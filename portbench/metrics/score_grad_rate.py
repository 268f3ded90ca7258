"""Configurations scored with their gradient a second: all of them over
the window's whole elapsed time. Host clock."""


def read(ctx):
    n = ctx.counts.get('configs')
    return n / ctx.window.elapsed if n else None
