"""Seconds a plan: the window's whole elapsed time over the plans it
completed (a batch of 64 counts 64). Host clock."""


def read(ctx):
    n = ctx.counts.get('plans')
    return ctx.window.elapsed / n if n else None
