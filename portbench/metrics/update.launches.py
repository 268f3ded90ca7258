"""Kernel launches on the card an update: the kernels in the traced
updates' spans (memory copies and fills left out) over the updates.
Device trace."""


def read(ctx):
    n = ctx.counts.get('updates')
    if ctx.trace is None or not n:
        return None
    return ctx.trace.in_requests()[0] / n
