"""Kernel launches on the card a trajectory-optimizer step: the kernels
in the traced requests' spans (memory copies and fills left out) over
the Adam steps they ran. Device trace."""


def read(ctx):
    steps = ctx.counts.get('adam_steps')
    if ctx.trace is None or not steps:
        return None
    return ctx.trace.in_requests()[0] / steps
