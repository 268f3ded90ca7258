"""Kernel launches an Adam step issued by the DH FK and its VJP: the
host's launch calls that start inside the program's
``diffco.robots.fk`` and ``diffco.robots.fk_vjp`` spans in the traced
requests, over the Adam steps they ran. Device trace."""
from portbench.metrics import _spans


def read(ctx):
    steps = ctx.counts.get('adam_steps')
    if ctx.trace is None or not steps:
        return None
    fk = _spans.union(ctx.trace, 'diffco.robots.fk', 'diffco.robots.fk_vjp')
    return _spans.launches(ctx.trace, fk) / steps if fk else None
