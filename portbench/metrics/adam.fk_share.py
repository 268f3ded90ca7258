"""The share of the Adam steps' host time spent in the DH FK and its
VJP, in percent: the union of the program's ``diffco.robots.fk`` and
``diffco.robots.fk_vjp`` spans over the union of its
``diffco.optim.step`` spans, in the traced requests. Device trace."""
from portbench.metrics import _spans


def read(ctx):
    if ctx.trace is None or not ctx.counts.get('adam_steps'):
        return None
    step = _spans.length(_spans.union(ctx.trace, 'diffco.optim.step'))
    fk = _spans.union(ctx.trace, 'diffco.robots.fk', 'diffco.robots.fk_vjp')
    return 100 * _spans.length(fk) / step if step else None
