"""The share of the updates' host time spent in the greedy trainer, in
percent: the union of the program's ``diffco.perceptron.train`` spans
over the union of its ``diffco.checker.update`` spans, in the traced
requests. Device trace."""
from portbench.metrics import _spans


def read(ctx):
    if ctx.trace is None or not ctx.counts.get('updates'):
        return None
    update = _spans.length(_spans.union(ctx.trace, 'diffco.checker.update'))
    train = _spans.length(_spans.union(ctx.trace, 'diffco.perceptron.train'))
    return 100 * train / update if update else None
