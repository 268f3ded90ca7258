"""Kernel launches the greedy trainer issued a step: the host's launch
calls that start inside the program's ``diffco.perceptron.train`` spans
in the traced updates, over the greedy steps those updates ran (the
``perceptron.greedy_steps`` counts of the program's kept
``diffco.checker.update`` spans that lie in a traced request). Device
trace."""
from portbench.metrics import _spans


def read(ctx):
    if ctx.trace is None or not ctx.counts.get('updates'):
        return None
    train = _spans.union(ctx.trace, 'diffco.perceptron.train')
    reqs = _spans.requests(ctx.trace)
    steps = sum(e.counts.get('perceptron.greedy_steps', 0)
                for e in _spans.entries('diffco.checker.update')
                if any(s <= e.start_ns and e.end_ns <= t for s, t in reqs))
    return _spans.launches(ctx.trace, train) / steps if train and steps \
        else None
