"""The set-up's fit, in seconds: the last kept ``diffco.checker.fit``
span of the program called at the top level (not inside an update, as a
warm-up update's fit is) that ended before the first traced request.
Host clock."""
from portbench.metrics import _spans


def read(ctx):
    fits = [e for e in _spans.in_setup(ctx, 'diffco.checker.fit')
            if e.parent is None]
    return (fits[-1].end_ns - fits[-1].start_ns) * 1e-9 if fits else None
