"""The router's host time a request, in milliseconds: the time inside
the program's ``diffco.ops.fk_score`` spans and outside their
``diffco.ops.launch`` (the kernel's ctypes call), over the traced
requests. Device trace."""
from portbench.metrics import _spans


def read(ctx):
    if ctx.trace is None or not ctx.counts.get('calls') \
            or not ctx.trace.requests:
        return None
    router = _spans.union(ctx.trace, 'diffco.ops.fk_score')
    if not router:
        return None
    launch = _spans.intersect(router,
                              _spans.union(ctx.trace, 'diffco.ops.launch'))
    host = _spans.length(router) - _spans.length(launch)
    return host * 1e-6 / len(ctx.trace.requests)
