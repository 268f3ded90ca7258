"""The whole score-and-gradient request's share of the card's compute
peak, in percent: the least compute time of its work
(``harness/work.py``: the larger of its products at the TF32 peak and
its elementwise work at the float32 peak) over the request's time on the
host's clock, whatever runs in it. The time is that of a second slice of
whole requests run untraced after the traced one (``Context.host_slice``,
about a second of them), since the profiler lengthens the traced
requests. Host clock."""
from portbench.harness import work


def read(ctx):
    if ctx.trace is None or not ctx.counts.get('calls') or not ctx.work:
        return None
    host = ctx.host_slice()
    return (100 * work.score_grad(**ctx.work)['compute_s']
            / (host.elapsed / host.requests))
