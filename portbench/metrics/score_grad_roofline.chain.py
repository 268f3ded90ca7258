"""A serial chain's score-and-gradient call's share of its roofline, in
percent: the least time the card could take for the call's work
(``harness/chain_work.py``: products at the TF32 tensor-core peak,
elementwise work with the chain's FK and its backward at the float32
peak, bytes at the HBM peak; the largest), over the device time of every
kernel launched inside the call, whatever implements it (the union of
the card's activity in the traced calls' spans, a call's share). Device
trace."""
from portbench.harness import chain_work


def read(ctx):
    calls = ctx.counts.get('calls')
    if (ctx.trace is None or not calls or not ctx.work
            or 'fk_ops' not in ctx.work):
        return None
    _, busy, _ = ctx.trace.in_requests()
    if busy <= 0:
        return None
    return 100 * chain_work.score_grad(**ctx.work)['bound_s'] / (busy / calls)
