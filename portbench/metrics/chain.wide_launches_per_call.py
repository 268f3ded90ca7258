"""Launches of the chain kernels' wide instance a score-and-gradient
call: the program's counter ``ops.wide_launches`` over the traced calls
(read before and after each by the ``chain_sweep`` kind), over those
calls. None where the program has no such counter. Program counter."""


def read(ctx):
    calls = ctx.counts.get('calls')
    launches = ctx.counts.get('wide_launches')
    if ctx.trace is None or not calls or launches is None:
        return None
    return launches / calls
