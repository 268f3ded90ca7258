"""The card's idle share while the traced requests ran: 100 (1 - the
union of its activity inside the requests' spans / their wall time), in
percent. Device trace."""


def read(ctx):
    if ctx.trace is None or not ctx.counts.get('updates'):
        return None
    _, busy, wall = ctx.trace.in_requests()
    return 100 * (1 - busy / wall)
