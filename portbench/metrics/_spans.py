"""What the readers of the program's own spans share: the spans of
``diffco_tpu_torch`` in a traced slice (its host ranges,
in ``ctx.trace.host``), as unions of disjoint [start, end) ns intervals
inside the traced requests; the host's kernel-launch calls that start in
them; and the program's kept entry spans (``profiling.spans()``, on the
same clock). A program without them gives empty unions and no entries,
and the readers then return None."""
from __future__ import annotations

import bisect

# the host calls that launch a kernel: cudaLaunch* and the lower-level cu*
LAUNCHES = frozenset(('cudaLaunchKernel', 'cudaLaunchKernelExC',
                      'cuLaunchKernel', 'cuLaunchKernelEx'))


def merge(intervals):
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def intersect(a, b):
    """The intersection of two sorted disjoint unions."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(union) -> int:
    return sum(e - s for s, e in union)


def requests(trace):
    """The traced requests' union."""
    return merge(trace.requests)


def union(trace, *names):
    """The union of the host spans named ``names``, inside the
    requests."""
    return intersect(merge((s, e) for s, e, n in trace.host if n in names),
                     requests(trace))


def launches(trace, union) -> int:
    """The launch calls whose start lies inside the union."""
    starts = [s for s, _ in union]
    n = 0
    for s, _, name in trace.host:
        if name in LAUNCHES:
            k = bisect.bisect_right(starts, s) - 1
            if k >= 0 and s < union[k][1]:
                n += 1
    return n


def entries(name):
    """The program's kept spans named ``name``, the oldest first."""
    from diffco_tpu_torch import profiling
    kept = getattr(profiling, 'spans', None)
    return [e for e in (kept() if kept else []) if e.name == name]


def in_setup(ctx, name):
    """The program's kept spans ``name`` that ended before the first
    traced request, the oldest first."""
    first = (ctx.trace.requests[0][0]
             if ctx.trace is not None and ctx.trace.requests else None)
    return [e for e in entries(name) if first is None or e.end_ns <= first]
