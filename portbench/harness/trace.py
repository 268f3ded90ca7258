"""A traced slice of whole requests under ``torch.profiler`` (CPU and
CUDA activity), kept in memory: the device's intervals, its kernel
launches, and what the host was doing in the device's longest idle
gaps."""
from __future__ import annotations

import time
from collections import defaultdict

import torch

REQUEST = 'portbench.request'   # the host span around each request


class Trace:
    """What a traced slice shows. Times in seconds."""

    def __init__(self, wall_s, device, host):
        self.wall_s = wall_s
        # device events: (start_ns, end_ns, name)
        self.device = sorted(device)
        self.host = host
        self.kernels = sum(1 for _, _, n in self.device
                           if not n.startswith(('Memcpy', 'Memset')))
        self.busy_s, self.gaps = union(self.device)
        self.requests = sorted((s, e) for s, e, n in host if n == REQUEST)

    def in_requests(self):
        """(kernels, device seconds, wall seconds) of the requests: each
        request ends by waiting for its device work, so a device event
        whose middle lies in a request's span is that request's (the
        middle, not both ends: the device's and the host's clocks agree
        only to some microseconds). Without the spans in the trace, the
        whole slice's."""
        if not self.requests:
            return self.kernels, self.busy_s, self.wall_s
        kernels, spans, wall = 0, [], 0
        for rs, re_ in self.requests:
            wall += re_ - rs
            for s, e, n in self.device:
                if rs <= (s + e) // 2 <= re_:
                    spans.append((s, e, n))
                    kernels += not n.startswith(('Memcpy', 'Memset'))
        return kernels, union(sorted(spans))[0], wall * 1e-9

    def top_ops(self, n: int = 10):
        tot = defaultdict(int)
        for s, e, name in self.device:
            tot[name] += e - s
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], ns * 1e-9] for name, ns in top]

    def top_gaps(self, n: int = 10):
        """The longest idle gaps between device activity, each named by
        the innermost host operation running at its middle."""
        out = []
        for s, e in sorted(self.gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = (s + e) // 2
            inner = None
            for hs, he, name in self.host:
                if hs <= mid <= he and (inner is None or hs >= inner[0]):
                    inner = (hs, name)
            out.append([(inner[1] if inner else 'python')[:200],
                        (e - s) * 1e-9])
        return out


def union(intervals):
    """(seconds covered by the union of [start, end) ns intervals, the
    gaps between them as (start, end) ns)."""
    busy, end, gaps = 0, None, []
    for s, e, _ in intervals:
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy * 1e-9, gaps


def profile(fn) -> Trace:
    """Run fn() under the profiler; its wall time ends with a synchronise."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    card = torch.cuda.is_available()
    if card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        span = (s, s + ev.duration_ns(), ev.name())
        if ev.device_type() != cuda:
            host.append(span)
        elif span[2] != REQUEST:      # not the span's mark on the device
            device.append(span)
    return Trace(wall, device, host)
