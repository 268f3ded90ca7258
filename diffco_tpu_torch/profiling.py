"""Structured timing, check counting and trace capture (PyTorch
counterpart of ``diffco_tpu/profiling.py``): a registry of named
wall-clock spans, a collision-check counter and a context manager around
``torch.profiler`` that writes a Chrome trace.

    timers = Timers()
    with timers.span('fit', block=True):    # waits for every CUDA device
        checker.fit(num_samples=3000)
    print(timers.report())

    with trace('traces/adam') as prof:      # CPU and CUDA activities
        run_steps()
    print(prof.key_averages().table(sort_by='cuda_time_total'))
    # traces/adam/trace.json opens in Perfetto or chrome://tracing
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def _synchronize_all():
    """Wait for the work queued on every CUDA device (not only device 0's:
    work sharded over several cards would still be in flight)."""
    if torch.cuda.is_available():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


class Timers:
    """Named wall-clock spans with call counts."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str, block: bool = False):
        """Time the block under ``name``; with ``block`` the span ends only
        when every CUDA device has finished the work queued in it."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block:
                _synchronize_all()
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {'total_s': round(self.total[k], 4),
                    'count': self.count[k],
                    'mean_s': round(self.total[k] / max(self.count[k], 1),
                                    5)}
                for k in sorted(self.total)}

    def report(self) -> str:
        return json.dumps(self.summary(), indent=1)

    def reset(self):
        self.total.clear()
        self.count.clear()


class CheckCounter:
    """Collision-query counter (the reference optimizers' ``cnt_check``):
    ``wrap`` a checker function to count the configurations it is asked
    about."""

    def __init__(self):
        self.count = 0

    def wrap(self, fn):
        def counted(q, *a, **kw):
            # configurations, not dofs: a flat [dof] configuration is one
            # query
            ndim = getattr(q, 'ndim', None)
            self.count += 1 if ndim is None or ndim <= 1 else int(q.shape[0])
            return fn(q, *a, **kw)
        return counted

    def reset(self):
        self.count = 0


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activities, and CUDA
    ones where a card is present) and write its Chrome trace to
    ``log_dir/trace.json``. Yields the profiler, whose ``key_averages()``
    and ``events()`` stay readable after the block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        _synchronize_all()
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


def device_memory_stats() -> Dict[str, Optional[dict]]:
    """``torch.cuda.memory_stats`` per CUDA device, by device name
    ('cuda:0', ...); ``{'cpu': None}`` where there is no card."""
    if not torch.cuda.is_available():
        return {'cpu': None}
    return {f'cuda:{d}': torch.cuda.memory_stats(d)
            for d in range(torch.cuda.device_count())}
