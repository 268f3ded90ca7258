"""Structured timing, check counting and trace capture (PyTorch
counterpart of ``diffco_tpu/profiling.py``): a registry of named
wall-clock spans, a collision-check counter and a context manager around
``torch.profiler`` that writes a Chrome trace; and the spans and counters
the package itself records where its work happens.

    timers = Timers()
    with timers.span('fit', block=True):    # waits for every CUDA device
        checker.fit(num_samples=3000)
    print(timers.report())

    with trace('traces/adam') as prof:      # CPU and CUDA activities
        run_steps()
    print(prof.key_averages().table(sort_by='cuda_time_total'))
    # traces/adam/trace.json opens in Perfetto or chrome://tracing

The package's own spans (``span('diffco.optim.step')``, ...) cost one
read of ``torch.autograd.profiler._is_profiler_enabled`` when no profiler
runs. Under one they are host ranges in its trace, on the clock of the
device's events: ``_RecordFunctionFast``, a function-scope range, since
``record_function``'s user-scope range also puts an annotation among the
device's events, which reads as device activity. The entry spans
(``span(name, keep=True)``: the kernels' build, a checker's fit and
update) are besides kept always in a log of the last 4096, each with the
change of every counter (``count``) inside it:

    reset_spans()
    checker.update(num_samples=300)
    e = spans()[-1]            # Entry('diffco.checker.update', ...)
    e.counts['perceptron.greedy_steps'], (e.end_ns - e.start_ns) * 1e-9

A counter is read outside any kept span too, as its running total
(``counter('ops.wide_launches')``). Every launch of a hand-written kernel
counts one in ``launches.<kernel>`` (``ops._native.launch``).
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# the entry spans kept in memory, the newest last
SPAN_LOG = 4096


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


class Entry(NamedTuple):
    """One kept span: its name, its start and end on the profiler's host
    clock (``time.time_ns``), its id, the id of the kept span it ran in
    (None at the top) and the change of each counter inside it."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    counts: Dict[str, int]


class _Off:
    """The span of a process with no profiler running: enters nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_log = deque(maxlen=SPAN_LOG)
_counters: Dict[str, int] = {}
_open = []                  # ids of the kept spans open, innermost last
_ids = itertools.count(1)


class _Kept:
    """A kept span: logged always, a host range too while a profiler
    runs."""
    __slots__ = ('name', 'ranged', 'id', 'parent', 'before', 'start')

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.ranged = (_range(self.name)
                       if _autograd_profiler._is_profiler_enabled else None)
        if self.ranged is not None:
            self.ranged.__enter__()
        self.parent = _open[-1] if _open else None
        self.id = next(_ids)
        _open.append(self.id)
        self.before = dict(_counters)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _open.pop()
        before = self.before
        _log.append(Entry(self.name, self.start, end, self.id, self.parent,
                          {k: v - before.get(k, 0)
                           for k, v in _counters.items()
                           if v != before.get(k, 0)}))
        if self.ranged is not None:
            self.ranged.__exit__(*exc)
        return False


def _range(name: str):
    return torch._C._profiler._RecordFunctionFast(name)


def span(name: str, keep: bool = False):
    """A context manager around one phase of the package's work. With no
    profiler running it is a shared no-op; under one it is a host range
    named ``name``. ``keep`` also logs it (``spans()``)."""
    if keep:
        return _Kept(name)
    if _autograd_profiler._is_profiler_enabled:
        return _range(name)
    return _OFF


def spanned(name: str, keep: bool = False):
    """``span`` as a decorator: each call of the function runs in
    ``span(name, keep)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def in_span(*args, **kwargs):
            with span(name, keep):
                return fn(*args, **kwargs)
        return in_span
    return wrap


def spans() -> list:
    """The kept spans, the oldest first (the last ``SPAN_LOG``)."""
    return list(_log)


def reset_spans():
    """Empty the log of kept spans."""
    _log.clear()


def count(name: str, n: int = 1):
    """Add n to the counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    """The counter ``name`` now: all that ``count`` added to it in this
    process (0 if nothing was)."""
    return _counters.get(name, 0)


def counters() -> Dict[str, int]:
    """Every counter now, by name (a copy)."""
    return dict(_counters)
