"""One run of one cell: set-up, the measured window (or the traced
slice), the metrics, the check of what the window produced, and the
result line."""
from __future__ import annotations

import contextlib
import math
import sys
import time

import numpy as np
import torch

from . import manifest as mf
from . import trace as tr
from .system import System

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'diffco_tpu')
SEED_NAMES = ('checker', 'fit', 'pool', 'restarts', 'probe', 'sample')


def seeds(seed: int) -> dict:
    """Named 32-bit seeds derived from the run's ``--seed``."""
    ss = np.random.SeedSequence(int(seed)).spawn(len(SEED_NAMES))
    return {n: int(s.generate_state(1)[0]) for n, s in zip(SEED_NAMES, ss)}


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


class Window:
    """Whole requests, back to back, until ``seconds`` have passed (or
    ``requests`` of them ran): each request's own time, the answers it was
    due to give (a plan each, a call or an update) and those that failed,
    and the elapsed time from the first start to the last end."""

    def __init__(self, kind, seconds=None, requests=None, traced=False):
        self.times, self.failed, self.attempted = [], 0, 0
        t_start = time.perf_counter()
        i = 0
        while True:
            kind.before(i)
            t0 = time.perf_counter()
            try:
                with (torch.profiler.record_function(tr.REQUEST) if traced
                      else contextlib.nullcontext()):
                    rec = kind.request(i)
            except Exception as e:   # a request that raises is failed
                print(f'request {i} raised {type(e).__name__}: {e}',
                      file=sys.stderr)
                sync(kind.device)
                n = getattr(kind, 'answers', 1)
                rec = {'attempted': n, 'failed': n}
            t1 = time.perf_counter()
            self.times.append(t1 - t0)
            self.failed += rec['failed']
            self.attempted += rec['attempted']
            i += 1
            kind.after(i - 1)
            if requests is not None:
                if i >= requests:
                    break
            elif t1 - t_start >= seconds:
                break
        self.elapsed = time.perf_counter() - t_start
        self.requests = i


HOST_SLICE_S = 1.0


class Context:
    """What a metric's reader may read."""

    def __init__(self, kind, setup_s, window, trace=None):
        self.setup_s, self.window = setup_s, window
        self.counts = dict(kind.counts)
        self.work = getattr(kind, 'work', None)
        self.trace = trace
        self._kind, self.host = kind, None

    def host_slice(self) -> Window:
        """Whole requests run untraced for ``HOST_SLICE_S`` seconds after
        the traced slice, timed by the host's clock alone (the profiler
        lengthens the traced requests): run once, on a reader's first
        call."""
        if self.host is None:
            self.host = Window(self._kind, seconds=HOST_SLICE_S)
            sync(self._kind.device)
        return self.host


def build(cell_name: str, seed: int, device, manifest=None,
          mix_overrides=None, config_overrides=None):
    """The set-up of a cell: its system and its request kind, warmed up."""
    manifest = manifest or mf.load()
    w = mf.workload(manifest, cell_name)
    config = mf.config(manifest, w['config'])
    config.update(config_overrides or {})
    mix = mf.mix(w['traffic'])
    mix.update(mix_overrides or {})
    sd = seeds(seed)
    system = System(config, sd, device)
    kind = mf.kind(mix['kind']).Kind(system, mix, sd)
    return w, mix, system, kind


def verdict(numbers: dict, limits: dict):
    """(correct, checks): each number beside its limit; a number is
    correct at or below its limit, a number without a limit never."""
    checks, ok = {}, True
    for name, value in numbers.items():
        lim = limits.get(name)
        good = (lim is not None and value is not None
                and math.isfinite(value) and value <= lim)
        ok &= good
        checks[name] = {'value': value, 'limit': lim}
    return ok, checks


def run(cell_name: str, seed: int, seconds: float, traced: bool, device,
        t_process: float, manifest=None, mix_overrides=None,
        config_overrides=None) -> dict:
    """One run; ``t_process`` is the process's start on the
    ``time.perf_counter`` clock. Returns the result line's fields."""
    manifest = manifest or mf.load()
    w, mix, system, kind = build(cell_name, seed, device, manifest,
                                 mix_overrides, config_overrides)
    sync(device)
    setup_s = time.perf_counter() - t_process
    trace = None
    if traced:
        box = {}
        trace = tr.profile(lambda: box.setdefault(
            'w', Window(kind, requests=mix['trace_requests'],
                        traced=True)))
        window = box['w']
    else:
        window = Window(kind, seconds=seconds)
    sync(device)
    t = sorted(window.times)
    print(f'window: {window.requests} requests in {window.elapsed:.3f} s, '
          f'a request {t[0]:.4f} / {t[len(t) // 2]:.4f} / {t[-1]:.4f} s '
          f'(least / median / most)', file=sys.stderr)
    mem = (torch.cuda.max_memory_allocated()
           if torch.device(device).type == 'cuda' else 0)
    kind.window_closed()
    ctx = Context(kind, setup_s, window, trace)
    values = {}
    for m in mf.metrics_of(manifest, cell_name, traced):
        v = mf.metric(m['name']).read(ctx)
        if v is not None:
            values[m['name']] = {'value': v, 'unit': m['unit']}
    numbers = kind.check()
    correct, checks = verdict(numbers, mf.limits(cell_name))
    dev = torch.device(device)
    runs = [window] + ([ctx.host] if ctx.host is not None else [])
    out = {'correct': correct,
           'attempted': sum(r.attempted for r in runs),
           'failed': sum(r.failed for r in runs), 'metrics': values,
           'device': {'platform': 'gpu' if dev.type == 'cuda' else 'cpu',
                      'kind': (torch.cuda.get_device_name(0)
                               if dev.type == 'cuda' else 'cpu'),
                      'count': 1, 'memory_peak_bytes': mem}}
    if trace is not None:
        out['device']['busy_s'] = trace.busy_s
        out['device']['window_s'] = trace.wall_s
        out['breakdown'] = {'device_ops': trace.top_ops(),
                            'idle_gaps': trace.top_gaps()}
    out['checks'] = checks
    return out
