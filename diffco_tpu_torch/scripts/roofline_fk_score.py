"""Roofline attribution of kernel B1 on the card: the PyTorch counterpart of
the JAX package's ``scripts/roofline_fk_score.py``.

    python3 -m diffco_tpu_torch.scripts.roofline_fk_score [--out PATH]

At bench.py's primitive shape (PandaFK: J = 7, P = 7, F = 21 padded to 24;
B = 65536 configurations, S = 512 supports that are FK points of random
configurations, weights N(0, 0.05^2)) it times

- ``bench_step``: ``fk_polyharmonic_score_auto(q).sum()``, its gradient in
  q through autograd (kernel B1 at this batch), then ``q - 1e-4 g``;
- ``full_kernel``: ``fk_score.dh_score_grad`` (B1) alone;
- the ablation ladder of kernel B7 (``csrc/dh_ablation.cu``, through
  ``dh_ablation``), each rung a prefix of B1's tensor-core kernel:
  ``fk_only`` -> ``mxu`` (+ product 1 alone: sum_j s_j . x, the
  reference's matrix-unit dot) -> ``mxu_rsqrt`` (+ d2 from the expanded
  square with the guard, the rsqrt) -> ``fwd`` (+ the weighted score) ->
  ``mv_f32_full`` (B1 in full, one output), and ``mv_bf16_full`` (the
  same with product 2 as one bf16 product and the score's r and w
  rounded to bf16, the reference's A/B);
- B1 at 64 / 128 / 256 / 512 threads per block (``tile_sweep_full_ms``;
  the reference sweeps its TPU batch tile).

Timing is the reference's scan differencing: a chain of steps, each
step's input the previous step's output, run at ``N_SHORT`` and ``N_LONG``
steps after a warm-up, each run timed with CUDA events, the minimum over
``REPS`` runs; per step = (long - short) / (N_LONG - N_SHORT). A difference
at or below zero is reported as null; ``raw_ms`` holds every variant's two
times. The reference's scan runs on the device alone; an eager step here
also waits on the host, which launches each kernel from Python (~0.03-0.07
ms a step, host-dependent), so a kernel faster than that is hidden in its
step. The result's ``device_ms`` therefore holds each kernel's own time
on the card, the mean duration of ``N_DEVICE`` launches in a
``torch.profiler`` trace (``device_ms``), and on the card the ladder is
computed from it.
The names follow the reference's result; none of its TPU numbers
describes this card.

The result goes to ``--out`` (default ``build/diffco_tpu_torch/
roofline.json``) and is printed as JSON with the card's name and power
limit. It runs on the card; ``--device cpu`` runs the plain twins (best
at a small ``--batch`` / ``--supports``) on the host clock, as a
rehearsal.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import time
from pathlib import Path

import torch

from ..device import resolve_device
from ..ops import _native, bounds, fk_score
from ..ops.fused_score import _PLAIN_ROWS, _poly_score_grad_plain
from ..robots.analytic import PandaFK
from ..robots.fk_jvp import dh_chain, dh_vjp

B = 65536
S = 512
N_SHORT, N_LONG = 20, 120
REPS = 6
N_DEVICE = 20
N_TRACE_SLACK = 20
N_TRACE_TRIES = 3
SWEEP_THREADS = (64, 128, 256, 512)
OUT_DIR = Path(__file__).resolve().parents[2] / 'build' / 'diffco_tpu_torch'

# the reference's ablation names, in ladder order, -> csrc/dh_ablation.cu's
# AblationMode (``mxu``: sum_j s_j . x, the dot that the distance is made
# of)
MODES = {'fk_only': 0, 'mxu': 1, 'mxu_rsqrt': 2, 'fwd': 3,
         'mv_f32_full': 4, 'mv_bf16_full': 5}
LADDER = ('fk_only', 'mxu', 'mxu_rsqrt', 'fwd', 'mv_f32_full')
FP_BUILT = 24   # the padded point width the B6 and B7 kernels are built for
# B7 against its twin, max |diff| <= tol x max |twin|: 1e-4 for the sums
# without dq, 1e-3 with it. In mv_bf16_full kernel and twin may round an r
# or 1/r to neighbouring bf16 values (2^-8 of a term; the kernel's d2 comes
# from the expanded square, the twin's by direct difference), while
# leaving the rounding out moves it by several times the tolerance, which
# chip_smoke.py and tests/test_torch_cuda.py assert
ABLATION_TOL = {'fk_only': 1e-4, 'mxu': 1e-4, 'mxu_rsqrt': 1e-4,
                'fwd': 1e-4, 'mv_f32_full': 1e-3, 'mv_bf16_full': 1e-3}


def flagship_score_setup(n_supports=S, seed=0, device='cuda'):
    """PandaFK, supports = FK points of ``n_supports`` random
    configurations [S, 21], weights N(0, 0.05^2) [S], from one
    ``torch.Generator``: the port's copy of the JAX package's
    ``__graft_entry__._flagship_score_setup`` (other random numbers, the
    same distributions)."""
    robot = PandaFK()
    g = torch.Generator().manual_seed(seed)
    sup = robot.fkine(robot.rand_configs(n_supports, g, device))
    w = (torch.randn(n_supports, generator=g) * 0.05).to(device)
    return robot, sup.reshape(n_supports, -1).contiguous(), w


def fp24_spec(name, spec):
    """The kernel's DHSpec argument for a spec whose P points pad to the
    FP_BUILT components that the B6 and B7 kernels are built for, on at
    most MAX_J joints; raises otherwise."""
    c = fk_score._c_spec(spec)
    J, P = len(spec[0]), len(spec[1])
    if J > _native.MAX_J or (3 * P + 7) // 8 * 8 != FP_BUILT:
        raise ValueError(f'{name}: built for {FP_BUILT} padded point '
                         f'components (6 to 8 points) on at most '
                         f'{_native.MAX_J} joints, got {P} points on {J}')
    return c


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def _bf16_score_grad_plain(x, s, w):
    """``_poly_score_grad_plain`` with r, 1/r, w and s * w rounded to bf16
    before the score / rowsum / su products (fp32 sums): the function of
    the reference's ``make_mv_full(mv_f32=False)``."""
    wb, swb = _bf16(w), _bf16(s * w[:, None])
    scores, dxs = [], []
    for x_c in torch.split(x, _PLAIN_ROWS):
        d2 = torch.sum((x_c[:, None, :] - s[None, :, :]) ** 2, dim=-1)
        d2 = torch.clamp(d2, min=0.0) + 1e-12
        rinv = torch.rsqrt(d2)
        rb, ib = _bf16(d2 * rinv), _bf16(rinv)
        scores.append(rb @ wb)
        dxs.append(x_c * (ib @ wb)[:, None] - ib @ swb)
    return torch.cat(scores), torch.cat(dxs)


def _dh_ablation_plain(q, s, w, spec, mode):
    """Plain PyTorch twin of ``csrc/dh_ablation.cu``: q [B, J] -> out [B],
    the mode's function (``MODES``) with the kernel's arithmetic."""
    st = fk_score._statics(spec)
    axes, pts = dh_chain(st, q)
    x = torch.stack([c for p in pts for c in p], dim=-1)       # [B, 3P]
    if mode == 'fk_only':
        acc = torch.zeros_like(x[:, 0])
        for c in x.unbind(-1):
            acc = acc + c
        return acc
    if mode in ('mv_f32_full', 'mv_bf16_full'):
        plain = (_poly_score_grad_plain if mode == 'mv_f32_full'
                 else _bf16_score_grad_plain)
        acc, dx = plain(x, s, w)
        dq = dh_vjp(st, axes, pts, dx)
        for j in reversed(range(dq.shape[1])):
            acc = acc + dq[:, j]
        return acc
    if mode == 'mxu':
        return x @ s.sum(0)
    out = []
    for x_c in torch.split(x, _PLAIN_ROWS):
        d2 = torch.sum((x_c[:, None, :] - s[None, :, :]) ** 2, dim=-1)
        d2 = torch.clamp(d2, min=0.0) + 1e-12
        rinv = torch.rsqrt(d2)
        r = d2 * rinv
        out.append((r + rinv).sum(1) if mode == 'mxu_rsqrt' else r @ w)
    return torch.cat(out) if out else x.new_zeros(0)


def dh_ablation(q, s, w, spec, mode):
    """Kernel B7: one float per configuration by ``mode`` (a key of
    ``MODES``), q [B, J] -> out [B]. A CUDA tensor launches
    ``csrc/dh_ablation.cu``, counted in ``launches.dh_ablation:<mode>``
    (or raises); a CPU tensor runs the plain twin."""
    if mode not in MODES:
        raise ValueError(f'dh_ablation: mode {mode!r}, not one of '
                         f'{list(MODES)}')
    if q.device.type == 'cpu':
        return _dh_ablation_plain(q, s, w, spec, mode)
    c = fp24_spec('dh_ablation', spec)
    return fk_score._launch(f'dh_ablation:{mode}', 'dh_ablation', q, s, w,
                            c, c.J, c.P, MODES[mode], entry='dh_ablation',
                            dq=False)


def dh_score_grad_threads(q, s, w, spec, threads):
    """Kernel B1 (``csrc/dh_score.cu``) at ``threads`` (64, 128, 256 or
    512) per block, for the block-size sweep: (score [B], dq [B, J]),
    counted in ``launches.dh_score_grad``. A CPU tensor runs the
    plain twin."""
    if q.device.type == 'cpu':
        return fk_score._dh_score_grad_plain(q, s, w, spec)
    if threads not in SWEEP_THREADS:
        raise ValueError(f'dh_score_grad_threads: {threads} threads, built '
                         f'for {SWEEP_THREADS}')
    c = fp24_spec('dh_score_grad_threads', spec)
    return fk_score._launch('dh_score_grad', 'dh_score', q, s, w, c, c.J,
                            c.P, threads, entry='dh_score_grad_threads')


def _elapsed_ms(fn, dev):
    if dev.type != 'cuda':
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize(dev)
    return e0.elapsed_time(e1)


def device_ms(fn, kernel, n=None):
    """The mean time on the card, in ms, of the kernel launched by each of
    ``n`` (default ``N_DEVICE``) calls of ``fn``: the durations of the
    last ``n`` device events whose name ``kernel`` (a regular expression)
    matches in a ``torch.profiler`` trace of CUDA activity over ``n +
    N_TRACE_SLACK`` calls (the trace can miss the first launches after it
    starts: 18 of 20 were seen once on the H100, 19 of 25 once after
    chip_smoke's mesh path, and once none of 40 there). A trace with fewer
    than ``n`` is taken again, up to ``N_TRACE_TRIES`` traces; raises if
    none holds ``n``, or if one holds more than one such kernel a call."""
    n = N_DEVICE if n is None else n
    calls = n + N_TRACE_SLACK
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(N_TRACE_TRIES):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = sorted((e.start_ns(), e.duration_ns())
                        for e in prof.profiler.kineto_results.events()
                        if e.device_type() == torch.autograd.DeviceType.CUDA
                        and re.search(kernel, e.name()))
        if len(events) > calls:
            raise RuntimeError(f'device_ms: {len(events)} launches of '
                               f'{kernel} in the trace of {calls} calls')
        if len(events) >= n:
            return sum(d for _, d in events[-n:]) / n * 1e-6
        seen.append(len(events))
    raise RuntimeError(f'device_ms: {seen} launches of {kernel} in '
                       f'{N_TRACE_TRIES} traces of {calls} calls each')


def instance_pattern(kernel, arg):
    """``device_ms``'s pattern for the instance ``kernel<arg>`` of a kernel
    template with one int argument, in a trace's demangled or mangled
    name (the trace may keep another instance's events)."""
    return rf'{kernel}(<{arg}>|ILi{arg}EE)'


def per_step_ms(step, q):
    """Scan differencing: ``step`` maps q to the next q; chains of
    ``N_SHORT`` and ``N_LONG`` steps, the minimum of ``REPS`` runs each.
    Returns (ms per step, or None when the difference is at or below
    zero; the raw minimum times of the two chains in ms)."""
    def chain(n):
        x = q
        for _ in range(n):
            x = step(x)
        return x

    chain(N_SHORT)                       # warm-up
    if q.device.type == 'cuda':
        torch.cuda.synchronize(q.device)
    t_short = t_long = math.inf
    for _ in range(REPS):
        t_short = min(t_short, _elapsed_ms(lambda: chain(N_SHORT), q.device))
        t_long = min(t_long, _elapsed_ms(lambda: chain(N_LONG), q.device))
    per = (t_long - t_short) / (N_LONG - N_SHORT)
    return (per if per > 0 else None), dict(short_ms=t_short, long_ms=t_long)


def card_info(dev):
    """The device's name and, on a card, nvidia-smi's name and power
    limit."""
    if dev.type != 'cuda':
        return dict(device_name='cpu', nvidia_smi=None)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return dict(device_name=torch.cuda.get_device_name(dev), nvidia_smi=smi)


def write_result(res, out):
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))


def run(device='cuda', batch=B, supports=S):
    """The roofline result dict (module docstring) at ``batch`` x
    ``supports``; the step counts as ``per_step_ms``."""
    dev = resolve_device(device)
    robot, sup, w = flagship_score_setup(supports, device=dev)
    spec = fk_score.robot_spec(robot)
    q = robot.rand_configs(batch, torch.Generator().manual_seed(1), dev)
    res = dict(B=batch, S=supports, device=str(dev),
               method=f'scan differencing ({N_SHORT} vs {N_LONG} steps, '
                      f'min of {REPS}), '
                      + ('CUDA events' if dev.type == 'cuda'
                         else 'host clock'))
    raw = {}

    def timed(key, step):
        ms, raw[key] = per_step_ms(step, q)
        return ms

    def bench_step(qq):
        qg = qq.detach().requires_grad_(True)
        total = fk_score.fk_polyharmonic_score_auto(qg, robot, sup, w).sum()
        g, = torch.autograd.grad(total, qg)
        return qq - 1e-4 * g

    def full_step(score_grad):
        def step(qq):
            score, dq = score_grad(qq)
            return qq - 1e-6 * dq + 1e-9 * score[0]
        return step

    res['bench_step_ms'] = timed('bench_step', bench_step)
    res['full_kernel_ms'] = timed('full_kernel', full_step(
        lambda qq: fk_score.dh_score_grad(qq, sup, w, spec)))
    for mode in MODES:
        res[f'{mode}_ms'] = timed(mode, lambda qq, m=mode: qq + 1e-9 * (
            dh_ablation(qq, sup, w, spec, m)[:, None]))
    res['tile_default'] = 128
    res['tile_sweep_full_ms'] = {
        str(t): timed(f'tile_sweep_{t}', full_step(
            lambda qq, t=t: dh_score_grad_threads(qq, sup, w, spec, t)))
        for t in SWEEP_THREADS}
    # on the card each kernel's own time (module docstring), the ladder's
    dev_ms = None
    if dev.type == 'cuda':
        dev_ms = {'full_kernel': device_ms(
            lambda: fk_score.dh_score_grad(q, sup, w, spec),
            'dh_score_tc_kernel')}
        dev_ms.update({mode: device_ms(
            lambda m=mode: dh_ablation(q, sup, w, spec, m),
            instance_pattern('dh_ablation_kernel', MODES[mode]))
            for mode in MODES})
    res['device_ms'] = dev_ms
    # the ladder: what each rung adds, as a share of B1 in full
    times = dev_ms or {m: res[f'{m}_ms'] for m in MODES}
    full, prev, ladder = times['mv_f32_full'], 0.0, {}
    for mode in LADDER:
        ms = times[mode]
        adds = None if ms is None or prev is None else ms - prev
        ladder[mode] = dict(ms=ms, adds_ms=adds, share_of_full=(
            None if adds is None or not full else adds / full))
        prev = ms
    res['ladder'] = ladder
    J, F = q.shape[1], sup.shape[1]
    ops = bounds.score_ops(batch, supports, F) + batch * bounds.dh_ops(
        J, len(spec[1]))
    t_full = res['full_kernel_ms']
    res['f_pad'] = (F + 7) // 8 * 8
    res['ops_per_call_full'] = ops
    res['evals_per_sec_full'] = batch / t_full * 1e3 if t_full else None
    res['implied_tflops_full'] = ops / t_full / 1e9 if t_full else None
    res['rsqrt_per_call'] = batch * supports
    res['raw_ms'] = raw
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out', default=str(OUT_DIR / 'roofline.json'))
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    ap.add_argument('--batch', type=int, default=B)
    ap.add_argument('--supports', type=int, default=S)
    args = ap.parse_args(argv)
    res = run(args.device, args.batch, args.supports)
    res.update(card_info(torch.device(args.device)))
    write_result(res, args.out)
    print(json.dumps(res), flush=True)


if __name__ == '__main__':
    main()
