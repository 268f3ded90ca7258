"""Smoke run of the PyTorch/CUDA port on one CUDA card: python3 chip_smoke.py

Builds the hand-written kernels from csrc/, holds each against its plain
PyTorch twin at the main path's shapes, drives the main path (PandaFK +
ShapeEnv scene -> ForwardKinematicsDiffCo.fit -> verify / collision_score
sweeps -> Adam trajectory optimization -> ground-truth check of the dense
paths) and shows through the launch counters that the sweeps went through
both kernels. Then it times each kernel and its plain twin with CUDA
events.

Prints the device, the card's name and power limit (nvidia-smi), one
line per phase, a ``{"kernels": [...]}`` JSON line, and last
``{"ok": true, "device": {...}}``. Any failed phase raises: the script
exits non-zero and prints no result. Without a CUDA card it exits 1
before doing anything.
"""
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

# the main path's shapes (bench.py's primitive: B = 65536, S = 512)
B_BENCH = 65536
B_RAGGED = B_BENCH + 37          # a ragged end for the kernel checks
S_BENCH = 512
FIT_SAMPLES = 5000               # ForwardKinematicsDiffCo.fit's default
VERIFY_SAMPLES = 16384
LINK_RADIUS = 0.15
N_PROBLEMS = 4
TRAJ_OPTIONS = {'N_WAYPOINTS': 20, 'NUM_RE_TRIALS': 8, 'MAXITER': 300,
                'max_speed': 2.0, 'dense_sub': 4, 'history': False}

# H100 SXM published peaks (NVIDIA data sheet, at 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def _phase(name, t0, **info):
    fields = ' '.join(f'{k}={v}' for k, v in info.items())
    print(f'[{name}] {time.perf_counter() - t0:.2f}s {fields}', flush=True)


def _ptxas_report(log):
    """'kernel<FP>: registers/spill stores' per compiled kernel instance,
    from nvcc's ``-Xptxas -v`` output."""
    out, kernel, spill = [], None, None
    for ln in log.splitlines():
        m = re.search(r'((?:poly|dh)_score_grad_kernel)ILi(\d+)E', ln)
        if 'Compiling entry function' in ln and m:
            kernel = f'{m.group(1)}<{m.group(2)}>'
        m = re.search(r'(\d+) bytes spill stores', ln)
        if m:
            spill = m.group(1)
        m = re.search(r'Used (\d+) registers', ln)
        if m and kernel:
            out.append(f'{kernel}: {m.group(1)} regs/{spill} B spilled')
    return out


def _max_err(pairs):
    return max(float((a - b).abs().max()) for a, b in pairs)


def _check_close(name, a, b, tol):
    if not torch.allclose(a, b, rtol=tol, atol=tol):
        raise AssertionError(
            f'{name}: kernel and plain twin disagree beyond {tol}: '
            f'max |diff| {float((a - b).abs().max())}')


def _inputs(robot, B, S, dev, seed):
    g = torch.Generator().manual_seed(seed)
    q = robot.rand_configs(B, g, dev)
    sup = robot.fkine(robot.rand_configs(S, g, dev), flat=True).contiguous()
    w = (torch.randn(S, generator=g) * 0.05).to(dev)
    return q, sup, w


def check_poly_kernel(robot, dev):
    """B2 against its plain twin at B = 65536 + 37, S = 512, F = 21."""
    from diffco_tpu_torch.ops import fused_score
    t0 = time.perf_counter()
    q, sup, w = _inputs(robot, B_RAGGED, S_BENCH, dev, seed=1)
    x = robot.fkine(q, flat=True).contiguous()
    score, dx = fused_score.poly_score_grad(x, sup, w)
    ref, ref_dx = fused_score._poly_score_grad_plain(x, sup, w)
    torch.cuda.synchronize()
    _check_close('poly_score_grad score', score, ref, 1e-4)
    _check_close('poly_score_grad dx', dx, ref_dx, 1e-3)
    err = _max_err([(score, ref), (dx, ref_dx)])
    _phase('B2 poly_score_grad vs plain', t0, B=B_RAGGED, S=S_BENCH,
           F=x.shape[1], max_abs_err=err)
    return dict(args=(x, sup, w), err=err)


def check_dh_kernel(robot, dev):
    """B1 against its plain twin at the same shape, and autograd through
    fk_polyharmonic_score_auto (bench.py's primitive) against its dq."""
    from diffco_tpu_torch.ops import fk_score
    t0 = time.perf_counter()
    q, sup, w = _inputs(robot, B_RAGGED, S_BENCH, dev, seed=2)
    spec = fk_score.robot_spec(robot)
    score, dq = fk_score.dh_score_grad(q, sup, w, spec)
    ref, ref_dq = fk_score._dh_score_grad_plain(q, sup, w, spec)
    torch.cuda.synchronize()
    _check_close('dh_score_grad score', score, ref, 1e-4)
    _check_close('dh_score_grad dq', dq, ref_dq, 1e-3)
    err = _max_err([(score, ref), (dq, ref_dq)])
    qg = q.clone().requires_grad_(True)
    out = fk_score.fk_polyharmonic_score_auto(qg, robot, sup, w)
    g, = torch.autograd.grad(out.sum(), qg)
    _check_close('autograd through fk_polyharmonic_score_auto', g, dq, 1e-6)
    _phase('B1 dh_score_grad vs plain', t0, B=B_RAGGED, S=S_BENCH,
           J=q.shape[1], max_abs_err=err)
    return dict(args=(q, sup, w, spec), err=err)


def _scene():
    import diffco_tpu_torch as dc

    def T(t):
        m = np.eye(4)
        m[:3, 3] = t
        return m
    # the box + sphere of tests/test_checkers.py::panda_world
    return dc.ShapeEnv({
        'box1': {'type': 'Box', 'params': {'extents': [0.1, 0.1, 0.1]},
                 'transform': T([0.5, 0.5, 0.5])},
        'sphere1': {'type': 'Sphere', 'params': {'radius': 0.1},
                    'transform': T([0.5, 0, 0])}})


def _problems(robot, gt, dev, n, seed=7):
    """n (start, target) pairs of ground-truth-free configurations whose
    straight line collides."""
    from diffco_tpu_torch.utils import dense_path
    g = torch.Generator().manual_seed(seed)
    q = robot.rand_configs(4096, g, dev)
    free = q[~gt(q)]
    pairs = []
    for i in range(0, free.shape[0] - 1, 2):
        line = dense_path(torch.stack([free[i], free[i + 1]]), 200)
        if bool(gt(line).any()):
            pairs.append((free[i], free[i + 1]))
        if len(pairs) == n:
            return pairs
    raise AssertionError(f'found only {len(pairs)} colliding straight lines')


def journey(robot, dev):
    """The main path through the entry points a user calls."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch import optim
    from diffco_tpu_torch.ops import fk_score, fused_score
    from diffco_tpu_torch.utils import dense_path
    env = _scene()
    gt_model = dc.CapsuleChainCollision(robot, link_radius=LINK_RADIUS)
    gt = gt_model.checker_fn(env)
    checker = dc.ForwardKinematicsDiffCo(robot=robot, environment=env,
                                         gt_check_func=gt, seed=0)

    t0 = time.perf_counter()
    acc, tpr, tnr = checker.fit(num_samples=FIT_SAMPLES)
    torch.cuda.synchronize()
    p = checker.perceptron
    _phase('fit', t0, samples=FIT_SAMPLES, iterations=p.train_iterations,
           supports=p.num_valid, acc=acc, tpr=tpr, tnr=tnr,
           safety_bias=checker.safety_bias)
    if not tpr >= 0.9:
        raise AssertionError(f'fit TPR {tpr} < 0.9')

    t0 = time.perf_counter()
    vacc, vtpr, vtnr = checker.verify(num_samples=VERIFY_SAMPLES)
    _phase('verify', t0, configs=VERIFY_SAMPLES, acc=vacc, tpr=vtpr,
           tnr=vtnr)

    # both sweeps with their gradients, as an optimizer takes them: the
    # backward of each kernel's autograd Function returns the dq (dx) of the
    # same launch
    t0 = time.perf_counter()
    q = robot.rand_configs(B_BENCH, torch.Generator().manual_seed(3), dev)
    qg = q.clone().requires_grad_(True)
    xg = robot.fkine(q).requires_grad_(True)
    s_q = checker.collision_score(qg)
    s_p = checker.collision_score(q_link_pos=xg)
    dq, = torch.autograd.grad(s_q.sum(), qg)
    dx, = torch.autograd.grad(s_p.sum(), xg)
    s_q, s_p, dx = s_q.detach(), s_p.detach(), dx.reshape(B_BENCH, -1)
    torch.cuda.synchronize()
    if s_q.shape != (B_BENCH, 1) or not bool(torch.isfinite(s_q).all()):
        raise AssertionError('collision_score: bad shape or non-finite')
    # the same proxy from configurations (B1) and from link points (B2)
    _check_close('collision_score q vs q_link_pos', s_q, s_p, 1e-3)
    _phase('collision_score sweeps', t0, configs=B_BENCH,
           supports=p.support_transformed.shape[0],
           gt_agreement=float(((s_q.reshape(-1) > 0) == gt(q)).float()
                              .mean()))
    # each sweep's kernel against its plain twin at the sweep's own shapes
    w = p.rbf_nodes * p.valid_mask.to(p.rbf_nodes.dtype) / p.rbf_kernel.epsilon
    sup = p.support_transformed
    with torch.no_grad():
        ref_q, ref_dq = fk_score._dh_score_grad_plain(
            q, sup, w, fk_score.robot_spec(robot))
        ref_p, ref_dx = fused_score._poly_score_grad_plain(
            robot.fkine(q, flat=True), sup, w)
    bias = checker.safety_bias
    _check_close('collision_score(q) vs plain twin', s_q.reshape(-1) - bias,
                 ref_q, 1e-4)
    _check_close('collision_score(q) dq vs plain twin', dq, ref_dq, 1e-3)
    _check_close('collision_score(q_link_pos) vs plain twin',
                 s_p.reshape(-1) - bias, ref_p, 1e-4)
    _check_close('collision_score(q_link_pos) dx vs plain twin', dx, ref_dx,
                 1e-3)
    print(f'sweeps vs plain twins at S = {sup.shape[0]}: max_abs_err '
          f'B1 {_max_err([(s_q.reshape(-1) - bias, ref_q), (dq, ref_dq)])} '
          f'B2 {_max_err([(s_p.reshape(-1) - bias, ref_p), (dx, ref_dx)])}',
          flush=True)

    t0 = time.perf_counter()
    results = []
    for i, (start, target) in enumerate(_problems(robot, gt, dev,
                                                  N_PROBLEMS)):
        opts = dict(TRAJ_OPTIONS, seed=i,
                    safety_margin=-checker.safety_bias)
        rec = optim.adam_traj_optimize(
            robot, lambda pp: checker.collision_score(pp, bias=0)
            .reshape(-1), start, target, opts)
        sol = torch.as_tensor(rec['solution'], device=dev)
        gt_free = not bool(gt(dense_path(sol, 10)).any())
        results.append((rec['success'], gt_free, rec['cost'], rec['time']))
    torch.cuda.synchronize()
    _phase('trajopt', t0, problems=N_PROBLEMS,
           success=[r[0] for r in results], gt_valid=[r[1] for r in results],
           cost=[round(r[2], 4) for r in results],
           seconds=[round(r[3], 2) for r in results])
    if not all(math.isfinite(r[2]) for r in results):
        raise AssertionError('trajopt: non-finite cost')
    if not any(r[1] for r in results):
        raise AssertionError('trajopt: no ground-truth-valid path')


def _time_ms(fn, warmup, iters):
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _bound(bytes_moved, ops):
    t_bytes = bytes_moved / PEAK_HBM_BYTES
    t_ops = ops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes > t_ops
                                       else 'operations')


def _dh_ops(J, P):
    """fp32 operations of one configuration's DH FK and suffix-sum backward,
    counted from csrc/dh_chain.cuh (an FMA is 2): per joint 66 for the
    transform compose (incl. sin and cos) and 17 for dq_j; per point 18 to
    place it and 21 to fold its gradient into the suffix sums."""
    return 83 * J + 39 * P


def _score_ops(B, S, F):
    """fp32 operations the score block's function needs, counted in the
    expanded form ||x||^2 + ||s||^2 - 2 x.s that the TPU kernel computes
    (an FMA is 2, an rsqrt 1): per pair 2F for x.s, 3 to form d2, 2 for the
    clamp and the 1e-12 floor, 1 rsqrt, 1 for r, 2 for the score, 2 for
    rowsum and 2F for su; per row 2F for ||x||^2 and 2F for dx; per support
    2F for ||s||^2. The kernels' direct difference sum (x - s)^2 does F
    more per pair, which the bound does not count."""
    return B * S * (4 * F + 11) + B * 4 * F + S * 2 * F


def kernel_table(b2, b1, launches):
    """Time each kernel and its plain twin at the checked shapes; the bound
    counts each input read once and each output written once, and
    ``_score_ops`` for the score block (plus ``_dh_ops`` per configuration
    for B1's FK and its backward)."""
    from diffco_tpu_torch.ops import fk_score, fused_score
    x, sup, w = b2['args']
    B, F = x.shape
    S = sup.shape[0]
    ops2 = _score_ops(B, S, F)
    bytes2 = 4 * (B * F + S * F + S + B + B * F)
    bound2, by2 = _bound(bytes2, ops2)
    q, sup1, w1, spec = b1['args']
    B1, J = q.shape
    S1, F1 = sup1.shape
    point_specs = spec[1]
    ops1 = _score_ops(B1, S1, F1) + _dh_ops(J, len(point_specs)) * B1
    bytes1 = 4 * (B1 * J + S1 * F1 + S1 + B1 + B1 * J)
    bound1, by1 = _bound(bytes1, ops1)
    rows = [
        dict(name='poly_score_grad', route='cuda',
             source='diffco_tpu_torch/csrc/poly_score.cu',
             replaces='diffco_tpu/ops/fused_score.py:138',
             shape=[B, S, F], launches=launches['poly_score_grad'],
             max_abs_err=b2['err'],
             ms=_time_ms(lambda: fused_score.poly_score_grad(x, sup, w),
                         5, 50),
             plain_ms=_time_ms(
                 lambda: fused_score._poly_score_grad_plain(x, sup, w), 1, 3),
             bound_ms=bound2, bound_by=by2, library_ms=None),
        dict(name='dh_score_grad', route='cuda',
             source='diffco_tpu_torch/csrc/dh_score.cu',
             replaces='diffco_tpu/ops/fk_score.py:505',
             shape=[B1, S1, J], launches=launches['dh_score_grad'],
             max_abs_err=b1['err'],
             ms=_time_ms(lambda: fk_score.dh_score_grad(q, sup1, w1, spec),
                         5, 50),
             plain_ms=_time_ms(
                 lambda: fk_score._dh_score_grad_plain(q, sup1, w1, spec),
                 1, 3),
             bound_ms=bound1, bound_by=by1, library_ms=None),
    ]
    return rows


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA card available', file=sys.stderr)
        return 1
    import diffco_tpu_torch as dc
    from diffco_tpu_torch.ops import _native, fk_score, fused_score

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f'device: {name} count={count} torch={torch.__version__} '
          f'cuda={torch.version.cuda}', flush=True)
    print(smi, flush=True)
    dev = torch.device('cuda')

    t0 = time.perf_counter()
    _native.build()
    regs = _ptxas_report(_native.build_log)
    _phase('build', t0, nvcc_seconds=round(_native.build_seconds, 2),
           kernels=len(regs))
    print('ptxas: ' + '; '.join(regs), flush=True)

    robot = dc.PandaFK()
    b2 = check_poly_kernel(robot, dev)
    b1 = check_dh_kernel(robot, dev)

    # count only the main path's launches
    fused_score.poly_score_grad_launches = 0
    fk_score.dh_score_grad_launches = 0
    journey(robot, dev)
    launches = {'poly_score_grad': fused_score.poly_score_grad_launches,
                'dh_score_grad': fk_score.dh_score_grad_launches}
    print(f'launches on the main path: {launches}', flush=True)
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f'{k} was never launched on the main path')

    t0 = time.perf_counter()
    rows = kernel_table(b2, b1, launches)
    _phase('kernel timing', t0)
    print(json.dumps({'kernels': rows}), flush=True)
    print(f'total {time.perf_counter() - t_start:.1f}s', flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': count}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
