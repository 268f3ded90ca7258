"""A/B of the multi-class kernels B5 (``csrc/chain_multi_score.cu``) and
B4 (``csrc/dh_multi_score.cu``), and of the tensor-core kernels B1
(``csrc/dh_score.cu``), B2 (``csrc/poly_score.cu``) and B3
(``csrc/chain_score.cu``), against other builds of the same C entry, on
one card in one process.

    python3 -m diffco_tpu_torch.scripts.ab_kernel \
        [--kernel chain|dh|b1|b2|b3] --source OTHER.cu [--classes 5 8] \
        [--out PATH]
    python3 -m diffco_tpu_torch.scripts.ab_kernel [--kernel chain|dh] \
        --ablate noA noB ...
    python3 -m diffco_tpu_torch.scripts.ab_kernel --kernel b1 \
        --ablate directDist noP2 noGuard tf32x1 noEpilogue noFK noLoop
    python3 -m diffco_tpu_torch.scripts.ab_kernel --kernel b3 \
        --ablate noLoop noGuard tf32x1 noFK oneAcc
    python3 -m diffco_tpu_torch.scripts.ab_kernel --kernel b1 \
        --supports 4096 --fitted --ablate oneAcc regsSums
    python3 -m diffco_tpu_torch.scripts.ab_kernel --kernel b2 --planar \
        --source build/parent/diffco_tpu_torch/csrc/poly_score.cu
    python3 -m diffco_tpu_torch.scripts.ab_kernel --kernel b3 --rope \
        --supports 8192 --ablate wideOneAcc wideRegsSums
    python3 -m diffco_tpu_torch.scripts.ab_kernel --kernel b3 --wide-rope \
        --source build/parent/diffco_tpu_torch/csrc/chain_score.cu \
        --ablate wideChunkSums wideNoP1 wideNoP2 wideNoTransform wideNoFK \
        wideNoBackward wideRows128

``--source OTHER.cu`` is any source that defines the kernel's C entry
(``chain_multi_score_grad``, ``dh_multi_score_grad``, ``dh_score_grad``,
``poly_score_grad`` or ``chain_score_grad``) with the production
signature, for example the file as an earlier commit had it (``git
archive`` into an ignored directory); it is held against the plain twin
(score 1e-4, gradient 1e-3, as chip_smoke.py) before it is timed.
``--ablate`` builds copies of ``csrc/`` with one part of the kernel taken
out (``ABLATIONS``: phase A, phase B, the class table, the compensated
score, the register instance's class sums, the epilogue), which
attributes the production kernel's time to its parts; their results are
wrong by design and are not checked. Every build uses the flags of
``ops/_native.py`` and is launched as the production wrapper launches,
outputs allocated per call.

Shapes (seeds fixed; supports are FK points of random configurations,
weights N(0, 0.05^2)): ``chain`` is the FrankaPanda multi-class path's
(B = 65573, S = 1024, C = 5 and 8 by default), ``dh`` chip_smoke's B4
row on PandaFK (B = 65573, S = 512, C = 1, 2, 3, 5 and 8), ``b1``
chip_smoke's B1 row (PandaFK, B = 65573, S = 512, one weight column),
``b2`` its B2 row (PandaFK's points of those configurations, F = 21) and
``b3`` its B3 row (FrankaPanda, B = 65573, S = 512). ``--supports S``
takes another S for ``b1``, ``b2`` and ``b3``; ``--fitted`` (``b1`` and
``b2``) replaces the random weights by those of a fitted proxy, which
cancel: the polyharmonic weights that interpolate the supports'
ground-truth labels in the box + sphere scene of
tests/test_checkers.py::panda_world (capsule chain, link radius 0.15;
``masked_rbf_solve``, every row valid), as chip_smoke.py's B1 check at
large S. ``--planar`` (``b2``) takes chip_smoke.py's planar escape proxy
instead: a q-space DiffCo fitted in 1rect_1circle (2 DOF, scripts/
escape_2d.py's defaults) scored on its 400 x 400 unified grid (B =
160000, F = 2), where B2 runs its fp64 instance; every build is held to
the float64 twin there, except a ``--source``, whose error is reported
only (the tensor-core build this instance replaced misses the
tolerance there).

The tensor-core block's ablations, which B1, B2 and B3 share
(``B1_ABLATIONS``, ``B2_ABLATIONS``, ``B3_ABLATIONS``): ``noGuard`` never
takes the near-pair guard, ``tf32x1`` runs both products in plain TF32
instead of 3xTF32, ``noLoop`` leaves out the support loop's products and
pair work (what remains is staging, FK, centring and the epilogue).
B1's also: ``oneAcc`` sums product 2 in one accumulator over all
supports (its design before per-chunk sums), ``regsSums`` keeps the
per-chunk sums in registers at every FP (production keeps them in
shared memory at FP = 24, where registers spill: each build's ptxas
report is in the result), ``directDist`` computes every d2 by direct difference
(product 1 off: the block's step A), ``noP2`` takes product 2 out (the
gradient sums), ``noEpilogue`` leaves out the backward, ``noFK`` the FK
(the rows' points stay zero). B3's: ``noFK`` (the chain FK out; the rows'
points stay zero). B2's and B3's
``oneAcc``: product 2 in one accumulator over all supports instead of one
per chunk (``kTcPointSums = kTcSumsOne``); ``wideOneAcc`` the same only
where production keeps the running sums in shared memory (B2 at FP = 56
and 64, B3 at 64; their design before the per-chunk sums there);
``wideRegsSums`` per-chunk sums with the running sums in registers there
instead (which spill). ``--rope [LINKS]`` (``b2``,
``b3``) runs them on the marked rope
(``robot_data.generate_marked_rope_urdf()``, 21 points on 11 moving
joints: FP = 64; 9 links, 17 points, FP = 56) with a fitted proxy of
``--supports`` supports (``rope_ball_gt``'s labels), every build held to
or reported against the float64 twin, as chip_smoke.py's
``check_tc_large_s``. ``--wide-rope`` (``b2``, ``b3``) runs the wide
instances (``csrc/wide_score_block.cuh``) at the 35-link rope's fitted
sweep, chip_smoke.py's multi-robot shape: ``robot_data.
generate_rope_urdf(35)`` (34 points on 35 moving joints, F = 102), ``--supports``
supports (default 1536; 512 for the shorter sweep) with the weights that
interpolate ``rope_ball_gt``'s +-1 labels, B2 from the points and B3
from q (its ``chain_score_grad_wide`` entry; B2 through
``poly_score_grad_wide``), each after its build's prologue
(``wide_prep``), every build held to or reported against the float64
twin; a ``--source`` of the parent's file times the parent's wide design
in the same process (a source from before the prologue launches without
it). The wide block's ablations (``WIDE_ABLATIONS``): ``wideChunkSums``
sums product 2 per chunk of 32 supports into running sums (the design the
block keeps one fp64 accumulator in place of), ``wideNoP2`` takes
product 2 out, ``wideNoP1`` product 1 (d2 from the norms alone),
``wideNoTransform`` the per-call preparation of the supports (the
prologue returns at once; the buffer stays unwritten), ``wideRows128``
runs 128 rows and 8 warps a block (one block per SM, 4 chunk buffers: a
design, not a part, whose error matches production's), ``wideNoFK`` (b3)
the chain FK (the rows' points stay as staged) and ``wideNoBackward``
(b3) the joints' backward. ``directDist`` and
``tf32x1`` compute the function and their error against the twin (and a
float64 twin) is reported beside their time, which shows what the split
buys; none of them is held to the tolerance. Each build is
timed against the production kernel in turns (production, other, other,
production; CUDA events, 50 launches after 5 warm-ups each), and each C
records the production launch plan (``_native.*_multi_plan_on_card``;
``dh_score_plan_on_card``, ``poly_score_plan_on_card``,
``chain_score_plan_on_card`` for B1, B2, B3).
The result goes to ``--out`` (default
``build/diffco_tpu_torch/ab_kernel-<kernel>.json``) and is printed as
JSON with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import shutil
import subprocess
from pathlib import Path

import torch

from ..ops import _native, fk_score, fused_score
from ..robots import PandaFK
from ..robots.urdf import FrankaPanda
from .roofline_fk_score import card_info, write_result

B = 65536 + 37
# kernel -> its source, C entry, supports and default classes
KERNELS = {
    'chain': dict(source='chain_multi_score.cu',
                  entry='chain_multi_score_grad', S=1024, classes=(5, 8)),
    'dh': dict(source='dh_multi_score.cu', entry='dh_multi_score_grad',
               S=512, classes=(1, 2, 3, 5, 8)),
    'b1': dict(source='dh_score.cu', entry='dh_score_grad', S=512,
               classes=None),
    'b2': dict(source='poly_score.cu', entry='poly_score_grad', S=512,
               classes=None),
    'b3': dict(source='chain_score.cu', entry='chain_score_grad', S=512,
               classes=None),
}
_MSB = 'multi_score_block.cuh'
# name -> [(file, text, replacement)]: each takes one part of the kernel
# out (file None: the kernel's own source); parts of the product
# instances and of the register instance alike
ABLATIONS = {
    'noA': [(_MSB, 'for (int jj = 0; jj < KH; ++jj) {',
             'for (int jj = 0; jj < 0; ++jj) {'),
            (_MSB, 'for (int i = 0; i < KH; ++i) {',
             'for (int i = 0; i < 0; ++i) {')],
    'noB': [(_MSB, 'for (int k = 0; k < K; ++k) {',
             'for (int k = 0; k < 0; ++k) {')],
    'noZ': [(_MSB,
             'for (int i = 0; i < K * kMultiCols / kMultiThreads; ++i) {',
             'for (int i = 0; i < 0; ++i) {')],
    'noTwoSum': [(_MSB,
                  'two_sum_add(wb[j * kWStride + k0 + c] * r, sc[c], '
                  'comp[c]);',
                  'sc[c] = fmaf(wb[j * kWStride + k0 + c], r, sc[c]);'),
                 (_MSB, 'two_sum_add(w * r, sc[c], comp[c]);',
                  'sc[c] = fmaf(w, r, sc[c]);')],
    'noSums': [(_MSB, 'for (int g = 0; g < FP / 4; ++g) {',
                'for (int g = 0; g < 0; ++g) {')],
    'noEpilogue': [(None, 'if (slot >= cg) return;', 'return;')],
}
_TCB = 'tc_score_block.cuh'
# the tensor-core block's parts, which B1, B2 and B3 share
_TC_ABLATIONS = {
    'noLoop': [(_TCB, 'for (int nt = 0; nt < K / 8; ++nt) {',
                'for (int nt = 0; nt < 0; ++nt) {')],
    'noGuard': [(_TCB, 'if (fminf(fminf(slack[0], slack[1]), fminf(slack[2], slack[3])) <',
                 'if (false &&')],
    'tf32x1': [(_TCB, 'constexpr int kTcSplit = 3;',
                'constexpr int kTcSplit = 1;')],
}
_DH_SUMS = 'constexpr int kDhSums = FP == 24 ? kTcSumsShared : kTcSumsRegs;'
_DHR = 'dh_tc_rows.cuh'
B1_ABLATIONS = {
    'oneAcc': [(_DHR, _DH_SUMS, 'constexpr int kDhSums = kTcSumsOne;')],
    'regsSums': [(_DHR, _DH_SUMS, 'constexpr int kDhSums = kTcSumsRegs;')],
    'directDist': [(_TCB, 'constexpr bool kTcDist = true;',
                    'constexpr bool kTcDist = false;')],
    'noP2': [(_TCB, 'if (n2 < nt2)\n', 'if (n2 < 0)\n')],
    'noEpilogue': [(None, 'if (tid < kTcRows) {  // the epilogue',
                    'if (false) {  // the epilogue')],
    'noFK': [(None,
              'if (tid < kTcRows) dh_row_fk<FP>(q, b, live, sp, xrow, axes);',
              'if (tid < kTcRows)\n'
              '    for (int f = 0; f < FP; ++f) xrow[f] = 0.f;')],
    **_TC_ABLATIONS,
}
_POINT_SUMS = ('constexpr int kTcPointSums = FP <= kRegsMaxFP ? '
               'kTcSumsRegs : kTcWideSums;')
_WIDE_SUMS = 'constexpr int kTcWideSums = kTcSumsShared;'
# B2's and B3's product-2 sums (tc_score_block.cuh's kTcPointSums): one
# accumulator at every FP; or where the running sums sit in shared
# memory (B2 at FP = 56 and 64, B3 at 64: their design before the
# per-chunk sums there); or per-chunk sums in registers there
_POINT_SUMS_ABLATIONS = {
    'oneAcc': [(_TCB, _POINT_SUMS,
                'constexpr int kTcPointSums = kTcSumsOne;')],
    'wideOneAcc': [(_TCB, _WIDE_SUMS,
                    'constexpr int kTcWideSums = kTcSumsOne;')],
    'wideRegsSums': [(_TCB, _WIDE_SUMS,
                      'constexpr int kTcWideSums = kTcSumsRegs;')],
}
_WSB, _CW = 'wide_score_block.cuh', 'chain_wide.cuh'
# the wide block's parts (module docstring)
WIDE_ABLATIONS = {
    'wideChunkSums': [(_WSB, 'constexpr bool kWideChunkSums = false;',
                       'constexpr bool kWideChunkSums = true;')],
    'wideNoP2': [(_WSB, 'for (int kk = 0; kk < 8 / J2; ++kk) {',
                  'for (int kk = 0; kk < 0; ++kk) {')],
    'wideNoP1': [(_WSB, 'for (int ks = 0; ks < KS1; ++ks)',
                  'for (int ks = 0; ks < 0; ++ks)')],
    'wideNoTransform': [(_WSB, '  const int n0 = min(S, kWideChunk);',
                         '  if (S >= 0) return;\n'
                         '  const int n0 = min(S, kWideChunk);')],
    'wideRows128': [(_WSB, 'constexpr int kWideRowTiles = 4;',
                     'constexpr int kWideRowTiles = 8;')],
}
_WIDE_FK_ABLATIONS = {
    'wideNoFK': [(_CW, 'chain_fk<kWideMaxCP>(',
                  'if (false) chain_fk<kWideMaxCP>(')],
    'wideNoBackward': [(_CW, 'for (int m = lane; m < M; m += 32) {',
                        'for (int m = lane; m < 0; m += 32) {')],
}
B2_ABLATIONS = {**_POINT_SUMS_ABLATIONS, **_TC_ABLATIONS, **WIDE_ABLATIONS}
B3_ABLATIONS = {
    **_POINT_SUMS_ABLATIONS,
    'noFK': [(None, 'chain_fk<KP>(qb, live, sp, fr, zo, xrow);', '')],
    **_TC_ABLATIONS,
    **WIDE_ABLATIONS,
    **_WIDE_FK_ABLATIONS,
}


def _ptxas(log):
    """'<mangled kernel>: <registers> regs/<spill> B spilled' for each
    kernel instance in nvcc's -Xptxas -v output."""
    out, name, spill = [], None, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r'(\d+) bytes spill stores', ln)
        if m:
            spill = m.group(1)
        m = re.search(r'Used (\d+) registers', ln)
        if m and name:
            out.append(f'{name}: {m.group(1)} regs/{spill} B spilled')
    return out


def _build_all(sources, entry, lib=None):
    """({source: its C entry}, {source: its ptxas report}), each source
    built into a library with the production flags (one nvcc per source
    not yet built, all started together; a build's nvcc output is kept
    beside it). ``lib``: the production library whose ``entry`` gives the
    argument types (default ``entry`` without ``_grad``); ``entry`` may be
    a function of the source (the production library's entry of that name
    gives the types). A build with the wide block's prologue
    (``_wide_prologue``) has its ``wide_prep`` entry in
    ``PROLOGUES[source]``."""
    outs, procs, reports = {}, [], {}
    _native._BUILD.mkdir(parents=True, exist_ok=True)
    for source in sources:
        src = Path(source).resolve()
        h = hashlib.sha256()   # the source and every header beside it
        for p in sorted(src.parent.glob('*.cu*')):
            h.update(p.name.encode() + p.read_bytes())
        out = outs[source] = (_native._BUILD /
                              f'ab-{src.stem}-{h.hexdigest()[:12]}.so')
        if not out.exists():
            procs.append((source, src, out, subprocess.Popen(
                [_native._nvcc(), *_native._NVCC_FLAGS, '-o', str(out),
                 str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for source, src, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {src}:\n{log}')
        out.with_suffix('.log').write_text(log)
    for source, out in outs.items():
        log = out.with_suffix('.log')
        reports[source] = _ptxas(log.read_text()) if log.exists() else []
    name_of = entry if callable(entry) else (lambda source: entry)
    prod = _native.build()[lib or name_of(sources[0]).replace('_grad', '')]
    fns = {}
    for source, out in outs.items():
        name = name_of(source)
        lib_ = ctypes.CDLL(str(out))
        fn = fns[source] = getattr(lib_, name)
        fn.argtypes = getattr(prod, name).argtypes
        fn.restype = ctypes.c_int
        if _wide_prologue(source):
            prep = PROLOGUES[source] = lib_.wide_prep
            prep.argtypes = prod.wide_prep.argtypes
            prep.restype = ctypes.c_int
    return fns, reports


# source -> the wide block's prologue entry of its build (_build_all)
PROLOGUES = {}


def _wide_prologue(source):
    """Whether the wide instances of the build of ``source`` read the
    supports from the wide block's prologue (``wide_launch.cuh``; this
    tree's do, a source from before it, the parent's, does not)."""
    return (Path(source).resolve().parent / 'wide_launch.cuh').exists()


def _wide_scratch(source):
    """Whether the wide entries of the build of ``source`` take the
    joints' scratch (``zo``) after the spec's device copy (this tree's
    do; a source from before it, the parent's, does not)."""
    launch = Path(source).resolve().parent / 'chain_wide_launch.cuh'
    return 'float* zo' in launch.read_text()


def ablation_table(kernel):
    """The named ablations a kernel takes: B1_ABLATIONS, B2_ABLATIONS and
    B3_ABLATIONS for ``b1``, ``b2`` and ``b3``, ABLATIONS for the
    multi-class kernels."""
    return {'b1': B1_ABLATIONS, 'b2': B2_ABLATIONS,
            'b3': B3_ABLATIONS}.get(kernel, ABLATIONS)


def _ablated(name, kernel):
    """csrc/ copied to the build directory with the ablation ``name`` of
    ``ablation_table(kernel)`` applied; the path of the kernel's source
    there."""
    source = KERNELS[kernel]['source']
    d = _native._BUILD / f'ablate-{kernel}-{name}'
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_native._CSRC, d)
    for fname, text, repl in ablation_table(kernel)[name]:
        path = d / (fname or source)
        body = path.read_text()
        if body.count(text) != 1:
            raise RuntimeError(f'ablation {name}: {text!r} not once in '
                               f'{path.name}')
        path.write_text(body.replace(text, repl))
    return d / source


def _time_ms(fn, warmup=5, iters=50):
    for _ in range(warmup):
        fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _setup(kernel, dev, g):
    """(spec for the wrappers, its ctypes struct, q, supports, production
    wrapper, plain twin, plan-on-card) at the kernel's shape."""
    S = KERNELS[kernel]['S']
    if kernel == 'chain':
        robot = FrankaPanda(load_gripper=True, device=dev)
        spec = fk_score.robot_chain_statics(robot)
        return (spec, fk_score._c_chain_spec(spec),
                robot.rand_configs(B, g, dev),
                robot.fkine(robot.rand_configs(S, g, dev)).reshape(S, -1),
                fk_score.chain_multi_score_grad,
                fk_score._chain_multi_score_grad_plain,
                _native.chain_multi_plan_on_card)
    robot = PandaFK()
    spec = fk_score.robot_spec(robot)
    return (spec, fk_score._c_spec(spec), robot.rand_configs(B, g, dev),
            robot.fkine(robot.rand_configs(S, g, dev), flat=True),
            fk_score.dh_multi_score_grad,
            fk_score._dh_multi_score_grad_plain,
            _native.dh_multi_plan_on_card)


def _errors(score, dq, ref, ref_dq):
    return dict(max_abs_err=max(float((score - ref).abs().max()),
                                float((dq - ref_dq).abs().max())),
                within_tol=bool(
                    torch.allclose(score, ref, rtol=1e-4, atol=1e-4)
                    and torch.allclose(dq, ref_dq, rtol=1e-3, atol=1e-3)))


def _fitted_weights(robot, qs, sup):
    """The polyharmonic weights interpolating the +-1 ground-truth labels
    of configurations qs (points sup) in panda_world's box + sphere scene
    (module docstring)."""
    import numpy as np
    from ..device import fp32_matmul
    from ..envs import ShapeEnv
    from ..kernels import Polyharmonic
    from ..perceptron import masked_rbf_solve
    from ..robots.capsule_chain import CapsuleChainCollision

    def pose(t):
        m = np.eye(4)
        m[:3, 3] = t
        return m
    env = ShapeEnv({
        'box1': {'type': 'Box', 'params': {'extents': [0.1, 0.1, 0.1]},
                 'transform': pose([0.5, 0.5, 0.5])},
        'sphere1': {'type': 'Sphere', 'params': {'radius': 0.1},
                    'transform': pose([0.5, 0, 0])}})
    y = CapsuleChainCollision(robot, link_radius=0.15).checker_fn(env)(
        qs).float() * 2 - 1
    with fp32_matmul():
        return masked_rbf_solve(
            Polyharmonic(k=1, epsilon=1)(sup, sup), y,
            torch.ones(sup.shape[0], dtype=torch.bool,
                       device=sup.device)).contiguous()


# the marked rope's ground truth (--rope; chip_smoke.py's
# check_tc_large_s): a configuration collides where a control point lies
# inside this ball (about a third of random configurations do)
ROPE_BALL, ROPE_BALL_RADIUS = (0.2, 0.0, 0.2), 0.2


def rope_ball_gt(robot, center=ROPE_BALL, radius=ROPE_BALL_RADIUS):
    """q [B, D] -> bool [B]: whether any control point of the robot lies
    inside the ball."""
    def gt(q):
        c = torch.as_tensor(center, dtype=q.dtype, device=q.device)
        return ((robot.fkine(q) - c).norm(dim=-1) < radius).any(-1)
    return gt


def _rope_setup(kernel, dev, g, S, links=11):
    """B2 or B3 on the marked rope of ``links`` links (2 links - 1 points
    on ``links`` moving joints: FP = 64 at 11 and 10, 56 at 9) with a
    fitted proxy's weights: those interpolating rope_ball_gt's +-1 labels
    of the S supports' configurations."""
    from .. import robot_data
    from ..device import fp32_matmul
    from ..kernels import Polyharmonic
    from ..perceptron import masked_rbf_solve
    from ..robots.urdf import URDFRobot
    robot = URDFRobot(robot_data.generate_marked_rope_urdf(n_links=links),
                      device=dev, setup_acm=False)
    qs = robot.rand_configs(S, g, dev)
    sup = robot.fkine(qs).reshape(S, -1).contiguous()
    y = rope_ball_gt(robot)(qs).float() * 2 - 1
    with fp32_matmul():
        w = masked_rbf_solve(Polyharmonic(k=1, epsilon=1)(sup, sup), y,
                             torch.ones(S, dtype=torch.bool, device=dev))
    q = robot.rand_configs(B, g, dev)
    if kernel == 'b3':
        spec = fk_score.robot_chain_statics(robot)
        c = fk_score._c_chain_spec(spec)
        return ((q, sup, w.contiguous()), fk_score.chain_score_grad,
                fk_score._chain_score_grad_plain, spec, (ctypes.byref(c),),
                c.D, _native.chain_score_plan_on_card(c.P, c.M))
    x = robot.fkine(q).reshape(B, -1).contiguous()
    F = x.shape[1]
    return ((x, sup, w.contiguous()),
            lambda x, s, w, _: fused_score.poly_score_grad(x, s, w),
            lambda x, s, w, _: fused_score._poly_score_grad_plain(x, s, w),
            None, (F,), F, _native.poly_score_plan_on_card(F))


WIDE_ROPE_LINKS = 35


def _wide_rope_setup(kernel, dev, g, S):
    """B2 or B3 at the 35-link rope's fitted sweep (``--wide-rope``, module
    docstring): their wide instances, with the weights that interpolate
    rope_ball_gt's +-1 labels of the S supports' configurations."""
    from .. import robot_data
    from ..device import fp32_matmul
    from ..kernels import Polyharmonic
    from ..perceptron import masked_rbf_solve
    from ..robots.urdf import URDFRobot
    robot = URDFRobot(robot_data.generate_rope_urdf(n_links=WIDE_ROPE_LINKS),
                      device=dev, setup_acm=False, link_spheres=1)
    qs = robot.rand_configs(S, g, dev)
    sup = robot.fkine(qs).reshape(S, -1).contiguous()
    y = rope_ball_gt(robot)(qs).float() * 2 - 1
    with fp32_matmul():
        w = masked_rbf_solve(Polyharmonic(k=1, epsilon=1)(sup, sup), y,
                             torch.ones(S, dtype=torch.bool, device=dev))
    q = robot.rand_configs(B, g, dev)
    if kernel == 'b3':
        spec = fk_score.robot_chain_statics(robot)
        c = fk_score._c_chain_spec(spec)
        assert isinstance(c, _native.ChainSpecWide)
        keep = (fk_score._on_device(bytes(c), torch.device(dev)),
                q.new_empty(_native.wide_scratch_floats(B, c.M)))
        # the spec's device copy and the scratch, both referenced by the
        # plan's 'keep' while the builds run
        tail = (ctypes.byref(c), *(ctypes.c_void_p(t.data_ptr())
                                   for t in keep))
        return ((q, sup, w.contiguous()), fk_score.chain_score_grad,
                fk_score._chain_score_grad_plain, spec, tail, c.D,
                dict(_native.chain_wide_plan_on_card(c.P, c.M), keep=keep))
    x = robot.fkine(q).reshape(B, -1).contiguous()
    F = x.shape[1]
    return ((x, sup, w.contiguous()),
            lambda x, s, w, _: fused_score.poly_score_grad(x, s, w),
            lambda x, s, w, _: fused_score._poly_score_grad_plain(x, s, w),
            None, (F,), F, _native.poly_score_plan_on_card(F))


def _planar_proxy(dev):
    """chip_smoke.py's planar escape proxy on its unified grid (module
    docstring): (x [160000, 2], supports, weights)."""
    from .. import kernels, routines
    from ..envs.presets2d import get_env
    from ..geometry.geometry2d import Obstacles2D, planar_robot_collision
    from ..perceptron import DiffCo
    from ..robots.analytic import RevolutePlanarRobot
    robot = RevolutePlanarRobot(3.5, link_width=0.3, dof=2)
    obs = Obstacles2D.from_obstacle_list(get_env('1rect_1circle'))
    q = robot.rand_configs(4000, torch.Generator().manual_seed(0), dev)
    p = DiffCo(kernel_func=kernels.RQKernel(10.0))
    p.train(q, planar_robot_collision(robot, obs, q).float() * 2 - 1,
            max_iteration=3 * 4000)
    p.fit_poly(kernels.Polyharmonic(1, 1), target='label')
    w = p.rbf_nodes.reshape(-1) * p.valid_mask.float() / p.rbf_kernel.epsilon
    return (routines.generate_unified_grid(400, 400, device=dev),
            p.support_transformed.contiguous(), w.contiguous())


def _single_setup(kernel, dev, g, S=None, fitted=False, planar=False,
                  rope=False, wide_rope=False):
    """One weight column at the kernel's shape (module docstring), or S
    supports, with a fitted proxy's weights, or the planar proxy, or the
    marked rope's fitted proxy: (the production wrapper's arguments, the
    wrapper, its plain twin on given arguments, the C entry's arguments
    after the output pointers, the gradient's columns, the launch plan on
    the card)."""
    if wide_rope:
        return _wide_rope_setup(kernel, dev, g, S or 1536)
    if rope:
        return _rope_setup(kernel, dev, g, S or KERNELS[kernel]['S'], rope)
    if planar:
        x, sup, w = _planar_proxy(dev)
        return ((x, sup, w),
                lambda x, s, w, _: fused_score.poly_score_grad(x, s, w),
                lambda x, s, w, _: fused_score._poly_score_grad_plain(x, s, w),
                None, (2,), 2, _native.poly_score_plan_on_card(2))
    S = S or KERNELS[kernel]['S']
    if fitted and kernel == 'b3':
        raise ValueError('--fitted takes b1 or b2 (PandaFK)')
    if kernel == 'b3':
        robot = FrankaPanda(load_gripper=True, device=dev)
        spec = fk_score.robot_chain_statics(robot)
        c = fk_score._c_chain_spec(spec)
        q = robot.rand_configs(B, g, dev)
        sup = robot.fkine(robot.rand_configs(S, g, dev)).reshape(S, -1)
        w = (torch.randn(S, generator=g) * 0.05).to(dev)
        return ((q, sup.contiguous(), w), fk_score.chain_score_grad,
                fk_score._chain_score_grad_plain, spec, (ctypes.byref(c),),
                c.D, _native.chain_score_plan_on_card(c.P, c.M))
    robot = PandaFK()
    spec = fk_score.robot_spec(robot)
    c = fk_score._c_spec(spec)
    q = robot.rand_configs(B, g, dev)
    qs = robot.rand_configs(S, g, dev)
    sup = robot.fkine(qs, flat=True).contiguous()
    w = (torch.randn(S, generator=g) * 0.05).to(dev)
    if fitted:
        w = _fitted_weights(robot, qs, sup)
    if kernel == 'b2':
        x = robot.fkine(q, flat=True).contiguous()
        F = x.shape[1]
        return ((x, sup, w),
                lambda x, s, w, _: fused_score.poly_score_grad(x, s, w),
                lambda x, s, w, _: fused_score._poly_score_grad_plain(x, s, w),
                None, (F,), F, _native.poly_score_plan_on_card(F))
    return ((q, sup, w), fk_score.dh_score_grad,
            fk_score._dh_score_grad_plain, spec, (ctypes.byref(c),), c.J,
            _native.dh_score_plan_on_card(c.P))


def run_single(builds, kernel, S=None, fitted=False, planar=False,
               rope=False, wide_rope=False):
    """B1, B2 or B3: {name: (source, check)} timed against production,
    with each build's error against the fp32 twin and against a float64
    twin (max |diff|, and that over max |twin|, for score and gradient)
    and its ptxas report. A build with ``check`` (another build of the C
    entry) must agree with the fp32 twin; an ablation is reported only.
    With ``fitted`` the builds are held to the float64 twin instead: the
    fp32 twin's own rounding takes up the tolerance there; so with
    ``planar`` and ``rope``, where another build is reported only (the
    designs they replaced miss the tolerance there); with ``wide_rope``
    B3 runs its ``chain_score_grad_wide`` entry."""
    dev = torch.device('cuda')
    entry = KERNELS[kernel]['entry']
    if wide_rope and kernel == 'b3':
        entry += '_wide'
    # B2's wide instance has its own entry since the prologue
    entry_of = (lambda src: entry + '_wide' if _wide_prologue(src)
                else entry) if wide_rope and kernel == 'b2' else entry
    libs, ptxas = _build_all([src for src, _ in builds.values()], entry_of,
                             KERNELS[kernel]['source'][:-3])
    g = torch.Generator().manual_seed(0)
    args, wrapper, plain, spec, tail, n_grad, plan = _single_setup(
        kernel, dev, g, S, fitted, planar, rope, wide_rope)
    plan = dict(plan)
    keep = plan.pop('keep', None)   # the tail points into these
    for src, _ in builds.values():
        fn = libs[src]
        if keep is not None and not _wide_scratch(src):
            # an older wide entry: no scratch
            fn.argtypes = fn.argtypes[:-2] + fn.argtypes[-1:]
        if kernel == 'b3' and wide_rope and not _wide_prologue(src):
            # a wide entry from before the prologue reads s and w
            fn.argtypes = [fn.argtypes[0], ctypes.c_void_p,
                           *fn.argtypes[1:]]
    fitted = fitted or planar or rope or wide_rope
    if planar or rope or wide_rope:
        builds = {k: (src, False) for k, (src, _) in builds.items()}
    Bq, S = args[0].shape[0], args[1].shape[0]
    r64, r64_g = plain(*(a.double() for a in args), spec)
    ref, ref_g = (r64, r64_g) if fitted else plain(*args, spec)

    def prod():
        return wrapper(*args, spec)

    res = dict(kernel=kernel, fitted=fitted,
               shape=dict(B=Bq, S=S, F=args[1].shape[1], grad=n_grad),
               plan=plan, builds={})
    for name, (src, check) in builds.items():
        fn = libs[src]

        own_tail = (tail if keep is None or _wide_scratch(src)
                    else tail[:-1])
        prep = PROLOGUES.get(src) if wide_rope else None

        def alt(fn=fn, own_tail=own_tail, prep=prep):
            # as the wrapper: allocate, launch (the prologue first, where
            # the build has one, into a buffer the entry reads in place
            # of s and w), check
            score, grad = args[0].new_empty(Bq), args[0].new_empty(
                (Bq, n_grad))
            stream = torch.cuda.current_stream(dev).cuda_stream
            inputs = args
            if prep is not None:
                s, w = args[1], args[2]
                buf = s.new_empty(2 * _native.wide_prep_doubles(
                    S, s.shape[1], 1))
                _native.raise_on_error(f'wide_prep ({name})', prep(
                    s.data_ptr(), w.data_ptr(), S, s.shape[1], 1,
                    buf.data_ptr(), stream))
                inputs = (args[0], buf)
            _native.raise_on_error(f'{entry} ({name})', fn(
                *(t.data_ptr() for t in (*inputs, score, grad)), Bq, S,
                *own_tail, stream))
            return score, grad
        row = {}
        for who, f in (('production', prod), (name, alt)):
            score, grad = f()
            torch.cuda.synchronize()
            err = _errors(score.to(ref.dtype), grad.to(ref.dtype), ref,
                          ref_g)
            if (who == 'production' or check) and not err['within_tol']:
                raise AssertionError(f'{who} disagrees with the plain twin: '
                                     f'{err}')
            d = (score.double() - r64).abs().max(), \
                (grad.double() - r64_g).abs().max()
            row[f'{who}_err'] = dict(
                err, abs_err_vs_float64=dict(score=float(d[0]),
                                             grad=float(d[1])),
                rel_err_vs_float64=dict(
                    score=float(d[0] / r64.abs().max()),
                    grad=float(d[1] / r64_g.abs().max())))
        t = [_time_ms(f) for f in (prod, alt, alt, prod)]
        res['builds'][name] = dict(row, production_ms=t[::3],
                                   other_ms=t[1:3], ptxas=ptxas[src])
    return res


def run(builds, classes=None, kernel='chain', S=None, fitted=False,
        planar=False, rope=False, wide_rope=False):
    """{name: (source, check)} timed against production (module
    docstring)."""
    if kernel in ('b1', 'b2', 'b3'):
        return run_single(builds, kernel, S, fitted, planar, rope, wide_rope)
    dev = torch.device('cuda')
    entry = KERNELS[kernel]['entry']
    classes = classes or KERNELS[kernel]['classes']
    libs, _ = _build_all([src for src, _ in builds.values()], entry)
    fns = {name: (libs[src], check) for name, (src, check) in
           builds.items()}
    g = torch.Generator().manual_seed(0)
    spec, c, q, sup, wrapper, plain, plan = _setup(kernel, dev, g)
    S, D = sup.shape[0], q.shape[1]
    res = dict(kernel=kernel, shape=dict(B=B, S=S, P=c.P, D=D), classes={})
    for C in classes:
        W = (torch.randn(S, C, generator=g) * 0.05).to(dev)
        args = (q, sup.contiguous(), W)
        ref, ref_dq = plain(*args, spec)

        def prod():
            return wrapper(*args, spec)

        out = res['classes'][C] = {'plan': plan(c.P, C)}
        for name, (fn, check) in fns.items():
            def alt(fn=fn):   # as the wrapper: allocate, launch, check
                score = q.new_empty((B, C))
                dq = q.new_empty((C, B, D))
                _native.raise_on_error(f'{entry} ({name})', fn(
                    *(t.data_ptr() for t in (*args, score, dq)), B, S, C,
                    ctypes.byref(c),
                    torch.cuda.current_stream(dev).cuda_stream))
                return score, dq
            row = {}
            for who, f in (('production', prod), (name, alt)):
                if who == name and not check:
                    continue
                score, dq = f()
                torch.cuda.synchronize()
                if not (torch.allclose(score, ref, rtol=1e-4, atol=1e-4)
                        and torch.allclose(dq, ref_dq, rtol=1e-3, atol=1e-3)):
                    raise AssertionError(f'{who} disagrees with the plain '
                                         f'twin at C = {C}')
                row[f'{who}_max_abs_err'] = max(
                    float((score - ref).abs().max()),
                    float((dq - ref_dq).abs().max()))
            t = [_time_ms(f) for f in (prod, alt, alt, prod)]
            out[name] = dict(row, production_ms=t[::3], other_ms=t[1:3])
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--kernel', choices=KERNELS, default='chain')
    ap.add_argument('--source', action='append', default=[],
                    help='another build of the C entry (repeatable)')
    ap.add_argument('--ablate', nargs='+', default=[],
                    choices=sorted({*ABLATIONS, *B1_ABLATIONS,
                                    *B2_ABLATIONS, *B3_ABLATIONS}))
    ap.add_argument('--classes', type=int, nargs='+', default=None)
    ap.add_argument('--supports', type=int, default=None,
                    help='S for b1, b2, b3 (default: the module docstring)')
    ap.add_argument('--fitted', action='store_true',
                    help="b1, b2: a fitted proxy's weights")
    ap.add_argument('--planar', action='store_true',
                    help="b2: the planar escape proxy's grid (F = 2)")
    ap.add_argument('--rope', type=int, nargs='?', const=11, default=0,
                    metavar='LINKS',
                    help="b2, b3: the marked rope's fitted proxy (11 links, "
                    'FP = 64, unless LINKS is given: 9 is FP = 56)')
    ap.add_argument('--wide-rope', action='store_true',
                    help="b2, b3: the 35-link rope's fitted sweep on their "
                    'wide instances (S = 1536 unless --supports)')
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    table = ablation_table(args.kernel)
    if any(name not in table for name in args.ablate):
        ap.error(f'--kernel {args.kernel} takes the ablations {list(table)}')
    builds = {src: (src, True) for src in args.source}
    builds.update({name: (_ablated(name, args.kernel), False)
                   for name in args.ablate})
    if not builds:
        ap.error('give --source or --ablate')
    if (args.supports or args.fitted) and args.kernel not in ('b1', 'b2',
                                                             'b3'):
        ap.error('--supports and --fitted take b1, b2 or b3')
    if args.planar and args.kernel != 'b2':
        ap.error('--planar takes b2')
    if (args.rope or args.wide_rope) and args.kernel not in ('b2', 'b3'):
        ap.error('--rope and --wide-rope take b2 or b3')
    res = run(builds, args.classes, args.kernel, args.supports, args.fitted,
              args.planar, args.rope, args.wide_rope)
    res.update(card_info(torch.device('cuda')))
    write_result(res, args.out or
                 _native._BUILD / f'ab_kernel-{args.kernel}.json')
    print(json.dumps({'ab_kernel': res}), flush=True)


if __name__ == '__main__':
    main()
