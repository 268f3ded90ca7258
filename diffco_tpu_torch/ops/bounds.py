"""Least-time bounds of the repo's seven TPU kernels (B1-B7) on one H100.

A bound is the larger of two times for the same work: the bytes the
function must move (each input read once, each output written once) over
the card's memory rate, and the fp32 operations it needs over the card's
fp32 rate (an FMA is 2 operations, an rsqrt, sin or cos 1). Score-block
operations are counted in the TPU kernels' expanded form
``||x||^2 + ||s||^2 - 2 x.s``; FK and backward operations are counted
from the hand-written CUDA code (``csrc/dh_chain.cuh``,
``csrc/chain_fk.cuh``) or, for the kernels not ported yet, from the ported
kernels they extend. ``chip_smoke.py`` computes every kernel's bound with
these functions from each run's inputs;

    python3 -m diffco_tpu_torch.ops.bounds

prints the bounds of all seven at the shapes PERF.md states (no card
needed: this is arithmetic on shapes).

B1, B2 and B3 run their two matrix products on the tensor cores
(``csrc/dh_score.cu``, ``poly_score.cu`` and ``chain_score.cu`` on
``csrc/tc_score_block.cuh``), so their least time on that route is
``tc_bound`` (``dh_tc_bound``, ``poly_tc_bound``, ``chain_tc_bound``):
the largest of the bytes over HBM, the two products in 3xTF32 over the
TF32 peak, and the work left on the CUDA cores over the fp32 peak. B6
runs B1's function on B1's block, so its tensor-core bound is
``dh_tc_bound``; each B7 rung, a prefix of B1's block, has
``ablation_tc_bound``. The fp32 bounds (the one above) stay beside them;
B4 and B5 keep theirs alone.

B2's and the FK kernels' wide instances (``csrc/wide_score_block.cuh``:
``poly_score_wide_kernel``, ``chain_wide_score_kernel``) run both
products on the fp64 tensor cores and the pair work in fp64, so their
least time on that route is ``wide_f64_tc_bound`` (``poly_wide_bound``,
``chain_wide_bound``): the largest of the bytes over HBM, the products
over the fp64 tensor-core peak, the pair, row and support work over the
fp64 peak, and the FK and backward over the fp32 peak.
"""
from __future__ import annotations

import json

# H100 SXM published peaks (NVIDIA data sheet, at 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
PEAK_TF32_FLOPS = 495e12   # dense, tensor cores
PEAK_BF16_FLOPS = 989e12   # dense, tensor cores
PEAK_FP64_TC_FLOPS = 67e12  # dense, tensor cores
PEAK_FP64_FLOPS = 34e12    # outside the tensor cores


def bound(bytes_moved, ops):
    """(least ms, 'bytes' or 'operations')."""
    t_bytes = bytes_moved / PEAK_HBM_BYTES
    t_ops = ops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes > t_ops
                                       else 'operations')


def tc_product_ops(B, S, F):
    """The two products of the tensor-core score block, as 3xTF32 runs
    them (3 products each): the cross term x . s (2F a pair) and the
    [s w | w] sums (2 (F + 1) a pair)."""
    return 3 * B * S * (2 * F + 2 * (F + 1))


# per pair on the CUDA cores beside the products: d2 from the norms and
# the cross term (3), clamp and floor (2), rsqrt (1), r (1), w r into the
# score (2), and rinv split into TF32 hi and lo (3)
TC_PAIR_OPS = 12


def tc_times(B, S, F, bytes_moved, row_ops):
    """Least times, in ms, of a kernel on the tensor-core score block
    (``csrc/tc_score_block.cuh``: B1, B2, B3) that moves ``bytes_moved``
    and does ``row_ops`` operations per row of its own (FK and backward,
    or B2's dx): 'bytes' (over HBM), 'tensor' (``tc_product_ops`` over the
    TF32 peak) and 'fp32' (per row ``row_ops`` and |x~|^2 (2F), per
    support |s~|^2 (2F), and ``TC_PAIR_OPS`` a pair, over the fp32
    peak)."""
    return dict(
        bytes=bytes_moved / PEAK_HBM_BYTES * 1e3,
        tensor=tc_product_ops(B, S, F) / PEAK_TF32_FLOPS * 1e3,
        fp32=(B * S * TC_PAIR_OPS + B * (row_ops + 2 * F) + S * 2 * F)
        / PEAK_FP32_FLOPS * 1e3)


def tc_bound(B, S, F, bytes_moved, row_ops):
    """(least ms, 'bytes' or 'operations') on the tensor-core route: the
    largest of ``tc_times`` (its operations on the tensor cores and on the
    CUDA cores run side by side)."""
    t = tc_times(B, S, F, bytes_moved, row_ops)
    ms = max(t.values())
    return ms, 'bytes' if ms == t['bytes'] else 'operations'


# fp64 operations per pair on the CUDA cores beside the wide block's
# products: once, d2 from the norms and the cross term (3), clamp and
# floor (2), rsqrt and its Newton step (4); per class w r into the score
# (2) and coef = w rinv (1)
WIDE_PAIR_OPS, WIDE_CLASS_PAIR_OPS = 9, 3


def wide_f64_tc_times(B, S, F, bytes_moved, fk_ops=0, C=1):
    """Least times, in ms, of a kernel on the wide score block
    (``csrc/wide_score_block.cuh``) with C weight columns: 'bytes' (over
    HBM), 'tensor' (the cross term x . s once, 2F a pair, and per class
    the [s | 1] sums, 2 (F + 1) a pair, over the fp64 tensor-core peak),
    'fp64' (``WIDE_PAIR_OPS`` + C ``WIDE_CLASS_PAIR_OPS`` a pair, per row
    |x~|^2 and per class its gradient x~ rowsum - su~ (2F each), per
    support |s~|^2 (2F), over the fp64 peak) and 'fp32' (per row
    ``fk_ops``, the FK and backward, over the fp32 peak)."""
    return dict(
        bytes=bytes_moved / PEAK_HBM_BYTES * 1e3,
        tensor=B * S * (2 * F + C * 2 * (F + 1)) / PEAK_FP64_TC_FLOPS * 1e3,
        fp64=(B * S * (WIDE_PAIR_OPS + C * WIDE_CLASS_PAIR_OPS)
              + B * 2 * F * (1 + C) + S * 2 * F) / PEAK_FP64_FLOPS * 1e3,
        fp32=B * fk_ops / PEAK_FP32_FLOPS * 1e3)


def wide_f64_tc_bound(B, S, F, bytes_moved, fk_ops=0, C=1):
    """(least ms, 'bytes' or 'operations') on the wide block: the largest
    of ``wide_f64_tc_times`` (its parts run side by side)."""
    t = wide_f64_tc_times(B, S, F, bytes_moved, fk_ops, C)
    ms = max(t.values())
    return ms, 'bytes' if ms == t['bytes'] else 'operations'


def poly_wide_bound(B, S, F):
    """B2's wide instance (F = 65-192): ``wide_f64_tc_bound`` of its bytes
    (``poly_bytes``)."""
    return wide_f64_tc_bound(B, S, F, poly_bytes(B, S, F))


def chain_wide_bound(B, S, F, D, c, C=1, dh=False):
    """The FK kernels' wide instance for a folded chain spec ``c`` (B1,
    B3, B4, B5 past their bounds): ``wide_f64_tc_bound`` with the chain's
    FK and backward (``chain_ops``, or ``dh_ops`` for a DH chain)."""
    fk = dh_ops(D, c.P, C) if dh else chain_ops(c, C)
    return wide_f64_tc_bound(B, S, F, fk_score_bytes(B, S, F, D, C), fk, C)


def dh_tc_times(B, S, F, J, P):
    """B1's ``tc_times``: q in, score and dq out, and per configuration
    the FK and backward (``dh_ops``)."""
    return tc_times(B, S, F, fk_score_bytes(B, S, F, J), dh_ops(J, P))


def dh_tc_bound(B, S, F, J, P):
    """B1's ``tc_bound``."""
    return tc_bound(B, S, F, fk_score_bytes(B, S, F, J), dh_ops(J, P))


def poly_bytes(B, S, F):
    """B2: x [B, F] + s [S, F] + w [S] in; score [B] + dx [B, F] out;
    fp32."""
    return 4 * (B * F + S * F + S + B + B * F)


def poly_tc_bound(B, S, F):
    """B2's ``tc_bound``: per row its dx, x~ rowsum - su~ (2F)."""
    return tc_bound(B, S, F, poly_bytes(B, S, F), 2 * F)


def chain_tc_bound(B, S, F, D, c):
    """B3's ``tc_bound`` for a folded ``_native.ChainSpec`` ``c``: per
    configuration the chain FK and backward (``chain_ops``)."""
    return tc_bound(B, S, F, fk_score_bytes(B, S, F, D), chain_ops(c))


def score_ops(B, S, F, C=1):
    """Score block with C weight columns: per pair 2F (x.s) + 3 (form d2)
    + 2 (clamp, 1e-12 floor) + 1 rsqrt + 1 (r) shared, and per class 2
    (score) + 2 (rowsum) + 2F (su); per row 2F (||x||^2) and 2F per class
    (dx); per support 2F (||s||^2)."""
    return (B * S * (2 * F + 7 + C * (2 * F + 4)) + B * 2 * F * (1 + C)
            + S * 2 * F)


def dh_ops(J, P, C=1):
    """DH FK and suffix-sum backward per configuration, from
    csrc/dh_chain.cuh: per joint 66 for the transform compose (sin and
    cos included) and per point 18 to place it, once; per class 17 per
    joint for dq_j and 21 per point to fold its gradient into the suffix
    sums."""
    return 66 * J + 18 * P + C * (17 * J + 21 * P)


def chain_ops(c, C=1):
    """General-chain FK and moving-ancestor backward per configuration,
    from csrc/chain_fk.cuh, for a folded ``_native.ChainSpec`` ``c``.
    Once: per moving joint 63 (parent x pre-transform), 2 (theta), 15
    (world axis), then 2 (sin, cos) + 34 (Rodrigues) + 45 (rotation
    compose) for a revolute joint or 6 (slide) for a prismatic one; per
    point on a moving frame 18 to place it. Per class: 6 per point for
    its gradient, and per (point, moving ancestor) pair 19 (revolute: the
    lever arm, cross, dot, scaled add) or 7 (prismatic)."""
    fk, pairs = 0, 0
    for m in range(c.M):
        fk += 80 + (81 if c.jtype[m] == 1 else 6)
    for k in range(c.P):
        m = c.pframe[k]
        fk += 18 if m >= 0 else 0
        while m >= 0:
            pairs += 19 if c.jtype[m] == 1 else 7
            m = c.mparent[m]
    return fk + C * (6 * c.P + pairs)


def fk_score_bytes(B, S, F, D, C=1):
    """q [B, D] + s [S, F] + w [S, C] in; score [B, C] + dq [C, B, D]
    out; fp32."""
    return 4 * (B * D + S * F + S * C + B * C + C * B * D)


def ablation_work(mode, B, S, F, J, P):
    """(bytes, operations) of a B7 mode (``csrc/dh_ablation.cu``; one
    float out per configuration). FK once is 66J + 18P per configuration;
    ``fk_only`` adds 3P to sum the points. The rungs after it count B1's
    per-pair work, by the definition of a rung (a sum over pairs of d2 or
    of w r could be had with fewer operations, but the rung measures the
    stage of B1 that computes it per pair): ``mxu`` per pair the dot s_j
    . x (2F) + 1 (its sum); ``mxu_rsqrt`` and ``fwd`` per pair the
    expanded-square distance, clamp and floor (2F + 5, as ``score_ops``)
    + rsqrt and r + 2 (r + 1/r and its sum, or w r and its sum); each per
    row 2F and per support 2F. ``mv_f32_full`` / ``mv_bf16_full`` B1's
    work (``score_ops`` + ``dh_ops``) + J to sum dq into the output."""
    fk = 66 * J + 18 * P
    q_out = 4 * (B * J + B)
    if mode == 'fk_only':
        return q_out, B * (fk + 3 * P)
    rows = B * fk + B * 2 * F + S * 2 * F
    if mode == 'mxu':
        return q_out + 4 * S * F, rows + B * S * (2 * F + 1)
    sweep = rows + B * S * (2 * F + 9)
    if mode == 'mxu_rsqrt':
        return q_out + 4 * S * F, sweep
    if mode == 'fwd':
        return q_out + 4 * (S * F + S), sweep
    if mode in ('mv_f32_full', 'mv_bf16_full'):
        return (q_out + 4 * (S * F + S),
                score_ops(B, S, F) + B * (dh_ops(J, P) + J))
    raise ValueError(f'ablation_work: unknown mode {mode!r}')


# per pair on the CUDA cores beside product 1, by B7 rung on B1's block:
# the sum of the dot (mxu); d2 from the norms and the cross term, clamp
# and floor, rsqrt, r, and r + 1/r or w r into the sum (mxu_rsqrt, fwd);
# B1's TC_PAIR_OPS with the split of rinv into TF32 hi and lo (3) in
# place of rounding r and rinv to bf16 (2) (mv_bf16_full)
_ABLATION_TC_PAIR_OPS = {'mxu': 1, 'mxu_rsqrt': 9, 'fwd': 9,
                         'mv_bf16_full': TC_PAIR_OPS - 3 + 2}


def ablation_tc_times(mode, B, S, F, J, P):
    """Least times, in ms, of a B7 rung on B1's tensor-core block
    (``csrc/dh_ablation.cu``): 'bytes' (``ablation_work``'s, over HBM),
    'tensor' (product 1 in 3xTF32 over the TF32 peak for every rung past
    ``fk_only``; ``mv_f32_full`` also product 2 in 3xTF32, as
    ``tc_product_ops``; ``mv_bf16_full`` product 2 as one bf16 product
    over the bf16 peak) and 'fp32' (per row the FK and 2F, per support
    2F, and the rung's pair work, over the fp32 peak; the full rungs per
    row B1's FK and backward + J, as ``dh_tc_times``). ``fk_only`` runs
    no product: its fp32 time is ``ablation_work``'s."""
    nbytes, ops = ablation_work(mode, B, S, F, J, P)
    if mode == 'fk_only':
        return dict(bytes=nbytes / PEAK_HBM_BYTES * 1e3, tensor=0.0,
                    fp32=ops / PEAK_FP32_FLOPS * 1e3)
    if mode == 'mv_f32_full':
        return tc_times(B, S, F, nbytes, dh_ops(J, P) + J)
    product1 = 3 * B * S * 2 * F / PEAK_TF32_FLOPS
    row_ops = (dh_ops(J, P) + J if mode == 'mv_bf16_full'
               else 66 * J + 18 * P)
    tensor = product1 + (B * S * 2 * (F + 1) / PEAK_BF16_FLOPS
                         if mode == 'mv_bf16_full' else 0.0)
    fp32 = (B * S * _ABLATION_TC_PAIR_OPS[mode] + B * (row_ops + 2 * F)
            + S * 2 * F) / PEAK_FP32_FLOPS
    return dict(bytes=nbytes / PEAK_HBM_BYTES * 1e3, tensor=tensor * 1e3,
                fp32=fp32 * 1e3)


def ablation_tc_bound(mode, B, S, F, J, P):
    """(least ms, 'bytes' or 'operations') of a B7 rung on B1's block:
    the largest of ``ablation_tc_times``."""
    t = ablation_tc_times(mode, B, S, F, J, P)
    ms = max(t.values())
    return ms, 'bytes' if ms == t['bytes'] else 'operations'


def table():
    """Bounds of B1-B7 at the shapes PERF.md states: B = 65536, S = 512;
    PandaFK (J = 7, P = 7, F = 21) for the DH kernels, FrankaPanda's
    generated panda_simple chain (D = M = 7, P = 8, F = 24, 45 point /
    ancestor pairs) for the chain kernels, C = 2 for the multi-class
    ones; and B2's and B3's wide instances at the 35-link rope's sweep (S
    = 1536, F = 102)."""
    from ..robots.urdf import FrankaPanda
    from .fk_score import _c_chain_spec, robot_chain_statics
    B, S = 65536, 512
    J, P, F = 7, 7, 21
    panda = _c_chain_spec(robot_chain_statics(FrankaPanda(
        device='cpu', setup_acm=False, link_spheres=1)))
    rows = {}

    def put(key, bytes_moved, ops, shape):
        ms, by = bound(bytes_moved, ops)
        rows[key] = dict(shape=shape, bytes=bytes_moved, ops=ops,
                         bound_ms=ms, bound_by=by)

    put('B1', fk_score_bytes(B, S, F, J),
        score_ops(B, S, F) + B * dh_ops(J, P), dict(B=B, S=S, J=J, F=F))
    ms, by = dh_tc_bound(B, S, F, J, P)
    rows['B1']['bound_tc_ms'], rows['B1']['bound_tc_by'] = ms, by
    rows['B1']['bound_tc_times_ms'] = dh_tc_times(B, S, F, J, P)
    put('B2', poly_bytes(B, S, F), score_ops(B, S, F), dict(B=B, S=S, F=F))
    rows['B2']['bound_tc_ms'], rows['B2']['bound_tc_by'] = poly_tc_bound(
        B, S, F)
    rows['B2']['bound_tc_times_ms'] = tc_times(B, S, F, poly_bytes(B, S, F),
                                               2 * F)
    put('B3', fk_score_bytes(B, S, 24, 7),
        score_ops(B, S, 24) + B * chain_ops(panda),
        dict(B=B, S=S, D=7, F=24))
    rows['B3']['bound_tc_ms'], rows['B3']['bound_tc_by'] = chain_tc_bound(
        B, S, 24, 7, panda)
    rows['B3']['bound_tc_times_ms'] = tc_times(
        B, S, 24, fk_score_bytes(B, S, 24, 7), chain_ops(panda))
    put('B4', fk_score_bytes(B, S, F, J, C=2),
        score_ops(B, S, F, C=2) + B * dh_ops(J, P, C=2),
        dict(B=B, S=S, J=J, F=F, C=2))
    put('B5', fk_score_bytes(B, S, 24, 7, C=2),
        score_ops(B, S, 24, C=2) + B * chain_ops(panda, C=2),
        dict(B=B, S=S, D=7, F=24, C=2))
    # B6: B1's function on B1's block in every variant
    put('B6', fk_score_bytes(B, S, F, J),
        score_ops(B, S, F) + B * dh_ops(J, P), dict(B=B, S=S, J=J, F=F))
    rows['B6']['bound_tc_ms'], rows['B6']['bound_tc_by'] = dh_tc_bound(
        B, S, F, J, P)
    # B7: the ablation modes, each writing one float per configuration
    for mode in ('fk_only', 'mxu', 'mxu_rsqrt', 'fwd', 'mv_f32_full',
                 'mv_bf16_full'):
        key = f'B7 {mode}'
        put(key, *ablation_work(mode, B, S, F, J, P),
            dict(B=B, S=S, J=J, P=P, F=F))
        rows[key]['bound_tc_ms'], rows[key]['bound_tc_by'] = \
            ablation_tc_bound(mode, B, S, F, J, P)
        rows[key]['bound_tc_times_ms'] = ablation_tc_times(mode, B, S, F, J,
                                                           P)
    # B2's and B3's wide instances at the 35-link rope's sweep (F = 102,
    # S = 1536; 35 moving joints): the fp64 tensor-core bound, and the
    # 3xTF32 route's beside it
    from .. import robot_data
    from ..robots.urdf import URDFRobot
    rope = _c_chain_spec(robot_chain_statics(URDFRobot(
        robot_data.generate_rope_urdf(n_links=35), device='cpu',
        setup_acm=False, link_spheres=1)))
    Sr, Fr = 1536, 3 * rope.P
    put('B2 wide', poly_bytes(B, Sr, Fr), score_ops(B, Sr, Fr),
        dict(B=B, S=Sr, F=Fr))
    rows['B2 wide']['bound_f64_tc_ms'], rows['B2 wide']['bound_f64_tc_by'] \
        = poly_wide_bound(B, Sr, Fr)
    rows['B2 wide']['bound_f64_tc_times_ms'] = wide_f64_tc_times(
        B, Sr, Fr, poly_bytes(B, Sr, Fr))
    rows['B2 wide']['bound_tc_ms'] = poly_tc_bound(B, Sr, Fr)[0]
    put('B3 wide', fk_score_bytes(B, Sr, Fr, rope.D),
        score_ops(B, Sr, Fr) + B * chain_ops(rope),
        dict(B=B, S=Sr, D=rope.D, F=Fr))
    rows['B3 wide']['bound_f64_tc_ms'], rows['B3 wide']['bound_f64_tc_by'] \
        = chain_wide_bound(B, Sr, Fr, rope.D, rope)
    rows['B3 wide']['bound_f64_tc_times_ms'] = wide_f64_tc_times(
        B, Sr, Fr, fk_score_bytes(B, Sr, Fr, rope.D), chain_ops(rope))
    rows['B3 wide']['bound_tc_ms'] = chain_tc_bound(B, Sr, Fr, rope.D,
                                                    rope)[0]
    return rows


if __name__ == '__main__':
    for k, v in table().items():
        print(json.dumps(dict(kernel=k, **v)))
