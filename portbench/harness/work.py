"""The work one score-and-gradient call needs, counted from the call's
shapes and the algorithm, whatever implements it, and the least time the
card could take for it.

Per (configuration, support) pair: the cross term x.s (2F operations) and
the gradient's weighted sums over the supports (2(F + 1)) as matrix
products at the TF32 tensor-core peak, and 9 elementwise operations
(the distance from its expansion, the square root, the weight) at the
float32 peak. Per configuration: the DH forward kinematics and its
backward, ``dh_ops`` (a frozen copy of the program's
``ops/bounds.py::dh_ops`` as of this benchmark's first version: per
joint 66 for the transform compose, per point 18 to place it; per joint
17 and per point 21 for the backward). Bytes: q in, the score and dq
out, the supports and weights in, float32, each once. The supports are
the valid ones, not the padded buffer: the work these inputs need."""
from __future__ import annotations

from . import peaks

PAIR_ELEMENTWISE = 9


def dh_ops(J: int, P: int) -> int:
    return 66 * J + 18 * P + (17 * J + 21 * P)


def score_grad(B: int, S: int, F: int, J: int, P: int, D: int) -> dict:
    """Times in seconds at the peaks, and the bound: the largest."""
    products = B * S * (2 * F + 2 * (F + 1))
    elementwise = B * S * PAIR_ELEMENTWISE + B * dh_ops(J, P)
    nbytes = 4 * (B * D + B + B * D + S * F + S)
    t = {'products_s': products / peaks.TF32_FLOPS,
         'elementwise_s': elementwise / peaks.FP32_FLOPS,
         'bytes_s': nbytes / peaks.HBM_BYTES}
    t['bound_s'] = max(t.values())
    t['compute_s'] = max(t['products_s'], t['elementwise_s'])
    return t
