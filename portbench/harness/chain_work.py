"""The work one score-and-gradient call on a serial chain needs, counted
as ``work.py`` counts a DH arm's, whatever implements it: per
(configuration, support) pair the products at the TF32 tensor-core peak
and the elementwise work at the float32 peak, the bytes at the HBM peak;
per configuration the chain's forward kinematics and its backward,
``chain_ops``.

``chain_ops`` is a frozen copy of the program's
``ops/bounds.py::chain_ops`` as of this file's first version, fed a
configuration's joint table (``robot.chain``, ``robot.points``) in place
of the program's folded chain: per moving joint 63 (parent x
pre-transform), 2 (theta), 15 (world axis), then 2 (sin, cos) + 34
(Rodrigues) + 45 (rotation compose) for a revolute joint; per point on a
moving frame 18 to place it; for the gradient 6 per point and 19 per
(point, moving ancestor) pair. In a serial chain of revolute joints the
moving ancestors of a point on frame k are joints 1 to k."""
from __future__ import annotations

from . import peaks, work


def chain_ops(robot: dict) -> int:
    """Operations a configuration: FK, then one class's backward."""
    M = len(robot['chain'])
    fk = M * (80 + 81)
    pairs = 0
    for k, _ in robot['points']:
        fk += 18 if k >= 1 else 0
        pairs += 19 * k
    return fk + 6 * len(robot['points']) + pairs


def score_grad(B: int, S: int, F: int, D: int, fk_ops: int) -> dict:
    """Times in seconds at the peaks, and the bound: the largest."""
    products = B * S * (2 * F + 2 * (F + 1))
    elementwise = B * S * work.PAIR_ELEMENTWISE + B * fk_ops
    nbytes = 4 * (B * D + B + B * D + S * F + S)
    t = {'products_s': products / peaks.TF32_FLOPS,
         'elementwise_s': elementwise / peaks.FP32_FLOPS,
         'bytes_s': nbytes / peaks.HBM_BYTES}
    t['bound_s'] = max(t.values())
    return t
