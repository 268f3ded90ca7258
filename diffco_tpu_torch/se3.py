"""SE(3) / SO(3) exp and log maps and quaternion conversions (PyTorch
counterpart of ``diffco_tpu/se3.py``).

Everything is batched over leading dimensions and branchless: the
small-angle regimes use ``torch.where``-selected Taylor series. As in
JAX, ``torch.where`` passes a zero cotangent to the branch it did not
select, and that branch's own derivative may be infinite there (0 * inf
= NaN), so each guarded branch is evaluated at a safe input (the
double-where pattern) and ``_safe_norm`` has a zero gradient at 0.
``log_so3`` goes through a branchless Shepperd matrix -> quaternion
conversion (the largest quaternion component picks the formula), which
stays stable at theta ~ pi. Rotations are 3 x 3 matrices, tangents plain
3-vectors (omega) and 6-vectors (xi = [omega, v]); quaternions are (x, y,
z, w). The small products run as explicit float32 sums
(``utils.matmul_f32``), never in TF32. Functions run on the device of
their inputs.
"""
from __future__ import annotations

import torch

from .utils import matmul_f32

_EPS = 1e-8


def _safe_norm(v, keepdims=False):
    """||v|| along the last axis with gradient 0 (not NaN) at v = 0."""
    sq = torch.sum(v * v, dim=-1, keepdim=keepdims)
    zero = sq == 0.0
    return torch.where(zero, torch.zeros_like(sq),
                       torch.sqrt(torch.where(zero, torch.ones_like(sq), sq)))


def skew(v):
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1),
                        torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def unskew(W):
    """[..., 3, 3] -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _guarded(theta, series, exact):
    """series(theta) where |theta| < 1e-4, else exact(theta) evaluated at
    a safe input (1 in the small regime)."""
    small = torch.abs(theta) < 1e-4
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, series(theta), exact(safe))


def _sinc(theta):
    """sin(theta) / theta, stable at 0."""
    return _guarded(theta, lambda t: 1.0 - t * t / 6.0,
                    lambda t: torch.sin(t) / t)


def _cosc(theta):
    """(1 - cos(theta)) / theta^2, stable at 0. Written 2 sin^2(theta / 2)
    / theta^2: 1 - cos(theta) cancels in float32 (it is 0 for theta below
    ~3e-4), which put errors of 1e-4 into exp_se3's V."""
    return _guarded(theta, lambda t: 0.5 - t * t / 24.0,
                    lambda t: 0.5 * (torch.sin(0.5 * t) / (0.5 * t)) ** 2)


def _sinc3(theta):
    """(theta - sin(theta)) / theta^3, stable at 0."""
    return _guarded(theta, lambda t: 1.0 / 6.0 - t * t / 120.0,
                    lambda t: (t - torch.sin(t)) / (t ** 3))


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        like.shape)


def exp_so3(omega):
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3] (Rodrigues)."""
    theta = _safe_norm(omega)
    W = skew(omega)
    W2 = matmul_f32(W, W)
    return (_eye3(W) + _sinc(theta)[..., None, None] * W
            + _cosc(theta)[..., None, None] * W2)


def matrix_to_quaternion(R):
    """[..., 3, 3] -> quaternion [..., 4] (x, y, z, w), w >= 0.

    Branchless Shepperd: all four candidate decompositions, the one keyed
    by the largest quaternion component selected, so every rotation
    (theta ~ pi included) is numerically stable."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # 4 * (component)^2 for w, x, y, z: the selector
    fours = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                         1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    case = torch.argmax(fours, dim=-1, keepdim=True)
    s = 2.0 * torch.sqrt(torch.clamp(
        torch.gather(fours, -1, case)[..., 0], min=_EPS))
    ss = s * s / 4.0
    cands = torch.stack([
        torch.stack([m21 - m12, m02 - m20, m10 - m01, ss], -1),   # w
        torch.stack([ss, m01 + m10, m02 + m20, m21 - m12], -1),   # x
        torch.stack([m01 + m10, ss, m12 + m21, m02 - m20], -1),   # y
        torch.stack([m02 + m20, m12 + m21, ss, m10 - m01], -1),   # z
    ], -2) / s[..., None, None]                                   # [..., 4, 4]
    q = torch.gather(cands, -2, case[..., None].expand(
        case.shape[:-1] + (1, 4)))[..., 0, :]
    # canonical hemisphere: w >= 0
    return torch.where(q[..., 3:4] < 0, -q, q)


def quaternion_to_matrix(q):
    """[..., 4] (x, y, z, w) -> [..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], -2)


def axis_angle_to_quaternion(omega):
    """[..., 3] -> [..., 4] (x, y, z, w)."""
    theta = _safe_norm(omega, keepdims=True)
    half = theta / 2.0
    small = theta < 1e-6
    # sin(t/2) / t, stable at 0 (-> 1/2)
    k = torch.where(small, 0.5 - theta * theta / 48.0,
                    torch.sin(half) / torch.where(small,
                                                  torch.ones_like(theta),
                                                  theta))
    return torch.cat([omega * k, torch.cos(half)], -1)


def quaternion_to_axis_angle(q):
    """[..., 4] (x, y, z, w) -> [..., 3], the representative with theta in
    [0, pi]; stable as theta -> 0 and theta -> pi."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    q = torch.where(q[..., 3:4] < 0, -q, q)
    xyz, w = q[..., :3], q[..., 3]
    s = _safe_norm(xyz)
    theta = 2.0 * torch.atan2(s, w)
    small = s < 1e-6
    scale = torch.where(small, 2.0 / torch.clamp(w, min=0.5),
                        theta / torch.where(small, torch.ones_like(s), s))
    return xyz * scale[..., None]


def log_so3(R):
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3] (apply ``skew``
    for the matrix form)."""
    return quaternion_to_axis_angle(matrix_to_quaternion(R))


def _bottom_row(top):
    """[..., 3, 4] -> [..., 4, 4] with the homogeneous row (0, 0, 0, 1)."""
    bottom = top.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(
        top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], -2)


def exp_se3(xi):
    """Twist [..., 6] (omega, v) -> homogeneous transform [..., 4, 4]."""
    omega, v = xi[..., :3], xi[..., 3:]
    theta = _safe_norm(omega)
    W = skew(omega)
    W2 = matmul_f32(W, W)
    eye = _eye3(W)
    a, b, c = (f(theta)[..., None, None] for f in (_sinc, _cosc, _sinc3))
    R = eye + a * W + b * W2
    V = eye + b * W + c * W2
    p = matmul_f32(V, v[..., None])
    return _bottom_row(torch.cat([R, p], -1))


def log_se3(T):
    """Homogeneous transform [..., 4, 4] -> twist [..., 6] (omega, v)."""
    R, p = T[..., :3, :3], T[..., :3, 3]
    omega = log_so3(R)
    theta = _safe_norm(omega)
    W = skew(omega)
    W2 = matmul_f32(W, W)
    # V^{-1} = I - W/2 + c W^2, c = (1 - theta sin / (2 (1 - cos))) /
    # theta^2 = (1 - (theta / 2) cot(theta / 2)) / theta^2, -> 1/12 at 0.
    # The cotangent form: 1 - cos(theta) is 0 in float32 for theta below
    # ~3e-4, where the first form divides by it (NaN)
    c = _guarded(theta, lambda t: 1.0 / 12.0 + t * t / 720.0,
                 lambda t: (1.0 - 0.5 * t * torch.cos(0.5 * t)
                            / torch.sin(0.5 * t)) / (t * t))
    Vinv = _eye3(W) - 0.5 * W + c[..., None, None] * W2
    v = matmul_f32(Vinv, p[..., None])[..., 0]
    return torch.cat([omega, v], -1)


def se3_inverse(T):
    """[..., 4, 4] -> [..., 4, 4]."""
    Rt = torch.swapaxes(T[..., :3, :3], -1, -2)
    pinv = -matmul_f32(Rt, T[..., :3, 3:4])
    return _bottom_row(torch.cat([Rt, pinv], -1))


def se3_interpolate(T0, T1, t):
    """Geodesic SE(3) interpolation T(t) = T0 exp(t log(T0^-1 T1)).

    t is a scalar ([..., 4, 4] out) or [..., K] ([..., K, 4, 4] out: the
    new K axis comes before the twist axis, so t[k] scales every
    waypoint's twist)."""
    delta = log_se3(matmul_f32(se3_inverse(T0), T1))
    t = torch.as_tensor(t, dtype=delta.dtype, device=delta.device)
    if t.dim() == 0:
        return matmul_f32(T0, exp_se3(t * delta))
    xi = t[..., :, None] * delta[..., None, :]          # [..., K, 6]
    return matmul_f32(T0[..., None, :, :], exp_se3(xi))


def integrate_axis_angle(axis_angle, omega, dt):
    """Integrate a body angular velocity omega over dt from the rotation
    axis_angle."""
    return log_so3(matmul_f32(exp_so3(omega * dt), exp_so3(axis_angle)))


def angular_error(source_axis_angle, target_axis_angle):
    """The rotation from source to target as an axis-angle vector."""
    R_s = exp_so3(source_axis_angle)
    R_t = exp_so3(target_axis_angle)
    return log_so3(matmul_f32(R_t, torch.swapaxes(R_s, -1, -2)))
