"""Structure-of-arrays rigid-transform algebra for batched FK.

A rotation is a 9-tuple (r00, r01, r02, r10, ..., r22) and a translation
a 3-tuple (x, y, z) of ``[B]`` tensors or Python floats; every compose is
27 multiply-adds on whole batch vectors. Entries broadcast, so the same
code serves constants, scalars and any batch shape.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

Rot = Tuple  # 9-tuple of tensors / floats
Vec = Tuple  # 3-tuple of tensors / floats


def rot_identity(like) -> Rot:
    o = torch.ones_like(like)
    z = torch.zeros_like(like)
    return (o, z, z, z, o, z, z, z, o)


def rot_compose(a: Rot, b: Rot) -> Rot:
    """a @ b, componentwise (27 multiply-adds)."""
    a00, a01, a02, a10, a11, a12, a20, a21, a22 = a
    b00, b01, b02, b10, b11, b12, b20, b21, b22 = b
    return (
        a00 * b00 + a01 * b10 + a02 * b20,
        a00 * b01 + a01 * b11 + a02 * b21,
        a00 * b02 + a01 * b12 + a02 * b22,
        a10 * b00 + a11 * b10 + a12 * b20,
        a10 * b01 + a11 * b11 + a12 * b21,
        a10 * b02 + a11 * b12 + a12 * b22,
        a20 * b00 + a21 * b10 + a22 * b20,
        a20 * b01 + a21 * b11 + a22 * b21,
        a20 * b02 + a21 * b12 + a22 * b22,
    )


def rot_apply(r: Rot, v: Vec) -> Vec:
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = r
    x, y, z = v
    return (r00 * x + r01 * y + r02 * z,
            r10 * x + r11 * y + r12 * z,
            r20 * x + r21 * y + r22 * z)


def vec_add(a: Vec, b: Vec) -> Vec:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def transform_compose(ra: Rot, ta: Vec, rb: Rot, tb: Vec):
    """(Ra, ta) * (Rb, tb) = (Ra Rb, ta + Ra tb)."""
    return rot_compose(ra, rb), vec_add(ta, rot_apply(ra, tb))


def rot_from_axis_angle(axis, angle) -> Rot:
    """Rodrigues with a constant axis (3 floats) and a tensor angle."""
    x, y, z = float(axis[0]), float(axis[1]), float(axis[2])
    s, c = torch.sin(angle), torch.cos(angle)
    C = 1.0 - c
    return (x * x * C + c, x * y * C - z * s, x * z * C + y * s,
            y * x * C + z * s, y * y * C + c, y * z * C - x * s,
            z * x * C - y * s, z * y * C + x * s, z * z * C + c)


def rot_from_static(M) -> Rot:
    """Constant 3x3 (numpy) -> component tuple of Python floats."""
    return (float(M[0, 0]), float(M[0, 1]), float(M[0, 2]),
            float(M[1, 0]), float(M[1, 1]), float(M[1, 2]),
            float(M[2, 0]), float(M[2, 1]), float(M[2, 2]))


def dh_rot_trans(angle, a, d, s_alpha, c_alpha):
    """Standard DH transform as (Rot, Vec) with scalar DH constants and a
    tensor joint angle."""
    ct, st = torch.cos(angle), torch.sin(angle)
    z = torch.zeros_like(angle)
    rot = (ct, -st * c_alpha, st * s_alpha,
           st, ct * c_alpha, -ct * s_alpha,
           z, z + s_alpha, z + c_alpha)
    trans = (a * ct, a * st, z + d)
    return rot, trans


def stack_points(points: Sequence[Vec], flat: bool = False):
    """[(x, y, z)] * M with [B]-shaped components -> [B, M, 3]
    (or [B, 3 * M] when flat=True)."""
    comps = []
    for p in points:
        comps.extend(p)
    out = torch.stack(comps, dim=-1)          # [B, 3*M] (x, y, z per point)
    if flat:
        return out
    return out.reshape(out.shape[:-1] + (len(points), 3))
