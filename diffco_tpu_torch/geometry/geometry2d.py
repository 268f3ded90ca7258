"""Batched, differentiable 2-D collision geometry: the ground truth of the
planar experiments (PyTorch counterpart of
``diffco_tpu/geometry/geometry2d.py``).

Closed-form signed distances between capsules (robot links: a segment
and a radius of half the link width), circles and oriented rectangles.
The sign convention is the reference's FCL checker's: **positive inside
collision** (penetration depth), **negative outside** (separation).
Every function broadcasts over leading dimensions and runs on the device
of its inputs; the obstacle arrays follow the query to its device.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

# elements of one [rows, links, obstacles] intermediate per chunk of
# planar_robot_signed_dist (64 MB in float32): 65536 configurations of a
# 7-link arm against 300 boxes take ~17 chunks instead of 550 MB blocks
_CHUNK_ELEMENTS = 1 << 24


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def point_segment_dist(p, a, b, eps=1e-12):
    """Distance from point(s) p [..., 2] to segment (a, b) [..., 2]."""
    ab = b - a
    t = _dot(p - a, ab) / (_dot(ab, ab) + eps)
    t = torch.clamp(t, 0.0, 1.0)
    proj = a + t[..., None] * ab
    return torch.sqrt(_dot(p - proj, p - proj) + eps)


def segment_segment_dist(a1, b1, a2, b2, n_check: int = 8):
    """Distance between 2-D segments: exact when they do not intersect
    (the least endpoint-to-segment distance), 0 when they do (orientation
    test). ``n_check`` is kept for the reference's signature."""
    del n_check

    def cross(o, a, b):
        return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
                - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0]))

    d1, d2 = cross(a2, b2, a1), cross(a2, b2, b1)
    d3, d4 = cross(a1, b1, a2), cross(a1, b1, b2)
    intersect = (d1 * d2 < 0) & (d3 * d4 < 0)
    dist = torch.minimum(
        torch.minimum(point_segment_dist(a1, a2, b2),
                      point_segment_dist(b1, a2, b2)),
        torch.minimum(point_segment_dist(a2, a1, b1),
                      point_segment_dist(b2, a1, b1)))
    return torch.where(intersect, torch.zeros_like(dist), dist)


def segment_circle_signed_dist(a, b, center, radius, cap_radius):
    """Signed distance of capsule(a, b, cap_radius) against a circle."""
    return (radius + cap_radius) - point_segment_dist(center, a, b)


def _to_rect_frame(p, center, angle):
    c, s = torch.cos(angle), torch.sin(angle)
    d = p - center
    return torch.stack([c * d[..., 0] + s * d[..., 1],
                        -s * d[..., 0] + c * d[..., 1]], dim=-1)


def point_rect_sd_aabb(p, half):
    """Box SDF of p [..., 2] against [-half, half] (negative inside)."""
    q = p.abs() - half
    outside = torch.sqrt(_dot(torch.clamp(q, min=0.0),
                              torch.clamp(q, min=0.0)) + 1e-12)
    inside = torch.clamp(torch.maximum(q[..., 0], q[..., 1]), max=0.0)
    return outside + inside


def point_rect_sd(p, center, half, angle):
    """Oriented-box SDF (negative inside). p [..., 2]."""
    return point_rect_sd_aabb(_to_rect_frame(p, center, angle), half)


def segment_rect_signed_dist(a, b, center, half, angle, cap_radius):
    """Signed distance of capsule(a, b, cap_radius) against an oriented
    rectangle (``half``: its half-extents). Separation: the exact least of
    endpoint-to-box and corner-to-segment distances; penetration: the
    separating-axis test over the box's two axes and the segment's
    normal."""
    af = _to_rect_frame(a, center, angle)
    bf = _to_rect_frame(b, center, angle)
    zero = torch.zeros_like(af[..., 0])
    hx, hy = half[..., 0] + zero, half[..., 1] + zero     # af's shape

    sd_a, sd_b = point_rect_sd_aabb(af, half), point_rect_sd_aabb(bf, half)
    d_end = torch.minimum(sd_a, sd_b)
    corners = torch.stack([torch.stack([sx * hx, sy * hy], -1)
                           for sx, sy in ((1, 1), (1, -1), (-1, 1),
                                          (-1, -1))], dim=0)
    d_corner = torch.amin(point_segment_dist(corners, af[None], bf[None]),
                          dim=0)
    sep = torch.minimum(torch.clamp(d_end, min=0.0), d_corner)

    seg = bf - af
    seg_len = torch.sqrt(_dot(seg, seg) + 1e-12)
    n = torch.stack([-seg[..., 1], seg[..., 0]], dim=-1) / seg_len[..., None]

    def overlap(pa, pb, extent):
        # the least shift along an axis that separates [smin, smax] from
        # [-extent, extent]; negative when they are already apart
        smin, smax = torch.minimum(pa, pb), torch.maximum(pa, pb)
        return torch.minimum(smax + extent, extent - smin)

    box_n = n[..., 0].abs() * hx + n[..., 1].abs() * hy
    o1 = overlap(af[..., 0], bf[..., 0], hx)
    o2 = overlap(af[..., 1], bf[..., 1], hy)
    o3 = overlap(_dot(af, n), _dot(bf, n), box_n)
    intersects = (o1 >= 0) & (o2 >= 0) & (o3 >= 0)
    pen = torch.minimum(torch.minimum(o1, o2), o3)
    # both endpoints inside: at least as deep as the shallower endpoint
    max_end_sd = torch.maximum(sd_a, sd_b)
    pen = torch.where(max_end_sd < 0, torch.maximum(pen, -max_end_sd), pen)
    return torch.where(intersects, pen, -sep) + cap_radius


class Obstacles2D:
    """A 2-D obstacle set: circles [Nc, 3] (x, y, r) and oriented
    rectangles [Nr, 5] (x, y, HALF-width, HALF-height, angle), each with a
    class label for multi-class datasets. ``from_obstacle_list`` takes
    full (w, h) sizes; direct construction takes half-extents. The arrays
    are float32 CPU tensors, copied once to each device a query comes
    from."""

    def __init__(self, circles=None, rects=None, circle_classes=None,
                 rect_classes=None):
        self.circles = torch.as_tensor(np.asarray(
            circles if circles is not None and len(circles) else
            np.zeros((0, 3))), dtype=torch.float32).reshape(-1, 3)
        self.rects = torch.as_tensor(np.asarray(
            rects if rects is not None and len(rects) else
            np.zeros((0, 5))), dtype=torch.float32).reshape(-1, 5)
        nc, nr = self.circles.shape[0], self.rects.shape[0]
        self.circle_classes = np.asarray(
            circle_classes if circle_classes is not None else np.zeros(nc),
            np.int32)
        self.rect_classes = np.asarray(
            rect_classes if rect_classes is not None else np.zeros(nr),
            np.int32)
        self.num_class = int(max(
            [0] + list(self.circle_classes + 1) + list(self.rect_classes + 1)))
        self._on_device = {}

    @classmethod
    def from_obstacle_list(cls, obstacles: List[Tuple]):
        """obstacles: [(kind, position, size[, class[, angle]])], kind
        'circle' (size: radius) or 'rect' (size: (w, h) or one side), as
        the reference's 2-D scripts write them."""
        circles, rects, ccls, rcls = [], [], [], []
        for obs in obstacles:
            kind, pos, size = obs[0], obs[1], obs[2]
            label = obs[3] if len(obs) > 3 else 0
            if kind == 'circle':
                circles.append([pos[0], pos[1], float(size)])
                ccls.append(label)
            elif kind == 'rect':
                w, h = (size, size) if np.isscalar(size) else size
                angle = obs[4] if len(obs) > 4 else 0.0
                rects.append([pos[0], pos[1], w / 2, h / 2, angle])
                rcls.append(label)
            else:
                raise ValueError(f'unknown obstacle kind {kind}')
        return cls(circles=np.asarray(circles, np.float32).reshape(-1, 3),
                   rects=np.asarray(rects, np.float32).reshape(-1, 5),
                   circle_classes=ccls, rect_classes=rcls)

    @property
    def num_obstacles(self) -> int:
        return self.circles.shape[0] + self.rects.shape[0]

    def _arrays(self, like):
        key = (like.device, like.dtype)
        if key not in self._on_device:
            self._on_device[key] = (self.circles.to(like.device, like.dtype),
                                    self.rects.to(like.device, like.dtype))
        return self._on_device[key]

    def signed_dist_segments(self, seg_a, seg_b, cap_radius):
        """Signed distance of capsules against every obstacle, the largest
        over the links: seg_a, seg_b [..., L, 2] -> [..., n_obstacles],
        circles first, then rectangles."""
        circles, rects = self._arrays(seg_a)
        a, b = seg_a[..., None, :], seg_b[..., None, :]     # [..., L, 1, 2]
        out = []
        if circles.shape[0]:
            out.append(torch.amax(segment_circle_signed_dist(
                a, b, circles[:, :2], circles[:, 2], cap_radius), dim=-2))
        if rects.shape[0]:
            out.append(torch.amax(segment_rect_signed_dist(
                a, b, rects[:, :2], rects[:, 2:4], rects[:, 4], cap_radius),
                dim=-2))
        if not out:
            return seg_a.new_zeros(seg_a.shape[:-2] + (0,))
        return torch.cat(out, dim=-1)

    def signed_dist_points(self, pts):
        """Point-robot signed distance: pts [..., 2] -> [...,
        n_obstacles] (> 0 inside)."""
        circles, rects = self._arrays(pts)
        p = pts[..., None, :]
        out = []
        if circles.shape[0]:
            d = p - circles[:, :2]
            out.append(circles[:, 2] - torch.sqrt(_dot(d, d) + 1e-12))
        if rects.shape[0]:
            out.append(-point_rect_sd(p, rects[:, :2], rects[:, 2:4],
                                      rects[:, 4]))
        if not out:
            return pts.new_zeros(pts.shape[:-1] + (0,))
        return torch.cat(out, dim=-1)

    @property
    def obstacle_classes(self) -> np.ndarray:
        return np.concatenate([self.circle_classes, self.rect_classes])


def planar_robot_signed_dist(robot, obstacles: Obstacles2D, q):
    """Per-configuration, per-obstacle signed distance of a planar arm:
    q [B, dof] -> [B, n_obstacles], > 0 where that obstacle collides. Runs
    on q's device, in row chunks that keep each [rows, links, obstacles]
    intermediate at 2^24 elements or fewer."""
    q = torch.reshape(q, (-1, robot.dof))
    cap_r = robot.link_width / 2
    per_row = max(1, robot.dof * obstacles.num_obstacles)
    rows = max(1, _CHUNK_ELEMENTS // per_row)
    out = []
    for qc in torch.split(q, rows):
        segs = robot.link_segments(qc)                     # [b, L, 2, 2]
        out.append(obstacles.signed_dist_segments(segs[:, :, 0],
                                                  segs[:, :, 1], cap_r))
    if not out:
        return q.new_zeros((0, obstacles.num_obstacles))
    return torch.cat(out)


def planar_robot_collision(robot, obstacles: Obstacles2D, q):
    """Boolean collision labels [B] (any obstacle)."""
    return torch.any(planar_robot_signed_dist(robot, obstacles, q) > 0,
                     dim=-1)


def _rect_corners(center, half, angle):
    c, s = torch.cos(angle), torch.sin(angle)
    ex = torch.stack([c, s], -1) * half[..., 0:1]
    ey = torch.stack([-s, c], -1) * half[..., 1:2]
    return torch.stack([center + ex + ey, center + ex - ey,
                        center - ex + ey, center - ex - ey], dim=-2)


def _rect_axes(angle):
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([torch.stack([c, s], -1),
                        torch.stack([-s, c], -1)], dim=-2)


def rect_rect_signed_dist(c1, h1, a1, c2, h2, a2):
    """Signed distance between oriented rectangles (centres [..., 2],
    half-extents [..., 2], angles [...], broadcast): > 0 the separating
    axis test's least translation, < 0 the exact separation over the
    corner-to-edge distances."""
    corners1 = _rect_corners(c1, h1, a1)                       # [..., 4, 2]
    corners2 = _rect_corners(c2, h2, a2)
    axes1, axes2 = _rect_axes(a1), _rect_axes(a2)
    shape = torch.broadcast_shapes(axes1.shape, axes2.shape)
    axes = torch.cat([axes1.expand(shape), axes2.expand(shape)], dim=-2)
    # projections as explicit sums: [..., 4 axes, 4 corners]
    p1 = _dot(corners1[..., None, :, :], axes[..., :, None, :])
    p2 = _dot(corners2[..., None, :, :], axes[..., :, None, :])
    mtv = torch.minimum(p1.amax(-1) - p2.amin(-1), p2.amax(-1) - p1.amin(-1))
    pen = torch.amin(mtv, dim=-1)

    nxt = [1, 3, 0, 2]                       # each corner's edge partner
    d12 = point_segment_dist(corners1[..., :, None, :],
                             corners2[..., None, :, :],
                             corners2[..., nxt, :][..., None, :, :])
    d21 = point_segment_dist(corners2[..., :, None, :],
                             corners1[..., None, :, :],
                             corners1[..., nxt, :][..., None, :, :])
    d12, d21 = d12.flatten(-2).amin(-1), d21.flatten(-2).amin(-1)
    sep = torch.minimum(d12, d21)
    return torch.where(pen >= 0, torch.clamp(pen, min=0.0), -sep)


def rigid_body_signed_dist(body_parts, obstacles: Obstacles2D, q):
    """Per-configuration, per-obstacle signed distance of an SE(2) rigid
    body made of rectangles ``body_parts`` [(centre (x, y), half (w/2,
    h/2))] in the body frame: q [B, 3] (x, y, theta) -> [B,
    n_obstacles]."""
    q = torch.atleast_2d(torch.as_tensor(q))
    parts_c = torch.as_tensor(np.asarray([p[0] for p in body_parts]),
                              dtype=q.dtype, device=q.device)     # [P, 2]
    parts_h = torch.as_tensor(np.asarray([p[1] for p in body_parts]),
                              dtype=q.dtype, device=q.device)
    th = q[:, 2]
    c, s = torch.cos(th), torch.sin(th)
    # centres = parts_c @ R^T + xy, as explicit sums
    centers = torch.stack([c[:, None] * parts_c[:, 0] - s[:, None]
                           * parts_c[:, 1],
                           s[:, None] * parts_c[:, 0] + c[:, None]
                           * parts_c[:, 1]], dim=-1) + q[:, None, :2]
    circles, rects = obstacles._arrays(q)
    out = []
    if circles.shape[0]:
        d = -point_rect_sd(circles[None, None, :, :2], centers[:, :, None],
                           parts_h[None, :, None], th[:, None, None]) \
            + circles[:, 2]
        out.append(torch.amax(d, dim=1))
    if rects.shape[0]:
        d = rect_rect_signed_dist(centers[:, :, None], parts_h[None, :, None],
                                  th[:, None, None], rects[:, :2],
                                  rects[:, 2:4], rects[:, 4])
        out.append(torch.amax(d, dim=1))
    if not out:
        return q.new_zeros((q.shape[0], 0))
    return torch.cat(out, dim=-1)
