"""MoveIt ``.scene`` (PlanningScene text format) loader (a copy of
``diffco_tpu/envs/moveit_scene.py``: the port keeps its own copy of
numpy-only modules).

The text is parsed into a ``ShapeEnv`` shape dict, so scene files work
without a ROS stack: primitives map one to one, meshes carry their inline
vertex and triangle lists into the sphere decomposition of
``geometry3d.scene_from_dict``, and cones become their bounding cylinder
(conservative for collision checking).

Format (both MoveIt serializations)::

    <scene name>
    * <object name>
    [<object pose: "x y z" line + "qx qy qz qw" line>]   # newer MoveIt
    <shape count>
    per shape:
      box|sphere|cylinder|cone|mesh
      <dims>              box: sx sy sz; sphere: r; cylinder/cone: r h
      (mesh: "<nv> <nt>" + nv vertex lines + nt triangle lines)
      <position x y z>
      <orientation qx qy qz qw>
      <color r g b a>
    .
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _quat_to_matrix(q) -> np.ndarray:
    """(x, y, z, w) -> [3, 3] rotation (host numpy: parsing is one-off
    host work)."""
    x, y, z, w = np.asarray(q, np.float64)
    n = np.sqrt(x * x + y * y + z * z + w * w)
    if n == 0:
        return np.eye(3)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _pose_to_transform(pos, quat) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = _quat_to_matrix(quat)
    T[:3, 3] = np.asarray(pos, np.float64)
    return T


class _Lines:
    def __init__(self, text: str):
        self.lines = [ln.strip() for ln in text.splitlines()]
        self.i = 0

    def peek(self):
        while self.i < len(self.lines) and not self.lines[self.i]:
            self.i += 1
        return self.lines[self.i] if self.i < len(self.lines) else None

    def next(self):
        ln = self.peek()
        if ln is None:
            raise ValueError('unexpected end of .scene file')
        self.i += 1
        return ln

    def floats(self, n):
        vals = [float(v) for v in self.next().split()]
        if len(vals) != n:
            raise ValueError(f'expected {n} numbers, got {vals}')
        return vals


def parse_scene_text(text: str) -> Tuple[str, Dict[str, dict]]:
    """Parse .scene text into (scene_name, ShapeEnv shape dict)."""
    L = _Lines(text)
    scene_name = L.next()
    shapes: Dict[str, dict] = {}
    while True:
        ln = L.peek()
        if ln is None or ln == '.':
            break
        if not ln.startswith('*'):
            raise ValueError(f'expected "* <object>" line, got {ln!r}')
        L.next()
        obj_name = ln[1:].strip() or f'object{len(shapes)}'
        # newer MoveIt writes an object-level pose (3-float + 4-float
        # lines) before the shape count; older writes the count directly
        obj_T = np.eye(4)
        nxt = L.peek()
        if nxt is None:
            raise ValueError(f'unexpected end of .scene file after object '
                             f'{obj_name!r}')
        tokens = nxt.split()
        if len(tokens) == 3:
            pos = L.floats(3)
            quat = L.floats(4)
            obj_T = _pose_to_transform(pos, quat)
        n_shapes = int(L.next())
        for si in range(n_shapes):
            kind = L.next().lower()
            name = obj_name if n_shapes == 1 else f'{obj_name}_{si}'
            spec: dict
            if kind == 'box':
                sx, sy, sz = L.floats(3)
                spec = {'type': 'Box', 'params': {'extents': [sx, sy, sz]}}
            elif kind == 'sphere':
                (r,) = L.floats(1)
                spec = {'type': 'Sphere', 'params': {'radius': r}}
            elif kind in ('cylinder', 'cone'):
                # MoveIt dims order: radius, length. A cone is contained
                # in its bounding cylinder — conservative approximation
                r, h = L.floats(2)
                spec = {'type': 'Cylinder',
                        'params': {'radius': r, 'height': h}}
            elif kind == 'mesh':
                nv, nt = (int(v) for v in L.next().split())
                verts = np.asarray([L.floats(3) for _ in range(nv)],
                                   np.float32)
                faces = np.asarray([[int(v) for v in L.next().split()]
                                    for _ in range(nt)], np.int32)
                spec = {'type': 'Mesh',
                        'params': {'vertices': verts, 'faces': faces}}
            else:
                raise ValueError(f'unknown shape type {kind!r}')
            pos = L.floats(3)
            quat = L.floats(4)
            L.floats(4)  # color, unused
            spec['transform'] = obj_T @ _pose_to_transform(pos, quat)
            shapes[name] = spec
    return scene_name, shapes


def load_moveit_scene(path: str, mesh_spheres: int = 16):
    """Load a MoveIt .scene file as a ShapeEnv (ready for checkers)."""
    from .shape_env import ShapeEnv
    with open(path) as f:
        name, shapes = parse_scene_text(f.read())
    env = ShapeEnv(shapes, mesh_spheres=mesh_spheres)
    env.name = name or 'MoveItScene'
    return env
