"""Minimal host-side mesh IO + sphere decomposition (numpy, build time).

A copy of ``diffco_tpu/geometry/mesh.py`` (the port keeps its own copy of
numpy-only modules). Meshes are loaded with small numpy parsers and
converted to **sphere decompositions** at build time (the cuRobo
approach): collision queries then become batched point-SDF evaluations on
the device.
"""
from __future__ import annotations

import os
import struct
import xml.etree.ElementTree as ET
from typing import Tuple

import numpy as np


def load_stl(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load binary or ASCII STL -> (vertices [V, 3], faces [F, 3])."""
    with open(path, 'rb') as f:
        head = f.read(5)
    if head == b'solid':
        # could still be binary with a 'solid' header; try ASCII first
        try:
            return _load_stl_ascii(path)
        except Exception:
            pass
    return _load_stl_binary(path)


def _load_stl_binary(path: str):
    with open(path, 'rb') as f:
        f.seek(80)
        (n_tri,) = struct.unpack('<I', f.read(4))
        data = np.frombuffer(f.read(n_tri * 50), dtype=np.uint8)
    data = data.reshape(n_tri, 50)
    tri = data[:, 12:48].copy().view(np.float32).reshape(n_tri, 3, 3)
    verts = tri.reshape(-1, 3)
    # dedupe vertices
    uniq, inv = np.unique(verts.round(decimals=7), axis=0,
                          return_inverse=True)
    faces = inv.reshape(-1, 3)
    return uniq.astype(np.float32), faces.astype(np.int32)


def _load_stl_ascii(path: str):
    verts = []
    with open(path, 'r') as f:
        for line in f:
            line = line.strip()
            if line.startswith('vertex'):
                verts.append([float(x) for x in line.split()[1:4]])
    if not verts:
        raise ValueError(f'no vertices in ASCII STL {path}')
    verts = np.asarray(verts, np.float32)
    uniq, inv = np.unique(verts.round(decimals=7), axis=0,
                          return_inverse=True)
    faces = inv.reshape(-1, 3)
    return uniq.astype(np.float32), faces.astype(np.int32)


def load_obj(path: str):
    verts, faces = [], []
    with open(path, 'r') as f:
        for line in f:
            if line.startswith('v '):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith('f '):
                idx = [int(tok.split('/')[0]) - 1 for tok in line.split()[1:]]
                for i in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return (np.asarray(verts, np.float32),
            np.asarray(faces, np.int32).reshape(-1, 3))


def load_dae(path: str):
    """Minimal COLLADA loader: concatenates every <float_array> that backs
    a POSITION source, applying the document's <unit meter=...> scale and
    Z-up conversion for <up_axis>. Good enough for collision keypoints /
    sphere fits (per-node transforms are NOT applied — multi-node scenes
    with placed instances need a real COLLADA library)."""
    ns = {'c': 'http://www.collada.org/2005/11/COLLADASchema'}
    root = ET.parse(path).getroot()
    # asset scale/orientation: vendor collision meshes are frequently
    # authored in mm (<unit meter="0.001">) — ignoring it made every
    # sphere fit 1000x too large
    scale = 1.0
    up = 'Z_UP'
    asset = root.find('c:asset', ns)
    if asset is not None:
        unit = asset.find('c:unit', ns)
        if unit is not None and unit.get('meter'):
            scale = float(unit.get('meter'))
        up_el = asset.find('c:up_axis', ns)
        if up_el is not None and up_el.text:
            up = up_el.text.strip().upper()
    verts = []
    for geom in root.iter('{http://www.collada.org/2005/11/COLLADASchema}geometry'):
        for src in geom.iter('{http://www.collada.org/2005/11/COLLADASchema}source'):
            sid = src.get('id', '')
            if 'position' not in sid.lower():
                continue
            fa = src.find('c:float_array', ns)
            if fa is None or fa.text is None:
                continue
            vals = np.fromiter((float(t) for t in fa.text.split()),
                               dtype=np.float32)
            verts.append(vals.reshape(-1, 3))
    if not verts:
        raise ValueError(f'no POSITION sources found in {path}')
    v = np.concatenate(verts, axis=0) * scale
    if up == 'Y_UP':       # COLLADA Y-up -> URDF Z-up: (x, y, z)->(x, -z, y)
        v = np.stack([v[:, 0], -v[:, 2], v[:, 1]], axis=1)
    elif up == 'X_UP':     # X-up -> Z-up: (x, y, z) -> (-z, y, x)
        v = np.stack([-v[:, 2], v[:, 1], v[:, 0]], axis=1)
    return v, np.zeros((0, 3), np.int32)


def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    ext = os.path.splitext(path)[1].lower()
    if ext == '.stl':
        return load_stl(path)
    if ext == '.obj':
        return load_obj(path)
    if ext == '.dae':
        return load_dae(path)
    raise ValueError(f'unsupported mesh format: {path}')


def surface_points(vertices: np.ndarray, faces: np.ndarray,
                   n: int = 2048, seed: int = 0) -> np.ndarray:
    """Uniform-ish surface samples (area-weighted barycentric)."""
    if len(faces) == 0:
        return vertices
    rng = np.random.RandomState(seed)
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    total = area.sum()
    if total <= 0:
        return vertices
    probs = area / total
    tri = rng.choice(len(faces), size=n, p=probs)
    u, v = rng.rand(n, 1), rng.rand(n, 1)
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    pts = v0[tri] + u * (v1[tri] - v0[tri]) + v * (v2[tri] - v0[tri])
    return pts.astype(np.float32)


def kmeans(points: np.ndarray, k: int, iters: int = 25, seed: int = 0):
    """Tiny numpy k-means (build-time only)."""
    rng = np.random.RandomState(seed)
    k = min(k, len(points))
    centers = points[rng.choice(len(points), k, replace=False)].copy()
    for _ in range(iters):
        d = ((points[:, None, :] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        for j in range(k):
            mask = assign == j
            if mask.any():
                centers[j] = points[mask].mean(0)
    d = ((points[:, None, :] - centers[None]) ** 2).sum(-1)
    assign = d.argmin(1)
    return centers, assign


def spheres_from_mesh(vertices: np.ndarray, faces: np.ndarray,
                      n_spheres: int = 8, seed: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Cover a mesh surface with spheres: k-means cluster surface samples,
    radius = max distance of a cluster's points to its center.

    Returns (centers [k, 3], radii [k]). Over-approximates the sampled
    surface (conservative collision labels).
    """
    pts = surface_points(vertices, faces, n=max(512, 64 * n_spheres),
                         seed=seed)
    if len(pts) == 0:
        return np.zeros((1, 3), np.float32), np.zeros(1, np.float32)
    centers, assign = kmeans(pts, n_spheres, seed=seed)
    radii = np.zeros(len(centers), np.float32)
    for j in range(len(centers)):
        mask = assign == j
        if mask.any():
            radii[j] = np.linalg.norm(pts[mask] - centers[j], axis=1).max()
    keep = radii > 0
    if not keep.any():
        keep[0] = True
    return centers[keep].astype(np.float32), radii[keep]


def spheres_from_primitive(kind: str, params: dict, n: int = 4
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Cover a primitive (in its local frame) with spheres.

    kind in {'box', 'cylinder', 'sphere', 'capsule'}; params use URDF
    conventions (box: size [3]; cylinder: radius, length; sphere: radius;
    capsule: radius, length). Covers conservatively.
    """
    if kind == 'sphere':
        return (np.zeros((1, 3), np.float32),
                np.asarray([params['radius']], np.float32))
    if kind in ('cylinder', 'capsule'):
        r = float(params['radius'])
        h = float(params.get('length', params.get('height', 0.0)))
        n_ax = max(1, int(np.ceil(h / (2 * r))) if r > 0 else n)
        # the caller's sphere budget n CAPS the axial count (a long thin
        # cylinder would otherwise emit ceil(h/2r) spheres regardless);
        # the per-sphere radius below absorbs the coarser split
        n_ax = min(n_ax, max(n, 1))
        zs = np.linspace(-h / 2, h / 2, n_ax + 1)
        zs = (zs[:-1] + zs[1:]) / 2 if n_ax > 0 else np.zeros(1)
        half_seg = (h / max(n_ax, 1)) / 2
        rad = np.sqrt(r ** 2 + half_seg ** 2) if kind == 'cylinder' \
            else r + half_seg
        centers = np.stack([np.zeros_like(zs), np.zeros_like(zs), zs], 1)
        return centers.astype(np.float32), np.full(len(zs), rad, np.float32)
    if kind == 'box':
        sx, sy, sz = [float(s) for s in params['size']]
        # split the longest axis into ceil(long / short) cells; clamp the
        # divisor so a zero-thickness dimension (thin-plate boxes exist in
        # real URDFs) cannot divide by zero / cast NaN to int
        dims = np.array([sx, sy, sz])
        shortest = max(dims.min(), 1e-6)
        n_split = np.maximum(1, np.ceil(dims / shortest).astype(int))
        n_split = np.minimum(n_split, 4)
        grids = [np.linspace(-d / 2, d / 2, k + 1) for d, k in
                 zip(dims, n_split)]
        cells = [(g[:-1] + g[1:]) / 2 for g in grids]
        cx, cy, cz = np.meshgrid(*cells, indexing='ij')
        centers = np.stack([cx.ravel(), cy.ravel(), cz.ravel()], 1)
        half = dims / (2 * n_split)
        rad = np.linalg.norm(half)
        return (centers.astype(np.float32),
                np.full(len(centers), rad, np.float32))
    raise ValueError(f'unknown primitive kind {kind}')
