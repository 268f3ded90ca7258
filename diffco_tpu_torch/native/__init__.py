"""ctypes bindings for the native exact-geometry oracle (PyTorch
counterpart of ``diffco_tpu/native``).

``exactgeom.cpp`` (a copy of the JAX package's source) is host code by
design: float64, OpenMP over configurations, called through ctypes. It
is the reference's stand-in for libfcl (exact checks for dataset labels
and trajectory validation) and never the card's path, here as in the JAX
package. At first use it is built with

    g++ -O3 -fopenmp -shared -fPIC exactgeom.cpp -o libexactgeom.so

into ``build/diffco_tpu_torch/`` at the root of the checkout, never next
to the source, and rebuilt when the source is newer than the library or
the library does not load. The queries mirror the semantics of
``diffco_tpu_torch.geometry.geometry3d`` (positive = penetration).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / 'exactgeom.cpp'
_BUILD = Path(__file__).resolve().parents[2] / 'build' / 'diffco_tpu_torch'
_SO = _BUILD / 'libexactgeom.so'

_lib = None


def _build() -> Path:
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_suffix(f'.{os.getpid()}.tmp')
    cmd = ['g++', '-O3', '-fopenmp', '-shared', '-fPIC', str(_SRC), '-o',
           str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        raise RuntimeError(f'exactgeom build failed: {e}') from e
    os.replace(tmp, _SO)   # atomic: a concurrent loader sees old or new
    return _SO


def available() -> bool:
    """Whether the library builds and loads (a bool probe: a failed build,
    a missing libgomp or a foreign binary give False)."""
    try:
        load()
        return True
    except (RuntimeError, OSError):
        return False


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        _build()
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        # a stale binary from another machine: rebuild once
        _build()
        lib = ctypes.CDLL(str(_SO))
    c_d = ctypes.POINTER(ctypes.c_double)
    c_i32 = ctypes.POINTER(ctypes.c_int32)
    lib.batch_spheres_vs_scene.argtypes = [
        c_d, c_d, ctypes.c_int64, ctypes.c_int64,
        c_d, ctypes.c_int, c_d, ctypes.c_int, c_d, ctypes.c_int,
        c_d, ctypes.c_int, c_d, ctypes.c_int, c_d]
    lib.batch_spheres_vs_scene.restype = None
    lib.batch_self_collision.argtypes = [
        c_d, c_d, ctypes.c_int64, ctypes.c_int64, c_i32, ctypes.c_int64,
        c_d]
    lib.batch_self_collision.restype = None
    lib.batch_point_sdf.argtypes = [
        c_d, ctypes.c_int64, c_d, ctypes.c_int, c_d, ctypes.c_int,
        c_d, ctypes.c_int, c_d, ctypes.c_int, c_d]
    lib.batch_point_sdf.restype = None
    lib.exactgeom_version.argtypes = []
    lib.exactgeom_version.restype = ctypes.c_int
    _lib = lib
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _f64(x) -> np.ndarray:
    """A tensor (any device) or array as a contiguous float64 array."""
    if hasattr(x, 'detach'):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x, np.float64))


def _rows(width, *parts):
    """Per-object rows [n, width] from parts [n, ...] (each flattened)."""
    n = parts[0].shape[0]
    if n == 0:
        return np.zeros((0, width))
    return np.ascontiguousarray(np.concatenate(
        [_f64(p).reshape(n, -1) for p in parts], axis=1))


class NativeScene:
    """Packed float64 scene arrays for the native queries, from the port's
    ``SceneArrays`` (or a ``ShapeEnv``'s ``.scene``), mesh spheres
    included."""

    def __init__(self, scene):
        scene = getattr(scene, 'scene', scene)
        self.sph = _rows(4, scene.sph_c, scene.sph_r)
        self.box = _rows(15, scene.box_t, scene.box_R, scene.box_h)
        self.cyl = _rows(14, scene.cyl_t, scene.cyl_R, scene.cyl_r,
                         scene.cyl_h)
        self.cap = _rows(14, scene.cap_t, scene.cap_R, scene.cap_r,
                         scene.cap_h)
        self.msh = _rows(5, scene.msh_c, scene.msh_r, scene.msh_obj)


def spheres_vs_scene(centers, radii, scene: NativeScene) -> np.ndarray:
    """centers [B, P, 3], radii [P] -> the largest signed distance [B]
    (> 0 = collision), float64 on the host."""
    lib = load()
    centers, radii = _f64(centers), _f64(radii)
    B, P, _ = centers.shape
    out = np.empty(B, np.float64)
    lib.batch_spheres_vs_scene(
        _ptr(centers), _ptr(radii), B, P,
        _ptr(scene.sph), len(scene.sph), _ptr(scene.box), len(scene.box),
        _ptr(scene.cyl), len(scene.cyl), _ptr(scene.cap), len(scene.cap),
        _ptr(scene.msh), len(scene.msh), _ptr(out))
    return out


def self_collision(centers, radii, pair_i, pair_j) -> np.ndarray:
    """The largest overlap [B] (radius sum less distance) over the sphere
    index pairs (pair_i, pair_j)."""
    lib = load()
    centers, radii = _f64(centers), _f64(radii)
    pairs = np.ascontiguousarray(np.stack(
        [np.asarray(_f64(pair_i), np.int32),
         np.asarray(_f64(pair_j), np.int32)], axis=1))
    B, P, _ = centers.shape
    out = np.empty(B, np.float64)
    lib.batch_self_collision(
        _ptr(centers), _ptr(radii), B, P,
        pairs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(pairs), _ptr(out))
    return out


def point_sdf(points, scene: NativeScene) -> np.ndarray:
    """points [N, 3] -> per-object SDFs [N, n_objects] (no mesh
    objects)."""
    lib = load()
    points = _f64(points)
    n_obj = (len(scene.sph) + len(scene.box) + len(scene.cyl)
             + len(scene.cap))
    out = np.empty((len(points), n_obj), np.float64)
    lib.batch_point_sdf(
        _ptr(points), len(points),
        _ptr(scene.sph), len(scene.sph), _ptr(scene.box), len(scene.box),
        _ptr(scene.cyl), len(scene.cyl), _ptr(scene.cap), len(scene.cap),
        _ptr(out))
    return out
