"""The port's native host oracle and its profiling helpers.

``diffco_tpu_torch.native`` builds its copy of ``exactgeom.cpp`` with g++
into ``build/diffco_tpu_torch/`` and answers the same float64 queries as
the JAX package's build of the same source (1e-12) and as the port's
torch geometry (1e-4, as tests/test_native.py holds the JAX pair), on
tests/test_native.py's scene with an inline mesh added. Then Timers,
CheckCounter, trace and device_memory_stats on the CPU."""
import filecmp
import json
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffco_tpu import native as jnative
from diffco_tpu.geometry import scene_from_dict as jscene_from_dict
from diffco_tpu_torch import native, profiling
from diffco_tpu_torch.geometry.geometry3d import (scene_from_dict,
                                                  sphere_set_self_distance,
                                                  spheres_vs_scene_signed_dist)

torch.set_num_threads(1)


def T(t):
    m = np.eye(4)
    m[:3, 3] = t
    return m


SHAPES = {
    'b': {'type': 'Box', 'params': {'extents': [1, 1, 1]},
          'transform': T([2, 0, 0])},
    's': {'type': 'Sphere', 'params': {'radius': 0.5},
          'transform': T([-2, 0, 0])},
    'c': {'type': 'Cylinder', 'params': {'radius': 0.4, 'height': 2},
          'transform': T([0, 2, 0])},
    'k': {'type': 'Capsule', 'params': {'radius': 0.3, 'height': 1},
          'transform': T([0, -2, 0])},
}
WEDGE = {'w': {'type': 'Mesh', 'params': {
    'vertices': np.asarray([[0, 0, 0], [0.8, 0, 0], [0, 0.8, 0],
                            [0, 0, 0.8]], np.float32),
    'faces': np.asarray([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]],
                        np.int32)}, 'transform': T([0.5, 0.5, 1.0])}}


@pytest.fixture(scope='module', autouse=True)
def jax_native(tmp_path_factory):
    """The JAX package's native module on a build of its source into a
    temporary directory (its own build writes beside the source, which
    another test process may be building at the same moment); the
    module's library and path are restored after this file."""
    so = tmp_path_factory.mktemp('jax_native') / 'libexactgeom.so'
    subprocess.run(['g++', '-O3', '-fopenmp', '-shared', '-fPIC',
                    jnative._SRC, '-o', str(so)], check=True,
                   capture_output=True)
    saved = jnative._lib, jnative._SO
    jnative._lib, jnative._SO = None, str(so)
    jnative.load()
    yield jnative
    jnative._lib, jnative._SO = saved


@pytest.fixture(scope='module')
def scenes():
    """(port scene, JAX scene) of tests/test_native.py's shapes and the
    same with the wedge mesh."""
    out = {}
    for name, shapes in (('primitives', SHAPES),
                         ('with mesh', {**SHAPES, **WEDGE})):
        ts, _ = scene_from_dict(shapes)
        js, _ = jscene_from_dict(shapes)
        out[name] = (ts, js)
    return out


def test_native_builds_into_build():
    """The source is the JAX package's, byte for byte, and its library is
    built under build/diffco_tpu_torch, never beside the source."""
    assert filecmp.cmp(native._SRC, jnative._SRC, shallow=False)
    assert native.available()
    assert native.load().exactgeom_version() == 1
    assert native._SO.parent.name == 'diffco_tpu_torch'
    assert native._SO.parent.parent.name == 'build'
    assert native._SO.exists()
    assert not list(native._SRC.parent.glob('*.so'))


@pytest.mark.parametrize('which', ['primitives', 'with mesh'])
def test_native_scene_query_matches(scenes, which):
    ts, js = scenes[which]
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(64, 5, 3)) * 1.5
    radii = np.asarray([0.1, 0.2, 0.15, 0.05, 0.3])
    got = native.spheres_vs_scene(centers, radii, native.NativeScene(ts))
    ref = jnative.spheres_vs_scene(centers, radii, jnative.NativeScene(js))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    torch_sd = spheres_vs_scene_signed_dist(
        torch.tensor(centers, dtype=torch.float32),
        torch.tensor(radii, dtype=torch.float32), ts).amax(-1)
    np.testing.assert_allclose(got, torch_sd.numpy(), rtol=0, atol=1e-4)
    # tensors on the CPU are taken as they are
    got_t = native.spheres_vs_scene(torch.from_numpy(centers),
                                    torch.from_numpy(radii),
                                    native.NativeScene(ts))
    np.testing.assert_array_equal(got_t, got)


def test_native_self_collision_matches():
    rng = np.random.default_rng(1)
    centers = rng.normal(size=(32, 6, 3))
    radii = np.full(6, 0.4)
    pi = np.asarray([0, 1, 2], np.int32)
    pj = np.asarray([3, 4, 5], np.int32)
    got = native.self_collision(centers, radii, pi, pj)
    ref = jnative.self_collision(centers, radii, pi, pj)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    torch_sd = sphere_set_self_distance(
        torch.tensor(centers, dtype=torch.float32),
        torch.tensor(radii, dtype=torch.float32), torch.from_numpy(pi).long(),
        torch.from_numpy(pj).long()).amax(-1)
    np.testing.assert_allclose(got, torch_sd.numpy(), rtol=0, atol=1e-4)


def test_native_point_sdf_matches(scenes):
    ts, js = scenes['primitives']
    pts = np.random.default_rng(2).normal(size=(50, 3)) * 2
    got = native.point_sdf(pts, native.NativeScene(ts))
    ref = jnative.point_sdf(pts, jnative.NativeScene(js))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    want = ts.point_sdf_per_object(torch.tensor(pts, dtype=torch.float32))
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-4)


def test_timers_and_counter():
    timers = profiling.Timers()
    with timers.span('a'):
        sum(range(1000))
    with timers.span('a', block=True):
        pass
    with timers.span('b', block=True):
        torch.ones(3).sum()
    s = timers.summary()
    assert s['a']['count'] == 2 and s['a']['total_s'] >= 0
    assert s['b']['count'] == 1
    assert json.loads(timers.report()) == s
    timers.reset()
    assert timers.summary() == {}

    counter = profiling.CheckCounter()
    fn = counter.wrap(lambda q: q)
    fn(torch.zeros(7, 2))
    fn(np.zeros((3, 2)))
    fn(torch.zeros(2))        # one flat configuration
    assert counter.count == 11
    counter.reset()
    assert counter.count == 0


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / 'trace')
    with profiling.trace(log_dir) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    path = os.path.join(log_dir, 'trace.json')
    with open(path) as f:
        events = json.load(f)['traceEvents']
    assert any('mm' in e.get('name', '') for e in events)
    assert len(prof.key_averages()) > 0


def test_device_memory_stats():
    stats = profiling.device_memory_stats()
    if torch.cuda.is_available():
        assert set(stats) == {f'cuda:{d}'
                              for d in range(torch.cuda.device_count())}
    else:
        assert stats == {'cpu': None}
