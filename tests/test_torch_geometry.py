"""Port parity: the capsule-chain ground truth against ShapeEnv scenes
(diffco_tpu_torch.robots.capsule_chain vs diffco_tpu's)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import diffco_tpu as jdc
from diffco_tpu.robots import PandaFK as JPanda
from diffco_tpu.robots.capsule_chain import CapsuleChainCollision as JCap
import diffco_tpu_torch as tdc
from diffco_tpu_torch.robots.capsule_chain import CapsuleChainCollision as TCap

torch.set_num_threads(1)


def _T(t, rot=None):
    m = np.eye(4)
    m[:3, 3] = t
    if rot is not None:
        m[:3, :3] = rot
    return m


_RZ = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])

SCENES = {
    # the box + sphere of tests/test_checkers.py::panda_world
    'box_sphere': {
        'box1': {'type': 'Box', 'params': {'extents': [0.1, 0.1, 0.1]},
                 'transform': _T([0.5, 0.5, 0.5])},
        'sphere1': {'type': 'Sphere', 'params': {'radius': 0.1},
                    'transform': _T([0.5, 0, 0])}},
    'all_primitives': {
        'box1': {'type': 'Box', 'params': {'extents': [0.3, 0.2, 0.4]},
                 'transform': _T([0.4, 0.3, 0.4], _RZ)},
        'sphere1': {'type': 'Sphere', 'params': {'radius': 0.2},
                    'transform': _T([0.4, -0.2, 0.3])},
        'cylinder1': {'type': 'Cylinder',
                      'params': {'radius': 0.1, 'height': 0.4},
                      'transform': _T([0.0, -0.5, 0.5], _RZ)},
        'capsule1': {'type': 'Capsule',
                     'params': {'radius': 0.1, 'height': 0.3},
                     'transform': _T([-0.3, 0.4, 0.2])}},
}


def _q(n, seed):
    lims = JPanda().limits
    lims = np.asarray(lims)
    u = np.random.default_rng(seed).uniform(size=(n, 7)).astype(np.float32)
    return u * (lims[:, 1] - lims[:, 0]) + lims[:, 0]


@pytest.mark.parametrize('scene', sorted(SCENES))
@pytest.mark.parametrize('link_radius', [0.06, 0.15])
def test_signed_dist_matches(scene, link_radius):
    q = _q(512, seed=7)
    jenv = jdc.ShapeEnv(shapes=SCENES[scene])
    tenv = tdc.ShapeEnv(SCENES[scene])
    assert tenv.object_names == jenv.object_names
    ref = np.asarray(JCap(JPanda(), link_radius=link_radius).signed_dist(
        jnp.asarray(q), jenv))
    gt = TCap(tdc.PandaFK(), link_radius=link_radius)
    out = gt.signed_dist(torch.from_numpy(q), tenv).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out > 0, ref > 0)
    labels = gt.checker_fn(tenv)(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(labels, ref > 0)
    assert 0 < labels.sum() < len(labels)


def test_mesh_obstacles_raise():
    """A Mesh shape builds its sphere decomposition (one object); one whose
    file is missing raises, as in the JAX package."""
    with pytest.raises(FileNotFoundError):
        tdc.ShapeEnv({'m': {'type': 'Mesh', 'params': {'file_obj': 'x.obj'}}})
    with pytest.raises(FileNotFoundError):
        jdc.ShapeEnv({'m': {'type': 'Mesh', 'params': {'file_obj': 'x.obj'}}})
    env = tdc.ShapeEnv({'m': {'type': 'Mesh', 'params': {
        'file_obj': 'robot_data/generated/torus.stl'}}}, mesh_spheres=4)
    assert env.n_objects == 1 and env.scene.msh_c.shape == (4, 3)
