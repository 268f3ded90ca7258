"""The URDF slice as a whole against the JAX package: a FrankaPanda
ForwardKinematicsDiffCo fitted by the JAX package in the 4-shape scene,
its state carried across with load_reference_state, then the sweeps (below
and at the chain kernel's gate), the safety bias, verification and Adam
trajectory optimization compared on the same numpy inputs; and a checker
built from a URDF path with a base transform."""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import diffco_tpu as jdc
from diffco_tpu import optim as joptim
from diffco_tpu.robots.urdf import URDFRobot as JURDFRobot
import diffco_tpu_torch as tdc
from diffco_tpu_torch import optim as toptim
from diffco_tpu_torch import robot_data
from diffco_tpu_torch.convert import load_reference_state

torch.set_num_threads(1)

ROBOT_KW = dict(setup_acm=False, link_spheres=3)


def _T(t):
    m = np.eye(4)
    m[:3, 3] = t
    return m


# the 4-shape scene of tests/test_checkers.py::panda_world
SHAPES = {
    'box1': {'type': 'Box', 'params': {'extents': [0.1, 0.1, 0.1]},
             'transform': _T([0.5, 0.5, 0.5])},
    'sphere1': {'type': 'Sphere', 'params': {'radius': 0.1},
                'transform': _T([0.5, 0, 0])},
    'cylinder1': {'type': 'Cylinder', 'params': {'radius': 0.1, 'height': 0.2},
                  'transform': _T([0, -0.5, 0.5])},
    'capsule1': {'type': 'Capsule', 'params': {'radius': 0.1, 'height': 0.2},
                 'transform': _T([0.5, 0.5, 0])},
}


def reference_state(checker):
    """The arrays load_reference_state takes, read off a fitted JAX
    checker: np.asarray of each DiffCo attribute."""
    p = checker.perceptron
    out = {k: np.asarray(getattr(p, k)) for k in (
        'support_points', 'support_transformed', 'gains', 'hypothesis', 'y',
        'kernel_matrix', 'rbf_nodes', 'valid_mask', 'num_valid')}
    out['epsilon'] = np.asarray(p.rbf_kernel.epsilon)
    out['safety_bias'] = np.asarray(checker.safety_bias)
    return out


def _jpanda():
    """The JAX FrankaPanda without a robot-data folder, read from the
    port's generated panda_simple.urdf (byte-identical to the JAX
    package's, and written atomically for parallel test workers)."""
    path = os.path.join(robot_data.ensure_default_assets(),
                        'panda_simple.urdf')
    return JURDFRobot(path, name='panda', **ROBOT_KW)


def _q(n, seed):
    lims = _jpanda().spec.joint_limits
    u = np.random.default_rng(seed).uniform(size=(n, 7)).astype(np.float32)
    return u * (lims[:, 1] - lims[:, 0]) + lims[:, 0]


@pytest.fixture(scope='module')
def fitted():
    """JAX checker fitted on 400 numpy configurations with the JAX ground
    truth's labels; a port checker holding the same state."""
    jenv = jdc.ShapeEnv(shapes=SHAPES)
    jrobot = _jpanda()
    q = _q(400, seed=21)
    labels = np.asarray(jrobot.collision(jnp.asarray(q), jenv))
    jck = jdc.ForwardKinematicsDiffCo(robot=jrobot, environment=jenv)
    jck.fit(q=q, labels=labels.astype(np.float32))
    tck = tdc.ForwardKinematicsDiffCo(
        robot=tdc.FrankaPanda(load_gripper=True, device='cpu', **ROBOT_KW),
        environment=tdc.ShapeEnv(SHAPES), device='cpu')
    load_reference_state(tck, reference_state(jck))
    q_v = _q(4096, seed=22)
    lab_v = np.asarray(jrobot.collision(jnp.asarray(q_v), jenv))
    assert 0 < labels.sum() < len(labels)
    return dict(jck=jck, tck=tck, q=q, labels=labels, q_v=q_v,
                lab_v=(2.0 * lab_v - 1.0).astype(np.float32))


@pytest.mark.parametrize('B', [256, 4096])
def test_collision_score_matches(fitted, B):
    """B = 256 takes FK + the plain score route, B = 4096 the one-pass
    chain route (the plain twin of kernel B3 on the CPU)."""
    q = fitted['q_v'][:B]
    ref = np.asarray(fitted['jck'].collision_score(jnp.asarray(q)))
    out = fitted['tck'].collision_score(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    # the link-position entry point (point-space route, F = 24)
    pts = np.array(fitted['jck'].robot.fkine(jnp.asarray(q)))
    assert pts.shape == (B, 8, 3)
    ref_p = np.asarray(fitted['jck'].collision_score(q_link_pos=pts))
    out_p = fitted['tck'].collision_score(
        q_link_pos=torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(out_p, ref_p, rtol=1e-4, atol=1e-4)


def test_safety_bias_and_verify_match(fitted):
    q_v = fitted['q_v'][:1000]
    lab = fitted['lab_v'][:1000]
    ref_b = fitted['jck']._calculate_safety_bias(jnp.asarray(q_v))
    out_b = fitted['tck']._calculate_safety_bias(torch.from_numpy(q_v))
    assert abs(out_b - ref_b) <= 1e-4 * max(1.0, abs(ref_b))
    ref = fitted['jck'].verify(jnp.asarray(q_v), jnp.asarray(lab))
    out = fitted['tck'].verify(torch.from_numpy(q_v), torch.from_numpy(lab))
    np.testing.assert_allclose(out, ref, atol=2e-3)  # <= 2 flipped labels


def test_adam_trajopt_matches(fitted):
    jck, tck = fitted['jck'], fitted['tck']
    free = fitted['q'][~fitted['labels']]
    start, target = free[0], free[1]
    init = np.linspace(start, target, 20) + np.random.default_rng(3).normal(
        scale=0.05, size=(20, 7)).astype(np.float32)
    opts = {'N_WAYPOINTS': 20, 'NUM_RE_TRIALS': 1, 'MAXITER': 20,
            'safety_margin': -0.1, 'max_speed': 2.0, 'seed': 0,
            'dense_sub': 4, 'init_solution': init}
    ref = joptim.adam_traj_optimize(
        jck.robot, lambda p: jck.collision_score(p, bias=0).reshape(-1),
        start, target, opts)
    out = toptim.adam_traj_optimize(
        tck.robot, lambda p: tck.collision_score(p, bias=0).reshape(-1),
        torch.from_numpy(start), torch.from_numpy(target), opts)
    np.testing.assert_allclose(np.asarray(out['solution']),
                               np.asarray(ref['solution']), atol=1e-3)
    np.testing.assert_allclose(out['cost'], ref['cost'], rtol=1e-3)
    assert out['success'] == ref['success']


def test_checker_from_urdf_path_with_base():
    """A checker given a URDF path and a base transform builds the same
    robot as the JAX package's, base included."""
    path = os.path.join(robot_data.ensure_default_assets(), 'lift_rig.urdf')
    T = np.array([[0.0, -1.0, 0.0, 0.1],
                  [1.0, 0.0, 0.0, -0.2],
                  [0.0, 0.0, 1.0, 0.3],
                  [0.0, 0.0, 0.0, 1.0]])
    jck = jdc.ForwardKinematicsDiffCo(robot=path, robot_base_transform=T)
    tck = tdc.ForwardKinematicsDiffCo(robot=path, robot_base_transform=T,
                                      device='cpu')
    jr, tr = jck.robot, tck.robot
    assert isinstance(tr, tdc.URDFRobot) and tr.name == jr.name == 'lift_rig'
    np.testing.assert_array_equal(tr.base_rot, np.asarray(jr.base_rot))
    np.testing.assert_array_equal(tr.base_trans, np.asarray(jr.base_trans))
    assert tck.unique_position_link_names == jck.unique_position_link_names
    lims = jr.spec.joint_limits
    q = (np.random.default_rng(8).uniform(size=(16, 3)) * (
        lims[:, 1] - lims[:, 0]) + lims[:, 0]).astype(np.float32)
    np.testing.assert_allclose(tr.fkine(torch.from_numpy(q)).numpy(),
                               np.asarray(jr.fkine(jnp.asarray(q))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tr.sphere_centers_world(torch.from_numpy(q)).numpy(),
        np.asarray(jr.sphere_centers_world(jnp.asarray(q))), rtol=1e-5,
        atol=1e-6)
    out = tck.fkine(torch.from_numpy(q))
    ref = jck.fkine(jnp.asarray(q))
    assert list(out) == list(ref)
    for name in ref:
        np.testing.assert_allclose(out[name][0][0].numpy(),
                                   np.asarray(ref[name][0][0]), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match='URDF'):
        tdc.ForwardKinematicsDiffCo(robot='/nonexistent.urdf', device='cpu')
