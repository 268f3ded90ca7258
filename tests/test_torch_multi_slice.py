"""The multi-class slice as a whole against the JAX package: PandaFK and
FrankaPanda ForwardKinematicsDiffCo checkers with a MultiDiffCo proxy
over two obstacle classes, fitted by both packages on the same numpy
configurations and [N, 2] labels (same supports, nodes, safety bias and
collision scores, below and at the multi-class kernels' gate), and a
JAX-fitted checker carried across by load_reference_state."""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import diffco_tpu as jdc
from diffco_tpu.robots import PandaFK as JPanda
from diffco_tpu.robots.capsule_chain import CapsuleChainCollision as JCap
from diffco_tpu.robots.urdf import URDFRobot as JURDFRobot
import diffco_tpu_torch as tdc
from diffco_tpu_torch import robot_data
from diffco_tpu_torch.convert import load_reference_state

torch.set_num_threads(1)

URDF_KW = dict(setup_acm=False, link_spheres=2)


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


def _panda_labels(q):
    """PandaFK, one capsule-chain ground truth per shape: box1, sphere1."""
    gt = JCap(JPanda(), link_radius=0.15)
    return np.stack([np.asarray(gt.signed_dist(
        jnp.asarray(q), jdc.ShapeEnv(shapes={k: SHAPES[k]}))) > 0
        for k in ('box1', 'sphere1')], axis=1)


def _franka():
    path = os.path.join(robot_data.ensure_default_assets(),
                        'panda_simple.urdf')
    return JURDFRobot(path, name='panda', **URDF_KW)


def _franka_labels(q):
    """FrankaPanda's sphere model against the scene: two classes, the
    shapes {box1, sphere1} and {cylinder1, capsule1}."""
    env_sd, _ = _franka().collision_signed_dist(jnp.asarray(q),
                                                jdc.ShapeEnv(shapes=SHAPES))
    hit = np.asarray(env_sd) > 0                 # [N, 4] in SHAPES order
    return np.stack([hit[:, :2].any(1), hit[:, 2:].any(1)], axis=1)


ROBOTS = {
    'PandaFK': (JPanda, lambda: tdc.PandaFK(), _panda_labels),
    'FrankaPanda': (_franka, lambda: tdc.FrankaPanda(
        load_gripper=True, device='cpu', **URDF_KW), _franka_labels),
}


def _q(robot, n, seed):
    lims = np.asarray(robot.joint_limits)
    u = np.random.default_rng(seed).uniform(size=(n, lims.shape[0]))
    return (u * (lims[:, 1] - lims[:, 0]) + lims[:, 0]).astype(np.float32)


def reference_state(checker):
    """The arrays load_reference_state takes, read off a fitted JAX
    MultiDiffCo checker."""
    p = checker.perceptron
    out = {k: np.asarray(getattr(p, k)) for k in (
        'support_points', 'support_transformed', 'gains', 'hypothesis', 'y',
        'kernel_matrix', 'rbf_nodes', 'valid_mask', 'num_valid',
        'num_class')}
    out['rbf_kernel'] = type(p.rbf_kernel).__name__
    out['k'] = p.rbf_kernel.k
    out['epsilon'] = p.rbf_kernel.epsilon
    out['safety_bias'] = np.asarray(checker.safety_bias)
    return out


@pytest.fixture(scope='module', params=sorted(ROBOTS))
def fitted(request):
    """Both packages' checkers fitted on the same 400 configurations and
    [400, 2] labels (no held-out split, so that both train on every
    row), the safety bias of each from the same 1000 configurations; and
    a port checker holding the JAX checker's state."""
    jrobot_fn, trobot_fn, labels_fn = ROBOTS[request.param]
    jrobot = jrobot_fn()
    q = _q(jrobot, 400, seed=31)
    labels = labels_fn(q)
    assert labels.shape == (400, 2)
    assert (0 < labels.sum(0)).all() and (labels.sum(0) < 400).all()
    jck = jdc.ForwardKinematicsDiffCo(robot=jrobot, perceptron_class=(
        jdc.MultiDiffCo), gt_check_func=labels_fn)
    tck = tdc.ForwardKinematicsDiffCo(robot=trobot_fn(), perceptron_class=(
        tdc.MultiDiffCo), gt_check_func=labels_fn, device='cpu')
    for ck in (jck, tck):
        ck.fit(q=q, labels=labels.astype(np.float32), verify_ratio=0)
    q_v = _q(jrobot, 5096, seed=32)
    jck.safety_bias = jck._calculate_safety_bias(jnp.asarray(q_v[:1000]))
    tck.safety_bias = tck._calculate_safety_bias(torch.from_numpy(q_v[:1000]))
    loaded = tdc.ForwardKinematicsDiffCo(
        robot=trobot_fn(), perceptron_class=tdc.MultiDiffCo,
        gt_check_func=labels_fn, device='cpu')
    load_reference_state(loaded, reference_state(jck))
    return dict(name=request.param, jck=jck, tck=tck, loaded=loaded,
                q_v=q_v[1000:])


def test_fit_state_matches(fitted):
    """The same greedy run (iterations, supports, gains); the per-class
    surrogate solves agree to the rounding of a float32 LU solve of the
    same polyharmonic system (up to ~2e-3 of the nodes here), and so do
    the safety biases taken from them."""
    jp, tp = fitted['jck'].perceptron, fitted['tck'].perceptron
    assert tp.num_class == jp.num_class == 2
    assert tp.train_iterations == jp.train_iterations
    assert tp.num_valid == jp.num_valid
    np.testing.assert_allclose(tp.support_points.numpy(),
                               np.asarray(jp.support_points), atol=1e-6)
    np.testing.assert_allclose(tp.gains.numpy(), np.asarray(jp.gains),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tp.rbf_nodes.numpy(), np.asarray(jp.rbf_nodes),
                               rtol=1e-2, atol=1e-2)
    ref_b = fitted['jck'].safety_bias
    assert abs(fitted['tck'].safety_bias - ref_b) <= 1e-2 * max(1.0, ref_b)


@pytest.mark.parametrize('B', [256, 4096])
def test_collision_score_matches(fitted, B):
    """B = 256 takes FK + the plain [B, S] @ [S, C] route, B = 4096 the
    one-pass multi-class route (kernel B4's or B5's plain twin here): on
    the JAX state, the JAX scores to 1e-4; the port's own fit within the
    solves' rounding of the JAX fit's."""
    q = fitted['q_v'][:B]
    ref = np.asarray(fitted['jck'].collision_score(jnp.asarray(q)))
    out = fitted['loaded'].collision_score(torch.from_numpy(q)).numpy()
    assert out.shape == ref.shape == (B, 2)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    own = fitted['tck'].collision_score(torch.from_numpy(q), bias=0).numpy()
    ref0 = np.asarray(fitted['jck'].collision_score(jnp.asarray(q), bias=0))
    np.testing.assert_allclose(own, ref0, rtol=1e-2, atol=1e-2)


def test_verify_matches(fitted):
    q = fitted['q_v'][:1000]
    lab = 2.0 * ROBOTS[fitted['name']][2](q).astype(np.float32) - 1.0
    ref = fitted['jck'].verify(jnp.asarray(q), jnp.asarray(lab))
    out = fitted['loaded'].verify(torch.from_numpy(q), torch.from_numpy(lab))
    np.testing.assert_allclose(out, ref, atol=2e-3)  # <= 4 of 2000 flipped
    own = fitted['tck'].verify(torch.from_numpy(q), torch.from_numpy(lab))
    np.testing.assert_allclose(own, ref, atol=2e-2)


def test_reference_state_carries_across(fitted):
    """load_reference_state carries the class count and the Polyharmonic
    surrogate of a JAX MultiDiffCo, and its safety bias."""
    p, jp = fitted['loaded'].perceptron, fitted['jck'].perceptron
    assert p.num_class == 2 and p.rbf_nodes.shape == jp.rbf_nodes.shape
    assert isinstance(p.rbf_kernel, tdc.kernels.Polyharmonic)
    assert (p.rbf_kernel.k, p.rbf_kernel.epsilon) == (1, 1.0)
    assert fitted['loaded'].safety_bias == pytest.approx(
        fitted['jck'].safety_bias)
