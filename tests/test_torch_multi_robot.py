"""MultiURDFRobot against the JAX package on the same numpy inputs: two
2-link robots with offset bases (tests/test_checkers2.py's layouts) and
the dual FrankaPanda (the second base 1.0 m along x, turned pi about z):
fkine, split_q, compute_forward_kinematics_all_links, the collision check
with and without a scene (the Pandas: with it), the inter-robot check
and wrap; labels compared
exactly away from |d| < 1e-5 (d the largest signed distance of the
check). Then a JAX-fitted ForwardKinematicsDiffCo on the 2-link pair
carried across (scores at 1e-4) and a fit of the port alone (TPR >= 0.85,
the reference test's limit)."""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffco_tpu as jdc
from diffco_tpu.robots.urdf import URDFRobot as JURDFRobot
import diffco_tpu_torch as tdc
from diffco_tpu_torch import robot_data
from diffco_tpu_torch.convert import load_reference_state

torch.set_num_threads(1)

B = 96


def _T(t, yaw=0.0):
    m = np.eye(4)
    c, s = math.cos(yaw), math.sin(yaw)
    m[:2, :2] = [[c, -s], [s, c]]
    m[:3, 3] = t
    return m


# tests/test_checkers2.py:145-150's post between the 2-link bases
POST = {'post': {'type': 'Cylinder', 'params': {'radius': 0.3,
                                                'height': 1.0},
                 'transform': _T([0.8, 0.9, 0.15])}}
# a post between the two Panda bases, and a ball over them
PANDA_SCENE = {
    'post': {'type': 'Cylinder', 'params': {'radius': 0.08, 'height': 1.2},
             'transform': _T([0.5, 0.3, 0.6])},
    'ball': {'type': 'Sphere', 'params': {'radius': 0.12},
             'transform': _T([0.5, -0.35, 0.7])}}


def _pair(kind, acm):
    """(JAX robots, port robots) of a layout, read from the same URDF
    files; the port's self-collision pairs (setup_acm) copied onto the
    JAX robots, whose ACM draws other random configurations."""
    assets = robot_data.ensure_default_assets()
    if kind == '2link':
        path = os.path.join(assets, '2link_robot.urdf')
        bases = [None, _T([1.6, 0.0, 0.0])]
        kw = dict(setup_acm=False)
    else:
        path = os.path.join(assets, 'panda_simple.urdf')
        bases = [None, _T([1.0, 0.0, 0.0], yaw=math.pi)]
        kw = dict(setup_acm=acm, link_spheres=3)
    t = [tdc.URDFRobot(path, base_transform=b, device='cpu', **kw)
         for b in bases]
    j = [JURDFRobot(path, base_transform=b, setup_acm=False,
                    link_spheres=kw.get('link_spheres', 8)) for b in bases]
    for jr, tr in zip(j, t):
        jr._self_pair_i = jnp.asarray(tr._self_pair_i.numpy())
        jr._self_pair_j = jnp.asarray(tr._self_pair_j.numpy())
    return jdc.MultiURDFRobot(j), tdc.MultiURDFRobot(t)


def _q(multi, n, seed):
    lims = multi.joint_limits.numpy()
    u = np.random.default_rng(seed).uniform(size=(n, lims.shape[0]))
    return (u * (lims[:, 1] - lims[:, 0]) + lims[:, 0]).astype(np.float32)


def _signed(multi, q, scene):
    """The largest signed distance of the port's check per configuration:
    every robot's environment and self distances and the inter-robot
    overlap."""
    qs = multi.split_q(q)
    parts = [multi._inter_robot_overlap(qs)]
    for r, qq in zip(multi.robots, qs):
        env_sd, self_sd = r.collision_signed_dist(qq, scene)
        parts += [self_sd] + ([env_sd.amax(-1)] if env_sd.shape[1] else [])
    return torch.stack(parts, -1).amax(-1).numpy()


def _labels_agree(ref, out, d):
    away = np.abs(d) >= 1e-5
    assert away.mean() > 0.95
    np.testing.assert_array_equal(np.asarray(ref)[away],
                                  out.numpy()[away])


@pytest.mark.parametrize('kind', ['2link', 'panda'])
def test_multi_robot_matches_reference(kind):
    jm, tm = _pair(kind, acm=True)
    scene = POST if kind == '2link' else PANDA_SCENE
    jenv, tenv = jdc.ShapeEnv(shapes=scene), tdc.ShapeEnv(scene)
    assert tm._n_dofs == jm._n_dofs == tm.dof
    q = _q(tm, B, seed=len(kind))
    qt, qj = torch.from_numpy(q), jnp.asarray(q)
    np.testing.assert_array_equal(tm.joint_limits.numpy(),
                                  np.asarray(jm.joint_limits))
    for a, b in zip(tm.split_q(qt), jm.split_q(qj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(tm.fkine(qt).numpy(), np.asarray(jm.fkine(qj)),
                               atol=1e-5)
    for ft, fj in zip(tm.compute_forward_kinematics_all_links(qt),
                      jm.compute_forward_kinematics_all_links(qj)):
        assert list(ft) == list(fj)
        for name in ft:
            (tt, rt), = ft[name]
            (tj, rj), = fj[name]
            np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
            np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)
    if kind == '2link':   # the check without a scene (a compile of its
        # own in the JAX package, ~8 s for the two Pandas)
        _labels_agree(jm.collision(qj), tm.collision(qt),
                      _signed(tm, qt, None))
    _labels_agree(jm.collision(qj, other=jenv), tm.collision(qt, tenv),
                  _signed(tm, qt, tenv))
    inter = tm._inter_robot_overlap(tm.split_q(qt)).numpy()
    _labels_agree(jax.jit(lambda x: jm._inter_robot_hit(jm.split_q(x)))(qj),
                  tm._inter_robot_hit(tm.split_q(qt)), inter)
    # both outcomes occur, so that the comparison means something
    hit = tm.collision(qt, tenv).numpy()
    assert 0 < hit.sum() < len(hit)
    qw = q * 3.0
    np.testing.assert_allclose(tm.wrap(torch.from_numpy(qw)).numpy(),
                               np.asarray(jm.wrap(jnp.asarray(qw))),
                               atol=1e-5)


def test_rand_configs_draw_each_robot_from_one_generator():
    """Each robot's part in turn from the one generator, on the device
    asked for, within the joint limits."""
    path = os.path.join(robot_data.ensure_default_assets(),
                        '2link_robot.urdf')
    tm = tdc.MultiURDFRobot([
        tdc.URDFRobot(path, device='cpu', setup_acm=False),
        tdc.URDFRobot(path, base_transform=_T([1.6, 0, 0]), device='cpu',
                      setup_acm=False)])
    g = torch.Generator().manual_seed(3)
    q = tm.rand_configs(50, g, 'cpu')
    g = torch.Generator().manual_seed(3)
    parts = [r.rand_configs(50, g, 'cpu') for r in tm.robots]
    torch.testing.assert_close(q, torch.cat(parts, -1))
    lims = tm.joint_limits
    assert bool(((q >= lims[:, 0]) & (q <= lims[:, 1])).all())


def _state(checker):
    p = checker.perceptron
    out = {k: np.asarray(getattr(p, k)) for k in (
        'support_points', 'support_transformed', 'gains', 'hypothesis', 'y',
        'kernel_matrix', 'rbf_nodes', 'valid_mask', 'num_valid')}
    out['epsilon'] = np.asarray(p.rbf_kernel.epsilon)
    out['safety_bias'] = np.asarray(checker.safety_bias)
    return out


def test_carried_multi_robot_proxy_scores_match():
    """A ForwardKinematicsDiffCo on the 2-link pair fitted by the JAX
    package (600 numpy configurations, the JAX ground truth's labels),
    carried across: the port's scores (FK of both robots, then the point
    score; the one-pass chain routes take single URDF robots only) within
    1e-4 of the reference's."""
    jm, tm = _pair('2link', acm=False)
    jenv = jdc.ShapeEnv(shapes=POST)
    q = _q(tm, 600, seed=5)
    labels = np.asarray(jm.collision(jnp.asarray(q), other=jenv))
    assert 0 < labels.sum() < len(labels)
    jck = jdc.ForwardKinematicsDiffCo(robot=jm, environment=jenv)
    jck.fit(q=q, labels=labels.astype(np.float32))
    tck = tdc.ForwardKinematicsDiffCo(robot=tm, environment=tdc.ShapeEnv(POST),
                                      device='cpu')
    load_reference_state(tck, _state(jck))
    assert tck.perceptron._fk_robot() is tm
    qv = _q(tm, 512, seed=6)
    ref = np.asarray(jck.collision_score(jnp.asarray(qv)))
    out = tck.collision_score(torch.from_numpy(qv)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    ref_p = np.asarray(jck.perceptron.poly_score(jnp.asarray(qv)))
    out_p = tck.perceptron.poly_score(torch.from_numpy(qv)).numpy()
    np.testing.assert_allclose(out_p, ref_p, rtol=1e-4, atol=1e-4)


def test_multi_robot_fit_on_the_port():
    """tests/test_checkers2.py::test_multi_urdf_fkdiffco_fit on the port
    alone: the 2-link pair around the post, 2000 samples, TPR >= 0.85."""
    _, tm = _pair('2link', acm=False)
    ck = tdc.ForwardKinematicsDiffCo(robot=tm, environment=tdc.ShapeEnv(POST),
                                     device='cpu', seed=0)
    rate = float(tm.collision(tm.rand_configs(
        500, torch.Generator().manual_seed(1), 'cpu'), tdc.ShapeEnv(POST))
        .float().mean())
    assert 0.02 < rate < 0.98
    acc, tpr, tnr = ck.fit(num_samples=2000)
    assert tpr >= 0.85
    scores = ck.collision_score(tm.rand_configs(
        32, torch.Generator().manual_seed(2), 'cpu'))
    assert bool(torch.isfinite(scores).all())
