"""The temporal pieces and the legacy obstacle-list API against the JAX
package on the same numpy inputs: the obstacle motions, the dynamic
ground truth in its batched (scalar motions) and looped (custom motions)
forms, temporal_dataset's labels, PointRobot1D, a temporal DiffCo fitted
by the JAX package and carried across, and every legacy class.
Tolerances: positions and signed distances 1e-5 (float32, the same
formulas); labels exact away from |d| < 1e-5; carried scores 1e-4 and
their gradient 1e-3, evaluated in float64 on both sides (the q-space
proxy's cancelling terms, summed in float32 in other orders, differ by
more than 1e-4)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffco_tpu import dynamics as jdyn
from diffco_tpu import kernels as jkernels
from diffco_tpu import legacy as jleg
from diffco_tpu.perceptron import DiffCo as JDiffCo
from diffco_tpu.robots import PointRobot1D as JPointRobot1D
from diffco_tpu.robots import RevolutePlanarRobot as JPlanar
import diffco_tpu_torch as tdc
from diffco_tpu_torch import dynamics as tdyn
from diffco_tpu_torch import legacy as tleg
from diffco_tpu_torch.convert import load_reference_state

torch.set_num_threads(1)

LIMITS = [[0.0, 10.0], [0.0, 10.0]]


def _motions(pkg):
    """scripts/temporal_1d.py's two obstacles."""
    return [(pkg.LinearMotion(0.5, 2.0), 0.6),
            (pkg.SineMotion(2.0, 0.8, 0.0, 7.0), 0.5)]


def _xt(n, seed):
    u = np.random.default_rng(seed).uniform(size=(n, 2))
    lims = np.asarray(LIMITS)
    return (u * (lims[:, 1] - lims[:, 0]) + lims[:, 0]).astype(np.float32)


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def test_motions_match():
    t = np.linspace(0.0, 10.0, 41).astype(np.float32)
    for (tm, _), (jm, _) in zip(_motions(tdyn), _motions(jdyn)):
        ref = jm.predict(jnp.asarray(t))
        _close(tm.predict(torch.from_numpy(t)), ref)
        _close(tm.position(torch.from_numpy(t)), ref)
        _close(tm(torch.from_numpy(t)), ref)
    # vector-valued motions
    for make in (lambda m: m.LinearMotion([1.0, 0.0], [0.0, 1.0]),
                 lambda m: m.SineMotion(0.5, 1.3, 0.2, [1.0, -2.0])):
        _close(make(tdyn).predict(torch.from_numpy(t)),
               make(jdyn).predict(jnp.asarray(t)))


class _Bounce:
    """A custom motion (no unified parameters): |3 - t| + 1."""

    def predict(self, t):
        return abs(3.0 - t) + 1.0


class _TBounce(_Bounce, tdyn.ObstacleMotion):
    pass


class _JBounce(_Bounce, jdyn.ObstacleMotion):
    pass


@pytest.mark.parametrize('form', ['unified', 'loop'])
def test_dynamic_checker_matches(form):
    """Dynamic1DChecker.signed_dist, predict and collision, batched for
    scalar motions and looped once a custom motion (no unified
    parameters) joins them."""
    tobs, jobs = _motions(tdyn), _motions(jdyn)
    if form == 'loop':
        tobs, jobs = tobs + [(_TBounce(), 0.4)], jobs + [(_JBounce(), 0.4)]
    tgt = tdyn.Dynamic1DChecker(tobs, device='cpu')
    jgt = jdyn.Dynamic1DChecker(jobs)
    assert (tgt._params is None) == (form == 'loop')
    xt = _xt(3000, seed=1)
    sd = tgt.signed_dist(torch.from_numpy(xt))
    _close(sd, jgt.signed_dist(jnp.asarray(xt)))
    away = np.abs(sd.numpy()).min(-1) >= 1e-5
    np.testing.assert_array_equal(
        tgt.predict(torch.from_numpy(xt)).numpy()[away],
        np.asarray(jgt.predict(jnp.asarray(xt)))[away])
    np.testing.assert_array_equal(
        tgt.collision(xt).numpy()[away],
        np.asarray(jgt.collision(jnp.asarray(xt)))[away])


def test_temporal_dataset_labels_match_the_reference_ground_truth():
    """temporal_dataset's draw is the port's own; its labels and
    distances are the reference ground truth's on the same (x, t)."""
    tgt = tdyn.Dynamic1DChecker(_motions(tdyn), device='cpu')
    jgt = jdyn.Dynamic1DChecker(_motions(jdyn))
    xt, labels, d = tdyn.temporal_dataset(
        tgt, LIMITS, 2000, torch.Generator().manual_seed(0))
    assert xt.shape == (2000, 2) and bool((xt >= 0).all() & (xt <= 10).all())
    ref_d = np.asarray(jgt.signed_dist(jnp.asarray(xt.numpy()))).max(-1)
    _close(d, ref_d)
    away = np.abs(ref_d) >= 1e-5
    np.testing.assert_array_equal(labels.numpy()[away],
                                  ((ref_d > 0) * 2.0 - 1.0)[away])
    assert 0.05 < float((labels > 0).float().mean()) < 0.8


def test_point_robot_1d_matches():
    tr, jr = tdc.PointRobot1D(LIMITS), JPointRobot1D(LIMITS)
    assert tr.dof == jr.dof == 1
    q = tr.rand_configs(500, torch.Generator().manual_seed(2), 'cpu')
    assert q.shape == (500, 2) and bool((q >= 0).all() & (q <= 1).all())
    xt = _xt(200, seed=3)
    _close(tr.normalize(torch.from_numpy(xt)), jr.normalize(jnp.asarray(xt)))
    n = np.array(jr.normalize(jnp.asarray(xt)))
    _close(tr.unnormalize(torch.from_numpy(n)),
           jr.unnormalize(jnp.asarray(n)))
    _close(tr.fkine(torch.from_numpy(n[:, :1])),
           jr.fkine(jnp.asarray(n[:, :1])))
    _close(tr.wrap(torch.from_numpy(n)), jr.wrap(jnp.asarray(n)))


STATE_FIELDS = ('support_points', 'support_transformed', 'gains',
                'hypothesis', 'y', 'kernel_matrix', 'rbf_nodes',
                'valid_mask')


def test_temporal_diffco_carried_state_matches():
    """scripts/temporal_1d.py's proxy at 600 samples, fitted by the JAX
    package on normalized (x, t), carried into a port DiffCo with the
    port's TemporalFKKernel: the kernel survives the load (the transform
    is None: a q-space proxy), and poly_score and its gradient on 1000
    normalized held-out rows match in float64."""
    jgt = jdyn.Dynamic1DChecker(_motions(jdyn))
    jr = JPointRobot1D(LIMITS)
    xt = _xt(600, seed=4)
    y = ((np.asarray(jgt.signed_dist(jnp.asarray(xt))).max(-1) > 0) * 2.0
         - 1.0).astype(np.float32)
    jk = jkernels.TemporalFKKernel(
        fkine=lambda x: x, rqkernel=jkernels.RQKernel(100.0),
        t_rqkernel=jkernels.RQKernel(100.0), alpha=3.0)
    jp = JDiffCo(kernel_func=jk)
    jp.train(jr.normalize(jnp.asarray(xt)), jnp.asarray(y),
             max_iteration=1800)
    jp.fit_poly(jkernels.Polyharmonic(1, 1), target='label')
    tk = tdc.kernels.TemporalFKKernel(
        fkine=lambda x: x, rqkernel=tdc.kernels.RQKernel(100.0),
        t_rqkernel=tdc.kernels.RQKernel(100.0), alpha=3.0)
    tp = tdc.DiffCo(kernel_func=tk)
    arrays = {k: np.asarray(getattr(jp, k)) for k in STATE_FIELDS}
    arrays.update(num_valid=jp.num_valid, rbf_kernel='Polyharmonic', k=1,
                  epsilon=1.0)
    load_reference_state(tp, arrays, device='cpu')
    assert tp.kernel_func is tk and tp.transform is None
    xn = np.array(jr.normalize(jnp.asarray(_xt(1000, seed=5))))
    floats = [k for k in STATE_FIELDS if k != 'valid_mask']
    with jax.enable_x64(True):
        j64 = copy.copy(jp)
        for k in floats:
            setattr(j64, k, jnp.asarray(np.asarray(getattr(jp, k)),
                                        jnp.float64))
        x = jnp.asarray(xn, jnp.float64)
        js = np.asarray(j64.poly_score(x))
        jdx = np.asarray(jax.grad(lambda x: j64.poly_score(x).sum())(x))
    t64 = copy.copy(tp)
    for k in floats:
        setattr(t64, k, getattr(tp, k).double())
    x = torch.from_numpy(xn).double().requires_grad_(True)
    ts = t64.poly_score(x)
    tdx, = torch.autograd.grad(ts.sum(), x)
    np.testing.assert_allclose(ts.detach().numpy(), js, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tdx.numpy(), jdx, rtol=1e-3, atol=1e-3)
    # the float32 state itself, as the card runs it, at 1e-3
    np.testing.assert_allclose(
        tp.poly_score(torch.from_numpy(xn)).numpy(),
        np.asarray(jp.poly_score(jnp.asarray(xn))), rtol=1e-3, atol=1e-3)


def test_legacy_obstacles_match():
    """A circle's size is its diameter; rectangles by their full size."""
    pts = np.random.default_rng(6).uniform(-1.0, 4.0, (500, 2)).astype(
        np.float32)
    for args in (('circle', (2.0, 0.0), 1.0), ('rect', (0.0, 2.0),
                                                (2.0, 1.0))):
        t, j = tleg.Obstacle(*args), jleg.Obstacle(*args)
        np.testing.assert_array_equal(
            t.is_collision(torch.from_numpy(pts)).numpy(),
            np.asarray(j.is_collision(jnp.asarray(pts))))
        assert t.get_cost() == j.get_cost()
    circ = tleg.Obstacle('circle', (2.0, 0.0), 1.0)
    assert bool(circ.is_collision([2.4, 0.0])[0])
    assert not bool(circ.is_collision([2.75, 0.0])[0])
    f = tleg.FCLObstacle('rect', (1.0, 1.0), (0.5, 0.5), category=1)
    assert f.category == 1 and f.kind == 'rect'
    with pytest.raises(NotImplementedError):
        tleg.Obstacle('triangle', (0, 0), 1.0)


@pytest.mark.parametrize('label_type', ['binary', 'instance', 'class'])
def test_fcl_checker_matches(label_type):
    """FCLChecker on a 2-DOF planar arm: labels and signed distances of
    every label type (tests/test_legacy.py's obstacles and a third)."""
    def obstacles(m):
        return [m.FCLObstacle('circle', (1.5, 1.0), 0.6, category=0),
                m.FCLObstacle('rect', (-1.2, -1.0), (1.2, 1.2), category=1),
                ('circle', (0.0, -1.6), 0.4, 1)]
    tck = tleg.FCLChecker(obstacles(tleg),
                          robot=tdc.RevolutePlanarRobot(1.0, link_width=0.2,
                                                        dof=2),
                          label_type=label_type, num_class=2, device='cpu')
    jck = jleg.FCLChecker(obstacles(jleg),
                          robot=JPlanar(1.0, link_width=0.2, dof=2),
                          label_type=label_type, num_class=2)
    q = np.random.default_rng(7).uniform(-np.pi, np.pi, (400, 2)).astype(
        np.float32)
    tl, td = tck.predict(torch.from_numpy(q))
    jl, jd = jck.predict(jnp.asarray(q))
    assert tl.shape == jl.shape
    _close(td, jd)
    away = np.abs(td.numpy()) >= 1e-5
    np.testing.assert_array_equal(tl.numpy()[away], np.asarray(jl)[away])
    assert bool(((tl > 0) == (td > 0)).all())
    _close(tck.score(torch.from_numpy(q)), jck.score(jnp.asarray(q)))
    assert tck.predict(torch.from_numpy(q), distance=False).shape == tl.shape


def test_simple_1d_dynamic_checker_matches():
    """Simple1DDynamicObstacle and Simple1DDynamicChecker, with and without
    a robot; with one, its labels of the normalized test set are
    Dynamic1DChecker's of the raw one."""
    def obs(m, dm):
        return [m.Simple1DDynamicObstacle(1.2, dm.LinearMotion(0.5, 2.0)),
                m.Simple1DDynamicObstacle(1.0, dm.SineMotion(2.0, 0.8, 0.0,
                                                             7.0))]
    xt = _xt(2000, seed=8)
    for t, j in zip(obs(tleg, tdyn), obs(jleg, jdyn)):
        np.testing.assert_array_equal(
            t.is_collision(torch.from_numpy(xt)).numpy(),
            np.asarray(j.is_collision(jnp.asarray(xt))))
    tck = tleg.Simple1DDynamicChecker(obs(tleg, tdyn), device='cpu')
    jck = jleg.Simple1DDynamicChecker(obs(jleg, jdyn))
    tl, td = tck.predict(torch.from_numpy(xt))
    jl, jd = jck.predict(jnp.asarray(xt))
    _close(td, jd)
    away = np.abs(td.numpy()) >= 1e-5
    np.testing.assert_array_equal(tl.numpy()[away], np.asarray(jl)[away])
    robot = tdc.PointRobot1D(LIMITS)
    tck_r = tleg.Simple1DDynamicChecker(obs(tleg, tdyn), robot, device='cpu')
    jck_r = jleg.Simple1DDynamicChecker(obs(jleg, jdyn), JPointRobot1D(LIMITS))
    xn = robot.normalize(torch.from_numpy(xt))
    tln, tdn = tck_r.predict(xn)
    jln, _ = jck_r.predict(jnp.asarray(xn.numpy()))
    away = np.abs(tdn.numpy()) >= 1e-5
    np.testing.assert_array_equal(tln.numpy()[away], np.asarray(jln)[away])
    gt = tdyn.Dynamic1DChecker(_motions(tdyn), device='cpu')
    np.testing.assert_array_equal(tln.numpy()[:, 0][away[:, 0]],
                                  gt.predict(torch.from_numpy(xt)).numpy()[
                                      away[:, 0]])
