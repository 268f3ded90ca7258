"""The rest of the trajectory optimizers against the JAX package, on the
same numpy inputs: the constraint helpers, the augmented Lagrangian's
restoration epilogue (a point robot and a disk), and scipy's SLSQP,
trust-constr and gradient-free paths on PandaFK with an analytic obstacle
score, both packages evaluating in float64 on the CPU; then the scipy
paths' route when a closure cannot run in float64."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from diffco_tpu import optim as joptim
from diffco_tpu import utils as jutils
from diffco_tpu.robots import PandaFK as JPanda
from diffco_tpu_torch import optim as toptim
from diffco_tpu_torch import utils as tutils
from diffco_tpu_torch.robots import PandaFK as TPanda

torch.set_num_threads(1)

# (n_segments, num_sub, score shape): flat, multi-output [M, C]
SEGMENT_CASES = [(4, 3, (11,)), (5, 1, (4,)), (3, 4, (11, 3))]


@pytest.mark.parametrize('fn', ['segment_violations', 'segment_max_scores',
                                'dense_path_params'])
@pytest.mark.parametrize('case', range(len(SEGMENT_CASES)))
def test_segment_helpers_match(fn, case):
    """Each helper on both packages' arrays (1e-6): the torch branch, the
    numpy branch, and the torch branch over a leading batch of 2 against
    each row alone."""
    n_seg, num_sub, shape = SEGMENT_CASES[case]
    rng = np.random.default_rng(case)
    s = rng.normal(size=shape).astype(np.float32)
    if fn == 'dense_path_params':
        q = rng.normal(size=(n_seg + 1, 7)).astype(np.float32)
        for kw in ({}, {'max_dense_waypoints': 5 * case + 3}):
            assert tutils.dense_path_params(torch.from_numpy(q), 0.3, **kw) \
                == jutils.dense_path_params(q, 0.3, **kw)
        return
    args = (n_seg, num_sub) + ((0.2,) if fn == 'segment_violations' else ())
    ref = np.asarray(getattr(jutils, fn)(jnp.asarray(s), *args))
    out = getattr(tutils, fn)(torch.from_numpy(s), *args).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    out_np = getattr(tutils, fn)(s, *args, xp=np)
    np.testing.assert_allclose(out_np, ref, atol=1e-6)
    s2 = np.stack([s, rng.normal(size=shape).astype(np.float32)])
    batched = getattr(tutils, fn)(torch.from_numpy(s2), *args,
                                  batch_dims=1).numpy()
    for row, s_row in zip(batched, s2):
        np.testing.assert_allclose(
            row, np.asarray(getattr(jutils, fn)(jnp.asarray(s_row), *args)),
            atol=1e-6)


class _JPointRobot:
    limits = jnp.asarray([[-4.0, 4.0]] * 2, jnp.float32)

    @staticmethod
    def fkine(p):
        return p


class _TPointRobot:
    limits = torch.tensor([[-4.0, 4.0]] * 2)

    @staticmethod
    def fkine(p):
        return p


def test_al_restoration_matches():
    """tests/test_optim_more.py's restoration case in both packages: a
    starved AL budget leaves the path infeasible (max violation > 1e-4),
    200 restoration steps take it within 1e-4; solutions 1e-3, max
    violations rtol 1e-3, success and cnt_check equal. The init is the
    straight line jittered: on the exact line through the disk's centre
    the objective's gradient is rounding noise, which Adam turns into
    steps of lr in either direction."""
    s, t = np.array([-2.0, -2.0], np.float32), np.array([2.0, 2.0],
                                                        np.float32)
    init = (np.linspace(s, t, 12) + np.random.default_rng(1).normal(
        scale=0.1, size=(12, 2))).astype(np.float32)
    base = {'N_WAYPOINTS': 12, 'NUM_RE_TRIALS': 1, 'MAXITER': 100,
            'safety_margin': -0.05, 'seed': 3, 'outer_iters': 2,
            'inner_iters': 5, 'init_solution': init}
    for restore, feasible in ((0, False), (200, True)):
        opts = dict(base, restore_iters=restore)
        ref = joptim.al_traj_optimize(
            _JPointRobot, lambda q: 1.0 - jnp.linalg.norm(q, axis=-1),
            jnp.asarray(s), jnp.asarray(t), opts)
        out = toptim.al_traj_optimize(
            _TPointRobot, lambda q: 1.0 - torch.linalg.norm(q, dim=-1),
            torch.from_numpy(s), torch.from_numpy(t), opts)
        assert out['success'] == ref['success'] == feasible
        assert (out['max_violation'] <= 1e-4) == feasible
        np.testing.assert_allclose(out['max_violation'],
                                   ref['max_violation'], rtol=1e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(out['solution']),
                                   np.asarray(ref['solution']), atol=1e-3)
        assert out['cnt_check'] == ref['cnt_check']
    sol = np.asarray(out['solution'])
    assert (1.0 - np.linalg.norm(sol, axis=-1) <= -0.05 + 1e-4).all()


# two spheres (centre, radius) in PandaFK's workspace
SPHERES = np.array([[0.45, 0.1, 0.45, 0.15], [0.3, -0.35, 0.6, 0.12]])
JROBOT, TROBOT = JPanda(), TPanda()


def _jdist(q):
    p = JROBOT.fkine(q)
    c = jnp.asarray(SPHERES, p.dtype)
    d = c[:, 3] - jnp.linalg.norm(p[:, :, None] - c[:, :3], axis=-1)
    return jnp.max(d, axis=(1, 2))


def _tdist(q):
    p = TROBOT.fkine(q)
    c = torch.as_tensor(SPHERES, dtype=p.dtype)
    d = c[:, 3] - torch.linalg.norm(p[:, :, None] - c[:, :3], dim=-1)
    return d.amax(dim=(1, 2))


START = np.array([-0.9, 0.3, 0.2, -1.6, 0.1, 1.6, 0.4], np.float32)
TARGET = np.array([0.9, 0.4, -0.2, -1.4, -0.1, 1.8, -0.4], np.float32)
SCIPY_OPTS = {'N_WAYPOINTS': 5, 'NUM_RE_TRIALS': 2, 'MAXITER': 15,
              'num_sub': 3, 'max_speed': 2.0, 'safety_margin': -0.02,
              'seed': 4}


@pytest.mark.parametrize('method,extra', [
    ('givengrad', {}),
    ('trustconstr', {}),
    ('trustconstr', {'constraint_hess': 'bfgs', 'constraint_form': 'clamp'}),
    ('trustconstr', {'free_waypoints': 4, 'N_WAYPOINTS': 6,
                     'constraint_hess': 'bfgs'}),
    ('gradient_free', {'MAXITER': 8}),
])
def test_scipy_paths_match(method, extra):
    """SLSQP, trust-constr (analytic Hessian; BFGS with the clamped form;
    BFGS on 4 free waypoints of 6) and gradient-free trust-constr (on the
    thresholded score), both packages in float64 on the CPU: solution
    1e-5, cost rtol 1e-6, success, feasible and cnt_check equal; the
    record names its route."""
    opts = dict(SCIPY_OPTS, **extra)
    jd, td = _jdist, _tdist
    if method == 'gradient_free':
        def jd(q):
            return (_jdist(q) > 0).astype(q.dtype)

        def td(q):
            return (_tdist(q) > 0).to(q.dtype)
    name = f'{method}_traj_optimize'
    ref = getattr(joptim, name)(JROBOT, jd, jnp.asarray(START),
                                jnp.asarray(TARGET), opts)
    out = getattr(toptim, name)(TROBOT, td, torch.from_numpy(START),
                                torch.from_numpy(TARGET), opts)
    np.testing.assert_allclose(np.asarray(out['solution']),
                               np.asarray(ref['solution']), atol=1e-5)
    np.testing.assert_allclose(out['cost'], ref['cost'], rtol=1e-6,
                               atol=1e-9)
    for k in ('success', 'feasible', 'cnt_check'):
        assert out[k] == ref[k], k
    assert (out['eval_device'], out['eval_dtype']) == ('cpu', 'float64')


def test_scipy_float32_route():
    """A closure that cannot run in float64 is evaluated in float32 on
    start_cfg's device, with a warning naming the route; when it fails
    there too, that error propagates. scipy_fp64=False takes float32
    directly."""
    def f32_only(q):
        if q.dtype != torch.float32:
            raise TypeError('float32 only')
        return _tdist(q)

    opts = dict(SCIPY_OPTS, NUM_RE_TRIALS=1, MAXITER=3)
    args = (TROBOT, f32_only, torch.from_numpy(START),
            torch.from_numpy(TARGET))
    with pytest.warns(RuntimeWarning, match='float32 on cpu'):
        rec = toptim.givengrad_traj_optimize(*args, opts)
    assert (rec['eval_device'], rec['eval_dtype']) == ('cpu', 'float32')
    rec = toptim.givengrad_traj_optimize(*args, dict(opts, scipy_fp64=False))
    assert rec['eval_dtype'] == 'float32'

    def broken(q):
        raise ValueError('no score here')

    with pytest.warns(RuntimeWarning), pytest.raises(ValueError,
                                                     match='no score here'):
        toptim.trustconstr_traj_optimize(TROBOT, broken, *args[2:], opts)
