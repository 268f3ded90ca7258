"""The Baxter robots and the Adam-based trajectory optimizers against the
JAX package: the five Baxter / dual-arm robots' FK, a BaxterLeftArmFK
proxy fitted by the JAX package in the Baxter benchmarks' scene (table,
pole, ball; capsule-chain ground truth) and carried across with
load_reference_state, then the augmented Lagrangian, batched Adam and the
Weighted stepper on it, all on the same numpy inputs.

BaxterLeftArmFK's last joint moves none of its control points, so its
gradient is rounding noise, which Adam's normalisation turns into steps
of up to lr in either package. The paths are compared where the
optimization determines them: joints 1-6 and the control points."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import diffco_tpu as jdc
import diffco_tpu.robots as jrobots
from diffco_tpu import optim as joptim
from diffco_tpu.robots.capsule_chain import CapsuleChainCollision as JCap
import diffco_tpu_torch as tdc
from diffco_tpu_torch import optim as toptim
from diffco_tpu_torch.convert import load_reference_state

torch.set_num_threads(1)

ROBOTS = ('BaxterLeftArmFK', 'BaxterRightArmFK', 'BaxterFK',
          'BaxterDualArmFK', 'DualPandaFK')


def _T(t):
    m = np.eye(4)
    m[:3, 3] = t
    return m


# scripts/baxter_trajopt_benchmark.py's scene
SHAPES = {'table': {'type': 'Box', 'params': {'extents': [0.8, 0.8, 0.05]},
                    'transform': _T([0.7, 0.0, -0.1])},
          'pole': {'type': 'Cylinder', 'params': {'radius': 0.1,
                                                  'height': 1.2},
                   'transform': _T([0.6, 0.3, 0.5])},
          'ball': {'type': 'Sphere', 'params': {'radius': 0.15},
                   'transform': _T([0.4, -0.35, 0.3])}}


def _configs(limits, n, seed, spread=1.0):
    """n configurations uniform in the limits widened by ``spread``."""
    lims = np.asarray(limits, np.float64)
    mid, half = lims.mean(1), 0.5 * (lims[:, 1] - lims[:, 0]) * spread
    u = np.random.default_rng(seed).uniform(-1, 1, size=(n, len(lims)))
    return (mid + u * half).astype(np.float32)


@pytest.mark.parametrize('name', ROBOTS)
def test_robot_fkine_wrap_match(name):
    """fkine (1e-5) and wrap (exact) on configurations reaching 25 %
    past the joint limits; limits and dof equal."""
    jr, tr = getattr(jrobots, name)(), getattr(tdc, name)()
    q = _configs(jr.limits, 64, seed=len(name), spread=1.5)
    np.testing.assert_allclose(tr.fkine(torch.from_numpy(q)).numpy(),
                               np.asarray(jr.fkine(jnp.asarray(q))),
                               atol=1e-5)
    np.testing.assert_array_equal(tr.wrap(torch.from_numpy(q)).numpy(),
                                  np.asarray(jr.wrap(jnp.asarray(q))))
    np.testing.assert_array_equal(tr.limits.numpy(), np.asarray(jr.limits))
    assert tr.dof == jr.dof


def _reference_state(checker):
    p = checker.perceptron
    out = {k: np.asarray(getattr(p, k)) for k in (
        'support_points', 'support_transformed', 'gains', 'hypothesis', 'y',
        'kernel_matrix', 'rbf_nodes', 'valid_mask', 'num_valid')}
    out['epsilon'] = np.asarray(p.rbf_kernel.epsilon)
    out['safety_bias'] = np.asarray(checker.safety_bias)
    return out


@pytest.fixture(scope='module')
def fitted():
    """A JAX BaxterLeftArmFK proxy fitted on 400 numpy configurations; a
    port checker holding its state; free start/target pairs whose
    straight line collides."""
    jrobot = jrobots.BaxterLeftArmFK()
    jenv = jdc.ShapeEnv(shapes=SHAPES)
    jgt = JCap(jrobot, link_radius=0.07, per_seg=4).checker_fn(jenv)
    q = _configs(jrobot.limits, 400, seed=1)
    labels = np.asarray(jgt(jnp.asarray(q)))
    jck = jdc.ForwardKinematicsDiffCo(robot=jrobot, gt_check_func=jgt)
    jck.fit(q=q, labels=labels.astype(np.float32))
    trobot = tdc.BaxterLeftArmFK()
    tck = tdc.ForwardKinematicsDiffCo(robot=trobot,
                                      gt_check_func=lambda qq: None,
                                      device='cpu')
    load_reference_state(tck, _reference_state(jck))
    free = q[~labels]
    pairs = []
    for i in range(0, len(free) - 1, 2):
        line = np.linspace(free[i], free[i + 1], 40).astype(np.float32)
        if np.asarray(jgt(jnp.asarray(line))).any():
            pairs.append((free[i], free[i + 1]))
    assert len(pairs) >= 3
    return dict(jrobot=jrobot, trobot=trobot, jck=jck, tck=tck,
                pairs=pairs[:3], margin=-float(jck.safety_bias))


def _scores(fitted):
    return fitted['jck'].score_fn(0.0), fitted['tck'].score_fn(0.0)


@pytest.mark.parametrize('B', [256, 4096])
def test_baxter_collision_score_matches(fitted, B):
    """The fitted proxy's sweep (B = 4096: at the DH kernel's gate, the
    plain twin of B1's FP = 16 instance on the CPU) and the optimizers'
    score_fn, 1e-4."""
    q = _configs(fitted['jrobot'].limits, B, seed=B)
    ref = np.asarray(fitted['jck'].collision_score(jnp.asarray(q)))
    out = fitted['tck'].collision_score(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    jfn, tfn = _scores(fitted)
    np.testing.assert_allclose(tfn(torch.from_numpy(q)).numpy(),
                               np.asarray(jfn(jnp.asarray(q))),
                               rtol=1e-4, atol=1e-4)


def _assert_paths_close(robot, out, ref, atol):
    """Joints 1-6 and the control points of two paths within atol."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(out[..., :6], ref[..., :6], atol=atol)
    np.testing.assert_allclose(
        robot.fkine(torch.from_numpy(out.reshape(-1, 7))).numpy(),
        robot.fkine(torch.from_numpy(ref.reshape(-1, 7))).numpy(),
        atol=atol)


def _jittered_line(start, target, n, seed):
    return (np.linspace(start, target, n) + np.random.default_rng(
        seed).normal(scale=0.05, size=(n, len(start)))).astype(np.float32)


def test_al_matches(fitted):
    """One restart from a jittered init, outer 3 x inner 5 AL steps and 20
    restoration steps: solution 1e-3 (_assert_paths_close), cost rtol
    1e-3, success, cnt_check equal, max_violation 1e-4."""
    jfn, tfn = _scores(fitted)
    start, target = fitted['pairs'][0]
    opts = {'N_WAYPOINTS': 12, 'NUM_RE_TRIALS': 1, 'outer_iters': 3,
            'inner_iters': 5, 'restore_iters': 20, 'num_sub': 3,
            'safety_margin': fitted['margin'], 'seed': 0,
            'init_solution': _jittered_line(start, target, 12, seed=2)}
    ref = joptim.al_traj_optimize(fitted['jrobot'], jfn, start, target, opts)
    out = toptim.al_traj_optimize(fitted['trobot'], tfn,
                                  torch.from_numpy(start),
                                  torch.from_numpy(target), opts)
    _assert_paths_close(fitted['trobot'], out['solution'], ref['solution'],
                        1e-3)
    np.testing.assert_allclose(out['cost'], ref['cost'], rtol=1e-3)
    np.testing.assert_allclose(out['max_violation'], ref['max_violation'],
                               atol=1e-4)
    assert out['success'] == ref['success']
    assert out['cnt_check'] == ref['cnt_check']


BATCH_OPTS = {'N_WAYPOINTS': 10, 'NUM_RE_TRIALS': 3, 'MAXITER': 12,
              'dense_sub': 3, 'max_speed': 2.0, 'seed': 5}


def test_batch_equals_single_calls(fitted):
    """P = 3 problems x 3 restarts in one batch equal 3 adam_traj_optimize
    calls with seeds seed + i, exactly (CPU)."""
    _, tfn = _scores(fitted)
    starts = np.stack([s for s, _ in fitted['pairs']])
    targets = np.stack([t for _, t in fitted['pairs']])
    opts = dict(BATCH_OPTS, safety_margin=fitted['margin'])
    recs = toptim.adam_traj_optimize_batch(
        fitted['trobot'], tfn, torch.from_numpy(starts),
        torch.from_numpy(targets), opts)
    for i, rec in enumerate(recs):
        single = toptim.adam_traj_optimize(
            fitted['trobot'], tfn, torch.from_numpy(starts[i]),
            torch.from_numpy(targets[i]), dict(opts, seed=opts['seed'] + i))
        assert rec['seed'] == single['seed']
        for k in ('solution', 'cost', 'success', 'cnt_check'):
            assert rec[k] == single[k], k


def test_batch_matches_jax(fitted):
    """The batch with one restart per problem, warm-started from
    init_solutions: solutions 1e-3 (_assert_paths_close), costs rtol
    1e-3, success and cnt_check equal."""
    jfn, tfn = _scores(fitted)
    starts = np.stack([s for s, _ in fitted['pairs']])
    targets = np.stack([t for _, t in fitted['pairs']])
    inits = np.stack([_jittered_line(s, t, 10, seed=i) for i, (s, t)
                      in enumerate(fitted['pairs'])])
    opts = dict(BATCH_OPTS, NUM_RE_TRIALS=1, init_solutions=inits,
                safety_margin=fitted['margin'])
    ref = joptim.adam_traj_optimize_batch(fitted['jrobot'], jfn, starts,
                                          targets, opts)
    out = toptim.adam_traj_optimize_batch(
        fitted['trobot'], tfn, torch.from_numpy(starts),
        torch.from_numpy(targets), opts)
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        _assert_paths_close(fitted['trobot'], o['solution'], r['solution'],
                            1e-3)
        np.testing.assert_allclose(o['cost'], r['cost'], rtol=1e-3)
        assert o['success'] == r['success']
        assert o['cnt_check'] == r['cnt_check']


def test_weighted_step_matches(fitted):
    """Weighted.step on the proxy's perceptron, 20 steps from a jittered
    line: path 1e-4 (_assert_paths_close)."""
    opts = {'n_waypoints': 10, 'maxiter': 20, 'max_move_weight': 10.0,
            'collision_weight': 10.0, 'joint_limit_weight': 10.0,
            'safety_bias': 0.0, 'max_speed': 1.5, 'dense_check': True,
            'num_sub': 3, 'optimizer_params': {'lr': 0.05}}
    start, target = fitted['pairs'][2]
    p0 = _jittered_line(start, target, 10, seed=7)
    ref = joptim.Weighted(fitted['jrobot'], fitted['jck'].perceptron,
                          opts).step(jnp.asarray(p0))
    out = toptim.Weighted(fitted['trobot'], fitted['tck'].perceptron,
                          opts).step(torch.from_numpy(p0))
    _assert_paths_close(fitted['trobot'], out.x.numpy(), ref.x, 1e-4)


def test_score_fn_follows_input(fitted):
    """score_fn on a CPU float64 batch returns float64 scores within 1e-5
    of the float32 ones (the state converted once and kept); a refit
    state is picked up."""
    tck = fitted['tck']
    fn = tck.score_fn(0.0)
    q = torch.from_numpy(_configs(fitted['jrobot'].limits, 64, seed=3))
    s32, s64 = fn(q), fn(q.double())
    assert s32.dtype == torch.float32 and s64.dtype == torch.float64
    np.testing.assert_allclose(s64.numpy(), s32.numpy(), atol=1e-5)
    assert fn.follows_input
    p = tck.perceptron
    nodes = p.rbf_nodes
    try:
        p.rbf_nodes = 2 * nodes
        np.testing.assert_allclose(fn(q.double()).numpy(), 2 * s64.numpy(),
                                   rtol=1e-12, atol=1e-12)
    finally:
        p.rbf_nodes = nodes
