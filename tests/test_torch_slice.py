"""The port's main path as a whole against the JAX package: a PandaFK
ForwardKinematicsDiffCo fitted by the JAX package, its state carried
across with load_reference_state, then the sweeps, the safety bias,
verification and Adam trajectory optimization compared on the same numpy
inputs; and a cold-start fit of the port on the same data."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import diffco_tpu as jdc
from diffco_tpu import optim as joptim
from diffco_tpu.robots import PandaFK as JPanda
from diffco_tpu.robots.capsule_chain import CapsuleChainCollision as JCap
import diffco_tpu_torch as tdc
from diffco_tpu_torch import optim as toptim
from diffco_tpu_torch.convert import load_reference_state
from diffco_tpu_torch.ops import fk_score as tfk
from diffco_tpu_torch.robots.capsule_chain import CapsuleChainCollision as TCap

torch.set_num_threads(1)

LINK_RADIUS = 0.15


def _T(t):
    m = np.eye(4)
    m[:3, 3] = t
    return m


SHAPES = {'box1': {'type': 'Box', 'params': {'extents': [0.1, 0.1, 0.1]},
                   'transform': _T([0.5, 0.5, 0.5])},
          'sphere1': {'type': 'Sphere', 'params': {'radius': 0.1},
                      'transform': _T([0.5, 0, 0])}}


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


def _q(n, seed):
    lims = np.asarray(JPanda().limits)
    u = np.random.default_rng(seed).uniform(size=(n, 7)).astype(np.float32)
    return u * (lims[:, 1] - lims[:, 0]) + lims[:, 0]


@pytest.fixture(scope='module')
def fitted():
    """JAX checker fitted on 400 numpy configurations; a port checker
    holding the same state; the JAX ground truth for labels."""
    jenv = jdc.ShapeEnv(shapes=SHAPES)
    jgt = JCap(JPanda(), link_radius=LINK_RADIUS)
    q = _q(400, seed=11)
    labels = np.asarray(jgt.signed_dist(jnp.asarray(q), jenv)) > 0
    jck = jdc.ForwardKinematicsDiffCo(
        robot=JPanda(), environment=jenv,
        gt_check_func=jgt.checker_fn(jenv))
    jck.fit(q=q, labels=labels.astype(np.float32))
    tenv = tdc.ShapeEnv(SHAPES)
    tgt = TCap(tdc.PandaFK(), link_radius=LINK_RADIUS)
    tck = tdc.ForwardKinematicsDiffCo(
        robot=tdc.PandaFK(), environment=tenv,
        gt_check_func=tgt.checker_fn(tenv), device='cpu')
    load_reference_state(tck, reference_state(jck))
    q_v = _q(4096, seed=12)
    lab_v = np.asarray(jgt.signed_dist(jnp.asarray(q_v), jenv)) > 0
    return dict(jck=jck, tck=tck, q=q, labels=labels, q_v=q_v,
                lab_v=(2.0 * lab_v - 1.0).astype(np.float32))


@pytest.mark.parametrize('B', [256, 4096])
def test_collision_score_matches(fitted, B):
    """B = 256 takes FK + the plain score route, B = 4096 the one-pass DH
    route (the plain twin of kernel B1 on the CPU)."""
    q = fitted['q_v'][:B]
    ref = np.asarray(fitted['jck'].collision_score(jnp.asarray(q)))
    out = fitted['tck'].collision_score(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    # the link-position entry point (point-space route)
    pts = np.asarray(JPanda().fkine(jnp.asarray(q)))
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


def test_score_fn_matches(fitted):
    """The optimizers' score function (a plain kernel matvec, no kernel
    route) agrees with the JAX package's, with and without a bias."""
    q = fitted['q_v'][:300]
    for bias in (None, 0.0):
        ref = np.asarray(fitted['jck'].score_fn(bias)(jnp.asarray(q)))
        out = fitted['tck'].score_fn(bias)(torch.from_numpy(q)).numpy()
        assert out.shape == ref.shape == (300,)
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('n_init', [2, 7, 20, 31])
def test_resample_init_matches(n_init):
    init = np.random.default_rng(n_init).normal(size=(n_init, 7))
    np.testing.assert_array_equal(toptim._resample_init(init, 20),
                                  np.asarray(joptim._resample_init(init, 20)))


def test_adam_trajopt_matches(fitted):
    jck, tck = fitted['jck'], fitted['tck']
    q = fitted['q']
    free = q[~fitted['labels']]
    start, target = free[0], free[1]
    init = np.linspace(start, target, 20) + np.random.default_rng(3).normal(
        scale=0.05, size=(20, 7)).astype(np.float32)
    opts = {'N_WAYPOINTS': 20, 'NUM_RE_TRIALS': 1, 'MAXITER': 20,
            'safety_margin': -0.1, 'max_speed': 2.0, 'seed': 0,
            'dense_sub': 4, 'init_solution': init}
    ref = joptim.adam_traj_optimize(
        JPanda(), lambda p: jck.collision_score(p, bias=0).reshape(-1),
        start, target, opts)
    out = toptim.adam_traj_optimize(
        tdc.PandaFK(), lambda p: tck.collision_score(p, bias=0).reshape(-1),
        torch.from_numpy(start), torch.from_numpy(target), opts)
    np.testing.assert_allclose(np.asarray(out['solution']),
                               np.asarray(ref['solution']), atol=1e-3)
    np.testing.assert_allclose(out['cost'], ref['cost'], rtol=1e-3)
    assert out['success'] == ref['success']
    assert out['cnt_check'] == ref['cnt_check']


def test_adam_core_history_matches(fitted):
    """Step-by-step paths of the optimizer core (history) agree."""
    jck, tck = fitted['jck'], fitted['tck']
    free = fitted['q'][~fitted['labels']]
    start, target = free[2], free[3]
    lims = np.asarray(JPanda().limits)
    init = np.linspace(start, target, 12).astype(np.float32)
    import jax
    _, _, _, _, jh = joptim._adam_traj_core(
        jnp.asarray(start), jnp.asarray(target), jnp.asarray(lims),
        jnp.asarray(init), jax.random.PRNGKey(0), JPanda().fkine,
        lambda p: jck.collision_score(p, bias=0).reshape(-1), 12, 1, 10,
        0.5, jnp.asarray(-0.1, jnp.float32), 2.0, history=True, dense_sub=3)
    _, _, _, _, th = toptim._adam_traj_core(
        torch.from_numpy(start), torch.from_numpy(target),
        torch.from_numpy(lims), torch.from_numpy(init),
        torch.Generator().manual_seed(0), tdc.PandaFK().fkine,
        lambda p: tck.collision_score(p, bias=0).reshape(-1), 12, 1, 10,
        0.5, -0.1, 2.0, history=True, dense_sub=3)
    assert th.shape == jh.shape == (1, 10, 12, 7)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-3)


def test_cold_fit_tpr_close(fitted):
    """Both packages fit from scratch on the same 400 configurations (no
    held-out split), take their safety bias from the same held-out
    configurations, and reach TPRs within 0.05 on a common held-out set."""
    jck = jdc.ForwardKinematicsDiffCo(robot=JPanda(),
                                      gt_check_func=lambda q: None)
    tck = tdc.ForwardKinematicsDiffCo(robot=tdc.PandaFK(),
                                      gt_check_func=lambda q: None,
                                      device='cpu')
    labels = fitted['labels'].astype(np.float32)
    jck.fit(q=fitted['q'], labels=labels, verify_ratio=0)
    tck.fit(q=fitted['q'], labels=labels, verify_ratio=0)
    assert tck.perceptron.train_iterations == jck.perceptron.train_iterations
    q_b, q_v, lab = fitted['q_v'][:1000], fitted['q_v'][1000:], \
        fitted['lab_v'][1000:]
    jck.safety_bias = jck._calculate_safety_bias(jnp.asarray(q_b))
    tck.safety_bias = tck._calculate_safety_bias(torch.from_numpy(q_b))
    _, tpr_ref, _ = jck.verify(jnp.asarray(q_v), jnp.asarray(lab))
    _, tpr, _ = tck.verify(torch.from_numpy(q_v), torch.from_numpy(lab))
    assert abs(tpr - tpr_ref) <= 0.05


def test_device_defaults_to_cuda():
    """No device and no card: the entry point raises instead of running on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdc.ForwardKinematicsDiffCo(robot=tdc.PandaFK(),
                                    environment=tdc.ShapeEnv(SHAPES))
    assert tfk._FK_FUSED_MIN_BATCH == 4096


@pytest.mark.parametrize('caller_setting', [False, True])
def test_fp32_matmul_is_scoped(caller_setting):
    """TF32 is off inside the Gram/solve/score_fn block and the caller's
    setting comes back after it, even when the block raises."""
    from diffco_tpu_torch.device import fp32_matmul
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = caller_setting
    try:
        with pytest.raises(ValueError):
            with fp32_matmul():
                assert torch.backends.cuda.matmul.allow_tf32 is False
                raise ValueError
        assert torch.backends.cuda.matmul.allow_tf32 is caller_setting
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
