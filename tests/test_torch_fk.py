"""Port parity: DH forward kinematics and its analytic derivatives
(diffco_tpu_torch.robots against diffco_tpu.robots), plus the math
utilities it builds on."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import diffco_tpu.utils as jutils
from diffco_tpu.robots import analytic as janalytic
from diffco_tpu.robots.fk_jvp import make_dh_fkine as jmake_dh_fkine

import diffco_tpu_torch.utils as tutils
from diffco_tpu_torch.robots import analytic as tanalytic
from diffco_tpu_torch.robots.fk_jvp import make_dh_fkine as tmake_dh_fkine

torch.set_num_threads(1)

_BASE = np.array([[0.0, -1.0, 0.0, 0.1],
                  [1.0, 0.0, 0.0, -0.2],
                  [0.0, 0.0, 1.0, 0.3],
                  [0.0, 0.0, 0.0, 1.0]])


def _robots(name):
    """(jax robot, torch robot) pair."""
    if name == 'panda':
        return janalytic.PandaFK(), tanalytic.PandaFK()
    if name == 'baxter':
        return janalytic.BaxterLeftArmFK(), tanalytic.baxter_arm()
    # a based 7-joint DH chain with every frame a control point
    a, alpha = [0.1, 0, 0.2, 0, 0.05, 0, 0], [0.5, -1.2, 0.3, 1.0, -0.4, 0.9, 0]
    d, th = [0.3, 0.1, 0, 0.25, 0, 0.1, 0.05], [0.2, 0, 0, -0.3, 0, 0, 0.1]
    lims = [[-2.5, 2.5]] * 7
    return (janalytic.DHChainRobot(janalytic.DHParameters(a=a, alpha=alpha,
                                                          d=d, theta=th),
                                   lims, [True] * 7, base=_BASE),
            tanalytic.DHChainRobot(tanalytic.DHParameters(a=a, alpha=alpha,
                                                          d=d, theta=th),
                                   lims, [True] * 7, base=_BASE))


def _q(n, seed=0):
    lims = np.asarray(janalytic._PANDA_LIMITS, np.float32)
    u = np.random.default_rng(seed).uniform(size=(n, 7)).astype(np.float32)
    return u * (lims[:, 1] - lims[:, 0]) + lims[:, 0]


def _loss_j(p):
    return jnp.sum(jnp.sin(p) * jnp.cos(0.7 * p))


def _loss_t(p):
    return torch.sum(torch.sin(p) * torch.cos(0.7 * p))


@pytest.mark.parametrize('name', ['panda', 'baxter', 'based_chain'])
def test_fk_points_match(name):
    jr, tr = _robots(name)
    q = _q(64)
    ref = np.asarray(jr.fkine(jnp.asarray(q), flat=True))
    out = tr.fkine(torch.from_numpy(q), flat=True).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    # the non-flat layout and the plain-autograd oracle agree too
    np.testing.assert_allclose(tr.fkine(torch.from_numpy(q)).numpy(),
                               ref.reshape(64, -1, 3), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tr._fkine_soa_autodiff(torch.from_numpy(q), flat=True).numpy(),
        ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('name', ['panda', 'based_chain'])
def test_fk_backward_matches_jax_grad(name):
    jr, tr = _robots(name)
    q = _q(32, seed=1)
    g_ref = np.asarray(jax.grad(
        lambda qq: _loss_j(jr.fkine(qq, flat=True)))(jnp.asarray(q)))
    qt = torch.from_numpy(q).requires_grad_(True)
    g, = torch.autograd.grad(_loss_t(tr.fkine(qt, flat=True)), qt)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('name', ['panda', 'based_chain'])
def test_fk_jvp_matches_jax_jvp(name):
    jr, tr = _robots(name)
    q = _q(32, seed=2)
    v = np.random.default_rng(3).normal(size=q.shape).astype(np.float32)
    _, t_ref = jax.jvp(lambda qq: jr.fkine(qq, flat=True),
                       (jnp.asarray(q),), (jnp.asarray(v),))
    import torch.autograd.forward_ad as fwAD
    with fwAD.dual_level():
        qd = fwAD.make_dual(torch.from_numpy(q), torch.from_numpy(v))
        tangent = fwAD.unpack_dual(tr.fkine(qd, flat=True)).tangent
    np.testing.assert_allclose(tangent.numpy(), np.asarray(t_ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('name', ['panda', 'based_chain'])
def test_fk_gradcheck_float64(name):
    _, tr = _robots(name)
    q = torch.from_numpy(_q(4, seed=4).astype(np.float64)).requires_grad_()
    # analytic VJP and JVP against finite differences, and the VJP is
    # itself differentiable (twice-differentiable FK)
    assert torch.autograd.gradcheck(lambda x: tr.fkine(x, flat=True), (q,),
                                    check_forward_ad=True)
    assert torch.autograd.gradgradcheck(lambda x: tr.fkine(x, flat=True),
                                        (q,))
    assert torch.autograd.gradcheck(
        lambda x: tr._fkine_soa_autodiff(x, flat=True), (q,))


def test_fk_frame_order_assert():
    consts = [(0.1, 0.2, 0.0, 1.0, 0.0)] * 2
    with pytest.raises(AssertionError):
        tmake_dh_fkine(consts, [(2, (0.0, 0.0, 0.0)), (1, (0.0, 0.0, 0.0))])
    with pytest.raises(AssertionError):
        jmake_dh_fkine(consts, [(2, (0.0, 0.0, 0.0)), (1, (0.0, 0.0, 0.0))])


def test_utils_match():
    rng = np.random.default_rng(5)
    th = rng.uniform(-10, 10, size=(50,)).astype(np.float32)
    np.testing.assert_allclose(tutils.wrap2pi(torch.from_numpy(th)).numpy(),
                               np.asarray(jutils.wrap2pi(jnp.asarray(th))),
                               rtol=1e-6, atol=1e-5)
    q = rng.uniform(-3, 3, size=(6, 7)).astype(np.float32)
    p = tanalytic.PandaFK().dhparams
    ref = jutils.DH2mat(jnp.asarray(q), jnp.asarray(p.a.numpy()),
                        jnp.asarray(p.d.numpy()),
                        jnp.asarray(p.s_alpha.numpy()),
                        jnp.asarray(p.c_alpha.numpy()))
    out = tutils.DH2mat(torch.from_numpy(q), p.a, p.d, p.s_alpha, p.c_alpha)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    path = rng.normal(size=(5, 7)).astype(np.float32)
    ref = np.asarray(jutils.dense_path(jnp.asarray(path), 4))
    out = tutils.dense_path(torch.from_numpy(path), 4).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    # leading batch dimensions densify each path independently
    batched = tutils.dense_path(torch.from_numpy(np.stack([path, path])), 4)
    np.testing.assert_allclose(batched[1].numpy(), ref, rtol=1e-6, atol=1e-6)


def test_rand_configs_within_limits_and_device_independent():
    robot = tanalytic.PandaFK()
    q = robot.rand_configs(500, torch.Generator().manual_seed(0), 'cpu')
    q2 = robot.rand_configs(500, torch.Generator().manual_seed(0), 'cpu')
    assert q.shape == (500, 7) and torch.equal(q, q2)
    lims = robot.limits
    assert bool(((q >= lims[:, 0]) & (q <= lims[:, 1])).all())
