"""Port parity: DH FK + score + configuration gradient (kernel B1's plain
twin, the one-pass autograd Function and fk_polyharmonic_score_auto)
against the JAX package's Pallas kernel (Pallas interpreter, fp32 inputs)
and its FK + fp32 XLA route."""
import ctypes

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffco_tpu.ops import fk_score as jfk
from diffco_tpu.ops.fused_score import _poly_score_xla
from diffco_tpu.robots import PandaFK as JPanda
from diffco_tpu_torch import profiling
from diffco_tpu_torch.ops import _native
from diffco_tpu_torch.ops import fk_score as tfk
from diffco_tpu_torch.robots import PandaFK as TPanda

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv('DIFFCO_PALLAS_INTERPRET', '1')


def _inputs(B=192, S=64, seed=0):
    """Supports are FK points of random configurations, as in a fit."""
    robot = TPanda()
    lims = robot.limits.numpy()
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(S + B, 7)).astype(np.float32)
    qs = u * (lims[:, 1] - lims[:, 0]) + lims[:, 0]
    sup = robot.fkine(torch.from_numpy(qs[:S]), flat=True).numpy()
    w = (rng.normal(size=(S,)) * 0.05).astype(np.float32)
    return qs[S:], sup, w


def _xla_ref(q, sup, w):
    jr = JPanda()
    f = lambda qq: _poly_score_xla(jr.fkine(qq, flat=True), jnp.asarray(sup),
                                   jnp.asarray(w))
    score = np.asarray(f(jnp.asarray(q))).reshape(-1)
    dq = np.asarray(jax.grad(lambda qq: f(qq).sum())(jnp.asarray(q)))
    return score, dq


def test_plain_twin_matches_pallas_and_xla():
    q, sup, w = _inputs()
    spec = tfk.robot_spec(TPanda())
    assert spec == jfk.robot_spec(JPanda())
    score, dq = tfk._dh_score_grad_plain(
        *map(torch.from_numpy, (q, sup, w)), spec)
    p_score, p_dq = jfk._dh_score_grad_pallas(
        jnp.asarray(q), jnp.asarray(sup), jnp.asarray(w), spec,
        use_bf16=False)
    np.testing.assert_allclose(score.numpy(), np.asarray(p_score),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dq.numpy(), np.asarray(p_dq), rtol=1e-3,
                               atol=1e-3)
    ref, ref_dq = _xla_ref(q, sup, w)
    np.testing.assert_allclose(score.numpy(), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dq.numpy(), ref_dq, rtol=1e-3, atol=1e-3)


def test_robot_spec_rejects_decreasing_frames():
    robot = TPanda()
    robot._point_specs = robot._point_specs[::-1]
    with pytest.raises(ValueError, match='non-decreasing'):
        tfk.robot_spec(robot)


@pytest.mark.parametrize('B', [32, 4096])
def test_auto_router_matches_jax(B):
    """On the CPU both batches take FK + polyharmonic_score, as the JAX
    router takes its XLA route off the TPU: values, query gradients, the
    support and weight cotangents and the forward-mode derivative match
    the JAX package's, at the gate as below it."""
    q, sup, w = _inputs(B=B, S=48, seed=B)
    mask = np.arange(48) < 40
    qt = torch.from_numpy(q).requires_grad_(True)
    st = torch.from_numpy(sup).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    assert not tfk.dh_score_grad_available(TPanda(), qt)
    out = tfk.fk_polyharmonic_score_auto(
        qt, TPanda(), st, wt, torch.from_numpy(mask), epsilon=1.5)
    g, gs, gw = torch.autograd.grad(out.sum(), (qt, st, wt))

    def jf(qq, ss, ww):
        return jfk.fk_polyharmonic_score_auto(
            qq, JPanda(), ss, ww, jnp.asarray(mask), epsilon=1.5)
    jargs = tuple(map(jnp.asarray, (q, sup, w)))
    ref = np.asarray(jf(*jargs))
    ref_g, ref_gs, ref_gw = jax.grad(lambda *a: jf(*a).sum(),
                                     argnums=(0, 1, 2))(*jargs)
    assert out.shape == (B, 1)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=1e-3,
                               atol=1e-3)
    for got, want in ((gs, ref_gs), (gw, ref_gw)):
        assert bool(got.any())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                                   atol=1e-3 * float(np.abs(want).max()))
    v = np.random.default_rng(B + 1).normal(size=q.shape).astype(np.float32)
    import torch.autograd.forward_ad as fwAD
    with fwAD.dual_level():
        qd = fwAD.make_dual(torch.from_numpy(q), torch.from_numpy(v))
        tan = fwAD.unpack_dual(tfk.fk_polyharmonic_score_auto(
            qd, TPanda(), torch.from_numpy(sup), torch.from_numpy(w),
            torch.from_numpy(mask), epsilon=1.5)).tangent
    ref_tan = jax.jvp(lambda qq: jf(qq, *jargs[1:]), (jargs[0],),
                      (jnp.asarray(v),))[1]
    np.testing.assert_allclose(tan.numpy(), np.asarray(ref_tan), rtol=1e-3,
                               atol=1e-3)


def test_dh_function_jvp_raises():
    q, sup, w = _inputs(B=8, S=16)
    spec = tfk.robot_spec(TPanda())
    import torch.autograd.forward_ad as fwAD
    with pytest.raises(RuntimeError, match='forward-mode'):
        with fwAD.dual_level():
            qd = fwAD.make_dual(torch.from_numpy(q), torch.ones(8, 7))
            tfk.dh_polyharmonic_score(qd, torch.from_numpy(sup),
                                      torch.from_numpy(w), spec)


def test_dh_function_gives_state_zero_cotangents():
    """The one-pass Function itself (the route of a float32 CUDA batch at
    the gate) treats supports and weights as constants, and its q
    gradient is the twin's dq."""
    q, sup, w = _inputs(B=8, S=16, seed=4)
    spec = tfk.robot_spec(TPanda())
    qt, st, wt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, sup, w))
    out = tfk.dh_polyharmonic_score(qt, st, wt, spec)
    g, gs, gw = torch.autograd.grad(out.sum(), (qt, st, wt))
    assert not gs.any() and not gw.any()
    _, dq = tfk._dh_score_grad_plain(*map(torch.from_numpy, (q, sup, w)),
                                     spec)
    assert torch.equal(g, dq)


def test_kernel_spec_struct():
    """The ctypes DHSpec mirrors csrc/dh_chain.cuh (472 bytes) and packs
    PandaFK's constants: 7 joints, 7 points (5 frames + 2 fingers)."""
    assert ctypes.sizeof(_native.DHSpec) == 472
    c = tfk._c_spec(tfk.robot_spec(TPanda()))
    assert (c.J, c.P) == (7, 7)
    assert list(c.frame)[:7] == [1, 3, 4, 5, 7, 7, 7]
    np.testing.assert_allclose(list(c.off[5]), [0.0, 0.107, 0.0], rtol=1e-6)
    np.testing.assert_allclose(list(c.base_r), np.eye(3).reshape(-1))
    consts = np.array([list(row) for row in c.dh][:7])
    np.testing.assert_allclose(consts, np.array(TPanda()._dh_const),
                               rtol=1e-6)


def test_wrapper_uses_plain_twin_on_cpu_without_counting():
    q, sup, w = _inputs(B=16, S=16, seed=3)
    spec = tfk.robot_spec(TPanda())
    before = profiling.counter('launches.dh_score_grad')
    score, dq = tfk.dh_score_grad(*map(torch.from_numpy, (q, sup, w)), spec)
    ref = tfk._dh_score_grad_plain(*map(torch.from_numpy, (q, sup, w)), spec)
    assert torch.equal(score, ref[0]) and torch.equal(dq, ref[1])
    assert profiling.counter('launches.dh_score_grad') == before
