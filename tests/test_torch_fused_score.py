"""Port parity: the point-space score + gradient (kernel B2's plain twin
and the polyharmonic_score router) against the JAX package's Pallas kernel
(run by the Pallas interpreter, fp32 inputs) and its fp32 XLA route."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffco_tpu.ops import fused_score as jfs
from diffco_tpu_torch import profiling
from diffco_tpu_torch.ops import fused_score as tfs

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv('DIFFCO_PALLAS_INTERPRET', '1')


def _inputs(B=192, S=64, F=21, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, F)).astype(np.float32) * 0.5
    s = rng.normal(size=(S, F)).astype(np.float32) * 0.5
    w = (rng.normal(size=(S,)) * 0.05).astype(np.float32)
    return x, s, w


# 72 and 102: the widths B2's wide instance serves (three Panda arms, the
# 35-link rope), which the Pallas kernel pads to its f_pad
@pytest.mark.parametrize('F', [21, 8, 5, 72, 102])
def test_plain_twin_matches_pallas_and_xla(F):
    x, s, w = _inputs(F=F)
    score, dx = tfs._poly_score_grad_plain(*map(torch.from_numpy, (x, s, w)))
    p_score, p_dx = jfs._poly_score_grad_pallas(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(w), use_bf16=False)
    np.testing.assert_allclose(score.numpy(), np.asarray(p_score),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dx.numpy(), np.asarray(p_dx),
                               rtol=1e-3, atol=1e-3)
    ref = np.asarray(jfs._poly_score_xla(jnp.asarray(x), jnp.asarray(s),
                                         jnp.asarray(w))).reshape(-1)
    ref_dx = np.asarray(jax.grad(lambda xx: jfs._poly_score_xla(
        xx, jnp.asarray(s), jnp.asarray(w)).sum())(jnp.asarray(x)))
    np.testing.assert_allclose(score.numpy(), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dx.numpy(), ref_dx, rtol=1e-3, atol=1e-3)


def test_xla_route_matches():
    x, s, w = _inputs(seed=1)
    mask = np.arange(64) < 50
    out = tfs._poly_score_xla(*map(torch.from_numpy, (x, s, w)),
                              valid_mask=torch.from_numpy(mask).float())
    ref = jfs._poly_score_xla(jnp.asarray(x), jnp.asarray(s), jnp.asarray(w),
                              valid_mask=jnp.asarray(mask, jnp.float32))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_router_agrees_across_gate():
    """polyharmonic_score at B = 16384 and below the gate gives the same
    values and query gradients. On the CPU both take the plain route, as
    the JAX router takes its XLA route off the TPU: at the gate the
    support and weight cotangents and the forward-mode derivative match
    JAX's. The one-pass Function itself gives supports and weights zero
    cotangents, and its forward mode raises."""
    B = tfs._FUSED_MIN_BATCH
    x, s, w = _inputs(B=B, S=32, seed=2)
    mask = torch.from_numpy(np.arange(32) < 30)
    xt = torch.from_numpy(x).requires_grad_(True)
    st = torch.from_numpy(s).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    above = tfs.polyharmonic_score(xt, st, wt, mask, epsilon=2.0)
    gx, gs, gw = torch.autograd.grad(above.sum(), (xt, st, wt))
    assert above.shape == (B, 1)
    half = B // 2   # two batches under the gate cover the same rows
    below = [tfs.polyharmonic_score(xt[i:i + half], st, wt, mask,
                                    epsilon=2.0) for i in (0, half)]
    below = torch.cat(below)
    gx_b, gs_b = torch.autograd.grad(below.sum(), (xt, st))
    np.testing.assert_allclose(above.detach().numpy(),
                               below.detach().numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gx.numpy(), gx_b.numpy(), rtol=1e-3,
                               atol=1e-3)
    assert gs_b.abs().sum() > 0   # the plain route differentiates supports
    # and matches the JAX router (XLA route off-TPU), cotangents included

    def jf(xx, ss, ww):
        return jfs.polyharmonic_score(xx, ss, ww, jnp.asarray(mask.numpy()),
                                      epsilon=2.0)
    jargs = tuple(map(jnp.asarray, (x, s, w)))
    np.testing.assert_allclose(above.detach().numpy(),
                               np.asarray(jf(*jargs)), rtol=1e-4, atol=1e-4)
    refs = jax.grad(lambda *a: jf(*a).sum(), argnums=(0, 1, 2))(*jargs)
    for got, want in zip((gx, gs, gw), refs):
        assert bool(got.any())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                                   atol=1e-3 * float(np.abs(want).max()))
    v = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    import torch.autograd.forward_ad as fwAD
    with fwAD.dual_level():
        xd = fwAD.make_dual(torch.from_numpy(x), torch.from_numpy(v))
        tan = fwAD.unpack_dual(tfs.polyharmonic_score(
            xd, torch.from_numpy(s), torch.from_numpy(w), mask,
            epsilon=2.0)).tangent
    ref_tan = jax.jvp(lambda xx: jf(xx, *jargs[1:]), (jargs[0],),
                      (jnp.asarray(v),))[1]
    np.testing.assert_allclose(tan.numpy(), np.asarray(ref_tan), rtol=1e-3,
                               atol=1e-3)
    # the one-pass Function (the route of a float32 CUDA batch)
    fused = tfs.polyharmonic_score_fused(xt[:64], st, wt)
    gx_f, gs_f, gw_f = torch.autograd.grad(fused.sum(), (xt, st, wt))
    assert not gs_f.any() and not gw_f.any()
    _, dx = tfs._poly_score_grad_plain(xt[:64].detach(), st.detach(),
                                       wt.detach())
    assert torch.equal(gx_f[:64], dx)
    with pytest.raises(RuntimeError, match='forward-mode'):
        with fwAD.dual_level():
            xd = fwAD.make_dual(torch.from_numpy(x[:64]), torch.ones(64, 21))
            tfs.polyharmonic_score_fused(xd, torch.from_numpy(s),
                                         torch.from_numpy(w))


def test_below_gate_twice_differentiable():
    x, s, w = _inputs(B=16, S=8, F=6, seed=3)
    args = [torch.from_numpy(a).double().requires_grad_(True)
            for a in (x, s, w)]
    assert torch.autograd.gradgradcheck(
        lambda a, b, c: tfs.polyharmonic_score(a, b, c), args)


def test_wrapper_uses_plain_twin_on_cpu_without_counting():
    x, s, w = _inputs(B=40, S=16, seed=4)
    before = profiling.counter('launches.poly_score_grad')
    score, dx = tfs.poly_score_grad(*map(torch.from_numpy, (x, s, w)))
    ref_s, ref_dx = tfs._poly_score_grad_plain(*map(torch.from_numpy,
                                                    (x, s, w)))
    assert torch.equal(score, ref_s) and torch.equal(dx, ref_dx)
    assert profiling.counter('launches.poly_score_grad') == before
