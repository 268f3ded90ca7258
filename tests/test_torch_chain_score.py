"""Port parity: general-chain FK + score + configuration gradient (kernel
B3's plain twin, the one-pass autograd Function and
fk_polyharmonic_score_auto's chain branch) against the JAX package's
Pallas kernel (Pallas interpreter, fp32 inputs) and its FK + fp32 XLA
route; and the folded chain the CUDA kernel takes, replayed in numpy."""
import ctypes
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffco_tpu.ops import fk_score as jfk
from diffco_tpu.ops.fused_score import _poly_score_xla
from diffco_tpu.robots import urdf as jurdf
from diffco_tpu_torch import profiling, robot_data
from diffco_tpu_torch.ops import _native
from diffco_tpu_torch.ops import fk_score as tfk
from diffco_tpu_torch.ops.fused_score import _poly_score_grad_plain
from diffco_tpu_torch.robots import urdf as turdf

torch.set_num_threads(1)

# serial (with a fixed gripper), branching tree with constant points,
# prismatic + mimic
URDFS = ['panda_simple.urdf', 'trifinger_simple.urdf', 'lift_rig.urdf']
_BASE = np.array([[0.0, -1.0, 0.0, 0.1],
                  [1.0, 0.0, 0.0, -0.2],
                  [0.0, 0.0, 1.0, 0.3],
                  [0.0, 0.0, 0.0, 1.0]])


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv('DIFFCO_PALLAS_INTERPRET', '1')


def _robots(name, base=None):
    path = os.path.join(robot_data.ensure_default_assets(), name)
    kw = dict(setup_acm=False, link_spheres=2, base_transform=base)
    return (jurdf.URDFRobot(path, **kw),
            turdf.URDFRobot(path, device='cpu', **kw))


def _inputs(robot, B, S, seed=0):
    """Supports are FK points of random configurations, as in a fit."""
    lims = robot.spec.joint_limits
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(S + B, lims.shape[0])).astype(np.float32)
    qs = u * (lims[:, 1] - lims[:, 0]) + lims[:, 0]
    sup = robot.fkine(torch.from_numpy(qs[:S])).reshape(S, -1).numpy()
    w = (rng.normal(size=(S,)) * 0.05).astype(np.float32)
    return qs[S:], sup, w


@pytest.mark.parametrize('name', URDFS)
def test_plain_twin_matches_pallas_and_xla(name):
    jr, tr = _robots(name)
    q, sup, w = _inputs(tr, B=160, S=32)
    cs = tfk.robot_chain_statics(tr)
    score, dq = tfk._chain_score_grad_plain(
        *map(torch.from_numpy, (q, sup, w)), cs)
    p_score, p_dq = jfk._chain_score_grad_pallas(
        jnp.asarray(q), jnp.asarray(sup), jnp.asarray(w),
        jfk.robot_chain_statics(jr), use_bf16=False)
    np.testing.assert_allclose(score.numpy(), np.asarray(p_score),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dq.numpy(), np.asarray(p_dq), rtol=1e-3,
                               atol=1e-3)

    def f(qq):
        return _poly_score_xla(jr.fkine(qq).reshape(qq.shape[0], -1),
                               jnp.asarray(sup), jnp.asarray(w))
    np.testing.assert_allclose(score.numpy(),
                               np.asarray(f(jnp.asarray(q))).reshape(-1),
                               rtol=1e-4, atol=1e-4)
    ref_dq = jax.grad(lambda qq: f(qq).sum())(jnp.asarray(q))
    np.testing.assert_allclose(dq.numpy(), np.asarray(ref_dq), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize('B', [32, 4096])
def test_auto_router_matches_jax(B):
    """On the CPU both batches take FK + polyharmonic_score, as the JAX
    router takes its XLA route off the TPU: values, query gradients, the
    support and weight cotangents and the forward-mode derivative match
    the JAX package's, at the gate as below it; no kernel is counted."""
    jr, tr = _robots('panda_simple.urdf')
    q, sup, w = _inputs(tr, B=B, S=48, seed=B)
    mask = np.arange(48) < 40
    qt = torch.from_numpy(q).requires_grad_(True)
    st = torch.from_numpy(sup).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    before = profiling.counter('launches.chain_score_grad')
    out = tfk.fk_polyharmonic_score_auto(
        qt, tr, st, wt, torch.from_numpy(mask), epsilon=1.5)
    g, gs, gw = torch.autograd.grad(out.sum(), (qt, st, wt))
    assert profiling.counter('launches.chain_score_grad') == before
    assert not tfk.chain_score_grad_available(tr, qt)

    def jf(qq, ss, ww):
        return jfk.fk_polyharmonic_score_auto(
            qq, jr, ss, ww, jnp.asarray(mask), epsilon=1.5)
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
            qd, tr, torch.from_numpy(sup), torch.from_numpy(w),
            torch.from_numpy(mask), epsilon=1.5)).tangent
    ref_tan = jax.jvp(lambda qq: jf(qq, *jargs[1:]), (jargs[0],),
                      (jnp.asarray(v),))[1]
    np.testing.assert_allclose(tan.numpy(), np.asarray(ref_tan), rtol=1e-3,
                               atol=1e-3)


def test_chain_function_gives_state_zero_cotangents():
    """The one-pass Function itself (the route of a float32 CUDA batch at
    the gate) treats supports and weights as constants, and its q
    gradient is the twin's dq."""
    _, tr = _robots('lift_rig.urdf')
    q, sup, w = _inputs(tr, B=8, S=16, seed=4)
    cs = tfk.robot_chain_statics(tr)
    qt, st, wt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, sup, w))
    out = tfk.chain_polyharmonic_score(qt, st, wt, cs)
    g, gs, gw = torch.autograd.grad(out.sum(), (qt, st, wt))
    assert not gs.any() and not gw.any()
    _, dq = tfk._chain_score_grad_plain(*map(torch.from_numpy, (q, sup, w)),
                                        cs)
    assert torch.equal(g, dq)


def test_chain_function_jvp_raises():
    _, tr = _robots('lift_rig.urdf')
    q, sup, w = _inputs(tr, B=8, S=16)
    import torch.autograd.forward_ad as fwAD
    with pytest.raises(RuntimeError, match='forward-mode'):
        with fwAD.dual_level():
            qd = fwAD.make_dual(torch.from_numpy(q), torch.ones(8, 3))
            tfk.chain_polyharmonic_score(qd, torch.from_numpy(sup),
                                         torch.from_numpy(w),
                                         tfk.robot_chain_statics(tr))


def _rodrigues(u, th):
    x, y, z = u
    s, c = np.sin(th), np.cos(th)
    C = 1.0 - c
    return np.stack([
        np.stack([x * x * C + c, x * y * C - z * s, x * z * C + y * s], -1),
        np.stack([y * x * C + z * s, y * y * C + c, y * z * C - x * s], -1),
        np.stack([z * x * C - y * s, z * y * C + x * s, z * z * C + c], -1),
    ], -2)


def _replay_kernel(c, q, s, w):
    """numpy float64 replay of csrc/chain_fk.cuh on the ctypes ChainSpec
    the kernel receives: FK of the folded moving joints, the score block
    (plain twin), then the per-point walk over moving parents."""
    q = q.astype(np.float64)
    B = q.shape[0]
    R, t, Z = [], [], []
    for m in range(c.M):
        p = c.mparent[m]
        pr = np.broadcast_to(np.eye(3), (B, 3, 3)) if p < 0 else R[p]
        pt = np.zeros((B, 3)) if p < 0 else t[p]
        ar = pr @ np.array(c.pre_r[m]).reshape(3, 3)
        at = pt + pr @ np.array(c.pre_t[m])
        th = q[:, c.dof[m]] * c.mult[m] + c.off[m]
        u = np.array(c.axis[m])
        Z.append(ar @ u)
        if c.jtype[m] == 1:
            R.append(ar @ _rodrigues(u, th))
            t.append(at)
        else:
            R.append(ar)
            t.append(at + Z[m] * th[:, None])
    x = np.stack([np.broadcast_to(np.array(c.poff[k]), (B, 3))
                  if c.pframe[k] < 0 else
                  t[c.pframe[k]] + R[c.pframe[k]] @ np.array(c.poff[k])
                  for k in range(c.P)], 1).reshape(B, -1)
    score, dx = _poly_score_grad_plain(
        *(torch.from_numpy(np.asarray(a, np.float64)) for a in (x, s, w)))
    dx = dx.numpy()
    dq = np.zeros((B, c.D))
    for k in range(c.P):
        g, xk = dx[:, 3 * k:3 * k + 3], x[:, 3 * k:3 * k + 3]
        m = c.pframe[k]
        while m >= 0:
            v = (np.cross(Z[m], xk - t[m]) if c.jtype[m] == 1
                 else Z[m])
            dq[:, c.dof[m]] += c.mult[m] * np.sum(v * g, -1)
            m = c.mparent[m]
    return score.numpy(), dq


@pytest.mark.parametrize('name', URDFS)
def test_folded_kernel_spec_matches_plain_twin(name):
    """The fixed-joint folding and the ctypes layout the CUDA kernel reads
    compute the plain twin's function (base transform included)."""
    _, tr = _robots(name, base=_BASE)
    cs = tfk.robot_chain_statics(tr)
    c = tfk._c_chain_spec(cs)
    n_moving = sum(1 for j in cs.jtype if j != 0)
    assert (c.M, c.P, c.D) == (n_moving, len(cs.point_specs), cs.n_dofs)
    q, sup, w = _inputs(tr, B=64, S=40, seed=3)
    score, dq = _replay_kernel(c, q, sup, w)
    ref, ref_dq = tfk._chain_score_grad_plain(
        *map(torch.from_numpy, (q, sup, w)), cs)
    np.testing.assert_allclose(score, ref.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dq, ref_dq.numpy(), rtol=1e-3, atol=1e-3)


def test_kernel_spec_layout_and_bounds(tmp_path):
    """The ctypes ChainSpec mirrors csrc/chain_fk.cuh (1628 bytes, inside
    the 4 KB kernel-parameter space); a chain beyond the tensor-core
    kernel's compile-time bounds (the 20-link rope's 20 moving joints)
    takes the wide instance's ChainSpecWide (6156 bytes, passed as a
    device copy), and a chain beyond that one's raises, naming the
    bound."""
    assert ctypes.sizeof(_native.ChainSpec) == 1628
    assert ctypes.sizeof(_native.ChainSpecWide) == 6156
    ropes = {}
    for n in (20, 70):
        path = robot_data.generate_rope_urdf(
            n_links=n, path=str(tmp_path / f'rope_{n}.urdf'))
        ropes[n] = turdf.URDFRobot(path, device='cpu', setup_acm=False,
                                   link_spheres=1)
    c = tfk._c_chain_spec(tfk.robot_chain_statics(ropes[20]))
    assert isinstance(c, _native.ChainSpecWide) and c.M == 20
    with pytest.raises(ValueError, match='70 moving joints.*1 to 64'):
        tfk._c_chain_spec(tfk.robot_chain_statics(ropes[70]))


def test_wrapper_uses_plain_twin_on_cpu_without_counting():
    _, tr = _robots('trifinger_simple.urdf')
    q, sup, w = _inputs(tr, B=16, S=16, seed=4)
    cs = tfk.robot_chain_statics(tr)
    before = profiling.counter('launches.chain_score_grad')
    score, dq = tfk.chain_score_grad(*map(torch.from_numpy, (q, sup, w)), cs)
    ref = tfk._chain_score_grad_plain(*map(torch.from_numpy, (q, sup, w)),
                                      cs)
    assert torch.equal(score, ref[0]) and torch.equal(dq, ref[1])
    assert profiling.counter('launches.chain_score_grad') == before
