"""Port parity: the multi-class FK + score + gradient twins (kernels B4
and B5's plain versions) against the JAX package's Pallas kernels
(Pallas interpreter, fp32 inputs), the autograd route's class-mixed VJP
against JAX's value_and_grad, and the contracts: the one-pass Functions
give zero cotangents for supports and W and no forward mode; the router
on the CPU keeps the plain route, differentiable in every argument, to
any order."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffco_tpu.ops import fk_score as jfk
from diffco_tpu.robots import PandaFK as JPandaFK
from diffco_tpu.robots import urdf as jurdf
from diffco_tpu_torch import profiling, robot_data
from diffco_tpu_torch.ops import _native
from diffco_tpu_torch.ops import fk_score as tfk
from diffco_tpu_torch.robots import PandaFK
from diffco_tpu_torch.robots import urdf as turdf

torch.set_num_threads(1)

URDFS = ['panda_simple.urdf', 'trifinger_simple.urdf', 'lift_rig.urdf']


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv('DIFFCO_PALLAS_INTERPRET', '1')


def _inputs(robot, B, S, C, seed):
    """q [B, D], supports = FK points of S configurations, W [S, C]."""
    lims = np.asarray(robot.joint_limits)
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(S + B, lims.shape[0])).astype(np.float32)
    qs = u * (lims[:, 1] - lims[:, 0]) + lims[:, 0]
    sup = robot.fkine(torch.from_numpy(qs[:S])).reshape(S, -1).numpy()
    W = (rng.normal(size=(S, C)) * 0.05).astype(np.float32)
    mix = rng.normal(size=(B, C)).astype(np.float32)
    return qs[S:], sup, W, mix


def _urdf_pair(name):
    path = os.path.join(robot_data.ensure_default_assets(), name)
    kw = dict(setup_acm=False, link_spheres=2)
    return (jurdf.URDFRobot(path, **kw),
            turdf.URDFRobot(path, device='cpu', **kw))


def _close(out, ref, tol):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize('C', [1, 3])
def test_dh_multi_twin_matches_pallas(C):
    robot = PandaFK()
    q, sup, W, _ = _inputs(robot, B=192, S=64, C=C, seed=C)
    spec = tfk.robot_spec(robot)
    score, dq = tfk._dh_multi_score_grad_plain(
        *map(torch.from_numpy, (q, sup, W)), spec)
    ref, ref_dq = jfk._dh_multi_score_grad_pallas(
        jnp.asarray(q), jnp.asarray(sup), jnp.asarray(W),
        jfk.robot_spec(JPandaFK()), use_bf16=False)
    assert score.shape == (192, C) and dq.shape == (C, 192, 7)
    _close(score, ref, 1e-4)
    _close(dq, ref_dq, 1e-3)


@pytest.mark.parametrize('name', URDFS)
def test_chain_multi_twin_matches_pallas(name):
    jr, tr = _urdf_pair(name)
    q, sup, W, _ = _inputs(tr, B=160, S=32, C=2, seed=7)
    score, dq = tfk._chain_multi_score_grad_plain(
        *map(torch.from_numpy, (q, sup, W)), tfk.robot_chain_statics(tr))
    ref, ref_dq = jfk._chain_multi_score_grad_pallas(
        jnp.asarray(q), jnp.asarray(sup), jnp.asarray(W),
        jfk.robot_chain_statics(jr), use_bf16=False)
    assert score.shape == (160, 2) and dq.shape == (2, 160, q.shape[1])
    _close(score, ref, 1e-4)
    _close(dq, ref_dq, 1e-3)


def _robot_pair(kind):
    return ((JPandaFK(), PandaFK()) if kind == 'dh'
            else _urdf_pair('panda_simple.urdf'))


@pytest.mark.parametrize('kind', ['dh', 'chain'])
@pytest.mark.parametrize('B', [64, 4096])
def test_auto_router_class_mixed_vjp(kind, B):
    """On the CPU both batches take FK + the plain [B, S] @ [S, C] route,
    as the JAX router takes its XLA route off the TPU: JAX's values, its
    class-mixed gradient in q, its cotangents of the supports and W, and
    its forward-mode derivative, at the gate as below it."""
    jr, tr = _robot_pair(kind)
    q, sup, W, mix = _inputs(tr, B=B, S=48, C=3, seed=B)
    mask = np.arange(48) < 40
    qt = torch.from_numpy(q).requires_grad_(True)
    st = torch.from_numpy(sup).requires_grad_(True)
    Wt = torch.from_numpy(W).requires_grad_(True)
    out = tfk.fk_polyharmonic_multi_score_auto(
        qt, tr, st, Wt, torch.from_numpy(mask), epsilon=1.5)
    g, gs, gW = torch.autograd.grad((out * torch.from_numpy(mix)).sum(),
                                    (qt, st, Wt))

    def scores(qq, ss, WW):
        return jfk.fk_polyharmonic_multi_score_auto(
            qq, jr, ss, WW, jnp.asarray(mask), epsilon=1.5)

    def total(qq, ss, WW):
        s = scores(qq, ss, WW)
        return (s * jnp.asarray(mix)).sum(), s
    jargs = tuple(map(jnp.asarray, (q, sup, W)))
    (_, ref), (ref_g, ref_gs, ref_gW) = jax.value_and_grad(
        total, argnums=(0, 1, 2), has_aux=True)(*jargs)
    assert out.shape == (B, 3)
    _close(out, ref, 1e-4)
    _close(g, ref_g, 1e-3)
    for got, want in ((gs, ref_gs), (gW, ref_gW)):
        assert bool(got.any())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                                   atol=1e-3 * float(np.abs(want).max()))
    v = np.random.default_rng(B + 1).normal(size=q.shape).astype(np.float32)
    import torch.autograd.forward_ad as fwAD
    with fwAD.dual_level():
        qd = fwAD.make_dual(torch.from_numpy(q), torch.from_numpy(v))
        tan = fwAD.unpack_dual(tfk.fk_polyharmonic_multi_score_auto(
            qd, tr, torch.from_numpy(sup), torch.from_numpy(W),
            torch.from_numpy(mask), epsilon=1.5)).tangent
    ref_tan = jax.jvp(lambda qq: scores(qq, *jargs[1:]), (jargs[0],),
                      (jnp.asarray(v),))[1]
    _close(tan, ref_tan, 1e-3)


@pytest.mark.parametrize('kind', ['dh', 'chain'])
def test_multi_function_gives_state_zero_cotangents(kind):
    """The one-pass Function itself (the route of a float32 CUDA batch at
    the gate) treats supports and W as constants, and its q gradient is
    the class mix of the twin's dq."""
    _, tr = _robot_pair(kind)
    q, sup, W, mix = _inputs(tr, B=8, S=16, C=2, seed=2)
    fn, twin, spec = (
        (tfk.dh_polyharmonic_multi_score, tfk._dh_multi_score_grad_plain,
         tfk.robot_spec(tr)) if kind == 'dh' else
        (tfk.chain_polyharmonic_multi_score,
         tfk._chain_multi_score_grad_plain, tfk.robot_chain_statics(tr)))
    qt, st, Wt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, sup, W))
    out = fn(qt, st, Wt, spec)
    g, gs, gW = torch.autograd.grad((out * torch.from_numpy(mix)).sum(),
                                    (qt, st, Wt))
    assert not gs.any() and not gW.any()
    _, dq = twin(*map(torch.from_numpy, (q, sup, W)), spec)
    torch.testing.assert_close(
        g, torch.einsum('bc,cbj->bj', torch.from_numpy(mix), dq))


@pytest.mark.parametrize('kind', ['dh', 'chain'])
def test_multi_function_jvp_raises(kind):
    _, tr = _robot_pair(kind)
    q, sup, W, _ = _inputs(tr, B=8, S=16, C=2, seed=1)
    fn, spec = ((tfk.dh_polyharmonic_multi_score, tfk.robot_spec(tr))
                if kind == 'dh' else (tfk.chain_polyharmonic_multi_score,
                                      tfk.robot_chain_statics(tr)))
    import torch.autograd.forward_ad as fwAD
    with pytest.raises(RuntimeError, match='forward-mode'):
        with fwAD.dual_level():
            qd = fwAD.make_dual(torch.from_numpy(q), torch.ones(8, 7))
            fn(qd, torch.from_numpy(sup), torch.from_numpy(W), spec)


def test_plain_route_is_twice_differentiable():
    """Below the gate the route is plain torch: a Hessian-vector product
    in q exists and matches the one of the JAX route."""
    jr, tr = _robot_pair('dh')
    q, sup, W, mix = _inputs(tr, B=16, S=24, C=2, seed=5)
    v = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)
    qt = torch.from_numpy(q).requires_grad_(True)
    out = tfk.fk_polyharmonic_multi_score_auto(qt, tr, torch.from_numpy(sup),
                                               torch.from_numpy(W))
    g, = torch.autograd.grad((out * torch.from_numpy(mix)).sum(), qt,
                             create_graph=True)
    hv, = torch.autograd.grad((g * torch.from_numpy(v)).sum(), qt)

    def total(qq):
        s = jfk.fk_polyharmonic_multi_score_auto(
            qq, jr, jnp.asarray(sup), jnp.asarray(W))
        return (s * jnp.asarray(mix)).sum()
    ref_hv = jax.jvp(jax.grad(total), (jnp.asarray(q),), (jnp.asarray(v),))[1]
    np.testing.assert_allclose(hv.numpy(), np.asarray(ref_hv), rtol=1e-3,
                               atol=1e-3)


def test_wrappers_use_twins_on_cpu_without_counting():
    robot = PandaFK()
    q, sup, W, _ = _inputs(robot, B=16, S=16, C=2, seed=4)
    spec = tfk.robot_spec(robot)
    def launches():
        return (profiling.counter('launches.dh_multi_score_grad'),
                profiling.counter('launches.chain_multi_score_grad'))
    before = launches()
    args = tuple(map(torch.from_numpy, (q, sup, W)))
    out = tfk.dh_multi_score_grad(*args, spec)
    ref = tfk._dh_multi_score_grad_plain(*args, spec)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    _, tr = _urdf_pair('lift_rig.urdf')
    q, sup, W, _ = _inputs(tr, B=16, S=16, C=2, seed=4)
    args = tuple(map(torch.from_numpy, (q, sup, W)))
    cs = tfk.robot_chain_statics(tr)
    out = tfk.chain_multi_score_grad(*args, cs)
    ref = tfk._chain_multi_score_grad_plain(*args, cs)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert launches() == before


def test_chain_multi_plan_fits_the_card():
    """Every (control points, classes) that B5's C entry takes (B4's are
    a subset) stays within 227 KB of shared memory per block and keeps 16
    warps resident per SM; a full pass takes floor(128 / (FP + 1)) classes
    (at most 8), so FrankaPanda's C = 5 at FP = 24 reads each support once
    and C = 8 twice; C <= floor(50 / (FP + 1)) takes the register instance
    (C <= 2 there, C <= 5 at FP = 8, none past FP = 48), else
    C <= floor(64 / (FP + 1)) the narrow one. The card's own occupancy
    calculator checks the same numbers (tests/test_torch_cuda.py)."""
    for P in range(1, _native.MAX_CP + 1):
        for C in range(1, _native.MAX_C + 1):
            plan = _native.multi_plan(P, C)
            cg = plan['classes_per_pass']
            assert 1 <= cg <= _native.MAX_C
            assert cg * (plan['fp'] + 1) <= _native.MULTI_COLS
            assert plan['passes'] == -(-C // cg)
            assert plan['smem_bytes'] <= _native.BLOCK_SHARED_MAX
            assert plan['warps_per_sm'] >= 16, (P, C, plan)
    assert _native.multi_plan(8, 5)['passes'] == 1
    assert _native.multi_plan(8, 8)['passes'] == 2
    assert [_native.multi_plan(8, C)['classes_per_pass']
            for C in (1, 2, 3)] == [2, 2, 5]
    assert [_native.multi_plan(8, C)['instance'] for C in (1, 2, 3, 8)] == [
        'register', 'register', 'full', 'full']
    assert [_native.multi_plan(2, C)['instance'] for C in (5, 6, 8)] == [
        'register', 'narrow', 'full']
    assert {_native.multi_plan(P, 1)['instance']
            for P in range(19, _native.MAX_CP + 1)} == {'full'}


def test_ab_kernel_ablations_find_their_text():
    """Each edit of each named ablation of scripts/ab_kernel.py is to text
    that its file holds exactly once (the shared block's, or the own
    source of each kernel that takes it: B5 and B4 their ABLATIONS, B1
    its B1_ABLATIONS), so it takes out the part it names."""
    from diffco_tpu_torch.scripts import ab_kernel
    for kernel, spec in ab_kernel.KERNELS.items():
        for name, edits in ab_kernel.ablation_table(kernel).items():
            for fname, text, _ in edits:
                f = fname or spec['source']
                assert (_native._CSRC / f).read_text().count(text) == 1, (
                    kernel, name, f)
