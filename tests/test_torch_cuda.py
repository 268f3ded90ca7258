"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card. Run there with ``python -m pytest -m cuda tests/test_torch_cuda.py``;
without a card every test skips (the fixture decides, at run time)."""
import copy
import os

import numpy as np
import pytest
import torch

from diffco_tpu_torch import profiling, robot_data
from diffco_tpu_torch.ops import _native, fk_score, fused_score
from diffco_tpu_torch.robots import PandaFK, URDFRobot, fk_jvp
from diffco_tpu_torch.robots.analytic import baxter_arm, panda_with_points
from diffco_tpu_torch.robots.soa import stack_points
from diffco_tpu_torch.scripts import ab_dual_tile as ab
from diffco_tpu_torch.scripts import roofline_fk_score as rf

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

# score rtol/atol 1e-4, gradient 1e-3: kernel and twin sum in other orders
SHAPES = [(37, 5), (300, 130), (65536 + 37, 512)]
# B3 on a serial arm with a fixed gripper, a branching tree and a
# prismatic + mimic rig
CHAIN_CASES = [('panda_simple.urdf', 37, 5),
               ('panda_simple.urdf', 65536 + 37, 512),
               ('trifinger_simple.urdf', 4096 + 5, 128),
               ('lift_rig.urdf', 4096 + 5, 128),
               ('marked_rope.urdf', 4096 + 5, 128)]
# B4 on PandaFK (FP = 24): ragged B, S off the 32-support chunk; C = 1 and
# 2 take the block's register instance, 3 and 5 one full pass, 8 two
DH_MULTI_CASES = [(37, 5, 1), (300, 130, 2), (65536 + 37, 512, 1),
                  (65536 + 37, 512, 2), (65536 + 37, 512, 3),
                  (65536 + 37, 512, 5), (65536 + 37, 512, 8)]
# B1 and B4 at their FP = 16 and FP = 8 instances: Baxter's arm with 4 and
# 2 control points (PandaFK's 7 take FP = 24); B4 in each instance there
# (register, narrow, full)
BAXTER_MASKS = {16: (True, False, True, False, True, False, True),
                8: (False, False, True, False, False, False, True)}
BAXTER_MULTI_CLASSES = {16: (2, 3, 5), 8: (5, 6, 8)}
# B4 at FP = 32, 40 and 48 (PandaFK's chain with 10, 13 and 16 points):
# the narrow instance at C = 1, one full pass at C = 2, more at C = 5
WIDE_MULTI_CASES = [(P, C) for P in (10, 13, 16) for C in (1, 2, 5)]
# B1 on fitted proxies with many supports: PandaFK (FP = 24) and Baxter's
# left arm (FP = 16)
LARGE_S_CASES = [(name, S) for name in ('PandaFK', 'Baxter arm')
                 for S in (2048, 4096)]
# B5 on the three robots (FP = 24, 32 and 16: one pass up to 5, 3 and 7
# classes); FrankaPanda's multi-class proxy has S = 1024 and C = 5. C = 1,
# 2, 5 and 8 (8 at FP = 24 takes a second pass; C <= 2 there the register
# instance), ragged B, S off the 32-support chunk, and no supports at all
CHAIN_MULTI_CASES = [('panda_simple.urdf', 37, 5, 3),
                     ('panda_simple.urdf', 300, 130, 1),
                     ('panda_simple.urdf', 65536 + 37, 1024, 5),
                     ('panda_simple.urdf', 65536 + 37, 1024, 8),
                     ('panda_simple.urdf', 65536 + 37, 1024, 2),
                     ('panda_simple.urdf', 4096 + 5, 0, 2),
                     ('trifinger_simple.urdf', 4096 + 5, 128, 2),
                     ('trifinger_simple.urdf', 4096 + 5, 100, 8),
                     ('lift_rig.urdf', 4096 + 5, 128, 2),
                     ('lift_rig.urdf', 300, 37, 8),
                     ('lift_rig.urdf', 64, 0, 5)]

# the DH FK kernels (csrc/dh_fk.cu) at an empty batch, one row, the
# trajectory optimizers' 448 (a plan) and 28672 (a batch of 64) and a
# ragged 2^16 + 1; on the KP = 8 instance at 4 and 7 points, the KP = 16
# one and the dual arm's right chain (a non-identity base, q the right
# half of 14 columns)
DH_FK_BATCHES = [0, 1, 448, 28672, 65537]
DH_FK_ROBOTS = ['Baxter', 'PandaFK', 'PandaFK chain, 16 points',
                'dual arm, right']

# B6 and B7 at a ragged small shape and the roofline path's shape; B7
# against its twin at rf.ABLATION_TOL
ROOFLINE_SHAPES = [(300, 130), (65536 + 37, 512)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def _inputs(B, S, dev, seed=0):
    robot = PandaFK()
    g = torch.Generator().manual_seed(seed)
    q = robot.rand_configs(B, g, dev)
    sup = robot.fkine(robot.rand_configs(S, g, dev), flat=True).contiguous()
    w = (torch.randn(S, generator=g) * 0.05).to(dev)
    return robot, q, sup, w


def _close(a, b, tol):
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=tol,
                               atol=tol)


def _near_supports(robot, q, sup, seed):
    """Supports 0-11 (of at least 12) moved onto the FK points of
    configurations 0-11: 0-3 exactly, 4-7 at 1e-3 and 8-11 at 1e-2."""
    return _near_points(robot.fkine(q[:12]).reshape(12, -1), sup, seed)


def _near_points(x, sup, seed):
    """Supports 0-11 moved onto the rows x [12, F]: 0-3 exactly, 4-7 at
    1e-3 and 8-11 at 1e-2 (random directions)."""
    g = torch.Generator().manual_seed(seed)
    d = torch.randn(x.shape, generator=g).to(x.device)
    d = d / d.norm(dim=1, keepdim=True)
    off = torch.tensor([0.0] * 4 + [1e-3] * 4 + [1e-2] * 4, device=x.device)
    sup = sup.clone()
    sup[:12] = x + off[:, None] * d
    return sup.contiguous()


def _close_near(score, dq, ref, ref_dq):
    """Rows 0-3 sit on a support, where dq is divided by a distance of
    ~1e-7 in kernel and twin alike: their dq only has to be finite."""
    _close(score, ref, 1e-4)
    _close(dq[4:], ref_dq[4:], 1e-3)
    assert torch.isfinite(dq).all()


@pytest.mark.parametrize('B,S', SHAPES)
def test_poly_score_kernel_matches_plain(cuda, B, S):
    """B2 against its twin at PandaFK's points (F = 21); at S >= 12 rows
    0-11 sit on a support or 1e-3 or 1e-2 from one."""
    robot, q, sup, w = _inputs(B, S, cuda)
    x = robot.fkine(q, flat=True).contiguous()
    if S >= 12:
        sup = _near_points(x[:12], sup, seed=S)
    before = profiling.counter('launches.poly_score_grad')
    score, dx = fused_score.poly_score_grad(x, sup, w)
    torch.cuda.synchronize()
    assert profiling.counter('launches.poly_score_grad') == before + 1
    ref, ref_dx = fused_score._poly_score_grad_plain(x, sup, w)
    if S >= 12:
        _close_near(score, dx, ref, ref_dx)
    else:
        _close(score, ref, 1e-4)
        _close(dx, ref_dx, 1e-3)


# B2's instances: fp64 at F <= 8 (2 and 14 are the planar path's widths:
# the 2-DOF q-space proxies and the 7-DOF arm's joint positions; 4 beside
# them), the tensor-core block at FP = 16, ..., 64, each at an F that pads
# to it (64: the full row, where product 2 takes an extra column tile),
# the wide instance at F = 72 (three Panda arms), 102 (the 35-link rope),
# 150 (K = 5) and 192 (its bound)
POLY_FS = [2, 4, 5, 13, 14, 21, 32, 37, 48, 53, 64, 72, 102, 150, 192]


@pytest.mark.parametrize('F', POLY_FS)
def test_poly_score_kernel_at_every_fp(cuda, F):
    """B2 at every instance against its twin, rows uniform in a box off
    the origin and rows 0-11 on or near a support, with its launch plan on
    the card as ops/_native.py::poly_tc_plan gives it
    (``poly_plan_holds``): 16 warps per SM at least (8 at FP = 64, whose
    shared memory takes more than half an SM's, and on the wide instance,
    whose warps each hold ~200 registers of accumulators)."""
    g = torch.Generator().manual_seed(F)
    x = (torch.rand(4096 + 5, F, generator=g) * 1.2 - 0.3).to(cuda)
    sup = (torch.rand(128, F, generator=g) * 1.2 - 0.3).to(cuda)
    sup = _near_points(x[:12], sup, seed=F)
    w = (torch.randn(128, generator=g) * 0.05).to(cuda)
    score, dx = fused_score.poly_score_grad(x, sup, w)
    ref, ref_dx = fused_score._poly_score_grad_plain(x, sup, w)
    _close_near(score, dx, ref, ref_dx)
    plan = _native.poly_score_plan_on_card(F)
    # one block (8 warps) per SM at FP = 64, whose per-chunk running sums
    # take 36 KB of shared memory, and 8 warps on the wide instance
    least = 8 if F > 56 else 16
    assert _native.poly_plan_holds(plan, F) and plan['warps_per_sm'] >= least


def _planar_proxy(dof, dev):
    """The planar path's fitted proxies (chip_smoke.py): the 2-DOF q-space
    DiffCo of scripts/escape_2d.py in 1rect_1circle with its unified grid
    (F = 2), and the 7-DOF FK-feature DiffCo of scripts/narrow_fk_study.py
    in 7d_narrow with 65536 configurations' joint positions (F = 14).
    Returns (x, supports, weights)."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch import routines
    from diffco_tpu_torch.envs.presets2d import get_env
    g = torch.Generator().manual_seed(0)
    if dof == 2:
        robot = dc.RevolutePlanarRobot(3.5, link_width=0.3, dof=2)
        env, n, target = '1rect_1circle', 4000, 'label'
        p = dc.DiffCo(kernel_func=dc.kernels.RQKernel(10.0))
    else:
        robot = dc.RevolutePlanarRobot(1.0, link_width=0.3, dof=7)
        env, n, target = '7d_narrow', 6000, 'dist'
        p = dc.DiffCo(kernel_func=dc.kernels.RQKernel(0.1),
                      transform=robot.fkine)
    obs = dc.Obstacles2D.from_obstacle_list(get_env(env))
    q = robot.rand_configs(n, g, dev)
    dist = dc.planar_robot_signed_dist(robot, obs, q).amax(-1)
    p.train(q, (dist > 0).float() * 2 - 1, max_iteration=3 * n,
            distance=dist)
    p.fit_poly(dc.kernels.Polyharmonic(1, 1), target=target)
    x = (routines.generate_unified_grid(400, 400, device=dev) if dof == 2
         else robot.fkine(robot.rand_configs(65536, g, dev)).reshape(
             65536, -1))
    w = p.rbf_nodes.reshape(-1) * p.valid_mask.float() / p.rbf_kernel.epsilon
    return x.contiguous(), p.support_transformed.contiguous(), w.contiguous()


@pytest.mark.parametrize('dof', [2, 7])
def test_poly_score_kernel_on_fitted_planar_proxies(cuda, dof):
    """B2 on the planar path's fitted proxies against its float64 twin:
    score 1e-4, dx 1e-3. The 2-DOF proxy's weights cancel so hard (sum_j
    |w_j| r_j ~ 1.4e4 against |score| <= 3.7) that a float32 r per pair
    misses the score tolerance: B2's fp64 instance takes F <= 8."""
    x, sup, w = _planar_proxy(dof, cuda)
    score, dx = fused_score.poly_score_grad(x, sup, w)
    ref, ref_dx = fused_score._poly_score_grad_plain(x.double(), sup.double(),
                                                     w.double())
    _close(score.double(), ref, 1e-4)
    _close(dx.double(), ref_dx, 1e-3)


def _chip_smoke():
    """chip_smoke.py as a module: the rigid-body path's proxies."""
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize('kind', ['se2', 'probe', 'mesh'])
def test_poly_score_kernel_on_fitted_rigid_proxies(cuda, kind):
    """B2 on the rigid-body path's fitted proxies (chip_smoke.rigid_proxy:
    the SE(2) q-space proxy, F = 3, on the fp64 instance; the SE(3) probe
    and torus over their keypoints, F = 9 and 24, on the tensor-core
    block) at a 65536 sweep against its float64 twin: score 1e-4, dx
    1e-3."""
    r = _chip_smoke().rigid_proxy(kind, cuda)
    p, robot = r['proxy'], r['robot']
    q = robot.rand_configs(65536, r['g'], cuda)
    x = (q if p.transform is None else robot.fkine(q).reshape(65536, -1))
    x = x.contiguous()
    assert x.shape[1] == {'se2': 3, 'probe': 9, 'mesh': 24}[kind]
    w = (p.rbf_nodes.reshape(-1) * p.valid_mask.float()
         / p.rbf_kernel.epsilon).contiguous()
    sup = p.support_transformed.contiguous()
    score, dx = fused_score.poly_score_grad(x, sup, w)
    ref, ref_dx = fused_score._poly_score_grad_plain(x.double(), sup.double(),
                                                     w.double())
    _close(score.double(), ref, 1e-4)
    _close(dx.double(), ref_dx, 1e-3)


def test_poly_score_kernel_on_the_fitted_rope_proxy(cuda):
    """B2's wide instance on chip_smoke's fitted 35-link rope proxy (34
    control points, F = 102, fit on 10000 samples) at a 65536 sweep
    against its float64 twin: score 1e-4, dx 1e-3."""
    import diffco_tpu_torch as dc
    cs = _chip_smoke()
    robot, env = cs.rope_world(cuda)
    ck = dc.ForwardKinematicsDiffCo(robot=robot, environment=env, seed=0,
                                    device=cuda)
    ck.fit(num_samples=cs.ROPE_FIT)
    p = ck.perceptron
    q = robot.rand_configs(65536, torch.Generator().manual_seed(9), cuda)
    x = robot.fkine(q).reshape(65536, -1).contiguous()
    assert x.shape[1] == 102
    w = (p.rbf_nodes.reshape(-1) * p.valid_mask.float()
         / p.rbf_kernel.epsilon).contiguous()
    sup = p.support_transformed.contiguous()
    before = profiling.counter('launches.poly_score_grad')
    score, dx = fused_score.poly_score_grad(x, sup, w)
    assert profiling.counter('launches.poly_score_grad') == before + 1
    ref, ref_dx = fused_score._poly_score_grad_plain(x.double(), sup.double(),
                                                     w.double())
    _close(score.double(), ref, 1e-4)
    _close(dx.double(), ref_dx, 1e-3)


def test_rope_sweeps_through_the_wide_b3_instance(cuda, tmp_path):
    """A ForwardKinematicsDiffCo on a 20-link rope (20 moving joints, past
    the tensor-core kernel's 16) sweeps on the card through B3's wide
    instance at B = 8192 and 65536, as the JAX package takes its kernel at
    every size: one B3 launch a sweep, and the score and dq of the float64
    twin (1e-4, 1e-3)."""
    import diffco_tpu_torch as dc
    rope = URDFRobot(robot_data.generate_rope_urdf(
        n_links=20, path=str(tmp_path / 'rope_20.urdf')), device=cuda,
        setup_acm=False, link_spheres=2)
    cs = fk_score.robot_chain_statics(rope)
    assert isinstance(fk_score._c_chain_spec(cs), _native.ChainSpecWide)
    env = dc.ShapeEnv({'ball': {'type': 'Sphere', 'params': {'radius': 0.2},
                                'transform': [[1, 0, 0, 0.2], [0, 1, 0, 0],
                                              [0, 0, 1, 0.1], [0, 0, 0, 1]]}})
    ck = dc.ForwardKinematicsDiffCo(robot=rope, environment=env, seed=0,
                                    device=cuda)
    ck.fit(num_samples=2000)
    p = ck.perceptron
    w = p.rbf_nodes.reshape(-1) * p.valid_mask.float() / p.rbf_kernel.epsilon
    g = torch.Generator().manual_seed(1)
    for B in (8192, 65536):
        before = profiling.counter('launches.chain_score_grad')
        q = rope.rand_configs(B, g, cuda).requires_grad_(True)
        s = ck.collision_score(q)
        dq, = torch.autograd.grad(s.sum(), q)
        torch.cuda.synchronize()
        assert profiling.counter('launches.chain_score_grad') == before + 1
        ref, ref_dq = fk_score._chain_score_grad_plain(
            q.detach().double(), p.support_transformed.double(), w.double(),
            cs)
        _close((s.detach()[:, 0] - ck.safety_bias).double(), ref, 1e-4)
        _close(dq.double(), ref_dq, 1e-3)


def _wide_robot(name, dev, tmp_path):
    """A robot past B1's / B3's bounds: the 9-joint DH chain, PandaFK's
    chain with 17 points, or the 35-link rope."""
    from diffco_tpu_torch.robots.analytic import DHChainRobot, DHParameters
    if name == 'dh9':
        n = 9
        return DHChainRobot(DHParameters(a=[0.1] * n, alpha=[0.5] * n,
                                         d=[0.05] * n, theta=[0.3] * n),
                            [[-np.pi, np.pi]] * n, [True] * n)
    if name == 'panda17':
        return panda_with_points(17)
    return URDFRobot(robot_data.generate_rope_urdf(
        n_links=35, path=str(tmp_path / 'rope_35.urdf')), device=dev,
        setup_acm=False, link_spheres=1)


@pytest.mark.parametrize('name,C', [('dh9', 1), ('dh9', 2), ('panda17', 1),
                                    ('panda17', 5), ('rope35', 1),
                                    ('rope35', 3)])
def test_wide_instances_match_plain(cuda, tmp_path, name, C):
    """The wide instance (csrc/chain_wide.cuh) as B1 and B4 launch it on a
    DH chain past their bounds and B3 and B5 on the 35-link rope, against
    the plain twins at B = 4096 + 5, S = 128 (configurations 0-11 on or
    near a support), each launch counted on its own kernel; the launch
    plan on the card is ops/_native.py::chain_wide_plan's."""
    robot = _wide_robot(name, cuda, tmp_path)
    g = torch.Generator().manual_seed(C)
    q = robot.rand_configs(4096 + 5, g, cuda)
    sup = robot.fkine(robot.rand_configs(128, g, cuda)).reshape(128, -1)
    sup = _near_supports(robot, q, sup, seed=C)
    W = _weights(128, C, cuda, seed=C)
    if name == 'rope35':
        spec = fk_score.robot_chain_statics(robot)
        kernel = (fk_score.chain_score_grad if C == 1
                  else fk_score.chain_multi_score_grad)
        plain = (fk_score._chain_score_grad_plain if C == 1
                 else fk_score._chain_multi_score_grad_plain)
        c = fk_score._c_chain_spec(spec)
    else:
        spec = fk_score.robot_spec(robot)
        kernel = (fk_score.dh_score_grad if C == 1
                  else fk_score.dh_multi_score_grad)
        plain = (fk_score._dh_score_grad_plain if C == 1
                 else fk_score._dh_multi_score_grad_plain)
        c = fk_score._c_spec(spec)
    assert isinstance(c, _native.ChainSpecWide)
    w = W[:, 0].contiguous() if C == 1 else W
    counter = f'launches.{kernel.__name__}'
    before = profiling.counter(counter)
    score, dq = kernel(q, sup, w, spec)
    torch.cuda.synchronize()
    assert profiling.counter(counter) == before + 1
    ref, ref_dq = plain(q, sup, w, spec)
    if C == 1:
        _close_near(score, dq, ref, ref_dq)
    else:
        _close(score, ref, 1e-4)
        _close(dq[:, 4:], ref_dq[:, 4:], 1e-3)
    card = _native.chain_wide_plan_on_card(c.P, c.M)
    assert _native.chain_wide_plan_holds(card, c.P, c.M)
    assert (card['warps_per_sm']
            >= _native.chain_wide_plan(c.P, c.M)['warps_per_sm'])


@pytest.mark.parametrize('B,S', SHAPES)
def test_dh_score_kernel_matches_plain(cuda, B, S):
    """B1 against its twin; at S >= 12 configurations 0-11 sit on a
    support or 1e-3 or 1e-2 from one (the near-pair guard's cases)."""
    robot, q, sup, w = _inputs(B, S, cuda, seed=1)
    if S >= 12:
        sup = _near_supports(robot, q, sup, seed=1)
    spec = fk_score.robot_spec(robot)
    before = profiling.counter('launches.dh_score_grad')
    score, dq = fk_score.dh_score_grad(q, sup, w, spec)
    torch.cuda.synchronize()
    assert profiling.counter('launches.dh_score_grad') == before + 1
    ref, ref_dq = fk_score._dh_score_grad_plain(q, sup, w, spec)
    _close_near(score, dq, ref, ref_dq)


@pytest.mark.parametrize('P', [10, 13, 16])
def test_dh_score_kernel_at_wide_rows(cuda, P):
    """B1 at FP = 32, 40 and 48 (PandaFK's chain with more points), with
    its launch plan on the card as ops/_native.py::dh_tc_plan gives it:
    16 warps per SM."""
    robot = panda_with_points(P)
    g = torch.Generator().manual_seed(P)
    q = robot.rand_configs(4096 + 5, g, cuda)
    sup = robot.fkine(robot.rand_configs(128, g, cuda), flat=True)
    sup = _near_supports(robot, q, sup, seed=P)
    w = (torch.randn(128, generator=g) * 0.05).to(cuda)
    spec = fk_score.robot_spec(robot)
    score, dq = fk_score.dh_score_grad(q, sup, w, spec)
    ref, ref_dq = fk_score._dh_score_grad_plain(q, sup, w, spec)
    _close_near(score, dq, ref, ref_dq)
    plan = _native.dh_score_plan_on_card(P)
    assert plan == _native.dh_tc_plan(P) and plan['warps_per_sm'] >= 16


@pytest.mark.parametrize('fp', list(BAXTER_MASKS))
def test_dh_kernels_at_fewer_points(cuda, fp):
    """B1 and B4 (each instance of the block) at FP = 16 and 8 against
    their twins."""
    robot = baxter_arm(BAXTER_MASKS[fp])
    g = torch.Generator().manual_seed(fp)
    q = robot.rand_configs(4096 + 5, g, cuda)
    sup = robot.fkine(robot.rand_configs(128, g, cuda), flat=True)
    assert (sup.shape[1] + 7) // 8 * 8 == fp
    w = (torch.randn(128, generator=g) * 0.05).to(cuda)
    spec = fk_score.robot_spec(robot)
    score, dq = fk_score.dh_score_grad(q, sup, w, spec)
    ref, ref_dq = fk_score._dh_score_grad_plain(q, sup, w, spec)
    _close(score, ref, 1e-4)
    _close(dq, ref_dq, 1e-3)
    for C in BAXTER_MULTI_CLASSES[fp]:
        W = (torch.randn(128, C, generator=g) * 0.05).to(cuda)
        score, dq = fk_score.dh_multi_score_grad(q, sup, W, spec)
        ref, ref_dq = fk_score._dh_multi_score_grad_plain(q, sup, W, spec)
        _close(score, ref, 1e-4)
        _close(dq, ref_dq, 1e-3)


@pytest.mark.parametrize('P,C', WIDE_MULTI_CASES)
def test_dh_multi_kernel_at_wide_rows(cuda, P, C):
    """B4 at FP = 32, 40 and 48 against its twin, with its launch plan on
    the card as ops/_native.py::multi_plan gives it."""
    robot = panda_with_points(P)
    g = torch.Generator().manual_seed(P + C)
    q = robot.rand_configs(4096 + 5, g, cuda)
    sup = robot.fkine(robot.rand_configs(128, g, cuda), flat=True)
    W = (torch.randn(128, C, generator=g) * 0.05).to(cuda)
    spec = fk_score.robot_spec(robot)
    score, dq = fk_score.dh_multi_score_grad(q, sup, W, spec)
    ref, ref_dq = fk_score._dh_multi_score_grad_plain(q, sup, W, spec)
    _close(score, ref, 1e-4)
    _close(dq, ref_dq, 1e-3)
    card, plan = _native.dh_multi_plan_on_card(P, C), _native.multi_plan(P, C)
    for key in ('instance', 'classes_per_pass', 'passes', 'smem_bytes'):
        assert card[key] == plan[key], key
    assert card['warps_per_sm'] >= 16


def _shape(kind, size, xyz):
    m = np.eye(4)
    m[:3, 3] = xyz
    key = 'radius' if kind == 'Sphere' else 'extents'
    return {'type': kind, 'params': {key: size}, 'transform': m}


def _fitted_proxy(name, S, dev):
    """The FK points of S ground-truth-labelled configurations and the
    polyharmonic weights that interpolate their labels (masked_rbf_solve,
    every row valid, float32 on the card), which cancel as a fitted
    proxy's do: PandaFK in the box + sphere scene, Baxter's left arm with
    a ball and a table."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch.device import fp32_matmul
    from diffco_tpu_torch.kernels import Polyharmonic
    from diffco_tpu_torch.perceptron import masked_rbf_solve
    if name == 'PandaFK':
        robot = dc.PandaFK()
        env = dc.ShapeEnv({'box1': _shape('Box', [0.1] * 3, [0.5, 0.5, 0.5]),
                           'sphere1': _shape('Sphere', 0.1, [0.5, 0, 0])})
        cap = dc.CapsuleChainCollision(robot, link_radius=0.15)
    else:
        robot = dc.BaxterLeftArmFK()
        env = dc.ShapeEnv({
            'table': _shape('Box', [0.8, 0.8, 0.05], [0.7, 0.0, -0.1]),
            'ball': _shape('Sphere', 0.15, [0.4, -0.35, 0.3])})
        cap = dc.CapsuleChainCollision(robot, link_radius=0.07, per_seg=4)
    g = torch.Generator().manual_seed(S)
    qs = robot.rand_configs(S, g, dev)
    sup = robot.fkine(qs).reshape(S, -1).contiguous()
    y = cap.checker_fn(env)(qs).float() * 2 - 1
    with fp32_matmul():
        w = masked_rbf_solve(Polyharmonic(k=1, epsilon=1)(sup, sup), y,
                             torch.ones(S, dtype=torch.bool, device=dev))
    return robot, robot.rand_configs(65536 + 37, g, dev), sup, w.contiguous()


@pytest.mark.parametrize('name,S', LARGE_S_CASES)
def test_dh_score_kernel_on_large_fitted_proxies(cuda, name, S):
    """B1 with 2048 and 4096 supports whose weights cancel against its
    float64 twin: score 1e-4, dq 1e-3 (its per-chunk product-2 sums; one
    accumulator over all supports took dq past half the tolerance at
    S = 4096, PERF.md section 6)."""
    robot, q, sup, w = _fitted_proxy(name, S, cuda)
    spec = fk_score.robot_spec(robot)
    score, dq = fk_score.dh_score_grad(q, sup, w, spec)
    ref, ref_dq = fk_score._dh_score_grad_plain(q.double(), sup.double(),
                                                w.double(), spec)
    _close(score.double(), ref, 1e-4)
    _close(dq.double(), ref_dq, 1e-3)


@pytest.mark.parametrize('kernel', ['B3', 'B2'])
@pytest.mark.parametrize('S', [4096, 8192])
@pytest.mark.parametrize('links', [11, 9])
def test_fp64_kernels_on_large_fitted_proxies(cuda, kernel, S, links):
    """B3 and B2 at FP = 64 and 56 (the marked ropes of 11 and 9 links:
    their configurations, their 21 and 17 points, F = 63 and 51) on
    fitted proxies of 4096 and 8192 supports whose weights cancel,
    against the float64 twins: score 1e-4, dq and dx 1e-3 (per-chunk
    product-2 sums; one accumulator over all supports missed the
    gradient's tolerance up to 4.6x there, PERF.md section 6)."""
    from diffco_tpu_torch.device import fp32_matmul
    from diffco_tpu_torch.kernels import Polyharmonic
    from diffco_tpu_torch.perceptron import masked_rbf_solve
    from diffco_tpu_torch.scripts.ab_kernel import rope_ball_gt
    robot = URDFRobot(robot_data.generate_marked_rope_urdf(n_links=links),
                      device=cuda, setup_acm=False)
    g = torch.Generator().manual_seed(S)
    qs = robot.rand_configs(S, g, cuda)
    sup = robot.fkine(qs).reshape(S, -1).contiguous()
    y = rope_ball_gt(robot)(qs).float() * 2 - 1
    with fp32_matmul():
        w = masked_rbf_solve(Polyharmonic(k=1, epsilon=1)(sup, sup), y,
                             torch.ones(S, dtype=torch.bool, device=cuda))
    w = w.contiguous()
    q = robot.rand_configs(65536 + 37, g, cuda)
    if kernel == 'B3':
        cs = fk_score.robot_chain_statics(robot)
        score, grad = fk_score.chain_score_grad(q, sup, w, cs)
        ref, ref_g = fk_score._chain_score_grad_plain(
            q.double(), sup.double(), w.double(), cs)
    else:
        x = robot.fkine(q).reshape(q.shape[0], -1).contiguous()
        score, grad = fused_score.poly_score_grad(x, sup, w)
        ref, ref_g = fused_score._poly_score_grad_plain(
            x.double(), sup.double(), w.double())
    _close(score.double(), ref, 1e-4)
    _close(grad.double(), ref_g, 1e-3)


def test_mesh_sweep_on_the_card_launches_b1(cuda):
    """A ForwardKinematicsDiffCo on a mesh of one rank (NCCL, world size
    1) fits as the checker without a mesh does, and its sharded
    collision_score sweep (65536 rows: each rank's block through B1)
    equals the unsharded one, score and dq, and launches B1."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch.parallel import make_mesh
    import torch.distributed as dist
    mesh = make_mesh(('dp', 'tp'), (1, 1))
    robot = PandaFK()
    env = dc.ShapeEnv({'box1': _shape('Box', [0.1] * 3, [0.5, 0.5, 0.5]),
                       'sphere1': _shape('Sphere', 0.1, [0.5, 0, 0])})
    gt = dc.CapsuleChainCollision(robot, link_radius=0.15).checker_fn(env)
    out = []
    for m in (mesh, None):
        ck = dc.ForwardKinematicsDiffCo(robot=robot, environment=env,
                                        gt_check_func=gt, seed=0,
                                        device=cuda, mesh=m)
        ck.fit(num_samples=2000)
        q = robot.rand_configs(65536, torch.Generator().manual_seed(3), cuda)
        qg = q.clone().requires_grad_(True)
        before = profiling.counter('launches.dh_score_grad')
        s = ck.collision_score(qg)
        dq, = torch.autograd.grad(s.sum(), qg)
        assert profiling.counter('launches.dh_score_grad') > before
        out.append((ck.perceptron.num_valid, s.detach(), dq))
    dist.destroy_process_group()
    assert out[0][0] == out[1][0]
    _close(out[0][1], out[1][1], 1e-6)
    _close(out[0][2], out[1][2], 1e-6)


def test_warm_start_train_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """DiffCo.train(update=True) on the card, with TF32 allowed for the
    caller's matrix products, equals the same warm start on the CPU from
    one cold state: the warm hypothesis (K @ gains) is computed in
    float32, so the greedy picks do not diverge."""
    from diffco_tpu_torch import kernels as tk
    from diffco_tpu_torch import perceptron as tp
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', True)
    rng = np.random.default_rng(0)
    X0 = rng.uniform(-1, 1, size=(600, 6)).astype(np.float32)
    X1 = rng.uniform(-1, 1, size=(500, 6)).astype(np.float32)

    def labels(X):
        return np.where(np.linalg.norm(X[:, :3] - 0.2, axis=1) < 0.6, 1.0,
                        -1.0).astype(np.float32)
    cold = tp.DiffCo(kernel_func=tk.RQKernel(10.0))
    cold.train(torch.from_numpy(X0), torch.from_numpy(labels(X0)),
               max_iteration=1800)
    nv = cold.num_valid
    X = np.concatenate([X1, cold.support_points[:nv].numpy()])
    em = np.zeros(X.shape[0], bool)
    em[-nv:] = True
    out = {}
    for dev in ('cpu', cuda):
        p = copy.deepcopy(cold)
        for k, v in vars(p).items():
            if torch.is_tensor(v):
                setattr(p, k, v.to(dev))
        p.train(torch.from_numpy(X).to(dev), torch.from_numpy(
            labels(X)).to(dev), update=True, exist_mask=em,
            max_iteration=3 * X.shape[0])
        out[str(dev)] = p
    cpu, card = out['cpu'], out[str(cuda)]
    assert card.train_iterations == cpu.train_iterations
    assert card.num_valid == cpu.num_valid
    _close(card.support_points, cpu.support_points, 1e-6)
    _close(card.gains, cpu.gains, 1e-4)


def test_auto_router_gradient_is_kernel_dq(cuda):
    robot, q, sup, w = _inputs(65536, 512, cuda, seed=2)
    qg = q.clone().requires_grad_(True)
    out = fk_score.fk_polyharmonic_score_auto(qg, robot, sup, w)
    g, = torch.autograd.grad(out.sum(), qg)
    _, dq = fk_score.dh_score_grad(q, sup, w, fk_score.robot_spec(robot))
    _close(g, dq, 1e-6)


def test_float64_batches_take_the_plain_route(cuda):
    """At the gates a float64 CUDA batch takes the plain route, as the
    reference does off the TPU: no kernel launch, real support
    cotangents, the float32 kernel's values."""
    robot, q, sup, w = _inputs(4096, 64, cuda, seed=13)
    before = (profiling.counter('launches.dh_score_grad'),
              profiling.counter('launches.poly_score_grad'))
    st = sup.double().requires_grad_(True)
    out = fk_score.fk_polyharmonic_score_auto(q.double(), robot, st,
                                              w.double())
    gs, = torch.autograd.grad(out.sum(), st)
    x = robot.fkine(q, flat=True).repeat(4, 1).double()
    out_x = fused_score.polyharmonic_score(x, sup.double(), w.double())
    assert (profiling.counter('launches.dh_score_grad'),
            profiling.counter('launches.poly_score_grad')) == before
    assert bool(gs.any())
    ref, _ = fk_score.dh_score_grad(q, sup, w, fk_score.robot_spec(robot))
    _close(out[:, 0].detach().float(), ref, 1e-4)
    _close(out_x[:4096, 0].float(), ref, 1e-4)


def test_kernels_reject_what_they_cannot_take(cuda):
    robot, q, sup, w = _inputs(64, 16, cuda)
    spec = fk_score.robot_spec(robot)
    with pytest.raises(ValueError):
        fk_score.dh_score_grad(q.double(), sup, w, spec)
    with pytest.raises(ValueError):
        fused_score.poly_score_grad(torch.zeros(4, 193, device=cuda),
                                    torch.zeros(3, 193, device=cuda),
                                    torch.zeros(3, device=cuda))
    with pytest.raises(ValueError):
        fused_score.poly_score_grad(sup.T, sup.T, w[:21])


def _chain_inputs(name, B, S, dev, seed=0):
    """``marked_rope.urdf``: robot_data.generate_marked_rope_urdf's 21
    control points on 11 moving joints (FP = 64)."""
    path = (robot_data.generate_marked_rope_urdf() if name ==
            'marked_rope.urdf' else
            os.path.join(robot_data.ensure_default_assets(), name))
    robot = URDFRobot(path, device=dev, setup_acm=False, link_spheres=2)
    g = torch.Generator().manual_seed(seed)
    q = robot.rand_configs(B, g, dev)
    # FK of S configurations; an empty support set keeps its width F
    sup = (robot.fkine(robot.rand_configs(S, g, dev)).flatten(1) if S
           else q.new_zeros(0, robot.fkine(q[:1]).numel()))
    w = (torch.randn(S, generator=g) * 0.05).to(dev)
    return robot, q, sup.contiguous(), w


@pytest.mark.parametrize('name,B,S', CHAIN_CASES)
def test_chain_score_kernel_matches_plain(cuda, name, B, S):
    """B3 against its twin; at S >= 12 configurations 0-11 sit on a
    support or 1e-3 or 1e-2 from one."""
    robot, q, sup, w = _chain_inputs(name, B, S, cuda, seed=3)
    if S >= 12:
        sup = _near_supports(robot, q, sup, seed=S)
    cs = fk_score.robot_chain_statics(robot)
    before = profiling.counter('launches.chain_score_grad')
    score, dq = fk_score.chain_score_grad(q, sup, w, cs)
    torch.cuda.synchronize()
    assert profiling.counter('launches.chain_score_grad') == before + 1
    ref, ref_dq = fk_score._chain_score_grad_plain(q, sup, w, cs)
    if S >= 12:
        _close_near(score, dq, ref, ref_dq)
    else:
        _close(score, ref, 1e-4)
        _close(dq, ref_dq, 1e-3)


def test_chain_score_plan_matches_the_card(cuda):
    """B3's launch plan as its build and the occupancy calculator give it
    equals ops/_native.py::chain_tc_plan's for every P and M the C entry
    takes, and keeps 16 warps per SM at FrankaPanda's shape (P = 8,
    M = 7)."""
    for P in range(1, _native.MAX_CP + 1):
        for M in range(1, _native.MAX_M + 1):
            assert (_native.chain_score_plan_on_card(P, M)
                    == _native.chain_tc_plan(P, M)), (P, M)
    assert _native.chain_score_plan_on_card(8, 7)['warps_per_sm'] >= 16


def test_chain_auto_router_gradient_is_kernel_dq(cuda):
    robot, q, sup, w = _chain_inputs('panda_simple.urdf', 65536, 512, cuda,
                                     seed=4)
    qg = q.clone().requires_grad_(True)
    out = fk_score.fk_polyharmonic_score_auto(qg, robot, sup, w)
    g, = torch.autograd.grad(out.sum(), qg)
    _, dq = fk_score.chain_score_grad(q, sup, w,
                                      fk_score.robot_chain_statics(robot))
    _close(g, dq, 1e-6)


def test_chain_kernel_rejects_what_it_cannot_take(cuda, tmp_path):
    robot, q, sup, w = _chain_inputs('lift_rig.urdf', 64, 16, cuda)
    cs = fk_score.robot_chain_statics(robot)
    with pytest.raises(ValueError):
        fk_score.chain_score_grad(q.double(), sup, w, cs)
    with pytest.raises(ValueError):
        fk_score.chain_score_grad(q, sup[:, :6].contiguous(), w, cs)
    # 70 moving joints: beyond the wide instance's bound of 64 (the
    # tensor-core instance's is 16)
    rope = URDFRobot(robot_data.generate_rope_urdf(
        n_links=70, path=str(tmp_path / 'rope_70.urdf')), device=cuda,
        setup_acm=False, link_spheres=1)
    g = torch.Generator().manual_seed(0)
    qr = rope.rand_configs(64, g, cuda)
    sr = rope.fkine(rope.rand_configs(8, g, cuda)).reshape(8, -1)
    with pytest.raises(ValueError, match='moving joints'):
        fk_score.chain_score_grad(qr, sr.contiguous(),
                                  torch.zeros(8, device=cuda),
                                  fk_score.robot_chain_statics(rope))


def _weights(S, C, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(S, C, generator=g) * 0.05).to(dev)


@pytest.mark.parametrize('B,S,C', DH_MULTI_CASES)
def test_dh_multi_score_kernel_matches_plain(cuda, B, S, C):
    robot, q, sup, _ = _inputs(B, S, cuda, seed=5)
    W = _weights(S, C, cuda, seed=C)
    spec = fk_score.robot_spec(robot)
    before = profiling.counter('launches.dh_multi_score_grad')
    score, dq = fk_score.dh_multi_score_grad(q, sup, W, spec)
    torch.cuda.synchronize()
    assert profiling.counter('launches.dh_multi_score_grad') == before + 1
    assert score.shape == (B, C) and dq.shape == (C, B, 7)
    ref, ref_dq = fk_score._dh_multi_score_grad_plain(q, sup, W, spec)
    _close(score, ref, 1e-4)
    _close(dq, ref_dq, 1e-3)


@pytest.mark.parametrize('name,B,S,C', CHAIN_MULTI_CASES)
def test_chain_multi_score_kernel_matches_plain(cuda, name, B, S, C):
    robot, q, sup, _ = _chain_inputs(name, B, S, cuda, seed=6)
    W = _weights(S, C, cuda, seed=C)
    cs = fk_score.robot_chain_statics(robot)
    before = profiling.counter('launches.chain_multi_score_grad')
    score, dq = fk_score.chain_multi_score_grad(q, sup, W, cs)
    torch.cuda.synchronize()
    assert profiling.counter('launches.chain_multi_score_grad') == before + 1
    assert score.shape == (B, C) and dq.shape == (C, B, q.shape[1])
    ref, ref_dq = fk_score._chain_multi_score_grad_plain(q, sup, W, cs)
    _close(score, ref, 1e-4)
    _close(dq, ref_dq, 1e-3)


def _plans_match_the_card(on_card, max_p):
    for P in range(1, max_p + 1):
        for C in range(1, _native.MAX_C + 1):
            card = on_card(P, C)
            plan = _native.multi_plan(P, C)
            for key in ('instance', 'classes_per_pass', 'passes',
                        'smem_bytes'):
                assert card[key] == plan[key], (P, C, key)
            assert card['warps_per_sm'] >= 16, (P, C, card)


def test_chain_multi_plan_matches_the_card(cuda):
    """B5's launch plan as the built kernel and the occupancy calculator
    give it (the instance its launch rule picks, classes per pass, passes,
    shared bytes) equals ops/_native.py::multi_plan's, and keeps 16 warps
    per SM for every control-point count and class count the C entry
    takes."""
    _plans_match_the_card(_native.chain_multi_plan_on_card, _native.MAX_CP)


def test_dh_multi_plan_matches_the_card(cuda):
    """B4's launch plan, as B5's: the same block, the same mirror, for
    every DH control-point count (P <= 16) and class count."""
    _plans_match_the_card(_native.dh_multi_plan_on_card, _native.MAX_P)


@pytest.mark.parametrize('kind', ['dh', 'chain'])
def test_multi_auto_router_gradient_is_kernel_dq(cuda, kind):
    """A class mix g [B, C] through fk_polyharmonic_multi_score_auto gives
    einsum('bc,cbj->bj', g, dq) of the kernel's dq."""
    if kind == 'dh':
        robot, q, sup, _ = _inputs(65536, 512, cuda, seed=7)
        kernel, spec = fk_score.dh_multi_score_grad, fk_score.robot_spec(robot)
    else:
        robot, q, sup, _ = _chain_inputs('panda_simple.urdf', 65536, 512,
                                         cuda, seed=7)
        kernel = fk_score.chain_multi_score_grad
        spec = fk_score.robot_chain_statics(robot)
    W = _weights(512, 3, cuda, seed=8)
    mix = _weights(65536, 3, cuda, seed=9)
    qg = q.clone().requires_grad_(True)
    out = fk_score.fk_polyharmonic_multi_score_auto(qg, robot, sup, W)
    g, = torch.autograd.grad((out * mix).sum(), qg)
    _, dq = kernel(q, sup, W, spec)
    _close(g, torch.einsum('bc,cbj->bj', mix, dq), 1e-6)


def test_multi_kernels_reject_what_they_cannot_take(cuda):
    robot, q, sup, _ = _inputs(64, 16, cuda)
    spec = fk_score.robot_spec(robot)
    with pytest.raises(ValueError, match='1 to 8'):
        fk_score.dh_multi_score_grad(q, sup, _weights(16, 9, cuda, 0), spec)
    with pytest.raises(ValueError):
        fk_score.dh_multi_score_grad(q, sup, _weights(16, 2, cuda, 0).double(),
                                     spec)
    with pytest.raises(ValueError):
        fk_score.dh_multi_score_grad(q, sup, _weights(15, 2, cuda, 0), spec)
    with pytest.raises(ValueError):      # one weight column is B1's input
        fk_score.dh_multi_score_grad(q, sup, _weights(16, 1, cuda, 0)[:, 0],
                                     spec)
    robot, q, sup, _ = _chain_inputs('lift_rig.urdf', 64, 16, cuda)
    cs = fk_score.robot_chain_statics(robot)
    with pytest.raises(ValueError, match='1 to 8'):
        fk_score.chain_multi_score_grad(q, sup, _weights(16, 9, cuda, 0), cs)


@pytest.mark.parametrize('B,S', ROOFLINE_SHAPES)
@pytest.mark.parametrize('mode', list(rf.MODES))
def test_ablation_kernel_matches_plain(cuda, mode, B, S):
    robot, q, sup, w = _inputs(B, S, cuda, seed=10)
    spec = fk_score.robot_spec(robot)
    before = profiling.counter(f'launches.dh_ablation:{mode}')
    out = rf.dh_ablation(q, sup, w, spec, mode)
    torch.cuda.synchronize()
    assert profiling.counter(f'launches.dh_ablation:{mode}') == before + 1
    ref = rf._dh_ablation_plain(q, sup, w, spec, mode)
    assert out.shape == (B,) and bool(torch.isfinite(out).all())
    err = float((out - ref).abs().max())
    tol = rf.ABLATION_TOL[mode] * float(ref.abs().max())
    assert err <= tol, err
    if mode == 'mv_bf16_full':    # the tolerance would catch no rounding
        f32 = rf._dh_ablation_plain(q, sup, w, spec, 'mv_f32_full')
        assert float((out - f32).abs().max()) > tol


@pytest.mark.parametrize('B,S', ROOFLINE_SHAPES)
@pytest.mark.parametrize('variant', list(ab.VARIANTS))
def test_dual_kernel_matches_plain_and_b1(cuda, variant, B, S):
    robot, q, sup, w = _inputs(B, S, cuda, seed=11)
    spec = fk_score.robot_spec(robot)
    counter = f'launches.dh_dual_score_grad:{variant}'
    before = profiling.counter(counter)
    score, dq = ab.dh_dual_score_grad(q, sup, w, spec, variant)
    torch.cuda.synchronize()
    assert profiling.counter(counter) == before + 1
    for ref, ref_dq in (fk_score._dh_score_grad_plain(q, sup, w, spec),
                        fk_score.dh_score_grad(q, sup, w, spec)):
        _close(score, ref, 1e-4)
        _close(dq, ref_dq, 1e-3)


@pytest.mark.parametrize('threads', rf.SWEEP_THREADS)
def test_b1_block_size_sweep_matches_plain(cuda, threads):
    robot, q, sup, w = _inputs(65536 + 37, 512, cuda, seed=12)
    spec = fk_score.robot_spec(robot)
    score, dq = rf.dh_score_grad_threads(q, sup, w, spec, threads)
    torch.cuda.synchronize()
    ref, ref_dq = fk_score._dh_score_grad_plain(q, sup, w, spec)
    _close(score, ref, 1e-4)
    _close(dq, ref_dq, 1e-3)


def test_roofline_kernels_reject_what_they_cannot_take(cuda):
    robot, q, sup, w = _inputs(64, 16, cuda)
    spec = fk_score.robot_spec(robot)
    with pytest.raises(ValueError):
        rf.dh_ablation(q.double(), sup, w, spec, 'fwd')
    with pytest.raises(ValueError, match='threads'):
        rf.dh_score_grad_threads(q, sup, w, spec, 96)
    with pytest.raises(ValueError, match='variant'):
        ab.dh_dual_score_grad(q, sup, w, spec, variant='dual_pipe_64')
    # four points pad to 16 components: the kernels are built for 24
    four = (spec[0], spec[1][:4], spec[2])
    with pytest.raises(ValueError, match='built for 24'):
        ab.dh_dual_score_grad(q, sup[:, :12].contiguous(), w, four)
    with pytest.raises(ValueError, match='built for 24'):
        rf.dh_ablation(q, sup[:, :12].contiguous(), w, four, 'mxu')


def test_roofline_kernels_run_on_the_tensor_cores(cuda):
    """Every B6 variant and every B7 rung past fk_only has HMMA in its
    SASS (``sass_counts.roofline_hmma`` raises otherwise)."""
    from diffco_tpu_torch.scripts import sass_counts
    hmma = sass_counts.roofline_hmma()
    assert len(hmma) == len(ab.VARIANTS) + len(rf.MODES)
    assert sum(n > 0 for n in hmma.values()) == len(hmma) - 1


def test_roofline_entry_points_on_the_card(cuda, monkeypatch):
    monkeypatch.setattr(rf, 'N_SHORT', 2)
    monkeypatch.setattr(rf, 'N_LONG', 6)
    monkeypatch.setattr(rf, 'REPS', 2)
    res = rf.run('cuda', batch=4096, supports=128)
    assert res['raw_ms']['full_kernel']['long_ms'] > 0
    assert list(res['ladder']) == list(rf.LADDER)
    assert set(res['device_ms']) == {'full_kernel', *rf.MODES}
    assert all(ms > 0 for ms in res['device_ms'].values())
    res = ab.run('cuda', batch=4096, supports=128)
    assert res['prod_device_ms'] > 0
    for v in res['variants'].values():
        assert v['rel_grad_err_vs_prod'] < 1e-3
        assert v['device_ms'] > 0


def _baxter_checkers(cuda):
    """A BaxterLeftArmFK proxy fitted on the CPU (400 configurations,
    labels from a sphere in its workspace) and a checker on the card
    holding the same state."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch.convert import load_reference_state
    robot = dc.BaxterLeftArmFK()

    def gt(q):
        p = robot.fkine(q)
        return (p - torch.tensor([0.5, 0.0, 0.3], device=q.device)).norm(
            dim=-1).amin(-1) < 0.25

    cpu = dc.ForwardKinematicsDiffCo(robot=robot, gt_check_func=gt, seed=0,
                                     device='cpu')
    cpu.fit(num_samples=400)
    p = cpu.perceptron
    arrays = {k: getattr(p, k).numpy() for k in (
        'support_points', 'support_transformed', 'gains', 'hypothesis', 'y',
        'kernel_matrix', 'rbf_nodes', 'valid_mask')}
    arrays.update(num_valid=p.num_valid, epsilon=p.rbf_kernel.epsilon,
                  safety_bias=cpu.safety_bias)
    card = dc.ForwardKinematicsDiffCo(robot=robot, gt_check_func=gt,
                                      device=cuda)
    load_reference_state(card, arrays)
    return robot, cpu, card, gt


def _baxter_paths_close(robot, a, b, atol):
    """Joints 1-6 and the control points (BaxterLeftArmFK's last joint
    moves no control point: its gradient is rounding noise)."""
    a, b = torch.tensor(a), torch.tensor(b)
    _close(a[..., :6], b[..., :6], atol)
    _close(robot.fkine(a.reshape(-1, 7)), robot.fkine(b.reshape(-1, 7)),
           atol)


def test_baxter_optimizers_on_the_card_match_the_cpu(cuda):
    """al_traj_optimize (2 restarts, a jittered init) and
    adam_traj_optimize_batch (3 problems) on the card agree with the same
    calls on the CPU over the same state: paths 1e-3 (joints 1-6 and
    control points), costs rtol 1e-3, success equal."""
    from diffco_tpu_torch import optim
    robot, cpu, card, gt = _baxter_checkers(cuda)
    g = torch.Generator().manual_seed(3)
    q = robot.rand_configs(256, g, 'cpu')
    free = q[~gt(q)]
    starts, targets = free[:3], free[3:6]
    init = (torch.stack([torch.linspace(0, 1, 12)] * 7, 1)
            * (targets[0] - starts[0]) + starts[0]
            + 0.05 * torch.randn(12, 7, generator=g))
    al = {'N_WAYPOINTS': 12, 'NUM_RE_TRIALS': 2, 'outer_iters': 3,
          'inner_iters': 5, 'restore_iters': 20, 'seed': 1,
          'safety_margin': -cpu.safety_bias, 'init_solution': init.numpy()}
    batch = {'N_WAYPOINTS': 12, 'NUM_RE_TRIALS': 2, 'MAXITER': 15,
             'dense_sub': 3, 'seed': 2, 'safety_margin': -cpu.safety_bias}
    runs = []
    for dev, ck in (('cpu', cpu), (cuda, card)):
        fn = ck.score_fn(0.0)
        runs.append([optim.al_traj_optimize(robot, fn, starts[0].to(dev),
                                            targets[0].to(dev), al)]
                    + optim.adam_traj_optimize_batch(
                        robot, fn, starts.to(dev), targets.to(dev), batch))
    for a, b in zip(*runs):
        _baxter_paths_close(robot, a['solution'], b['solution'], 1e-3)
        assert abs(a['cost'] - b['cost']) <= 1e-3 * abs(a['cost']) + 1e-6
        assert a['success'] == b['success']


def test_baxter_collision_score_launches_b1(cuda):
    """collision_score of the fitted Baxter proxy at B = 65536 launches B1
    (FP = 16) and matches the float64 plain twin: score 1e-4, dq 1e-3."""
    robot, _, card, _ = _baxter_checkers(cuda)
    q = robot.rand_configs(65536, torch.Generator().manual_seed(4), cuda)
    before = profiling.counter('launches.dh_score_grad')
    qg = q.clone().requires_grad_(True)
    s = card.collision_score(qg, bias=0.0)
    dq, = torch.autograd.grad(s.sum(), qg)
    assert profiling.counter('launches.dh_score_grad') > before
    p = card.perceptron
    w = p.rbf_nodes * p.valid_mask.to(p.rbf_nodes.dtype) / \
        p.rbf_kernel.epsilon
    ref, ref_dq = fk_score._dh_score_grad_plain(
        q.double(), p.support_transformed.double(), w.double(),
        fk_score.robot_spec(robot))
    _close(s.detach().reshape(-1).double(), ref, 1e-4)
    _close(dq.double(), ref_dq, 1e-3)


def test_score_fn_takes_cpu_float64(cuda):
    """A checker on the card scores a CPU float64 batch (the scipy paths'
    route) in float64 on the CPU, within 1e-5 of the card's float32."""
    robot, _, card, _ = _baxter_checkers(cuda)
    q = robot.rand_configs(64, torch.Generator().manual_seed(5), 'cpu')
    fn = card.score_fn(0.0)
    s64 = fn(q.double())
    assert s64.dtype == torch.float64 and s64.device.type == 'cpu'
    _close(s64, fn(q.to(cuda)).cpu().double(), 1e-5)


def _dh_fk_case(name, B, dev):
    """(the FK closure, the leaf configurations [B, dof] on ``dev``, the
    chain's columns of them)."""
    import diffco_tpu_torch as dc
    g = torch.Generator().manual_seed(B + 7)
    if name == 'dual arm, right':
        robot = dc.BaxterDualArmFK()
        return robot._arm_fkine[1], robot.rand_configs(B, g, dev), \
            slice(7, 14)
    robot = {'Baxter': dc.BaxterLeftArmFK, 'PandaFK': PandaFK,
             'PandaFK chain, 16 points': lambda: panda_with_points(16)
             }[name]()
    return robot._fkine_flat, robot.rand_configs(B, g, dev), slice(0, 7)


def _eager_fk(st, q, g=None):
    """The eager ops of ``_DHFkine``: points [B, 3P], or with point
    cotangents g the VJP dq [B, J]."""
    axes, pts = fk_jvp.dh_chain(st, q)
    if g is None:
        return stack_points(pts, flat=True)
    return fk_jvp.dh_vjp(st, axes, pts, g)


def _launches():
    return (profiling.counter('launches.dh_fk'),
            profiling.counter('launches.dh_fk_vjp'))


@pytest.mark.parametrize('B', DH_FK_BATCHES)
@pytest.mark.parametrize('name', DH_FK_ROBOTS)
def test_dh_fk_kernels_match_the_eager_ops(cuda, name, B):
    """The FK and its VJP of a float32 CUDA batch (``_DHFkine`` through
    autograd, ``create_graph`` off) on csrc/dh_fk.cu, one launch each (none
    for an empty batch), against the eager ops on the same float32 rows
    and in float64 (the Function's eager path): points 1e-5, dq 1e-5 of
    its largest component (float32 rounding over the 7-joint chain)."""
    fk, full, cols = _dh_fk_case(name, B, cuda)
    st = fk.statics
    P = len(st.point_specs)
    full = full.requires_grad_(True)
    g = torch.randn(B, 3 * P, generator=torch.Generator().manual_seed(B),
                    ).to(cuda)
    before = _launches()
    x = fk(full[:, cols])
    mid = _launches()
    dq, = torch.autograd.grad(x, full, g)
    dq = dq[:, cols]
    after = _launches()
    one = int(B > 0)
    assert mid == (before[0] + one, before[1])
    assert after == (mid[0], mid[1] + one)
    q, x = full.detach()[:, cols], x.detach()
    assert torch.isfinite(x).all() and torch.isfinite(dq).all()
    dq_tol = 1e-5 * max(1.0, float(dq.abs().max())) if B else 0.0
    for ref_q, ref_g in ((q, g), (q.double(), g.double())):
        _close(x.double(), _eager_fk(st, ref_q).double(), 1e-5)
        ref = _eager_fk(st, ref_q, ref_g).double()
        np.testing.assert_allclose(dq.double().cpu().numpy(),
                                   ref.cpu().numpy(), rtol=0, atol=dq_tol)
    q64 = q.double().requires_grad_(True)
    x64 = fk(q64)
    dq64, = torch.autograd.grad(x64, q64, g.double())
    assert _launches() == after
    _close(x.double(), x64.detach(), 1e-5)
    np.testing.assert_allclose(dq.double().cpu().numpy(),
                               dq64.cpu().numpy(), rtol=0, atol=dq_tol)


@pytest.mark.parametrize('name', DH_FK_ROBOTS)
def test_dh_fk_higher_orders_keep_the_eager_ops(cuda, name):
    """On a float32 CUDA batch the forward runs on the kernel, but a
    backward with ``create_graph=True`` and forward mode keep the
    differentiable eager VJP and JVP: no VJP launch; the gradient, the
    gradient of its squared norm and the tangent equal the eager ops'
    (1e-5 of the largest component)."""
    import torch.autograd.forward_ad as fwAD
    fk, full, cols = _dh_fk_case(name, 448, cuda)
    st = fk.statics
    P = len(st.point_specs)
    gen = torch.Generator().manual_seed(5)
    g = torch.randn(448, 3 * P, generator=gen).to(cuda)
    v = torch.randn(448, st.n_joints, generator=gen).to(cuda)

    def grads(fn):
        leaf = full.detach().clone().requires_grad_(True)
        dq, = torch.autograd.grad(fn(leaf[:, cols]), leaf, g,
                                  create_graph=True)
        ddq, = torch.autograd.grad((dq ** 2).sum(), leaf)
        return dq.detach()[:, cols], ddq[:, cols]

    def close(a, b):
        tol = 1e-5 * max(1.0, float(b.abs().max()))
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=0, atol=tol)

    before = _launches()
    got = grads(fk)
    assert _launches() == (before[0] + 1, before[1])
    for a, b in zip(got, grads(lambda q: _eager_fk(st, q))):
        close(a, b)
    q = full.detach()[:, cols].contiguous()
    before = _launches()
    with fwAD.dual_level():
        tangent = fwAD.unpack_dual(fk(fwAD.make_dual(q, v))).tangent
    assert _launches() == (before[0] + 1, before[1])
    close(tangent, fk_jvp.dh_jvp(st, *fk_jvp.dh_chain(st, q), v))


def test_dh_fk_kernels_leave_adam_on_baxter_as_the_eager_ops(cuda,
                                                             monkeypatch):
    """adam_traj_optimize (one problem) and adam_traj_optimize_batch (3
    problems) on the card with the FK on its kernels give the eager ops'
    paths (joints 1-6 and control points 1e-3), costs (rtol 1e-3) and
    success, the tolerances of the card-against-CPU parity test; the
    kernels launch only on their own route."""
    from diffco_tpu_torch import optim
    robot, cpu, card, gt = _baxter_checkers(cuda)
    g = torch.Generator().manual_seed(3)
    q = robot.rand_configs(256, g, 'cpu')
    free = q[~gt(q)]
    starts, targets = free[:3].to(cuda), free[3:6].to(cuda)
    opts = {'N_WAYPOINTS': 12, 'NUM_RE_TRIALS': 4, 'MAXITER': 15,
            'dense_sub': 3, 'seed': 2, 'safety_margin': -cpu.safety_bias}
    fn = card.score_fn(0.0)
    runs, launched = [], []
    for route in ('kernels', 'eager'):
        if route == 'eager':
            monkeypatch.setattr(fk_jvp, 'takes_kernel',
                                lambda *a, **k: False)
        before = _launches()
        runs.append([optim.adam_traj_optimize(robot, fn, starts[0],
                                              targets[0], opts)]
                    + optim.adam_traj_optimize_batch(robot, fn, starts,
                                                     targets, opts))
        launched.append([b - a for a, b in zip(before, _launches())])
    assert min(launched[0]) >= 2 * opts['MAXITER'] and launched[1] == [0, 0]
    for a, b in zip(*runs):
        _baxter_paths_close(robot, a['solution'], b['solution'], 1e-3)
        assert abs(a['cost'] - b['cost']) <= 1e-3 * abs(a['cost']) + 1e-6
        assert a['success'] == b['success']



@pytest.mark.parametrize('name', ['givengrad', 'trustconstr'])
def test_dh_fk_scipy_paths_in_float32_on_the_card(cuda, name):
    """With ``scipy_fp64=False`` the scipy paths evaluate BaxterLeftArmFK
    in float32 on the card, their Jacobians vectorized over the outputs:
    the FK's backward gets a cotangent batched by vmap, with no storage,
    and keeps the eager VJP. ``optim._jacobian`` of the FK on the card
    equals the CPU float64 one (1e-5 of its largest entry) with no VJP
    launch, and givengrad_traj_optimize / trustconstr_traj_optimize run
    from a card ``start_cfg`` to a finite cost there."""
    from diffco_tpu_torch import optim
    robot, cpu, card, gt = _baxter_checkers(cuda)
    g = torch.Generator().manual_seed(4)
    q = robot.rand_configs(256, g, 'cpu')
    free = q[~gt(q)]
    x = free[:5].reshape(-1)

    def fk_sum(flat):
        return robot.fkine(flat.reshape(-1, 7), flat=True).sum(0)
    before = _launches()
    jac = optim._jacobian(fk_sum, x.to(cuda))
    assert _launches()[1] == before[1]
    ref = optim._jacobian(fk_sum, x.double())
    np.testing.assert_allclose(jac.double().cpu().numpy(), ref.numpy(),
                               rtol=0, atol=1e-5 * float(ref.abs().max()))
    opts = {'N_WAYPOINTS': 8, 'NUM_RE_TRIALS': 1, 'MAXITER': 10, 'seed': 0,
            'scipy_fp64': False, 'safety_margin': -cpu.safety_bias}
    if name == 'trustconstr':
        opts['free_waypoints'] = 4
    rec = getattr(optim, f'{name}_traj_optimize')(
        robot, card.score_fn(0.0), free[5].to(cuda), free[6].to(cuda), opts)
    assert torch.device(rec['eval_device']).type == cuda.type
    assert rec['eval_dtype'] == 'float32'
    assert np.isfinite(rec['cost'])
    assert np.isfinite(np.asarray(rec['solution'])).all()
