"""The 35-link rope (``RopeRobot``) and its benchmark cell: the plain
chain reference of ``portbench/reference/chain.py`` against the port on
the CPU (FK, ground truth, the proxy's score and gradient), the rope's
route to B3's wide instance, the work and the readers of the cell's
metrics, and the cell (``rope35.sweep_256k``) rehearsed through
``harness/cell.py`` at tiny sizes without JAX. On the card (``python -m
pytest -m cuda tests/test_torch_rope35.py``) the rope's call at the
cell's batch launches the wide instance once, its check holds and the
control fails it."""
import functools
import json
import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import diffco_tpu_torch as dc
from diffco_tpu_torch import profiling
from diffco_tpu_torch.ops import _native, bounds, fk_score
from diffco_tpu_torch.robots.urdf import parse_urdf
from portbench.harness import cell, chain_work, manifest as mf
from portbench.harness import trace as tr
from portbench.reference import chain

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
CELL = 'rope35.sweep_256k'
TINY_FIT = {'fit': {'num_samples': 1000, 'verify_ratio': 0.1}}
TINY_MIX = {'batch': 512, 'pools': 2, 'check_rows': 512,
            'trace_requests': 2}


@pytest.fixture(scope='module')
def rope():
    cfg = mf.config(mf.load(), 'rope35')
    robot = dc.RopeRobot(device='cpu')
    env = dc.ShapeEnv({k: dict(v, transform=np.asarray(v['transform']))
                       for k, v in cfg['scene'].items()})
    gt = cfg['ground_truth']
    cap = dc.CapsuleChainCollision(robot, link_radius=gt['link_radius'],
                                   per_seg=gt['per_seg'])
    q = robot.rand_configs(2000, torch.Generator().manual_seed(1), 'cpu')
    return SimpleNamespace(cfg=cfg, robot=robot, env=env, cap=cap, q=q)


def test_the_configuration_is_the_robot(rope):
    """The configuration's joint table, limits and points are the
    generated rope's: what the reference reads is what the port runs."""
    _, joints, _, _ = parse_urdf(rope.robot.urdf_path)
    table = rope.cfg['robot']['chain']
    assert rope.robot.dof == rope.cfg['robot']['dof'] == len(table) == 35
    for j, row in zip(joints, table):
        assert j['type'] == row['type']
        assert np.allclose(j['origin_trans'], row['xyz'])
        assert np.allclose(j['origin_rot'], np.eye(3)) and row['rpy'] == [0] * 3
        assert np.allclose(j['axis'], row['axis'])
    assert torch.equal(rope.robot.joint_limits, torch.tensor(
        rope.cfg['robot']['limits'], dtype=torch.float32))
    assert rope.robot.unique_position_link_names == tuple(
        f'link{k}' for k, _ in rope.cfg['robot']['points'])


def test_reference_fk_matches_the_port(rope):
    ref = chain.chain_points(rope.q.double(), rope.cfg['robot'])
    port = rope.robot.fkine(rope.q)
    assert ref.shape == port.shape == (2000, 34, 3)
    # the port's float32 FK against float64 over 35 composed rotations, on
    # the same float32 angles
    assert float((port.double() - ref).abs().max()) < 1e-5


def test_reference_ground_truth_matches_the_port(rope):
    cfg = rope.cfg
    ref = chain.signed_dist(rope.q.double(), cfg['robot'],
                            cfg['ground_truth'], cfg['scene'])
    port = rope.cap.signed_dist(rope.q, rope.env).double()
    assert float((port - ref).abs().max()) < 1e-5
    away = ref.abs() > 1e-5
    assert bool(((port > 0) == (ref > 0))[away].all())
    assert 0.7 < float((ref > 0).double().mean()) < 0.95


def test_reference_score_matches_the_port_on_random_supports(rope):
    """Seeded random supports and weights: the one-pass route's plain twin
    (the kernel's arithmetic: FK, score, the moving-ancestor backward) and
    the plain route against the reference's score and its autograd
    gradient in float64."""
    g = torch.Generator().manual_seed(5)
    q = rope.q[:300]
    sq = rope.robot.rand_configs(96, g, 'cpu')
    s = rope.robot.fkine(sq).reshape(96, -1)
    w = torch.randn(96, generator=g)
    cs = fk_score.robot_chain_statics(rope.robot)
    score, dq = fk_score._chain_score_grad_plain(q, s, w, cs)
    qq = q.clone().requires_grad_(True)
    auto = fk_score.fk_polyharmonic_score_auto(qq, rope.robot, s, w)
    gauto, = torch.autograd.grad(auto.sum(), qq)
    qd = q.double().requires_grad_(True)
    rs = chain.score(qd, rope.cfg['robot'], s.double(), w.double(), 1.0)
    rg, = torch.autograd.grad(rs.sum(), qd)
    rs = rs.detach()
    # float32 against float64 on the same float32 inputs: 35 composed
    # rotations, then sums of 96 weighted distances (|w_j| r_j ~ 1 each),
    # each step rounding at ~6e-8 relative (5e-7 of the largest value
    # measured)
    for got, want in ((score, rs), (auto.reshape(-1), rs), (dq, rg),
                      (gauto, rg)):
        err = (got.detach().double() - want).abs().max()
        assert float(err / want.abs().max()) < 1e-5
    assert float(dq[:, -1].abs().max()) == 0.0    # joint 35 moves no point


def test_reference_proxy_matches_the_port_fit(rope):
    cfg = rope.cfg
    ck = dc.ForwardKinematicsDiffCo(
        robot=rope.robot, environment=rope.env,
        gt_check_func=rope.cap.checker_fn(rope.env), seed=0, device='cpu')
    ck.fit(q=rope.q[:1000])
    p = ck.perceptron
    ref = chain.Proxy(p.support_points[:p.num_valid], cfg, cfg['scene'])
    assert bool((ref.y == p.y[:p.num_valid].double()).all())
    qq = rope.q[1000:1500].clone().requires_grad_(True)
    s = ck.collision_score(qq, bias=0.0).reshape(-1)
    g, = torch.autograd.grad(s.sum(), qq)
    rs, rg = ref.score_grad(rope.q[1000:1500])
    # the port solves for its weights in float32, the reference in float64:
    # at these ~170 supports that alone gives ~1e-3 (the reference solved in
    # float32 reads as much)
    assert float((s.detach().double() - rs).abs().max()) < 5e-3
    assert float((g.double() - rg).abs().max() / rg.abs().max()) < 5e-3


def test_the_rope_takes_the_wide_instance(rope):
    cs = fk_score.robot_chain_statics(rope.robot)
    c = fk_score._c_chain_spec(cs)
    assert isinstance(c, _native.ChainSpecWide)
    assert (c.M, c.P, c.D) == (35, 34, 35)
    assert c.M > _native.MAX_M and c.P > _native.MAX_CP
    batch = SimpleNamespace(is_cuda=True, dtype=torch.float32,
                            shape=(262144, 35))
    assert fk_score.chain_score_grad_available(rope.robot, batch)
    assert not fk_score.chain_score_grad_available(rope.robot, rope.q)
    # the benchmark's frozen count of the chain's FK work is the program's
    assert chain_work.chain_ops(rope.cfg['robot']) == bounds.chain_ops(c)


def test_chain_work_by_hand(rope):
    # 35 revolute joints: 161 each; 34 points on frames 2-35: 18 each to
    # place, 6 each for the gradient, 19 per (point, ancestor) pair
    fk = 35 * 161 + 34 * 18 + 34 * 6 + 19 * sum(range(2, 36))
    assert chain_work.chain_ops(rope.cfg['robot']) == fk
    B, S, F, D = 262144, 1500, 102, 35
    t = chain_work.score_grad(B=B, S=S, F=F, D=D, fk_ops=fk)
    assert t['products_s'] == pytest.approx(B * S * (4 * F + 2) / 495e12)
    assert t['elementwise_s'] == pytest.approx((B * S * 9 + B * fk) / 67e12)
    assert t['bytes_s'] == pytest.approx(
        4 * (2 * B * D + B + S * F + S) / 3.35e12)
    assert t['bound_s'] == t['products_s']


def test_the_counter_reads_its_running_total():
    before = profiling.counter('test.rope35')
    profiling.count('test.rope35', 3)
    assert profiling.counter('test.rope35') == before + 3
    assert profiling.counter('test.rope35.never') == 0


REQ = tr.REQUEST
WORK = {'B': 1000, 'S': 100, 'F': 102, 'D': 35, 'fk_ops': 18402}


def _ctx(counts, work=WORK):
    # ns: two calls; device work 300 + 200 ns inside them
    trace = tr.Trace(1e-6, [(10, 310, 'k'), (1100, 1300, 'k')],
                     [(0, 1000, REQ), (1000, 2000, REQ)])
    return SimpleNamespace(trace=trace, counts=counts, work=work,
                           setup_s=1.0, window=None)


def test_the_new_readers_by_hand():
    wide = mf.metric('chain.wide_launches_per_call').read
    assert wide(_ctx({'calls': 4, 'wide_launches': 4})) == 1.0
    assert wide(_ctx({'calls': 4, 'wide_launches': 0})) == 0.0
    roof = mf.metric('score_grad_roofline.chain').read
    bound = chain_work.score_grad(**WORK)['bound_s']
    assert roof(_ctx({'calls': 2})) == pytest.approx(
        100 * bound / (500e-9 / 2))


def test_the_new_readers_find_nothing_on_a_program_without_them():
    """The parent program: no counter of wide launches (the kind leaves
    its count out); a kind whose work has no chain FK count."""
    assert mf.metric('chain.wide_launches_per_call').read(
        _ctx({'calls': 4})) is None
    dh = {'B': 1000, 'S': 100, 'F': 21, 'J': 7, 'P': 7, 'D': 7}
    assert mf.metric('score_grad_roofline.chain').read(
        _ctx({'calls': 2}, dh)) is None


REHEARSE = r'''
import functools, json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
import diffco_tpu_torch as dc
from portbench.harness import cell
# the harness builds the robot by its class name alone; a URDF robot
# holds its tensors on a device, which on the CPU has to be asked for
dc.RopeRobot = functools.partial(dc.RopeRobot, device='cpu')
fit, mix = json.loads(sys.argv[2]), json.loads(sys.argv[3])
out = {}
for name in sys.argv[4:]:
    for traced in (False, True):
        r = cell.run(name, 2 ** 31 + 77, 0.3, traced, 'cpu',
                     time.perf_counter(), mix_overrides=mix,
                     config_overrides=fit)
        out[f'{name} {int(traced)}'] = {
            'correct': r['correct'], 'checks': r['checks'],
            'metrics': {k: v['value'] for k, v in r['metrics'].items()}}
out['forbidden'] = cell.forbidden_modules()
print(json.dumps(out))
'''


def test_the_new_cell_rehearses_on_the_cpu_without_jax():
    p = subprocess.run([sys.executable, '-c', REHEARSE, str(ROOT),
                        json.dumps(TINY_FIT), json.dumps(TINY_MIX), CELL],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out.pop('forbidden') == []
    m = mf.load()
    for key, r in out.items():
        name, traced = key.split()
        assert r['correct'], (key, r['checks'])
        # on the CPU no kernel runs: no roofline, no build of the kernels
        want = {e['name'] for e in mf.metrics_of(m, name, traced == '1')}
        want -= {'score_grad_roofline.chain', 'setup.native_s'}
        assert set(r['metrics']) == want, key
        if traced == '1':
            # below the batch gate the plain route runs: no wide launch
            assert r['metrics']['chain.wide_launches_per_call'] == 0.0


def _chain_sweep():
    return mf.kind('chain_sweep')


@pytest.mark.parametrize('fault', sorted(_chain_sweep().FAULTS))
def test_a_fault_makes_the_rope_cell_incorrect(monkeypatch, fault):
    monkeypatch.setattr(dc, 'RopeRobot',
                        functools.partial(dc.RopeRobot, device='cpu'))
    _chain_sweep().FAULTS[fault](monkeypatch.setattr)
    out = cell.run(CELL, 11, 0.3, True, 'cpu', 0.0,
                   mix_overrides=dict(TINY_MIX, trace_requests=3),
                   config_overrides=TINY_FIT)
    assert out['correct'] is False, out['checks']


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return 'cuda'


@pytest.mark.cuda
def test_the_rope_call_launches_the_wide_instance_once_on_the_card(card):
    """At the cell's batch (262144) each call launches B3's wide instance
    once (its launch count and the ``ops.wide_launches`` counter), the
    cell's check of the calls holds against the float64 chain reference,
    and the control (the reference in float32 with TF32 products) fails
    it."""
    _, mix, _, kind = cell.build(CELL, 20260, card,
                                 mix_overrides={'pools': 2})
    assert mix['batch'] == 262144
    b3 = profiling.counter('launches.chain_score_grad')
    wide = profiling.counter('ops.wide_launches')
    cell.Window(kind, requests=3)
    kind.window_closed()
    assert profiling.counter('launches.chain_score_grad') - b3 == 3
    assert profiling.counter('ops.wide_launches') - wide == 3
    assert kind.counts['wide_launches'] == 3
    limits = mf.limits(CELL)
    sound, checks = cell.verdict(kind.check(), limits)
    assert sound, checks
    numbers = kind.control()
    assert any(v > limits[k] for k, v in numbers.items()), numbers
    assert math.isfinite(numbers['score_gap'])
