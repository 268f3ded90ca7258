"""The plain reference against the port at tiny sizes on the CPU, and
every cell rehearsed on the CPU without JAX."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness import manifest as mf
from portbench.reference import fk, proxy, scene

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ('baxter_dh', 'panda_dh')


def _port(name):
    import diffco_tpu_torch as dc
    cfg = mf.config(mf.load(), name)
    robot = getattr(dc, cfg['robot']['class'])()
    env = dc.ShapeEnv({k: dict(v, transform=np.asarray(v['transform']))
                       for k, v in cfg['scene'].items()})
    cap = dc.CapsuleChainCollision(
        robot, link_radius=cfg['ground_truth']['link_radius'],
        per_seg=cfg['ground_truth']['per_seg'])
    q = robot.rand_configs(2000, torch.Generator().manual_seed(1), 'cpu')
    return dc, cfg, robot, env, cap, q


@pytest.mark.parametrize('name', CONFIGS)
def test_fk_matches_the_port(name):
    _, cfg, robot, _, _, q = _port(name)
    ref = fk.dh_points(q.double(), cfg['robot'])
    assert ref.shape == robot.fkine(q).shape
    assert float((robot.fkine(q).double() - ref).abs().max()) < 1e-6


@pytest.mark.parametrize('name', CONFIGS)
def test_ground_truth_matches_the_port(name):
    _, cfg, _, env, cap, q = _port(name)
    ref = scene.signed_dist(q.double(), cfg['robot'], cfg['ground_truth'],
                            cfg['scene'])
    port = cap.signed_dist(q, env).double()
    assert float((port - ref).abs().max()) < 1e-5
    away = ref.abs() > 1e-5
    assert bool(((port > 0) == (ref > 0))[away].all())
    assert 0.02 < float((ref > 0).double().mean()) < 0.5


@pytest.mark.parametrize('name', CONFIGS)
def test_proxy_matches_the_port(name):
    dc, cfg, robot, env, cap, q = _port(name)
    ck = dc.ForwardKinematicsDiffCo(
        robot=robot, environment=env, gt_check_func=cap.checker_fn(env),
        seed=0, device='cpu')
    ck.fit(q=q[:1000])
    p = ck.perceptron
    sup = p.support_points[:p.num_valid]
    ref = proxy.Proxy(sup, cfg, cfg['scene'])
    assert bool((ref.y == p.y[:p.num_valid].double()).all())
    qq = q[1000:1500].clone().requires_grad_(True)
    s = ck.collision_score(qq, bias=0.0).reshape(-1)
    g, = torch.autograd.grad(s.sum(), qq)
    rs, rg = ref.score_grad(q[1000:1500])
    # the port solves for its weights in float32, the reference in float64
    assert float((s.detach().double() - rs).abs().max()) < 2e-2
    assert float((g.double() - rg).abs().max() / rg.abs().max()) < 2e-2
    fn = ck.score_fn(bias=0.0)
    assert float((fn(q[1000:1500]).double() - rs).abs().max()) < 2e-2


REHEARSE = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
from portbench.harness import cell
from portbench.tests import tiny
out = {}
for name in tiny.MIXES:
    r = tiny.run(cell, name)
    out[name] = {'correct': r['correct'], 'checks': r['checks'],
                 'metrics': sorted(r['metrics'])}
out['forbidden'] = cell.forbidden_modules()
print(json.dumps(out))
'''


def test_every_cell_rehearses_on_the_cpu_without_jax():
    p = subprocess.run([sys.executable, '-c', REHEARSE, str(ROOT)],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out.pop('forbidden') == []
    m = mf.load()
    for name, r in out.items():
        assert r['correct'], (name, r['checks'])
        want = {e['name'] for e in mf.metrics_of(m, name, False)}
        assert set(r['metrics']) == want, name
