"""The port stands alone: importing diffco_tpu_torch and scoring on the
CPU (a DH robot and a URDF robot) loads neither JAX nor the JAX
package."""
import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

_SCRIPT = r'''
import sys
import torch
torch.set_num_threads(1)
import diffco_tpu_torch as dc
from diffco_tpu_torch.ops import fk_score
robot = dc.PandaFK()
g = torch.Generator().manual_seed(0)
q = robot.rand_configs(8, g, 'cpu')
sup = robot.fkine(robot.rand_configs(16, g, 'cpu'), flat=True)
w = torch.randn(16, generator=g)
s = fk_score.fk_polyharmonic_score_auto(q, robot, sup, w)
assert s.shape == (8, 1) and bool(torch.isfinite(s).all())
robot = dc.FrankaPanda(device='cpu', setup_acm=False, link_spheres=2)
q = robot.rand_configs(8, g)
sup = robot.fkine(robot.rand_configs(16, g)).reshape(16, -1)
s = fk_score.fk_polyharmonic_score_auto(q, robot, sup, w)
assert s.shape == (8, 1) and bool(torch.isfinite(s).all())
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m == 'diffco_tpu'
             or m.startswith('diffco_tpu.'))
print('LOADED', bad)
assert not bad, bad
'''


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, '-c', _SCRIPT], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert 'LOADED []' in out.stdout


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py names neither JAX nor the JAX package in its imports."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, 'chip_smoke.py')) as f:
        lines = [ln.strip() for ln in f]
    imports = [ln for ln in lines if ln.startswith(('import ', 'from '))]
    assert imports
    for ln in imports:
        mod = ln.split()[1]
        assert mod.split('.')[0] not in ('jax', 'diffco_tpu'), ln
