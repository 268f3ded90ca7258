"""The port stands alone: importing diffco_tpu_torch, scoring on the CPU
(a DH robot and a URDF robot, one class and two), training a small
MultiDiffCo, running the roofline path's twins (every B7 mode, B6),
importing the kernel-reading scripts, running the augmented
Lagrangian, batched Adam and trust-constr on Baxter's arm, a hybrid
checker's fit, active-learning update, collision and path bands, and the
planar path (a 2-D dataset generated, saved and unpacked, the 2-D
ground truth, the escape and manifold samplers, RRT-Connect and RRT*)
and the rigid-body path (se3, a RigidBody proxy scored, a mesh scene, a
.scene text parsed, a point-cloud world) and the multi-robot, temporal and
host-side modules (MultiURDFRobot, the dynamic ground truth and
PointRobot1D, the legacy checkers, profiling, the native oracle) and the
ROS interface and the mesh path (a world-size-1 gloo mesh: a meshed
checker's fit, score gradient, Adam with options['mesh'], the checkpoint
pair, the lazy distributed fit) load neither JAX nor the JAX package."""
import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

_SCRIPT = r'''
import sys
import numpy as np
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
W = torch.randn(16, 2, generator=g)
s, dq = fk_score.chain_multi_score_grad(q, sup, W,
                                        fk_score.robot_chain_statics(robot))
assert s.shape == (8, 2) and dq.shape == (2, 8, 7)
X = torch.rand(60, 6, generator=g) * 2 - 1
y = torch.stack([X[:, 0] > 0.2, X[:, 1] < -0.3], 1).float() * 2 - 1
p = dc.MultiDiffCo(kernel_func=dc.kernels.RQKernel(10.0))
p.train(X, y, max_iteration=180)
p.fit_poly(target='label')
s = p.poly_score(X[:8])
assert p.num_class == 2 and s.shape == (8, 2)
assert bool(torch.isfinite(s).all()) and p.score(X[:8]).shape == (8, 2)
from diffco_tpu_torch.scripts import ab_dual_tile, roofline_fk_score as rf
from diffco_tpu_torch.scripts import ab_kernel, sass_counts
robot, sup, w = rf.flagship_score_setup(16, device='cpu')
q = robot.rand_configs(8, g, 'cpu')
spec = fk_score.robot_spec(robot)
for mode in rf.MODES:
    out = rf.dh_ablation(q, sup, w, spec, mode)
    assert out.shape == (8,) and bool(torch.isfinite(out).all())
s, dq = ab_dual_tile.dh_dual_score_grad(q, sup, w, spec)
assert s.shape == (8,) and dq.shape == (8, 7)
arm = dc.BaxterLeftArmFK()
qa = arm.rand_configs(2, g, 'cpu')
def dist(p):
    return 0.3 - torch.linalg.norm(arm.fkine(p) - 0.4, dim=-1).amin(-1)
opts = {'N_WAYPOINTS': 5, 'NUM_RE_TRIALS': 2, 'MAXITER': 4, 'seed': 0}
rec = dc.al_traj_optimize(arm, dist, qa[0], qa[1], dict(opts, restore_iters=3))
recs = dc.adam_traj_optimize_batch(arm, dist, qa[:1], qa[1:], opts)
rec = dc.trustconstr_traj_optimize(arm, dist, qa[0], qa[1], opts)
assert rec['eval_dtype'] == 'float64' and len(recs) == 1
env = dc.ShapeEnv({'ball': {'type': 'Sphere', 'params': {'radius': 0.2},
                             'transform': [[1, 0, 0, 0.4], [0, 1, 0, 0.2],
                                           [0, 0, 1, 0.3], [0, 0, 0, 1]]}})
cap = dc.CapsuleChainCollision(dc.PandaFK(), link_radius=0.1)
ck = dc.HybridForwardKinematicsDiffCo(robot=dc.PandaFK(),
                                      gt_check_func=cap.checker_fn(env),
                                      device='cpu')
ck.fit(num_samples=200)
ck.update(num_samples=40, verify=0.2)
qs = dc.PandaFK().rand_configs(16, g, 'cpu')
assert ck.collision(qs).shape == (16,)
from diffco_tpu_torch.sampler import path_band_samples
band = path_band_samples([qs[:4].numpy()], dc.PandaFK().limits.numpy(),
                         np.random.default_rng(0), n_total=64)
assert band.shape == (64, 7)
import os, tempfile
from diffco_tpu_torch import routines
from diffco_tpu_torch.envs.presets2d import get_env
arm = dc.RevolutePlanarRobot(3.5, link_width=0.3, dof=2)
data = routines.autogenerate_2d_dataset(64, dof=2, link_length=3.5,
                                        obstacles=get_env('2class_1'),
                                        label_type='class', device='cpu')
with tempfile.TemporaryDirectory() as d:
    routines.save_dataset(data, os.path.join(d, 'd.npz'))
    cfgs, labels, dists, obs, arm2 = routines.unpack_dataset(
        os.path.join(d, 'd.npz'), device='cpu')
assert labels.shape == (64, 2) and arm2.dof == 2
world = dc.Obstacles2D.from_obstacle_list(get_env('1rect_1circle'))
def sd(qq):
    return dc.planar_robot_signed_dist(arm, world, qq).amax(-1)
grid = routines.generate_unified_grid(8, 8, device='cpu')
qe = dc.OptimSampler(arm, sd, lr=0.1, max_steps=3).optim_escape(grid[:4])
from diffco_tpu_torch.sampler import uniform_sample_on_transformed_manifold
qm = uniform_sample_on_transformed_manifold(
    arm, lambda qq: arm.fkine(qq)[:, -1], 16, g, device='cpu')
coll = lambda qq: sd(qq) > 0
free = grid[~coll(grid)]
path = dc.MotionPlanner(arm, coll, device='cpu').plan(
    free[0].numpy(), free[-1].numpy(), max_iters=64)
star = dc.RRTStar(arm, coll, score_fn=sd, device='cpu').plan(
    free[0].numpy(), free[-1].numpy(), max_iters=20)
assert qe.shape == (4, 2) and qm.shape == (16, 2)
from diffco_tpu_torch import se3
from diffco_tpu_torch.envs import panda_envs, moveit_scene, collision_env
from diffco_tpu_torch.geometry.mesh import load_mesh
body = dc.RigidBody.from_vertices(
    load_mesh('robot_data/generated/torus.stl')[0])
qb = body.rand_configs(64, g, 'cpu')
rp = dc.DiffCo(kernel_func=dc.kernels.RQKernel(10.0),
               transform=lambda x: body.fkine(x))
rp.train(qb, (qb[:, 0] > 0).float() * 2 - 1, max_iteration=192)
rp.fit_poly(target='label')
assert rp.poly_score(qb[:8]).shape == (8, 1)
assert se3.log_se3(se3.exp_se3(qb)).shape == (64, 6)
menv = dc.ShapeEnv({'torus': {'type': 'Mesh', 'params': {
    'file_obj': 'robot_data/generated/torus.stl', 'scale': 0.5}}},
    mesh_spheres=4)
assert menv.scene.point_sdf_per_object(qb[:, :3]).shape == (64, 1)
name, shapes = moveit_scene.parse_scene_text(
    'w\n* b\n1\nsphere\n0.1\n0 0 0\n0 0 0 1\n0 0 0 0\n.\n')
assert name == 'w' and shapes['b']['type'] == 'Sphere'
assert dc.PCDEnv(np.zeros((5, 3))).scene.n_objects == 5
from diffco_tpu_torch import native, profiling, legacy, dynamics
two = [dc.TwoLinkRobot(device='cpu', setup_acm=False) for _ in range(2)]
multi = dc.MultiURDFRobot(two)
qm = multi.rand_configs(8, g, 'cpu')
assert multi.fkine(qm).shape[0] == 8 and multi.collision(qm).shape == (8,)
gt = dc.Dynamic1DChecker([(dc.LinearMotion(0.5, 2.0), 0.6),
                          (dc.SineMotion(2.0, 0.8, 0.0, 7.0), 0.5)],
                         device='cpu')
xt, lab, _ = dc.temporal_dataset(gt, [[0, 10], [0, 10]], 32, g)
pr = dc.PointRobot1D([[0, 10], [0, 10]])
sd_chk = dc.Simple1DDynamicChecker(
    [dc.Simple1DDynamicObstacle(1.2, dc.LinearMotion(0.5, 2.0))], pr,
    device='cpu')
assert sd_chk.predict(pr.normalize(xt))[0].shape == (32, 1)
fc = dc.FCLChecker([dc.FCLObstacle('circle', (1.5, 1.0), 0.6)],
                   robot=arm, device='cpu')
assert fc.predict(grid[:4])[0].shape == (4, 1)
timers = profiling.Timers()
with timers.span('x', block=True):
    pass
assert native.available()
centers = np.zeros((2, 1, 3))
assert native.spheres_vs_scene(centers, np.ones(1),
                               native.NativeScene(env.scene)).shape == (2,)
from diffco_tpu_torch import ros_interface
from diffco_tpu_torch.parallel import make_mesh, sharding
assert not ros_interface._HAS_ROS
mesh = make_mesh(('dp', 'tp'), (1, 1), device_type='cpu')
mck = dc.ForwardKinematicsDiffCo(robot=dc.PandaFK(),
                                 gt_check_func=cap.checker_fn(env),
                                 device='cpu', mesh=mesh)
mck.fit(num_samples=200)
mq = qs.clone().requires_grad_(True)
torch.autograd.grad(mck.collision_score(mq).sum(), mq)
rec = dc.adam_traj_optimize(dc.PandaFK(), mck.score_fn(), qs[0], qs[1],
                            dict(opts, mesh=mesh))
with tempfile.TemporaryDirectory() as d:
    routines.save_checker_dcp(mck.perceptron, os.path.join(d, 'ck'))
    routines.load_checker_dcp(dc.DiffCo(), os.path.join(d, 'ck'),
                              device='cpu')
gl = sharding.distributed_fit_lazy(dc.kernels.RQKernel(5.0), X, X[:, 0],
                                   mesh, max_iteration=20)
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
