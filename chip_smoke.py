"""Smoke run of the PyTorch/CUDA port on one CUDA card: python3 chip_smoke.py

Builds the hand-written kernels from csrc/, holds each against its plain
PyTorch twin at the main paths' shapes (B3 and B5 on three URDF robots: a
serial arm, a branching tree and a prismatic + mimic rig, B5 with five
and eight classes, B3 also on a marked rope with 21 control points; B4
with two and five classes; B1 and B4 also at their FP = 16 and 8
instances, on Baxter's arm with 4 and 2 control points, and at FP = 32,
40 and 48 on PandaFK's chain with more points, B2 at every FP = 8-64; B1,
B2 and B3 with rows whose points sit on a support or 1e-3 and 1e-2 from
one; B1 on fitted proxies of 2048 and 4096 supports against its float64
twin, and B2 and B3 at FP = 64 and 56 (the marked ropes of 11 and 9
links) on fitted proxies of 4096 and 8192; B2 also at F = 2, 4 and 14,
the first two on its fp64 instance,
and at F = 72, 102, 150 and 192 on its wide instance; the FK kernels'
wide instance, for chains past their own bounds, as B1 and B4 launch it
on a 9-joint DH chain and B3 and B5 on the 35-link rope; every wide
instance with DMMA, the fp64 tensor cores' mma, in its SASS; the DH FK
and its VJP (csrc/dh_fk.cu, ``_DHFkine``'s route on a float32 CUDA batch)
against the eager ops in float32 and float64 on Baxter's arm at B = 448
and 28672, PandaFK, PandaFK's chain with 16 points and the dual arm's
right chain; the greedy trainer's kernel (csrc/greedy_train.cu) against
its eager loop, bit for bit, on a warm-started update with padded rows at
N = 820, fits at 4500 and 9000, a cut before done, C = 3 at N = 16384 and
an oscillating pair that never finishes; every instance of each kernel
within its launch bound's registers and unspilled), then drives eleven
paths through the entry points a user calls:

- PandaFK: ShapeEnv scene -> ForwardKinematicsDiffCo.fit -> verify /
  collision_score sweeps -> Adam trajectory optimization -> ground-truth
  check of the dense paths;
- the README quick start: FrankaPanda (URDF, sphere model, ACM) in the
  4-shape scene with its own ground truth -> fit -> the same sweeps ->
  Adam trajectory optimization -> ground-truth check;
- PandaFK multi-class: a MultiDiffCo proxy over two obstacle classes
  (box, sphere) -> fit -> verify -> collision_score [B, 2] sweeps with a
  class-mixed gradient -> Adam trajectory optimization on the max over
  classes -> ground-truth check (any class);
- FrankaPanda multi-class at the quick start's width: five classes
  (self-collision and each of the 4 shapes) -> fit -> verify -> the
  [B, 5] sweeps;
- the Baxter benchmarks' journey (scripts/baxter_trajopt_benchmark.py,
  scripts/batch_trajopt_bench.py): BaxterLeftArmFK in their table / pole /
  ball scene -> fit -> verify / collision_score sweeps (B1 and B2 at
  FP = 16) -> 64 problems in one adam_traj_optimize_batch (the FK and its
  VJP on csrc/dh_fk.cu) -> ground-truth
  check -> a batched repair against the ground truth's signed distance ->
  al_traj_optimize on 2 problems -> SLSQP and trust-constr on one problem
  each (their derivatives on CPU float64, the scipy paths' route) -> one
  Weighted.step;
- PandaFK active learning (scripts/active_2d.py's updates, on the
  panda_world scene with a moving sphere): HybridForwardKinematicsDiffCo
  fit -> ten obstacle moves, each with the ground truth rebound and an
  update, the proxy's agreement with the moved scene before and after ->
  Adam before and after a path-targeted update on its solutions -> the
  sweeps (B1, B2) at the final supports -> the hybrid recheck and
  OptimisticChecker.in_collision;
- the paper's 2-D planar path (scripts/escape_2d.py, scripts/trajopt_2d.py
  --init rrt and scripts/narrow_fk_study.py at their own sizes): a 2-DOF
  q-space DiffCo in 1rect_1circle -> its score map on the 400 x 400
  unified grid (B2 at F = 2, held to the float64 twin and the ground
  truth) -> OptimSampler's escape against resampling; the 2class_1
  dataset (autogenerate_2d_dataset) -> a MultiDiffCo -> RRT-Connect on
  the ground truth seeding Adam -> RRT* with the proxy's edge costs; a
  7-DOF DiffCo over the arm's joint positions in 7d_narrow (300 boxes)
  -> holdout -> a 65536 sweep with its gradient (B2 at F = 14, held to
  the float64 twin) -> FK-manifold sampling through the checker -> Adam
  on the staged pairs;
- the rigid-body and scene-file path (scripts/trajopt_se3.py with the
  probe body and with --mesh torus.stl, scripts/trajopt_se2.py, at their
  own sizes; tests/test_moveit_scene_e2e.py's .scene journey): a DiffCo
  over an SE(3) body's keypoints in the script's world -> holdout -> a
  65536 sweep with its gradient (B2 at F = 9, and F = 24 for the torus,
  whose world adds the lbracket mesh as an obstacle, held to the float64
  twin) -> Adam -> the ground truth on the path; the same for the SE(2)
  L-shape's q-space DiffCo (B2 at F = 3, its fp64 instance); the .scene
  file -> load_moveit_scene -> FrankaPanda fit -> verify / the sweeps (B3,
  B2) -> Adam; then se3's exp / log maps and geodesic interpolation on
  the card against the float64 CPU results;
- the multi-robot, temporal and rope path: two FrankaPandas as one
  MultiURDFRobot around a post -> fit -> verify -> a 65536 sweep with its
  gradient (B2 at F = 48, held to the float64 twin) -> Adam on one problem
  -> its dense path's ground truth on the card against the native host
  oracle -> Adam steps inside profiling.trace (the card's busy share);
  scripts/temporal_1d.py (PointRobot1D among two moving intervals, a
  TemporalFKKernel DiffCo) -> holdout -> its space-time grid (B2 at F =
  2) -> the legacy Simple1DDynamicChecker; the 35-link rope -> fit on
  10000 -> the 65536 sweeps: from configurations through B3's wide
  instance (35 moving joints, 34 points), from points through B2's wide
  instance at F = 102, each held to the float64 twin;
- the mesh path: the PandaFK journey on a torch.distributed mesh of one
  rank (NCCL) -> ForwardKinematicsDiffCo(mesh=...) fit -> verify -> the
  65536 sweep with its gradient (B1 on the rank's rows), held to the
  same checker without a mesh and to the float64 twin -> Adam with
  options['mesh'] and the ground-truth check -> distributed_fit_lazy on
  65536 rows -> a save_checker_dcp / load_checker_dcp round trip;
- the roofline path at bench.py's primitive shape (PandaFK, B = 65536,
  S = 512): ``diffco_tpu_torch.scripts.roofline_fk_score.run`` (B1's
  bench step and kernel, the B7 ablation ladder, the B1 block-size sweep)
  and ``diffco_tpu_torch.scripts.ab_dual_tile.run`` (B1 against the B6
  dual half-tile variants), each result printed as a JSON line.

Before the paths it holds B6 (every variant) against the B1 kernel and
B1's plain twin, B1 at each block size of the sweep against the twin,
and each B7 mode against its plain twin, at B = 65536 + 37, S = 512, and
reads from the SASS that every B6 variant and every B7 rung past fk_only
runs its products on the tensor cores (HMMA).

On the PandaFK and FrankaPanda paths' fitted sweeps it also prints the
share of pairs that the near-pair guard of the tensor-core kernels
recomputes, and the kernel's error there, for several thresholds (their
measurement builds): B1 and B2 on PandaFK, B3 and B2 on FrankaPanda.

Each path's launches are the change of the ``launches.<kernel>`` counters
(``profiling.counters``) over it, which shows that its sweeps went through
its kernels and its fits and updates through the greedy trainer's
(``launches.greedy_train``).
Then it times each kernel and its plain twin with CUDA events.

Prints the device, the card's name and power limit (nvidia-smi), one
line per phase, a ``{"kernels": [...]}`` JSON line, and last
``{"ok": true, "device": {...}}``. Any failed phase raises: the script
exits non-zero and prints no result. Without a CUDA card it exits 1
before doing anything.
"""
import collections
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

from diffco_tpu_torch import profiling
from diffco_tpu_torch.ops.bounds import (ablation_tc_bound,
                                         ablation_tc_times, ablation_work,
                                         bound, chain_ops, chain_tc_bound,
                                         chain_wide_bound, dh_ops,
                                         dh_tc_bound, dh_tc_times,
                                         fk_score_bytes, poly_bytes,
                                         poly_tc_bound, poly_wide_bound,
                                         score_ops, tc_bound, tc_times)
from diffco_tpu_torch.robots.analytic import baxter_arm

# the main path's shapes (bench.py's primitive: B = 65536, S = 512)
B_BENCH = 65536
B_RAGGED = B_BENCH + 37          # a ragged end for the kernel checks
S_BENCH = 512
B_CHAIN_SMALL = 4096 + 5          # B3 and B5 on the tree and the mimic rig
S_CHAIN_SMALL = 128
S_URDF_MULTI = 1024              # FrankaPanda's 5-class proxy: 973 supports
# B1 and B4 at their FP = 16 and FP = 8 instances (the kernels dispatch on
# 3P padded to a multiple of 8): Baxter's arm with 4 and 2 control points,
# at B_CHAIN_SMALL, S_CHAIN_SMALL; no DH robot of the repo reaches FP >= 32
BAXTER_MASKS = {16: (True, False, True, False, True, False, True),
                8: (False, False, True, False, False, False, True)}
# B1 at FP = 32, 40 and 48 (no DH robot of the catalogue reaches them):
# PandaFK's chain with 10, 13 and 16 control points
WIDE_POINTS = (10, 13, 16)
# B2 at each of its FP instances (8, 16, ..., 64), at an F that pads to it
# (64: the full row, where product 2 takes an extra column tile), at the
# planar path's widths: F = 2 (the 2-DOF q-space proxies) and 14 (the
# 7-DOF arm's joint positions), with 4 beside them, and on its wide
# instance at F = 72 (three Panda arms), 102 (the 35-link rope) and 192
# (its bound)
POLY_FS = (2, 4, 5, 13, 14, 21, 32, 37, 48, 53, 64, 72, 102, 150, 192)
# the near-pair guard's thresholds measured on the fitted PandaFK and
# FrankaPanda sweeps, from q and from points (csrc/tc_score_block.cuh;
# ops/_native.py::TC_GUARD, its kTcGuard, is the production one)
GUARD_KAPPAS = (0.0, 1 / 1024, 1 / 256, 1 / 64, 1 / 16, 1 / 4)
# B4 on PandaFK (FP = 24): C <= 2 takes the block's register instance, 3-5
# one full pass, 8 two; on Baxter's arm each instance at FP = 16 and 8
# (register, narrow, full: C <= 2, 3, more at FP = 16; <= 5, <= 7, 8 at
# FP = 8)
DH_MULTI_CLASSES = (1, 2, 3, 5, 8)
BAXTER_MULTI_CASES = ((16, 2), (16, 3), (16, 5), (8, 5), (8, 6), (8, 8))
# B4 at FP = 32, 40 and 48 (PandaFK's chain with WIDE_POINTS points): the
# narrow instance at C = 1, one full pass at C = 2, two or three at C = 5
WIDE_MULTI_CLASSES = (1, 2, 5)
# B1 on proxies of this many supports, with weights that cancel as a
# fitted proxy's do (_fitted_proxy), held to the float64 twin
LARGE_S = (2048, 4096)
# B2 and B3 at FP = 64 and 56 on fitted proxies of the marked ropes
TC_LARGE_S = (4096, 8192)
TC_ROPE_LINKS = (11, 9)
FIT_SAMPLES = 5000               # ForwardKinematicsDiffCo.fit's default
URDF_FIT_SAMPLES = 3000          # the README quick start's
# The URDF trajopt departs from the README's options in two places. 83 %
# of FrankaPanda's random configurations collide (mostly self-collision of
# the generated sphere model), and the 3000-sample proxy leaves
# free-looking holes there that every optimized path finds: no
# ground-truth-valid path on the 4 problems, in this package or in the JAX
# reference (PERF.md, section 6). So it refits on the dense trainer's largest
# size (14400 training rows), and checks the path at the density the
# ground truth checks it (10 points per segment, not 4), which took every
# path clear of the scene on the card.
URDF_TRAJ_FIT_SAMPLES = 16000
URDF_TRAJ_DENSE_SUB = 10
VERIFY_SAMPLES = 16384
LINK_RADIUS = 0.15
N_PROBLEMS = 4
# the PandaFK multi-class path's trajopt runs its first N_MULTI_PROBLEMS
# problems (4 before the planar path was added: the run's depth cut)
N_MULTI_PROBLEMS = 2
TRAJ_OPTIONS = {'N_WAYPOINTS': 20, 'NUM_RE_TRIALS': 8, 'MAXITER': 300,
                'max_speed': 2.0, 'dense_sub': 4, 'history': False}
# The Baxter benchmarks' journey (scripts/baxter_trajopt_benchmark.py,
# scripts/batch_trajopt_bench.py): their scene, ground truth and options.
# The batch and its repair run all N_BATCH problems, AL the first N_AL,
# SLSQP and trust-constr one each with SCIPY_OPTIONS (one restart).
BAXTER_LINK_RADIUS = 0.07
N_BATCH = 64
N_AL = 2
BAXTER_TRAJ = {'N_WAYPOINTS': 20, 'NUM_RE_TRIALS': 8, 'MAXITER': 200,
               'max_speed': 2.0, 'dense_sub': 3, 'seed': 0}
REPAIR_TRAJ = {'NUM_RE_TRIALS': 1, 'MAXITER': 200, 'safety_margin': -0.03,
               'dense_sub': 8}
SCIPY_OPTIONS = {'NUM_RE_TRIALS': 1, 'MAXITER': 200}
TC_FREE_WAYPOINTS = 8
WEIGHTED_STEPS = 50
# The active-learning path (scripts/active_2d.py's 10 updates at
# --num-update 300 with a 0.2 verify split, on PandaFK in the moving
# panda_world scene): sphere1 moves along x from ACTIVE_X[0] to
# ACTIVE_X[1] at y = 0.3, z = 0.4 in ACTIVE_MOVES steps; each step's proxy
# is held to the moved scene's ground truth on ACTIVE_SWEEP
# configurations. Then ACTIVE_PROBLEMS Adam problems before and after a
# path-targeted update of ACTIVE_EXPLOIT samples, and the hybrid recheck
# on ACTIVE_RECHECK configurations.
ACTIVE_MOVES = 10
ACTIVE_X = (0.5, -0.3)
ACTIVE_YZ = (0.3, 0.4)
ACTIVE_UPDATE_SAMPLES = 300
ACTIVE_VERIFY = 0.2
ACTIVE_SWEEP = 65536
ACTIVE_PROBLEMS = 2
ACTIVE_EXPLOIT = 1024
ACTIVE_RECHECK = 16384
# The planar path, at the reference scripts' own sizes. Escape
# (scripts/escape_2d.py's defaults): a 2-DOF arm (links 3.5, width 0.3) in
# 1rect_1circle, a q-space DiffCo on ESCAPE_TRAIN ground-truth labels
# (3N iterations), its score map on generate_unified_grid(GRID, GRID)
# (B2 at F = 2), and OptimSampler on ESCAPE_N colliding configurations.
# 2-D trajopt (scripts/trajopt_2d.py --init rrt): 2class_1, a MultiDiffCo
# on TRAJ2D_SAMPLES class labels, RRT-Connect on the ground truth seeding
# Adam (PLANAR_TRAJ), and RRT* with the proxy's edge costs. The 7-DOF FK
# features (scripts/narrow_fk_study.py's FK variant): 7d_narrow's 300
# boxes, a DiffCo over the joint positions (F = 14) on NARROW_TRAIN
# samples fitted to their distances, a holdout, a FITTED_SWEEP sweep (B2
# at F = 14), FK-manifold sampling and Adam on the staged pairs.
PLANAR_LINK = 3.5
PLANAR_WIDTH = 0.3
ESCAPE_TRAIN = 4000
ESCAPE_N = 256
ESCAPE_OPTIONS = {'lr': 0.1, 'max_steps': 60, 'stop_bias': 1.0}
ESCAPE_MIN_FREE = 0.8                 # tests/test_sampler_planning.py:38
GRID = 400
PLANAR_SEED = 1917
TRAJ2D_SAMPLES = 8000
PLANAR_TRAJ = {'N_WAYPOINTS': 20, 'NUM_RE_TRIALS': 10, 'MAXITER': 200,
               'safety_margin': 0.0, 'max_speed': 2.0, 'dense_sub': 4,
               'history': False, 'seed': PLANAR_SEED}
RRT = {'step_size': 0.5, 'max_iters': 4000, 'batch': 64}
RRT_STAR = {'step_size': 0.5, 'radius': 1.0, 'max_iters': 600,
            'goal_tol': 0.5}
NARROW_DOF = 7
NARROW_TRAIN = 6000
NARROW_HOLDOUT = 2000
FITTED_SWEEP = 65536             # the planar narrow and rigid-body sweeps
MANIFOLD_SAMPLES = 4096
NARROW_CONFIGS = 'benchmarks/test_configs/test_configs_7d_narrow_7d.json'
# The rigid-body path, at the reference scripts' own sizes. SE(3)
# (scripts/trajopt_se3.py's defaults): the probe body (three spheres of
# 0.18, keypoints their centres, F = 9) and, with --mesh torus.stl, the
# torus (16 spheres of its mesh, keypoints its 8 bounding-box corners, F =
# 24) in the script's four-shape world (the torus run adds the lbracket
# mesh as a fifth obstacle), a DiffCo over the keypoints on RIGID_SAMPLES
# distances, a RIGID_HOLDOUT holdout, a FITTED_SWEEP sweep (B2), Adam
# (SE3_TRAJ). SE(2) (scripts/trajopt_se2.py's defaults): the L-shaped
# RigidPlanarBody among three obstacles, a q-space DiffCo (F = 3) the same
# way. The .scene file: tests/test_moveit_scene_e2e.py's text and options
# at the README quick start's fit size (B3, B2). Then se3's maps on
# SE3_TWISTS twists.
RIGID_SAMPLES = 6000
RIGID_HOLDOUT = 2000
RIGID_MIN_ACC = 0.9
SE3_LIMITS = [[-3, 3]] * 3 + [[-math.pi, math.pi]] * 3
SE3_TRAJ = {'N_WAYPOINTS': 20, 'NUM_RE_TRIALS': 8, 'MAXITER': 300,
            'history': False, 'safety_margin': -0.3, 'max_speed': 2.0,
            'seed': 0, 'dense_sub': 4}
PROBE = [[-0.3, 0, 0], [0, 0, 0], [0.3, 0, 0]]
PROBE_RADIUS = 0.18
TORUS = 'robot_data/generated/torus.stl'
BRACKET = {'type': 'Mesh', 'params': {
    'file_obj': 'robot_data/generated/lbracket.stl', 'scale': 2.0}}
BRACKET_AT = (1.5, -1.5, -1.0)
SE2_BODY = [((0.0, 0.0), (1.0, 0.25)), ((0.75, 0.0), (0.25, 0.75))]
SE2_OBSTACLES = [('rect', (4, 4), (3, 3), 0), ('circle', (-4, -4), 2.0, 1),
                 ('rect', (-4, 4), (2, 4), 1)]
SE2_LIMITS = [[-8, 8], [-8, 8], [-math.pi, math.pi]]
SE2_TRAJ = dict(SE3_TRAJ, safety_margin=-0.2)
SCENE_FIT = 3000
SCENE_TRAJ = {'N_WAYPOINTS': 8, 'NUM_RE_TRIALS': 2, 'MAXITER': 60,
              'seed': 5, 'dense_sub': 3}
SE3_TWISTS = 65536
# The multi-robot, temporal and rope path. Dual arm: two FrankaPandas
# (gripper, ACM), the second base DUAL_BASE_X along x and turned pi about
# z, a post of DUAL_POST between the bases; fit DUAL_FIT (limit TPR >=
# DUAL_MIN_TPR, tests/test_checkers2.py:156's), verify, a FITTED_SWEEP
# sweep (B2 at F = 48), Adam on one problem at TRAJ_OPTIONS, the dense
# path against the native oracle, DUAL_TRACE_STEPS steps inside
# profiling.trace. Temporal (scripts/temporal_1d.py at its sizes):
# TEMPORAL_SAMPLES samples, 3 N greedy iterations, acc on TEMPORAL_TEST (limit
# TEMPORAL_MIN_ACC, tests/test_dynamics_profiling.py:48's), the
# TEMPORAL_GRID^2 space-time grid (B2 at F = 2). Rope: the 35-link rope of
# robot_data.generate_rope_urdf in tests/test_rope.py's two obstacles, fit
# ROPE_FIT (the reference's 10000; limit TPR >= 0.9), the B_BENCH sweeps
# (B3's wide instance from q, B2 at F = 102 from the points).
DUAL_BASE_X = 1.0
DUAL_POST = {'radius': 0.1, 'height': 1.0, 'at': (0.5, 0.0, 0.5)}
DUAL_FIT = 3000
DUAL_MIN_TPR = 0.85
DUAL_TRACE_STEPS = 5
NATIVE_TOL = 1e-4                 # tests/test_native.py's
TEMPORAL_LIMITS = [[0.0, 10.0], [0.0, 10.0]]
TEMPORAL_SAMPLES = 4000
TEMPORAL_TEST = 2000
TEMPORAL_MIN_ACC = 0.9
TEMPORAL_GRID = 200
ROPE_LINKS = 35
# the mesh path (mesh_journey)
MESH_PROBLEMS = 2
MESH_LAZY_ROWS = 65536
MESH_LAZY_ITERS = 1000
ROPE_FIT = 10000
# the rope's sweeps against float64 on the wide instances' first design
# (PERF.md section 6, PR 16's table; B2's on its own float32 points):
# printed beside this run's
ROPE_PR16_ERRS = dict(score_p=1.2e-7, dx=2.2e-7, score_q=1.0e-6, dq=1.9e-6)
# tests/test_moveit_scene_e2e.py:17-49: a box, a sphere, an inline mesh
MOVEIT_SCENE = """\
panda_world
* shelf
1
box
0.25 0.5 0.03
0.45 0.0 0.45
0 0 0 1
0 0 0 0
* ball
1
sphere
0.09
0.35 -0.35 0.55
0 0 0 1
0 0 0 0
* wedge
1
mesh
4 4
0 0 0
0.12 0 0
0 0.12 0
0 0 0.12
0 1 2
0 1 3
0 2 3
1 2 3
0.3 0.35 0.3
0 0 0 1
0 0 0 0
.
"""
def _phase(name, t0, **info):
    fields = ' '.join(f'{k}={v}' for k, v in info.items())
    print(f'[{name}] {time.perf_counter() - t0:.2f}s {fields}', flush=True)


def _ptxas_report(log):
    """'kernel<template args>: registers/spill stores/stack frame' per
    compiled kernel instance, from nvcc's ``-Xptxas -v`` output (an
    ablation kernel's mode by name; the wide block's prologue,
    ``wide_prep_kernel``, by its name alone; other kernels left out)."""
    from diffco_tpu_torch.scripts.roofline_fk_score import MODES
    mode_names = {str(v): k for k, v in MODES.items()}
    out, kernel, spill, stack = [], None, None, None
    for ln in log.splitlines():
        m = re.search(r'((?:poly|dh|chain)(?:_multi)?_score_grad_kernel'
                      r'|dh_ablation_kernel|dh_dual_score_tc_kernel'
                      r'|(?:dh|poly|chain)_score_tc_kernel'
                      r'|poly_score_(?:f64|wide)_kernel'
                      r'|chain_wide_score_kernel'
                      r'|dh_fk(?:_vjp)?_kernel|greedy_train_kernel)'
                      r'I((?:L[ib]\d+E)+)E',
                      ln)
        if 'Compiling entry function' in ln:
            kernel = 'wide_prep_kernel' if 'wide_prep_kernel' in ln else None
        if 'Compiling entry function' in ln and m:
            args = re.findall(r'L[ib](\d+)E', m.group(2))
            if m.group(1) == 'dh_ablation_kernel':
                args = [mode_names[a] for a in args]
            kernel = f'{m.group(1)}<{",".join(args)}>'
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores',
                      ln)
        if m:
            stack, spill = m.group(1), m.group(2)
        m = re.search(r'Used (\d+) registers', ln)
        if m and kernel:
            out.append(f'{kernel}: {m.group(1)} regs/{spill} B spilled/'
                       f'{stack} B stack')
    return out


def _check_multi_ptxas(regs):
    """Every instance of the multi-class block's kernels (B4, B5) within
    the launch bound's 128 registers and unspilled, or fail."""
    n = 0
    for line in regs:
        m = re.match(r'(?:dh|chain)_multi_score_grad_kernel<[^>]*>: (\d+) '
                     r'regs/(\d+) B spilled', line)
        if m:
            n += 1
            if int(m.group(1)) > 128 or int(m.group(2)) != 0:
                raise AssertionError(f'ptxas: {line}')
    if n == 0:
        raise AssertionError('ptxas: no multi-class kernel instance found')


# the production instances of the kernels on the tensor-core block: B1 at
# FP = 8-48, B2 at FP = 16-64 (its fp64 instance at F = 1-8,
# poly_score_f64_kernel<F>, and its wide one at K = ceil(F / 32) = 3-6,
# poly_score_wide_kernel<K>), B3 at FP = 8-64; the FK kernels' wide
# instance, chain_wide_score_kernel<K>, at K = ceil(3P / 32) = 1-6
TC_INSTANCES = {'dh_score_tc_kernel': set(range(8, 49, 8)),
                'poly_score_tc_kernel': set(range(16, 65, 8)),
                'chain_score_tc_kernel': set(range(8, 65, 8))}
F64_INSTANCES = set(range(1, 9))
WIDE_INSTANCES = set(range(3, 7))
CHAIN_WIDE_INSTANCES = set(range(1, 7))


def _check_tc_ptxas(regs):
    """Every production instance of B1, B2 and B3 (<FP, 0>: TC_INSTANCES)
    within the launch bound's 128 registers and unspilled, and B2's fp64
    (F64_INSTANCES) and wide (WIDE_INSTANCES) instances and the FK
    kernels' wide one (CHAIN_WIDE_INSTANCES, built into each of B1, B3,
    B4 and B5; the wide block's launch bound ``_native.wide_threads`` x
    ``_native.wide_min_blocks`` at each K) within theirs (65536 over the
    threads of their least blocks per SM, at most 255) and unspilled, or
    fail."""
    from diffco_tpu_torch.ops import _native
    f64_regs = 65536 // (_native.F64_ROWS * _native.F64_MIN_BLOCKS)

    def wide_regs(kind, K):
        return min(255, 65536 // (_native.wide_threads(K)
                                  * _native.wide_min_blocks(K)))
    found = {k: set() for k in TC_INSTANCES}
    f64, wide, chain_wide = set(), set(), set()
    for line in regs:
        m = re.match(r'((?:dh|poly|chain)_score_tc_kernel)<(\d+),0>: (\d+) '
                     r'regs/(\d+) B spilled', line)
        if m:
            found[m.group(1)].add(int(m.group(2)))
            if int(m.group(3)) > 128 or int(m.group(4)) != 0:
                raise AssertionError(f'ptxas: {line}')
        m = re.match(r'poly_score_f64_kernel<(\d+)>: (\d+) regs/(\d+) B '
                     r'spilled', line)
        if m:
            f64.add(int(m.group(1)))
            if int(m.group(2)) > f64_regs or int(m.group(3)) != 0:
                raise AssertionError(f'ptxas: {line}')
        m = re.match(r'(poly_score_wide|chain_wide_score)_kernel<(\d+)>: '
                     r'(\d+) regs/(\d+) B spilled', line)
        if m:
            (wide if m.group(1) == 'poly_score_wide' else chain_wide).add(
                int(m.group(2)))
            if (int(m.group(3)) > wide_regs(m.group(1), int(m.group(2)))
                    or int(m.group(4)) != 0):
                raise AssertionError(f'ptxas: {line}')
    if (found != TC_INSTANCES or f64 != F64_INSTANCES
            or wide != WIDE_INSTANCES
            or chain_wide != CHAIN_WIDE_INSTANCES):
        raise AssertionError(f'ptxas: tensor-core instances found {found}, '
                             f'fp64 instances {sorted(f64)}, wide '
                             f'instances {sorted(wide)}, the FK kernels\' '
                             f'wide instances {sorted(chain_wide)}')


# the DH FK kernels' instances (csrc/dh_fk.cu) at KP control points, and
# their launch bound (its kFkThreads)
FK_INSTANCES = {8, 16}
FK_THREADS = 128


def _check_fk_ptxas(regs):
    """Every instance of the DH FK and its VJP (FK_INSTANCES, each kernel)
    within its launch bound's registers (65536 over ``FK_THREADS``, at
    most 255) and unspilled, or fail."""
    limit = min(255, 65536 // FK_THREADS)
    found = {'dh_fk_kernel': set(), 'dh_fk_vjp_kernel': set()}
    for line in regs:
        m = re.match(r'(dh_fk(?:_vjp)?_kernel)<(\d+)>: (\d+) regs/(\d+) B '
                     r'spilled', line)
        if m:
            found[m.group(1)].add(int(m.group(2)))
            if int(m.group(3)) > limit or int(m.group(4)) != 0:
                raise AssertionError(f'ptxas: {line}')
    if any(v != FK_INSTANCES for v in found.values()):
        raise AssertionError(f'ptxas: DH FK instances found {found}')


# the greedy trainer's kernel (csrc/greedy_train.cu): its block's threads
# (kGreedyThreads, the launch bound) and its instances by rows a thread
GREEDY_THREADS = 1024
GREEDY_INSTANCES = {1, 2, 4, 8, 16}


def _check_greedy_ptxas(regs):
    """Every instance of the greedy trainer's kernel (GREEDY_INSTANCES at
    GREEDY_THREADS) within its launch bound's registers (65536 over
    ``GREEDY_THREADS``: 64) and unspilled, or fail."""
    limit = 65536 // GREEDY_THREADS
    found = set()
    for line in regs:
        m = re.match(rf'greedy_train_kernel<{GREEDY_THREADS},(\d+)>: (\d+) '
                     r'regs/(\d+) B spilled', line)
        if m:
            found.add(int(m.group(1)))
            if int(m.group(2)) > limit or int(m.group(3)) != 0:
                raise AssertionError(f'ptxas: {line}')
    if found != GREEDY_INSTANCES:
        raise AssertionError(f'ptxas: greedy trainer instances found '
                             f'{sorted(found)}')


def _max_err(pairs):
    return max(float((a - b).abs().max()) for a, b in pairs)


def _rel_err(pairs):
    """max |a - b| / max |b| over the pairs (each pair's own scale)."""
    return max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
               for a, b in pairs)


def _check_close(name, a, b, tol):
    if not torch.allclose(a, b, rtol=tol, atol=tol):
        raise AssertionError(
            f'{name}: kernel and plain twin disagree beyond {tol}: '
            f'max |diff| {float((a - b).abs().max())}')


def _inputs(robot, B, S, dev, seed):
    g = torch.Generator().manual_seed(seed)
    q = robot.rand_configs(B, g, dev)
    sup = robot.fkine(robot.rand_configs(S, g, dev)).reshape(S, -1)
    w = (torch.randn(S, generator=g) * 0.05).to(dev)
    return q, sup.contiguous(), w


def check_poly_kernel(robot, dev):
    """B2 against its plain twin at B = 65536 + 37, S = 512, F = 21
    (PandaFK's points), rows 0-11 on or near a support (_near_points);
    then at every FP instance (POLY_FS; F <= 8 is the fp64 instance) on
    rows uniform in a box. Prints B2's launch plan as the card gives it
    (fails unless ops/_native.py::poly_plan_holds and it keeps 16 warps
    per SM, 8 at FP = 64 and on the wide instance, at every FP)."""
    from diffco_tpu_torch.ops import _native, fused_score
    t0 = time.perf_counter()
    q, sup, w = _inputs(robot, B_RAGGED, S_BENCH, dev, seed=1)
    x = robot.fkine(q, flat=True).contiguous()
    sup = _near_points(x[:12], sup, seed=1)
    score, dx = fused_score.poly_score_grad(x, sup, w)
    ref, ref_dx = fused_score._poly_score_grad_plain(x, sup, w)
    torch.cuda.synchronize()
    _check_near('poly_score_grad', score, dx, ref, ref_dx)
    err = _max_err([(score, ref), (dx[4:], ref_dx[4:])])
    plans = {}
    for F in POLY_FS:
        card = plans[F] = _native.poly_score_plan_on_card(F)
        # one block (8 warps) per SM at FP = 64, whose per-chunk running
        # sums take 36 KB of shared memory, and 8 warps on the wide
        # instance (~200 registers a thread of accumulators)
        least = 8 if F > 56 else 16
        if not _native.poly_plan_holds(card, F) or \
                card['warps_per_sm'] < least:
            raise AssertionError(f'B2 plan {card} on the card at F = {F}, '
                                 f'{_native.poly_tc_plan(F)} in '
                                 f'ops/_native.py::poly_tc_plan ({least} '
                                 'warps per SM at least)')
    print(f'B2 launch plan (F = 21): {plans[21]}', flush=True)
    _phase('B2 poly_score_grad vs plain', t0, B=B_RAGGED, S=S_BENCH,
           F=x.shape[1], max_abs_err=err,
           near_support_rows='0-3 on, 4-7 at 1e-3, 8-11 at 1e-2')
    out = dict(args=(x, sup, w), err=err, plan=plans[21])
    for F in POLY_FS:
        t0 = time.perf_counter()
        g = torch.Generator().manual_seed(F)
        xf = (torch.rand(B_CHAIN_SMALL, F, generator=g) * 1.2 - 0.3).to(dev)
        sf = (torch.rand(S_CHAIN_SMALL, F, generator=g) * 1.2 - 0.3).to(dev)
        sf = _near_points(xf[:12], sf, seed=F)
        wf = (torch.randn(S_CHAIN_SMALL, generator=g) * 0.05).to(dev)
        score, dx = fused_score.poly_score_grad(xf, sf, wf)
        ref, ref_dx = fused_score._poly_score_grad_plain(xf, sf, wf)
        torch.cuda.synchronize()
        _check_near(f'poly_score_grad (F = {F})', score, dx, ref, ref_dx)
        err = _max_err([(score, ref), (dx[4:], ref_dx[4:])])
        out['err'] = max(out['err'], err)
        inst = ('the fp64 instance' if F <= _native.F64_MAX_F
                else f'the wide instance, K = {plans[F]["fp"] // 32}'
                if F > _native.TC_MAX_F else f'FP = {plans[F]["fp"]}')
        _phase(f'B2 poly_score_grad vs plain, F = {F}, {inst}', t0,
               B=B_CHAIN_SMALL, S=S_CHAIN_SMALL,
               max_abs_err=err, warps_per_sm=plans[F]['warps_per_sm'],
               smem_bytes=plans[F]['smem_bytes'])
    return out


def _near_supports(robot, q, sup, seed):
    """Supports 0-11 moved onto the FK points of configurations 0-11
    (_near_points). Returns the new supports."""
    return _near_points(robot.fkine(q[:12]).reshape(12, -1), sup, seed)


def _near_points(x, sup, seed):
    """Supports 0-11 moved onto the rows x [12, F]: 0-3 exactly, 4-7 at
    1e-3 and 8-11 at 1e-2 (random directions). Returns the new
    supports."""
    g = torch.Generator().manual_seed(seed)
    d = torch.randn(x.shape, generator=g).to(x.device)
    d = d / d.norm(dim=1, keepdim=True)
    off = torch.tensor([0.0] * 4 + [1e-3] * 4 + [1e-2] * 4, device=x.device)
    sup = sup.clone()
    sup[:12] = x + off[:, None] * d
    return sup.contiguous()


def _check_near(tag, score, dq, ref, ref_dq):
    """Score at 1e-4 on every row; dq at 1e-3 on all but rows 0-3, whose
    points sit on a support: there dq is divided by a distance of ~1e-7
    (ill-conditioned in kernel and twin alike) and has to be finite."""
    _check_close(f'{tag} score', score, ref, 1e-4)
    _check_close(f'{tag} dq', dq[4:], ref_dq[4:], 1e-3)
    if not bool(torch.isfinite(dq[:4]).all()):
        raise AssertionError(f'{tag}: non-finite dq on a support')


def check_dh_kernel(robot, dev):
    """B1 against its plain twin at the same shape, with configurations 0-11
    on or near a support (_near_supports), and autograd through
    fk_polyharmonic_score_auto (bench.py's primitive) against its dq; then
    at FP = 16 and 8 (Baxter's arm) and 32, 40 and 48 (PandaFK's chain
    with more points). Prints B1's launch plan as the card gives it (fails
    unless it is ops/_native.py::dh_tc_plan's and keeps 16 warps per
    SM)."""
    from diffco_tpu_torch.ops import _native, fk_score
    from diffco_tpu_torch.robots.analytic import panda_with_points
    t0 = time.perf_counter()
    q, sup, w = _inputs(robot, B_RAGGED, S_BENCH, dev, seed=2)
    sup = _near_supports(robot, q, sup, seed=2)
    spec = fk_score.robot_spec(robot)
    score, dq = fk_score.dh_score_grad(q, sup, w, spec)
    ref, ref_dq = fk_score._dh_score_grad_plain(q, sup, w, spec)
    torch.cuda.synchronize()
    _check_near('dh_score_grad', score, dq, ref, ref_dq)
    err = _max_err([(score, ref), (dq[4:], ref_dq[4:])])
    qg = q.clone().requires_grad_(True)
    out = fk_score.fk_polyharmonic_score_auto(qg, robot, sup, w)
    g, = torch.autograd.grad(out.sum(), qg)
    _check_close('autograd through fk_polyharmonic_score_auto', g, dq, 1e-6)
    _phase('B1 dh_score_grad vs plain', t0, B=B_RAGGED, S=S_BENCH,
           J=q.shape[1], max_abs_err=err,
           near_support_rows='0-3 on, 4-7 at 1e-3, 8-11 at 1e-2')
    card = _native.dh_score_plan_on_card(len(spec[1]))
    mirror = _native.dh_tc_plan(len(spec[1]))
    print(f'B1 launch plan (P = {len(spec[1])}): {card}', flush=True)
    if card != mirror or card['warps_per_sm'] < 16:
        raise AssertionError(f'B1 plan {card} on the card, {mirror} in '
                             'ops/_native.py::dh_tc_plan (16 warps per SM '
                             'at least)')
    out = dict(args=(q, sup, w, spec), err=err, plan=card)
    arms = [(f'Baxter arm, FP = {fp}', baxter_arm(mask), fp)
            for fp, mask in BAXTER_MASKS.items()]
    arms += [(f'PandaFK chain with {P} points, FP = {(3 * P + 7) // 8 * 8}',
              panda_with_points(P), P) for P in WIDE_POINTS]
    for tag, arm, seed in arms:
        t0 = time.perf_counter()
        q, sup, w = _inputs(arm, B_CHAIN_SMALL, S_CHAIN_SMALL, dev, seed=seed)
        sup = _near_supports(arm, q, sup, seed=seed)
        spec = fk_score.robot_spec(arm)
        score, dq = fk_score.dh_score_grad(q, sup, w, spec)
        ref, ref_dq = fk_score._dh_score_grad_plain(q, sup, w, spec)
        torch.cuda.synchronize()
        _check_near(f'dh_score_grad ({tag})', score, dq, ref, ref_dq)
        card = _native.dh_score_plan_on_card(len(spec[1]))
        if (card != _native.dh_tc_plan(len(spec[1]))
                or card['warps_per_sm'] < 16):
            raise AssertionError(f'B1 plan at P = {len(spec[1])}: {card}')
        err = _max_err([(score, ref), (dq[4:], ref_dq[4:])])
        out['err'] = max(out['err'], err)
        _phase(f'B1 dh_score_grad vs plain, {tag}', t0, B=B_CHAIN_SMALL,
               S=S_CHAIN_SMALL, F=sup.shape[1], max_abs_err=err,
               warps_per_sm=card['warps_per_sm'],
               smem_bytes=card['smem_bytes'])
    return out


def _fitted_proxy(robot, gt, S, dev, seed):
    """Supports and weights of a polyharmonic proxy fitted the way
    fit_poly fits one: the FK points of S ground-truth-labelled random
    configurations and the weights that interpolate their +-1 labels
    (masked_rbf_solve, every row valid, in float32 on the card). Such
    weights cancel: sum_j |w_j| r_j is far beyond |score|."""
    from diffco_tpu_torch.device import fp32_matmul
    from diffco_tpu_torch.kernels import Polyharmonic
    from diffco_tpu_torch.perceptron import masked_rbf_solve
    qs = robot.rand_configs(S, torch.Generator().manual_seed(seed), dev)
    sup = robot.fkine(qs).reshape(S, -1).contiguous()
    y = gt(qs).float() * 2 - 1
    with fp32_matmul():
        w = masked_rbf_solve(Polyharmonic(k=1, epsilon=1)(sup, sup), y,
                             torch.ones(S, dtype=torch.bool, device=dev))
    return sup, w.contiguous()


def _large_s_cases(dev):
    """(name, robot, ground truth) of the B1 check at LARGE_S: PandaFK
    (FP = 24) in the panda_world scene and BaxterLeftArmFK (FP = 16) in
    the Baxter benchmarks' scene, each with its capsule-chain ground
    truth."""
    import diffco_tpu_torch as dc
    panda, baxter = dc.PandaFK(), dc.BaxterLeftArmFK()
    return [('PandaFK', panda, dc.CapsuleChainCollision(
                panda, link_radius=LINK_RADIUS).checker_fn(_scene())),
            ('Baxter arm', baxter, dc.CapsuleChainCollision(
                baxter, link_radius=BAXTER_LINK_RADIUS, per_seg=4)
             .checker_fn(dc.ShapeEnv(_baxter_shapes())))]


def check_dh_large_s(dev):
    """B1 on fitted proxies of LARGE_S supports (_fitted_proxy) at
    B = 65536 + 37, against its twin in float64, at the sweeps'
    tolerances (score 1e-4, dq 1e-3): PandaFK (FP = 24) and Baxter's arm
    (FP = 16). Prints each error beside max sum_j |w_j| r_j, as _sweeps
    does, and fails after all cases if any is out of tolerance."""
    from diffco_tpu_torch.ops import fk_score
    out, failed = dict(err=0.0, cases=[]), []
    for i, (name, robot, gt) in enumerate(_large_s_cases(dev)):
        spec = fk_score.robot_spec(robot)
        q = robot.rand_configs(B_RAGGED, torch.Generator().manual_seed(60 + i),
                               dev)
        for S in LARGE_S:
            t0 = time.perf_counter()
            sup, w = _fitted_proxy(robot, gt, S, dev, seed=70 + i + S)
            score, dq = fk_score.dh_score_grad(q, sup, w, spec)
            with torch.no_grad():
                q64, sup64, w64 = q.double(), sup.double(), w.double()
                ref, ref_dq = fk_score._dh_score_grad_plain(q64, sup64, w64,
                                                            spec)
                x64 = robot.fkine(q64).reshape(q.shape[0], -1)
                cond = max(float((torch.cdist(xc, sup64) * w64.abs())
                                 .sum(1).max())
                           for xc in torch.split(x64, 8192))
            torch.cuda.synchronize()
            err_s = _max_err([(score.double(), ref)])
            err_dq = _max_err([(dq.double(), ref_dq)])
            row = dict(robot=name, S=S, F=sup.shape[1],
                       score_err=err_s, dq_err=err_dq,
                       max_abs_score=float(ref.abs().max()),
                       max_abs_dq=float(ref_dq.abs().max()),
                       max_sum_w_r=cond)
            out['cases'].append(row)
            out['err'] = max(out['err'], err_s, err_dq)
            for what, a, b, tol in (('score', score.double(), ref, 1e-4),
                                    ('dq', dq.double(), ref_dq, 1e-3)):
                if not torch.allclose(a, b, rtol=tol, atol=tol):
                    failed.append(f'{name} S = {S} {what}')
            _phase(f'B1 dh_score_grad vs float64 twin, {name}, S = {S}', t0,
                   B=B_RAGGED, **{k: v for k, v in row.items()
                                  if k not in ('robot', 'S')})
    if failed:
        raise AssertionError(f'B1 at large S beyond the tolerance: {failed}')
    return out


def _allclose_ratio(a, b, tol):
    """max |a - b| / (tol + tol |b|): torch.allclose(a, b, tol, tol) holds
    where it is at most 1."""
    return float(((a - b).abs() / (tol + tol * b.abs())).max())


def check_tc_large_s(dev):
    """B3 and B2 at FP = 64 and 56 on fitted proxies of TC_LARGE_S
    supports (_fitted_proxy on the marked ropes of TC_ROPE_LINKS links,
    labels from ab_kernel's rope_ball_gt: a control point inside a ball),
    at B = 65536 + 37, against their twins in float64 at the sweeps'
    tolerances (score 1e-4, dq and dx 1e-3): B3 from the ropes'
    configurations (21 points on 11 moving joints, FP = 64; 17 on 9, FP =
    56), B2 from their points (F = 63 and 51). The float32 twin itself
    misses 1e-4 on the score at S = 8192, so the reference is float64.
    Prints each case's error, its error over the reference's max and its
    allclose ratio, and fails after all cases if any is out of
    tolerance."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch import robot_data
    from diffco_tpu_torch.ops import fk_score, fused_score
    from diffco_tpu_torch.scripts.ab_kernel import rope_ball_gt
    out, failed = dict(err=0.0, cases=[]), []
    for links in TC_ROPE_LINKS:
        robot = dc.URDFRobot(
            robot_data.generate_marked_rope_urdf(n_links=links), device=dev,
            setup_acm=False)
        gt = rope_ball_gt(robot)
        cs = fk_score.robot_chain_statics(robot)
        q = robot.rand_configs(B_RAGGED, torch.Generator().manual_seed(80),
                               dev)
        x = robot.fkine(q).reshape(B_RAGGED, -1).contiguous()
        q64, x64 = q.double(), x.double()
        for S in TC_LARGE_S:
            sup, w = _fitted_proxy(robot, gt, S, dev, seed=90 + S)
            sup64, w64 = sup.double(), w.double()
            F = sup.shape[1]
            for name, run, plain, arg, arg64 in (
                    ('B3 chain_score_grad',
                     lambda a: fk_score.chain_score_grad(a, sup, w, cs),
                     lambda a: fk_score._chain_score_grad_plain(
                         a, sup64, w64, cs), q, q64),
                    ('B2 poly_score_grad',
                     lambda a: fused_score.poly_score_grad(a, sup, w),
                     lambda a: fused_score._poly_score_grad_plain(
                         a, sup64, w64), x, x64)):
                t0 = time.perf_counter()
                score, grad = run(arg)
                with torch.no_grad():
                    ref, ref_g = plain(arg64)
                torch.cuda.synchronize()
                row = dict(kernel=name, S=S, F=F, FP=(F + 7) // 8 * 8)
                for what, a, b, tol in (('score', score.double(), ref, 1e-4),
                                        ('grad', grad.double(), ref_g, 1e-3)):
                    err = float((a - b).abs().max())
                    row.update({
                        f'{what}_err': err,
                        f'{what}_err_of_max': err / float(b.abs().max()),
                        f'{what}_allclose_ratio': _allclose_ratio(a, b,
                                                                  tol)})
                    out['err'] = max(out['err'], err)
                    if not torch.allclose(a, b, rtol=tol, atol=tol):
                        failed.append(f'{name} F = {F} S = {S} {what}')
                row['colliding'] = float(gt(q).float().mean())
                out['cases'].append(row)
                _phase(f'{name} vs float64 twin, marked rope of {links} '
                       f'links, S = {S}', t0, B=B_RAGGED,
                       **{k: v for k, v in row.items()
                          if k not in ('kernel', 'S')})
    if failed:
        raise AssertionError(f'B2 / B3 at FP = 56 and 64, large S, beyond '
                             f'the tolerance: {failed}')
    return out


def check_chain_kernel(dev):
    """B3 against its plain twin: FrankaPanda at B = 65536 + 37, S = 512
    (F = 24), and the generated branching trifinger, prismatic + mimic
    lift rig and marked rope (21 points on 11 moving joints: FP = 64) at
    B = 4096 + 5, S = 128, so that every joint type runs on the card;
    configurations 0-11 on or near a support in every case. Then autograd
    through fk_polyharmonic_score_auto on FrankaPanda against the kernel's
    dq. Prints B3's launch plan as the card gives it (fails unless it is
    ops/_native.py::chain_tc_plan's, with 16 warps per SM at
    FrankaPanda's shape)."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch import robot_data
    from diffco_tpu_torch.ops import _native, fk_score
    robot_data.ensure_default_assets()
    cases = [('FrankaPanda', dc.FrankaPanda(load_gripper=True, device=dev),
              B_RAGGED, S_BENCH)]
    for name in ('trifinger_simple.urdf', 'lift_rig.urdf'):
        cases.append((name, dc.URDFRobot(
            f'{robot_data.data_dir}/{name}', device=dev, setup_acm=False),
            B_CHAIN_SMALL, S_CHAIN_SMALL))
    cases.append(('marked rope', dc.URDFRobot(
        robot_data.generate_marked_rope_urdf(), device=dev,
        setup_acm=False), B_CHAIN_SMALL, S_CHAIN_SMALL))
    errs, out = [], None
    for seed, (name, robot, B, S) in enumerate(cases, start=5):
        t0 = time.perf_counter()
        q, sup, w = _inputs(robot, B, S, dev, seed=seed)
        sup = _near_supports(robot, q, sup, seed=seed)
        cs = fk_score.robot_chain_statics(robot)
        score, dq = fk_score.chain_score_grad(q, sup, w, cs)
        ref, ref_dq = fk_score._chain_score_grad_plain(q, sup, w, cs)
        torch.cuda.synchronize()
        _check_near(f'chain_score_grad ({name})', score, dq, ref, ref_dq)
        err = _max_err([(score, ref), (dq[4:], ref_dq[4:])])
        errs.append(err)
        c = fk_score._c_chain_spec(cs)
        card = _native.chain_score_plan_on_card(c.P, c.M)
        if (card != _native.chain_tc_plan(c.P, c.M)
                or (name == 'FrankaPanda' and card['warps_per_sm'] < 16)):
            raise AssertionError(f'B3 plan {card} on the card for {name}, '
                                 f'{_native.chain_tc_plan(c.P, c.M)} in '
                                 'ops/_native.py::chain_tc_plan (16 warps '
                                 'per SM at least for FrankaPanda)')
        _phase(f'B3 chain_score_grad vs plain, {name}', t0, B=B, S=S,
               D=q.shape[1], moving_joints=c.M, points=c.P,
               max_abs_err=err, warps_per_sm=card['warps_per_sm'],
               smem_bytes=card['smem_bytes'],
               near_support_rows='0-3 on, 4-7 at 1e-3, 8-11 at 1e-2')
        if out is None:
            print(f'B3 launch plan (FrankaPanda, P = {c.P}, M = {c.M}): '
                  f'{card}', flush=True)
            qg = q.clone().requires_grad_(True)
            s_auto = fk_score.fk_polyharmonic_score_auto(qg, robot, sup, w)
            g, = torch.autograd.grad(s_auto.sum(), qg)
            _check_close('autograd through fk_polyharmonic_score_auto '
                         '(FrankaPanda)', g, dq, 1e-6)
            out = dict(args=(q, sup, w, cs), plan=card)
    out['err'] = max(errs)
    return out


def _wide_robot(name, dev):
    """The robots past the tensor-core and multi-class kernels' bounds that
    check_wide_kernels takes: a 9-joint DH chain with a point on every
    frame, and the 35-link rope (35 moving joints, 34 points)."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch import robot_data
    from diffco_tpu_torch.robots.analytic import DHChainRobot, DHParameters
    if name == 'DH, 9 joints':
        n = 9
        return DHChainRobot(DHParameters(a=[0.1] * n, alpha=[0.5] * n,
                                         d=[0.05] * n, theta=[0.3] * n),
                            [[-math.pi, math.pi]] * n, [True] * n)
    return dc.URDFRobot(robot_data.generate_rope_urdf(n_links=ROPE_LINKS),
                        setup_acm=False, link_spheres=1, device=dev)


# (robot, C) of check_wide_kernels: B1, B4 on the DH chain, B3, B5 on the
# rope
WIDE_CASES = (('DH, 9 joints', 1), ('DH, 9 joints', 2), ('rope', 1),
              ('rope', 3))


def check_wide_kernels(dev):
    """The wide instance of the FK kernels (csrc/chain_wide.cuh) as B1, B4,
    B3 and B5 launch it for a chain past their bounds (WIDE_CASES), against
    the plain twins at B = 65536 + 37, S = 512, configurations 0-11 on or
    near a support; with its launch plan from the card (fails unless
    ops/_native.py::chain_wide_plan_holds: chain_wide_plan's shared bytes,
    threads and rows and at least its blocks and warps per SM). Returns
    per case the error and the arguments for the timing table. First DMMA
    in the SASS of every wide instance (B2's and the FK kernels':
    sass_counts.wide_dmma), or fail."""
    from diffco_tpu_torch.ops import _native, fk_score
    from diffco_tpu_torch.scripts import sass_counts
    t0 = time.perf_counter()
    dmma = sass_counts.wide_dmma()
    _phase('wide instances SASS', t0, dmma={
        stem: {re.search(r'(\w+_kernel)I(L[ib]\d+E)E', k).group(0): n
               for k, n in found.items()} for stem, found in dmma.items()})
    out = {}
    for seed, (name, C) in enumerate(WIDE_CASES, start=21):
        t0 = time.perf_counter()
        robot = _wide_robot(name, dev)
        dh = name.startswith('DH')
        g = torch.Generator().manual_seed(seed)
        q = robot.rand_configs(B_RAGGED, g, dev)
        sup = robot.fkine(robot.rand_configs(S_BENCH, g, dev)).reshape(
            S_BENCH, -1)
        sup = _near_supports(robot, q, sup, seed=seed)
        W = _class_weights(S_BENCH, C, dev, seed)
        w = W[:, 0].contiguous() if C == 1 else W
        spec = (fk_score.robot_spec(robot) if dh
                else fk_score.robot_chain_statics(robot))
        c = fk_score._c_spec(spec) if dh else fk_score._c_chain_spec(spec)
        if not isinstance(c, _native.ChainSpecWide):
            raise AssertionError(f'{name} takes the narrow instance')
        kernel, plain = {
            (True, 1): (fk_score.dh_score_grad, fk_score._dh_score_grad_plain),
            (True, 2): (fk_score.dh_multi_score_grad,
                        fk_score._dh_multi_score_grad_plain),
            (False, 1): (fk_score.chain_score_grad,
                         fk_score._chain_score_grad_plain),
            (False, 3): (fk_score.chain_multi_score_grad,
                         fk_score._chain_multi_score_grad_plain)}[dh, C]
        counter = f'launches.{kernel.__name__}'
        before = profiling.counter(counter)
        score, dq = kernel(q, sup, w, spec)
        torch.cuda.synchronize()
        if profiling.counter(counter) != before + 1:
            raise AssertionError(f'{kernel.__name__} ({name}) not counted')
        ref, ref_dq = plain(q, sup, w, spec)
        if C == 1:
            _check_near(f'{kernel.__name__} wide ({name})', score, dq, ref,
                        ref_dq)
            err = _max_err([(score, ref), (dq[4:], ref_dq[4:])])
        else:
            _check_close(f'{kernel.__name__} wide ({name}) score', score,
                         ref, 1e-4)
            _check_close(f'{kernel.__name__} wide ({name}) dq', dq[:, 4:],
                         ref_dq[:, 4:], 1e-3)
            err = _max_err([(score, ref), (dq[:, 4:], ref_dq[:, 4:])])
        card = _native.chain_wide_plan_on_card(c.P, c.M)
        plan = _native.chain_wide_plan(c.P, c.M)
        if (not _native.chain_wide_plan_holds(card, c.P, c.M)
                or card['warps_per_sm'] < plan['warps_per_sm']):
            raise AssertionError(f'wide plan {card} on the card for {name}, '
                                 f'{plan} in ops/_native.py::'
                                 'chain_wide_plan')
        _phase(f'wide {kernel.__name__} vs plain, {name}', t0, B=B_RAGGED,
               S=S_BENCH, C=C, D=c.D, moving_joints=c.M, points=c.P,
               max_abs_err=err, plan=card,
               near_support_rows='0-3 on, 4-7 at 1e-3, 8-11 at 1e-2')
        out[kernel.__name__] = dict(args=(q, sup, w, spec), c=c, err=err,
                                    plan=card, robot=name, kernel=kernel,
                                    plain=plain)
    return out


def _class_weights(S, C, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(S, C, generator=g) * 0.05).to(dev)


def _check_multi(tag, kernel, plain, q, sup, W, spec):
    """A multi-class kernel against its plain twin; returns the error."""
    score, dq = kernel(q, sup, W, spec)
    ref, ref_dq = plain(q, sup, W, spec)
    torch.cuda.synchronize()
    B, C = q.shape[0], W.shape[1]
    if score.shape != (B, C) or dq.shape != (C, B, q.shape[1]):
        raise AssertionError(f'{tag}: shapes {tuple(score.shape)}, '
                             f'{tuple(dq.shape)}')
    _check_close(f'{tag} score', score, ref, 1e-4)
    _check_close(f'{tag} dq', dq, ref_dq, 1e-3)
    return _max_err([(score, ref), (dq, ref_dq)]), dq


def _check_multi_autograd(tag, robot, q, sup, W, dq, dev):
    """A class mix g [B, C] through fk_polyharmonic_multi_score_auto gives
    einsum('bc,cbj->bj', g, dq) of the kernel's dq."""
    from diffco_tpu_torch.ops import fk_score
    mix = _class_weights(q.shape[0], W.shape[1], dev, seed=99)
    qg = q.clone().requires_grad_(True)
    out = fk_score.fk_polyharmonic_multi_score_auto(qg, robot, sup, W)
    g, = torch.autograd.grad((out * mix).sum(), qg)
    _check_close(f'autograd through fk_polyharmonic_multi_score_auto '
                 f'({tag})', g, torch.einsum('bc,cbj->bj', mix, dq), 1e-6)


def _plan_line(tag, card, P, C):
    """Print a multi-class launch plan as the card gives it; fail unless
    it is ops/_native.py::multi_plan's (instance, classes per pass,
    passes, shared bytes) and keeps 16 warps per SM."""
    from diffco_tpu_torch.ops import _native
    mirror = _native.multi_plan(P, C)
    print(f'{tag} launch plan (P = {P}), C = {C}: {card}; '
          f'{_native.MULTI_THREADS} threads and {_native.MULTI_ROWS} '
          'configurations per block', flush=True)
    for key in ('instance', 'classes_per_pass', 'passes', 'smem_bytes'):
        if card[key] != mirror[key]:
            raise AssertionError(f'{tag} plan at P = {P}, C = {C}: {key} '
                                 f'{card[key]} on the card, {mirror[key]} '
                                 'in ops/_native.py::multi_plan')
    if card['warps_per_sm'] < 16:
        raise AssertionError(f'{tag} keeps {card["warps_per_sm"]} warps '
                             'per SM, below 16')
    return card


def check_dh_multi_kernel(robot, dev):
    """B4 against its plain twin on PandaFK at B = 65536 + 37, S = 512,
    for C = 1, 2, 3, 5, 8 (at FP = 24: the register instance, one full
    pass, two), and the class-mixed autograd through
    fk_polyharmonic_multi_score_auto against its dq; then its FP = 16 and
    FP = 8 instances on Baxter's arm at B = 4096 + 5, S = 128, each in the
    register, narrow and full instance, and its FP = 32, 40 and 48
    instances on PandaFK's chain with WIDE_POINTS points at C = 1, 2, 5
    (narrow; full in one pass; two or three). Every case prints the instance
    and launch plan that dh_multi_score_plan gives (and fails below 16
    warps per SM or off the CPU mirror)."""
    from diffco_tpu_torch.ops import _native, fk_score
    from diffco_tpu_torch.robots.analytic import panda_with_points
    spec = fk_score.robot_spec(robot)
    P = len(spec[1])
    out = dict(err=0.0)
    for C in DH_MULTI_CLASSES:
        t0 = time.perf_counter()
        q, sup, _ = _inputs(robot, B_RAGGED, S_BENCH, dev, seed=10 + C)
        W = _class_weights(S_BENCH, C, dev, seed=C)
        err, dq = _check_multi(f'dh_multi_score_grad C={C}',
                               fk_score.dh_multi_score_grad,
                               fk_score._dh_multi_score_grad_plain, q, sup,
                               W, spec)
        _check_multi_autograd(f'PandaFK, C={C}', robot, q, sup, W, dq, dev)
        plan = _plan_line('B4', _native.dh_multi_plan_on_card(P, C), P, C)
        _phase(f'B4 dh_multi_score_grad vs plain, C={C}', t0, B=B_RAGGED,
               S=S_BENCH, J=q.shape[1], max_abs_err=err,
               instance=plan['instance'], plan=plan)
        out[f'args_c{C}'] = (q, sup, W, spec)
        out[f'plan_c{C}'] = plan
        out['err'] = max(out['err'], err)
    out['args'] = out['args_c2']   # the PandaFK multi-class path's C
    for fp, C in BAXTER_MULTI_CASES:
        t0 = time.perf_counter()
        arm = baxter_arm(BAXTER_MASKS[fp])
        q, sup, _ = _inputs(arm, B_CHAIN_SMALL, S_CHAIN_SMALL, dev,
                            seed=40 + fp)
        W = _class_weights(S_CHAIN_SMALL, C, dev, seed=fp + C)
        arm_spec = fk_score.robot_spec(arm)
        err, _ = _check_multi(f'dh_multi_score_grad FP = {fp}, C={C}',
                              fk_score.dh_multi_score_grad,
                              fk_score._dh_multi_score_grad_plain, q, sup, W,
                              arm_spec)
        Pa = len(arm_spec[1])
        plan = _plan_line('B4', _native.dh_multi_plan_on_card(Pa, C), Pa, C)
        out['err'] = max(out['err'], err)
        _phase(f'B4 dh_multi_score_grad vs plain, Baxter arm, FP = {fp}, '
               f'C={C}', t0, B=B_CHAIN_SMALL, S=S_CHAIN_SMALL,
               F=sup.shape[1], max_abs_err=err, instance=plan['instance'],
               plan=plan)
    for P in WIDE_POINTS:
        arm = panda_with_points(P)
        arm_spec = fk_score.robot_spec(arm)
        fp = (3 * P + 7) // 8 * 8
        for C in WIDE_MULTI_CLASSES:
            t0 = time.perf_counter()
            q, sup, _ = _inputs(arm, B_CHAIN_SMALL, S_CHAIN_SMALL, dev,
                                seed=50 + P)
            W = _class_weights(S_CHAIN_SMALL, C, dev, seed=P + C)
            err, _ = _check_multi(f'dh_multi_score_grad FP = {fp}, C={C}',
                                  fk_score.dh_multi_score_grad,
                                  fk_score._dh_multi_score_grad_plain, q, sup,
                                  W, arm_spec)
            plan = _plan_line('B4', _native.dh_multi_plan_on_card(P, C), P, C)
            out['err'] = max(out['err'], err)
            _phase(f'B4 dh_multi_score_grad vs plain, PandaFK chain with {P} '
                   f'points, FP = {fp}, C={C}', t0, B=B_CHAIN_SMALL,
                   S=S_CHAIN_SMALL, F=sup.shape[1], max_abs_err=err,
                   instance=plan['instance'], plan=plan)
    return out


def check_chain_multi_kernel(dev):
    """B5 against its plain twin: FrankaPanda at B = 65536 + 37, S = 1024,
    C = 5 (the multi-class quick start's shape: one pass over the
    supports) with the class-mixed autograd check, C = 8 (two passes) and
    C = 2 and 1 (the register instance); the trifinger tree and the prismatic +
    mimic lift rig at B = 4096 + 5, S = 128, C = 2, so that every joint
    type runs on the card. Prints the launch plan at FrankaPanda's shape
    as the card's occupancy calculator gives it, and fails below 16 warps
    per SM or off the CPU mirror."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch import robot_data
    from diffco_tpu_torch.ops import _native, fk_score
    robot_data.ensure_default_assets()
    panda = dc.FrankaPanda(load_gripper=True, device=dev)
    cases = [('FrankaPanda', panda, B_RAGGED, S_URDF_MULTI, 5),
             ('FrankaPanda', panda, B_RAGGED, S_URDF_MULTI, 8)]
    for name in ('trifinger_simple.urdf', 'lift_rig.urdf'):
        cases.append((name, dc.URDFRobot(
            f'{robot_data.data_dir}/{name}', device=dev, setup_acm=False),
            B_CHAIN_SMALL, S_CHAIN_SMALL, 2))
    cases += [('FrankaPanda', panda, B_RAGGED, S_URDF_MULTI, C)
              for C in (2, 1)]
    out = None
    for seed, (name, robot, B, S, C) in enumerate(cases, start=20):
        t0 = time.perf_counter()
        q, sup, _ = _inputs(robot, B, S, dev, seed=seed)
        W = _class_weights(S, C, dev, seed=seed)
        cs = fk_score.robot_chain_statics(robot)
        err, dq = _check_multi(f'chain_multi_score_grad ({name}, C={C})',
                               fk_score.chain_multi_score_grad,
                               fk_score._chain_multi_score_grad_plain, q, sup,
                               W, cs)
        if out is None:
            _check_multi_autograd(name, robot, q, sup, W, dq, dev)
            out = dict(args=(q, sup, W, cs), err=err)
        elif name == 'FrankaPanda':   # timed beside it
            out[f'args_c{C}'] = (q, sup, W, cs)
        out['err'] = max(out['err'], err)
        _phase(f'B5 chain_multi_score_grad vs plain, {name}, C={C}', t0, B=B,
               S=S, C=C, D=q.shape[1], max_abs_err=err)
    c = fk_score._c_chain_spec(out['args'][3])
    for C in (1, 2, 5, 8):
        out[f'plan_c{C}'] = _plan_line(
            'B5, FrankaPanda', _native.chain_multi_plan_on_card(c.P, C),
            c.P, C)
    return out


def check_roofline_kernels(robot, dev):
    """B6 in every variant against the B1 kernel and B1's fp32 plain twin,
    B1 at each block size of the roofline path's sweep against the twin,
    and each B7 mode against its plain twin (``rf.ABLATION_TOL``), at
    B = 65536 + 37, S = 512 (tolerances as in tests/test_torch_cuda.py);
    and HMMA in the SASS of every B6 variant and B7 rung past fk_only."""
    from diffco_tpu_torch.ops import fk_score
    from diffco_tpu_torch.scripts import ab_dual_tile as ab
    from diffco_tpu_torch.scripts import roofline_fk_score as rf
    from diffco_tpu_torch.scripts import sass_counts
    t0 = time.perf_counter()
    hmma = sass_counts.roofline_hmma()
    _phase('B6 and B7 SASS', t0, hmma={
        re.search(r'(dh_\w+_kernel)I(L[ib]\d+E)E', k).group(0): n
        for k, n in hmma.items()})
    t0 = time.perf_counter()
    q, sup, w = _inputs(robot, B_RAGGED, S_BENCH, dev, seed=30)
    spec = fk_score.robot_spec(robot)
    b1 = fk_score.dh_score_grad(q, sup, w, spec)
    twin = fk_score._dh_score_grad_plain(q, sup, w, spec)
    dual = {}
    for name in ab.VARIANTS:
        score, dq = ab.dh_dual_score_grad(q, sup, w, spec, name)
        torch.cuda.synchronize()
        for what, (ref, ref_dq) in (('B1 kernel', b1), ('plain twin', twin)):
            _check_close(f'{name} score vs {what}', score, ref, 1e-4)
            _check_close(f'{name} dq vs {what}', dq, ref_dq, 1e-3)
        dual[name] = _max_err([(score, twin[0]), (dq, twin[1])])
    _phase('B6 dh_dual_score_grad vs B1 and plain', t0, B=B_RAGGED,
           S=S_BENCH, max_abs_err=dual)
    t0 = time.perf_counter()
    sweep = {}
    for threads in rf.SWEEP_THREADS:
        score, dq = rf.dh_score_grad_threads(q, sup, w, spec, threads)
        torch.cuda.synchronize()
        _check_close(f'dh_score_grad_threads {threads} score', score,
                     twin[0], 1e-4)
        _check_close(f'dh_score_grad_threads {threads} dq', dq, twin[1],
                     1e-3)
        sweep[threads] = _max_err([(score, twin[0]), (dq, twin[1])])
    _phase('B1 block-size sweep vs plain', t0, B=B_RAGGED, S=S_BENCH,
           max_abs_err=sweep)
    t0 = time.perf_counter()
    modes, refs = {}, {}
    for mode in rf.MODES:
        out = rf.dh_ablation(q, sup, w, spec, mode)
        ref = refs[mode] = rf._dh_ablation_plain(q, sup, w, spec, mode)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        tol = rf.ABLATION_TOL[mode] * float(ref.abs().max())
        if not err <= tol:
            raise AssertionError(f'dh_ablation {mode}: kernel and plain twin '
                                 f'disagree by {err} > {tol}')
        modes[mode] = err
    # a kernel that left out mv_bf16_full's rounding would give mv_f32_full
    bf16_gap = float((refs['mv_bf16_full'] - refs['mv_f32_full']).abs().max())
    bf16_tol = rf.ABLATION_TOL['mv_bf16_full'] * float(
        refs['mv_bf16_full'].abs().max())
    if not bf16_gap > bf16_tol:
        raise AssertionError(f'mv_bf16_full: its rounding moves it by only '
                             f'{bf16_gap}, within the tolerance {bf16_tol}')
    _phase('B7 dh_ablation vs plain', t0, B=B_RAGGED, S=S_BENCH,
           max_abs_err=modes, bf16_rounding_moves=bf16_gap,
           bf16_tol=bf16_tol)
    return dict(args=(q, sup, w, spec), dual_err=dual, mode_err=modes,
                sweep_err=max(sweep.values()), hmma=hmma)


def roofline_path(dev):
    """The roofline entry points at their own shape; each result printed
    as one JSON line."""
    from diffco_tpu_torch.scripts import ab_dual_tile as ab
    from diffco_tpu_torch.scripts import roofline_fk_score as rf
    t0 = time.perf_counter()
    roof = rf.run(dev)
    _phase('roofline path: roofline_fk_score', t0,
           full_kernel_ms=roof['full_kernel_ms'],
           bench_step_ms=roof['bench_step_ms'],
           device_ms=roof['device_ms'])
    print(json.dumps({'roofline': roof}), flush=True)
    for key in ('bench_step_ms', 'full_kernel_ms', 'mv_f32_full_ms'):
        if not (roof[key] or 0) > 0:
            raise AssertionError(f'roofline {key}: {roof[key]} '
                                 f'(raw {roof["raw_ms"]})')
    t0 = time.perf_counter()
    dual = ab.run(dev)
    _phase('roofline path: ab_dual_tile', t0, prod_ms=dual['prod_ms'],
           device_ms={k: v['device_ms'] for k, v in dual['variants'].items()})
    print(json.dumps({'dual_tile_ab': dual}), flush=True)
    for name, v in dual['variants'].items():
        if not v['rel_grad_err_vs_prod'] < 1e-3:
            raise AssertionError(f'{name} against the B1 kernel: {v}')


def _eager_fk(st, q, g=None):
    """``_DHFkine``'s eager ops: points [B, 3P], or with point cotangents g
    the VJP dq [B, J]."""
    from diffco_tpu_torch.robots import fk_jvp
    axes, pts = fk_jvp.dh_chain(st, q)
    if g is None:
        return fk_jvp.stack_points(pts, flat=True)
    return fk_jvp.dh_vjp(st, axes, pts, g)


# (robot, B) for the DH FK kernels: Baxter's arm (P = 4) at the plan
# cells' batches (a problem's 7 restarts x 64 dense points, and 64 such
# problems), PandaFK (P = 7), its chain with 16 points (the KP = 16
# instance) and the dual arm's right chain (a base transform, q a block
# of columns)
FK_CASES = (('Baxter', 448), ('Baxter', 28672), ('PandaFK', 28672),
            ('PandaFK chain, 16 points', 28672), ('dual arm, right', 448))


def check_dh_fk_kernel(dev):
    """The DH FK and its VJP (csrc/dh_fk.cu through
    ``robots.fk_jvp._dh_fk_kernel``) at FK_CASES against the eager ops on
    the same float32 rows and in float64 (cotangents ~ N(0, 1)): points
    within 1e-5, dq within 1e-5 of its largest component, one launch a
    call. Returns the errors and Baxter's B = 28672 case for the kernel
    table."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch.robots import fk_jvp
    from diffco_tpu_torch.robots.analytic import panda_with_points
    t0 = time.perf_counter()
    cases, out = [], {}
    for name, B in FK_CASES:
        gen = torch.Generator().manual_seed(B + 11)
        if name == 'dual arm, right':
            robot = dc.BaxterDualArmFK()
            fk, q = robot._arm_fkine[1], robot.rand_configs(B, gen, dev)
            q = q[:, 7:14]
        else:
            robot = {'Baxter': dc.BaxterLeftArmFK, 'PandaFK': dc.PandaFK,
                     'PandaFK chain, 16 points':
                         lambda: panda_with_points(16)}[name]()
            fk, q = robot._fkine_flat, robot.rand_configs(B, gen, dev)
        st, c = fk.statics, fk.dh_spec
        g = torch.randn(B, 3 * c.P, generator=gen).to(dev)
        row = dict(robot=name, B=B, J=c.J, P=c.P)
        for kind, gk in (('fk', None), ('vjp', g)):
            before = _launch_counts()
            got = fk_jvp._dh_fk_kernel(q, c, gk)
            if _launch_counts() - before != {
                    'dh_fk' if gk is None else 'dh_fk_vjp': 1}:
                raise AssertionError(f'dh_fk {kind} on {name}: not one '
                                     'launch')
            tol = 1e-5 if kind == 'fk' else 1e-5 * max(
                1.0, float(got.abs().max()))
            for prec, qq, gg in (('f32', q, gk),
                                 ('f64', q.double(),
                                  None if gk is None else gk.double())):
                err = float((got.double() - _eager_fk(st, qq, gg).double()
                             ).abs().max())
                row[f'{kind}_err_{prec}'] = err
                if not err <= tol:
                    raise AssertionError(f'dh_fk {kind} on {name} at B = '
                                         f'{B}: {prec} error {err:.3g} > '
                                         f'{tol:.3g}')
        cases.append(row)
        if (name, B) == ('Baxter', 28672):
            out['args'] = (q, c, g, st)
    _phase('DH FK kernels', t0, cases=json.dumps(cases))
    out['cases'] = cases
    out['err'] = max(r['fk_err_f32'] for r in cases)
    out['vjp_err'] = max(r['vjp_err_f32'] for r in cases)
    return out


# (case, N, C, rows off in a warm start or None for a cold one,
# max_iteration or None for the fits' 3 N): the update's warm start with
# padded rows, the panda_dh and baxter_dh fits, one cut before done, the
# rope's fit, and C = 3 at the kernel's largest N
GREEDY_CASES = (('update', 820, 1, 100, None), ('fit', 4500, 1, None, None),
                ('max_iteration cut', 4500, 1, None, 100),
                ('rope fit', 9000, 1, None, None),
                ('C = 3', 16384, 3, None, None))
# the oscillating pair's iterations in the check and in the kernel table
GREEDY_PAIR_CHECK, GREEDY_PAIR_ITERATIONS = 500, 10000


def _greedy_problem(N, C, dev, seed):
    """A Gram K [N, N] (RQ kernel, gamma 10) of rows uniform in a cube and
    labels y [N, C] in +-1 from a wave, a phase a column (about half
    positive; the trainer runs ~0.4 N iterations, removals among them)."""
    from diffco_tpu_torch.kernels import RQKernel
    gen = torch.Generator().manual_seed(seed)
    X = (2 * torch.rand(N, 3, generator=gen) - 1).to(dev)
    y = torch.stack([torch.where(torch.sin(3 * X[:, 0] + c)
                                 * torch.cos(3 * X[:, 1]) + 0.3 * X[:, 2]
                                 > 0, 1.0, -1.0) for c in range(C)], 1)
    return RQKernel(10.0)(X, X).contiguous(), y


def _eager_train(K, y, beta, max_iteration, g0=None, h0=None, valid=None):
    """The greedy trainer's eager loop: ``_train_columns`` without the
    Gram."""
    from diffco_tpu_torch import perceptron
    return perceptron._train_columns(lambda idx: K[idx], torch.diagonal(K),
                                     y, beta, max_iteration, g0, h0, valid)


def check_greedy_train_kernel(dev):
    """The greedy trainer's kernel (csrc/greedy_train.cu through
    ``perceptron._train_kernel``) at GREEDY_CASES and on the oscillating
    pair (two rows on one point with opposite labels: no iteration
    finishes, so it runs to max_iteration) against the eager loop on the
    same inputs: equal gains and hypotheses in every bit, equal
    iterations, one ``launches.greedy_train`` and at most one kernel in
    a trace a call. Returns the cases and, for the kernel table, the inputs
    of the update, the fit, the rope's fit and the pair (at
    GREEDY_PAIR_ITERATIONS) with their iterations."""
    from diffco_tpu_torch import perceptron
    t0 = time.perf_counter()
    cases, out = [], {'args': {}, 'iterations': {}}
    pair = (torch.ones(2, 2, device=dev),
            torch.tensor([[1.0], [-1.0]], device=dev))
    for name, N, C, off, it in GREEDY_CASES + (
            ('oscillating pair', 2, 1, None, GREEDY_PAIR_CHECK),):
        K, y = pair if N == 2 else _greedy_problem(N, C, dev, N + C)
        it = 3 * N if it is None else it
        g0 = h0 = valid = None
        if off is not None:
            h = N // 2
            g, _, _ = _eager_train(K[:h, :h].contiguous(), y[:h], 1.0, 60)
            g0 = torch.cat([g, g.new_zeros(N - h, C)])
            h0 = K @ g0
            valid = torch.ones(N, dtype=torch.bool, device=dev)
            valid[torch.randperm(N, generator=torch.Generator()
                                 .manual_seed(N))[:off].to(dev)] = False
        args = (K, y, 1.0, it, g0, h0, valid)
        if not perceptron.takes_train_kernel(K, y, it, g0, h0):
            raise AssertionError(f'greedy_train {name}: not on the kernel')
        calls = profiling.counter('launches.greedy_train')
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            got = perceptron._train_kernel(*args)
            torch.cuda.synchronize()
        launched = sum('greedy_train_kernel' in e.name()
                       for e in prof.profiler.kineto_results.events()
                       if e.device_type() == torch.autograd.DeviceType.CUDA)
        if (profiling.counter('launches.greedy_train') != calls + 1
                or launched > 1):
            raise AssertionError(f'greedy_train {name}: not one launch '
                                 f'({launched} in the trace)')
        t1 = time.perf_counter()
        ref = _eager_train(*args)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t1
        for a, b, what in ((got[0], ref[0], 'gains'),
                           (got[1], ref[1], 'hypothesis')):
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise AssertionError(f'greedy_train {name}: {what} differ '
                                     'from the eager loop\'s')
        n = int(got[2])
        if n != int(ref[2]) or (N == 2 and n != it):
            raise AssertionError(f'greedy_train {name}: {n} iterations, '
                                 f'the eager loop {int(ref[2])}')
        cases.append(dict(case=name, N=N, C=C, iterations=n,
                          eager_ms_per_iteration=1e3 * eager_s / max(n, 1)))
        if name in ('update', 'fit', 'rope fit', 'oscillating pair'):
            if N == 2:
                args = args[:3] + (GREEDY_PAIR_ITERATIONS,) + args[4:]
                n = GREEDY_PAIR_ITERATIONS
            out['args'][name], out['iterations'][name] = args, n
    _phase('greedy trainer kernel', t0, cases=json.dumps(cases))
    out['cases'] = cases
    return out


def _scene():
    import diffco_tpu_torch as dc
    # the box + sphere of tests/test_checkers.py::panda_world
    return dc.ShapeEnv({k: v for k, v in _shapes().items()
                        if k in ('box1', 'sphere1')})


def _shapes():
    def T(t):
        m = np.eye(4)
        m[:3, 3] = t
        return m
    # the 4-shape scene of tests/test_checkers.py::panda_world
    return {
        'box1': {'type': 'Box', 'params': {'extents': [0.1, 0.1, 0.1]},
                 'transform': T([0.5, 0.5, 0.5])},
        'sphere1': {'type': 'Sphere', 'params': {'radius': 0.1},
                    'transform': T([0.5, 0, 0])},
        'cylinder1': {'type': 'Cylinder',
                      'params': {'radius': 0.1, 'height': 0.2},
                      'transform': T([0, -0.5, 0.5])},
        'capsule1': {'type': 'Capsule',
                     'params': {'radius': 0.1, 'height': 0.2},
                     'transform': T([0.5, 0.5, 0])}}


def _problems(robot, gt, dev, n, seed=7):
    """n (start, target) pairs of ground-truth-free configurations whose
    straight line collides."""
    from diffco_tpu_torch.utils import dense_path
    g = torch.Generator().manual_seed(seed)
    q = robot.rand_configs(4096, g, dev)
    free = q[~gt(q)]
    pairs = []
    for i in range(0, free.shape[0] - 1, 2):
        line = dense_path(torch.stack([free[i], free[i + 1]]), 200)
        if bool(gt(line).any()):
            pairs.append((free[i], free[i + 1]))
        if len(pairs) == n:
            return pairs
    raise AssertionError(f'found only {len(pairs)} colliding straight lines')


def _fit(checker, num_samples, tag, verify=True, min_tpr=0.9):
    t0 = time.perf_counter()
    acc, tpr, tnr = checker.fit(num_samples=num_samples)
    torch.cuda.synchronize()
    p = checker.perceptron
    _phase(f'{tag} fit', t0, samples=num_samples,
           iterations=p.train_iterations, supports=p.num_valid, acc=acc,
           tpr=tpr, tnr=tnr, safety_bias=checker.safety_bias)
    if not tpr >= min_tpr:
        raise AssertionError(f'{tag} fit TPR {tpr} < {min_tpr}')
    if not verify:
        return
    t0 = time.perf_counter()
    vacc, vtpr, vtnr = checker.verify(num_samples=VERIFY_SAMPLES)
    _phase(f'{tag} verify', t0, configs=VERIFY_SAMPLES, acc=vacc, tpr=vtpr,
           tnr=vtnr)


def _sweeps(checker, robot, gt, dev, kernel_plain, tag):
    """Both sweeps with their gradients, as an optimizer takes them: the
    backward of each kernel's autograd Function returns the dq (dx) of
    the same launch. Then each sweep's kernel against its plain twin at
    the fitted supports, with the error beside the values' own scale."""
    from diffco_tpu_torch.ops import fused_score
    t0 = time.perf_counter()
    p = checker.perceptron
    q = robot.rand_configs(B_BENCH, torch.Generator().manual_seed(3), dev)
    qg = q.clone().requires_grad_(True)
    xg = robot.fkine(q).requires_grad_(True)
    s_q = checker.collision_score(qg)
    s_p = checker.collision_score(q_link_pos=xg)
    dq, = torch.autograd.grad(s_q.sum(), qg)
    dx, = torch.autograd.grad(s_p.sum(), xg)
    s_q, s_p, dx = s_q.detach(), s_p.detach(), dx.reshape(B_BENCH, -1)
    torch.cuda.synchronize()
    if s_q.shape != (B_BENCH, 1) or not bool(torch.isfinite(s_q).all()):
        raise AssertionError(f'{tag} collision_score: bad shape or '
                             'non-finite')
    # the same proxy from configurations (B1 / B3) and from link points (B2)
    _check_close(f'{tag} collision_score q vs q_link_pos', s_q, s_p, 1e-3)
    _phase(f'{tag} collision_score sweeps', t0, configs=B_BENCH,
           supports=p.support_transformed.shape[0], F=dx.shape[1],
           gt_agreement=float(((s_q.reshape(-1) > 0) == gt(q)).float()
                              .mean()))
    # each sweep's kernel against its plain twin at the fitted supports.
    # Fitted weights alternate in sign and sum |w_j| r_j far beyond
    # |score|, so the twin runs in float64 here: in float32 its own
    # rounding (~1e-4 at these supports) would take up the tolerance
    w = p.rbf_nodes * p.valid_mask.to(p.rbf_nodes.dtype) / p.rbf_kernel.epsilon
    sup = p.support_transformed
    q64, sup64, w64 = q.double(), sup.double(), w.double()
    x64 = robot.fkine(q64).reshape(B_BENCH, -1)
    with torch.no_grad():
        ref_q, ref_dq = kernel_plain(q64, sup64, w64)
        ref_p, ref_dx = fused_score._poly_score_grad_plain(x64, sup64, w64)
        # the same in float64 on the kernel's own float32 points: what is
        # left is the kernel's error, not the FK's float32 rounding
        ref_ps, ref_dxs = fused_score._poly_score_grad_plain(
            xg.detach().reshape(B_BENCH, -1).double(), sup64, w64)
        twin_q, twin_dq = kernel_plain(q, sup, w)
        cond = max(float((torch.cdist(xc, sup64) * w64.abs()).sum(1).max())
                   for xc in torch.split(x64, 8192))
    bias = checker.safety_bias
    out_q = (s_q.reshape(-1) - bias).double()
    out_p = (s_p.reshape(-1) - bias).double()
    _check_close(f'{tag} collision_score(q) vs plain twin', out_q, ref_q,
                 1e-4)
    _check_close(f'{tag} collision_score(q) dq vs plain twin', dq.double(),
                 ref_dq, 1e-3)
    _check_close(f'{tag} collision_score(q_link_pos) vs plain twin', out_p,
                 ref_p, 1e-4)
    _check_close(f'{tag} collision_score(q_link_pos) dx vs plain twin',
                 dx.double(), ref_dx, 1e-3)
    pq = [(out_q, ref_q), (dq.double(), ref_dq)]
    pp = [(out_p, ref_p), (dx.double(), ref_dx)]
    tw = [(twin_q.double(), ref_q), (twin_dq.double(), ref_dq)]
    print(f'{tag} sweeps vs the plain twin in float64 at S = {sup.shape[0]}:'
          f' from q max_abs_err score {_max_err(pq[:1])} grad '
          f'{_max_err(pq[1:])}; from points score {_max_err(pp[:1])} grad '
          f'{_max_err(pp[1:])}; the float32 plain twin itself score '
          f'{_max_err(tw[:1])} grad {_max_err(tw[1:])}; max |score| '
          f'{float(ref_q.abs().max())}, max |dq| '
          f'{float(ref_dq.abs().max())}, max sum_j |w_j| r_j {cond}; '
          f'max_rel_err (to max |score|, max |dq|) from q score '
          f'{_rel_err(pq[:1])} grad {_rel_err(pq[1:])}', flush=True)
    return dict(q=q, sup=sup, w=w, ref_q=ref_q, ref_dq=ref_dq,
                x=robot.fkine(q).reshape(B_BENCH, -1).contiguous(),
                ref_p=ref_p, ref_dx=ref_dx, err_q=_max_err(pq),
                err_p=_max_err(pp),
                errs=dict(score_q=_max_err(pq[:1]), dq=_max_err(pq[1:]),
                          score_p=_max_err(pp[:1]), dx=_max_err(pp[1:]),
                          score_p_same=_max_err([(out_p, ref_ps)]),
                          dx_same=_max_err([(dx.double(), ref_dxs)])))


def _guard_share(fitted, tag, kernels):
    """The near-pair guard of the tensor-core kernels on a fitted sweep:
    for each of ``kernels``, (name, measurement entry run on the sweep's
    inputs at a threshold, 'q' or 'points'), and each threshold of
    GUARD_KAPPAS (the production one marked), the share of (row, support)
    pairs it recomputes and the kernel's error against the float64 twin
    there, from the kernel's measurement build. Fails unless the
    production threshold's scores and gradients are within the sweep's
    tolerances (1e-4, 1e-3)."""
    from diffco_tpu_torch.ops import _native
    pairs = fitted['q'].shape[0] * fitted['sup'].shape[0]
    out = {}
    for name, run, frm in kernels:
        ref = ((fitted['ref_q'], fitted['ref_dq']) if frm == 'q' else
               (fitted['ref_p'], fitted['ref_dx']))
        rows = out[name] = []
        for kappa in GUARD_KAPPAS:
            score, grad, n = run(kappa)
            torch.cuda.synchronize()
            e = [(score.double(), ref[0]), (grad.double(), ref[1])]
            rows.append(dict(kappa=kappa, share=n / pairs, pairs=n,
                             score_err=_max_err(e[:1]),
                             grad_err=_max_err(e[1:])))
            if kappa == _native.TC_GUARD:
                _check_close(f'{tag} {name} at the production guard, score',
                             *e[0], 1e-4)
                _check_close(f'{tag} {name} at the production guard, '
                             'gradient', *e[1], 1e-3)
        print(f'{tag} {name} near-pair guard on the fitted sweep from {frm} '
              f'({pairs} pairs, production kappa = {_native.TC_GUARD}): '
              f'{json.dumps(rows)}', flush=True)
    return out


def _multi_sweeps(checker, robot, gt, dev, kernel_plain, tag):
    """The multi-class sweep with a class-mixed gradient, as an optimizer
    of a weighted sum of class scores takes it: the backward of the
    kernel's autograd Function returns einsum(g, dq) of the same launch.
    Then the kernel against its plain twin in float64 at the fitted
    supports (W = the per-class nodes), as in _sweeps."""
    t0 = time.perf_counter()
    p = checker.perceptron
    C = p.num_class
    q = robot.rand_configs(B_BENCH, torch.Generator().manual_seed(3), dev)
    mix = _class_weights(B_BENCH, C, dev, seed=4)
    qg = q.clone().requires_grad_(True)
    s_q = checker.collision_score(qg)
    dq, = torch.autograd.grad((s_q * mix).sum(), qg)
    s_q = s_q.detach()
    torch.cuda.synchronize()
    if s_q.shape != (B_BENCH, C) or not bool(torch.isfinite(s_q).all()):
        raise AssertionError(f'{tag} collision_score: bad shape or '
                             'non-finite')
    # the same proxy from link points (the plain [B, S] @ [S, C] route)
    s_p = checker.collision_score(q_link_pos=robot.fkine(q))
    _check_close(f'{tag} collision_score q vs q_link_pos', s_q, s_p, 1e-3)
    _phase(f'{tag} collision_score sweeps', t0, configs=B_BENCH, classes=C,
           supports=p.support_transformed.shape[0],
           gt_agreement_per_class=[round(float(a), 4) for a in (
               (s_q > 0) == gt(q)).float().mean(0)])
    W = (p.rbf_nodes * p.valid_mask.to(p.rbf_nodes.dtype)[:, None]
         / p.rbf_kernel.epsilon)
    sup = p.support_transformed
    with torch.no_grad():
        ref_q, ref_dq = kernel_plain(q.double(), sup.double(), W.double())
        twin_q, twin_dq = kernel_plain(q, sup, W)
    ref_g = torch.einsum('bc,cbj->bj', mix.double(), ref_dq)
    twin_g = torch.einsum('bc,cbj->bj', mix, twin_dq).double()
    out_q = (s_q - checker.safety_bias).double()
    _check_close(f'{tag} collision_score(q) vs plain twin', out_q, ref_q,
                 1e-4)
    _check_close(f'{tag} collision_score(q) class-mixed dq vs plain twin',
                 dq.double(), ref_g, 1e-3)
    pq = [(out_q, ref_q), (dq.double(), ref_g)]
    tw = [(twin_q.double(), ref_q), (twin_g, ref_g)]
    print(f'{tag} sweeps vs the plain twin in float64 at S = {sup.shape[0]},'
          f' C = {C}: max_abs_err score {_max_err(pq[:1])} grad '
          f'{_max_err(pq[1:])}; the float32 plain twin itself score '
          f'{_max_err(tw[:1])} grad {_max_err(tw[1:])}; max |score| '
          f'{float(ref_q.abs().max())}, max |grad| '
          f'{float(ref_g.abs().max())}', flush=True)


def _solve(checker, robot, gt, dev, pairs, dist_est=None, **options):
    """Adam trajectory optimization (TRAJ_OPTIONS) of each (start, target)
    pair, each path checked against the ground truth gt (bool [B]) at 10
    points per segment: [(success, GT-valid, cost, seconds, hits,
    solution)]. dist_est defaults to the checker's unbiased score."""
    from diffco_tpu_torch import optim
    from diffco_tpu_torch.utils import dense_path
    if dist_est is None:
        def dist_est(pp):
            return checker.collision_score(pp, bias=0).reshape(-1)
    results = []
    for i, (start, target) in enumerate(pairs):
        opts = dict(TRAJ_OPTIONS, seed=i,
                    safety_margin=-checker.safety_bias, **options)
        rec = optim.adam_traj_optimize(robot, dist_est, start, target, opts)
        sol = torch.as_tensor(rec['solution'], device=dev)
        hits = int(gt(dense_path(sol, 10)).sum())
        results.append((rec['success'], hits == 0, rec['cost'], rec['time'],
                        hits, sol))
    torch.cuda.synchronize()
    return results


def _trajopt(checker, robot, gt, dev, tag, dist_est=None, n=N_PROBLEMS,
             **options):
    """_solve on the first n of N_PROBLEMS problems; fails on a non-finite
    cost or without a ground-truth-valid path."""
    t0 = time.perf_counter()
    results = _solve(checker, robot, gt, dev,
                     _problems(robot, gt, dev, N_PROBLEMS)[:n], dist_est,
                     **options)
    _phase(f'{tag} trajopt', t0, problems=n,
           success=[r[0] for r in results], gt_valid=[r[1] for r in results],
           gt_hits_of_191=[r[4] for r in results],
           cost=[round(r[2], 4) for r in results],
           seconds=[round(r[3], 2) for r in results])
    if not all(math.isfinite(r[2]) for r in results):
        raise AssertionError(f'{tag} trajopt: non-finite cost')
    if not any(r[1] for r in results):
        raise AssertionError(f'{tag} trajopt: no ground-truth-valid path')


def journey(robot, dev):
    """The PandaFK path through the entry points a user calls."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch.ops import fk_score, fused_score
    env = _scene()
    gt = dc.CapsuleChainCollision(robot, link_radius=LINK_RADIUS) \
        .checker_fn(env)
    checker = dc.ForwardKinematicsDiffCo(robot=robot, environment=env,
                                         gt_check_func=gt, seed=0,
                                         device=dev)
    _fit(checker, FIT_SAMPLES, 'PandaFK')
    spec = fk_score.robot_spec(robot)
    fitted = _sweeps(checker, robot, gt, dev,
                     lambda q, s, w: fk_score._dh_score_grad_plain(q, s, w,
                                                                   spec),
                     'PandaFK')
    _guard_share(fitted, 'PandaFK', [
        ('B1', lambda k: fk_score.dh_score_guard_pairs(
            fitted['q'], fitted['sup'], fitted['w'], spec, k), 'q'),
        ('B2', lambda k: fused_score.poly_score_guard_pairs(
            fitted['x'], fitted['sup'], fitted['w'], k), 'points')])
    _trajopt(checker, robot, gt, dev, 'PandaFK')


def _agreement(checker, q, truth):
    """The proxy's labels on q against the ground truth's: the share of
    configurations where the unbiased score's sign agrees with it (the
    proxy's own classification), and where the biased one does, with the
    biased labels' TPR (the safe labels a planner reads). Scores through
    collision_score (B1 at this batch); fails on a non-finite score."""
    with torch.no_grad():
        score = checker.collision_score(q, bias=0).reshape(-1)
    if not bool(torch.isfinite(score).all()):
        raise AssertionError('collision_score: non-finite score')
    biased = score + checker.safety_bias > 0
    return dict(agreement=float(((score > 0) == truth).float().mean()),
                biased_agreement=float((biased == truth).float().mean()),
                tpr=float((biased & truth).sum() / truth.sum().clamp(min=1)))


def active_journey(robot, dev):
    """The active-learning path: PandaFK in the panda_world scene with a
    HybridForwardKinematicsDiffCo; sphere1 moves ACTIVE_MOVES times, each
    time the ground truth is rebound to the moved scene and the proxy
    updated (update(num_samples=ACTIVE_UPDATE_SAMPLES,
    verify=ACTIVE_VERIFY)), its agreement with that ground truth measured
    on a fixed sweep before and after (_agreement; fails if the update
    lowers it); then Adam on ACTIVE_PROBLEMS
    problems, a path-targeted update on their solutions (and the straight
    line of each problem whose solution is not GT-valid), Adam again; the
    sweeps through B1 and B2 against the float64 twin at the final
    supports; the hybrid recheck against the raw proxy, and
    OptimisticChecker.in_collision on one path in both modes."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch.ops import fk_score
    from diffco_tpu_torch.utils import dense_path
    env = _scene()
    cap = dc.CapsuleChainCollision(robot, link_radius=LINK_RADIUS)
    checker = dc.HybridForwardKinematicsDiffCo(
        robot=robot, environment=env, gt_check_func=cap.checker_fn(env),
        seed=0, device=dev)
    _fit(checker, FIT_SAMPLES, 'PandaFK active', verify=False)
    p = checker.perceptron
    q_sweep = robot.rand_configs(ACTIVE_SWEEP,
                                 torch.Generator().manual_seed(8), dev)
    max_s = p.support_transformed.shape[0]
    steps = []
    for step, x in enumerate(np.linspace(*ACTIVE_X, ACTIVE_MOVES)):
        t0 = time.perf_counter()
        pose = np.eye(4)
        pose[:3, 3] = (x, *ACTIVE_YZ)
        env.update_transform('sphere1', pose)
        # a bound ground truth keeps the scene it was bound to: rebind
        gt = checker.gt_check_func = cap.checker_fn(env)
        truth = gt(q_sweep)
        stale = _agreement(checker, q_sweep, truth)
        t1 = time.perf_counter()
        acc, tpr, tnr = checker.update(num_samples=ACTIVE_UPDATE_SAMPLES,
                                       verify=ACTIVE_VERIFY)
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t1
        fresh = _agreement(checker, q_sweep, truth)
        max_s = max(max_s, p.support_transformed.shape[0])
        steps.append(dict(update_s=update_s, supports=p.num_valid,
                          padded=p.support_transformed.shape[0]))
        _phase(f'PandaFK active, move {step + 1} of {ACTIVE_MOVES}', t0,
               sphere1=[round(float(x), 4), *ACTIVE_YZ],
               update_s=round(update_s, 3), supports=p.num_valid,
               padded_supports=p.support_transformed.shape[0],
               iterations=p.train_iterations, verify_acc=acc,
               verify_tpr=tpr, verify_tnr=tnr, sweep_tpr_before=stale['tpr'],
               sweep_tpr_after=fresh['tpr'],
               agreement_before=stale['agreement'],
               agreement_after=fresh['agreement'],
               biased_agreement_before=stale['biased_agreement'],
               biased_agreement_after=fresh['biased_agreement'],
               colliding_share=float(truth.float().mean()),
               safety_bias=checker.safety_bias)
        if not fresh['agreement'] >= stale['agreement']:
            raise AssertionError(
                f'PandaFK active move {step + 1}: the proxy agrees with the '
                f'moved scene on {fresh["agreement"]} after the update, '
                f'{stale["agreement"]} before')

    t0 = time.perf_counter()
    pairs = _problems(robot, gt, dev, ACTIVE_PROBLEMS)
    before = _solve(checker, robot, gt, dev, pairs)
    paths = [r[5] for r in before] + [
        dense_path(torch.stack(pair), 19)
        for pair, r in zip(pairs, before) if not r[1]]
    t1 = time.perf_counter()
    acc, tpr, tnr = checker.update(exploit_paths=paths,
                                   num_exploit_samples=ACTIVE_EXPLOIT,
                                   verify=ACTIVE_VERIFY)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t1
    max_s = max(max_s, p.support_transformed.shape[0])
    after = _solve(checker, robot, gt, dev, pairs)
    costs = [r[2] for r in before + after]
    _phase('PandaFK active, path-targeted update', t0,
           problems=ACTIVE_PROBLEMS, exploit_paths=len(paths),
           update_s=round(update_s, 3), supports=p.num_valid,
           verify_acc=acc, verify_tpr=tpr, verify_tnr=tnr,
           gt_valid_before=[r[1] for r in before],
           gt_valid_after=[r[1] for r in after],
           gt_hits_before=[r[4] for r in before],
           gt_hits_after=[r[4] for r in after],
           cost=[round(c, 4) for c in costs],
           seconds=[round(r[3], 2) for r in before + after])
    if not all(math.isfinite(c) for c in costs):
        raise AssertionError('PandaFK active trajopt: non-finite cost')

    spec = fk_score.robot_spec(robot)
    _sweeps(checker, robot, gt, dev,
            lambda q, s, w: fk_score._dh_score_grad_plain(q, s, w, spec),
            'PandaFK active')
    print(f'PandaFK active: largest S of the run {max_s} (padded), final '
          f'{p.support_transformed.shape[0]} with {p.num_valid} supports; '
          f'seconds per update {[round(s["update_s"], 3) for s in steps]}, '
          f'supports per move {[s["supports"] for s in steps]}', flush=True)

    t0 = time.perf_counter()
    q = robot.rand_configs(ACTIVE_RECHECK, torch.Generator().manual_seed(9),
                           dev)
    truth = gt(q)
    hybrid = checker.collision(q)
    raw = _agreement(checker, q, truth)
    agree_h = float((hybrid == truth).float().mean())
    optimistic = dc.OptimisticChecker(robot=robot, environment=env,
                                      gt_check_func=gt, device=dev)
    optimistic.perceptron, optimistic.safety_bias = p, checker.safety_bias
    path = paths[0]
    answers = [optimistic.in_collision(path, optimistic=o)
               for o in (False, True)]
    _phase('PandaFK active, hybrid recheck', t0, configs=ACTIVE_RECHECK,
           hybrid_agreement=agree_h,
           raw_agreement=raw['biased_agreement'],
           raw_unbiased_agreement=raw['agreement'],
           optimistic_in_collision={'False': answers[0], 'True': answers[1]},
           gt_hits_on_the_path=int(gt(path).sum()))
    # the reference's own assertion (tests/test_checkers2.py): against the
    # raw proxy's labels, collision_score(q) > 0
    if not agree_h >= raw['biased_agreement']:
        raise AssertionError(f'PandaFK active: the hybrid recheck agrees '
                             f'with the ground truth on {agree_h}, below '
                             f'the raw proxy\'s {raw["biased_agreement"]}')
    return dict(max_s=max_s, steps=steps)


def urdf_journey(dev):
    """The README quick start at the flagship test's width
    (tests/test_checkers.py::test_fk_diffco_panda_fit): FrankaPanda with
    24-sphere links and the ACM in the 4-shape scene, the robot's own
    ground truth (environment + self collision); fit on 3000 samples,
    verify and the sweeps; then a refit on URDF_TRAJ_FIT_SAMPLES for the
    trajectory optimization, which checks its paths URDF_TRAJ_DENSE_SUB
    points per segment."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch.ops import fk_score, fused_score
    t0 = time.perf_counter()
    robot = dc.FrankaPanda(load_gripper=True, setup_acm=True,
                           link_spheres=24, device=dev)
    env = dc.ShapeEnv(_shapes())
    checker = dc.ForwardKinematicsDiffCo(robot=robot, environment=env,
                                         seed=0, device=dev)
    gt = checker.gt_check_func
    _phase('FrankaPanda robot', t0, urdf=robot.urdf_path.split('/')[-1],
           dof=robot.dof, spheres=robot.link_sphere_centers.shape[0],
           self_pairs=robot._self_pair_i.shape[0],
           control_points=len(robot.unique_position_link_names))
    _fit(checker, URDF_FIT_SAMPLES, 'FrankaPanda')
    cs = fk_score.robot_chain_statics(robot)
    fitted = _sweeps(checker, robot, gt, dev,
                     lambda q, s, w: fk_score._chain_score_grad_plain(
                         q, s, w, cs), 'FrankaPanda')
    _guard_share(fitted, 'FrankaPanda', [
        ('B3', lambda k: fk_score.chain_score_guard_pairs(
            fitted['q'], fitted['sup'], fitted['w'], cs, k), 'q'),
        ('B2', lambda k: fused_score.poly_score_guard_pairs(
            fitted['x'], fitted['sup'], fitted['w'], k), 'points')])
    _fit(checker, URDF_TRAJ_FIT_SAMPLES, 'FrankaPanda trajopt', verify=False)
    _trajopt(checker, robot, gt, dev, 'FrankaPanda',
             dense_sub=URDF_TRAJ_DENSE_SUB)


def _baxter_shapes():
    def T(t):
        m = np.eye(4)
        m[:3, 3] = t
        return m
    # scripts/baxter_trajopt_benchmark.py's scene
    return {'table': {'type': 'Box', 'params': {'extents': [0.8, 0.8, 0.05]},
                      'transform': T([0.7, 0.0, -0.1])},
            'pole': {'type': 'Cylinder',
                     'params': {'radius': 0.1, 'height': 1.2},
                     'transform': T([0.6, 0.3, 0.5])},
            'ball': {'type': 'Sphere', 'params': {'radius': 0.15},
                     'transform': T([0.4, -0.35, 0.3])}}


def _gt_valid(gt, sols):
    """Per path [P, N, dof]: no ground-truth hit on the dense path, 8
    points per segment (the benchmarks' validation)."""
    from diffco_tpu_torch.utils import dense_path
    dense = dense_path(sols, 8)[:, 1:-1]
    hits = gt(dense.reshape(-1, dense.shape[-1])).reshape(sols.shape[0], -1)
    return ~hits.any(dim=1)


def baxter_journey(dev):
    """The Baxter benchmarks' journey on BaxterLeftArmFK (4 control
    points: B1's and B2's FP = 16 instances): fit on 5000 samples, verify
    and the sweeps against the float64 twin; N_BATCH problems in one
    adam_traj_optimize_batch, checked against the ground truth and the
    failures repaired in one more batch against its signed distance;
    al_traj_optimize on the first N_AL; SLSQP and trust-constr (free
    waypoints) on one problem each, evaluated on CPU float64 tensors (the
    scipy paths' route); one Weighted.step."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch import optim
    from diffco_tpu_torch.ops import fk_score
    t0 = time.perf_counter()
    robot = dc.BaxterLeftArmFK()
    env = dc.ShapeEnv(_baxter_shapes())
    cap = dc.CapsuleChainCollision(robot, link_radius=BAXTER_LINK_RADIUS,
                                   per_seg=4)
    gt = cap.checker_fn(env)
    checker = dc.ForwardKinematicsDiffCo(robot=robot, gt_check_func=gt,
                                         seed=0, device=dev)
    b1_before = profiling.counter('launches.dh_score_grad')
    _fit(checker, FIT_SAMPLES, 'Baxter')
    spec = fk_score.robot_spec(robot)
    _sweeps(checker, robot, gt, dev,
            lambda q, s, w: fk_score._dh_score_grad_plain(q, s, w, spec),
            'Baxter')
    b1 = profiling.counter('launches.dh_score_grad') - b1_before
    _phase('Baxter fit and sweeps (B1 at FP = 16 on the fitted proxy)', t0,
           b1_launches=b1, points=len(spec[1]))
    if b1 <= 0:
        raise AssertionError('Baxter fit and sweeps: B1 never launched')

    # N_BATCH free (start, target) pairs, as batch_trajopt_bench.py picks
    q = robot.rand_configs(4096, torch.Generator().manual_seed(7), dev)
    idx = torch.nonzero(~gt(q)).reshape(-1)
    starts = q[idx[0:2 * N_BATCH:2]]
    targets = q[idx.flip(0)[0:2 * N_BATCH:2]]
    dist_est = checker.score_fn(bias=0.0)
    opts = dict(BAXTER_TRAJ, safety_margin=-checker.safety_bias)

    t_batch = t0 = time.perf_counter()
    recs = optim.adam_traj_optimize_batch(robot, dist_est, starts, targets,
                                          opts)
    sols = torch.tensor([r['solution'] for r in recs], device=dev)
    valid = _gt_valid(gt, sols)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    before = float(valid.float().mean())
    t0 = time.perf_counter()
    fixed = optim.adam_traj_optimize_batch(
        robot, lambda qq: cap.signed_dist(qq, env), starts, targets,
        dict(opts, **REPAIR_TRAJ, init_solutions=sols.cpu().numpy()))
    bad = ~valid
    sols[bad] = torch.tensor([r['solution'] for r in fixed],
                             device=dev)[bad]
    valid = _gt_valid(gt, sols)
    torch.cuda.synchronize()
    repair_s = time.perf_counter() - t0
    costs = [r['cost'] for r in recs + fixed]
    _phase('Baxter batched Adam', t_batch, problems=N_BATCH,
           batch_s=round(batch_s, 3), repair_s=round(repair_s, 3),
           repaired=int(bad.sum()), gt_valid_before=before,
           gt_valid_after=float(valid.float().mean()),
           success=float(np.mean([r['success'] for r in recs])))
    if not all(math.isfinite(c) for c in costs):
        raise AssertionError('Baxter batched Adam: non-finite cost')

    t0 = time.perf_counter()
    al = []
    for i in range(N_AL):
        rec = optim.al_traj_optimize(robot, dist_est, starts[i], targets[i],
                                     dict(opts, seed=i, num_sub=4))
        ok = bool(_gt_valid(gt, torch.tensor([rec['solution']],
                                             device=dev))[0])
        al.append((rec, ok))
    torch.cuda.synchronize()
    _phase('Baxter augmented Lagrangian', t0, problems=N_AL,
           seconds=[round(r['time'], 2) for r, _ in al],
           success=[r['success'] for r, _ in al],
           max_violation=[r['max_violation'] for r, _ in al],
           gt_valid=[ok for _, ok in al], cost=[r['cost'] for r, _ in al])
    if not all(math.isfinite(r['cost']) and math.isfinite(r['max_violation'])
               for r, _ in al):
        raise AssertionError('Baxter AL: non-finite cost or violation')
    if not any(ok for _, ok in al):
        raise AssertionError('Baxter AL: no ground-truth-valid path')

    for i, (name, extra) in enumerate((
            ('givengrad', {}),
            ('trustconstr', {'free_waypoints': TC_FREE_WAYPOINTS}))):
        t0 = time.perf_counter()
        rec = getattr(optim, f'{name}_traj_optimize')(
            robot, dist_est, starts[N_AL + i], targets[N_AL + i],
            dict(opts, **SCIPY_OPTIONS, **extra))
        ok = bool(_gt_valid(gt, torch.tensor([rec['solution']],
                                             device=dev))[0])
        _phase(f'Baxter {name} (scipy; derivatives on '
               f'{rec["eval_device"]} {rec["eval_dtype"]})', t0,
               seconds=round(rec['time'], 2), success=rec['success'],
               feasible=rec['feasible'], gt_valid=ok, cost=rec['cost'],
               cnt_check=rec['cnt_check'], **SCIPY_OPTIONS, **extra)
        if not math.isfinite(rec['cost']):
            raise AssertionError(f'Baxter {name}: non-finite cost')

    t0 = time.perf_counter()
    stepper = optim.Weighted(robot, checker.perceptron, {
        'n_waypoints': BAXTER_TRAJ['N_WAYPOINTS'], 'maxiter': WEIGHTED_STEPS,
        'max_move_weight': 10.0, 'collision_weight': 10.0,
        'joint_limit_weight': 10.0, 'safety_bias': checker.safety_bias,
        'max_speed': 2.0, 'dense_check': True, 'num_sub': 4,
        'optimizer_params': {'lr': 0.1}})
    line = torch.stack([torch.linspace(0, 1, BAXTER_TRAJ['N_WAYPOINTS'],
                                       device=dev)] * 7, 1)
    p0 = starts[0] + line * (targets[0] - starts[0])
    res = stepper.step(p0)
    torch.cuda.synchronize()
    _phase('Baxter Weighted.step', t0, maxiter=WEIGHTED_STEPS,
           device=res.x.device, finite=bool(torch.isfinite(res.x).all()))
    if res.x.device.type != 'cuda' or not bool(torch.isfinite(res.x).all()):
        raise AssertionError('Baxter Weighted.step: off the card or '
                             'non-finite')


def _per_shape_gt(robot, names):
    """Ground truth [B, len(names)]: one capsule-chain check per shape."""
    import diffco_tpu_torch as dc
    shapes = _shapes()
    cap = dc.CapsuleChainCollision(robot, link_radius=LINK_RADIUS)
    fns = [cap.checker_fn(dc.ShapeEnv({k: shapes[k]})) for k in names]
    return lambda q: torch.stack([f(q) for f in fns], dim=1)


def multi_journey(robot, dev):
    """The PandaFK multi-class path: a MultiDiffCo over the box and the
    sphere (one class each); trajectory optimization on the max over
    classes of the unbiased score, with the ground truth 'any class'."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch.ops import fk_score
    gt = _per_shape_gt(robot, ('box1', 'sphere1'))
    checker = dc.ForwardKinematicsDiffCo(
        robot=robot, environment=_scene(), gt_check_func=gt,
        perceptron_class=dc.MultiDiffCo, seed=0, device=dev)
    _fit(checker, FIT_SAMPLES, 'PandaFK multi-class')
    spec = fk_score.robot_spec(robot)
    _multi_sweeps(checker, robot, gt, dev,
                  lambda q, s, W: fk_score._dh_multi_score_grad_plain(
                      q, s, W, spec), 'PandaFK multi-class')
    _trajopt(checker, robot, lambda q: gt(q).any(-1), dev,
             'PandaFK multi-class',
             dist_est=lambda pp: checker.collision_score(pp, bias=0)
             .amax(-1), n=N_MULTI_PROBLEMS)


def urdf_multi_journey(dev):
    """The FrankaPanda multi-class path at the quick start's width
    (24-sphere links, ACM, the 4-shape scene): five classes, the robot's
    self-collision and each shape, from robot.collision_signed_dist; fit
    on 3000 samples, verify and the sweeps. Its trajopt batches would sit
    below the kernels' gate, so it runs none."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch.ops import fk_score
    robot = dc.FrankaPanda(load_gripper=True, setup_acm=True,
                           link_spheres=24, device=dev)
    env = dc.ShapeEnv(_shapes())

    def gt(q):
        env_sd, self_sd = robot.collision_signed_dist(q, env)
        return torch.cat([self_sd[:, None] > 0, env_sd > 0], dim=1)

    checker = dc.ForwardKinematicsDiffCo(
        robot=robot, environment=env, gt_check_func=gt,
        perceptron_class=dc.MultiDiffCo, seed=0, device=dev)
    _fit(checker, URDF_FIT_SAMPLES, 'FrankaPanda multi-class')
    cs = fk_score.robot_chain_statics(robot)
    _multi_sweeps(checker, robot, gt, dev,
                  lambda q, s, W: fk_score._chain_multi_score_grad_plain(
                      q, s, W, cs), 'FrankaPanda multi-class')


def _check_fitted_poly(tag, perceptron, x, score, dx):
    """B2's output on a fitted proxy's sweep (score [B], dx [B, F] of one
    launch) against the plain twin in float64: 1e-4 (score), 1e-3 (dx).
    Fitted weights cancel (sum_j |w_j| r_j far beyond |score|), so the
    float32 twin's own error is printed beside. Returns the error and the
    kernel's arguments (x, supports, weights) for the timing table."""
    from diffco_tpu_torch.ops import fused_score
    p = perceptron
    w = (p.rbf_nodes.reshape(-1) * p.valid_mask.to(p.rbf_nodes.dtype)
         / p.rbf_kernel.epsilon).contiguous()
    sup = p.support_transformed.contiguous()
    x = x.detach().contiguous()
    with torch.no_grad():
        ref, ref_dx = fused_score._poly_score_grad_plain(
            x.double(), sup.double(), w.double())
        twin, twin_dx = fused_score._poly_score_grad_plain(x, sup, w)
    _check_close(f'{tag} score vs float64 twin', score.double(), ref, 1e-4)
    _check_close(f'{tag} dx vs float64 twin', dx.double(), ref_dx, 1e-3)
    err = _max_err([(score.double(), ref), (dx.double(), ref_dx)])
    print(f'{tag} vs the plain twin in float64 at S = {sup.shape[0]}: '
          f'score {_max_err([(score.double(), ref)])} dx '
          f'{_max_err([(dx.double(), ref_dx)])}; the float32 twin itself '
          f'score {_max_err([(twin.double(), ref)])} dx '
          f'{_max_err([(twin_dx.double(), ref_dx)])}; max |score| '
          f'{float(ref.abs().max())}, max |dx| {float(ref_dx.abs().max())}',
          flush=True)
    return dict(args=(x, sup, w), err=err)


def _fitted_sweep(tag, robot, p, g, dev):
    """A FITTED_SWEEP sweep of a fitted proxy with its gradient: the score
    from q (through the transform and B2, or B2 on q itself for a q-space
    proxy) and, for a proxy over FK features, from the points, held to the
    float64 twin (_check_fitted_poly); dq also against the twin's dx
    pulled back through the float64 FK. Returns B2's check."""
    from diffco_tpu_torch.ops import fused_score
    t0 = time.perf_counter()
    n = FITTED_SWEEP
    q = robot.rand_configs(n, g, dev).requires_grad_(True)
    s_q = p.poly_score(q)
    dq, = torch.autograd.grad(s_q.sum(), q)
    s_q = s_q.detach().reshape(-1)
    if p.transform is None:
        x, s_x, dx = q.detach(), s_q, dq
    else:
        x = robot.fkine(q.detach()).reshape(n, -1).requires_grad_(True)
        s_x = p.poly_score(transformed_point=x)
        dx, = torch.autograd.grad(s_x.sum(), x)
        s_x = s_x.detach().reshape(-1)
        _check_close(f'{tag} sweep, from q vs from points', s_q, s_x, 1e-3)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(s_q).all())
            and bool(torch.isfinite(dq).all())):
        raise AssertionError(f'{tag} sweep: non-finite score or dq')
    q64 = q.detach().double().requires_grad_(True)
    x64 = q64 if p.transform is None else robot.fkine(q64).reshape(n, -1)
    w64 = (p.rbf_nodes.reshape(-1) * p.valid_mask.to(p.rbf_nodes.dtype)
           / p.rbf_kernel.epsilon).double()
    with torch.no_grad():
        _, ref_dx64 = fused_score._poly_score_grad_plain(
            x64.detach(), p.support_transformed.double(), w64)
    ref_dq, = torch.autograd.grad(x64, q64, ref_dx64)
    _check_close(f'{tag} sweep dq vs the float64 twin', dq.double(), ref_dq,
                 1e-3)
    F = x.shape[1]
    _phase(f'{tag} sweep (B2 at F = {F})', t0, configs=n, F=F,
           supports=p.support_transformed.shape[0],
           dq_max_abs_err_vs_float64=_max_err([(dq.double(), ref_dq)]),
           max_abs_dq=float(ref_dq.abs().max()))
    return _check_fitted_poly(f'{tag} sweep (F = {F})', p, x, s_x, dx)


def _planar_escape(dev):
    """scripts/escape_2d.py at its defaults: the q-space proxy, its score
    map on the unified grid (B2 at F = 2) held to the float64 twin and
    to the ground truth, then OptimSampler's escape against resampling on
    ESCAPE_N colliding configurations."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch import routines
    from diffco_tpu_torch.envs.presets2d import get_env
    t0 = time.perf_counter()
    robot = dc.RevolutePlanarRobot(PLANAR_LINK, link_width=PLANAR_WIDTH,
                                   dof=2)
    obs = dc.Obstacles2D.from_obstacle_list(get_env('1rect_1circle'))
    g = torch.Generator().manual_seed(0)
    q = robot.rand_configs(ESCAPE_TRAIN, g, dev)
    labels = (dc.planar_robot_signed_dist(robot, obs, q).amax(-1) > 0) \
        .float() * 2 - 1
    clf = dc.DiffCo(kernel_func=dc.kernels.RQKernel(10.0))
    clf.train(q, labels, max_iteration=3 * ESCAPE_TRAIN)
    clf.fit_poly(dc.kernels.Polyharmonic(1, 1), target='label')
    torch.cuda.synchronize()
    _phase('planar escape, fit (1rect_1circle, 2 DOF)', t0,
           samples=ESCAPE_TRAIN, supports=clf.num_valid)

    t0 = time.perf_counter()
    grid = routines.generate_unified_grid(GRID, GRID, device=dev) \
        .requires_grad_(True)
    score = clf.poly_score(grid)
    dx, = torch.autograd.grad(score.sum(), grid)
    score = score.detach().reshape(-1)
    torch.cuda.synchronize()
    t_map = time.perf_counter() - t0
    truth = dc.planar_robot_collision(robot, obs, grid.detach())
    pred = score > 0
    _phase('planar escape, score map (B2 at F = 2)', t0,
           configs=GRID * GRID, map_s=round(t_map, 4),
           acc=float((pred == truth).float().mean()),
           tpr=float((pred & truth).sum() / truth.sum().clamp(min=1)),
           tnr=float((~pred & ~truth).sum() / (~truth).sum().clamp(min=1)))
    fitted = _check_fitted_poly('planar escape score map (F = 2)', clf, grid,
                                score, dx)

    pool = robot.rand_configs(ESCAPE_N * 10, g, dev)
    q0 = pool[dc.planar_robot_collision(robot, obs, pool)][:ESCAPE_N]
    sampler = dc.OptimSampler(robot,
                              lambda qq: clf.poly_score(qq).reshape(-1),
                              **ESCAPE_OPTIONS)
    t0 = time.perf_counter()
    q_opt = sampler.optim_escape(q0)
    torch.cuda.synchronize()
    t_opt = time.perf_counter() - t0
    free_opt = 1 - float(dc.planar_robot_collision(robot, obs, q_opt)
                         .float().mean())
    t1 = time.perf_counter()
    q_res, checks = sampler.resample_escape(q0,
                                            torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    t_res = time.perf_counter() - t1
    free_res = 1 - float(dc.planar_robot_collision(robot, obs, q_res)
                         .float().mean())
    _phase('planar escape, OptimSampler', t0, n=q0.shape[0],
           optim_s=round(t_opt, 4),
           optim_checks=q0.shape[0] * ESCAPE_OPTIONS['max_steps'],
           optim_gt_free=free_opt, resample_s=round(t_res, 4),
           resample_checks=checks, resample_gt_free=free_res)
    if free_opt < ESCAPE_MIN_FREE:
        raise AssertionError(f'planar escape: GT-free rate {free_opt} < '
                             f'{ESCAPE_MIN_FREE}')
    return fitted


def _gt_hits(collision, path, dev, num_sub=10):
    """Ground-truth hits on a path densified num_sub times a segment."""
    from diffco_tpu_torch.utils import dense_path
    path = torch.as_tensor(np.asarray(path), dtype=torch.float32,
                           device=dev)
    return int(collision(dense_path(path, num_sub)).sum())


def _planar_trajopt(dev):
    """scripts/trajopt_2d.py --init rrt at its defaults: the 2class_1
    dataset from autogenerate_2d_dataset, a q-space MultiDiffCo, an
    RRT-Connect seed on the ground truth for Adam, and RRT* with the
    proxy's score on its edge costs."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch import optim, routines
    from diffco_tpu_torch.envs.presets2d import get_env
    t0 = time.perf_counter()
    obstacles = get_env('2class_1')
    data = routines.autogenerate_2d_dataset(
        TRAJ2D_SAMPLES, dof=2, link_length=PLANAR_LINK,
        link_width=PLANAR_WIDTH, obstacles=obstacles, label_type='class',
        seed=PLANAR_SEED, device=dev)
    cfgs, labels, _, _, robot = routines.unpack_dataset(data, device=dev)
    proxy = dc.MultiDiffCo(kernel_func=dc.kernels.RQKernel(10.0))
    proxy.train(cfgs, labels, max_iteration=3 * TRAJ2D_SAMPLES)
    proxy.fit_poly(dc.kernels.Polyharmonic(1, 1), target='label')
    torch.cuda.synchronize()
    _phase('planar trajopt, fit (2class_1, MultiDiffCo)', t0,
           samples=TRAJ2D_SAMPLES, classes=labels.shape[1],
           supports=proxy.num_valid)

    def dist_est(q):
        return proxy.poly_score(q).amax(-1)

    obs = dc.Obstacles2D.from_obstacle_list(obstacles)

    def collision(q):
        return dc.planar_robot_collision(robot, obs, q)

    q = robot.rand_configs(8192, torch.Generator().manual_seed(
        PLANAR_SEED + 7), dev)
    idx = torch.nonzero(~collision(q)).reshape(-1)
    pairs = [(q[idx[2 * i]], q[idx[-1 - 2 * i]])
             for i in range(min(5, idx.shape[0] // 2))]
    t0 = time.perf_counter()
    planner = dc.MotionPlanner(robot, collision, step_size=RRT['step_size'],
                               seed=PLANAR_SEED, device=dev)
    path, tried = None, 0
    for start, target in pairs:
        tried += 1
        path = planner.plan(start.cpu().numpy(), target.cpu().numpy(),
                            max_iters=RRT['max_iters'], batch=RRT['batch'])
        if path is not None:
            break
    if path is None:
        raise AssertionError('planar trajopt: RRT-Connect found no path')
    rrt_hits = _gt_hits(collision, path, dev)
    _phase('planar trajopt, RRT-Connect on the ground truth', t0,
           pairs_tried=tried, states=len(path), cnt_check=planner.cnt_check,
           gt_hits=rrt_hits)

    t0 = time.perf_counter()
    init = path[np.linspace(0, len(path) - 1,
                            PLANAR_TRAJ['N_WAYPOINTS']).astype(int)]
    rec = optim.adam_traj_optimize(robot, dist_est, start, target,
                                   dict(PLANAR_TRAJ, init_solution=init))
    adam_hits = _gt_hits(collision, rec['solution'], dev)
    _phase('planar trajopt, Adam from the RRT seed', t0,
           seconds=round(rec['time'], 3), cnt_check=rec['cnt_check'],
           cost=rec['cost'], success=rec['success'], gt_valid=adam_hits == 0,
           gt_hits=adam_hits)

    t0 = time.perf_counter()
    star = dc.RRTStar(robot, collision, score_fn=dist_est,
                      step_size=RRT_STAR['step_size'],
                      radius=RRT_STAR['radius'], seed=PLANAR_SEED, device=dev)
    star_path = star.plan(start.cpu().numpy(), target.cpu().numpy(),
                          max_iters=RRT_STAR['max_iters'],
                          goal_tol=RRT_STAR['goal_tol'])
    if star_path is None:
        raise AssertionError('planar trajopt: RRT* found no path')
    star_hits = _gt_hits(collision, star_path, dev)
    cost = float(np.sum(np.linalg.norm(np.diff(star_path, axis=0), axis=1)))
    _phase('planar trajopt, RRT* (proxy-weighted edges)', t0,
           states=len(star_path), cnt_check=star.cnt_check,
           c_space_length=cost, gt_hits=star_hits)
    if rrt_hits or star_hits:
        raise AssertionError(f'planar trajopt: the planners\' paths hit the '
                             f'ground truth ({rrt_hits}, {star_hits})')
    if not math.isfinite(rec['cost']):
        raise AssertionError('planar trajopt: non-finite Adam cost')


def _planar_narrow(dev):
    """scripts/narrow_fk_study.py's FK variant: the 7-DOF arm in
    7d_narrow, a DiffCo over its joint positions fitted to the signed
    distances; the holdout, the FITTED_SWEEP sweep with its gradient (B2
    at F = 14, through the router's FK fallback and from points) held to
    the float64 twin, FK-manifold sampling through the checker, and Adam
    on the staged pairs."""
    import os
    import diffco_tpu_torch as dc
    from diffco_tpu_torch import optim
    from diffco_tpu_torch.envs.presets2d import get_env
    from diffco_tpu_torch.sampler import manifold_jac_det
    t0 = time.perf_counter()
    robot = dc.RevolutePlanarRobot(PLANAR_LINK * 2 / NARROW_DOF,
                                   link_width=PLANAR_WIDTH, dof=NARROW_DOF)
    obs = dc.Obstacles2D.from_obstacle_list(get_env('7d_narrow'))

    def signed_dist(q):
        return dc.planar_robot_signed_dist(robot, obs, q).amax(-1)

    def collision(q):
        return signed_dist(q) > 0

    g = torch.Generator().manual_seed(PLANAR_SEED)
    cfgs = robot.rand_configs(NARROW_TRAIN, g, dev)
    dist = signed_dist(cfgs)
    proxy = dc.DiffCo(kernel_func=dc.kernels.RQKernel(0.1),
                      transform=robot.fkine)
    proxy.train(cfgs, (dist > 0).float() * 2 - 1,
                max_iteration=3 * NARROW_TRAIN, distance=dist)
    proxy.fit_poly(dc.kernels.Polyharmonic(1, 1), target='dist')
    torch.cuda.synchronize()
    _phase('planar narrow, fit (7d_narrow, 7 DOF, FK features)', t0,
           samples=NARROW_TRAIN, colliding=float((dist > 0).float().mean()),
           supports=proxy.num_valid)

    t0 = time.perf_counter()
    q_hold = robot.rand_configs(NARROW_HOLDOUT, g, dev)
    free = ~collision(q_hold)
    with torch.no_grad():
        pred_free = proxy.poly_score(q_hold).reshape(-1) <= 0
    n_col = max(1, int((~free).sum()))
    _phase('planar narrow, holdout', t0, configs=NARROW_HOLDOUT,
           acc=float((pred_free == free).float().mean()),
           missed_col=float((pred_free & ~free).sum()) / n_col)

    fitted = _fitted_sweep('planar narrow', robot, proxy, g, dev)

    t0 = time.perf_counter()
    checker = dc.ForwardKinematicsDiffCo(robot=robot,
                                         gt_check_func=collision,
                                         seed=PLANAR_SEED, device=dev)

    def end_effector(qq):
        return robot.fkine(qq)[:, -1, :]

    q_man, labels, _ = checker._generate_dataset(
        None, None, None, MANIFOLD_SAMPLES, sample_transform=end_effector)
    torch.cuda.synchronize()
    t_man = time.perf_counter() - t0
    q_uni = robot.rand_configs(MANIFOLD_SAMPLES, g, dev)
    det_u = manifold_jac_det(end_effector, q_uni)
    det_m = manifold_jac_det(end_effector, q_man)
    _phase('planar narrow, FK-manifold sampling (end effector)', t0,
           samples=q_man.shape[0], sample_s=round(t_man, 4),
           expected_acceptance=float(det_u.mean() / (1.1 * det_u.max())),
           mean_det_manifold=float(det_m.mean()),
           mean_det_uniform=float(det_u.mean()),
           colliding=float(labels.mean()))
    if q_man.shape != (MANIFOLD_SAMPLES, NARROW_DOF) or \
            not float(det_m.mean()) > float(det_u.mean()):
        raise AssertionError('planar narrow: the manifold samples do not '
                             'lean towards a larger Jacobian determinant')

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, NARROW_CONFIGS)) as f:
        staged = json.load(f)
    t0 = time.perf_counter()
    results = []
    for start, target in zip(staged['start_cfgs'], staged['target_cfgs']):
        rec = optim.adam_traj_optimize(
            robot, lambda qq: proxy.poly_score(qq).reshape(-1),
            torch.tensor(start, dtype=torch.float32, device=dev),
            torch.tensor(target, dtype=torch.float32, device=dev),
            dict(PLANAR_TRAJ))
        hits = _gt_hits(collision, rec['solution'], dev)
        results.append((rec['time'], rec['cost'], rec['success'], hits))
    _phase('planar narrow, Adam on the staged pairs', t0,
           problems=len(results),
           seconds=[round(r[0], 3) for r in results],
           cost=[round(r[1], 4) for r in results],
           success=[r[2] for r in results],
           gt_valid=[r[3] == 0 for r in results],
           gt_hits=[r[3] for r in results])
    if not all(math.isfinite(r[1]) for r in results):
        raise AssertionError('planar narrow: non-finite Adam cost')
    return fitted


def planar_journey(dev):
    """The paper's 2-D planar path: escape, 2-D trajopt with the planners,
    and the 7-DOF FK-feature proxy. Returns B2's checks on its two fitted
    proxies (F = 2 and 14) for the timing table."""
    f2 = _planar_escape(dev)
    _planar_trajopt(dev)
    f14 = _planar_narrow(dev)
    return {'F2': f2, 'F14': f14}


def rigid_world(mesh):
    """scripts/trajopt_se3.py's four shapes, and the lbracket mesh (a
    fifth obstacle) with ``mesh``."""
    import diffco_tpu_torch as dc

    def T(t):
        m = np.eye(4)
        m[:3, 3] = t
        return m
    shapes = {
        'pillar1': {'type': 'Cylinder',
                    'params': {'radius': 0.5, 'height': 6.0},
                    'transform': T([1.2, 1.2, 0.0])},
        'pillar2': {'type': 'Cylinder',
                    'params': {'radius': 0.5, 'height': 6.0},
                    'transform': T([-1.2, -1.2, 0.0])},
        'shelf': {'type': 'Box', 'params': {'extents': [2.0, 0.4, 2.0]},
                  'transform': T([0.0, 1.8, 0.0])},
        'ball': {'type': 'Sphere', 'params': {'radius': 0.6},
                 'transform': T([-1.5, 1.5, 1.0])}}
    if mesh:
        shapes['bracket'] = dict(BRACKET, transform=T(BRACKET_AT))
    return dc.ShapeEnv(shapes)


def rigid_body(mesh):
    """scripts/trajopt_se3.py's build_body: (RigidBody, sphere centres
    [P, 3], radii [P]) of the probe, or of the torus (its mesh's 16-sphere
    decomposition, keypoints its bounding-box corners)."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch.geometry.mesh import load_mesh, spheres_from_mesh
    if mesh:
        verts, faces = load_mesh(TORUS)
        verts = verts - verts.mean(0)
        centers, radii = spheres_from_mesh(verts, faces, n_spheres=16)
        robot = dc.RigidBody.from_vertices(verts, limits=SE3_LIMITS)
    else:
        centers = np.asarray(PROBE, np.float32)
        radii = np.full(len(PROBE), PROBE_RADIUS, np.float32)
        robot = dc.RigidBody(centers, limits=SE3_LIMITS)
    return robot, torch.as_tensor(centers), torch.as_tensor(radii)


def rigid_ground_truth(centers, radii, env, dev):
    """q [B, 6] -> the body's largest signed distance to the scene [B]
    (> 0 in collision): its spheres moved by (xyz, rpy)."""
    from diffco_tpu_torch.geometry.geometry3d import \
        spheres_vs_scene_signed_dist
    from diffco_tpu_torch.utils import euler2mat, transform_points
    scene, c, r = env.scene.to(dev), centers.to(dev), radii.to(dev)

    def signed(q):
        world = transform_points(euler2mat(q[:, 3:]), q[:, :3], c)
        return spheres_vs_scene_signed_dist(world, r, scene).amax(-1)
    return signed


def rigid_proxy(kind, dev):
    """One rigid-body phase's fitted proxy, the scripts' route (3 N
    greedy iterations on labels with their distances, fit_poly on the
    distances): kind 'probe' (F = 9), 'mesh' (F = 24) or 'se2' (q-space,
    F = 3). Returns dict(robot, proxy, signed, g, colliding)."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch.geometry.geometry2d import rigid_body_signed_dist
    g = torch.Generator().manual_seed(0)
    if kind == 'se2':
        robot = dc.RigidPlanarBody([('rect', c, (h[0] * 2, h[1] * 2))
                                    for c, h in SE2_BODY], limits=SE2_LIMITS)
        obs = dc.Obstacles2D.from_obstacle_list(SE2_OBSTACLES)

        def signed(q):
            return rigid_body_signed_dist(SE2_BODY, obs, q).amax(-1)
        proxy = dc.DiffCo(kernel_func=dc.kernels.RQKernel(1.0))
    else:
        robot, centers, radii = rigid_body(kind == 'mesh')
        signed = rigid_ground_truth(centers, radii,
                                    rigid_world(kind == 'mesh'), dev)
        proxy = dc.DiffCo(kernel_func=dc.kernels.RQKernel(10.0),
                          transform=lambda x: robot.fkine(x))
    q = robot.rand_configs(RIGID_SAMPLES, g, dev)
    dist = signed(q)
    proxy.train(q, (dist > 0).float() * 2 - 1,
                max_iteration=3 * RIGID_SAMPLES, distance=dist)
    proxy.fit_poly(dc.kernels.Polyharmonic(1, 1), target='dist')
    return dict(robot=robot, proxy=proxy, signed=signed, g=g,
                colliding=float((dist > 0).float().mean()))


def _rigid_phase(tag, kind, dev):
    """fit -> holdout -> sweep -> Adam on one problem -> the ground truth
    on its dense path, as the scripts run them; fails below RIGID_MIN_ACC
    or on a non-finite cost. Returns B2's check of the sweep."""
    from diffco_tpu_torch import optim
    from diffco_tpu_torch.utils import dense_path
    t0 = time.perf_counter()
    r = rigid_proxy(kind, dev)
    robot, p, signed = r['robot'], r['proxy'], r['signed']
    torch.cuda.synchronize()
    _phase(f'{tag} fit', t0, samples=RIGID_SAMPLES,
           colliding=r['colliding'], iterations=p.train_iterations,
           supports=p.num_valid, F=p.support_transformed.shape[1])
    t0 = time.perf_counter()
    qt = robot.rand_configs(RIGID_HOLDOUT, r['g'], dev)
    with torch.no_grad():
        st = p.poly_score(qt).reshape(-1)
    dt = signed(qt)
    acc = float(((st > 0) == (dt > 0)).float().mean())
    corr = float(np.corrcoef(st.cpu().numpy(), dt.cpu().numpy())[0, 1])
    _phase(f'{tag} holdout', t0, configs=RIGID_HOLDOUT, acc=acc, corr=corr)
    if not acc >= RIGID_MIN_ACC:
        raise AssertionError(f'{tag}: holdout acc {acc} < {RIGID_MIN_ACC}')
    fitted = _fitted_sweep(tag, robot, p, r['g'], dev)
    free = torch.nonzero(dt <= (0.0 if kind == 'se2' else -0.1)).reshape(-1)
    opts = SE2_TRAJ if kind == 'se2' else SE3_TRAJ
    t0 = time.perf_counter()
    rec = optim.adam_traj_optimize(
        robot, lambda pp: p.poly_score(pp).reshape(-1), qt[free[0]],
        qt[free[-1]], dict(opts))
    sol = torch.as_tensor(rec['solution'], dtype=torch.float32, device=dev)
    hits = int((signed(dense_path(sol, 8)) > 0).sum())
    _phase(f'{tag} trajopt', t0, success=rec['success'],
           cost=rec['cost'], seconds=round(rec['time'], 3),
           cnt_check=rec['cnt_check'], gt_valid=hits == 0, gt_hits=hits)
    if not math.isfinite(rec['cost']):
        raise AssertionError(f'{tag} trajopt: non-finite cost')
    return fitted


def _scene_file(dev):
    """tests/test_moveit_scene_e2e.py's journey: the .scene text (a box, a
    sphere, an inline mesh) -> load_moveit_scene -> FrankaPanda (no
    gripper, 12 spheres a link, ACM) -> fit (SCENE_FIT; TPR >= 0.9) ->
    verify, the sweeps (B3, B2) against the float64 twin -> Adam with the
    test's options; the dense path's ground-truth validity is printed, not
    asserted (the reference's own path collides there)."""
    import os
    import diffco_tpu_torch as dc
    from diffco_tpu_torch import optim
    from diffco_tpu_torch.ops import fk_score
    from diffco_tpu_torch.utils import dense_path
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, 'build', 'chip_smoke', 'panda_world.scene')
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
        f.write(MOVEIT_SCENE)
    t0 = time.perf_counter()
    env = dc.load_moveit_scene(path, mesh_spheres=6)
    robot = dc.FrankaPanda(load_gripper=False, setup_acm=True,
                           link_spheres=12, device=dev)
    checker = dc.ForwardKinematicsDiffCo(robot=robot, environment=env,
                                         seed=0, device=dev)
    gt = checker.gt_check_func
    _phase('scene file, load and robot', t0, scene=env.name,
           objects=env.object_names, mesh_spheres=env.scene.msh_c.shape[0],
           spheres=robot.link_sphere_centers.shape[0],
           self_pairs=robot._self_pair_i.shape[0])
    _fit(checker, SCENE_FIT, 'scene file')
    cs = fk_score.robot_chain_statics(robot)
    fitted = _sweeps(checker, robot, gt, dev,
                     lambda q, s, w: fk_score._chain_score_grad_plain(
                         q, s, w, cs), 'scene file')
    t0 = time.perf_counter()
    q = robot.rand_configs(128, torch.Generator().manual_seed(11), dev)
    free = q[~gt(q)]
    rec = optim.adam_traj_optimize(
        robot, checker.score_fn(bias=0.0), free[0], free[-1],
        dict(SCENE_TRAJ, safety_margin=-float(checker.safety_bias)))
    sol = torch.as_tensor(rec['solution'], dtype=torch.float32, device=dev)
    hits = int(gt(dense_path(sol, 4)).sum())
    _phase('scene file, trajopt', t0, success=rec['success'],
           cost=rec['cost'], seconds=round(rec['time'], 3),
           gt_valid=hits == 0, gt_hits=hits)
    if not math.isfinite(rec['cost']):
        raise AssertionError('scene file trajopt: non-finite cost')
    w = fitted['w'].reshape(-1).contiguous()
    sup = fitted['sup'].contiguous()
    return dict(q=fitted['q'], sup=sup, w=w, cs=cs,
                args=(fitted['x'], sup, w), err=fitted['err_p'],
                err_q=fitted['err_q'])


def _twists(rng, n, near_pi):
    """4 n float32 twists: rotation angles uniform in (0, pi - 1e-2), below
    1e-4, log-uniform in 1e-4 to 1e-2, and pi less ``near_pi``'s range."""
    axis = rng.normal(size=(4 * n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    theta = np.concatenate([rng.uniform(0, math.pi - 1e-2, n),
                            rng.uniform(0, 1e-4, n),
                            10 ** rng.uniform(-4, -2, n),
                            math.pi - rng.uniform(*near_pi, n)])
    return torch.from_numpy(np.concatenate(
        [axis * theta[:, None], rng.normal(size=(4 * n, 3))], 1).astype(
            np.float32))


def _se3_on_card(dev):
    """se3 on the card in float32 against the port's own float64 on the
    CPU, same inputs, 1e-5: exp_se3 of SE3_TWISTS twists, log_se3 of the
    result, the round trip, and se3_interpolate (8 points) from each pose
    to the pose moved by another twist (relative angles up to pi -
    1e-3)."""
    from diffco_tpu_torch import se3
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    n = SE3_TWISTS // 4
    xi = _twists(rng, n, (1e-5, 1e-3))
    rel = _twists(rng, n, (1e-3, 1e-2))
    ts = torch.linspace(0, 1, 8)
    xg = xi.to(dev)
    T = se3.exp_se3(xg)
    L = se3.log_se3(T)
    T1 = se3.matmul_f32(T, se3.exp_se3(rel.to(dev)))
    path = se3.se3_interpolate(T, T1, ts.to(dev))
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    T64, T1_64 = T.cpu().double(), T1.cpu().double()
    errs = {}
    for name, out, ref in (
            ('exp_se3', T, se3.exp_se3(xi.double())),
            ('log_se3', L, se3.log_se3(T64)),
            ('round trip', L, se3.log_se3(se3.exp_se3(xi.double()))),
            ('se3_interpolate', path,
             se3.se3_interpolate(T64, T1_64, ts.double()))):
        errs[name] = _max_err([(out.cpu().double(), ref)])
        if not bool(torch.isfinite(out).all()) or errs[name] > 1e-5:
            raise AssertionError(f'se3 on the card: {name} is '
                                 f'{errs[name]} from float64')
    _phase('se3 on the card (float32 vs float64)', t0, twists=SE3_TWISTS,
           card_s=round(t_card, 4), max_abs_err=errs)


def rigid_journey(dev):
    """The rigid-body and scene-file path: SE(3) on the probe (B2 at F = 9)
    and the torus among five obstacles, one a mesh (F = 24), SE(2) (F = 3,
    B2's fp64 instance), the MoveIt .scene file on FrankaPanda (B3, B2),
    and se3's maps. Returns B2's checks on the three fitted proxies and the
    .scene file's sweep (its inputs for B2 and B3 at F = 18)."""
    f9 = _rigid_phase('rigid SE(3) probe', 'probe', dev)
    f24 = _rigid_phase('rigid SE(3) torus', 'mesh', dev)
    f3 = _rigid_phase('rigid SE(2)', 'se2', dev)
    scene = _scene_file(dev)
    _se3_on_card(dev)
    return {'F3': f3, 'F9': f9, 'F24': f24, 'scene F18': scene}


def _T(t, yaw=0.0):
    m = np.eye(4)
    m[:2, :2] = [[math.cos(yaw), -math.sin(yaw)],
                 [math.sin(yaw), math.cos(yaw)]]
    m[:3, 3] = t
    return m


def dual_arm_world(dev):
    """The dual FrankaPanda (gripper, ACM; the second base DUAL_BASE_X
    along x, turned pi about z) and its post between the bases:
    (MultiURDFRobot, ShapeEnv)."""
    import diffco_tpu_torch as dc
    arms = [dc.FrankaPanda(load_gripper=True, setup_acm=True, device=dev,
                           base_transform=base)
            for base in (None, _T([DUAL_BASE_X, 0.0, 0.0], math.pi))]
    post = {'type': 'Cylinder',
            'params': {k: DUAL_POST[k] for k in ('radius', 'height')},
            'transform': _T(DUAL_POST['at'])}
    return dc.MultiURDFRobot(arms), dc.ShapeEnv({'post': post})


def dual_signed(multi, env, q):
    """The dual arm's ground truth as signed distances on the card, and the
    same from the native host oracle on the same sphere centres in float64:
    each arm's environment and self distances and the inter-robot overlap,
    the largest per configuration ([B] each, > 0 in collision)."""
    from diffco_tpu_torch import native
    qs = multi.split_q(q)
    with torch.no_grad():
        card = [multi._inter_robot_overlap(qs)]
        for r, qq in zip(multi.robots, qs):
            env_sd, self_sd = r.collision_signed_dist(qq, env)
            card += [env_sd.amax(-1), self_sd]
        card = torch.stack(card, -1).amax(-1)
        centers = [r.sphere_centers_world(qq)
                   for r, qq in zip(multi.robots, qs)]
    scene = native.NativeScene(env.scene)
    host = []
    for r, c in zip(multi.robots, centers):
        host.append(native.spheres_vs_scene(c, r.link_sphere_radii, scene))
        host.append(native.self_collision(c, r.link_sphere_radii,
                                          r._self_pair_i, r._self_pair_j))
    a, b = multi.robots
    pa, pb = a.link_sphere_radii.shape[0], b.link_sphere_radii.shape[0]
    ii, jj = np.meshgrid(np.arange(pa), pa + np.arange(pb), indexing='ij')
    host.append(native.self_collision(
        torch.cat(centers, 1), torch.cat([a.link_sphere_radii,
                                          b.link_sphere_radii]),
        ii.ravel(), jj.ravel()))
    return card.double().cpu().numpy(), np.max(np.stack(host, -1), -1)


def _busy_share(prof, wall_s):
    """The share of ``wall_s`` seconds in which the card ran a kernel, a
    copy or a fill: the union of those intervals of the profiler's trace
    over the wall time, read off its raw events (building the profiler's
    event tree for some 10^5 device events takes a minute). Returns
    (share, busy seconds, the number of device events)."""
    spans = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == torch.autograd.DeviceType.CUDA)
    busy, end = 0, -math.inf
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy * 1e-9 / wall_s, busy * 1e-9, len(spans)


def _dual_arm(dev, timers):
    """The dual FrankaPanda: fit -> verify -> sweep (B2 at F = 48, held to
    the float64 twin) -> Adam on one problem -> the dense path against the
    native oracle -> DUAL_TRACE_STEPS steps traced.
    Returns B2's check of the sweep."""
    import os
    import diffco_tpu_torch as dc
    from diffco_tpu_torch import optim, profiling
    from diffco_tpu_torch.utils import dense_path
    with timers.span('dual arm, robots and scene', block=True):
        t0 = time.perf_counter()
        multi, env = dual_arm_world(dev)
        checker = dc.ForwardKinematicsDiffCo(robot=multi, environment=env,
                                             seed=0, device=dev)
        gt = checker.gt_check_func
        q = multi.rand_configs(2000, torch.Generator().manual_seed(5), dev)
        qs = multi.split_q(q)
        _phase('dual arm, robots and scene', t0, dof=multi.dof,
               control_points=multi.fkine(q[:1]).shape[1],
               spheres=[r.link_sphere_radii.shape[0] for r in multi.robots],
               colliding=float(gt(q).float().mean()),
               inter_robot=float(multi._inter_robot_hit(qs).float().mean()),
               each_arm=[float(r.collision(qq).float().mean())
                         for r, qq in zip(multi.robots, qs)],
               post_hits=[float((r.collision_signed_dist(qq, env)[0] > 0)
                                .any(-1).float().mean())
                          for r, qq in zip(multi.robots, qs)])
    with timers.span('dual arm, fit and verify', block=True):
        _fit(checker, DUAL_FIT, 'dual arm', min_tpr=DUAL_MIN_TPR)
    with timers.span('dual arm, sweep', block=True):
        fitted = _fitted_sweep('dual arm', multi, checker.perceptron,
                               torch.Generator().manual_seed(6), dev)
    start, target = _problems(multi, gt, dev, 1)[0]
    opts = dict(TRAJ_OPTIONS, seed=0,
                safety_margin=-checker.safety_bias)

    def dist_est(pp):
        return checker.collision_score(pp, bias=0).reshape(-1)
    with timers.span('dual arm, Adam', block=True):
        t0 = time.perf_counter()
        rec = optim.adam_traj_optimize(multi, dist_est, start, target, opts)
        sol = torch.as_tensor(rec['solution'], device=dev)
        path = dense_path(sol, 10)
        hits = int(gt(path).sum())
        _phase('dual arm trajopt', t0, steps=opts['MAXITER'],
               success=rec['success'], cost=rec['cost'],
               seconds=round(rec['time'], 3), gt_valid=hits == 0,
               gt_hits_of=[hits, path.shape[0]])
        if not math.isfinite(rec['cost']):
            raise AssertionError('dual arm trajopt: non-finite cost')
    with timers.span('dual arm, native check', block=True):
        t0 = time.perf_counter()
        card, host = dual_signed(multi, env, path)
        err = float(np.abs(card - host).max())
        away = np.abs(host) > NATIVE_TOL
        agree = int(((card > 0) == (host > 0))[away].sum())
        _phase('dual arm dense path: card vs native ground truth', t0,
               configs=len(host), max_abs_err=err,
               labels_agree=f'{agree} of {int(away.sum())} with |d| > '
                            f'{NATIVE_TOL}',
               gt_labels_match=bool(((card > 0) == gt(path).cpu().numpy())
                                    .all()))
        if not err <= NATIVE_TOL or agree != int(away.sum()):
            raise AssertionError(f'dual arm: card and native ground truth '
                                 f'differ by {err}, or labels disagree')
    short = dict(opts, MAXITER=DUAL_TRACE_STEPS)
    with timers.span('dual arm, traced Adam steps', block=True):
        log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               'build', 'chip_smoke', 'trace_dual_arm_adam')
        with profiling.trace(log_dir) as prof:
            t0 = time.perf_counter()
            optim.adam_traj_optimize(multi, dist_est, start, target, short)
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        share, busy_s, n_events = _busy_share(prof, traced_s)
        # the untraced step's time from the Adam phase above, for the
        # tracer's cost
        _phase('dual arm, Adam steps in profiling.trace', t0,
               steps=DUAL_TRACE_STEPS,
               untraced_s_per_step=rec['time'] / opts['MAXITER'],
               traced_s_per_step=traced_s / DUAL_TRACE_STEPS,
               traced_s=round(traced_s, 4), device_busy_s=round(busy_s, 5),
               device_busy_share=share, device_events=n_events,
               device_events_per_step=n_events / DUAL_TRACE_STEPS,
               trace=os.path.join(log_dir, 'trace.json'))
        if n_events == 0:
            raise AssertionError('profiling.trace saw no device event')
    return fitted


def _temporal(dev, timers):
    """scripts/temporal_1d.py at its sizes: the two moving intervals on
    PointRobot1D, a DiffCo with TemporalFKKernel over normalized (x, t),
    acc on a held-out set, the space-time grid scored (B2 at F = 2, its
    fp64 instance, held to the float64 twin), and legacy's
    Simple1DDynamicChecker against Dynamic1DChecker. Returns B2's check."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch import kernels, legacy
    with timers.span('temporal, fit', block=True):
        t0 = time.perf_counter()
        motions = [(dc.LinearMotion(0.5, 2.0), 0.6),
                   (dc.SineMotion(2.0, 0.8, 0.0, 7.0), 0.5)]
        gt = dc.Dynamic1DChecker(motions, device=dev)
        robot = dc.PointRobot1D(TEMPORAL_LIMITS)
        g = torch.Generator().manual_seed(0)
        xt, labels, dists = dc.temporal_dataset(gt, TEMPORAL_LIMITS,
                                                TEMPORAL_SAMPLES, g, dev)
        kern = kernels.TemporalFKKernel(
            fkine=lambda x: x, rqkernel=kernels.RQKernel(100.0),
            t_rqkernel=kernels.RQKernel(100.0), alpha=3.0)
        p = dc.DiffCo(kernel_func=kern)
        p.train(robot.normalize(xt), labels,
                max_iteration=3 * TEMPORAL_SAMPLES, distance=dists)
        p.fit_poly(kernels.Polyharmonic(1, 1), target='label')
        torch.cuda.synchronize()
        _phase('temporal fit', t0, samples=TEMPORAL_SAMPLES,
               colliding=float((labels > 0).float().mean()),
               iterations=p.train_iterations, supports=p.num_valid)
    with timers.span('temporal, holdout and grid', block=True):
        t0 = time.perf_counter()
        xt_t, y_t, _ = dc.temporal_dataset(gt, TEMPORAL_LIMITS,
                                           TEMPORAL_TEST, g, dev)
        with torch.no_grad():
            pred = (p.poly_score(robot.normalize(xt_t)).reshape(-1) > 0)
        y = y_t > 0
        acc = float((pred == y).float().mean())
        _phase('temporal holdout', t0, configs=TEMPORAL_TEST, acc=acc,
               tpr=float(pred[y].float().mean()),
               tnr=float((~pred[~y]).float().mean()))
        if not acc > TEMPORAL_MIN_ACC:
            raise AssertionError(f'temporal acc {acc} <= {TEMPORAL_MIN_ACC}')
        n = TEMPORAL_GRID
        axis = torch.linspace(0, 10, n, device=dev)
        grid = torch.stack(torch.meshgrid(axis, axis, indexing='xy'),
                           -1).reshape(-1, 2)
        x = robot.normalize(grid).requires_grad_(True)
        s = p.poly_score(x)
        dx, = torch.autograd.grad(s.sum(), x)
        torch.cuda.synchronize()
        fitted = _check_fitted_poly(f'temporal grid (F = 2, {n} x {n})', p,
                                    x, s.detach().reshape(-1), dx)
        agree = float(((s.detach().reshape(-1) > 0) == gt.collision(grid))
                      .float().mean())
        _phase('temporal grid (B2 at F = 2)', t0, rows=n * n,
               gt_agreement=agree, max_abs_err_vs_float64=fitted['err'])
    with timers.span('temporal, legacy checker', block=True):
        t0 = time.perf_counter()
        old = legacy.Simple1DDynamicChecker(
            [legacy.Simple1DDynamicObstacle(2 * h, m) for m, h in motions],
            robot, device=dev)
        lab, _ = old.predict(robot.normalize(xt_t))
        same = int((lab.reshape(-1) == gt.predict(xt_t)).sum())
        _phase('temporal legacy Simple1DDynamicChecker', t0,
               labels_equal=f'{same} of {TEMPORAL_TEST}')
        if same != TEMPORAL_TEST:
            raise AssertionError('legacy Simple1DDynamicChecker labels '
                                 'differ from Dynamic1DChecker\'s')
    return fitted


def rope_world(dev):
    """The 35-link rope (``RopeRobot``: robot_data.generate_rope_urdf, 4
    spheres a link) in tests/test_rope.py's box and sphere: (RopeRobot,
    ShapeEnv)."""
    import diffco_tpu_torch as dc
    robot = dc.RopeRobot(n_links=ROPE_LINKS, device=dev)
    env = dc.ShapeEnv({
        'box1': {'type': 'Box', 'params': {'extents': [0.25, 0.25, 0.25]},
                 'transform': _T([0.18, 0.0, 0.05])},
        'sphere1': {'type': 'Sphere', 'params': {'radius': 0.15},
                    'transform': _T([-0.15, 0.15, -0.05])}})
    return robot, env


def _rope(dev, timers):
    """The rope: fit ROPE_FIT (TPR >= 0.9), verify, and both B_BENCH sweeps
    (_sweeps): from configurations through B3's wide instance (35 moving
    joints and 34 points lie past its tensor-core instance's bounds; it
    fails unless B3 launched there), from the points through B2's wide one
    (F = 102), each held to the float64 twin. Returns both checks."""
    import diffco_tpu_torch as dc
    from diffco_tpu_torch.ops import _native, fk_score
    with timers.span('rope, fit and verify', block=True):
        t0 = time.perf_counter()
        robot, env = rope_world(dev)
        checker = dc.ForwardKinematicsDiffCo(robot=robot, environment=env,
                                             seed=0, device=dev)
        q = robot.rand_configs(FITTED_SWEEP, torch.Generator().manual_seed(8),
                               dev)
        cs = fk_score.robot_chain_statics(robot)
        c = fk_score._c_chain_spec(cs)
        F = robot.fkine(q[:1]).numel()
        _phase('rope, robot and scene', t0, dof=robot.dof,
               control_points=robot.fkine(q[:1]).shape[1],
               spheres=robot.link_sphere_radii.shape[0],
               colliding=float(checker.gt_check_func(q).float().mean()),
               route=f'one pass (B3, the wide instance: {c.M} moving joints, '
                     f'{c.P} points, plan '
                     f'{_native.chain_wide_plan(c.P, c.M)}) from q; '
                     f'poly_score_grad (B2, F = {F}, plan '
                     f'{_native.poly_tc_plan(F)}) from points')
        if not (fk_score.chain_score_grad_available(robot, q)
                and isinstance(c, _native.ChainSpecWide)):
            raise AssertionError('the rope does not take B3\'s wide instance')
        _fit(checker, ROPE_FIT, 'rope')
    with timers.span('rope, sweeps', block=True):
        before = profiling.counter('launches.chain_score_grad')
        fitted = _sweeps(checker, robot, checker.gt_check_func, dev,
                         lambda q, s, w: fk_score._chain_score_grad_plain(
                             q, s, w, cs), 'rope')
        if profiling.counter('launches.chain_score_grad') == before:
            raise AssertionError('B3 did not launch on the rope\'s sweep')
    e = fitted['errs']
    print('rope sweeps, the wide instances against float64 (the first wide '
          'design\'s in brackets, chip_smoke on NVIDIA H100 80GB HBM3, '
          f'700.00 W): B2 on its float32 points score {e["score_p_same"]} '
          f'({ROPE_PR16_ERRS["score_p"]}), dx {e["dx_same"]} '
          f'({ROPE_PR16_ERRS["dx"]}), against the twin on float64 FK '
          f'points score {e["score_p"]}, dx {e["dx"]}; B3 from q score '
          f'{e["score_q"]} ({ROPE_PR16_ERRS["score_q"]}), dq {e["dq"]} '
          f'({ROPE_PR16_ERRS["dq"]})', flush=True)
    w = fitted['w'].reshape(-1).contiguous()
    sup = fitted['sup'].contiguous()
    return dict(q=fitted['q'], sup=sup, w=w, cs=cs,
                args=(fitted['x'], sup, w), err=fitted['err_p'],
                err_q=fitted['err_q'])


def multi_robot_journey(dev):
    """The multi-robot, temporal and rope path, its phases in
    profiling.Timers spans (every device synchronized at each end):
    the dual FrankaPanda (B2 at F = 48), the temporal 1-D proxy (B2 at
    F = 2) and the 35-link rope (B3's wide instance, B2 at F = 102).
    Prints the spans and returns the checks of the three sweeps."""
    from diffco_tpu_torch import profiling
    timers = profiling.Timers()
    out = {'F48 dual arm': _dual_arm(dev, timers),
           'F2 temporal': _temporal(dev, timers),
           'F102 rope': _rope(dev, timers)}
    print(f'multi-robot path spans: {json.dumps(timers.summary())}',
          flush=True)
    return out


def mesh_journey(robot, dev):
    """The mesh path: the PandaFK journey (panda_world's box + sphere) on a
    torch.distributed mesh of one rank, NCCL at world size 1
    (``make_mesh(('dp', 'tp'), (1, 1))``; one card cannot hold more ranks,
    so the multi-rank cases are the CPU tests' on gloo), each phase in a
    profiling.Timers span: ForwardKinematicsDiffCo(mesh=...) fit on
    FIT_SAMPLES (TPR >= 0.9 after the bias) and verify on VERIFY_SAMPLES
    -> collision_score on B_BENCH configurations with its gradient (each
    rank's rows through B1), held to the float64 twin (1e-4, 1e-3) and to
    the same checker built without a mesh (1e-6) -> adam_traj_optimize
    with options['mesh'] (TRAJ_OPTIONS) on MESH_PROBLEMS problems and the
    ground-truth check of the dense paths -> distributed_fit_lazy on
    MESH_LAZY_ROWS rows of PandaFK features (MESH_LAZY_ITERS iterations),
    timed -> save_checker_dcp / load_checker_dcp, whose restored state
    reproduces the scores. Prints the spans; destroys the process group
    after."""
    import shutil
    import torch.distributed as dist
    import diffco_tpu_torch as dc
    from diffco_tpu_torch import profiling, routines
    from diffco_tpu_torch.kernels import Polyharmonic, RQKernel
    from diffco_tpu_torch.ops import fk_score
    from diffco_tpu_torch.parallel import distributed_fit_lazy, make_mesh
    timers = profiling.Timers()
    with timers.span('mesh, make_mesh', block=True):
        mesh = make_mesh(('dp', 'tp'), (1, 1))
    env = _scene()
    gt = dc.CapsuleChainCollision(robot, link_radius=LINK_RADIUS) \
        .checker_fn(env)
    checkers = {}
    for name, m in (('mesh', mesh), ('no mesh', None)):
        with timers.span(f'{name}, fit and verify', block=True):
            checkers[name] = dc.ForwardKinematicsDiffCo(
                robot=robot, environment=env, gt_check_func=gt, seed=0,
                device=dev, mesh=m)
            _fit(checkers[name], FIT_SAMPLES, f'PandaFK on the {name} path',
                 verify=m is not None)
    checker, plain = checkers['mesh'], checkers['no mesh']
    with timers.span('mesh, collision_score sweep', block=True):
        t0 = time.perf_counter()
        q = robot.rand_configs(B_BENCH, torch.Generator().manual_seed(3),
                               dev)
        out = {}
        for name, ck in checkers.items():
            qg = q.clone().requires_grad_(True)
            s = ck.collision_score(qg)
            dq, = torch.autograd.grad(s.sum(), qg)
            out[name] = (s.detach().reshape(-1) - ck.safety_bias, dq)
        p = checker.perceptron
        w = (p.rbf_nodes * p.valid_mask.to(p.rbf_nodes.dtype)
             / p.rbf_kernel.epsilon)
        with torch.no_grad():
            ref, ref_dq = fk_score._dh_score_grad_plain(
                q.double(), p.support_transformed.double(), w.double(),
                fk_score.robot_spec(robot))
        torch.cuda.synchronize()
        s, dq = out['mesh']
        if plain.perceptron.num_valid != p.num_valid:
            raise AssertionError(f'mesh path: {p.num_valid} supports, '
                                 f'{plain.perceptron.num_valid} without a '
                                 'mesh')
        _check_close('mesh collision_score vs the checker without a mesh',
                     s, out['no mesh'][0], 1e-6)
        _check_close('mesh collision_score dq vs the checker without a mesh',
                     dq, out['no mesh'][1], 1e-6)
        _check_close('mesh collision_score vs plain twin (float64)',
                     s.double(), ref, 1e-4)
        _check_close('mesh collision_score dq vs plain twin (float64)',
                     dq.double(), ref_dq, 1e-3)
        _phase('mesh collision_score sweep', t0, configs=B_BENCH,
               supports=p.num_valid,
               max_abs_err=_max_err([(s.double(), ref),
                                     (dq.double(), ref_dq)]),
               vs_no_mesh=_max_err([(s, out['no mesh'][0]),
                                    (dq, out['no mesh'][1])]))
    with timers.span('mesh, Adam', block=True):
        _trajopt(checker, robot, gt, dev, 'PandaFK on the mesh path',
                 n=MESH_PROBLEMS, mesh=mesh)
    with timers.span('mesh, distributed_fit_lazy', block=True):
        t0 = time.perf_counter()
        ql = robot.rand_configs(MESH_LAZY_ROWS,
                                torch.Generator().manual_seed(9), dev)
        X = robot.fkine(ql).reshape(MESH_LAZY_ROWS, -1)
        y = gt(ql).float() * 2 - 1
        gains, hyp, it = distributed_fit_lazy(RQKernel(10), X, y, mesh,
                                              max_iteration=MESH_LAZY_ITERS)
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(hyp).all())
                and gains.shape == (MESH_LAZY_ROWS,)):
            raise AssertionError('distributed_fit_lazy: bad gains')
        _phase('mesh distributed_fit_lazy', t0, rows=MESH_LAZY_ROWS,
               F=X.shape[1], iterations=int(it),
               supports=int((gains != 0).sum()),
               train_acc=float(((hyp > 0) == (y > 0)).float().mean()))
    with timers.span('mesh, checkpoint round trip', block=True):
        t0 = time.perf_counter()
        path = 'build/chip_smoke/mesh_dcp'
        shutil.rmtree(path, ignore_errors=True)
        routines.save_checker_dcp(p, path)
        fresh = dc.DiffCo(kernel_func=RQKernel(10), transform=robot.fkine)
        fresh.rbf_kernel = Polyharmonic(k=1, epsilon=1)
        routines.load_checker_dcp(fresh, path, device=dev)
        with torch.no_grad():
            a, b = fresh.poly_score(q), p.poly_score(q)
        if fresh.num_valid != p.num_valid:
            raise AssertionError('load_checker_dcp: num_valid')
        _check_close('load_checker_dcp scores', a, b, 1e-6)
        _phase('mesh checkpoint round trip', t0, supports=fresh.num_valid)
    print(f'mesh path spans: {json.dumps(timers.summary())}', flush=True)
    dist.destroy_process_group()


def _time_ms(fn, warmup, iters):
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def kernel_table(b2, b1, b3, b4, b5, b67, wide, fk, gt, launches):
    """Time each kernel and its plain twin at the checked shapes; the bound
    counts each input read once and each output written once, and
    ``score_ops`` for the score block (with C weight columns for B4, B5),
    plus per configuration ``dh_ops`` (B1, B4, B6) or ``chain_ops`` (B3,
    B5) for the FK and its backward, or a B7 mode's ``ablation_work``
    (diffco_tpu_torch/ops/bounds.py). B1, B2 and B3 run their products on
    the tensor cores: their ``bound_ms`` is the tensor-core route's
    (``dh_tc_bound``, ``poly_tc_bound``, ``chain_tc_bound``), with the
    fp32 bound beside it (``bound_fp32_ms``); so do B6 (B1's
    ``dh_tc_bound``) and each B7 rung (``ablation_tc_bound``), which have
    one row per variant and mode. The wide instances' entries (B2's F =
    102 rope proxy, B3's ``rope_wide``, the ``wide`` rows of B1, B3, B4,
    B5) add ``bound_f64_tc_ms``, the bound of the route they take, both
    products on the fp64 tensor cores (``poly_wide_bound``,
    ``chain_wide_bound``), beside their ``bound_ms`` (the 3xTF32 route's
    ``tc_bound``). ``ms`` is the wrapper's time per call
    over back-to-back calls, which the host's launches bound for the
    fastest kernels; B1, B6 and B7 also give ``device_ms``, the kernel's
    own time on the card (``roofline_fk_score.device_ms``). The DH FK and
    its VJP (csrc/dh_fk.cu) at Baxter's B = 28672, against the eager ops,
    with ``device_ms`` and a bound of q (and g) read and the points (dq)
    written once, and ``dh_ops`` without (the FK) or with (the VJP, which
    recomputes the chain) the backward. The greedy trainer's kernel
    (csrc/greedy_train.cu) on the fit's inputs against its eager loop, with
    the device us an iteration on the update's, the fit's and the rope
    fit's, and a latency bound: no bytes or operations bound it (4N bytes
    and ~12N operations an iteration), so ``bound_ms`` is the fit's
    iterations at the kernel's own device time an iteration on the
    oscillating pair, where two threads have a row: the fused block
    reduction, both barriers and the picked row's dependent read."""
    from diffco_tpu_torch import perceptron
    from diffco_tpu_torch.ops import _native, fk_score, fused_score
    from diffco_tpu_torch.robots import fk_jvp
    from diffco_tpu_torch.scripts import ab_dual_tile as ab
    from diffco_tpu_torch.scripts import roofline_fk_score as rf
    x, sup, w = b2['args']
    B, F = x.shape
    S = sup.shape[0]
    bound2, by2 = poly_tc_bound(B, S, F)
    bound2_fp32, by2_fp32 = bound(poly_bytes(B, S, F), score_ops(B, S, F))
    q, sup1, w1, spec = b1['args']
    B1, J = q.shape
    S1, F1 = sup1.shape
    bound1, by1 = dh_tc_bound(B1, S1, F1, J, len(spec[1]))
    bound1_fp32, by1_fp32 = bound(fk_score_bytes(B1, S1, F1, J),
                                  score_ops(B1, S1, F1)
                                  + dh_ops(J, len(spec[1])) * B1)
    q3, sup3, w3, cs = b3['args']
    B3, D = q3.shape
    S3, F3 = sup3.shape
    c3 = fk_score._c_chain_spec(cs)
    bound3, by3 = chain_tc_bound(B3, S3, F3, D, c3)
    bound3_fp32, by3_fp32 = bound(fk_score_bytes(B3, S3, F3, D),
                                  score_ops(B3, S3, F3) + chain_ops(c3) * B3)
    q4, sup4, W4, spec4 = b4['args']
    B4, J4 = q4.shape
    S4, F4 = sup4.shape
    C4 = W4.shape[1]

    def bound_b4(C):
        return bound(fk_score_bytes(B4, S4, F4, J4, C),
                     score_ops(B4, S4, F4, C)
                     + dh_ops(J4, len(spec4[1]), C) * B4)
    bound4, by4 = bound_b4(C4)
    q5, sup5, W5, cs5 = b5['args']
    B5, D5 = q5.shape
    S5, F5 = sup5.shape
    C5 = W5.shape[1]
    bound5, by5 = bound(fk_score_bytes(B5, S5, F5, D5, C5),
                        score_ops(B5, S5, F5, C5)
                        + chain_ops(fk_score._c_chain_spec(cs5), C5) * B5)

    def row(name, source, replaces, shape, check, fn, plain, b, by, **extra):
        return dict(name=name, route='cuda', source=source, **extra,
                    replaces=replaces, shape=shape,
                    launches=sum(n[name] for n in launches.values()),
                    launches_by_path={k: n[name]
                                      for k, n in launches.items()},
                    max_abs_err=check['err'], ms=_time_ms(fn, 5, 50),
                    plain_ms=_time_ms(plain, 1, 3), bound_ms=b, bound_by=by,
                    library_ms=None)

    def poly_at(fitted):
        """B2 on a fitted proxy of the planar path (F = 2 and 14), the
        rigid-body path (F = 3, 9, 24; the .scene file's points, F = 18)
        or the multi-robot path (F = 48, 2, 102), at the sweep's shape,
        with its error against the float64 twin."""
        xp, sp, wp = fitted['args']
        Bp, Sp, Fp = xp.shape[0], sp.shape[0], xp.shape[1]
        bp, byp = poly_tc_bound(Bp, Sp, Fp)
        bp32, byp32 = bound(poly_bytes(Bp, Sp, Fp), score_ops(Bp, Sp, Fp))
        wide = {}
        if Fp > _native.TC_MAX_F:   # the wide instance: its own bound too
            wide = dict(zip(('bound_f64_tc_ms', 'bound_f64_tc_by'),
                            poly_wide_bound(Bp, Sp, Fp)))
        return dict(
            **wide,
            shape=[Bp, Sp, Fp], bound_fp32_ms=bp32, bound_fp32_by=byp32,
            max_abs_err_vs_float64=fitted['err'],
            ms=_time_ms(lambda: fused_score.poly_score_grad(xp, sp, wp), 5,
                        50),
            plain_ms=_time_ms(
                lambda: fused_score._poly_score_grad_plain(xp, sp, wp), 1, 3),
            bound_ms=bp, bound_by=byp)

    def chain_at(fitted):
        """B3 on the .scene file's FrankaPanda sweep (F = 18) or the 35-link
        rope's (its wide instance, F = 102), with its error against the
        float64 twin."""
        qs, ss, ws = fitted['q'], fitted['sup'], fitted['w']
        cs = fitted['cs']
        Bs, Ds = qs.shape
        Ss, Fs = ss.shape
        cc = fk_score._c_chain_spec(cs)
        bs, bys = chain_tc_bound(Bs, Ss, Fs, Ds, cc)
        wide = {}
        if isinstance(cc, _native.ChainSpecWide):
            wide = dict(zip(('bound_f64_tc_ms', 'bound_f64_tc_by'),
                            chain_wide_bound(Bs, Ss, Fs, Ds, cc)))
        return dict(
            **wide,
            shape=[Bs, Ss, Ds], F=Fs, max_abs_err_vs_float64=fitted['err_q'],
            ms=_time_ms(lambda: fk_score.chain_score_grad(qs, ss, ws, cs), 5,
                        50),
            plain_ms=_time_ms(lambda: fk_score._chain_score_grad_plain(
                qs, ss, ws, cs), 1, 3), bound_ms=bs, bound_by=bys)

    def wide_at(case):
        """The wide instance at check_wide_kernels' shape, with its error
        against the plain twin; the bound is the function's (B1's or B3's
        tensor-core route at one class, the fp32 one at several), with
        the DH chain's FK counted as dh_ops; beside it the wide block's
        own, the fp64 tensor-core route (``chain_wide_bound``)."""
        qw, sw, ww, specw = case['args']
        c = case['c']
        Bw, Dw = qw.shape
        Sw, Fw = sw.shape
        Cw = 1 if ww.dim() == 1 else ww.shape[1]
        fk_ops = (dh_ops(Dw, c.P, Cw) if case['robot'].startswith('DH')
                  else chain_ops(c, Cw))
        bw, byw = (tc_bound(Bw, Sw, Fw, fk_score_bytes(Bw, Sw, Fw, Dw),
                            fk_ops) if Cw == 1 else
                   bound(fk_score_bytes(Bw, Sw, Fw, Dw, Cw),
                         score_ops(Bw, Sw, Fw, Cw) + fk_ops * Bw))
        bf, byf = chain_wide_bound(Bw, Sw, Fw, Dw, c, Cw,
                                   dh=case['robot'].startswith('DH'))
        return dict(
            bound_f64_tc_ms=bf, bound_f64_tc_by=byf,
            robot=case['robot'], shape=[Bw, Sw, Dw, Cw], F=Fw,
            moving_joints=c.M, points=c.P, plan=case['plan'],
            max_abs_err=case['err'],
            ms=_time_ms(lambda: case['kernel'](qw, sw, ww, specw), 5, 50),
            plain_ms=_time_ms(lambda: case['plain'](qw, sw, ww, specw), 1,
                              3), bound_ms=bw, bound_by=byw,
            library_ms=None)

    q6, sup6, w6, spec6 = b67['args']
    B6, J6 = q6.shape
    S6, F6 = sup6.shape
    P6 = len(spec6[1])
    # B6 runs B1's function on B1's block: B1's tensor-core bound, the
    # fp32 one beside it; each B7 rung its own of each
    bound6, by6 = dh_tc_bound(B6, S6, F6, J6, P6)
    bound6_fp32, by6_fp32 = bound(fk_score_bytes(B6, S6, F6, J6),
                                  score_ops(B6, S6, F6) + dh_ops(J6, P6) * B6)
    dual_rows = [
        row(f'dh_dual_score_grad:{name}',
            'diffco_tpu_torch/csrc/dh_dual_score.cu',
            'scripts/ab_dual_tile.py:160', [B6, S6, J6],
            dict(err=b67['dual_err'][name]),
            lambda v=name: ab.dh_dual_score_grad(q6, sup6, w6, spec6, v),
            lambda: fk_score._dh_score_grad_plain(q6, sup6, w6, spec6),
            bound6, by6, bound_fp32_ms=bound6_fp32, bound_fp32_by=by6_fp32,
            bound_times_ms=dh_tc_times(B6, S6, F6, J6, P6),
            device_ms=rf.device_ms(
                lambda v=name: ab.dh_dual_score_grad(q6, sup6, w6, spec6, v),
                rf.instance_pattern('dh_dual_score_tc_kernel',
                                    ab.VARIANTS[name])))
        for name in ab.VARIANTS]
    mode_rows = [
        row(f'dh_ablation:{mode}', 'diffco_tpu_torch/csrc/dh_ablation.cu',
            'scripts/roofline_fk_score.py:73', [B6, S6, J6],
            dict(err=b67['mode_err'][mode]),
            lambda m=mode: rf.dh_ablation(q6, sup6, w6, spec6, m),
            lambda m=mode: rf._dh_ablation_plain(q6, sup6, w6, spec6, m),
            *ablation_tc_bound(mode, B6, S6, F6, J6, P6),
            **dict(zip(('bound_fp32_ms', 'bound_fp32_by'),
                       bound(*ablation_work(mode, B6, S6, F6, J6, P6)))),
            bound_times_ms=ablation_tc_times(mode, B6, S6, F6, J6, P6),
            device_ms=rf.device_ms(
                lambda m=mode: rf.dh_ablation(q6, sup6, w6, spec6, m),
                rf.instance_pattern('dh_ablation_kernel', rf.MODES[mode])))
        for mode in rf.MODES]
    qf, cf, gf, stf = fk['args']
    Bf, Jf, Pf = qf.shape[0], cf.J, cf.P
    fk_rows = [
        row(name, 'diffco_tpu_torch/csrc/dh_fk.cu',
            'diffco_tpu/robots/fk_jvp.py:51', [Bf, Jf, Pf], dict(err=err),
            lambda gk=gk: fk_jvp._dh_fk_kernel(qf, cf, gk),
            lambda gk=gk: _eager_fk(stf, qf, gk),
            *bound(Bf * 4 * (n_q * Jf + 3 * Pf), dh_ops(Jf, Pf, C) * Bf),
            device_ms=rf.device_ms(
                lambda gk=gk: fk_jvp._dh_fk_kernel(qf, cf, gk),
                rf.instance_pattern(f'{name}_kernel',
                                    8 if Pf <= 8 else 16)))
        for name, gk, n_q, C, err in (('dh_fk', None, 1, 0, fk['err']),
                                      ('dh_fk_vjp', gf, 2, 1,
                                       fk['vjp_err']))]

    def greedy_us(case):
        """The kernel's device us an iteration on a case's inputs."""
        return 1e3 * rf.device_ms(
            lambda: perceptron._train_kernel(*gt['args'][case]),
            'greedy_train_kernel') / gt['iterations'][case]
    floor_us = greedy_us('oscillating pair')
    fit = gt['args']['fit']
    greedy_rows = [row(
        'greedy_train', 'diffco_tpu_torch/csrc/greedy_train.cu',
        'diffco_tpu/perceptron.py:117', list(fit[1].shape), dict(err=0.0),
        lambda: perceptron._train_kernel(*fit), lambda: _eager_train(*fit),
        1e-3 * floor_us * gt['iterations']['fit'],
        'latency (the oscillating pair)',
        us_per_iteration={c: greedy_us(c)
                          for c in ('update', 'fit', 'rope fit')},
        floor_us_per_iteration=floor_us,
        iterations={c: n for c, n in gt['iterations'].items()
                    if c != 'oscillating pair'},
        cases=gt['cases'])]
    return [
        row('poly_score_grad', 'diffco_tpu_torch/csrc/poly_score.cu',
            'diffco_tpu/ops/fused_score.py:138', [B, S, F], b2,
            lambda: fused_score.poly_score_grad(x, sup, w),
            lambda: fused_score._poly_score_grad_plain(x, sup, w),
            bound2, by2, bound_fp32_ms=bound2_fp32, bound_fp32_by=by2_fp32,
            bound_times_ms=tc_times(B, S, F, poly_bytes(B, S, F), 2 * F),
            plan=b2['plan'], warps_per_sm=b2['plan']['warps_per_sm'],
            rope_large_s_vs_float64=b2['rope_large_s'],
            planar_proxies={k: poly_at(v) for k, v in b2['planar'].items()},
            rigid_proxies={k: poly_at(v) for k, v in b2['rigid'].items()},
            multi_robot_proxies={k: poly_at(v)
                                 for k, v in b2['multi'].items()}),
        # its launches include the roofline path's block-size sweep, so its
        # error is the largest of the production and the sweep instances
        row('dh_score_grad', 'diffco_tpu_torch/csrc/dh_score.cu',
            'diffco_tpu/ops/fk_score.py:505', [B1, S1, J],
            dict(err=max(b1['err'], b67['sweep_err'])),
            lambda: fk_score.dh_score_grad(q, sup1, w1, spec),
            lambda: fk_score._dh_score_grad_plain(q, sup1, w1, spec),
            bound1, by1, bound_fp32_ms=bound1_fp32, bound_fp32_by=by1_fp32,
            bound_times_ms=dh_tc_times(B1, S1, F1, J, len(spec[1])),
            plan=b1['plan'], warps_per_sm=b1['plan']['warps_per_sm'],
            device_ms=rf.device_ms(
                lambda: fk_score.dh_score_grad(q, sup1, w1, spec),
                'dh_score_tc_kernel'),
            large_s_vs_float64=b1['large_s']['cases'],
            wide=wide_at(wide['dh_score_grad'])),
        row('chain_score_grad', 'diffco_tpu_torch/csrc/chain_score.cu',
            'diffco_tpu/ops/fk_score.py:587', [B3, S3, D], b3,
            lambda: fk_score.chain_score_grad(q3, sup3, w3, cs),
            lambda: fk_score._chain_score_grad_plain(q3, sup3, w3, cs),
            bound3, by3, bound_fp32_ms=bound3_fp32, bound_fp32_by=by3_fp32,
            bound_times_ms=tc_times(B3, S3, F3, fk_score_bytes(B3, S3, F3, D),
                                    chain_ops(c3)),
            plan=b3['plan'], warps_per_sm=b3['plan']['warps_per_sm'],
            rope_large_s_vs_float64=b3['rope_large_s'],
            scene_file=chain_at(b2['rigid']['scene F18']),
            wide=wide_at(wide['chain_score_grad']),
            rope_wide=chain_at(b2['multi']['F102 rope'])),
        row('dh_multi_score_grad', 'diffco_tpu_torch/csrc/dh_multi_score.cu',
            'diffco_tpu/ops/fk_score.py:255', [B4, S4, J4, C4], b4,
            lambda: fk_score.dh_multi_score_grad(q4, sup4, W4, spec4),
            lambda: fk_score._dh_multi_score_grad_plain(q4, sup4, W4, spec4),
            bound4, by4, **{f'ms_at_C{C}': _time_ms(
                lambda C=C: fk_score.dh_multi_score_grad(
                    *b4[f'args_c{C}']), 5, 50)
                for C in DH_MULTI_CLASSES if C != C4},
            **{f'bound_ms_at_C{C}': bound_b4(C)[0]
               for C in DH_MULTI_CLASSES},
            plans={C: b4[f'plan_c{C}'] for C in DH_MULTI_CLASSES},
            warps_per_sm=b4[f'plan_c{C4}']['warps_per_sm'],
            wide=wide_at(wide['dh_multi_score_grad'])),
        row('chain_multi_score_grad',
            'diffco_tpu_torch/csrc/chain_multi_score.cu',
            'diffco_tpu/ops/fk_score.py:405', [B5, S5, D5, C5], b5,
            lambda: fk_score.chain_multi_score_grad(q5, sup5, W5, cs5),
            lambda: fk_score._chain_multi_score_grad_plain(q5, sup5, W5,
                                                           cs5),
            bound5, by5, **{f'ms_at_C{C}': _time_ms(
                lambda C=C: fk_score.chain_multi_score_grad(
                    *b5[f'args_c{C}']), 5, 50) for C in (1, 2, 8)},
            plans={C: b5[f'plan_c{C}'] for C in (1, 2, 5, 8)},
            warps_per_sm=b5['plan_c5']['warps_per_sm'],
            wide=wide_at(wide['chain_multi_score_grad'])),
    ] + dual_rows + mode_rows + fk_rows + greedy_rows


def _launch_counts():
    """The ``launches.<kernel>`` counters now, by kernel; a B6 variant's
    and a B7 mode's ('<kernel>:<variant or mode>') count under
    '<kernel>' too. Subtracting two gives the launches between them."""
    out = collections.Counter()
    for name, n in profiling.counters().items():
        if name.startswith('launches.'):
            kernel = name[len('launches.'):]
            out[kernel] += n
            if ':' in kernel:
                out[kernel.split(':')[0]] += n
    return out


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA card available', file=sys.stderr)
        return 1
    import diffco_tpu_torch as dc
    from diffco_tpu_torch.ops import _native
    from diffco_tpu_torch.scripts import ab_dual_tile as ab
    from diffco_tpu_torch.scripts import roofline_fk_score as rf

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f'device: {name} count={count} torch={torch.__version__} '
          f'cuda={torch.version.cuda}', flush=True)
    print(smi, flush=True)
    dev = torch.device('cuda')

    t0 = time.perf_counter()
    _native.build()
    regs = _ptxas_report(_native.build_log)
    built = [e for e in dc.profiling.spans()
             if e.name == 'diffco.native.build'][-1]
    _phase('build', t0,
           nvcc_seconds=round((built.end_ns - built.start_ns) * 1e-9, 2),
           kernels=len(regs))
    print('ptxas: ' + '; '.join(regs), flush=True)
    _check_multi_ptxas(regs)
    _check_tc_ptxas(regs)
    _check_fk_ptxas(regs)
    _check_greedy_ptxas(regs)

    robot = dc.PandaFK()
    b2 = check_poly_kernel(robot, dev)
    b1 = check_dh_kernel(robot, dev)
    b1['large_s'] = check_dh_large_s(dev)
    tc_large_s = check_tc_large_s(dev)
    b3 = check_chain_kernel(dev)
    for b, k in ((b2, 'B2'), (b3, 'B3')):
        b['rope_large_s'] = [c for c in tc_large_s['cases']
                             if c['kernel'].startswith(k)]
    wide = check_wide_kernels(dev)
    b4 = check_dh_multi_kernel(robot, dev)
    b5 = check_chain_multi_kernel(dev)
    b67 = check_roofline_kernels(robot, dev)
    fk = check_dh_fk_kernel(dev)
    gt = check_greedy_train_kernel(dev)

    # count only each main path's own launches
    launches, planar, rigid, multi = {}, {}, {}, {}
    for path, run in (('PandaFK', lambda: journey(robot, dev)),
                      ('FrankaPanda', lambda: urdf_journey(dev)),
                      ('PandaFK multi-class', lambda: multi_journey(robot,
                                                                    dev)),
                      ('FrankaPanda multi-class',
                       lambda: urdf_multi_journey(dev)),
                      ('Baxter', lambda: baxter_journey(dev)),
                      ('PandaFK active', lambda: active_journey(robot, dev)),
                      ('planar', lambda: planar.update(planar_journey(dev))),
                      ('rigid body', lambda: rigid.update(rigid_journey(dev))),
                      ('multi-robot', lambda: multi.update(
                          multi_robot_journey(dev))),
                      ('mesh', lambda: mesh_journey(robot, dev)),
                      ('roofline', lambda: roofline_path(dev))):
        before = _launch_counts()
        run()
        launches[path] = _launch_counts() - before
    print('launches on the main paths: '
          f'{ {k: dict(n) for k, n in launches.items()} }', flush=True)
    for path, k in (('PandaFK', 'poly_score_grad'),
                    ('PandaFK', 'dh_score_grad'),
                    ('FrankaPanda', 'poly_score_grad'),
                    ('FrankaPanda', 'chain_score_grad'),
                    ('PandaFK multi-class', 'dh_multi_score_grad'),
                    ('FrankaPanda multi-class', 'chain_multi_score_grad'),
                    ('Baxter', 'dh_score_grad'),
                    ('Baxter', 'poly_score_grad'),
                    ('Baxter', 'dh_fk'),
                    ('Baxter', 'dh_fk_vjp'),
                    ('PandaFK', 'greedy_train'),
                    ('Baxter', 'greedy_train'),
                    ('PandaFK active', 'greedy_train'),
                    ('multi-robot', 'greedy_train'),
                    ('PandaFK active', 'dh_score_grad'),
                    ('PandaFK active', 'poly_score_grad'),
                    ('planar', 'poly_score_grad'),
                    ('rigid body', 'poly_score_grad'),
                    ('rigid body', 'chain_score_grad'),
                    ('multi-robot', 'poly_score_grad'),
                    ('multi-robot', 'chain_score_grad'),
                    ('mesh', 'dh_score_grad'),
                    ('roofline', 'dh_score_grad'),
                    ('roofline', 'dh_dual_score_grad'),
                    ('roofline', 'dh_ablation'),
                    *(('roofline', f'dh_dual_score_grad:{v}')
                      for v in ab.VARIANTS),
                    *(('roofline', f'dh_ablation:{m}') for m in rf.MODES)):
        if launches[path][k] <= 0:
            raise AssertionError(f'{k} was never launched on the {path} '
                                 'path')

    t0 = time.perf_counter()
    b2['planar'], b2['rigid'], b2['multi'] = planar, rigid, multi
    rows = kernel_table(b2, b1, b3, b4, b5, b67, wide, fk, gt, launches)
    _phase('kernel timing', t0)
    print(json.dumps({'kernels': rows}), flush=True)
    print(f'total {time.perf_counter() - t_start:.1f}s', flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': count}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
