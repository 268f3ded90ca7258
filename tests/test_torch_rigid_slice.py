"""The rigid-body and scene-file slice as a whole against the JAX package
on the same numpy inputs, at a small size: an SE(3) DiffCo over the
probe body's keypoints (scripts/trajopt_se3.py's world and options) and
an SE(2) q-space DiffCo (scripts/trajopt_se2.py's), each fitted by the
JAX package and carried across (poly_score 1e-4, its q-gradient 1e-3),
fitted by the port on the same data (the same supports; scores within
1e-2, the float32 solves' difference), and Adam on SE(3) from a jittered
line; then the MoveIt .scene journey: identical scene arrays and the
same FrankaPanda labels, the port's fit and Adam run on the CPU."""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import diffco_tpu as jdc
from diffco_tpu import kernels as jkernels
from diffco_tpu import optim as joptim
from diffco_tpu import utils as jutils
from diffco_tpu.envs.moveit_scene import load_moveit_scene as jload
from diffco_tpu.geometry import geometry2d as jg2
from diffco_tpu.geometry import geometry3d as jg3
import diffco_tpu_torch as tdc
from diffco_tpu_torch import optim as toptim
from diffco_tpu_torch.convert import load_reference_state

torch.set_num_threads(1)

STATE_FIELDS = ('support_points', 'support_transformed', 'gains',
                'hypothesis', 'y', 'kernel_matrix', 'rbf_nodes',
                'valid_mask', 'distance')
N_TRAIN = 800

# scripts/trajopt_se3.py: the probe body and its four-shape world
PROBE = np.asarray([[-0.3, 0, 0], [0, 0, 0], [0.3, 0, 0]], np.float32)
PROBE_R = np.full(3, 0.18, np.float32)
SE3_LIMITS = [[-3, 3]] * 3 + [[-np.pi, np.pi]] * 3


def _T(t):
    return np.r_[np.c_[np.eye(3), np.asarray(t)], [[0, 0, 0, 1]]]


SE3_SHAPES = {
    'pillar1': {'type': 'Cylinder', 'params': {'radius': 0.5, 'height': 6.0},
                'transform': _T([1.2, 1.2, 0.0])},
    'pillar2': {'type': 'Cylinder', 'params': {'radius': 0.5, 'height': 6.0},
                'transform': _T([-1.2, -1.2, 0.0])},
    'shelf': {'type': 'Box', 'params': {'extents': [2.0, 0.4, 2.0]},
              'transform': _T([0.0, 1.8, 0.0])},
    'ball': {'type': 'Sphere', 'params': {'radius': 0.6},
             'transform': _T([-1.5, 1.5, 1.0])},
}
# scripts/trajopt_se2.py: the L-shaped body and its three obstacles
SE2_BODY = [((0.0, 0.0), (1.0, 0.25)), ((0.75, 0.0), (0.25, 0.75))]
SE2_OBSTACLES = [('rect', (4, 4), (3, 3), 0), ('circle', (-4, -4), 2.0, 1),
                 ('rect', (-4, 4), (2, 4), 1)]
SE2_LIMITS = [[-8, 8], [-8, 8], [-np.pi, np.pi]]


def _uniform(limits, n, seed):
    lim = np.asarray(limits, np.float64)
    return np.random.default_rng(seed).uniform(
        lim[:, 0], lim[:, 1], (n, len(lim))).astype(np.float32)


@jax.jit
def _se3_signed_dist(q):
    """The script's ground truth: the probe's spheres in the world, max
    signed distance over objects (> 0 in collision)."""
    scene = jdc.ShapeEnv(shapes=SE3_SHAPES).scene
    R = jutils.euler2mat(q[:, 3:])
    centers = jnp.einsum('bij,pj->bpi', R, jnp.asarray(PROBE),
                         precision='highest') + q[:, None, :3]
    return jax.vmap(lambda c: jnp.max(jg3.spheres_vs_scene_signed_dist(
        c, jnp.asarray(PROBE_R), scene)))(centers)


@jax.jit
def _se2_signed_dist(q):
    obs = jg2.Obstacles2D.from_obstacle_list(SE2_OBSTACLES)
    return jnp.max(jg2.rigid_body_signed_dist(SE2_BODY, obs, q), axis=-1)


def _arrays(jp):
    out = {k: np.asarray(getattr(jp, k)) for k in STATE_FIELDS
           if getattr(jp, k, None) is not None}
    out.update(num_valid=jp.num_valid, rbf_kernel='Polyharmonic', k=1,
               epsilon=1.0)
    return out


def _fit(pkg, kernel, q, dist, transform=None):
    """A DiffCo fitted on distances by pkg (jdc or tdc), the scripts'
    route: train with 3 N iterations, fit_poly(Polyharmonic(1, 1),
    'dist')."""
    to = jnp.asarray if pkg is jdc else torch.from_numpy
    p = pkg.DiffCo(kernel_func=kernel, transform=transform)
    p.train(to(q), to(((dist > 0) * 2.0 - 1.0).astype(np.float32)),
            max_iteration=3 * len(q), distance=to(dist.astype(np.float32)))
    p.fit_poly(pkg.kernels.Polyharmonic(1, 1), target='dist')
    return p


def _scores(jp, tp, q, fp64):
    """poly_score and its q-gradient of both packages on q: in float64
    (both evaluating the float32 state) or float32."""
    if fp64:
        floats = [k for k in STATE_FIELDS if k != 'valid_mask'
                  and getattr(jp, k, None) is not None]
        with jax.enable_x64(True):
            j64 = copy.copy(jp)
            for k in floats:
                setattr(j64, k, jnp.asarray(np.asarray(getattr(jp, k)),
                                            jnp.float64))
            x = jnp.asarray(q, jnp.float64)
            js = np.asarray(jax.jit(j64.poly_score)(x))
            jg = np.asarray(jax.jit(jax.grad(
                lambda x: j64.poly_score(x).sum()))(x))
        tp = copy.copy(tp)
        for k in floats:
            setattr(tp, k, getattr(tp, k).double())
        x = torch.from_numpy(q).double().requires_grad_(True)
    else:
        js = np.asarray(jp.poly_score(jnp.asarray(q)))
        jg = np.asarray(jax.grad(lambda x: jp.poly_score(x).sum())(
            jnp.asarray(q)))
        x = torch.from_numpy(q).requires_grad_(True)
    ts = tp.poly_score(x)
    tg, = torch.autograd.grad(ts.sum(), x)
    return ts.detach().numpy(), tg.numpy(), js, jg


def _same_fit(jp, own, q):
    """The port's own fit of the same data: the same supports (ranked by
    |gain|, so gains equal to rounding may swap places), scores within
    1e-2 (the two packages' float32 LU solves differ)."""
    assert own.num_valid == jp.num_valid
    valid = np.asarray(jp.valid_mask)
    np.testing.assert_array_equal(own.valid_mask.numpy(), valid)

    def rows(a):
        return a[np.lexsort(a.T[::-1])]
    np.testing.assert_array_equal(
        rows(own.support_points.numpy()[valid]),
        rows(np.asarray(jp.support_points)[valid]))
    np.testing.assert_allclose(
        own.poly_score(torch.from_numpy(q)).detach().numpy(),
        np.asarray(jp.poly_score(jnp.asarray(q))), rtol=1e-2, atol=1e-2)


@pytest.fixture(scope='module')
def se3():
    """The SE(3) probe proxy over its keypoints (F = 9), fitted by the
    JAX package on N_TRAIN samples of the script's world."""
    q = _uniform(SE3_LIMITS, N_TRAIN, seed=0)
    dist = np.asarray(_se3_signed_dist(jnp.asarray(q)))
    jb = jdc.RigidBody(keypoints=PROBE, limits=SE3_LIMITS)
    tb = tdc.RigidBody(keypoints=PROBE, limits=SE3_LIMITS)
    jp = _fit(jdc, jkernels.RQKernel(10.0), q, dist,
              transform=lambda x: jb.fkine(x))
    tp = tdc.DiffCo(kernel_func=tdc.kernels.RQKernel(10.0),
                    transform=lambda x: tb.fkine(x))
    load_reference_state(tp, _arrays(jp), device='cpu')
    return dict(q=q, dist=dist, jb=jb, tb=tb, jp=jp, tp=tp)


def test_se3_proxy_carried_across(se3):
    """The JAX-fitted SE(3) proxy on the port: no robot behind its
    lambda transform, so the score goes through fkine and the point-space
    route (F = 9): poly_score 1e-4, its q-gradient 1e-3 on 512 held-out
    configurations; the proxy separates the held-out set."""
    tp, jp = se3['tp'], se3['jp']
    assert tp._fk_robot() is None and tp.support_transformed.shape[1] == 9
    q = _uniform(SE3_LIMITS, 512, seed=1)
    ts, tg, js, jg = _scores(jp, tp, q, fp64=False)
    np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tg, jg, rtol=1e-3, atol=1e-3)
    truth = np.asarray(_se3_signed_dist(jnp.asarray(q))) > 0
    assert ((ts[:, 0] > 0) == truth).mean() > 0.8


def test_se3_port_fit_matches_reference(se3):
    """The port's own fit of the same SE(3) data picks the same
    supports."""
    own = _fit(tdc, tdc.kernels.RQKernel(10.0), se3['q'], se3['dist'],
               transform=lambda x: se3['tb'].fkine(x))
    _same_fit(se3['jp'], own, _uniform(SE3_LIMITS, 512, seed=1))


def test_se3_adam_matches_reference(se3):
    """Adam on the carried-across SE(3) proxy from a jittered line between
    two free configurations (the script's options, one restart, 20
    steps): solution 1e-3, cost 1e-3, the same success and checks."""
    q = _uniform(SE3_LIMITS, 256, seed=2)
    free = q[np.asarray(_se3_signed_dist(jnp.asarray(q))) <= -0.1]
    start, target = free[0], free[-1]
    init = (np.linspace(start, target, 12) + np.random.default_rng(3)
            .normal(scale=0.05, size=(12, 6))).astype(np.float32)
    opts = {'N_WAYPOINTS': 12, 'NUM_RE_TRIALS': 1, 'MAXITER': 20,
            'safety_margin': -0.3, 'max_speed': 2.0, 'seed': 0,
            'dense_sub': 4, 'init_solution': init}
    jp, tp = se3['jp'], se3['tp']
    ref = joptim.adam_traj_optimize(
        se3['jb'], lambda p: jp.poly_score(p).reshape(-1), start, target,
        opts)
    out = toptim.adam_traj_optimize(
        se3['tb'], lambda p: tp.poly_score(p).reshape(-1),
        torch.from_numpy(start), torch.from_numpy(target), opts)
    np.testing.assert_allclose(np.asarray(out['solution']),
                               np.asarray(ref['solution']), atol=1e-3)
    np.testing.assert_allclose(out['cost'], ref['cost'], rtol=1e-3)
    assert out['success'] == ref['success']
    assert out['cnt_check'] == ref['cnt_check']


def test_se2_proxy_carried_across_and_refitted():
    """scripts/trajopt_se2.py's q-space proxy (F = 3) fitted by the JAX
    package on N_TRAIN samples: carried across, poly_score 1e-4 and its
    gradient 1e-3 evaluated in float64 on both sides (a q-space proxy's
    weights cancel: in float32 the packages' sums differ by more); the
    port's own fit picks the same supports; the port's ground truth
    agrees with the reference's at 1e-5."""
    q = _uniform(SE2_LIMITS, N_TRAIN, seed=4)
    dist = np.asarray(_se2_signed_dist(jnp.asarray(q)))
    tobs = tdc.Obstacles2D.from_obstacle_list(SE2_OBSTACLES)
    from diffco_tpu_torch.geometry.geometry2d import rigid_body_signed_dist
    np.testing.assert_allclose(
        rigid_body_signed_dist(SE2_BODY, tobs, torch.from_numpy(q))
        .amax(-1).numpy(), dist, rtol=1e-5, atol=1e-5)
    jp = _fit(jdc, jkernels.RQKernel(1.0), q, dist)
    tp = tdc.DiffCo(kernel_func=tdc.kernels.RQKernel(1.0))
    load_reference_state(tp, _arrays(jp), device='cpu')
    qt = _uniform(SE2_LIMITS, 512, seed=5)
    ts, tg, js, jg = _scores(jp, tp, qt, fp64=True)
    np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tg, jg, rtol=1e-3, atol=1e-3)
    own = _fit(tdc, tdc.kernels.RQKernel(1.0), q, dist)
    _same_fit(jp, own, qt)


# tests/test_moveit_scene_e2e.py's world: a box, a sphere, an inline mesh
SCENE = """\
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


def test_scene_file_journey(tmp_path):
    """The .scene journey on the CPU: the loaded scenes are identical;
    FrankaPanda (no gripper, 12 spheres a link, the ACM from the same
    configurations) labels the same configurations as the reference away
    from the boundary; the port's fit, score and Adam run (the reference
    trajectory's ground-truth validity is not a reference here: it
    collides)."""
    path = tmp_path / 'panda_world.scene'
    path.write_text(SCENE)
    tenv = tdc.load_moveit_scene(str(path), mesh_spheres=6)
    jenv = jload(str(path), mesh_spheres=6)
    assert tenv.name == jenv.name == 'panda_world'
    assert tenv.object_names == jenv.object_names
    for f in ('sph_c', 'sph_r', 'box_t', 'box_R', 'box_h', 'msh_c', 'msh_r',
              'msh_obj'):
        np.testing.assert_array_equal(getattr(tenv.scene, f).numpy(),
                                      np.asarray(getattr(jenv.scene, f)))
    kw = dict(load_gripper=False, setup_acm=False, link_spheres=12)
    jr = jdc.FrankaPanda(**kw)
    tr = tdc.FrankaPanda(device='cpu', **kw)
    acm_q = _uniform(np.asarray(tr.joint_limits), 100, seed=6)
    jr.rand_configs = lambda n, key=None: jnp.asarray(acm_q[:n])
    tr.rand_configs = lambda n, *a, **k: torch.from_numpy(acm_q[:n])
    jr._setup_acm(100)
    tr._setup_acm(100)
    del jr.rand_configs, tr.rand_configs
    q = _uniform(np.asarray(tr.joint_limits), 512, seed=7)
    env_sd, self_sd = tr.collision_signed_dist(torch.from_numpy(q), tenv)
    jenv_sd, jself_sd = jr.collision_signed_dist(jnp.asarray(q), jenv)
    np.testing.assert_allclose(env_sd.numpy(), np.asarray(jenv_sd),
                               rtol=1e-5, atol=1e-5)
    labels = tr.collision(torch.from_numpy(q), other=tenv).numpy()
    ref = np.asarray(jr.collision(jnp.asarray(q), other=jenv))
    sd = np.maximum(np.asarray(jenv_sd).max(-1), np.asarray(jself_sd))
    away = np.abs(sd) >= 1e-5
    np.testing.assert_array_equal(labels[away], ref[away])
    assert (np.asarray(jenv_sd)[:, -1] > 0).any()      # the mesh is hit

    checker = tdc.ForwardKinematicsDiffCo(robot=tr, environment=tenv,
                                          seed=0, device='cpu')
    acc, tpr, tnr = checker.fit(num_samples=400)
    free = torch.from_numpy(q[~labels])
    rec = toptim.adam_traj_optimize(
        tr, checker.score_fn(bias=0.0), free[0], free[-1],
        {'N_WAYPOINTS': 6, 'NUM_RE_TRIALS': 1, 'MAXITER': 5,
         'safety_margin': -float(checker.safety_bias), 'seed': 5,
         'dense_sub': 3})
    assert np.isfinite(rec['cost'])
    assert np.asarray(rec['solution']).shape == (6, 7)
