"""The port's samplers and planners against the JAX package on the same
numpy inputs: OptimSampler's escape (per-row freeze steps, final
configurations at 1e-4) and the resample_escape contract, the
manifold_jac_det of a planar end effector and of PandaFK (rtol 1e-4),
the manifold sampler's shift towards a larger Jacobian determinant, the
checkers' dataset on a transform's manifold, and MotionPlanner / RRTStar
fed the same numpy collision and score functions with the same seed
(identical paths at 1e-6, identical cnt_check); then the port's planners
on the ground truth of the JAX package's own planner tests."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from diffco_tpu import planning as jplanning
from diffco_tpu import sampler as jsampler
from diffco_tpu.geometry import geometry2d as jg
from diffco_tpu.robots import PandaFK as JPanda
from diffco_tpu.robots import RevolutePlanarRobot as JPlanar
import diffco_tpu_torch as tdc
from diffco_tpu_torch import planning as tplanning
from diffco_tpu_torch import sampler as tsampler
from diffco_tpu_torch.geometry import geometry2d as tg

torch.set_num_threads(1)

# the JAX package's planner-test world (tests/test_sampler_planning.py)
CIRCLE = [('circle', (1.6, 1.1), 0.7)]


@pytest.fixture(scope='module')
def world():
    jr, tr = JPlanar(1.0, link_width=0.2, dof=2), \
        tdc.RevolutePlanarRobot(1.0, link_width=0.2, dof=2)
    jo = jg.Obstacles2D.from_obstacle_list(CIRCLE)
    to = tg.Obstacles2D.from_obstacle_list(CIRCLE)
    return dict(jr=jr, tr=tr, jo=jo, to=to,
                jdist=lambda q: jg.planar_robot_signed_dist(jr, jo,
                                                            q).max(-1),
                tdist=lambda q: tg.planar_robot_signed_dist(tr, to,
                                                            q).amax(-1))


def _colliding(w, n, seed):
    q = np.random.RandomState(seed).uniform(
        -np.pi, np.pi, (20 * n, 2)).astype(np.float32)
    hit = np.asarray(w['jdist'](jnp.asarray(q))) > 0
    return q[hit][:n]


def _freeze_steps(traj, dist, stop_bias):
    """The first step at which each row's score reaches -stop_bias (the
    number of steps where it never does): traj [T + 1, B, dof]."""
    done = np.stack([dist(q) + stop_bias <= 0 for q in traj])  # [T+1, B]
    return np.where(done.any(0), done.argmax(0), len(traj) - 1)


def test_optim_escape_matches_reference(world, monkeypatch):
    """Both escapes on 256 colliding configurations, the ground-truth
    signed distance as the score (the same in both to ~1e-6). The JAX
    package's escape runs un-jitted with its scan unrolled so that its
    per-step configurations can be read. A row's freeze step may move by
    one where its score crosses -stop_bias within rounding: it must agree
    on at least 99 % of rows, and the rows where it agrees end within
    1e-4 of each other."""
    w = world
    q0 = _colliding(w, 256, seed=0)
    assert len(q0) == 256
    steps, stop_bias = 80, 0.05
    w['jdist'](jnp.asarray(q0))            # compiled before jit is lifted
    jtraj = []

    def scan(f, init, xs, length):
        carry = init
        jtraj.append(np.asarray(carry[0]))
        for _ in range(length):
            carry, _ = f(carry, None)
            jtraj.append(np.asarray(carry[0]))
        return carry, None

    monkeypatch.setattr(jsampler, 'lax', type('lax', (), {'scan': scan}))
    monkeypatch.setattr(jsampler.jax, 'jit', lambda f, **kw: f)
    ref = np.asarray(jsampler.OptimSampler(
        w['jr'], w['jdist'], lr=0.1, max_steps=steps,
        stop_bias=stop_bias).optim_escape(jnp.asarray(q0)))
    monkeypatch.undo()

    ttraj = []

    def tdist(q):
        ttraj.append(q.detach().clone().numpy())
        return w['tdist'](q)

    out = tsampler.OptimSampler(w['tr'], tdist, lr=0.1, max_steps=steps,
                                stop_bias=stop_bias).optim_escape(
        torch.from_numpy(q0)).numpy()
    ttraj.append(out)
    assert len(jtraj) == len(ttraj) == steps + 1
    np.testing.assert_allclose(jtraj[-1], ref)
    j_freeze = _freeze_steps(
        jtraj, lambda q: np.asarray(w['jdist'](jnp.asarray(q))), stop_bias)
    t_freeze = _freeze_steps(
        ttraj, lambda q: w['tdist'](torch.from_numpy(q)).numpy(), stop_bias)
    agree = j_freeze == t_freeze
    print(f'freeze step agrees on {int(agree.sum())} of {len(agree)} rows')
    assert agree.mean() >= 0.99
    np.testing.assert_allclose(out[agree], ref[agree], rtol=0, atol=1e-4)
    free = float((w['tdist'](torch.from_numpy(out)) <= 0).float().mean())
    assert free > 0.8


def test_resample_escape_contract(world):
    """Free rows stay; a colliding row is replaced by a free draw when one
    comes; checks count B per round, the first round included."""
    w = world
    q0 = np.concatenate([_colliding(w, 24, seed=1),
                         np.zeros((8, 2), np.float32) - 2.5])
    q0t = torch.from_numpy(q0)
    assert (w['tdist'](q0t[-8:]) <= 0).all()
    smp = tsampler.OptimSampler(w['tr'], w['tdist'], lr=0.1, max_steps=1)
    out, checks = smp.resample_escape(q0t, torch.Generator().manual_seed(1),
                                      max_tries=20)
    assert out.shape == q0t.shape and checks % len(q0) == 0
    assert checks >= 2 * len(q0)
    torch.testing.assert_close(out[-8:], q0t[-8:], rtol=0, atol=0)
    assert bool((w['tdist'](out) <= 0).all())
    _, none_needed = smp.resample_escape(q0t[-8:])
    assert none_needed == 8


def _ee(fkine):
    return lambda q: fkine(q)[:, -1, :]


def test_manifold_jac_det_planar_end_effector():
    """2-link arm of unit links: sqrt(det(J^T J + 1e-4)) ~ |sin q2|, and
    the JAX package's values at rtol 1e-4 (atol 1e-5: float32
    determinants where J is nearly singular)."""
    jr, tr = JPlanar(1.0, 0.2, dof=2), tdc.RevolutePlanarRobot(1.0, 0.2,
                                                                dof=2)
    q = np.stack([np.zeros(5), [0.1, 0.5, 1.0, 2.0, 3.0]], 1).astype(
        np.float32)
    det = tsampler.manifold_jac_det(_ee(tr.fkine), torch.from_numpy(q))
    np.testing.assert_allclose(det.numpy(), np.abs(np.sin(q[:, 1])),
                               atol=2e-2)
    q = np.random.RandomState(2).uniform(-3, 3, (64, 2)).astype(np.float32)
    ref = np.asarray(jsampler.manifold_jac_det(_ee(jr.fkine),
                                               jnp.asarray(q)))
    out = tsampler.manifold_jac_det(_ee(tr.fkine), torch.from_numpy(q))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_manifold_jac_det_pandafk():
    """PandaFK's 21 control-point coordinates, through the port's DH FK
    Function's forward mode (one pass per joint), against jacfwd."""
    q = np.random.RandomState(3).uniform(-2, 2, (32, 7)).astype(np.float32)
    jp, tp = JPanda(), tdc.PandaFK()
    ref = np.asarray(jsampler.manifold_jac_det(jp.fkine, jnp.asarray(q)))
    out = tsampler.manifold_jac_det(tp.fkine, torch.from_numpy(q))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4)
    # the end effector: 3 outputs, 7 joints (J^T J over the smaller side)
    ref = np.asarray(jsampler.manifold_jac_det(_ee(jp.fkine),
                                               jnp.asarray(q)))
    out = tsampler.manifold_jac_det(_ee(tp.fkine), torch.from_numpy(q))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4)


def test_manifold_sampling_shifts_distribution():
    """The accepted set's mean Jacobian determinant exceeds the uniform
    draw's (E[det^2] / E[det] >= E[det])."""
    tr = tdc.RevolutePlanarRobot(1.0, 0.2, dof=2)
    g = torch.Generator().manual_seed(0)
    qm = tsampler.uniform_sample_on_transformed_manifold(
        tr, _ee(tr.fkine), 512, g, device='cpu')
    qu = tr.rand_configs(512, torch.Generator().manual_seed(123), 'cpu')
    assert qm.shape == (512, 2)
    det_m = float(tsampler.manifold_jac_det(_ee(tr.fkine), qm).mean())
    det_u = float(tsampler.manifold_jac_det(_ee(tr.fkine), qu).mean())
    assert det_m > det_u * 1.05
    # a transform singular everywhere is topped up with uniform draws
    qz = tsampler.uniform_sample_on_transformed_manifold(
        tr, lambda q: q[:, :1] * 0, 64, g, device='cpu')
    assert qz.shape == (64, 2)
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError):
            tsampler.uniform_sample_on_transformed_manifold(
                tr, _ee(tr.fkine), 8, g)


def test_generate_dataset_sample_transform():
    """sample_transform reaches the manifold sampler through the
    checkers' dataset generator, on the checker's device."""
    tr = tdc.RevolutePlanarRobot(1.0, link_width=0.2, dof=2)
    obs = tg.Obstacles2D.from_obstacle_list([('circle', (1.5, 1.0), 0.6)])

    def gt(q):
        return tg.planar_robot_collision(tr, obs, q)

    checker = tdc.RBFDiffCo(robot=tr, gt_check_func=gt, device='cpu')
    q, labels, dists = checker._generate_dataset(
        None, None, None, 256, sample_transform=_ee(tr.fkine))
    assert q.shape == (256, 2) and labels.shape == (256,)
    assert dists.shape == (256,)
    fk = tdc.ForwardKinematicsDiffCo(robot=tr, gt_check_func=gt,
                                     device='cpu')
    assert fk._uniform_sample_on_transformed_manifold(
        _ee(tr.fkine), 100).shape == (100, 2)


# C-space discs (centre, radius) that both packages see through the same
# numpy arithmetic
DISCS = np.asarray([[0.6, 0.4, 0.7], [-1.2, -0.8, 0.6], [1.5, -1.5, 0.5]],
                   np.float32)


def _np_score(q):
    q = np.asarray(q, np.float32)
    d = np.linalg.norm(q[:, None, :] - DISCS[None, :, :2], axis=-1)
    return (DISCS[None, :, 2] - d).max(-1).astype(np.float32)


def _fns(kind):
    """(collision, score) over the same numpy function, in the package's
    own array type."""
    if kind == 'jax':
        return (lambda q: jnp.asarray(_np_score(np.asarray(q)) > 0),
                lambda q: jnp.asarray(_np_score(np.asarray(q))))
    return (lambda q: torch.from_numpy(_np_score(q.numpy()) > 0),
            lambda q: torch.from_numpy(_np_score(q.numpy())))


ENDS = (np.asarray([-2.5, 2.0]), np.asarray([2.4, -0.3]))


@pytest.mark.parametrize('seed,batch', [(0, 32), (5, 8)])
def test_motion_planner_matches_reference(seed, batch):
    jr, tr = JPlanar(1.0, 0.2, dof=2), tdc.RevolutePlanarRobot(1.0, 0.2,
                                                                dof=2)
    jp = jplanning.MotionPlanner(jr, _fns('jax')[0], step_size=0.4,
                                 seed=seed)
    tp = tplanning.MotionPlanner(tr, _fns('torch')[0], step_size=0.4,
                                 seed=seed, device='cpu')
    ref = jp.plan(*ENDS, max_iters=800, batch=batch)
    out = tp.plan(*ENDS, max_iters=800, batch=batch)
    assert ref is not None and out is not None
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    assert tp.cnt_check == jp.cnt_check > 0
    raw_j = jp.plan(*ENDS, max_iters=800, batch=batch, dense_output=False)
    raw_t = tp.plan(*ENDS, max_iters=800, batch=batch, dense_output=False)
    np.testing.assert_allclose(raw_t, raw_j, rtol=0, atol=1e-6)
    assert not (_np_score(out) > 0).any()


@pytest.mark.parametrize('weighted', [True, False])
def test_rrt_star_matches_reference(weighted):
    jr, tr = JPlanar(1.0, 0.2, dof=2), tdc.RevolutePlanarRobot(1.0, 0.2,
                                                                dof=2)
    jc, js = _fns('jax')
    tc, ts = _fns('torch')
    jp = jplanning.RRTStar(jr, jc, score_fn=js if weighted else None,
                           step_size=0.5, radius=1.0, seed=1)
    tp = tplanning.RRTStar(tr, tc, score_fn=ts if weighted else None,
                           step_size=0.5, radius=1.0, seed=1, device='cpu')
    ref = jp.plan(*ENDS, max_iters=300, goal_tol=0.5)
    out = tp.plan(*ENDS, max_iters=300, goal_tol=0.5)
    assert ref is not None and out is not None
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    assert tp.cnt_check == jp.cnt_check > 0


def test_planners_gt_free_on_reference_world(world):
    """The JAX package's planner tests on the port: RRT-Connect and RRT*
    (the score on its edge costs) between free configurations, the paths
    free under the ground truth."""
    w = world
    tr = w['tr']

    def collision(q):
        return tg.planar_robot_collision(tr, w['to'], q)

    q = tr.rand_configs(128, torch.Generator().manual_seed(3), 'cpu')
    idx = torch.nonzero(~collision(q)).reshape(-1)
    start, goal = q[idx[0]].numpy(), q[idx[-1]].numpy()
    planner = tdc.MotionPlanner(tr, collision, step_size=0.4, device='cpu')
    path = planner.plan(start, goal, max_iters=500)
    assert path is not None and planner.cnt_check > 0
    np.testing.assert_allclose(path[0], start, atol=1e-6)
    np.testing.assert_allclose(path[-1], goal, atol=1e-6)
    assert not collision(torch.as_tensor(path, dtype=torch.float32)).any()
    star = tdc.RRTStar(tr, collision, score_fn=w['tdist'], step_size=0.5,
                       radius=1.0, seed=1, device='cpu')
    path = star.plan(start, goal, max_iters=600, goal_tol=0.5)
    assert path is not None
    assert not collision(torch.as_tensor(path, dtype=torch.float32)).any()
