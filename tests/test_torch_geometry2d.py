"""The port's 2-D geometry, planar robots, 2-D utils and preset scenes
against the JAX package on the same numpy inputs: the primitives,
Obstacles2D, planar_robot_signed_dist / _collision with their
q-gradients, multi-class obstacle sets, rect_rect_signed_dist and
rigid_body_signed_dist at 1e-5 (distances up to ~20 in float32), the
robots' fkine / link_segments at 1e-5, the utils at 1e-6, and the presets
identical."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffco_tpu import utils as jutils
from diffco_tpu.envs import presets2d as jpresets
from diffco_tpu.geometry import geometry2d as jg
from diffco_tpu.robots import RevolutePlanarRobot as JPlanar
from diffco_tpu.robots import RigidPlanarBody as JBody
from diffco_tpu_torch import utils as tutils
from diffco_tpu_torch.envs import presets2d as tpresets
from diffco_tpu_torch.geometry import geometry2d as tg
from diffco_tpu_torch.robots import RevolutePlanarRobot as TPlanar
from diffco_tpu_torch.robots import RigidPlanarBody as TBody

torch.set_num_threads(1)

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0,
                               atol=tol)


def _pts(rng, *shape):
    return rng.uniform(-4, 4, shape + (2,)).astype(np.float32)


def test_point_and_segment_primitives():
    rng = np.random.RandomState(0)
    p, a, b = _pts(rng, 500), _pts(rng, 500), _pts(rng, 500)
    a2, b2 = _pts(rng, 500), _pts(rng, 500)
    _close(tg.point_segment_dist(_t(p), _t(a), _t(b)),
           jg.point_segment_dist(p, a, b))
    d_t = tg.segment_segment_dist(_t(a), _t(b), _t(a2), _t(b2))
    d_j = jg.segment_segment_dist(a, b, a2, b2)
    _close(d_t, d_j)
    assert int((d_t == 0).sum()) > 50          # crossing pairs included
    r, cap = rng.uniform(0.2, 2, 500).astype(np.float32), 0.15
    _close(tg.segment_circle_signed_dist(_t(a), _t(b), _t(p), _t(r), cap),
           jg.segment_circle_signed_dist(a, b, p, r, cap))


def test_rect_primitives():
    """Point and capsule against oriented rectangles, endpoints inside,
    across and outside the box."""
    rng = np.random.RandomState(1)
    n = 2000
    c = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    half = rng.uniform(0.2, 2, (n, 2)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    a, b = _pts(rng, n) / 2, _pts(rng, n) / 2
    _close(tg.point_rect_sd(_t(a), _t(c), _t(half), _t(ang)),
           jax.jit(jg.point_rect_sd)(a, c, half, ang))
    sd_t = tg.segment_rect_signed_dist(_t(a), _t(b), _t(c), _t(half),
                                       _t(ang), 0.1)
    sd_j = np.asarray(jax.jit(jax.vmap(
        jg.segment_rect_signed_dist, (0, 0, 0, 0, 0, None)))(
            a, b, c, half, ang, 0.1))
    _close(sd_t, sd_j)
    assert (sd_j > 0.1).sum() > 200 and (sd_j < 0).sum() > 200


def test_rect_rect_signed_dist():
    rng = np.random.RandomState(2)
    n = 1000
    c1, c2 = _pts(rng, n), _pts(rng, n)
    h1 = rng.uniform(0.2, 2, (n, 2)).astype(np.float32)
    h2 = rng.uniform(0.2, 2, (n, 2)).astype(np.float32)
    a1 = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    a2 = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    ref = np.asarray(jax.jit(jax.vmap(jg.rect_rect_signed_dist))(
        c1, h1, a1, c2, h2, a2))
    _close(tg.rect_rect_signed_dist(_t(c1), _t(h1), _t(a1), _t(c2), _t(h2),
                                    _t(a2)), ref)
    assert (ref > 0).sum() > 100 and (ref < 0).sum() > 100


MULTI_CLASS = [('rect', (1, 1), (2, 1), 0, 0.4), ('circle', (-2, 0), 1.0, 1),
               ('rect', (3, -2), (1, 3), 2, -0.7), ('circle', (0, 3), 0.5, 1)]


def test_obstacles2d_fields_and_points():
    jo = jg.Obstacles2D.from_obstacle_list(MULTI_CLASS)
    to = tg.Obstacles2D.from_obstacle_list(MULTI_CLASS)
    _close(to.circles, jo.circles, 0)
    _close(to.rects, jo.rects, 0)
    np.testing.assert_array_equal(to.obstacle_classes, jo.obstacle_classes)
    assert to.num_class == jo.num_class == 3
    pts = _pts(np.random.RandomState(3), 40, 30) * 2
    _close(to.signed_dist_points(_t(pts)),
           jax.jit(jo.signed_dist_points)(pts))
    seg_a, seg_b = _pts(np.random.RandomState(4), 2, 5)
    _close(to.signed_dist_segments(_t(seg_a), _t(seg_b), 0.15),
           jax.jit(jo.signed_dist_segments)(seg_a, seg_b, 0.15))
    empty = tg.Obstacles2D()
    assert empty.signed_dist_points(_t(pts)).shape == (40, 30, 0)
    assert tg.Obstacles2D.from_obstacle_list(
        [('rect', (0, 0), 2.0)]).rects[0, 2:4].tolist() == [1.0, 1.0]
    with pytest.raises(ValueError):
        tg.Obstacles2D.from_obstacle_list([('triangle', (0, 0), 1.0)])


# (scene, dof, link length): the escape and trajopt scenes at the scripts'
# 2-DOF arm, a 3-DOF arm, and 7d_narrow's 300 boxes at 7 DOF
ARMS = [('1rect_1circle', 2, 3.5), ('2class_1', 2, 3.5),
        ('3circle', 3, 2.0), ('7d_narrow', 7, 1.0)]


@pytest.mark.parametrize('env,dof,length', ARMS)
def test_planar_robot_signed_dist(env, dof, length):
    """Distances at 1e-5; labels may differ only where |sd| < 1e-5 (the
    count of such rows is asserted, not dropped)."""
    obstacles = tpresets.get_env(env)
    jr, tr = (JPlanar(length, link_width=0.3, dof=dof),
              TPlanar(length, link_width=0.3, dof=dof))
    jo = jg.Obstacles2D.from_obstacle_list(obstacles)
    to = tg.Obstacles2D.from_obstacle_list(obstacles)
    q = np.random.RandomState(dof).uniform(
        -np.pi, np.pi, (600, dof)).astype(np.float32)
    ref = np.asarray(jg.planar_robot_signed_dist(jr, jo, q))
    out = tg.planar_robot_signed_dist(tr, to, _t(q))
    assert out.shape == ref.shape == (600, to.num_obstacles)
    _close(out, ref)
    lab_t = tg.planar_robot_collision(tr, to, _t(q)).numpy()
    lab_j = np.asarray(jg.planar_robot_collision(jr, jo, q))
    differ = lab_t != lab_j
    near = np.abs(ref.max(-1)) < 1e-5
    assert not (differ & ~near).any(), (int(differ.sum()), int(near.sum()))
    assert 0 < lab_j.sum() < len(q)


def test_planar_signed_dist_in_row_chunks(monkeypatch):
    """Rows split into chunks give the same distances as one block."""
    tr = TPlanar(1.0, link_width=0.3, dof=7)
    to = tg.Obstacles2D.from_obstacle_list(tpresets.get_env('7d_narrow'))
    q = _t(np.random.RandomState(5).uniform(-np.pi, np.pi, (300, 7)))
    whole = tg.planar_robot_signed_dist(tr, to, q)
    monkeypatch.setattr(tg, '_CHUNK_ELEMENTS', 7 * 300 * 64)
    torch.testing.assert_close(tg.planar_robot_signed_dist(tr, to, q), whole,
                               rtol=0, atol=0)


def test_planar_signed_dist_gradient():
    """d(sum of per-obstacle distances)/dq at 1e-4, multi-class scene."""
    jr, tr = JPlanar(2.0, link_width=0.3, dof=3), TPlanar(2.0, 0.3, dof=3)
    jo = jg.Obstacles2D.from_obstacle_list(MULTI_CLASS)
    to = tg.Obstacles2D.from_obstacle_list(MULTI_CLASS)
    q = np.random.RandomState(6).uniform(-np.pi, np.pi,
                                         (200, 3)).astype(np.float32)
    ref = np.asarray(jax.grad(lambda x: jg.planar_robot_signed_dist(
        jr, jo, x).sum())(jnp.asarray(q)))
    qt = _t(q).requires_grad_(True)
    g, = torch.autograd.grad(tg.planar_robot_signed_dist(tr, to, qt).sum(),
                             qt)
    _close(g, ref, 1e-4)


def test_rigid_body_signed_dist():
    parts = [((0.0, 0.0), (1.0, 0.5)), ((1.2, 0.3), (0.3, 0.3))]
    jo = jg.Obstacles2D.from_obstacle_list(MULTI_CLASS)
    to = tg.Obstacles2D.from_obstacle_list(MULTI_CLASS)
    q = np.random.RandomState(7).uniform(
        [-5, -5, -np.pi], [5, 5, np.pi], (300, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(
        lambda x: jg.rigid_body_signed_dist(parts, jo, x))(q))
    out = tg.rigid_body_signed_dist(parts, to, _t(q))
    assert out.shape == ref.shape == (300, 4)
    _close(out, ref)
    assert (ref > 0).sum() > 20


@pytest.mark.parametrize('length,dof', [(3.5, 2), ([1.0, 0.5, 2.0], None),
                                        (1.0, 7)])
def test_planar_robots_fkine(length, dof):
    jr, tr = JPlanar(length, 0.3, dof=dof), TPlanar(length, 0.3, dof=dof)
    q = np.random.RandomState(8).uniform(
        -4, 4, (64, tr.dof)).astype(np.float32)
    _close(tr.fkine(_t(q)), jr.fkine(q))
    _close(tr.link_segments(_t(q)), jr.link_segments(q))
    _close(tr.wrap(_t(q)), jr.wrap(q), 1e-6)
    _close(tr.limits, jr.limits, 0)
    with pytest.raises(ValueError):
        TPlanar(1.0, 0.3)


def test_rigid_planar_body():
    parts = [('box', (0.5, 0.0), (1, 1)), ('box', (-0.3, 0.7), (0.5, 0.5))]
    jb, tb = JBody(parts), TBody(parts)
    q = np.random.RandomState(9).uniform(-4, 4, (64, 3)).astype(np.float32)
    _close(tb.fkine(_t(q)), jb.fkine(q))
    _close(tb.wrap(_t(q)), jb.wrap(q), 1e-6)
    _close(tb.limits, jb.limits, 0)


def test_planar_utils():
    rng = np.random.RandomState(10)
    x = rng.uniform(-10, 10, (50, 3)).astype(np.float32)
    _close(tutils.se2_wrap2pi(_t(x)), jutils.se2_wrap2pi(x), 1e-6)
    _close(tutils.rot_2d(_t(x[:, 0])), jutils.rot_2d(x[:, 0]), 1e-6)
    q1, q2 = x[0], x[1]
    for num, endpoint in ((50, True), (7, False), (2, True), (1, True)):
        _close(tutils.anglin(q1, q2, num, endpoint),
               jutils.anglin(q1, q2, num, endpoint), 1e-6)
    path = np.cumsum(rng.uniform(-2.5, 2.5, (40, 3)), 0).astype(np.float32)
    wrapped = np.asarray(jutils.wrap2pi(path))
    _close(tutils.make_continue(_t(wrapped)), jutils.make_continue(wrapped),
           1e-5)


def test_presets_identical():
    assert tpresets.ENVS == jpresets.ENVS
    for kw in ({}, {'seed': 3, 'num_boxes': 40, 'gap': 1.5}):
        assert tpresets.narrow_env(**kw) == jpresets.narrow_env(**kw)
    assert tpresets.get_env('7d_narrow') == jpresets.get_env('7d_narrow')
    assert len(tpresets.get_env('7d_narrow')) == 300
    for kw in ({}, {'seed': 5, 'num_obstacles': 9, 'num_class': 3}):
        assert tpresets.random_env(**kw) == jpresets.random_env(**kw)
    assert tpresets.get_env('random', seed=2) == jpresets.get_env('random',
                                                                  seed=2)
    for name in jpresets.ENVS:
        assert tpresets.get_env(name) == jpresets.get_env(name)
