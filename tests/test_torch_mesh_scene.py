"""Mesh obstacles, the point-cloud world, the MoveIt ``.scene`` parser, the
tutorial Panda environments and the SE(3) path view of the port against
the JAX package on the same inputs: scenes with a file mesh (torus.stl,
scale 0.5) and an inline mesh build identical arrays and object names,
and their signed distances agree at 1e-5 on seeded probes, through the
scene, a capsule-chain robot and a URDF robot's sphere model."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffco_tpu import routines as jroutines
from diffco_tpu.envs import ShapeEnv as JShapeEnv
from diffco_tpu.envs import panda_envs as jpanda
from diffco_tpu.envs.moveit_scene import parse_scene_text as jparse
from diffco_tpu.envs.shape_env import PCDEnv as JPCDEnv
from diffco_tpu.geometry import geometry3d as jg
from diffco_tpu.robots import PandaFK as JPandaFK
from diffco_tpu.robots.capsule_chain import CapsuleChainCollision as JCap
import diffco_tpu_torch as tdc
from diffco_tpu_torch import routines as troutines
from diffco_tpu_torch.envs import panda_envs as tpanda
from diffco_tpu_torch.envs.moveit_scene import parse_scene_text as tparse
from diffco_tpu_torch.geometry import geometry3d as tg

torch.set_num_threads(1)

TORUS = 'robot_data/generated/torus.stl'
MESH_FIELDS = ('msh_c', 'msh_r', 'msh_obj')


def _T(t, rpy=(0.0, 0.0, 0.0)):
    from scipy.spatial.transform import Rotation
    m = np.eye(4)
    m[:3, :3] = Rotation.from_euler('xyz', rpy).as_matrix()
    m[:3, 3] = t
    return m


def _shapes():
    """Every shape kind, a file mesh (scaled, rotated) and an inline one."""
    wedge = {'vertices': np.asarray([[0, 0, 0], [0.2, 0, 0], [0, 0.2, 0],
                                     [0, 0, 0.2]], np.float32),
             'faces': np.asarray([[0, 1, 2], [0, 1, 3], [0, 2, 3],
                                  [1, 2, 3]], np.int32)}
    return {
        'torus': {'type': 'Mesh',
                  'params': {'file_obj': TORUS, 'scale': 0.5},
                  'transform': _T([0.4, -0.2, 0.5], (0.3, -0.2, 0.8))},
        'ball': {'type': 'Sphere', 'params': {'radius': 0.1},
                 'transform': _T([0.5, 0.0, 0.0])},
        'wedge': {'type': 'Mesh', 'params': wedge,
                  'transform': _T([0.3, 0.35, 0.3])},
        'crate': {'type': 'Box', 'params': {'extents': [0.1, 0.2, 0.3]},
                  'transform': _T([0.5, 0.5, 0.5], (0.1, 0.2, 0.3))},
        'pole': {'type': 'Cylinder', 'params': {'radius': 0.1,
                                                'height': 0.2},
                 'transform': _T([0.0, -0.5, 0.5])},
        'pill': {'type': 'Capsule', 'params': {'radius': 0.1, 'height': 0.2},
                 'transform': _T([0.5, 0.5, 0.0])},
    }


def _same_scene(tenv, jenv):
    """Identical mesh arrays and object names; the other arrays at 1e-7."""
    assert tenv.object_names == jenv.object_names
    ts, js = tenv.scene, jenv.scene
    assert ts.n_mesh_objects == js.n_mesh_objects
    assert ts.n_objects == js.n_objects
    for f in MESH_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    for f in ('sph_c', 'box_R', 'box_t', 'cyl_t', 'cap_t'):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), atol=1e-7)


def _probes(n, seed):
    return np.random.default_rng(seed).uniform(
        [-0.2, -0.8, -0.2], [0.9, 0.8, 1.0], (n, 3)).astype(np.float32)


def _same_distances(tenv, jenv, seed=0):
    """point_sdf_per_object and spheres_vs_scene_signed_dist at 1e-5."""
    p = _probes(512, seed)
    np.testing.assert_allclose(
        tenv.scene.point_sdf_per_object(torch.from_numpy(p)).numpy(),
        np.asarray(jenv.scene.point_sdf_per_object(jnp.asarray(p))),
        rtol=1e-5, atol=1e-5)
    sets = p.reshape(64, 8, 3)
    radii = np.random.default_rng(seed + 1).uniform(0.01, 0.1, 8).astype(
        np.float32)
    out = tg.spheres_vs_scene_signed_dist(
        torch.from_numpy(sets), torch.from_numpy(radii), tenv.scene)
    ref = np.asarray(jax.jit(jax.vmap(
        jg.spheres_vs_scene_signed_dist, in_axes=(0, None, None)))(
            jnp.asarray(sets), jnp.asarray(radii), jenv.scene))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    return ref


def test_mesh_scene_matches_reference():
    """A file mesh and an inline mesh beside every primitive: identical
    arrays and names (meshes last), distances at 1e-5, and some probe
    sets inside each mesh object."""
    tenv = tdc.ShapeEnv(_shapes(), mesh_spheres=12)
    jenv = JShapeEnv(_shapes(), mesh_spheres=12)
    _same_scene(tenv, jenv)
    assert tenv.object_names[-2:] == ['torus', 'wedge']
    assert tenv.scene.msh_c.shape == (24, 3)
    ref = _same_distances(tenv, jenv)
    assert (ref[:, -2:] > 0).any(0).all()


def test_mesh_obstacle_moves_with_its_local_frame():
    """update_transform on a mesh obstacle: the decomposition comes from
    the cache (no new entry), its centers are the local ones in the new
    pose, and both packages agree after the move."""
    tenv = tdc.ShapeEnv(_shapes(), mesh_spheres=12)
    jenv = JShapeEnv(_shapes(), mesh_spheres=12)
    n_cached = len(tg._mesh_sphere_cache)
    local = tg._mesh_sphere_cache[(TORUS, 0.5, 12)][0]
    move = _T([0.1, 0.3, 0.2], (-0.5, 0.4, 1.1))
    tenv.update_transform('torus', move)
    jenv.update_transform('torus', move)
    assert len(tg._mesh_sphere_cache) == n_cached
    R, t = move[:3, :3].astype(np.float32), move[:3, 3].astype(np.float32)
    np.testing.assert_array_equal(tenv.scene.msh_c[:12].numpy(),
                                  local @ R.T + t)
    _same_scene(tenv, jenv)
    _same_distances(tenv, jenv, seed=1)


def test_mesh_obstacles_reach_the_ground_truths():
    """The capsule-chain checker of PandaFK and FrankaPanda's sphere model
    read the mesh objects through spheres_vs_scene_signed_dist: both at
    1e-5 of the reference on the same configurations, and the mesh
    objects change some labels."""
    tenv = tdc.ShapeEnv(_shapes(), mesh_spheres=12)
    jenv = JShapeEnv(_shapes(), mesh_spheres=12)
    q = np.random.default_rng(2).uniform(-2.5, 2.5, (256, 7)).astype(
        np.float32)
    tcap = tdc.CapsuleChainCollision(tdc.PandaFK(), link_radius=0.1)
    jcap = JCap(JPandaFK(), link_radius=0.1)
    sd = tcap.signed_dist(torch.from_numpy(q), tenv).numpy()
    np.testing.assert_allclose(sd, np.asarray(jcap.signed_dist(q, jenv)),
                               rtol=1e-5, atol=1e-5)
    no_mesh = tdc.ShapeEnv({k: v for k, v in _shapes().items()
                            if v['type'] != 'Mesh'})
    assert ((sd > 0) != (tcap.signed_dist(torch.from_numpy(q), no_mesh)
                         .numpy() > 0)).any()
    tenv_p = tpanda.PandaEnv(_shapes(), device='cpu', load_gripper=False,
                             setup_acm=False, link_spheres=4)
    jenv_p = jpanda.PandaEnv(_shapes(), load_gripper=False, setup_acm=False,
                             link_spheres=4)
    env_t, _ = tenv_p.robot.collision_signed_dist(torch.from_numpy(q),
                                                  tenv_p.env)
    env_j, _ = jenv_p.robot.collision_signed_dist(jnp.asarray(q),
                                                  jenv_p.env)
    np.testing.assert_allclose(env_t.numpy(), np.asarray(env_j), rtol=1e-5,
                               atol=1e-5)


def test_pcd_env_matches_reference():
    """PCDEnv keeps the reference's subsample of a large cloud, and
    update_point_cloud keeps the radius and the cap; its scene's distances
    agree at 1e-5."""
    cloud = np.random.default_rng(3).uniform(-1, 1, (5000, 3))
    tenv = tdc.PCDEnv(cloud, point_radius=0.03, max_points=300)
    jenv = JPCDEnv(cloud, point_radius=0.03, max_points=300)
    np.testing.assert_array_equal(tenv.point_cloud, jenv.point_cloud)
    assert tenv.object_names == jenv.object_names
    assert tenv.scene.n_objects == 300
    _same_distances(tenv, jenv)
    tenv.update_point_cloud(cloud[:1000])
    jenv.update_point_cloud(cloud[:1000])
    assert (tenv.point_radius, tenv.max_points) == (0.03, 300)
    np.testing.assert_array_equal(tenv.point_cloud, jenv.point_cloud)
    np.testing.assert_array_equal(tenv.scene.sph_r.numpy(),
                                  np.full(300, 0.03, np.float32))
    small = tdc.PCDEnv(cloud[:10], point_radius=0.05)
    assert small.scene.n_objects == 10


# copied from tests/test_moveit_scene.py
OLD_FORMAT = """\
myscene
* shelf
1
box
0.4 0.8 0.02
-0.6 0 0.5
0 0 0 1
0 0 0 0
* ball
1
sphere
0.15
1.0 0.1 0.0
0 0 0 1
0 0 0 0
* pole
1
cylinder
0.05 1.2
0.5 0.5 0.6
0 0 0 1
0 0 0 0
* funnel
1
cone
0.1 0.2
0.7 0.4 0.05
0 0 0 1
0 0 0 0
* wedge
1
mesh
4 4
0 0 0
0.2 0 0
0 0.2 0
0 0 0.2
0 1 2
0 1 3
0 2 3
1 2 3
0.3 -0.4 0.1
0 0 0 1
0 0 0 0
.
"""

NEW_FORMAT = """\
newscene
* crate
0.5 0 0.25
0 0 0 1
1
box
0.3 0.3 0.3
0 0 0
0 0 0 1
0 0 0 0
.
"""


def _same_value(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same_value(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize('text', [OLD_FORMAT, NEW_FORMAT],
                         ids=['old', 'new'])
def test_parse_scene_text_matches_reference(tmp_path, text):
    """Both serializations parse to identical names and shape dicts; the
    file loads as a ShapeEnv equal to the reference's."""
    tname, tshapes = tparse(text)
    jname, jshapes = jparse(text)
    assert tname == jname
    _same_value(tshapes, jshapes)
    path = tmp_path / 'world.scene'
    path.write_text(text)
    from diffco_tpu.envs.moveit_scene import load_moveit_scene
    tenv = tdc.load_moveit_scene(str(path), mesh_spheres=4)
    jenv = load_moveit_scene(str(path), mesh_spheres=4)
    assert tenv.name == jenv.name
    _same_scene(tenv, jenv)
    _same_distances(tenv, jenv)


def test_panda_envs_match_reference():
    """The preset environments hold the reference's shapes; is_collision
    and distance (separation, positive when free) agree on the same
    configurations; the empty world's distance is +inf and nothing
    collides in it; sample_q lies inside the limits."""
    q = np.random.default_rng(5).uniform(-2.5, 2.5, (64, 7)).astype(
        np.float32)
    kw = dict(load_gripper=False, setup_acm=False, link_spheres=4)
    for name in ('PandaSingleCylinderEnv', 'PandaThreeCylinderEnv',
                 'PandaSingleCuboidEnv'):
        tenv = getattr(tpanda, name)(device='cpu', **kw)
        jenv = getattr(jpanda, name)(**kw)
        _same_value(tenv.env.shapes, jenv.env.shapes)
        if name == 'PandaSingleCylinderEnv':
            continue     # PandaThreeCylinderEnv holds its cylinder
        assert tenv.is_collision(q) == jenv.is_collision(q)
        np.testing.assert_allclose(tenv.distance(q), jenv.distance(q),
                                   rtol=1e-5, atol=1e-5)
        assert any(tenv.is_collision(q)) and not all(tenv.is_collision(q))
    empty_t = tpanda.PandaEnv(device='cpu', **kw)
    empty_j = jpanda.PandaEnv(**kw)
    assert empty_t.distance(q[:3]) == empty_j.distance(q[:3]) == [np.inf] * 3
    assert empty_t.is_collision(q[0]) == [False]
    s = empty_t.sample_q()
    lim = empty_t.robot.joint_limits
    assert s.shape == (7,)
    assert bool(((s >= lim[:, 0]) & (s <= lim[:, 1])).all())


def test_view_se3_path_matches_reference(tmp_path):
    """view_se3_path writes its figure, and the scattered keypoints equal
    the reference's at 1e-6."""
    rng = np.random.default_rng(6)
    path = np.concatenate([np.linspace([0, 0, 0], [2, 1, 1], 17),
                           rng.uniform(-np.pi, np.pi, (17, 3))], 1)
    kp = rng.normal(size=(8, 3)).astype(np.float32)
    tfig = troutines.view_se3_path(torch.from_numpy(path), keypoints=kp,
                                   save_to=str(tmp_path / 't.png'))
    jfig = jroutines.view_se3_path(path, keypoints=kp,
                                   save_to=str(tmp_path / 'j.png'))
    assert (tmp_path / 't.png').stat().st_size > 0
    tcol, jcol = tfig.axes[0].collections, jfig.axes[0].collections
    assert len(tcol) == len(jcol) == 2 + 9
    for a, b in zip(tcol, jcol):
        np.testing.assert_allclose(np.asarray(a._offsets3d),
                                   np.asarray(b._offsets3d), rtol=1e-6,
                                   atol=1e-6)
