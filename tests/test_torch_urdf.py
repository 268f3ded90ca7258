"""Port parity: URDF robots (diffco_tpu_torch.robots.urdf / kinematics /
fk_jvp's general chain against diffco_tpu.robots): the generated assets,
ChainSpec, FK and its analytic derivatives, the sphere model, the ground
truth and the allowed-collision matrix, on the same numpy inputs."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import diffco_tpu as jdc
from diffco_tpu import robot_data as jrobot_data
from diffco_tpu.ops import fk_score as jfk
from diffco_tpu.robots import kinematics as jkin
from diffco_tpu.robots import urdf as jurdf

import diffco_tpu_torch as tdc
from diffco_tpu_torch import robot_data as trobot_data
from diffco_tpu_torch.ops import fk_score as tfk
from diffco_tpu_torch.robots import kinematics as tkin
from diffco_tpu_torch.robots import urdf as turdf

torch.set_num_threads(1)

GENERATED = ['panda_simple.urdf', 'panda_simple_no_gripper.urdf',
             'trifinger_simple.urdf', 'lift_rig.urdf', '2link_robot.urdf']
VENDOR_DIR = os.path.join(os.path.dirname(jdc.__file__), 'robot_data',
                          'vendored')
VENDORED = sorted(f for f in os.listdir(VENDOR_DIR) if f.endswith('.urdf'))
# serial, branching tree, prismatic + mimic, and a real Panda skeleton
FK_ROBOTS = ['panda_simple.urdf', 'trifinger_simple.urdf', 'lift_rig.urdf',
             'vendored/panda.urdf']

_BASE = np.array([[0.0, -1.0, 0.0, 0.1],
                  [1.0, 0.0, 0.0, -0.2],
                  [0.0, 0.0, 1.0, 0.3],
                  [0.0, 0.0, 0.0, 1.0]])


def _T(t):
    m = np.eye(4)
    m[:3, 3] = t
    return m


# the 4-shape scene of tests/test_checkers.py::panda_world
SHAPES = {
    'box1': {'type': 'Box', 'params': {'extents': [0.1, 0.1, 0.1]},
             'transform': _T([0.5, 0.5, 0.5])},
    'sphere1': {'type': 'Sphere', 'params': {'radius': 0.1},
                'transform': _T([0.5, 0, 0])},
    'cylinder1': {'type': 'Cylinder', 'params': {'radius': 0.1, 'height': 0.2},
                  'transform': _T([0, -0.5, 0.5])},
    'capsule1': {'type': 'Capsule', 'params': {'radius': 0.1, 'height': 0.2},
                 'transform': _T([0.5, 0.5, 0])},
}


def _path(name):
    if name.startswith('vendored/'):
        return os.path.join(VENDOR_DIR, name.split('/', 1)[1])
    return os.path.join(trobot_data.ensure_default_assets(), name)


def _robots(name, base=None, **kw):
    """(jax robot, torch robot) built from the same URDF file."""
    kw = dict(dict(setup_acm=False, link_spheres=2), **kw)
    path = _path(name)
    return (jurdf.URDFRobot(path, base_transform=base, **kw),
            turdf.URDFRobot(path, base_transform=base, device='cpu', **kw))


def _q(robot, n, seed):
    """Configurations within the limits of a robot (or a ChainSpec)."""
    lims = getattr(robot, 'spec', robot).joint_limits
    u = np.random.default_rng(seed).uniform(
        size=(n, lims.shape[0])).astype(np.float32)
    return u * (lims[:, 1] - lims[:, 0]) + lims[:, 0]


def _loss_j(p):
    return jnp.sum(jnp.sin(p) * jnp.cos(0.7 * p))


def _loss_t(p):
    return torch.sum(torch.sin(p) * torch.cos(0.7 * p))


def test_generators_write_identical_files(tmp_path):
    for fn, kw in (('generate_rope_urdf', {'n_links': 5}),
                   ('generate_two_link_urdf', {}),
                   ('generate_panda_like_urdf', {'load_gripper': True}),
                   ('generate_panda_like_urdf', {'load_gripper': False}),
                   ('generate_trifinger_urdf', {}),
                   ('generate_lift_urdf', {})):
        a = getattr(jrobot_data, fn)(path=str(tmp_path / 'j.urdf'), **kw)
        b = getattr(trobot_data, fn)(path=str(tmp_path / 't.urdf'), **kw)
        with open(a, 'rb') as fa, open(b, 'rb') as fb:
            assert fa.read() == fb.read(), fn
    # the port writes its own assets, beside its own package
    assert os.path.samefile(trobot_data.data_dir,
                            os.path.dirname(trobot_data.__file__))


@pytest.mark.parametrize('name', GENERATED + [f'vendored/{v}'
                                              for v in VENDORED])
def test_chain_spec_matches(name):
    jname, jjoints, _, jroot = jurdf.parse_urdf(_path(name))
    tname, tjoints, _, troot = turdf.parse_urdf(_path(name))
    assert (tname, troot) == (jname, jroot)
    js = jkin.chain_from_joint_list(jjoints, root_name=jroot)
    ts = tkin.chain_from_joint_list(tjoints, root_name=troot)
    assert ts.link_names == js.link_names
    assert ts.joint_names == js.joint_names
    for f in ('parent', 'jtype', 'axis', 'fixed_rot', 'fixed_trans',
              'dof_idx', 'mimic_mult', 'mimic_offset', 'joint_limits'):
        a, b = getattr(ts, f), getattr(js, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ts.n_dofs == js.n_dofs
    assert ts.unique_position_link_names == js.unique_position_link_names


def _joint(name, parent, child, jtype='revolute', mimic=None):
    return dict(name=name, parent=parent, child=child, type=jtype,
                axis=[0, 0, 1], origin_rot=np.eye(3),
                origin_trans=np.zeros(3), limits=(-1.0, 1.0), mimic=mimic)


@pytest.mark.parametrize('joints,match', [
    ([_joint('a', 'base', 'l1', mimic=('b', 1.0, 0.0)),
      _joint('b', 'l1', 'l2', mimic=('a', 1.0, 0.0))], 'mimic cycle'),
    ([_joint('a', 'base', 'l1', mimic=('nope', 1.0, 0.0))],
     'mimics unknown joint'),
    ([_joint('a', 'base', 'l1', jtype='floating')], 'unsupported'),
])
def test_chain_errors_match(joints, match):
    for mod in (jkin, tkin):
        with pytest.raises(ValueError, match=match):
            mod.chain_from_joint_list([dict(j) for j in joints])


@pytest.mark.parametrize('name', FK_ROBOTS)
def test_fk_and_sphere_model_match(name):
    base = _BASE if name == 'lift_rig.urdf' else None
    jr, tr = _robots(name, base=base)
    q = _q(tr, 24, seed=0)
    rot, tr_ = tr.fk_poses(torch.from_numpy(q))
    jrot, jtr = jr.fk_poses(jnp.asarray(q))
    np.testing.assert_allclose(rot.numpy(), np.asarray(jrot), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tr_.numpy(), np.asarray(jtr), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tr.fkine(torch.from_numpy(q)).numpy(),
                               np.asarray(jr.fkine(jnp.asarray(q))),
                               rtol=1e-5, atol=1e-6)
    # the sphere model is the same arrays, and so are its world centers
    np.testing.assert_array_equal(tr.link_sphere_centers.numpy(),
                                  np.asarray(jr.link_sphere_centers))
    np.testing.assert_array_equal(tr.link_sphere_radii.numpy(),
                                  np.asarray(jr.link_sphere_radii))
    np.testing.assert_array_equal(tr.sphere_link_idx.numpy(),
                                  np.asarray(jr.sphere_link_idx))
    np.testing.assert_allclose(
        tr.sphere_centers_world(torch.from_numpy(q)).numpy(),
        np.asarray(jr.sphere_centers_world(jnp.asarray(q))), rtol=1e-5,
        atol=1e-6)
    # the kernel's statics equal the reference kernel's
    assert tuple(tfk.robot_chain_statics(tr)) == tuple(
        jfk.robot_chain_statics(jr))
    # the dict API: one pose per link (per collision piece on request)
    out = tr.compute_forward_kinematics_all_links(torch.from_numpy(q[:3]),
                                                  return_collision=True)
    ref = jr.compute_forward_kinematics_all_links(jnp.asarray(q[:3]),
                                                  return_collision=True)
    assert list(out) == list(ref)
    assert [len(v) for v in out.values()] == [len(v) for v in ref.values()]


def test_keep_joints_matches():
    """Joints not kept freeze at q = 0 (mimics of a frozen joint with
    them); unknown names raise in both packages."""
    keep = ['finger0_joint0', 'finger0_joint1', 'finger2_joint2']
    jr, tr = _robots('trifinger_simple.urdf', keep_joints=keep)
    assert tr.dof == jr.dof == 3
    q = _q(tr, 8, seed=11)
    np.testing.assert_allclose(tr.fkine(torch.from_numpy(q)).numpy(),
                               np.asarray(jr.fkine(jnp.asarray(q))),
                               rtol=1e-5, atol=1e-6)
    jr, tr = _robots('lift_rig.urdf', keep_joints=['elbow'])
    np.testing.assert_array_equal(tr.spec.jtype, jr.spec.jtype)
    assert tr.dof == 1
    for mod in (jurdf, turdf):
        with pytest.raises(ValueError, match='keep_joints'):
            kw = {} if mod is jurdf else {'device': 'cpu'}
            mod.URDFRobot(_path('lift_rig.urdf'), keep_joints=['nope'], **kw)


def test_selected_positions_and_collision_pieces_match():
    """The matrix-form helpers over a chain whose links carry collision
    origins (parse_urdf leaves them empty), with a base transform."""
    path = _path('trifinger_simple.urdf')
    _, joints, _, root = turdf.parse_urdf(path)
    rng = np.random.default_rng(9)
    for j in joints[::2]:
        o = np.eye(4)
        o[:3, 3] = rng.normal(size=3)
        j['collision_origins'] = [o, np.eye(4)]
    js = jkin.chain_from_joint_list([dict(j) for j in joints], root)
    ts = tkin.chain_from_joint_list([dict(j) for j in joints], root)
    q = _q(ts, 5, seed=10)
    sel = [1, 4, 7]
    br, bt = _BASE[:3, :3], _BASE[:3, 3]
    out = tkin.fk_selected_positions(ts, torch.from_numpy(q), sel, br, bt)
    ref = jax.vmap(lambda qq: jkin.fk_selected_positions(
        js, qq, sel, jnp.asarray(br, jnp.float32),
        jnp.asarray(bt, jnp.float32)))(jnp.asarray(q))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    rot, tr = tkin.fk_collision_pieces(ts, torch.from_numpy(q))
    jrot, jtr = jax.vmap(lambda qq: jkin.fk_collision_pieces(js, qq))(
        jnp.asarray(q))
    assert rot.shape == jrot.shape == (5, 12, 3, 3)
    np.testing.assert_allclose(rot.numpy(), np.asarray(jrot), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jtr), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize('name', FK_ROBOTS[:3])
def test_chain_fk_vjp_jvp_match_jax(name):
    jr, tr = _robots(name)
    q = _q(tr, 16, seed=1)
    g_ref = np.asarray(jax.grad(lambda qq: _loss_j(jr.fkine(qq)))(
        jnp.asarray(q)))
    qt = torch.from_numpy(q).requires_grad_(True)
    g, = torch.autograd.grad(_loss_t(tr.fkine(qt)), qt)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-5, atol=1e-5)
    v = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    _, t_ref = jax.jvp(jr.fkine, (jnp.asarray(q),), (jnp.asarray(v),))
    import torch.autograd.forward_ad as fwAD
    with fwAD.dual_level():
        qd = fwAD.make_dual(torch.from_numpy(q), torch.from_numpy(v))
        tangent = fwAD.unpack_dual(tr.fkine(qd)).tangent
    np.testing.assert_allclose(tangent.numpy(), np.asarray(t_ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('name', ['trifinger_simple.urdf', 'lift_rig.urdf'])
def test_chain_fk_gradcheck_float64(name):
    _, tr = _robots(name, base=_BASE)
    q = torch.from_numpy(_q(tr, 2, seed=4).astype(np.float64))
    q.requires_grad_(True)
    # analytic VJP and JVP against finite differences, and the VJP is
    # itself differentiable (twice-differentiable FK)
    assert torch.autograd.gradcheck(tr._fkine_sel, (q,),
                                    check_forward_ad=True)
    assert torch.autograd.gradgradcheck(tr._fkine_sel, (q,))


@pytest.fixture(scope='module')
def acm_robots():
    """FrankaPanda in both packages with the ACM computed from the same
    numpy configurations (each package draws its own otherwise)."""
    kw = dict(setup_acm=False, link_spheres=3)
    # the JAX robot reads the port's generated file (byte-identical to its
    # own), which is written atomically for parallel test workers
    jr = jurdf.URDFRobot(_path('panda_simple.urdf'), name='panda', **kw)
    tr = tdc.FrankaPanda(load_gripper=True, device='cpu', **kw)
    assert jr.urdf_path.endswith('panda_simple.urdf')
    assert tr.urdf_path.endswith('panda_simple.urdf')
    q = _q(tr, 100, seed=5)
    jr.rand_configs = lambda n, key=None: jnp.asarray(q[:n])
    tr.rand_configs = lambda n, *a, **k: torch.from_numpy(q[:n])
    jr._setup_acm(100)
    tr._setup_acm(100)
    return jr, tr


def test_acm_pairs_match(acm_robots):
    jr, tr = acm_robots
    np.testing.assert_array_equal(tr._self_pair_i.numpy(),
                                  np.asarray(jr._self_pair_i))
    np.testing.assert_array_equal(tr._self_pair_j.numpy(),
                                  np.asarray(jr._self_pair_j))
    assert tr._allowed_internal == jr._allowed_internal
    assert tr._self_pair_i.shape[0] > 0


def test_ground_truth_matches(acm_robots):
    jr, tr = acm_robots
    jenv, tenv = jdc.ShapeEnv(shapes=SHAPES), tdc.ShapeEnv(SHAPES)
    q = _q(tr, 512, seed=6)
    env_sd, self_sd = tr.collision_signed_dist(torch.from_numpy(q), tenv)
    jenv_sd, jself_sd = jr.collision_signed_dist(jnp.asarray(q), jenv)
    np.testing.assert_allclose(env_sd.numpy(), np.asarray(jenv_sd),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(self_sd.numpy(), np.asarray(jself_sd),
                               rtol=1e-5, atol=1e-6)
    labels = tr.collision(torch.from_numpy(q), tenv).numpy()
    ref = np.asarray(jr.collision(jnp.asarray(q), jenv))
    sd = np.maximum(np.asarray(jenv_sd).max(-1), np.asarray(jself_sd))
    away = np.abs(sd) >= 1e-6
    np.testing.assert_array_equal(labels[away], ref[away])
    assert 0 < labels.sum() < len(labels)
    np.testing.assert_array_equal(
        tr.self_collision(torch.from_numpy(q)).numpy(),
        np.asarray(jr.self_collision(jnp.asarray(q))))


def test_wrap_and_rand_configs():
    jr, tr = _robots('lift_rig.urdf')
    q = np.random.default_rng(7).uniform(-9, 9, size=(20, 3)).astype(
        np.float32)
    np.testing.assert_allclose(tr.wrap(torch.from_numpy(q)).numpy(),
                               np.asarray(jr.wrap(jnp.asarray(q))),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(tr._revolute_dof_mask.numpy(),
                                  np.asarray(jr._revolute_dof_mask))
    qs = tr.rand_configs(500, torch.Generator().manual_seed(0))
    assert qs.shape == (500, 3) and qs.device.type == 'cpu'
    lims = tr.joint_limits
    assert bool(((qs >= lims[:, 0]) & (qs <= lims[:, 1])).all())
