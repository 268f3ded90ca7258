"""The planar slice as a whole against the JAX package on the same numpy
inputs: trajopt on planar arms (the point dimension of their control
points, 2), dataset and checkpoint files read across packages both ways,
a JAX-fitted 2-DOF q-space DiffCo carried across (poly_score 1e-4, its
gradient 1e-3, on a 64 x 64 grid), a 7-DOF proxy over the arm's joint
positions through the port's router (score 1e-4, dq 1e-3), and the
routines' helpers (test_checker to 1e-6)."""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import diffco_tpu as jdc
from diffco_tpu import kernels as jkernels
from diffco_tpu import optim as joptim
from diffco_tpu import routines as jroutines
from diffco_tpu.geometry import geometry2d as jg
from diffco_tpu.robots import RevolutePlanarRobot as JPlanar
import diffco_tpu_torch as tdc
from diffco_tpu_torch import optim as toptim
from diffco_tpu_torch import routines as troutines
from diffco_tpu_torch.convert import load_reference_state
from diffco_tpu_torch.envs.presets2d import get_env
from diffco_tpu_torch.geometry import geometry2d as tg
from diffco_tpu_torch.ops import fk_score

torch.set_num_threads(1)

SCENE = [('circle', (1.5, 1.0), 0.6), ('rect', (-1.0, 1.5), (1.0, 0.8))]
STATE_FIELDS = ('support_points', 'support_transformed', 'gains',
                'hypothesis', 'y', 'kernel_matrix', 'rbf_nodes',
                'valid_mask', 'distance')


def _pair(robot, obs, seed):
    """Two collision-free configurations (numpy, JAX ground truth)."""
    q = np.random.RandomState(seed).uniform(
        -np.pi, np.pi, (64, robot.dof)).astype(np.float32)
    free = q[~np.asarray(jg.planar_robot_collision(robot, obs, q))]
    return free[0], free[-1]


@pytest.mark.parametrize('dof', [2, 3])
def test_adam_keeps_the_planar_point_dimension(dof):
    """Adam on a planar arm (control points [N, dof, 2]) in both packages
    from the same jittered line, with a max_speed that the joints' moves
    exceed, so that the max_move term (the squared move of each point,
    summed over its 2 coordinates) is active: the penalty terms on that
    path at 1e-5, the solution 1e-3, the cost 1e-3. Grouping the points
    by 3 coordinates raised at dof 2 and gave another max_move at dof
    3."""
    jr, tr = JPlanar(1.5, 0.3, dof=dof), tdc.RevolutePlanarRobot(1.5, 0.3,
                                                                  dof=dof)
    jo = jg.Obstacles2D.from_obstacle_list(SCENE)
    to = tg.Obstacles2D.from_obstacle_list(SCENE)
    start, target = _pair(jr, jo, dof)
    init = (np.linspace(start, target, 12) + np.random.default_rng(dof)
            .normal(scale=0.05, size=(12, dof))).astype(np.float32)
    opts = {'N_WAYPOINTS': 12, 'NUM_RE_TRIALS': 1, 'MAXITER': 30,
            'safety_margin': -0.05, 'max_speed': 0.15, 'seed': 0,
            'dense_sub': 3, 'init_solution': init}
    # the penalty terms themselves on the jittered path: diff, collision,
    # max_move, joint limits
    lims = np.asarray(jr.limits)
    jterms = joptim._loss_terms(
        jnp.asarray(init), jr.fkine,
        lambda p: jg.planar_robot_signed_dist(jr, jo, p).max(-1),
        jnp.asarray(lims), -0.05, 0.15)
    tterms = toptim._loss_terms(
        torch.from_numpy(init)[None], tr.fkine,
        lambda p: tg.planar_robot_signed_dist(
            tr, to, p.reshape(-1, dof)).amax(-1).reshape(1, -1),
        torch.from_numpy(lims), -0.05, 0.15)
    for t, j in zip(tterms, jterms):
        np.testing.assert_allclose(t.numpy(), [float(j)], rtol=1e-5,
                                   atol=1e-6)
    assert float(jterms[2]) > 0.1                # max_move is active
    ref = joptim.adam_traj_optimize(
        jr, lambda p: jg.planar_robot_signed_dist(jr, jo, p).max(-1),
        start, target, opts)
    out = toptim.adam_traj_optimize(
        tr, lambda p: tg.planar_robot_signed_dist(tr, to, p).amax(-1),
        torch.from_numpy(start), torch.from_numpy(target), opts)
    np.testing.assert_allclose(np.asarray(out['solution']),
                               np.asarray(ref['solution']), atol=1e-3)
    np.testing.assert_allclose(out['cost'], ref['cost'], rtol=1e-3)
    assert out['success'] == ref['success']
    assert out['cnt_check'] == ref['cnt_check']


@pytest.mark.parametrize('label_type', ['binary', 'instance', 'class'])
def test_dataset_files_cross_load(tmp_path, label_type):
    """A dataset the JAX package saves loads in the port and the other way
    round (arrays and meta fields equal), and the port's labels are the
    JAX ground truth's on the port's configurations (1e-5)."""
    obstacles = get_env('2class_1')
    kw = dict(dof=2, link_length=3.5, link_width=0.3, obstacles=obstacles,
              label_type=label_type, env_id='2class_1', seed=3)
    name = f'2d_2dof_2class_1_{label_type}.npz'
    jd = jroutines.autogenerate_2d_dataset(300, save_dir=str(tmp_path / 'j'),
                                           **kw)
    td = troutines.load_dataset(str(tmp_path / 'j' / name))
    assert set(td) == set(jd)
    for k, v in jd.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(td[k], v)
        else:
            assert td[k] == v, k
    cfgs, labels, dists, obs, robot = troutines.unpack_dataset(
        str(tmp_path / 'j' / name), device='cpu')
    np.testing.assert_array_equal(cfgs.numpy(), jd['data'])
    np.testing.assert_array_equal(labels.numpy(), jd['label'])
    assert obs == obstacles and isinstance(robot, tdc.RevolutePlanarRobot)
    assert robot.dof == 2 and robot.link_width == 0.3

    td2 = troutines.autogenerate_2d_dataset(
        300, save_dir=str(tmp_path / 't'), device='cpu', **kw)
    jd2 = jroutines.load_dataset(str(tmp_path / 't' / name))
    assert set(jd2) == set(td2)
    for k, v in td2.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(jd2[k], v)
        else:
            assert jd2[k] == v, k
    jcfgs, jlabels, _, _, jrobot = jroutines.unpack_dataset(
        str(tmp_path / 't' / name))
    assert jrobot.dof == 2
    np.testing.assert_array_equal(np.asarray(jlabels), td2['label'])
    jo = jg.Obstacles2D.from_obstacle_list(obstacles)
    sd = np.asarray(jg.planar_robot_signed_dist(JPlanar(3.5, 0.3, dof=2), jo,
                                                td2['data']))
    if label_type == 'binary':
        ref = sd.max(-1, keepdims=True)
    elif label_type == 'instance':
        ref = sd
    else:
        cls = jo.obstacle_classes
        ref = np.stack([np.where(cls == c, sd, -np.inf).max(-1)
                        for c in range(jo.num_class)], -1)
    np.testing.assert_allclose(td2['dist'], ref, rtol=0, atol=1e-5)
    sure = np.abs(ref) > 1e-5
    np.testing.assert_array_equal(td2['label'][sure],
                                  ((ref > 0) * 2.0 - 1.0)[sure])


def _train_data(n, dof, length, env, seed):
    jr = JPlanar(length, 0.3, dof=dof)
    jo = jg.Obstacles2D.from_obstacle_list(get_env(env))
    q = np.random.RandomState(seed).uniform(
        -np.pi, np.pi, (n, dof)).astype(np.float32)
    dist = np.asarray(jg.planar_robot_signed_dist(jr, jo, q)).max(-1)
    return jr, q, ((dist > 0) * 2.0 - 1.0).astype(np.float32), dist


def _grids():
    """The 64 x 64 unified grid of both packages (equal at 1e-6)."""
    jgrid = np.asarray(jroutines.generate_unified_grid(64, 64))
    tgrid = troutines.generate_unified_grid(64, 64, device='cpu')
    np.testing.assert_allclose(tgrid.numpy(), jgrid, rtol=0, atol=1e-6)
    return jgrid, tgrid


@pytest.fixture(scope='module')
def jax_2dof():
    """A q-space DiffCo fitted by the JAX package on 400 labels of the
    escape scene (1rect_1circle, 2 DOF, links 3.5)."""
    _, q, labels, _ = _train_data(400, 2, 3.5, '1rect_1circle', seed=0)
    jp = jdc.DiffCo(kernel_func=jkernels.RQKernel(10.0))
    jp.train(jnp.asarray(q), jnp.asarray(labels), max_iteration=3 * 400)
    jp.fit_poly(jkernels.Polyharmonic(1, 1), target='label')
    return jp


def _arrays(jp):
    out = {k: np.asarray(getattr(jp, k)) for k in STATE_FIELDS
           if getattr(jp, k, None) is not None}
    out.update(num_valid=jp.num_valid, rbf_kernel='Polyharmonic', k=1,
               epsilon=1.0)
    return out


def _check_on_grid(jp, tp):
    """poly_score and its gradient on the 64 x 64 grid, both packages
    evaluating the same float32 state in float64: 1e-4 / 1e-3. (In
    float32 the two packages' expanded-square routes sum this proxy's
    cancelling terms in other orders and differ by more than 1e-4.)"""
    jgrid, tgrid = _grids()
    floats = [k for k in STATE_FIELDS if k != 'valid_mask'
              and getattr(jp, k, None) is not None]
    with jax.enable_x64(True):
        j64 = copy.copy(jp)
        for k in floats:
            setattr(j64, k, jnp.asarray(np.asarray(getattr(jp, k)),
                                        jnp.float64))
        x = jnp.asarray(jgrid, jnp.float64)
        js = np.asarray(j64.poly_score(x))
        jdx = np.asarray(jax.grad(lambda x: j64.poly_score(x).sum())(x))
    t64 = copy.copy(tp)
    for k in floats:
        setattr(t64, k, getattr(tp, k).double())
    x = tgrid.double().requires_grad_(True)
    ts = t64.poly_score(x)
    tdx, = torch.autograd.grad(ts.sum(), x)
    assert ts.dtype == torch.float64 and js.dtype == np.float64
    np.testing.assert_allclose(ts.detach().numpy(), js, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tdx.numpy(), jdx, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize('via', ['checkpoint', 'load_reference_state'])
def test_jax_2dof_state_on_the_port(tmp_path, via, jax_2dof):
    """A 2-DOF q-space DiffCo fitted by the JAX package, carried into the
    port by the JAX package's checkpoint file or load_reference_state:
    poly_score 1e-4 and its gradient 1e-3 on a 64 x 64 grid."""
    jp = jax_2dof
    tp = tdc.DiffCo(kernel_func=tdc.kernels.RQKernel(10.0))
    if via == 'checkpoint':
        path = str(tmp_path / 'jax.npz')
        jroutines.save_pretrained_checker(jp, path)
        tp.rbf_kernel = tdc.kernels.Polyharmonic(1, 1)
        troutines.load_pretrained_checker(tp, path, device='cpu')
        assert tp.valid_mask.dtype == torch.bool
    else:
        load_reference_state(tp, _arrays(jp), device='cpu')
    assert tp.num_valid == jp.num_valid
    _check_on_grid(jp, tp)


def test_port_checkpoint_on_the_jax_package(tmp_path):
    """The port's checkpoint of a proxy it fitted loads in the JAX
    package, which then scores as the port does (1e-4 / 1e-3); an
    untrained proxy saves without its missing arrays, and loads as
    such."""
    tp = tdc.DiffCo(kernel_func=tdc.kernels.RQKernel(10.0))
    path = str(tmp_path / 'untrained.npz')
    troutines.save_pretrained_checker(tp, path)
    assert np.load(path).files == ['num_valid']
    jp = jdc.DiffCo(kernel_func=jkernels.RQKernel(10.0))
    jroutines.load_pretrained_checker(jp, path)
    assert jp.rbf_nodes is None and jp.num_valid == 0
    _, q, labels, _ = _train_data(400, 2, 3.5, '1rect_1circle', seed=0)
    troutines.train_checker(tp, torch.from_numpy(q), torch.from_numpy(labels))
    troutines.fit_checker(tp)
    path = str(tmp_path / 'port.npz')
    troutines.save_pretrained_checker(tp, path)
    jp = jdc.DiffCo(kernel_func=jkernels.RQKernel(10.0))
    jp.rbf_kernel = jkernels.Polyharmonic(1, 1)
    jroutines.load_pretrained_checker(jp, path)
    assert jp.num_valid == tp.num_valid
    np.testing.assert_array_equal(np.asarray(jp.valid_mask),
                                  tp.valid_mask.numpy())
    _check_on_grid(jp, tp)
    fn = troutines.get_estimator(tp, 'poly')
    torch.testing.assert_close(fn(torch.from_numpy(q[:8])),
                               tp.poly_score(torch.from_numpy(q[:8])))
    with pytest.raises(ValueError):
        troutines.get_estimator(tp, 'nope')


def test_fk_feature_proxy_through_the_router():
    """A 7-DOF DiffCo over the arm's joint positions (transform =
    robot.fkine, F = 14, 7d_narrow) fitted by the JAX package on 300
    samples and carried across: the port's router finds the robot, takes
    its FK fallback (a planar arm is neither DH nor URDF) and scores at
    1e-4 with dq at 1e-3. The port's own fit of the same data keeps the
    same number of supports."""
    jr, q, labels, dist = _train_data(300, 7, 1.0, '7d_narrow', seed=1)
    tr = tdc.RevolutePlanarRobot(1.0, 0.3, dof=7)
    jp = jdc.DiffCo(kernel_func=jkernels.RQKernel(0.1), transform=jr.fkine)
    jp.train(jnp.asarray(q), jnp.asarray(labels), max_iteration=900,
             distance=jnp.asarray(dist))
    jp.fit_poly(jkernels.Polyharmonic(1, 1), target='dist')
    tp = tdc.DiffCo(kernel_func=tdc.kernels.RQKernel(0.1),
                    transform=tr.fkine)
    load_reference_state(tp, _arrays(jp), device='cpu')
    assert tp._fk_robot() is tr and tp.support_transformed.shape[1] == 14
    qq = np.random.RandomState(2).uniform(-np.pi, np.pi,
                                          (512, 7)).astype(np.float32)
    qt = torch.from_numpy(qq)
    assert not fk_score.dh_score_grad_available(tr, qt)
    assert not fk_score.chain_score_grad_available(tr, qt)
    js = np.asarray(jp.poly_score(jnp.asarray(qq)))
    jdq = np.asarray(jax.grad(lambda x: jp.poly_score(x).sum())(
        jnp.asarray(qq)))
    x = qt.clone().requires_grad_(True)
    ts = tp.poly_score(x)
    tdq, = torch.autograd.grad(ts.sum(), x)
    np.testing.assert_allclose(ts.detach().numpy(), js, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tdq.numpy(), jdq, rtol=1e-3, atol=1e-3)
    own = tdc.DiffCo(kernel_func=tdc.kernels.RQKernel(0.1),
                     transform=tr.fkine)
    own.train(qt.new_tensor(q), torch.from_numpy(labels), max_iteration=900,
              distance=torch.from_numpy(dist.astype(np.float32)))
    assert own.num_valid == jp.num_valid


def test_routines_helpers_match_reference(tmp_path):
    """test_checker (acc, TPR, TNR with the reference's margin sign) at
    1e-6, train_test_split's masks, save_ompl_path's text."""
    rng = np.random.RandomState(4)
    cfgs = rng.uniform(-1, 1, (500, 2)).astype(np.float32)
    labels = np.where(rng.uniform(size=500) < 0.3, 1.0, -1.0).astype(
        np.float32)
    w = np.asarray([1.5, -0.7], np.float32)

    def jscore(x):
        return jnp.asarray(np.asarray(x) @ w)[:, None]

    def tscore(x):
        return torch.from_numpy(x.numpy() @ w)[:, None]

    for margin, num in ((0.0, None), (-0.3, None), (0.2, 400)):
        ref = jroutines.test_checker(None, jscore, jnp.asarray(cfgs),
                                     jnp.asarray(labels), num_test=num,
                                     safety_margin=margin, verbose=False)
        out = troutines.test_checker(None, tscore, torch.from_numpy(cfgs),
                                     torch.from_numpy(labels), num_test=num,
                                     safety_margin=margin, verbose=False)
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    jtr, jte = jroutines.train_test_split(100, 70, seed=5)
    ttr, tte = troutines.train_test_split(100, 70, seed=5)
    np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
    np.testing.assert_array_equal(tte.numpy(), np.asarray(jte))
    path = cfgs[:5]
    jroutines.save_ompl_path(str(tmp_path / 'j.txt'), path, times=[0, 1, 2,
                                                                   3, 4])
    troutines.save_ompl_path(str(tmp_path / 't.txt'), torch.from_numpy(path),
                             times=[0, 1, 2, 3, 4])
    assert (tmp_path / 't.txt').read_text() == (tmp_path /
                                                 'j.txt').read_text()


def test_planar_entry_points_default_to_cuda(tmp_path):
    """No device and no card: the planar entry points raise instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    arm = tdc.RevolutePlanarRobot(1.0, 0.3, dof=2)
    path = str(tmp_path / 'ck.npz')
    troutines.save_pretrained_checker(tdc.DiffCo(), path)
    for call in (
            lambda: troutines.autogenerate_2d_dataset(8),
            lambda: troutines.generate_unified_grid(4, 4),
            lambda: troutines.unpack_dataset(
                troutines.autogenerate_2d_dataset(8, device='cpu')),
            lambda: troutines.load_pretrained_checker(tdc.DiffCo(), path),
            lambda: tdc.MotionPlanner(arm, lambda q: q[:, 0] > 9),
            lambda: tdc.RRTStar(arm, lambda q: q[:, 0] > 9),
            lambda: arm.rand_configs(4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
