"""The port's multi-device scale-out (``diffco_tpu_torch.parallel`` and
every ``mesh=``) on gloo process groups on the CPU, for every case of
tests/test_parallel.py.

Two groups run: four ranks on a 2 x 2 (dp, tp) mesh and three on a 3 x 1
one (sizes that do not divide it). The groups are spawned once, together
(a module-scoped fixture, each a ``FileStore`` under the test's temporary
directory), and each runs every case; each rank saves its results, and the
parametrised tests read them: every rank must hold the same global result
(the SPMD contract), equal to the port's unsharded run at the JAX
package's tolerances (1e-4 gains and hypothesis, 1e-3 nodes and scores,
rtol 1e-3 / atol 1e-4 for trajectories, equal iteration and support
counts), which in turn is held against the JAX package on the same numpy
inputs. The file's top-level imports are torch-only and the JAX package is
imported inside the tests, so the spawned ranks never load JAX.
"""
import datetime
import os
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

torch.set_num_threads(1)

LAYOUTS = {'2x2': (2, 2), '3x1': (3, 1)}
JOIN_TIMEOUT = 300


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(out, ref, tol, rtol=None):
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol,
                               rtol=tol if rtol is None else rtol)


# ---- the cases' inputs (numpy, seeded) and worlds, shared by ranks and
# the parent

def _rng(seed):
    return np.random.default_rng(seed)


def _planar(circle_only=True):
    import diffco_tpu_torch as tdc
    robot = tdc.RevolutePlanarRobot(1.0, link_width=0.2, dof=2)
    obs = [('circle', (1.5, 1.0), 0.6)]
    if not circle_only:
        obs.append(('rect', (-1.2, -1.0), (1.0, 1.0)))
    return robot, tdc.Obstacles2D.from_obstacle_list(obs)


def _planar_q(n, seed):
    return _rng(seed).uniform(-np.pi, np.pi, (n, 2)).astype(np.float32)


def _blobs(n, seed, f=4):
    return _rng(seed).normal(size=(n, f)).astype(np.float32)


def _support_inputs(S, seed, n_valid):
    r = _rng(seed)
    return (r.normal(size=(S, 6)).astype(np.float32),
            r.normal(size=S).astype(np.float32),
            np.arange(S) < n_valid, r.normal(size=(32, 6)).astype(np.float32))


def _traj_world():
    r = _rng(8)
    return (r.normal(size=(64, 4)).astype(np.float32),
            (r.normal(size=64) * 0.01).astype(np.float32),
            np.asarray([-1.0, 0.5], np.float32),
            np.asarray([1.0, -0.5], np.float32))


def _t_poly_score(pts, sup, w):
    """||pts - sup|| @ w (the expanded square), differentiable."""
    d2 = (torch.sum(pts * pts, 1, keepdim=True)
          + torch.sum(sup * sup, 1)[None] - 2.0 * pts @ sup.T)
    return torch.sqrt(torch.clamp(d2, min=0.0) + 1e-12) @ w


def _trials(dp):
    """The smallest multiple of dp that is >= 8 restarts."""
    return dp * -(-8 // dp)


def _shape_env_box():
    return {'box1': {'type': 'Box', 'params': {'extents': [0.5, 0.5, 0.5]},
                     'transform': np.eye(4)}}


# ---- the cases, run on every rank of a group: case(mesh) -> {name: array}

def _case_score_sweep(mesh):
    from diffco_tpu_torch.geometry.geometry2d import planar_robot_signed_dist
    from diffco_tpu_torch.parallel import sharded_score_sweep
    robot, obs = _planar()
    q = torch.from_numpy(_planar_q(1000, 0))
    return {'out': sharded_score_sweep(
        lambda qq: planar_robot_signed_dist(robot, obs, qq).amax(-1), q,
        mesh)}


def _case_support_score(mesh):
    from diffco_tpu_torch.parallel import support_parallel_score_fn
    sup, w, valid, x = (torch.from_numpy(a) for a in
                        _support_inputs(100, 1, 77))
    fn = support_parallel_score_fn(sup, w, valid, mesh)
    xg = x.clone().requires_grad_(True)
    out = fn(xg)
    dx, = torch.autograd.grad(out.sum(), xg)
    return {'out': out, 'dx': dx}


def _case_support_kernels(mesh):
    from diffco_tpu_torch import kernels
    from diffco_tpu_torch.parallel import support_parallel_score_fn
    sup, w, valid, x = (torch.from_numpy(a) for a in
                        _support_inputs(90, 2, 71))
    return {type(k).__name__: support_parallel_score_fn(
        sup, w, valid, mesh, kernel_func=k)(x)
        for k in (kernels.RQKernel(5.0), kernels.MultiQuadratic(1.0))}


def _case_gram(mesh):
    from diffco_tpu_torch import kernels
    from diffco_tpu_torch.parallel import sharded_gram
    return {'K': sharded_gram(kernels.RQKernel(5.0),
                              torch.from_numpy(_blobs(50, 3)), mesh)}


def _fit_out(gains, hyp, nodes, it):
    return {'gains': gains, 'hyp': hyp, 'nodes': nodes, 'it': int(it)}


def _case_fit(mesh):
    from diffco_tpu_torch import kernels
    from diffco_tpu_torch.parallel import distributed_fit
    X = torch.from_numpy(_blobs(64, 4))
    return _fit_out(*distributed_fit(kernels.RQKernel(5.0), X,
                                     torch.sign(X[:, 0]), mesh,
                                     max_iteration=500))


def _case_fit_padding(mesh):
    from diffco_tpu_torch import kernels
    from diffco_tpu_torch.parallel import distributed_fit
    X = torch.from_numpy(_blobs(61, 5))
    return _fit_out(*distributed_fit(kernels.RQKernel(5.0), X,
                                     torch.sign(X[:, 0]), mesh,
                                     max_iteration=500))


def _warm_data():
    X = np.concatenate([_blobs(64, 6), _blobs(32, 7)])
    return X, np.sign(X[:, 0])


def _case_fit_warm(mesh):
    from diffco_tpu_torch import kernels
    from diffco_tpu_torch.parallel import distributed_fit
    kern = kernels.RQKernel(5.0)
    X2, y2 = (torch.from_numpy(a) for a in _warm_data())
    gains = distributed_fit(kern, X2[:64], y2[:64], mesh,
                            max_iteration=500)[0]
    prev = torch.cat([gains, gains.new_zeros(32)])
    g, h, _, it_warm = distributed_fit(kern, X2, y2, mesh,
                                       max_iteration=500, init_gains=prev)
    it_cold = distributed_fit(kern, X2, y2, mesh, max_iteration=500)[3]
    return {'prev': prev, 'gains': g, 'hyp': h, 'it_warm': int(it_warm),
            'it_cold': int(it_cold)}


def _traj_hist(score, robot, start, target, T, trials=None):
    """Every restart's path at each of 10 steps of the Adam core (an init
    path in the second restart), [T, 10, 10, 2]: with ``trials`` each
    rank runs its block of restarts and the blocks are gathered."""
    from diffco_tpu_torch import optim
    init = torch.linspace(0, 1, 10)[:, None] * (target - start) + start
    init = init + 0.05 * torch.sin(torch.arange(20.0)).reshape(10, 2)
    hist = optim._adam_traj_core(
        start, target, robot.limits, init, torch.Generator().manual_seed(4),
        robot.fkine, score, 10, T, 10, 0.5, 0.0, 1.5, history=True,
        trials=trials)[4]
    return hist


def _case_trajopt(mesh):
    from diffco_tpu_torch.parallel import distributed_trajopt, sharding
    robot, _ = _planar()
    sup, w, start, target = (torch.from_numpy(a) for a in _traj_world())

    def score(p):
        return _t_poly_score(robot.fkine(p).reshape(p.shape[0], -1), sup, w)
    T = _trials(mesh.shape[0])
    sol, cost, success = distributed_trajopt(
        robot.fkine, score, start, target, robot.limits, mesh,
        n_waypoints=10, num_trials=T, maxiter=30, seed=0)
    with sharding.rank_local():
        hist = _traj_hist(score, robot, start, target, T,
                          sharding.row_shard(mesh, T))
    return {'sol': sol, 'cost': float(cost), 'success': bool(success),
            'hist': hist}


def _case_e2e(mesh):
    from diffco_tpu_torch import kernels
    from diffco_tpu_torch.geometry.geometry2d import planar_robot_signed_dist
    from diffco_tpu_torch.parallel import (distributed_fit,
                                           distributed_trajopt,
                                           sharded_score_sweep)
    robot, obs = _planar()
    q = torch.from_numpy(_planar_q(256, 9))
    labels = (sharded_score_sweep(
        lambda qq: planar_robot_signed_dist(robot, obs, qq).amax(-1), q,
        mesh) > 0).float() * 2 - 1
    kern = kernels.RQKernel(10.0)
    gains, hyp, nodes, _ = distributed_fit(kern, q, labels, mesh,
                                           max_iteration=1000)
    sol, cost, _ = distributed_trajopt(
        robot.fkine, lambda p: (kern(p, q) @ nodes).reshape(-1),
        torch.tensor([-2.0, 0.0]), torch.tensor([2.0, 0.0]), robot.limits,
        mesh, n_waypoints=10, num_trials=_trials(mesh.shape[0]),
        maxiter=100)
    return {'labels': labels, 'gains': gains, 'hyp': hyp, 'sol': sol,
            'cost': float(cost)}


def _case_fit_lazy(mesh):
    from diffco_tpu_torch import kernels
    from diffco_tpu_torch.parallel import distributed_fit_lazy
    X = torch.from_numpy(_blobs(64, 4))
    g, h, it = distributed_fit_lazy(kernels.RQKernel(5.0), X,
                                    torch.sign(X[:, 0]), mesh,
                                    max_iteration=500)
    return {'gains': g, 'hyp': h, 'it': int(it)}


def _case_fit_lazy_warm(mesh):
    from diffco_tpu_torch import kernels
    from diffco_tpu_torch.parallel import distributed_fit_lazy
    kern = kernels.RQKernel(5.0)
    X = torch.from_numpy(_blobs(61, 5))
    y = torch.sign(X[:, 0])
    g, h, it = distributed_fit_lazy(kern, X, y, mesh, max_iteration=500)
    g2, h2, it2 = distributed_fit_lazy(kern, X, y, mesh, max_iteration=500,
                                       init_gains=g)
    return {'gains': g, 'hyp': h, 'it': int(it), 'gains2': g2, 'hyp2': h2,
            'it2': int(it2)}


def _planar_gt():
    from diffco_tpu_torch.geometry.geometry2d import planar_robot_collision
    robot, obs = _planar(circle_only=False)
    return robot, (lambda qq: planar_robot_collision(robot, obs, qq))


def _checker_state(ck, q_score, q_sweep=None):
    p = ck.perceptron
    out = {'num_valid': p.num_valid, 'supports': p.support_points,
           'gains': p.gains, 'bias': ck.safety_bias,
           'score': ck.collision_score(q_score).reshape(-1)}
    if q_sweep is not None:
        out['sweep'] = ck._sweep_scores(q_sweep)
    return out


def _case_checker_fit(mesh):
    import diffco_tpu_torch as tdc
    robot, gt = _planar_gt()
    ck = tdc.RBFDiffCo(robot=robot, gt_check_func=gt, seed=5, mesh=mesh,
                       device='cpu')
    acc = ck.fit(num_samples=512, verify_ratio=0.2)
    return dict(_checker_state(ck, torch.from_numpy(_planar_q(64, 9)),
                               torch.from_numpy(_planar_q(101, 13))),
                acc=np.asarray(acc))


def _case_checker_update_lazy(mesh):
    import diffco_tpu_torch as tdc
    robot, gt = _planar_gt()
    q = torch.from_numpy(_planar_q(64, 9))
    ck = tdc.RBFDiffCo(robot=robot, gt_check_func=gt, seed=3, mesh=mesh,
                       device='cpu')
    acc = ck.fit(num_samples=512, verify_ratio=0.2)
    fitted = _checker_state(ck, q)
    acc2 = ck.update(num_samples=64, verify=True)
    updated = _checker_state(ck, q)
    lazy = tdc.RBFDiffCo(robot=robot, gt_check_func=gt, seed=3, mesh=mesh,
                         device='cpu')
    lazy.perceptron.lazy_gram_threshold = 128
    acc3 = lazy.fit(num_samples=512, verify_ratio=0.2)
    return {'acc': np.asarray([acc, acc2, acc3]),
            **{f'fit_{k}': v for k, v in fitted.items()},
            **{f'update_{k}': v for k, v in updated.items()},
            **{f'lazy_{k}': v for k, v in _checker_state(lazy, q).items()}}


def _traj_records(mesh):
    """adam_traj_optimize and al_traj_optimize on a fitted planar checker,
    with options['mesh'] = mesh (None: unsharded; restarts as the mesh
    rounds them when ``trials_of`` gives its data-axis size)."""
    import diffco_tpu_torch as tdc
    from diffco_tpu_torch import optim
    robot, gt = _planar_gt()
    ck = tdc.RBFDiffCo(robot=robot, gt_check_func=gt, seed=1, device='cpu')
    ck.fit(num_samples=512, verify_ratio=0.2)
    return robot, ck.score_fn(), optim


def _traj_options(dp):
    adam = {'N_WAYPOINTS': 10, 'NUM_RE_TRIALS': 8, 'MAXITER': 30, 'seed': 0}
    al = {'N_WAYPOINTS': 8, 'NUM_RE_TRIALS': 3, 'MAXITER': 30, 'seed': 0}
    if dp:   # the unsharded runs with the mesh's rounded restarts
        adam['NUM_RE_TRIALS'] = -(-8 // dp) * dp
        al['NUM_RE_TRIALS'] = -(-3 // dp) * dp
    return adam, al


def _case_trajopt_option(mesh):
    robot, dist_est, optim = _traj_records(mesh)
    start, target = torch.tensor([-2.0, 0.0]), torch.tensor([2.0, 0.0])
    adam, al = _traj_options(None)
    rec = optim.adam_traj_optimize(robot, dist_est, start, target,
                                   {**adam, 'mesh': mesh})
    rec_al = optim.al_traj_optimize(robot, dist_est, start, target,
                                    {**al, 'mesh': mesh})
    return {'adam_' + k: np.asarray(rec[k])
            for k in ('solution', 'cost', 'success', 'cnt_check')} | {
        'al_' + k: np.asarray(rec_al[k])
        for k in ('solution', 'cost', 'success', 'cnt_check')}


def _franka():
    import diffco_tpu_torch as tdc
    return tdc.FrankaPanda(load_gripper=True, setup_acm=False,
                           link_spheres=8, device='cpu')


def _fk_q(n, seed):
    return torch.from_numpy(_rng(seed).uniform(-1.0, 1.0, (n, 7)).astype(
        np.float32))


def _case_fk_checker(mesh):
    import diffco_tpu_torch as tdc
    from diffco_tpu_torch import optim
    robot = _franka()
    ck = tdc.ForwardKinematicsDiffCo(robot=robot, environment=_shape_env_box(),
                                     seed=7, mesh=mesh, device='cpu')
    acc = ck.fit(num_samples=512, verify_ratio=0.2)
    q = _fk_q(32, 11)
    qg = q.clone().requires_grad_(True)
    s = ck.collision_score(qg).reshape(-1)
    dq, = torch.autograd.grad(s.sum(), qg)
    labels = ck._gt_labels(_fk_q(64, 12))
    out = dict(_checker_state(ck, q), acc=np.asarray(acc), dq=dq,
               labels=labels)
    ck.update(num_samples=32)
    rec = optim.adam_traj_optimize(
        robot, ck.score_fn(), torch.zeros(7), 0.4 * torch.ones(7),
        {'N_WAYPOINTS': 8, 'NUM_RE_TRIALS': 4, 'MAXITER': 20, 'seed': 0,
         'mesh': mesh})
    out.update(update_num_valid=ck.perceptron.num_valid,
               update_score=ck.collision_score(q).reshape(-1),
               solution=np.asarray(rec['solution']))
    return out


def _multidim_data():
    from diffco_tpu_torch.geometry.geometry2d import planar_robot_signed_dist
    robot, obs = _planar()
    q = torch.from_numpy(_planar_q(301, 14))
    y = (planar_robot_signed_dist(robot, obs, q).amax(-1) > 0).float() * 2 - 1
    return robot, obs, q, y


def _multidim(robot, mesh, lazy=False):
    from diffco_tpu_torch import kernels
    from diffco_tpu_torch.perceptron import MultiDimDiffCo
    p = MultiDimDiffCo(kernel_func=kernels.MultiDimRQKernel(10.0),
                       transform=lambda x: robot.fkine(x), mesh=mesh)
    if lazy:
        p.lazy_gram_threshold = 64
    return p


def _multidim_run(mesh):
    """The dense and lazy fits and a warm-started update, with or without
    a mesh: {name: array}."""
    from diffco_tpu_torch.geometry.geometry2d import planar_robot_signed_dist
    robot, obs, q, y = _multidim_data()
    out = {}
    for tag, lazy in (('dense', False), ('lazy', True)):
        p = _multidim(robot, mesh, lazy)
        p.train(q, y, max_iteration=900)
        out.update({f'{tag}_num_valid': p.num_valid, f'{tag}_gains': p.gains,
                    f'{tag}_supports': p.support_points,
                    f'{tag}_hyp': p.hypothesis})
        if not lazy:
            dense = p
    nv = dense.num_valid
    q2 = torch.cat([torch.from_numpy(_planar_q(96, 15)),
                    dense.support_points[:nv]])
    y2 = (planar_robot_signed_dist(robot, obs, q2).amax(-1) > 0).float() \
        * 2 - 1
    exist = torch.zeros(q2.shape[0], dtype=torch.bool)
    exist[-nv:] = True
    dense.train(q2, y2, update=True, exist_mask=exist, max_iteration=900)
    out.update(update_num_valid=dense.num_valid, update_gains=dense.gains,
               update_score=dense.score_original(q2).reshape(-1), y2=y2)
    return out


def _case_multidim(mesh):
    return _multidim_run(mesh)


# the directory a group's ranks share (set in _rank)
_SHARED = {}


def _case_dcp(mesh):
    """A meshed checker's state through save_checker_dcp / load_checker_dcp
    into a fresh perceptron, every rank calling both on one path."""
    import diffco_tpu_torch as tdc
    from diffco_tpu_torch import kernels, routines
    robot, gt = _planar_gt()
    ck = tdc.RBFDiffCo(robot=robot, gt_check_func=gt, seed=5, mesh=mesh,
                       device='cpu')
    ck.fit(num_samples=256, verify_ratio=0.2)
    path = os.path.join(_SHARED['dir'], 'checker_dcp')
    routines.save_checker_dcp(ck.perceptron, path)
    fresh = tdc.DiffCo(kernel_func=kernels.RQKernel(10))
    fresh.rbf_kernel = kernels.Polyharmonic(1, 1)
    routines.load_checker_dcp(fresh, path, device='cpu')
    q = torch.from_numpy(_planar_q(64, 9))
    return {'num_valid': fresh.num_valid,
            'ref_num_valid': ck.perceptron.num_valid,
            'score': fresh.poly_score(q), 'ref': ck.perceptron.poly_score(q)}


CASES = {
    'score_sweep': _case_score_sweep,
    'support_score': _case_support_score,
    'support_kernels': _case_support_kernels,
    'gram': _case_gram,
    'fit': _case_fit,
    'fit_padding': _case_fit_padding,
    'fit_warm': _case_fit_warm,
    'trajopt': _case_trajopt,
    'e2e': _case_e2e,
    'fit_lazy': _case_fit_lazy,
    'fit_lazy_warm': _case_fit_lazy_warm,
    'checker_fit': _case_checker_fit,
    'checker_update_lazy': _case_checker_update_lazy,
    'trajopt_option': _case_trajopt_option,
    'fk_checker': _case_fk_checker,
    'multidim': _case_multidim,
    'dcp': _case_dcp,
}


def _numpy_tree(out):
    return {k: _np(v) for k, v in out.items()}


def _unsharded_trajopt(dp):
    """The trajopt_option case without a mesh, with the restarts a mesh
    of dp ranks on its data axis rounds to."""
    robot, dist_est, optim = _traj_records(None)
    start, target = torch.tensor([-2.0, 0.0]), torch.tensor([2.0, 0.0])
    adam, al = _traj_options(dp)
    rec = optim.adam_traj_optimize(robot, dist_est, start, target, adam)
    rec_al = optim.al_traj_optimize(robot, dist_est, start, target, al)
    return {'adam_' + k: np.asarray(rec[k])
            for k in ('solution', 'cost', 'success', 'cnt_check')} | {
        'al_' + k: np.asarray(rec_al[k])
        for k in ('solution', 'cost', 'success', 'cnt_check')}


# the port's unsharded runs of the checker-level cases, in a process of
# their own beside the groups
UNSHARDED = {
    'checker_fit': lambda: _case_checker_fit(None),
    'checker_update_lazy': lambda: _case_checker_update_lazy(None),
    'fk_checker': lambda: _case_fk_checker(None),
    'multidim': lambda: _multidim_run(None),
    **{f'trajopt option {dp}': (lambda dp=dp: _unsharded_trajopt(dp))
       for dp in (2, 3)},
}


def _unsharded(out_dir):
    torch.set_num_threads(1)
    results = {}
    for name, run in UNSHARDED.items():
        try:
            results[name] = _numpy_tree(run())
        except Exception:   # reported by the case's test
            results[name] = {'error': traceback.format_exc()}
    torch.save(results, os.path.join(out_dir, 'unsharded.pt'))


def _rank(rank, world, shape, out_dir):
    """One rank of a group: every case, each result saved (an exception as
    its traceback)."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        'gloo', store=dist.FileStore(os.path.join(out_dir, 'store'), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    from diffco_tpu_torch.parallel import make_mesh
    mesh = make_mesh(('dp', 'tp'), shape, device_type='cpu')
    _SHARED['dir'] = out_dir
    results = {}
    for name, case in CASES.items():
        try:
            results[name] = _numpy_tree(case(mesh))
        except Exception:   # reported by the case's test
            results[name] = {'error': traceback.format_exc()}
    torch.save(results, os.path.join(out_dir, f'rank{rank}.pt'))
    dist.destroy_process_group()


@pytest.fixture(scope='module')
def groups(tmp_path_factory):
    """Both groups spawned together, with a process for the unsharded
    checker-level runs: {layout: every rank's results, 'unsharded':
    {case: result}}."""
    ctx = mp.get_context('spawn')
    plain = str(tmp_path_factory.mktemp('unsharded'))
    procs, dirs = [ctx.Process(target=_unsharded, args=(plain,))], {}
    for layout, shape in LAYOUTS.items():
        world = shape[0] * shape[1]
        dirs[layout] = str(tmp_path_factory.mktemp(f'mesh{layout}'))
        procs += [ctx.Process(target=_rank,
                              args=(r, world, shape, dirs[layout]))
                  for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=JOIN_TIMEOUT)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(timeout=10)
    assert not hung, f'{len(hung)} ranks hung'
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    out = {layout: [torch.load(os.path.join(d, f'rank{r}.pt'),
                               weights_only=False)
                    for r in range(LAYOUTS[layout][0] * LAYOUTS[layout][1])]
           for layout, d in dirs.items()}
    out['unsharded'] = torch.load(os.path.join(plain, 'unsharded.pt'),
                                  weights_only=False)
    return out


def _sharded(groups, layout, case):
    """Rank 0's result of the case, after holding every rank's to it."""
    ranks = [r[case] for r in groups[layout]]
    for r in ranks:
        assert 'error' not in r, r.get('error')
    for r in ranks[1:]:
        assert r.keys() == ranks[0].keys()
        for k in r:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    return ranks[0]


# ---- the unsharded port runs and the JAX package, once per case

_memo = {}


def _once(key, fn):
    if key not in _memo:
        _memo[key] = fn()
    return _memo[key]


def test_make_mesh_without_a_card_raises():
    """make_mesh() asks for CUDA (NCCL) by default: without a card it
    raises, never falling back to the CPU or to gloo."""
    from diffco_tpu_torch.parallel import make_mesh
    if torch.cuda.is_available():   # pragma: no cover - no card here
        pytest.skip('a CUDA card is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        make_mesh()
    with pytest.raises(RuntimeError, match='CUDA'):
        make_mesh(device_type='cuda')


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_sharded_score_sweep(groups, layout):
    import jax.numpy as jnp
    from diffco_tpu.geometry import Obstacles2D as JObs
    from diffco_tpu.geometry import planar_robot_signed_dist as jsd
    from diffco_tpu.robots import RevolutePlanarRobot as JPlanar
    from diffco_tpu_torch.geometry.geometry2d import planar_robot_signed_dist
    out = _sharded(groups, layout, 'score_sweep')['out']
    q = _planar_q(1000, 0)
    robot, obs = _planar()
    ref = planar_robot_signed_dist(robot, obs, torch.from_numpy(q)).amax(-1)
    assert out.shape == (1000,)
    _close(out, ref, 1e-5)
    jref = _once('jax score_sweep', lambda: np.asarray(jsd(
        JPlanar(1.0, link_width=0.2, dof=2),
        JObs.from_obstacle_list([('circle', (1.5, 1.0), 0.6)]),
        jnp.asarray(q)).max(axis=-1)))
    _close(ref, jref, 1e-5)


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_support_parallel_score(groups, layout):
    """The support-sharded score and its gradient in x (summed over the tp
    ranks) against the unsharded polyharmonic score."""
    import jax.numpy as jnp
    from diffco_tpu.ops.fused_score import _poly_score_xla
    from diffco_tpu_torch.ops import fused_score
    r = _sharded(groups, layout, 'support_score')
    sup, w, valid, x = _support_inputs(100, 1, 77)
    ref, ref_dx = fused_score._poly_score_grad_plain(
        torch.from_numpy(x), torch.from_numpy(sup),
        torch.from_numpy(w * valid))
    _close(r['out'], ref, 1e-3)
    _close(r['dx'], ref_dx, 1e-3)
    _close(ref, np.asarray(_poly_score_xla(
        jnp.asarray(x), jnp.asarray(sup), jnp.asarray(w * valid))).reshape(-1),
        1e-3)


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_support_parallel_score_generic_kernel(groups, layout):
    import jax.numpy as jnp
    from diffco_tpu import kernels as jk
    from diffco_tpu_torch import kernels as tk
    r = _sharded(groups, layout, 'support_kernels')
    sup, w, valid, x = _support_inputs(90, 2, 71)
    for name, args in (('RQKernel', (5.0,)), ('MultiQuadratic', (1.0,))):
        kv = getattr(tk, name)(*args)(torch.from_numpy(x),
                                      torch.from_numpy(sup))
        ref = (kv * torch.from_numpy(valid).float()) @ torch.from_numpy(w)
        _close(r[name], ref, 1e-3)
        jkv = getattr(jk, name)(*args)(jnp.asarray(x), jnp.asarray(sup))
        _close(ref, np.asarray(jnp.matmul(jkv * valid, jnp.asarray(w),
                                          precision='highest')), 1e-3)


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_sharded_gram(groups, layout):
    import jax.numpy as jnp
    from diffco_tpu import kernels as jk
    from diffco_tpu_torch import kernels as tk
    X = _blobs(50, 3)
    ref = tk.RQKernel(5.0)(torch.from_numpy(X), torch.from_numpy(X))
    _close(_sharded(groups, layout, 'gram')['K'], ref, 1e-4)
    _close(ref, jk.RQKernel(5.0)(jnp.asarray(X), jnp.asarray(X)), 1e-4)


def _fit_refs(X, init=None):
    """The port's and the JAX package's unsharded greedy fits and RBF
    solves on X (labels sign(X[:, 0])): {'port': ..., 'jax': ...}."""
    import jax.numpy as jnp
    from diffco_tpu import kernels as jk
    from diffco_tpu import perceptron as jp
    from diffco_tpu_torch import kernels as tk
    from diffco_tpu_torch import perceptron as tp
    from diffco_tpu_torch.device import fp32_matmul
    y = np.sign(X[:, 0])
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    with fp32_matmul():
        K = tk.RQKernel(5.0)(Xt, Xt)
        ig = None if init is None else torch.from_numpy(init)
        g, h, it = tp.perceptron_train_loop(
            K, yt, 1.0, 500, init_gains=ig,
            init_hypothesis=None if ig is None else K @ ig)
        n = tp.masked_rbf_solve(K, yt, g != 0)
    Kj = jk.RQKernel(5.0)(jnp.asarray(X), jnp.asarray(X))
    igj = None if init is None else jnp.asarray(init)
    gj, hj, itj = jp.perceptron_train_loop(
        Kj, jnp.asarray(y), 1.0, 500, init_gains=igj,
        init_hypothesis=None if igj is None else jnp.matmul(
            Kj, igj, precision='highest'))
    nj = jp.masked_rbf_solve(Kj, jnp.asarray(y), gj != 0)
    return {'port': (g, h, n, int(it)),
            'jax': tuple(np.asarray(a) for a in (gj, hj, nj)) + (int(itj),)}


def _check_fit(r, ref, nodes=True):
    g, h, n, it = ref['port']
    assert r['it'] == it
    _close(r['gains'], g, 1e-4)
    _close(r['hyp'], h, 1e-4)
    if nodes:
        _close(r['nodes'], n, 1e-3)
    gj, hj, nj, itj = ref['jax']
    assert it == itj
    _close(g, gj, 1e-4)
    _close(h, hj, 1e-4)
    if nodes:
        _close(n, nj, 1e-3)


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_distributed_fit_matches_single_device(groups, layout):
    X = _blobs(64, 4)
    r = _sharded(groups, layout, 'fit')
    _check_fit(r, _once('fit', lambda: _fit_refs(X)))
    assert np.mean((r['hyp'] > 0) == (X[:, 0] > 0)) > 0.8


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_distributed_fit_padding_inert(groups, layout):
    """61 rows over 2 and 3 ranks: the padded rows never become supports."""
    X = _blobs(61, 5)
    r = _sharded(groups, layout, 'fit_padding')
    assert r['gains'].shape == (61,)
    _check_fit(r, _once('fit_padding', lambda: _fit_refs(X)))


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_distributed_fit_warm_start_update(groups, layout):
    """Fit, extend the dataset, warm-start the refit: the same gains as
    the unsharded warm start from the same previous gains, fewer
    iterations than a cold fit, and the training accuracy kept."""
    X2, y2 = _warm_data()
    r = _sharded(groups, layout, 'fit_warm')
    ref = _fit_refs(X2, init=r['prev'])
    g, h, _, it = ref['port']
    assert r['it_warm'] == it
    _close(r['gains'], g, 1e-4)
    _close(r['hyp'], h, 1e-4)
    _close(g, ref['jax'][0], 1e-4)
    assert it == ref['jax'][3]
    assert np.mean((r['hyp'] > 0) == (y2 > 0)) > 0.8
    assert r['it_warm'] <= r['it_cold']


def _adam_refs(score_fn, robot, start, target, T, n_way, iters, seed=0):
    """The port's unsharded Adam core with T restarts drawn from the
    generator seeded ``seed``."""
    from diffco_tpu_torch import optim
    rand = optim._draws([torch.Generator().manual_seed(seed)], T, n_way, 2,
                        torch.float32, torch.device('cpu'))
    sol, cost, success, _, _ = optim._adam_batch_core(
        start[None], target[None], robot.limits, None, rand, robot.fkine,
        score_fn, n_way, iters, 0.5, 0.0, 1.5)
    return sol[0], float(cost[0]), bool(success[0])


def _check_traj(sol, cost, success, ref):
    assert success == ref[2]
    np.testing.assert_allclose(cost, ref[1], rtol=1e-3, atol=1e-4)
    _close(sol, ref[0], 1e-4, rtol=1e-3)


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_distributed_trajopt_matches_single_device(groups, layout):
    """Restart-sharded Adam == the unsharded core on the same draws; and
    the port's core == the JAX package's on the JAX package's draws."""
    import jax
    import jax.numpy as jnp
    from diffco_tpu.ops.fused_score import _poly_score_xla
    from diffco_tpu.optim import _adam_traj_core as jcore
    from diffco_tpu.robots import RevolutePlanarRobot as JPlanar
    from diffco_tpu_torch import optim
    r = _sharded(groups, layout, 'trajopt')
    robot, _ = _planar()
    sup, w, start, target = _traj_world()
    T = _trials(LAYOUTS[layout][0])

    def score(p):
        return _t_poly_score(robot.fkine(p).reshape(p.shape[0], -1),
                             torch.from_numpy(sup), torch.from_numpy(w))
    st, tg = torch.from_numpy(start), torch.from_numpy(target)
    _check_traj(r['sol'], float(r['cost']), bool(r['success']),
                _adam_refs(score, robot, st, tg, T, 10, 30))
    # every restart, step by step: the init path, the straight line next,
    # the random ones in order, each on its rank
    hist = _traj_hist(score, robot, st, tg, T)
    assert r['hist'].shape == hist.shape == (T, 10, 10, 2)
    _close(r['hist'], hist, 1e-4, rtol=1e-3)
    np.testing.assert_allclose(r['sol'][0], start, atol=1e-6)
    np.testing.assert_allclose(r['sol'][-1], target, atol=1e-6)

    def jax_vs_port():
        jrobot = JPlanar(1.0, link_width=0.2, dof=2)
        limits = jnp.asarray(jrobot.limits, jnp.float32)

        def jscore(p):
            pts = jrobot.fkine(p).reshape(p.shape[0], -1)
            return _poly_score_xla(pts, jnp.asarray(sup),
                                   jnp.asarray(w)).reshape(-1)
        jsol, jcost, jsucc, _, _ = jcore(
            jnp.asarray(start), jnp.asarray(target), limits,
            jnp.full((10, 2), jnp.nan, jnp.float32), jax.random.PRNGKey(0),
            jrobot.fkine, jscore, 10, 8, 30, 0.5,
            jnp.asarray(0.0, jnp.float32), 1.5)
        rand = torch.from_numpy(np.array(jax.random.uniform(
            jax.random.PRNGKey(0), (8, 10, 2), dtype=jnp.float32)))[None]
        sol, cost, succ, _, _ = optim._adam_batch_core(
            st[None], tg[None], robot.limits, None, rand, robot.fkine, score,
            10, 30, 0.5, 0.0, 1.5)
        return ((sol[0], float(cost[0]), bool(succ[0])),
                (np.asarray(jsol), float(jcost), bool(jsucc)))
    port, jref = _once('trajopt jax', jax_vs_port)
    _check_traj(*port, jref)


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_distributed_e2e_fit_update_trajopt(groups, layout):
    """Label -> fit -> trajopt on the mesh: the labels and the fit equal
    the unsharded (and the JAX package's) ones on the same
    configurations."""
    import jax.numpy as jnp
    from diffco_tpu import kernels as jk
    from diffco_tpu import perceptron as jp
    from diffco_tpu_torch import kernels as tk
    from diffco_tpu_torch import perceptron as tp
    from diffco_tpu_torch.device import fp32_matmul
    from diffco_tpu_torch.geometry.geometry2d import planar_robot_signed_dist
    r = _sharded(groups, layout, 'e2e')
    robot, obs = _planar()
    q = _planar_q(256, 9)
    labels = (planar_robot_signed_dist(robot, obs, torch.from_numpy(q))
              .amax(-1) > 0).float() * 2 - 1
    _close(r['labels'], labels, 0)
    with fp32_matmul():
        K = tk.RQKernel(10.0)(torch.from_numpy(q), torch.from_numpy(q))
        g, h, _ = tp.perceptron_train_loop(K, labels, 1.0, 1000)
    _close(r['gains'], g, 1e-4)
    _close(r['hyp'], h, 1e-4)
    assert np.mean((r['hyp'] > 0) == (_np(labels) > 0)) > 0.9
    assert np.all(np.isfinite(r['sol'])) and r['cost'] >= 0.0
    jg = _once('e2e jax', lambda: np.asarray(jp.perceptron_train_loop(
        jk.RQKernel(10.0)(jnp.asarray(q), jnp.asarray(q)),
        jnp.asarray(_np(labels)), 1.0, 1000)[0]))
    _close(g, jg, 1e-4)


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_distributed_fit_lazy_matches_single_device(groups, layout):
    X = _blobs(64, 4)
    _check_fit(_sharded(groups, layout, 'fit_lazy'),
               _once('fit', lambda: _fit_refs(X)), nodes=False)


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_distributed_fit_lazy_padding_and_warm_start(groups, layout):
    """61 rows: padded rows inert; a warm start from the found gains
    converges in no more iterations and equals the unsharded lazy warm
    start."""
    from diffco_tpu_torch import kernels as tk
    from diffco_tpu_torch import perceptron as tp
    from diffco_tpu_torch.device import fp32_matmul
    X = _blobs(61, 5)
    r = _sharded(groups, layout, 'fit_lazy_warm')
    _check_fit(r, _once('fit_padding', lambda: _fit_refs(X)), nodes=False)
    Xt, y = torch.from_numpy(X), torch.sign(torch.from_numpy(X[:, 0]))
    g = torch.from_numpy(r['gains'])
    with fp32_matmul():
        kern = tk.RQKernel(5.0)
        g2, h2, it2 = tp.perceptron_train_loop_lazy(
            Xt, y, kern, 1.0, 500, init_gains=g,
            init_hypothesis=kern(Xt, Xt) @ g)
    assert r['it2'] == int(it2) and r['it2'] <= r['it']
    _close(r['gains2'], g2, 1e-4)
    _close(r['hyp2'], h2, 1e-4)
    assert np.mean((r['hyp2'] > 0) == (X[:, 0] > 0)) > 0.8


def _unsharded_checker(groups, case):
    """The case run without a mesh (the same seeds, so the same
    datasets)."""
    r = groups['unsharded'][case]
    assert 'error' not in r, r.get('error')
    return r


def _check_state(r, ref, prefix=''):
    assert r[prefix + 'num_valid'] == ref[prefix + 'num_valid']
    _close(r[prefix + 'supports'], ref[prefix + 'supports'], 1e-6)
    _close(r[prefix + 'gains'], ref[prefix + 'gains'], 1e-4)
    _close(r[prefix + 'score'], ref[prefix + 'score'], 1e-3)


def _same_streams(*checkers):
    """Each checker's _next_rng gives the same numpy streams (the
    packages' own differ)."""
    for ck in checkers:
        seeds = iter(np.random.SeedSequence(21).spawn(8))
        ck._next_rng = lambda seeds=seeds: np.random.default_rng(next(seeds))


def _planar_jax_pair():
    """The port's and the JAX package's unsharded RBFDiffCo in the planar
    world, fitted on the same 512 configurations and labels with the same
    verify split: (acc, num_valid, support points, gains, scores) each."""
    import jax.numpy as jnp
    import diffco_tpu as jdc
    from diffco_tpu.geometry import Obstacles2D as JObs
    from diffco_tpu.geometry import planar_robot_collision as jcol
    from diffco_tpu.robots import RevolutePlanarRobot as JPlanar
    import diffco_tpu_torch as tdc
    robot, gt = _planar_gt()
    jrobot = JPlanar(1.0, link_width=0.2, dof=2)
    jobs = JObs.from_obstacle_list([('circle', (1.5, 1.0), 0.6),
                                    ('rect', (-1.2, -1.0), (1.0, 1.0))])
    q = _planar_q(512, 16)
    labels = _np(gt(torch.from_numpy(q))).astype(np.float32)
    tck = tdc.RBFDiffCo(robot=robot, gt_check_func=gt, seed=5, device='cpu')
    jck = jdc.RBFDiffCo(robot=jrobot,
                        gt_check_func=lambda qq: jcol(jrobot, jobs, qq),
                        seed=5)
    _same_streams(tck, jck)
    qs = _planar_q(64, 9)
    out = {}
    for name, ck, arr in (('port', tck, torch.from_numpy),
                          ('jax', jck, jnp.asarray)):
        acc = ck.fit(q=arr(q), labels=arr(labels), verify_ratio=0.2)
        p = ck.perceptron
        out[name] = (np.asarray(acc), p.num_valid, _np(p.support_points),
                     _np(p.gains),
                     _np(ck.collision_score(arr(qs))).reshape(-1))
    return out


def _check_jax_pair(pair):
    (acc, nv, sup, g, s), (jacc, jnv, jsup, jg, js) = pair['port'], pair['jax']
    assert nv == jnv
    _close(sup, jsup, 1e-6)
    _close(g, jg, 1e-4)
    _close(acc, jacc, 1e-6)
    # scores through each package's float32 RBF solve, which differ
    # (ROADMAP, "Fits differ in float32"; tests/test_torch_active.py)
    _close(s, js, 1e-2)


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_checker_mesh_fit_parity(groups, layout):
    """RBFDiffCo(mesh=...) reproduces the unsharded fit: support count,
    verify metrics, scores, and the verify sweep over 101 rows (not a
    multiple of the mesh); the unsharded port fit equals the JAX
    package's on the same dataset."""
    r = _sharded(groups, layout, 'checker_fit')
    ref = _unsharded_checker(groups, 'checker_fit')
    _check_state(r, ref)
    _close(r['acc'], ref['acc'], 1e-6)
    assert r['sweep'].shape == (101,)
    _close(r['sweep'], ref['sweep'], 1e-3)
    _check_jax_pair(_once('planar jax pair', _planar_jax_pair))


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_checker_mesh_update_and_lazy(groups, layout):
    """A meshed checker's update (warm start + sharded refit) and its lazy
    route (forced by a small threshold) equal the unsharded ones."""
    r = _sharded(groups, layout, 'checker_update_lazy')
    ref = _unsharded_checker(groups, 'checker_update_lazy')
    for prefix in ('fit_', 'update_', 'lazy_'):
        _check_state(r, ref, prefix)
    _close(r['acc'], ref['acc'], 1e-6)
    acc, acc2, acc3 = r['acc'][:, 0]
    assert acc > 0.8 and acc2 > 0.75 and acc3 > 0.8
    _check_jax_pair(_once('planar jax pair', _planar_jax_pair))


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_trajopt_mesh_option_parity(groups, layout):
    """adam_traj_optimize and al_traj_optimize with options['mesh'] equal
    the unsharded runs with the restarts the mesh rounds to (8 restarts
    divide the 2 x 2 mesh's data axis, so there it is the plain run; AL's
    3 round up to 4 and stay 3 on 3 ranks), and their records count the
    rounded restarts."""
    r = _sharded(groups, layout, 'trajopt_option')
    ref = _unsharded_checker(groups,
                             f'trajopt option {LAYOUTS[layout][0]}')
    for tag in ('adam_', 'al_'):
        _check_traj(r[tag + 'solution'], float(r[tag + 'cost']),
                    bool(r[tag + 'success']),
                    (ref[tag + 'solution'], float(ref[tag + 'cost']),
                     bool(ref[tag + 'success'])))
        assert int(r[tag + 'cnt_check']) == int(ref[tag + 'cnt_check'])
    assert np.all(np.isfinite(r['al_solution']))


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_fk_checker_mesh_e2e(groups, layout):
    """ForwardKinematicsDiffCo(mesh=...) on FrankaPanda: fit (TPR >= 0.8),
    scores and their gradient in q (through the sharded sweep's gather),
    update and Adam with options['mesh'], equal to the unsharded checker;
    the sharded ground-truth labels equal the JAX package's."""
    import jax.numpy as jnp
    import diffco_tpu as jdc
    r = _sharded(groups, layout, 'fk_checker')
    ref = _unsharded_checker(groups, 'fk_checker')
    assert r['acc'][1] >= 0.8
    _check_state(r, ref)
    _close(r['dq'], ref['dq'], 1e-3)
    assert r['update_num_valid'] == ref['update_num_valid']
    _close(r['update_score'], ref['update_score'], 1e-3)
    assert np.all(np.isfinite(r['solution']))
    _close(r['solution'], ref['solution'], 1e-4, rtol=1e-3)

    def jax_labels():
        env = jdc.ShapeEnv(_shape_env_box())
        robot = jdc.FrankaPanda(load_gripper=True, setup_acm=False,
                                link_spheres=8)
        return np.asarray(robot.collision(jnp.asarray(_np(_fk_q(64, 12))),
                                          other=env))
    np.testing.assert_array_equal(r['labels'], _once('fk labels', jax_labels))


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_multidim_mesh_fit_parity(groups, layout):
    """MultiDimDiffCo(mesh=...) reproduces the unsharded dense and lazy
    trains (N = 301 divides neither mesh) and the warm-started update; the
    unsharded dense train equals the JAX package's."""
    import jax.numpy as jnp
    from diffco_tpu import kernels as jk
    from diffco_tpu.perceptron import MultiDimDiffCo as JMultiDim
    from diffco_tpu.robots import RevolutePlanarRobot as JPlanar
    r = _sharded(groups, layout, 'multidim')
    ref = _unsharded_checker(groups, 'multidim')
    for tag in ('dense', 'lazy'):
        assert r[f'{tag}_num_valid'] == ref[f'{tag}_num_valid']
        _close(r[f'{tag}_gains'], ref[f'{tag}_gains'], 1e-4)
        _close(r[f'{tag}_supports'], ref[f'{tag}_supports'], 1e-6)
        _close(r[f'{tag}_hyp'], ref[f'{tag}_hyp'], 1e-3)
    assert r['update_num_valid'] == ref['update_num_valid']
    _close(r['update_gains'], ref['update_gains'], 1e-4)
    assert np.mean((r['update_score'] > 0) == (r['y2'] > 0)) > 0.85

    def jax_dense():
        jrobot = JPlanar(1.0, link_width=0.2, dof=2)
        _, _, q, y = _multidim_data()
        p = JMultiDim(kernel_func=jk.MultiDimRQKernel(10.0),
                      transform=lambda x: jrobot.fkine(x))
        p.train(jnp.asarray(_np(q)), jnp.asarray(_np(y)), max_iteration=900)
        return p.num_valid, np.asarray(p.gains)
    jnv, jg = _once('multidim jax', jax_dense)
    assert ref['dense_num_valid'] == jnv
    _close(ref['dense_gains'], jg, 1e-4)


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_checker_dcp_round_trip_on_a_mesh(groups, layout):
    """save_checker_dcp / load_checker_dcp called by every rank of a mesh
    restore the meshed checker's state: the same scores."""
    r = _sharded(groups, layout, 'dcp')
    assert r['num_valid'] == r['ref_num_valid']
    _close(r['score'], r['ref'], 1e-6)


def test_checker_dcp_round_trip_matches_orbax(tmp_path):
    """One process, no process group: a perceptron state (128 padded
    supports, 100 valid) through the port's save_checker_dcp /
    load_checker_dcp comes back as the JAX package's save_checker_orbax /
    load_checker_orbax restore it: the same arrays, num_valid and
    scores."""
    pytest.importorskip('orbax.checkpoint')
    import jax.numpy as jnp
    import diffco_tpu as jdc
    from diffco_tpu import routines as jroutines
    import diffco_tpu_torch as tdc
    from diffco_tpu_torch import kernels, routines
    r = _rng(18)
    S, nv = 128, 100
    valid = np.arange(S) < nv
    sup = (r.uniform(-np.pi, np.pi, (S, 2)) * valid[:, None]).astype(
        np.float32)
    state = {'support_points': sup, 'support_transformed': sup,
             'gains': r.normal(size=S).astype(np.float32) * valid,
             'hypothesis': r.normal(size=S).astype(np.float32),
             'y': np.sign(r.normal(size=S)).astype(np.float32),
             'kernel_matrix': r.normal(size=(S, S)).astype(np.float32),
             'rbf_nodes': r.normal(size=S).astype(np.float32) * valid,
             'valid_mask': valid, 'distance': None}
    restored = []
    for pkg, arr, save, load in (
            (jdc, jnp.asarray, jroutines.save_checker_orbax,
             jroutines.load_checker_orbax),
            (tdc, torch.from_numpy, routines.save_checker_dcp,
             lambda p, path: routines.load_checker_dcp(p, path,
                                                       device='cpu'))):
        kern = pkg.kernels if pkg is tdc else pkg.kernel
        src = pkg.DiffCo(kernel_func=kern.RQKernel(10))
        for k, v in state.items():
            setattr(src, k, None if v is None else arr(v))
        src.num_valid = nv
        path = str(tmp_path / pkg.__name__)
        save(src, path)
        fresh = pkg.DiffCo(kernel_func=kern.RQKernel(10))
        fresh.rbf_kernel = kern.Polyharmonic(1, 1)
        load(fresh, path)
        restored.append(fresh)
    ref, port = restored
    assert port.num_valid == ref.num_valid == nv
    for k, v in state.items():
        if v is not None:
            np.testing.assert_array_equal(_np(getattr(port, k)), v,
                                          err_msg=k)
            np.testing.assert_array_equal(np.asarray(getattr(ref, k)), v,
                                          err_msg=k)
        else:
            assert getattr(port, k) is None and getattr(ref, k) is None
    q = _planar_q(64, 9)
    _close(port.poly_score(torch.from_numpy(q)),
           np.asarray(ref.poly_score(jnp.asarray(q))), 1e-4)
