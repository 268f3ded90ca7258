"""Convenience routines: 2-D dataset generation and I/O, training,
fitting, testing and checkpointing a proxy, and a view of an SE(3) path
(PyTorch counterpart of ``diffco_tpu/routines.py``).

A dataset is a dict {'data', 'label', 'dist', 'obs', 'robot', 'rparam',
'label_type'} stored as .npz: the arrays as npz members, the other
fields as plain Python values pickled into ``__meta__``. A checkpoint is
an npz of the proxy's arrays. Both formats are the JAX package's, so
each package reads the files the other writes.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np
import torch

from . import kernels as kernel
from .device import resolve_device
from .geometry.geometry2d import Obstacles2D, planar_robot_signed_dist
from .robots.analytic import RevolutePlanarRobot, RigidPlanarBody


def autogenerate_2d_dataset(num_init_points=8000, dof=2, link_length=1.0,
                            link_width=0.3, obstacles=None,
                            label_type='binary', env_id='auto', seed=0,
                            save_dir=None, device=None):
    """A planar-arm dataset labelled by the geometric ground truth, on
    ``device`` (CUDA unless the caller asks for the CPU); configurations
    drawn from a CPU ``torch.Generator`` seeded ``seed``.

    label_type: 'binary' (dist [N, 1], the deepest obstacle), 'instance'
    (one column per obstacle) or 'class' (one per obstacle class).
    Returns the dataset dict (numpy arrays), also saved under
    ``save_dir`` when given."""
    dev = resolve_device(device)
    if obstacles is None:
        obstacles = [('circle', (1.5, 1.5), 0.6, 0),
                     ('rect', (-1.5, -1.5), (1.5, 1.5), 1)]
    robot = RevolutePlanarRobot(link_length, link_width=link_width, dof=dof)
    obs = Obstacles2D.from_obstacle_list(obstacles)
    q = robot.rand_configs(num_init_points,
                           torch.Generator().manual_seed(int(seed)), dev)
    sd = planar_robot_signed_dist(robot, obs, q)          # [N, n_obs]
    if label_type == 'binary':
        dist = torch.amax(sd, dim=-1, keepdim=True)
    elif label_type == 'instance':
        dist = sd
    elif label_type == 'class':
        classes = torch.as_tensor(obs.obstacle_classes, device=dev)
        dist = torch.stack([
            torch.amax(torch.where(classes[None, :] == c, sd,
                                   torch.full_like(sd, -torch.inf)), dim=-1)
            for c in range(obs.num_class)], dim=-1)
    else:
        raise ValueError(f'unknown label_type {label_type}')
    label = (dist > 0).to(torch.float32) * 2.0 - 1.0
    dataset = {
        'data': q.cpu().numpy(),
        'label': label.cpu().numpy(),
        'dist': dist.cpu().numpy(),
        'obs': obstacles,
        'robot': 'RevolutePlanarRobot',
        'rparam': [link_length, link_width, dof],
        'label_type': label_type,
    }
    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
        save_dataset(dataset, os.path.join(
            save_dir, f'2d_{dof}dof_{env_id}_{label_type}.npz'))
    return dataset


def save_dataset(dataset: Dict, path: str):
    """The numpy arrays as npz members, every other field pickled into
    ``__meta__`` (plain Python values only)."""
    meta = {k: v for k, v in dataset.items()
            if not isinstance(v, np.ndarray)}
    arrays = {k: v for k, v in dataset.items() if isinstance(v, np.ndarray)}
    np.savez(path, __meta__=np.frombuffer(pickle.dumps(meta), np.uint8),
             **arrays)


def load_dataset(path: str) -> Dict:
    """A dataset saved by ``save_dataset`` (of either package). Its
    ``__meta__`` is unpickled, which can run code: load only files this
    program or the JAX package wrote."""
    z = np.load(path, allow_pickle=False)
    out = {k: z[k] for k in z.files if k != '__meta__'}
    if '__meta__' in z.files:
        out.update(pickle.loads(z['__meta__'].tobytes()))
    return out


def unpack_dataset(dataset, device=None):
    """Dataset dict (or npz path) -> (cfgs, labels, dists, obstacles,
    robot): float32 tensors on ``device`` (CUDA unless the caller asks for
    the CPU), the obstacle list and the planar robot the dataset names
    (None for another)."""
    dev = resolve_device(device)
    if isinstance(dataset, str):
        dataset = load_dataset(dataset)

    def tensor(k):
        return torch.as_tensor(np.asarray(dataset[k]), dtype=torch.float32,
                               device=dev)

    robot_name = dataset.get('robot')
    rparam = dataset.get('rparam', [])
    if robot_name == 'RevolutePlanarRobot':
        robot = RevolutePlanarRobot(rparam[0], link_width=rparam[1],
                                    dof=int(rparam[2]))
    elif robot_name == 'RigidPlanarBody':
        robot = RigidPlanarBody(rparam[0])
    else:
        robot = None
    return (tensor('data'), tensor('label'), tensor('dist'),
            dataset.get('obs'), robot)


def train_test_split(n_total, n_train, seed=0):
    """Random index split from ``np.random.RandomState(seed)``: (train,
    test) boolean CPU tensors [n_total]."""
    perm = np.random.RandomState(seed).permutation(n_total)
    train_mask = np.zeros(n_total, bool)
    train_mask[perm[:n_train]] = True
    return torch.from_numpy(train_mask), torch.from_numpy(~train_mask)


def generate_unified_grid(size_x=400, size_y=400, lo=-np.pi, hi=np.pi,
                          device=None):
    """Dense configuration grid [size_x * size_y, 2] over [lo, hi]^2 on
    ``device`` (CUDA unless the caller asks for the CPU), x varying
    fastest."""
    dev = resolve_device(device)
    yy, xx = torch.meshgrid(
        torch.linspace(lo, hi, size_y, device=dev),
        torch.linspace(lo, hi, size_x, device=dev), indexing='ij')
    return torch.stack([xx, yy], dim=2).reshape(-1, 2)


def train_checker(checker, cfgs, labels, dists=None, fkine=None,
                  max_iteration=None, verbose=False):
    """Train a bare perceptron on a dataset (default 3N iterations)."""
    del fkine
    max_iteration = max_iteration or 3 * cfgs.shape[0]
    checker.train(cfgs, torch.as_tensor(labels), max_iteration=max_iteration,
                  distance=dists, verbose=verbose)
    return checker


def fit_checker(checker, fitting_target='label', fitting_epsilon=1.0,
                kernel_func=None):
    """Fit the smooth surrogate (default ``Polyharmonic(1,
    fitting_epsilon)``)."""
    if kernel_func is None:
        kernel_func = kernel.Polyharmonic(k=1, epsilon=fitting_epsilon)
    checker.fit_poly(kernel_func=kernel_func, target=fitting_target)
    return checker


def get_estimator(checker, method='rbf'):
    """A score function by name: 'rbf' (``rbf_score``, else
    ``poly_score``), 'poly', 'original' or 'fullpoly'."""
    if method == 'rbf':
        fn = getattr(checker, 'rbf_score', None) or checker.poly_score
    elif method == 'poly':
        fn = checker.poly_score
    elif method == 'original':
        fn = checker.score_original
    elif method == 'fullpoly':
        fn = checker.full_poly_score
    else:
        raise ValueError(f'unknown method {method}')
    return fn


def test_checker(checker, score_fn, cfgs, labels, num_test=None,
                 safety_margin=0.0, verbose=True):
    """(acc, TPR, TNR) of ``score_fn`` on a labelled set (labels +-1).
    The prediction is ``score - safety_margin > 0``: a NEGATIVE margin
    (-0.3 in the reference scripts) leans towards 'collision', the
    opposite sign of the checkers' additive ``safety_bias``."""
    del checker
    if num_test is not None:
        cfgs, labels = cfgs[:num_test], labels[:num_test]
    labels = torch.as_tensor(labels)
    with torch.no_grad():
        scores = score_fn(cfgs) - safety_margin
    preds = (scores.reshape(labels.shape) > 0).to(labels.dtype) * 2 - 1
    n_pos = torch.clamp(torch.sum(labels == 1), min=1)
    n_neg = torch.clamp(torch.sum(labels == -1), min=1)
    acc = float(torch.mean((preds == labels).to(torch.float32)))
    tpr = float(torch.sum((preds == 1) & (labels == 1)) / n_pos)
    tnr = float(torch.sum((preds == -1) & (labels == -1)) / n_neg)
    if verbose:
        print(f'Test acc: {acc:.4f}, TPR {tpr:.4f}, TNR {tnr:.4f}')
    return acc, tpr, tnr


_CHECKER_STATE_KEYS = ('support_points', 'support_transformed', 'gains',
                       'hypothesis', 'y', 'kernel_matrix', 'rbf_nodes',
                       'valid_mask', 'distance')


def save_pretrained_checker(checker, path: str):
    """A perceptron's state as npz: its arrays (those that are None are
    left out) and ``num_valid``. This is also the state the JAX package
    writes to an orbax checkpoint."""
    state = {k: getattr(checker, k).detach().cpu().numpy()
             for k in _CHECKER_STATE_KEYS
             if getattr(checker, k, None) is not None}
    state['num_valid'] = checker.num_valid
    np.savez(path, **state)


def load_pretrained_checker(checker, path: str, device=None):
    """Restore a state written by ``save_pretrained_checker`` (of either
    package) onto ``device`` (CUDA unless the caller asks for the CPU):
    ``valid_mask`` as bool, the other arrays as float32. Keys absent from
    the file are left at the perceptron's current value, and so is its
    surrogate kernel (``rbf_kernel``), which the file does not hold."""
    dev = resolve_device(device)
    z = np.load(path)
    for k in _CHECKER_STATE_KEYS:
        if k in z.files:
            dt = torch.bool if k == 'valid_mask' else torch.float32
            setattr(checker, k, torch.as_tensor(z[k], dtype=dt, device=dev))
    checker.num_valid = int(z['num_valid'])
    return checker


def _checker_state(checker):
    """The arrays-only state of ``save_pretrained_checker`` as tensors,
    ``num_valid`` a 0-d one (attributes that are None are left out)."""
    state = {k: getattr(checker, k) for k in _CHECKER_STATE_KEYS
             if getattr(checker, k, None) is not None}
    state['num_valid'] = torch.tensor(int(checker.num_valid))
    return state


def save_checker_dcp(checker, path: str):
    """A perceptron's state as a ``torch.distributed.checkpoint``
    directory: the arrays of ``save_pretrained_checker`` and
    ``num_valid`` (the counterpart of the JAX package's
    ``save_checker_orbax``, diffco_tpu/routines.py:233). With a process
    group up (a mesh) every rank calls it, and the state, the same on
    every rank, is written once; without one this process writes it."""
    import torch.distributed.checkpoint as dcp
    dcp.save(_checker_state(checker), checkpoint_id=os.path.abspath(path))


def load_checker_dcp(checker, path: str, device=None):
    """Restore a state written by ``save_checker_dcp`` onto ``device``
    (CUDA unless the caller asks for the CPU), each array at the shape and
    dtype the checkpoint records (the counterpart of
    ``load_checker_orbax``, diffco_tpu/routines.py:246). With a process
    group up every rank calls it and reads the whole state."""
    import torch.distributed.checkpoint as dcp
    dev = resolve_device(device)
    path = os.path.abspath(path)
    meta = dcp.FileSystemReader(path).read_metadata()
    state = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype,
                            device=dev)
             for k, m in meta.state_dict_metadata.items()}
    dcp.load(state, checkpoint_id=path)
    for k, v in state.items():
        if k == 'num_valid':
            checker.num_valid = int(v)
        else:
            setattr(checker, k, v)
    return checker


def save_ompl_path(path_file: str, path, times=None):
    """Write a path as whitespace-separated rows, each led by its time
    when ``times`` is given."""
    arr = path.detach().cpu().numpy() if torch.is_tensor(path) \
        else np.asarray(path)
    with open(path_file, 'w') as f:
        for i, row in enumerate(arr):
            cols = list(row)
            if times is not None:
                cols = [times[i]] + cols
            f.write(' '.join(f'{v:.8f}' for v in cols) + '\n')


def view_se3_path(path, keypoints=None, save_to=None):
    """An SE(3) path [N, 6] (x, y, z, roll, pitch, yaw) as a matplotlib 3-D
    figure (Agg backend), saved to ``save_to`` when given: the positions,
    start and goal, and with ``keypoints`` [M, 3] the body's keypoints at
    about eight of the waypoints. Returns the figure."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from .utils import euler2mat
    arr = path.detach().cpu().numpy() if torch.is_tensor(path) \
        else np.asarray(path)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection='3d')
    ax.plot(arr[:, 0], arr[:, 1], arr[:, 2], '-o', ms=2)
    ax.scatter(*arr[0, :3], c='g', s=40, label='start')
    ax.scatter(*arr[-1, :3], c='r', s=40, label='goal')
    if keypoints is not None:
        kp = keypoints.detach().cpu().numpy() if torch.is_tensor(keypoints) \
            else np.asarray(keypoints)
        for i in range(0, len(arr), max(1, len(arr) // 8)):
            R = euler2mat(torch.as_tensor(arr[i, 3:6],
                                          dtype=torch.float32)).numpy()
            pts = kp @ R.T + arr[i, :3]
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=4, alpha=0.4)
    ax.legend()
    if save_to:
        fig.savefig(save_to, dpi=110)
    return fig
