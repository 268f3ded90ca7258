"""Multi-device scale-out on ``torch.distributed`` (PyTorch counterpart of
``diffco_tpu/parallel/sharding.py``).

The JAX package drives every device from one process (GSPMD over a
``jax.sharding.Mesh``). The port is SPMD instead, one process per device
(``torchrun``): every rank calls the same function with the same global
arguments and gets the same global result. Inside, each rank works on its
block, and the blocks meet in collectives over the process groups of a
``torch.distributed.device_mesh.DeviceMesh``. The axes are the JAX
package's:

  * batch (the mesh's first axis, ``'dp'``, ``data_axis``): sweeps,
    labels, Gram rows, the greedy trainers' rows, trajectory restarts and
    problems. A rank's rows are a contiguous block of the batch padded to
    a multiple of the axis size (``row_shard``), the blocks in the order of
    the ranks in the axis's group;
  * support (``'tp'``): ``support_parallel_score_fn`` partitions the
    supports and sums the partial scores with an all-reduce.

Ranks that differ only on the other axes hold the same block and compute
it alike.

Gradients keep the SPMD contract: a replicated input's gradient is whole
on every rank and equals the unsharded one. The collectives' adjoints are
written for it (``_RowBlock`` / ``_GatherRows``, ``_CopyToGroup`` /
``_SumOverGroup``). ``torch.distributed.nn.functional``'s all_gather and
all_reduce sum the ranks' output gradients in their backward, the
convention in which each rank's loss is a different term; here every
rank's loss is the same global loss, and that sum would scale the
gradient by the group's size.

``make_mesh`` starts the process group if none is up: from ``torchrun``'s
environment, else a world-size-1 group on a ``FileStore`` in a temporary
directory, so that one process on one card gets a mesh of one.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import threading
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import fp32_matmul, resolve_device

_state = threading.local()


@contextlib.contextmanager
def rank_local():
    """Inside the block a meshed checker scores and labels the batch it is
    given on this rank alone: the optimizers run under it with a mesh,
    whose batches are the rank's own restarts or problems."""
    prev = getattr(_state, 'local', False)
    _state.local = True
    try:
        yield
    finally:
        _state.local = prev


def is_rank_local() -> bool:
    return getattr(_state, 'local', False)


def _init_group(backend: str, device_type: str):
    env = os.environ
    if device_type == 'cuda':
        torch.cuda.set_device(int(env.get('LOCAL_RANK', 0)))
    if 'RANK' in env and 'WORLD_SIZE' in env:
        dist.init_process_group(backend, init_method='env://')
    else:
        path = os.path.join(tempfile.mkdtemp(prefix='diffco_mesh_'), 'store')
        dist.init_process_group(backend, store=dist.FileStore(path, 1),
                                rank=0, world_size=1)


def make_mesh(axis_names: Sequence[str] = ('dp', 'tp'),
              shape: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` over every rank of the process group, all of them
    on the first axis unless ``shape`` says otherwise. ``device_type``
    None is CUDA (NCCL), which raises without a card; ``'cpu'`` runs on
    gloo. Starts the process group if none is up (module docstring)."""
    from torch.distributed.device_mesh import init_device_mesh
    device_type = resolve_device(device_type).type
    if not dist.is_initialized():
        _init_group('nccl' if device_type == 'cuda' else 'gloo',
                    device_type)
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != world or len(shape) != len(axis_names):
        raise ValueError(f'mesh {shape} over axes {tuple(axis_names)} != '
                         f'{world} ranks')
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


def data_axis(mesh) -> str:
    """The mesh axis batch dimensions shard over: by convention the
    first."""
    return mesh.mesh_dim_names[0]


class RowShard(NamedTuple):
    """A rank's block of a row axis of ``n_pad`` rows split over one mesh
    axis's ``group`` of ``size`` ranks: rows [offset, offset + n_local),
    the rank's ``coord`` on the axis."""
    group: object
    size: int
    coord: int
    n_pad: int
    n_local: int
    offset: int

    @property
    def rows(self) -> slice:
        return slice(self.offset, self.offset + self.n_local)

    def gather(self, t, dim: int = 0):
        """Every rank's block of ``t`` concatenated along ``dim`` (no
        gradient)."""
        return _all_gather(t, self.group, self.size, dim)

    def pad(self, x):
        """x (the axis's rows) padded with zero rows to ``n_pad``."""
        return _pad_to_multiple(x, self.size)[0]


def row_shard(mesh, n: int, axis: Optional[str] = None) -> RowShard:
    """This rank's block of n rows padded to a multiple of the size of
    ``axis`` (the data axis by default)."""
    axis = axis or data_axis(mesh)
    group = mesh.get_group(axis)
    size = dist.get_world_size(group)
    coord = dist.get_rank(group)
    n_pad = -(-int(n) // size) * size
    n_local = n_pad // size
    return RowShard(group, size, coord, n_pad, n_local, coord * n_local)


def _all_gather(t, group, size: int, dim: int = 0):
    t = t.contiguous()
    wire = t.to(torch.uint8) if t.dtype == torch.bool else t
    parts = [torch.empty_like(wire) for _ in range(size)]
    dist.all_gather(parts, wire, group=group)
    return torch.cat(parts, dim).to(t.dtype)


def _pad_to_multiple(x, m: int, axis: int = 0):
    """x padded with zeros along ``axis`` to a multiple of m: (padded, the
    original length)."""
    n = x.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], axis), n


class _RowBlock(torch.autograd.Function):
    """Forward: the rank's block of a replicated tensor's rows. Backward:
    the blocks' gradients gathered, so that the replicated input's
    gradient is whole on every rank."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x[shard.rows].clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.gather(g), None


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's block concatenated. Backward: the rank's
    block of the (replicated) output gradient."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return shard.gather(x)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.shard.rows].clone(), None


class _CopyToGroup(torch.autograd.Function):
    """Forward: identity on a tensor replicated over the group. Backward:
    the ranks' gradients summed (each rank's holds its own part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumOverGroup(torch.autograd.Function):
    """Forward: the ranks' partial tensors summed. Backward: identity (the
    replicated output gradient is each part's)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def row_block(x, shard: RowShard):
    """The rank's block of the rows of x, padded to ``shard.n_pad`` rows;
    gradients flow back whole to every rank."""
    return _RowBlock.apply(shard.pad(x), shard)


def gather_rows(x_local, shard: RowShard):
    """Every rank's block concatenated ([n_pad, ...]); gradients flow back
    to each rank's block."""
    return _GatherRows.apply(x_local, shard)


def shard_batch(x, mesh, axis: str = 'dp'):
    """The rank's block of x's rows along ``axis``, x padded to a multiple
    of the axis size."""
    x = torch.as_tensor(x)
    return row_block(x, row_shard(mesh, x.shape[0], axis))


def replicate(x, mesh):
    """x on the mesh's device type, whole on every rank."""
    dev = (torch.device('cuda', torch.cuda.current_device())
           if mesh.device_type == 'cuda' else torch.device(mesh.device_type))
    return torch.as_tensor(x, device=dev)


def sharded_score_sweep(score_fn: Callable, q, mesh, axis: str = 'dp'):
    """``score_fn`` over a large batch of configurations q [B, dof], each
    rank scoring its block of rows; the blocks are gathered and the
    padding dropped, so every rank returns score_fn's output with leading
    dim B. Differentiable in q."""
    q = torch.as_tensor(q)
    shard = row_shard(mesh, q.shape[0], axis)
    out = score_fn(row_block(q, shard))
    return gather_rows(out, shard)[:q.shape[0]]


def sharded_label_sweep(gt_fn: Callable, q, mesh, axis: str = 'dp'):
    """Ground-truth labels sharded over configurations, as
    ``sharded_score_sweep``."""
    return sharded_score_sweep(gt_fn, q, mesh, axis)


def support_parallel_score_fn(supports, weights, valid_mask, mesh,
                              axis: str = 'tp', epsilon: float = 1.0,
                              kernel_func: Optional[Callable] = None):
    """Kernel score ``k(x, S) @ w`` with the supports partitioned over
    ``axis``: each rank scores its block of supports and the partial
    scores are summed over the axis's group (the JAX package's psum).

    ``kernel_func=None`` is the polyharmonic k = 1 score with ``epsilon``
    folded into the weights; any other kernel computes its columns against
    the rank's supports (padded supports carry zero weight). Plain torch
    products in float32 (``fp32_matmul``), as the JAX package computes
    this outside any kernel. Returns x [B, F] -> [B], differentiable in
    x (the gradient summed over the axis's ranks)."""
    w = weights.reshape(-1) * valid_mask.to(weights.dtype)
    if kernel_func is None:
        w = w / epsilon
    shard = row_shard(mesh, supports.shape[0], axis)
    sup = shard.pad(supports)[shard.rows]
    w = shard.pad(w)[shard.rows]

    def fn(x):
        x = _CopyToGroup.apply(x, shard.group)
        with fp32_matmul():
            if kernel_func is None:
                x2 = torch.sum(x * x, dim=1, keepdim=True)
                s2 = torch.sum(sup * sup, dim=1, keepdim=True)
                kv = torch.sqrt(torch.clamp(x2 + s2.T - 2.0 * (x @ sup.T),
                                            min=0.0) + 1e-12)
            else:
                kv = kernel_func(x, sup)
            partial = torch.sum(kv * w[None, :], dim=1)
        return _SumOverGroup.apply(partial, shard.group)
    return fn


def local_diagonal(K_local, shard: RowShard):
    """The Gram's diagonal entries in a rank's row block [n_local, n_pad,
    ...] of it."""
    i = torch.arange(shard.n_local, device=K_local.device)
    return K_local[i, shard.offset + i]


def sharded_gram(kernel_fn: Callable, X_transformed, mesh,
                 axis: str = 'dp'):
    """K = k(X, X) [N, N]: each rank computes its row block against all
    of X, then the blocks are gathered."""
    X = torch.as_tensor(X_transformed)
    N = X.shape[0]
    shard = row_shard(mesh, N, axis)
    Xp = shard.pad(X)
    with fp32_matmul():
        K_local = kernel_fn(Xp[shard.rows], Xp)
    return shard.gather(K_local)[:N, :N]


# ---------------------------------------------------------------------------
# composed distributed steps: the single-device trainer and optimizer with
# their rows, restarts or problems sharded


def distributed_fit(kernel_fn, X_transformed, y, mesh, beta: float = 1.0,
                    max_iteration: int = 1000, rbf_kernel_fn=None,
                    init_gains=None, axis: str = 'dp'):
    """Distributed proxy fit: the greedy trainer (min-margin updates, the
    support-removal step, early stop) on a Gram whose rows are sharded
    over ``axis``, each iteration's picks combined across the ranks
    (``perceptron._train_columns``), then the RBF solve over the found
    supports: their S x S block of the Gram (of ``rbf_kernel_fn`` if
    given) gathered and solved on every rank.

    ``init_gains`` ([N]) warm-starts an active-learning update: the
    hypothesis is seeded as K @ init_gains.
    Returns (gains [N], hypothesis [N], rbf_nodes [N], iterations)."""
    from ..perceptron import _train_columns
    X = torch.as_tensor(X_transformed)
    N = X.shape[0]
    shard = row_shard(mesh, N, axis)
    Xp = shard.pad(X)
    yp = shard.pad(torch.as_tensor(y, device=X.device).reshape(-1).to(
        X.dtype))
    valid = torch.arange(shard.n_pad, device=X.device) < N
    Xl = Xp[shard.rows]
    with fp32_matmul():
        K_local = kernel_fn(Xl, Xp)
        ig = ih = None
        if init_gains is not None:
            igp = shard.pad(torch.as_tensor(init_gains, device=X.device)
                            .reshape(-1).to(X.dtype))
            ig, ih = igp[shard.rows], K_local @ igp
        gains, hyp, it = _train_columns(
            lambda idx: K_local[:, idx].T, local_diagonal(K_local, shard),
            yp[shard.rows, None], beta, int(max_iteration),
            None if ig is None else ig[:, None],
            None if ih is None else ih[:, None], valid[shard.rows],
            shard=shard)
        gains = shard.gather(gains[:, 0])
        hyp = shard.gather(hyp[:, 0])
        # the smooth surrogate over the supports: their rows of the Gram
        # (or of the RBF kernel's) against the supports, gathered
        sup = torch.nonzero((gains != 0) & valid).reshape(-1)
        cols = (K_local[:, sup] if rbf_kernel_fn is None
                else rbf_kernel_fn(Xl, Xp[sup]))
        block = shard.gather(cols)[sup]
        nodes = torch.zeros_like(yp)
        nodes[sup] = torch.linalg.solve(block, yp[sup])
    return gains[:N], hyp[:N], nodes[:N], it


def distributed_fit_lazy(kernel_func, X_transformed, y, mesh,
                         beta: float = 1.0, max_iteration: int = 1000,
                         init_gains=None, axis: str = 'dp'):
    """Distributed lazy-row fit, O(N F / ranks) memory per rank and no
    Gram anywhere: the feature rows are sharded over ``axis``; each
    iteration the picked rows' features travel with the picks (one [F]
    vector per class) and each rank computes its block of their Gram
    rows. Returns (gains [N], hypothesis [N], iterations)."""
    from ..perceptron import _row_diag, _train_columns
    X = torch.as_tensor(X_transformed)
    N = X.shape[0]
    shard = row_shard(mesh, N, axis)
    Xp = shard.pad(X)
    yp = shard.pad(torch.as_tensor(y, device=X.device).reshape(-1).to(
        X.dtype))
    valid = torch.arange(shard.n_pad, device=X.device) < N
    Xl = Xp[shard.rows]
    with fp32_matmul():
        ig = ih = None
        if init_gains is not None:
            igp = shard.pad(torch.as_tensor(init_gains, device=X.device)
                            .reshape(-1).to(X.dtype))
            nz = torch.nonzero(igp).reshape(-1)
            ig = igp[shard.rows, None]
            ih = (kernel_func(Xl, Xp[nz]) @ igp[nz])[:, None]
        gains, hyp, it = _train_columns(
            lambda feat: kernel_func(feat, Xl), _row_diag(kernel_func, Xl),
            yp[shard.rows, None], beta, int(max_iteration), ig, ih,
            valid[shard.rows], shard=shard, feats=Xl)
    return (shard.gather(gains[:, 0])[:N], shard.gather(hyp[:, 0])[:N],
            it)


def distributed_trajopt(robot_fkine, score_fn, start_cfg, target_cfg,
                        limits, mesh, n_waypoints: int = 12,
                        num_trials: Optional[int] = None, maxiter: int = 50,
                        lr: float = 0.5, safety_margin: float = 0.0,
                        max_speed: float = 1.5, dense_sub: int = 1,
                        seed: int = 0, axis: str = 'dp'):
    """The multi-restart Adam trajectory optimization
    (``optim._adam_batch_core``) with the restarts sharded over ``axis``:
    every rank draws all restarts' initial paths from the generator seeded
    ``seed`` and optimizes its block, and the best is chosen over all of
    them as the unsharded run chooses it. ``score_fn`` scores the rank's
    own paths. Returns (solution [N, dof], cost, success)."""
    from .. import optim
    start = torch.as_tensor(start_cfg, dtype=torch.float32)
    dev = start.device
    target = torch.as_tensor(target_cfg, dtype=torch.float32, device=dev)
    limits = torch.as_tensor(limits, dtype=torch.float32, device=dev)
    shard0 = row_shard(mesh, 1, axis)
    if num_trials is None:
        # the smallest multiple of the axis size that is >= 8
        num_trials = shard0.size * max(1, -(-8 // shard0.size))
    if num_trials % shard0.size:
        raise ValueError(f'num_trials {num_trials} must divide over '
                         f'{shard0.size} ranks')
    shard = row_shard(mesh, num_trials, axis)
    rand = optim._draws([torch.Generator().manual_seed(int(seed))],
                        num_trials, int(n_waypoints), start.shape[-1],
                        start.dtype, dev)
    with rank_local():
        sol, cost, success, _, _ = optim._adam_batch_core(
            start[None], target[None], limits, None,
            rand[:, shard.rows], robot_fkine, score_fn, int(n_waypoints),
            int(maxiter), float(lr), float(safety_margin), float(max_speed),
            dense_sub=int(dense_sub), trials=shard)
    return sol[0], cost[0], success[0]


# the JAX package's round-1 names
distributed_fit_step = distributed_fit
distributed_trajopt_step = distributed_trajopt
