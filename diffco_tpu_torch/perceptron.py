"""Kernel perceptrons, the learned collision proxies (PyTorch counterpart of
``diffco_tpu/perceptron.py``: the greedy trainers, ``masked_rbf_solve``,
``extract_supports``, ``Perceptron``, ``DiffCo``, ``DiffCoBeta``,
``MultiDiffCo`` and ``MultiDimDiffCo``).

The greedy min-margin trainers run as a Python loop of tensor ops that
stay on the device, over a precomputed Gram matrix or, past
``lazy_gram_threshold`` rows, over only the Gram rows each step needs
(the lazy-row trainers, O(N) memory; the same update sequence). A
finished state is a fixed point of the loop body (its update is zero), so
the loop reads its ``done`` flag back only every ``_DONE_CHECK_EVERY``
iterations and records on the device the iteration at which it first
held: the result equals that of a loop that stops at once. The scalar and
the multi-class trainers are one loop over label columns [N, C] (C = 1
for a scalar perceptron): each class takes its own greedy step per
iteration, and the loop is done when every class is. Over a dense float32
Gram on the card, without a mesh, the whole loop is one launch of
``csrc/greedy_train.cu``, bit for bit the eager loop
(``takes_train_kernel``).

Support sets are fixed-shape padded arrays with a validity mask, as in
the JAX package. ``train(update=True, exist_mask=...)`` warm-starts from
them: the previous supports' gains are seeded at their rows of the new
dataset and the hypothesis is their kernel sum, exactly (float32 products,
never TF32: the greedy picks read it).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .device import fp32_matmul
from .kernels import KernelFunc, MultiDimRQKernel, MultiQuadratic, \
    Polyharmonic, RQKernel
from .ops import _native
from .profiling import count

# iterations between host reads of the train loop's done flag
_DONE_CHECK_EVERY = 64


def _greedy_loop(step, gains, hyp, max_iteration: int):
    """Run ``step(gains, hyp) -> (gains, hyp, done)`` until ``done`` holds
    everywhere or ``max_iteration`` steps ran. Returns (gains, hyp,
    iterations), the iterations a 0-d tensor: those of a loop that stops
    right after done first holds."""
    # max_iteration until done first holds at iteration i, then i + 1.
    # Kept as a 1-element tensor so that the loop does not wait for the
    # device, except at the reads every _DONE_CHECK_EVERY iterations
    it = torch.full((1,), max_iteration, device=gains.device)
    for i in range(max_iteration):
        gains, hyp, done = step(gains, hyp)
        count('perceptron.greedy_steps')
        it = torch.where(done.all() & (it == max_iteration), i + 1, it)
        if (i + 1) % _DONE_CHECK_EVERY == 0 and bool(it < max_iteration):
            break
    return gains, hyp, it.reshape(())


def _class_picks(gains, hyp, y, target, diagK, valid):
    """Each class column's greedy choice: gains, hyp, y, target [N, C] ->
    (idx [C], delta [C], done [C]). A class takes a min-margin gain update
    if some margin is <= 0, else removes the support whose removal
    increases its own margin; it is done when neither applies (delta 0)."""
    cols = torch.arange(y.shape[1], device=y.device)
    inf = torch.tensor(float('inf'), dtype=y.dtype, device=y.device)
    margin = torch.where(valid[:, None], y * hyp, inf)
    min_i = torch.argmin(margin, dim=0)
    take_update = margin[min_i, cols] <= 0
    delta_update = (target[min_i, cols] - hyp[min_i, cols]) / diagK[min_i]
    nz = gains != 0
    modified = y * (hyp - gains * diagK[:, None]) * nz * valid[:, None]
    max_i = torch.argmax(modified, dim=0)
    removable = (modified[max_i, cols] > 0) & (torch.sum(nz, dim=0) > 1)
    take_remove = ~take_update & removable
    done = ~take_update & ~removable
    idx = torch.where(take_update, min_i, max_i)
    delta = torch.where(take_update, delta_update,
                        torch.where(take_remove, -gains[max_i, cols],
                                    torch.zeros_like(delta_update)))
    return idx, delta, done


def _combine(local, shard, key_min: int, key_max: int):
    """The ranks' candidates combined: ``local`` [K, fields] holds this
    rank's per-column candidates; every rank gathers them all ([R, K,
    fields]) and takes, per column, the fields of the rank whose field
    ``key_min`` is least and of the one whose ``key_max`` is greatest. Ties
    go to the lowest rank, whose rows come first: the pick ``torch.argmin``
    / ``argmax`` make on the whole vector. Returns (at_min, at_max, all)."""
    G = shard.gather(local[None])
    cols = torch.arange(local.shape[0], device=local.device)
    return (G[torch.argmin(G[:, :, key_min], dim=0), cols],
            G[torch.argmax(G[:, :, key_max], dim=0), cols], G)


def _scatter_local(shard, gains, idx, delta, cols=None):
    """gains[idx - offset] += delta on the rank that holds row idx (global
    indices idx [C]; ``cols`` the columns of a [N, C] gains, None for
    vector gains [N, C] taking delta [1, C])."""
    li = idx - shard.offset
    own = (li >= 0) & (li < shard.n_local)
    li = li.clamp(0, shard.n_local - 1)
    if cols is None:
        return gains.index_add(0, li, torch.where(own[:, None], delta, 0.0))
    return gains.index_put((li, cols), torch.where(own, delta, 0.0),
                           accumulate=True)


def _class_picks_sharded(gains, hyp, y, target, diagK, valid, shard,
                         feats=None):
    """``_class_picks`` over row-sharded state: each rank's local
    candidates (value, global index and the owner's target, hypothesis,
    gain and diagonal there, its count of supports, and with ``feats``
    [n, F] the candidate rows' features) combined in one gather
    (``_combine``). Returns (idx [C], delta [C], done [C], the picked
    rows' features [C, F] or None)."""
    C = y.shape[1]
    dt = y.dtype
    cols = torch.arange(C, device=y.device)
    inf = torch.tensor(float('inf'), dtype=dt, device=y.device)
    margin = torch.where(valid[:, None], y * hyp, inf)
    min_i = torch.argmin(margin, dim=0)
    nz = gains != 0
    modified = y * (hyp - gains * diagK[:, None]) * nz * valid[:, None]
    max_i = torch.argmax(modified, dim=0)
    # per column: 0-4 the min-margin pick (margin, global index, target,
    # hypothesis, diagonal), 5-7 the removal pick (modified margin, global
    # index, gain), 8 the rank's supports, then the picks' features
    fields = [margin[min_i, cols], (min_i + shard.offset).to(dt),
              target[min_i, cols], hyp[min_i, cols], diagK[min_i],
              modified[max_i, cols], (max_i + shard.offset).to(dt),
              gains[max_i, cols], torch.sum(nz, dim=0).to(dt)]
    local = torch.stack(fields, dim=1)
    if feats is not None:
        local = torch.cat([local, feats[min_i].reshape(C, -1),
                           feats[max_i].reshape(C, -1)], dim=1)
    at_min, at_max, G = _combine(local, shard, 0, 5)
    take_update = at_min[:, 0] <= 0
    delta_update = (at_min[:, 2] - at_min[:, 3]) / at_min[:, 4]
    removable = (at_max[:, 5] > 0) & (torch.sum(G[:, :, 8], dim=0) > 1)
    take_remove = ~take_update & removable
    done = ~take_update & ~removable
    idx = torch.where(take_update, at_min[:, 1], at_max[:, 6]).long()
    delta = torch.where(take_update, delta_update,
                        torch.where(take_remove, -at_max[:, 7],
                                    torch.zeros_like(delta_update)))
    feat = None
    if feats is not None:
        F = (local.shape[1] - 9) // 2
        feat = torch.where(take_update[:, None], at_min[:, 9:9 + F],
                           at_max[:, 9 + F:])
    return idx, delta, done, feat


def takes_train_kernel(K, y, max_iteration: int, init_gains=None,
                       init_hypothesis=None) -> bool:
    """Whether ``_train_columns`` runs its loop on ``csrc/greedy_train.cu``:
    a float32 CUDA Gram K [N, N] of 1 to ``_native.GREEDY_MAX_N`` rows,
    labels y [N, C] (C >= 1), 0 <= max_iteration < 2^31, and a warm start,
    if any, in float32 on K's device. The CPU, float64 and a larger N keep
    the eager loop, as do the sharded, the lazy-row and the vector-gain
    trainers, which hand ``_train_columns`` no Gram."""
    if K.dim() != 2 or y.dim() != 2:
        return False
    N = K.shape[0]
    return (K.device.type == 'cuda' and K.dtype == torch.float32
            and K.shape[1] == N == y.shape[0] and y.shape[1] >= 1
            and 1 <= N <= _native.GREEDY_MAX_N
            and 0 <= max_iteration < 2 ** 31
            and all(t is None or (t.dtype == torch.float32
                                  and t.device == K.device)
                    for t in (init_gains, init_hypothesis)))


def _train_kernel(K, y, beta: float, max_iteration: int, init_gains=None,
                  init_hypothesis=None, valid_mask=None):
    """``_train_columns``' eager loop on ``csrc/greedy_train.cu``: every
    iteration of every label column (a block a column) in one launch on
    the current stream, the same gains, hypothesis and iterations. The
    iterations are read back once, for the counter
    ``perceptron.greedy_steps``, and returned as a 0-d tensor on the host;
    the launch counts one in ``launches.greedy_train``
    (``_native.launch``)."""
    N, C = y.shape
    K, y = K.contiguous(), y.contiguous()
    g0, h0 = (None if t is None else t.reshape(N, C).contiguous()
              for t in (init_gains, init_hypothesis))
    _native.check_cuda_inputs('greedy_train', K, y,
                              *(t for t in (g0, h0) if t is not None))
    valid = None
    if valid_mask is not None:
        valid = valid_mask.reshape(-1).to(torch.bool).contiguous()
        if valid.device != K.device or valid.shape != (N,):
            raise ValueError(f'greedy_train: valid_mask {tuple(valid.shape)}'
                             f' on {valid.device} for {N} rows on '
                             f'{K.device}')
    gains, hyp = torch.empty_like(y), torch.empty_like(y)
    iters = torch.empty(C, dtype=torch.int64, device=K.device)
    _native.launch(
        'greedy_train', 'greedy_train', K.data_ptr(), y.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (g0, h0, valid)),
        N, C, beta, max_iteration, gains.data_ptr(), hyp.data_ptr(),
        iters.data_ptr(), torch.cuda.current_stream(K.device).cuda_stream)
    n = max(iters.tolist())
    count('perceptron.greedy_steps', n)
    return gains, hyp, torch.tensor(n)


def _train_columns(rows, diagK, y, beta: float, max_iteration: int,
                   init_gains=None, init_hypothesis=None, valid_mask=None,
                   shard=None, feats=None, gram=None):
    """Greedy training of every label column of y [N, C] over one Gram:
    ``rows(idx [C])`` returns the Gram rows [C, N] a step needs (gathered
    from K, or computed lazily). Each iteration folds either update into
    one scatter-add + axpy per class::

        gains[idx_c, c] += delta_c;  hyp[:, c] += delta_c * K[idx_c]

    ``gram``: the dense Gram K [N, N] that ``rows`` gathers from (and
    ``diagK`` is the diagonal of), where the caller holds it; without a
    shard the loop then runs on its kernel where ``takes_train_kernel``.

    With ``shard`` (``parallel.sharding.RowShard``) every row argument is
    this rank's block of the rows, and each iteration's picks are combined
    across the ranks (``_class_picks_sharded``): ``rows(idx)`` then
    returns the rank's block [C, n] of the picked rows (the Gram's
    symmetric columns ``K_local[:, idx]``), or, with ``feats`` (the
    rank's feature rows, lazy training), ``rows(features [C, F])`` of the
    picked rows' features, which travel with the picks."""
    N, C = y.shape
    dt, dev = diagK.dtype, diagK.device
    y = y.to(dt)
    if gram is not None and shard is None and takes_train_kernel(
            gram, y, max_iteration, init_gains, init_hypothesis):
        return _train_kernel(gram, y, beta, max_iteration, init_gains,
                             init_hypothesis, valid_mask)
    target = torch.where(y > 0, torch.full_like(y, beta),
                         torch.full_like(y, -1.0))
    valid = (torch.ones(N, dtype=torch.bool, device=dev) if valid_mask is None
             else valid_mask.reshape(-1).to(torch.bool))
    gains = (torch.zeros(N, C, dtype=dt, device=dev) if init_gains is None
             else init_gains.reshape(N, C).clone())
    hyp = (torch.zeros(N, C, dtype=dt, device=dev) if init_hypothesis is None
           else init_hypothesis.reshape(N, C).clone())
    cols = torch.arange(C, device=dev)

    def step(gains, hyp):
        if shard is None:
            idx, delta, done = _class_picks(gains, hyp, y, target, diagK,
                                            valid)
            gains = gains.index_put((idx, cols), delta, accumulate=True)
            return gains, hyp + rows(idx).T * delta, done
        idx, delta, done, feat = _class_picks_sharded(
            gains, hyp, y, target, diagK, valid, shard, feats)
        gains = _scatter_local(shard, gains, idx, delta, cols)
        kr = rows(idx if feat is None else feat.reshape(
            (C,) + feats.shape[1:]))
        return gains, hyp + kr.T * delta, done

    return _greedy_loop(step, gains, hyp, max_iteration)


def _row_diag(kernel_func, Xt):
    """k(x_i, x_i) for every row of Xt without the Gram: [N], or [N, C]
    for a vector-valued kernel."""
    return torch.func.vmap(lambda r: kernel_func(r[None], r[None])[0, 0])(Xt)


def _lazy_rows(kernel_func, Xt):
    return lambda idx: kernel_func(Xt[idx], Xt)


def _column(a):
    return None if a is None else a.reshape(-1, 1)


def perceptron_train_loop(K, y, beta: float, max_iteration: int,
                          init_gains=None, init_hypothesis=None,
                          valid_mask=None):
    """Greedy kernel-perceptron training over the Gram K [N, N].

    Each iteration performs either a min-margin gain update or a
    redundant-support removal, folded into one scatter-add + axpy::

        idx   = min-margin index if margin <= 0 else removal index
        delta = gain correction  if margin <= 0 else -gains[idx]
        gains[idx] += delta;  hypothesis += delta * K[idx]

    ``valid_mask`` (bool [N]) marks real rows. Returns
    (gains, hypothesis, iterations) with iterations a 0-d tensor.
    """
    gains, hyp, it = _train_columns(
        lambda idx: K[idx], torch.diagonal(K), y.reshape(-1, 1), beta,
        max_iteration, _column(init_gains), _column(init_hypothesis),
        valid_mask, gram=K)
    return gains[:, 0], hyp[:, 0], it


def perceptron_train_loop_lazy(Xt, y, kernel_func, beta: float,
                               max_iteration: int, init_gains=None,
                               init_hypothesis=None, valid_mask=None):
    """``perceptron_train_loop`` with lazy kernel rows, O(N) memory: the
    [N, N] Gram is never built; each iteration computes the one row it
    needs, ``k(x_idx, X)``, as a [1, F] x [F, N] product."""
    N = y.shape[0]
    Xt = Xt.reshape(N, -1)
    gains, hyp, it = _train_columns(
        _lazy_rows(kernel_func, Xt), _row_diag(kernel_func, Xt),
        y.reshape(-1, 1), beta, max_iteration, _column(init_gains),
        _column(init_hypothesis), valid_mask)
    return gains[:, 0], hyp[:, 0], it


def _check_classes(y, num_class: int):
    if y.dim() != 2 or y.shape[1] != num_class:
        raise ValueError(f'labels must be [N, {num_class}], got '
                         f'{tuple(y.shape)}')


def multiclass_train_loop(K, y, beta: float, max_iteration: int,
                          num_class: int, init_gains=None,
                          init_hypothesis=None, valid_mask=None):
    """Per-class greedy updates over one shared Gram K [N, N]; labels,
    gains and hypothesis are [N, num_class], and every class advances one
    step per iteration. Returns (gains, hypothesis, iterations)."""
    _check_classes(y, num_class)
    return _train_columns(lambda idx: K[idx], torch.diagonal(K), y, beta,
                          max_iteration, init_gains, init_hypothesis,
                          valid_mask, gram=K)


def multiclass_train_loop_lazy(Xt, y, kernel_func, beta: float,
                               max_iteration: int, num_class: int,
                               init_gains=None, init_hypothesis=None,
                               valid_mask=None):
    """Lazy-row ``multiclass_train_loop``, O(N * C) memory: each iteration
    computes exactly the num_class Gram rows it needs as one [C, F] x
    [F, N] product."""
    _check_classes(y, num_class)
    Xt = Xt.reshape(y.shape[0], -1)
    return _train_columns(_lazy_rows(kernel_func, Xt),
                          _row_diag(kernel_func, Xt), y, beta, max_iteration,
                          init_gains, init_hypothesis, valid_mask)


def _vector_picks_sharded(gains, hyp, y, target, diagK, valid, shard,
                          feats=None):
    """The vector-gain step's picks over row-sharded state, combined as
    ``_class_picks_sharded`` combines a column's (diagK [n, C], feats [n,
    M, d]). Returns (min-margin fields, removal fields, supports in all,
    picked rows' features or None): the fields are [1, k] rows of
    (value, global index, target, hypothesis, diagonal [C] or gains [C])."""
    dt = y.dtype
    inf = torch.tensor(float('inf'), dtype=dt, device=y.device)
    margin = torch.where(valid, y * hyp, inf)
    min_i = torch.argmin(margin)
    nonzero = torch.any(gains != 0, dim=-1)
    modified = y * (hyp - torch.sum(diagK * gains, dim=-1)) * nonzero * valid
    max_i = torch.argmax(modified)
    C = diagK.shape[1]
    # 0-3 the min-margin pick (margin, global index, target, hypothesis),
    # 4-5 the removal pick (modified margin, global index), 6 the rank's
    # supports, then the diagonal [C] at the first and the gains [C] at
    # the second, then the picks' features
    head = torch.stack([margin[min_i], (min_i + shard.offset).to(dt),
                        target[min_i], hyp[min_i], modified[max_i],
                        (max_i + shard.offset).to(dt),
                        torch.sum(nonzero).to(dt)])
    parts = [head, diagK[min_i], gains[max_i]]
    if feats is not None:
        parts += [feats[min_i].reshape(-1), feats[max_i].reshape(-1)]
    local = torch.cat(parts)[None]
    at_min, at_max, G = _combine(local, shard, 0, 4)
    count = torch.sum(G[:, 0, 6])
    feat = None
    if feats is not None:
        F = feats[0].numel()
        o = 7 + 2 * C
        feat = (at_min[0, o:o + F], at_max[0, o + F:])
    return at_min, at_max, count, feat


def _train_vector_gains(rows, diagK, y, beta: float, max_iteration: int,
                        init_gains=None, init_hypothesis=None,
                        valid_mask=None, shard=None, feats=None):
    """Vector-gain greedy training (``MultiDimDiffCo``): gains [N, C],
    hypothesis h_i = sum_j K[i, j] . g_j [N]; ``rows(idx [1])`` returns
    the vector Gram row [1, N, C]. The min-margin update uses the rank-1
    pseudo-inverse of the diagonal kernel vector,
    delta = (target - h_i) * K_ii / ||K_ii||^2.

    ``shard`` and ``feats`` (the rank's [n, M, d] feature rows, lazy
    training) as in ``_train_columns``: ``rows`` then returns the rank's
    block [1, n, C] of the picked row, from its global index or from its
    features [1, M, d]."""
    N, C = diagK.shape
    dt, dev = diagK.dtype, diagK.device
    y = y.reshape(-1).to(dt)
    target = torch.where(y > 0, torch.full_like(y, beta),
                         torch.full_like(y, -1.0))
    valid = (torch.ones(N, dtype=torch.bool, device=dev) if valid_mask is None
             else valid_mask.reshape(-1).to(torch.bool))
    gains = (torch.zeros(N, C, dtype=dt, device=dev) if init_gains is None
             else init_gains.clone())
    hyp = (torch.zeros(N, dtype=dt, device=dev) if init_hypothesis is None
           else init_hypothesis.clone())
    inf = torch.tensor(float('inf'), dtype=dt, device=dev)

    def step_sharded(gains, hyp):
        C = diagK.shape[1]
        at_min, at_max, count, feat = _vector_picks_sharded(
            gains, hyp, y, target, diagK, valid, shard, feats)
        take_update = at_min[:, 0] <= 0
        k_ii = at_min[:, 7:7 + C]                                # [1, C]
        inv_k = k_ii / torch.clamp(torch.sum(k_ii ** 2), min=1e-12)
        delta_vec = (at_min[:, 2] - at_min[:, 3])[:, None] * inv_k
        removable = (at_max[:, 4] > 0) & (count > 1)
        take_remove = ~take_update & removable
        done = ~take_update & ~removable
        idx = torch.where(take_update, at_min[:, 1], at_max[:, 5]).long()
        delta = torch.where(take_update[:, None], delta_vec,
                            torch.where(take_remove[:, None],
                                        -at_max[:, 7 + C:7 + 2 * C],
                                        torch.zeros_like(delta_vec)))
        gains = _scatter_local(shard, gains, idx, delta)
        kr = rows(idx if feat is None else torch.where(
            take_update, feat[0], feat[1]).reshape((1,) + feats.shape[1:]))
        return gains, hyp + kr[0] @ delta[0], done

    def step(gains, hyp):
        if shard is not None:
            return step_sharded(gains, hyp)
        margin = torch.where(valid, y * hyp, inf)
        min_i = torch.argmin(margin).reshape(1)
        take_update = margin[min_i] <= 0
        k_ii = diagK[min_i]                                   # [1, C]
        inv_k = k_ii / torch.clamp(torch.sum(k_ii ** 2), min=1e-12)
        delta_vec = (target[min_i] - hyp[min_i])[:, None] * inv_k
        delta_h = torch.sum(diagK * gains, dim=-1)
        nonzero = torch.any(gains != 0, dim=-1)
        modified = y * (hyp - delta_h) * nonzero * valid
        max_i = torch.argmax(modified).reshape(1)
        removable = (modified[max_i] > 0) & (torch.sum(nonzero) > 1)
        take_remove = ~take_update & removable
        done = ~take_update & ~removable
        idx = torch.where(take_update, min_i, max_i)
        delta = torch.where(take_update[:, None], delta_vec,
                            torch.where(take_remove[:, None], -gains[max_i],
                                        torch.zeros_like(delta_vec)))
        gains = gains.index_add(0, idx, delta)
        return gains, hyp + rows(idx)[0] @ delta[0], done

    return _greedy_loop(step, gains, hyp, max_iteration)


def multidim_train_loop(K, y, beta: float, max_iteration: int,
                        init_gains=None, init_hypothesis=None,
                        valid_mask=None):
    """Vector-gain greedy training over the [N, N, C] vector-valued Gram
    tensor. Returns (gains [N, C], hypothesis [N], iterations)."""
    N = K.shape[0]
    ar = torch.arange(N, device=K.device)
    return _train_vector_gains(lambda idx: K[idx], K[ar, ar], y, beta,
                               max_iteration, init_gains, init_hypothesis,
                               valid_mask)


def multidim_train_loop_lazy(Xt, y, kernel_func, beta: float,
                             max_iteration: int, init_gains=None,
                             init_hypothesis=None, valid_mask=None):
    """Lazy-row ``multidim_train_loop``, O(N * C) memory: Xt [N, M, d]
    per-control-point features; each iteration computes the one vector
    Gram row it needs, ``k(x_idx, X)`` [N, C]."""
    return _train_vector_gains(_lazy_rows(kernel_func, Xt),
                               _row_diag(kernel_func, Xt), y, beta,
                               max_iteration, init_gains, init_hypothesis,
                               valid_mask)


def masked_rbf_solve(kmat, y, valid_mask, reg: float = 0.0):
    """Solve K w = y restricted to ``valid_mask`` rows/cols of a padded
    system; invalid entries yield w = 0 (padding rows become identity)."""
    m = valid_mask.to(kmat.dtype)
    A = kmat * m[:, None] * m[None, :]
    A = A + torch.diag(1.0 - m) + reg * torch.eye(
        kmat.shape[0], dtype=kmat.dtype, device=kmat.device)
    b = y * m if y.dim() == 1 else y * m[:, None]
    return torch.linalg.solve(A, b)


def extract_supports(gains, S: int):
    """Rank points by |gain| and build a fixed-size support selection.

    Returns (indices [S], valid_mask [S], num_valid 0-d tensor). Keeps the
    largest |gain| points; at least 2 slots are valid so the polyharmonic
    solve stays nonsingular."""
    flat = torch.abs(gains) if gains.dim() == 1 else torch.abs(gains).sum(1)
    count = torch.sum(flat != 0)
    order = torch.argsort(-flat, stable=True)
    if S > order.shape[0]:
        order = torch.cat([order, order[-1:].expand(S - order.shape[0])])
    idx = order[:S]
    num_valid = torch.clamp(count, 2, min(S, flat.shape[0]))
    valid = torch.arange(S, device=gains.device) < num_valid
    return idx, valid, num_valid


class Perceptron:
    """Base class: the padded support state shared by every proxy.

    With a ``mesh`` (``parallel.make_mesh``: a torch.distributed
    DeviceMesh) training scales out over its first axis, SPMD: every rank
    calls ``train`` with the same dataset, holds its block of the rows of
    the Gram (or of the features, on the lazy path), and each iteration's
    picks are combined across the ranks (``_train_columns``,
    ``_train_vector_gains``), so every rank ends with the unsharded run's
    gains and supports."""

    # support sets are padded to a multiple of this many rows
    _pad_multiple = 128

    def __init__(self):
        self.support_points = None
        self.mesh = None

    # -- mesh plumbing (DiffCo, MultiDiffCo and MultiDimDiffCo) -------------

    def _mesh_train_inputs(self, Xt, y, lazy):
        """The trainer's inputs for ``train``: (rows, diagK, y, valid, K,
        shard, feats). Without a mesh the Gram K (dense) or its lazy rows;
        with one this rank's block of the padded rows (``shard``), its row
        block of the Gram on the dense path and its feature rows (``feats``)
        on the lazy path, whose picked rows' features travel with the
        picks. Vector kernels ([N, N, C] Grams) take their rows as
        [1, n, C]."""
        vector = Xt.dim() == 3
        if self.mesh is None:
            if lazy:
                return (_lazy_rows(self.kernel_func, Xt),
                        _row_diag(self.kernel_func, Xt), y, None, None, None,
                        None)
            K = self.kernel_func(Xt, Xt)
            ar = torch.arange(K.shape[0], device=K.device)
            return ((lambda idx: K[idx]), K[ar, ar], y, None, K, None, None)
        from .parallel import sharding
        shard = sharding.row_shard(self.mesh, Xt.shape[0])
        Xp = shard.pad(Xt)
        yl = shard.pad(y)[shard.rows]
        valid = (torch.arange(shard.n_pad, device=Xt.device)
                 < Xt.shape[0])[shard.rows]
        Xl = Xp[shard.rows]
        if lazy:
            return ((lambda feat: self.kernel_func(feat, Xl)),
                    _row_diag(self.kernel_func, Xl), yl, valid, None, shard,
                    Xl)
        K_local = self.kernel_func(Xl, Xp)
        rows = ((lambda idx: K_local[:, idx].transpose(0, 1)) if vector
                else (lambda idx: K_local[:, idx].T))
        return (rows, sharding.local_diagonal(K_local, shard), yl, valid,
                K_local, shard, None)

    def _mesh_warm_start(self, Xt, K, shard, init_gains, vg, einsum):
        """The warm start's (gains, hypothesis) for the trainer: the
        hypothesis K @ gains from the Gram (its row block with a mesh) or,
        without one, from the cross-Gram against the support buffer
        (padded rows carry zero gain); with a mesh both cut to the rank's
        rows."""
        N = init_gains.shape[0]
        if K is not None:
            hyp = einsum(K[:, :N], init_gains)
        else:
            X = Xt if shard is None else shard.pad(Xt)[shard.rows]
            hyp = einsum(self.kernel_func(X, self.support_transformed), vg)
        if shard is None:
            return init_gains, hyp
        return shard.pad(init_gains)[shard.rows], hyp

    def _pad_size(self, count: int) -> int:
        if self.max_num_supports is not None:
            return self.max_num_supports
        # next multiple >= count, never below a previous pad size
        size = max(self._pad_multiple,
                   int(np.ceil(count / self._pad_multiple))
                   * self._pad_multiple)
        prev = (0 if self.support_points is None
                else self.support_points.shape[0])
        return max(size, prev)

    @property
    def valid_supports(self):
        return self.num_valid

    def _prev_gains(self, exist_mask, N: int):
        """The warm start's gains: (prev [N, C], vg [S, C]) with vg the
        valid supports' gains (padded rows 0) and prev vg scattered to the
        rows ``exist_mask`` marks, by position. The marked rows must come
        in the support buffer's order (``extract_supports``'s, as
        ``RBFDiffCo.update`` appends them)."""
        if exist_mask is None:
            raise ValueError('update=True requires exist_mask')
        g = self.gains.reshape(self.gains.shape[0], -1)
        exist_idx = torch.nonzero(torch.as_tensor(
            exist_mask, device=g.device)).reshape(-1)
        vg = g * self.valid_mask.to(g.dtype)[:, None]
        prev = g.new_zeros((N, g.shape[1]))
        prev[exist_idx] = vg[:exist_idx.shape[0]]
        return prev, vg

    def _select_supports(self, X, Xt, gains, hyp, y, dist, K):
        """Compact to the fixed-size padded support set. ``K`` is None
        after lazy-row training: the support Gram is then recomputed from
        the kept rows. Support rows are counted, not nonzero gains, so
        that [N, C] gains do not inflate the pad size."""
        count = int(torch.sum(gains != 0) if gains.dim() == 1
                    else torch.sum(torch.any(gains != 0, dim=-1)))
        S = self._pad_size(max(count, 2))
        idx, valid, num_valid = extract_supports(gains, S)
        vf = valid.to(Xt.dtype)

        def take(a):
            return a[idx] * vf.reshape((S,) + (1,) * (a.dim() - 1)).to(
                a.dtype)

        self.support_points = take(X)
        self.support_transformed = take(Xt)
        self.gains = take(gains)
        self.hypothesis = take(hyp)
        self.y = take(y.to(Xt.dtype))
        self.distance = take(dist) if dist is not None else None
        if K is None:
            with fp32_matmul():
                km = self.kernel_func(self.support_transformed,
                                      self.support_transformed)
        else:
            km = K[idx][:, idx]
        pair = vf[:, None] * vf[None, :]
        self.kernel_matrix = km * pair.reshape(pair.shape
                                               + (1,) * (km.dim() - 2))
        self.valid_mask = valid
        self.num_valid = int(num_valid)
        self.rbf_nodes = torch.zeros(S, dtype=Xt.dtype, device=Xt.device)
        if count > S:
            # top-S truncation breaks hypothesis == K @ gains; recompute it
            # over the kept supports
            with fp32_matmul():
                self.hypothesis = (
                    torch.einsum('ijc,jc->i', self.kernel_matrix, self.gains)
                    if self.kernel_matrix.dim() == 3
                    else self.kernel_matrix @ self.gains)

    def _target_values(self, target):
        if target == 'hypo':
            return self.hypothesis
        if 'dist' in target:
            return self.distance
        return self.y

    def score(self, point):
        raise NotImplementedError

    def is_collision(self, point):
        return self.score(point) > 0

    def line_predict(self, start, target, res=50):
        """Whether any of ``res`` evenly spaced points of the straight
        segment start -> target scores as a collision."""
        ts = torch.linspace(0.0, 1.0, res, dtype=start.dtype,
                            device=start.device)
        pts = start[None] + ts[:, None] * (target - start)[None]
        return bool(torch.any(self.score(pts) > 0))

    def __call__(self, *args, **kwargs):
        return self.predict(*args, **kwargs)


class DiffCo(Perceptron):
    """Binary kernel-perceptron collision proxy. ``train`` / ``fit_poly``
    populate fixed-shape padded state on the device of the training data;
    ``score_original`` / ``poly_score`` are functions of (state, query)."""

    def __init__(self, kernel_func='rq', gamma=1, beta=1,
                 transform: Optional[Callable] = None,
                 max_batch_size=None, max_num_supports: Optional[int] = None,
                 mesh=None):
        super().__init__()
        self.mesh = mesh
        self.kernel_func = (RQKernel(gamma) if kernel_func == 'rq'
                            else kernel_func)
        self.beta = float(beta)
        self.transform = transform
        self.max_num_supports = max_num_supports  # None -> auto pad
        # rows above which train() switches to the lazy-row trainer
        self.lazy_gram_threshold = 16384

        self.support_points = None       # [S, dof]
        self.support_transformed = None  # [S, F]
        self.gains = None                # [S] ([S, C] multi-class)
        self.hypothesis = None           # [S] ([S, C])
        self.y = None                    # [S] ([S, C])
        self.distance = None             # [S] or None
        self.kernel_matrix = None        # [S, S]
        self.rbf_nodes = None            # [S] ([S, C])
        self.valid_mask = None           # bool [S]
        self.num_valid = 0
        self.rbf_kernel = None
        self.train_iterations = None

    def _apply_transform(self, X):
        Xt = X if self.transform is None else self.transform(X)
        return Xt.reshape(Xt.shape[0], -1)

    # -- training ---------------------------------------------------------

    def train(self, X, y, update=False, exist_mask=None, max_iteration=1000,
              method='original', distance=None, verbose=False):
        """Training over the dense Gram of the transformed X up to
        ``lazy_gram_threshold`` rows, over lazy Gram rows past it.
        ``update=True`` warm-starts from the current supports, whose rows
        of X ``exist_mask`` marks (``_prev_gains``); without supports yet
        it starts cold."""
        del method
        self._train(X, y.reshape(-1), max_iteration,
                    distance.reshape(-1) if distance is not None else None,
                    verbose, update, exist_mask)

    def _train(self, X, y, max_iteration, distance, verbose, update=False,
               exist_mask=None):
        """Train on labels y [N] or [N, C] and select the supports."""
        N = X.shape[0]
        Xt = self._apply_transform(X)
        yc = y.reshape(N, -1).to(Xt.dtype)
        init_gains = init_hyp = None
        with fp32_matmul():
            rows, diagK, y_train, valid, K, shard, feats = \
                self._mesh_train_inputs(Xt, yc, N > self.lazy_gram_threshold)
            if update and self.gains is not None:
                init_gains, vg = self._prev_gains(exist_mask, N)
                init_gains, init_hyp = self._mesh_warm_start(
                    Xt, K, shard, init_gains, vg, torch.matmul)
            gains, hyp, it = _train_columns(rows, diagK, y_train, self.beta,
                                            int(max_iteration), init_gains,
                                            init_hyp, valid, shard, feats,
                                            gram=K)
        if shard is not None:
            gains, hyp = shard.gather(gains)[:N], shard.gather(hyp)[:N]
            K = None   # the support Gram is recomputed from the kept rows
        gains, hyp = gains.reshape(y.shape), hyp.reshape(y.shape)
        self.train_iterations = int(it)
        if verbose:
            acc = float(torch.mean(((hyp > 0) == (y > 0)).float()))
            print(f'{type(self).__name__} training ended at iteration '
                  f'{self.train_iterations}, ACC {acc:.4f}')
        self._select_supports(X, Xt, gains, hyp, y, distance, K)

    # -- smooth surrogate -------------------------------------------------

    def fit_poly(self, kernel_func: Optional[KernelFunc] = None,
                 target='hypo', reg: float = 0.0):
        """Fit the smooth RBF surrogate over the supports."""
        if target != 'hypo' and 'dist' not in target and \
                'label' not in target:
            raise ValueError(f'unknown target {target}')
        self.rbf_kernel = (Polyharmonic(k=1, epsilon=1)
                           if kernel_func is None else kernel_func)
        with fp32_matmul():
            kmat = self.rbf_kernel(self.support_transformed,
                                   self.support_transformed)
            self.rbf_nodes = masked_rbf_solve(
                kmat, self._target_values(target), self.valid_mask, reg=reg)

    def fit_full_poly(self, epsilon=1, k=2, lmbd=0, target='hypo'):
        """Polyharmonic + linear-tail interpolation over the valid
        supports: solves [[Phi, X, 1], [X^T, 0, 0], [1^T, 0, 0]] nodes =
        [y, 0, 0]. [S, C] targets (``MultiDiffCo``) give [S + F + 1, C]
        nodes."""
        self.poly_kernel = Polyharmonic(k=k, epsilon=epsilon)
        X = self.support_transformed
        S, F = X.shape
        m = self.valid_mask.to(X.dtype)
        with fp32_matmul():
            phi = self.poly_kernel(X, X) * m[:, None] * m[None, :]
        phi = phi + torch.diag(lmbd * m + (1.0 - m))
        Xm = X * m[:, None]
        ones = m.reshape(-1, 1)
        L = torch.cat([torch.cat([phi, Xm, ones], 1),
                       torch.cat([Xm.T, X.new_zeros(F, F + 1)], 1),
                       torch.cat([ones.T, X.new_zeros(1, F + 1)], 1)], 0)
        # regularize the (singular-prone) tail block minimally
        L = L + 1e-8 * torch.eye(L.shape[0], dtype=X.dtype, device=X.device)
        yv = self._target_values(target)
        b = torch.cat([yv * m.reshape((S,) + (1,) * (yv.dim() - 1)),
                       X.new_zeros((F + 1,) + yv.shape[1:])], 0)
        with fp32_matmul():
            self.poly_nodes = torch.linalg.solve(L, b)

    # -- inference --------------------------------------------------------

    def _fk_robot(self):
        """The robot whose ``fkine`` is this perceptron's transform, or
        None (the one-pass FK + score routes need it)."""
        robot = getattr(self.transform, '__self__', None)
        if robot is not None and getattr(robot, 'fkine', None) == \
                self.transform:
            return robot
        return None

    def _kernel_matvec(self, kernel_func, pt, nodes):
        with fp32_matmul():
            kv = kernel_func(pt, self.support_transformed)
            kv = kv * self.valid_mask.to(kv.dtype)[None, :]
            return kv @ nodes

    def poly_score(self, point=None, transformed_point=None):
        """Smooth surrogate score [B, 1].

        Differentiation contract: gradients w.r.t. the QUERY only. For a
        float32 CUDA batch >= ops.fk_score._FK_FUSED_MIN_BATCH
        (configurations of a DH or URDF robot) or >=
        ops.fused_score._FUSED_MIN_BATCH (points) the score runs through
        one-pass autograd Functions that treat the trained state as
        constants (zero cotangents, no forward mode); below the gates, on
        the CPU and in float64 the route is differentiable in every
        argument."""
        is_poly1 = (isinstance(self.rbf_kernel, Polyharmonic)
                    and self.rbf_kernel.k == 1)
        if transformed_point is None:
            point = torch.atleast_2d(point)
            robot = self._fk_robot() if is_poly1 else None
            if robot is not None:
                # FK + score + configuration gradient in one pass per
                # batch at large batch
                from .ops.fk_score import fk_polyharmonic_score_auto
                return fk_polyharmonic_score_auto(
                    point, robot, self.support_transformed, self.rbf_nodes,
                    self.valid_mask, epsilon=self.rbf_kernel.epsilon)
            pt = self._apply_transform(point)
        else:
            pt = transformed_point.reshape(transformed_point.shape[0], -1)
        if is_poly1:
            from .ops.fused_score import polyharmonic_score
            return polyharmonic_score(pt, self.support_transformed,
                                      self.rbf_nodes, self.valid_mask,
                                      epsilon=self.rbf_kernel.epsilon)
        return self._kernel_matvec(self.rbf_kernel, pt,
                                   self.rbf_nodes.reshape(-1, 1))

    def full_poly_score(self, point):
        """[B, 1] for DiffCo; [B, C] for MultiDiffCo."""
        pt = self._apply_transform(torch.atleast_2d(point))
        m = self.valid_mask.to(pt.dtype)
        nodes = (self.poly_nodes.reshape(-1, 1) if self.poly_nodes.dim() == 1
                 else self.poly_nodes)
        with fp32_matmul():
            phi = self.poly_kernel(pt, self.support_transformed) * m[None, :]
            phi_x = torch.cat([phi, pt, pt.new_ones(pt.shape[0], 1)], 1)
            return phi_x @ nodes

    def score_original(self, point):
        """Raw perceptron score k(phi(q), supports) @ gains."""
        pt = self._apply_transform(torch.atleast_2d(point))
        return self._kernel_matvec(self.kernel_func, pt, self.gains)

    def score(self, point):
        return self.score_original(point)

    def predict(self, point):
        return (self.score(point) > 0) * 2 - 1


class DiffCoBeta(DiffCo):
    """Distance-regressing variant: the perceptron picks the support set,
    then a regularized RBF solve regresses the signed distance."""

    def __init__(self, kernel_func='rq', rbf_kernel=None, gamma=1, beta=1,
                 transform=None, max_num_supports=None, mesh=None):
        super().__init__(kernel_func=kernel_func, gamma=gamma, beta=beta,
                         transform=transform,
                         max_num_supports=max_num_supports, mesh=mesh)
        self.rbf_kernel = (Polyharmonic(k=1, epsilon=1)
                           if rbf_kernel is None else rbf_kernel)

    def train(self, X, d, max_iteration=1000, n_left_out_points=100,
              dtol=1e-4, keep_all=False, verbose=False):
        """Train labels (d >= 0) on X[:-n], then regress the distances d
        over the valid supports + the n left-out points X[-n:]."""
        del dtol, keep_all
        d = d.reshape(-1)
        # clamp so small datasets keep at least 2 perceptron training rows
        n = int(min(n_left_out_points, max(X.shape[0] - 2, 0)))
        if n == 0:
            raise ValueError(
                f'DiffCoBeta.train needs > 2 samples, got {X.shape[0]}')
        X_head, d_head = X[:-n], d[:-n]
        labels = (d_head >= 0).to(d.dtype) * 2.0 - 1.0
        super().train(X_head, labels, max_iteration=max_iteration,
                      distance=d_head, verbose=verbose)
        nv = self.num_valid
        self.train_distance(torch.cat([self.support_points[:nv], X[-n:]]),
                            torch.cat([self.distance[:nv], d[-n:]]))

    def train_distance(self, X, d):
        """Solve (K + 0.1 I) alpha = d over the regression set."""
        Xt = self._apply_transform(X)
        n = X.shape[0]
        S = self._pad_size(n)

        def pad(a):
            return torch.cat([a, a.new_zeros((S - n,) + a.shape[1:])])

        self.support_points = pad(X)
        self.support_transformed = pad(Xt)
        self.distance = pad(d)
        self.valid_mask = torch.arange(S, device=X.device) < n
        self.num_valid = int(n)
        with fp32_matmul():
            self.kernel_matrix = self.rbf_kernel(self.support_transformed,
                                                 self.support_transformed)
            self.gains = masked_rbf_solve(self.kernel_matrix, self.distance,
                                          self.valid_mask, reg=0.1)
        self.rbf_nodes = self.gains
        self.hypothesis = pad(self.rbf_score(
            self.support_points[:n]).reshape(-1))
        self.y = torch.sign(self.distance)

    def rbf_score(self, point):
        pt = self._apply_transform(torch.atleast_2d(point))
        return self._kernel_matvec(self.rbf_kernel, pt,
                                   self.rbf_nodes.reshape(-1, 1))


class MultiDiffCo(DiffCo):
    """Multi-class perceptron: per-class gains [S, C] over one shared
    support set (one class per obstacle class, labels [N, C])."""

    def __init__(self, kernel_func='rq', gamma=1, beta=1, transform=None,
                 max_num_supports=None, mesh=None):
        super().__init__(kernel_func=kernel_func, gamma=gamma, beta=beta,
                         transform=transform,
                         max_num_supports=max_num_supports, mesh=mesh)
        self.num_class = None

    def train(self, X, y, update=False, exist_mask=None, max_iteration=1000,
              method='original', distance=None, verbose=False):
        """``DiffCo.train`` on labels [N, num_class]; a warm start seeds
        the [S, C] gains."""
        del method
        if y.dim() != 2:
            raise ValueError('MultiDiffCo expects labels [N, num_class]')
        self.num_class = y.shape[1]
        self._train(X, y, max_iteration, distance, verbose, update,
                    exist_mask)

    def fit_poly(self, kernel_func=None, target='hypo', reg: float = 0.0):
        """Per-class masked solve over the shared supports: class c solves
        only over the supports with a nonzero class-c gain (the others'
        rows and columns become identity, their nodes 0)."""
        self.rbf_kernel = (MultiQuadratic(1) if kernel_func is None
                           else kernel_func)
        yv = self._target_values(target)
        with fp32_matmul():
            kmat = self.rbf_kernel(self.support_transformed,
                                   self.support_transformed)
            self.rbf_nodes = torch.stack([masked_rbf_solve(
                kmat, yv[:, c], (self.gains[:, c] != 0) & self.valid_mask,
                reg=reg) for c in range(self.num_class)], dim=1)  # [S, C]

    def poly_score(self, point=None, transformed_point=None):
        """[B, C] per-class surrogate scores. Same differentiation contract
        as ``DiffCo.poly_score``: for a float32 CUDA batch >=
        ``ops.fk_score._FK_FUSED_MIN_BATCH`` an FK-transformed DH or URDF
        checker scores all classes in one pass (kernel B4 or B5: q
        gradients only, forward mode raises); below the gate, on the CPU
        and in float64 the route is twice-differentiable."""
        is_poly1 = (isinstance(self.rbf_kernel, Polyharmonic)
                    and self.rbf_kernel.k == 1)
        if transformed_point is None:
            point = torch.atleast_2d(point)
            robot = self._fk_robot() if is_poly1 else None
            if robot is not None:
                from .ops.fk_score import fk_polyharmonic_multi_score_auto
                return fk_polyharmonic_multi_score_auto(
                    point, robot, self.support_transformed, self.rbf_nodes,
                    self.valid_mask, epsilon=self.rbf_kernel.epsilon)
            pt = self._apply_transform(point)
        else:
            pt = transformed_point.reshape(transformed_point.shape[0], -1)
        return self._kernel_matvec(self.rbf_kernel, pt, self.rbf_nodes)

    rbf_score = poly_score


class MultiDimDiffCo(Perceptron):
    """Vector-gain perceptron: the kernel returns one value per control
    point and each support carries a gain per control point. The Gram is
    [N, N, C], C times an ordinary one, so past ``lazy_gram_threshold``
    rows (4096) ``train`` takes the lazy-row trainer."""

    _pad_multiple = 64

    def __init__(self, kernel_func=None, gamma=1, beta=1, transform=None,
                 max_batch_size=None, max_num_supports=None, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.kernel_func = (MultiDimRQKernel(gamma) if kernel_func is None
                            or kernel_func == 'multi_dim_rq'
                            else kernel_func)
        self.beta = float(beta)
        self.transform = transform
        self.max_num_supports = max_num_supports
        self.lazy_gram_threshold = 4096
        self.support_transformed = None  # [S, M, d]
        self.gains = None                # [S, C]
        self.hypothesis = None           # [S]
        self.y = None
        self.distance = None
        self.kernel_matrix = None        # [S, S, C]
        self.rbf_nodes = None
        self.valid_mask = None
        self.num_valid = 0
        self.rbf_kernel = None
        self.train_iterations = None

    def _apply_transform(self, X):
        """Keeps the per-control-point structure: [N, M, d]."""
        if self.transform is None:
            return X[:, :, None] if X.dim() == 2 else X
        return self.transform(X)

    def train(self, X, y, update=False, exist_mask=None, max_iteration=1000,
              method='original', distance=None, verbose=False):
        """Vector-gain training; ``update=True`` warm-starts as
        ``DiffCo.train`` does, with h_i = sum_j K[i, j] . g_j, and raises
        ValueError without a previous training."""
        del method
        y = y.reshape(-1)
        N = X.shape[0]
        Xt = self._apply_transform(X)                 # [N, M, d]
        init_gains = init_hyp = None
        with fp32_matmul():
            rows, diagK, y_train, valid, K, shard, feats = \
                self._mesh_train_inputs(Xt, y.to(Xt.dtype),
                                        N > self.lazy_gram_threshold)
            if update and self.gains is not None:
                init_gains, vg = self._prev_gains(exist_mask, N)
                init_gains, init_hyp = self._mesh_warm_start(
                    Xt, K, shard, init_gains, vg,
                    lambda k, g: torch.einsum('nsc,sc->n', k, g))
            elif update:
                raise ValueError('update=True requires a previously trained '
                                 'MultiDimDiffCo (no gains present)')
            gains, hyp, it = _train_vector_gains(
                rows, diagK, y_train, self.beta, int(max_iteration),
                init_gains, init_hyp, valid, shard, feats)
        if shard is not None:
            gains, hyp = shard.gather(gains)[:N], shard.gather(hyp)[:N]
            K = None   # the support Gram is recomputed from the kept rows
        self.train_iterations = int(it)
        if verbose:
            acc = float(torch.mean(((hyp > 0) == (y > 0)).float()))
            print(f'MultiDimDiffCo ended at iteration '
                  f'{self.train_iterations}, ACC {acc:.4f}')
        self._select_supports(
            X, Xt, gains, hyp, y,
            distance.reshape(-1) if distance is not None else None, K)
        self.rbf_nodes = torch.zeros_like(self.gains)

    def fit_poly(self, kernel_func=None, target='hypo'):
        """Least-squares fit over the flattened vector kernel [S, S * C]
        (the minimum-norm solution, singular values below 1e-6 of the
        largest cut, as the JAX package's ``lstsq(rcond=1e-6)``)."""
        self.rbf_kernel = (MultiDimRQKernel(1.0) if kernel_func is None
                           else kernel_func)
        yv = self._target_values(target)
        m = self.valid_mask.to(yv.dtype)
        with fp32_matmul():
            kmat = self.rbf_kernel(self.support_transformed,
                                   self.support_transformed)  # [S, S, C]
            S = kmat.shape[0]
            kflat = (kmat * m[:, None, None] * m[None, :, None]).reshape(S, -1)
            sol = torch.linalg.pinv(kflat, rtol=1e-6) @ (yv * m)[:, None]
        self.rbf_nodes = sol.reshape(S, -1) * m[:, None]

    def _vector_kernel(self, kernel_func, point, transformed_point=None):
        """k(phi(q), supports) [B, S, C] with padded supports masked."""
        pt = (self._apply_transform(torch.atleast_2d(point))
              if transformed_point is None else transformed_point)
        kv = kernel_func(pt, self.support_transformed)
        return kv * self.valid_mask.to(kv.dtype)[None, :, None]

    def poly_score(self, point=None, transformed_point=None):
        kv = self._vector_kernel(self.rbf_kernel, point, transformed_point)
        with fp32_matmul():
            return kv.reshape(kv.shape[0], -1) @ self.rbf_nodes.reshape(-1, 1)

    def score_original(self, point):
        kv = self._vector_kernel(self.kernel_func, point)
        with fp32_matmul():
            return torch.einsum('bsc,sc->b', kv, self.gains)

    def score(self, point):
        return self.score_original(point)

    def predict(self, point):
        return (self.score(point) > 0) * 2 - 1
