"""Kernel perceptrons, the learned collision proxy (PyTorch counterpart of
``diffco_tpu/perceptron.py``: ``perceptron_train_loop``,
``masked_rbf_solve``, ``extract_supports``, ``Perceptron``, ``DiffCo``).

The greedy min-margin trainer runs over a precomputed Gram matrix as a
Python loop of tensor ops that stay on the device. A finished state is a
fixed point of the loop body (its update is zero), so the loop reads the
``done`` flag back only every ``_DONE_CHECK_EVERY`` iterations and
records on the device the iteration at which it first held: the result
equals that of a loop that stops at once.

Support sets are fixed-shape padded arrays with a validity mask, as in
the JAX package.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .device import fp32_matmul
from .kernels import KernelFunc, RQKernel, Polyharmonic

# iterations between host reads of the train loop's done flag
_DONE_CHECK_EVERY = 64


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
    N = y.shape[0]
    dt, dev = K.dtype, K.device
    y = y.reshape(-1).to(dt)
    diagK = torch.diagonal(K)
    # target = beta for y = +1, -1 for y = -1
    target = torch.where(y > 0, torch.tensor(beta, dtype=dt, device=dev),
                         torch.tensor(-1.0, dtype=dt, device=dev))
    valid = (torch.ones(N, dtype=torch.bool, device=dev) if valid_mask is None
             else valid_mask.reshape(-1).to(torch.bool))
    gains = (torch.zeros(N, dtype=dt, device=dev) if init_gains is None
             else init_gains.clone())
    hyp = (torch.zeros(N, dtype=dt, device=dev) if init_hypothesis is None
           else init_hypothesis.clone())
    inf = torch.tensor(float('inf'), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    # iteration count of a loop that stops right after done: max_iteration
    # until done first holds at iteration i, then i + 1. Indices are kept
    # as 1-element tensors: indexing with them does not wait for the device
    it = torch.full((1,), max_iteration, device=dev)
    for i in range(max_iteration):
        margin = torch.where(valid, y * hyp, inf)
        min_i = torch.argmin(margin).reshape(1)
        take_update = margin[min_i] <= 0
        delta_update = (target[min_i] - hyp[min_i]) / diagK[min_i]
        # removal step: support whose removal *increases* its own margin
        nz = gains != 0
        modified = y * (hyp - gains * diagK) * nz * valid
        max_i = torch.argmax(modified).reshape(1)
        removable = (modified[max_i] > 0) & (torch.sum(nz) > 1)
        take_remove = ~take_update & removable
        done = ~take_update & ~removable
        idx = torch.where(take_update, min_i, max_i)
        delta = torch.where(take_update, delta_update,
                            torch.where(take_remove, -gains[max_i], zero))
        gains = gains.index_add(0, idx, delta)
        hyp = hyp + delta * K[idx][0]
        it = torch.where(done & (it == max_iteration), i + 1, it)
        if (i + 1) % _DONE_CHECK_EVERY == 0 and bool(it < max_iteration):
            break
    return gains, hyp, it.reshape(())


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
    """Base class."""

    def __init__(self):
        self.support_points = None

    def score(self, point):
        raise NotImplementedError

    def is_collision(self, point):
        return self.score(point) > 0

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
        if mesh is not None:
            raise NotImplementedError(
                'mesh= (multi-device training) is not ported yet '
                '(ROADMAP A15, torch.distributed)')
        self.kernel_func = (RQKernel(gamma) if kernel_func == 'rq'
                            else kernel_func)
        self.beta = float(beta)
        self.transform = transform
        self.max_num_supports = max_num_supports  # None -> auto pad
        # rows above which the JAX package switches to its lazy-row trainer
        self.lazy_gram_threshold = 16384

        self.support_points = None       # [S, dof]
        self.support_transformed = None  # [S, F]
        self.gains = None                # [S]
        self.hypothesis = None           # [S]
        self.y = None                    # [S]
        self.distance = None             # [S] or None
        self.kernel_matrix = None        # [S, S]
        self.rbf_nodes = None            # [S]
        self.valid_mask = None           # bool [S]
        self.num_valid = 0
        self.rbf_kernel = None
        self.train_iterations = None

    # -- helpers ----------------------------------------------------------

    def _apply_transform(self, X):
        Xt = X if self.transform is None else self.transform(X)
        return Xt.reshape(Xt.shape[0], -1)

    def _pad_size(self, count: int) -> int:
        if self.max_num_supports is not None:
            return self.max_num_supports
        # next multiple of 128 >= count, never below a previous pad size
        size = max(128, int(np.ceil(count / 128.0)) * 128)
        prev = (0 if self.support_points is None
                else self.support_points.shape[0])
        return max(size, prev)

    @property
    def valid_supports(self):
        return self.num_valid

    # -- training ---------------------------------------------------------

    def train(self, X, y, update=False, exist_mask=None, max_iteration=1000,
              method='original', distance=None, verbose=False):
        """Cold-start training over the dense Gram of the transformed X."""
        del method, exist_mask
        if update:
            raise NotImplementedError(
                'warm-start update=True is not ported yet '
                '(ROADMAP A7, warm-start update)')
        y = y.reshape(-1)
        N = X.shape[0]
        if N > self.lazy_gram_threshold:
            raise NotImplementedError(
                f'{N} rows need the lazy-row trainer, not ported yet '
                '(ROADMAP A5, lazy trainer)')
        Xt = self._apply_transform(X)
        with fp32_matmul():
            K = self.kernel_func(Xt, Xt)
        gains, hyp, it = perceptron_train_loop(K, y, self.beta,
                                               int(max_iteration))
        self.train_iterations = int(it)
        if verbose:
            acc = float(torch.mean(((hyp > 0) == (y > 0)).float()))
            print(f'DiffCo training ended at iteration {self.train_iterations}'
                  f', ACC {acc:.4f}')
        dist = distance.reshape(-1) if distance is not None else None
        self._select_supports(X, Xt, gains, hyp, y, dist, K)

    def _select_supports(self, X, Xt, gains, hyp, y, dist, K):
        """Compact to the fixed-size padded support set."""
        count = int(torch.sum(gains != 0))
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
        km = K[idx][:, idx]
        self.kernel_matrix = km * vf[:, None] * vf[None, :]
        self.valid_mask = valid
        self.num_valid = int(num_valid)
        self.rbf_nodes = torch.zeros(S, dtype=Xt.dtype, device=Xt.device)
        if count > S:
            # top-S truncation breaks hypothesis == K @ gains; recompute it
            # over the kept supports
            self.hypothesis = self.kernel_matrix @ self.gains

    # -- smooth surrogate -------------------------------------------------

    def fit_poly(self, kernel_func: Optional[KernelFunc] = None,
                 target='hypo', reg: float = 0.0):
        """Fit the smooth RBF surrogate over the supports."""
        self.rbf_kernel = (Polyharmonic(k=1, epsilon=1)
                           if kernel_func is None else kernel_func)
        if target == 'hypo':
            yv = self.hypothesis
        elif 'dist' in target:
            yv = self.distance
        elif 'label' in target:
            yv = self.y
        else:
            raise ValueError(f'unknown target {target}')
        with fp32_matmul():
            kmat = self.rbf_kernel(self.support_transformed,
                                   self.support_transformed)
            self.rbf_nodes = masked_rbf_solve(kmat, yv, self.valid_mask,
                                              reg=reg)

    # -- inference --------------------------------------------------------

    def poly_score(self, point=None, transformed_point=None):
        """Smooth surrogate score [B, 1].

        Differentiation contract: gradients w.r.t. the QUERY only. At
        batch >= ops.fk_score._FK_FUSED_MIN_BATCH (configurations of a DH
        robot) or >= ops.fused_score._FUSED_MIN_BATCH (points) the score
        runs through one-pass autograd Functions that treat the trained
        state as constants (zero cotangents, no forward mode); below the
        gates the route is differentiable in every argument."""
        is_poly1 = (isinstance(self.rbf_kernel, Polyharmonic)
                    and self.rbf_kernel.k == 1)
        if transformed_point is None:
            point = torch.atleast_2d(point)
            if is_poly1:
                # FK-transformed checker: FK + score + configuration
                # gradient in one pass per batch at large batch
                robot = getattr(self.transform, '__self__', None)
                if (robot is not None
                        and getattr(robot, 'fkine', None) == self.transform):
                    from .ops.fk_score import fk_polyharmonic_score_auto
                    return fk_polyharmonic_score_auto(
                        point, robot, self.support_transformed,
                        self.rbf_nodes, self.valid_mask,
                        epsilon=self.rbf_kernel.epsilon)
            pt = self._apply_transform(point)
        else:
            pt = transformed_point.reshape(transformed_point.shape[0], -1)
        if is_poly1:
            from .ops.fused_score import polyharmonic_score
            return polyharmonic_score(pt, self.support_transformed,
                                      self.rbf_nodes, self.valid_mask,
                                      epsilon=self.rbf_kernel.epsilon)
        kv = self.rbf_kernel(pt, self.support_transformed)
        kv = kv * self.valid_mask.to(kv.dtype)[None, :]
        return kv @ self.rbf_nodes.reshape(-1, 1)

    def score_original(self, point):
        """Raw perceptron score k(phi(q), supports) @ gains."""
        point = torch.atleast_2d(point)
        pt = self._apply_transform(point)
        kv = self.kernel_func(pt, self.support_transformed)
        kv = kv * self.valid_mask.to(kv.dtype)[None, :]
        return kv @ self.gains

    def score(self, point):
        return self.score_original(point)

    def predict(self, point):
        return (self.score(point) > 0) * 2 - 1
