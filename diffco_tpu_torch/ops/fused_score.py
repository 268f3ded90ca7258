"""Point-space polyharmonic DiffCo score + gradient (PyTorch counterpart of
``diffco_tpu/ops/fused_score.py``).

The serving hot path is ``score(x) = sum_j w_j ||x - s_j||`` with its
query gradient ``dx = x * sum_j w_j / r_j - sum_j s_j w_j / r_j``. A
float32 CUDA batch >= ``_FUSED_MIN_BATCH`` runs through
``poly_score_grad``, one pass that computes score and dx together (the
hand-written CUDA kernel ``csrc/poly_score.cu``, on the tensor-core score
block ``csrc/tc_score_block.cuh`` at F = 9-64 and in fp64 on the CUDA
cores at F <= 8 and at F = 65-192, for a CUDA tensor, its plain twin
``_poly_score_grad_plain`` for a CPU tensor); the autograd
Function saves dx so the backward is a broadcast multiply. Everywhere
else (below the gate, on the CPU, in float64, as the JAX package off its
accelerator) the plain expanded-square formulation ``_poly_score_xla``
runs, which stays differentiable to every order in every argument.
"""
from __future__ import annotations

import ctypes

import torch

from . import _native
from ..device import fp32_matmul

# the JAX package's batch gate (fused_score.py:57-59), kept as the contract
_FUSED_MIN_BATCH = 16384

_PLAIN_ROWS = 4096   # rows per chunk of the plain twin's [rows, S, F] block


def _poly_score_grad_plain(x, s, w):
    """Plain PyTorch twin of ``csrc/poly_score.cu``: x [B, F], s [S, F],
    w [S] -> (score [B], dx [B, F]) with the kernel's arithmetic: direct
    difference d2, ``rinv = rsqrt(max(d2, 0) + 1e-12)``, ``r = d2 * rinv``,
    score = r @ w, rowsum = rinv @ w, su = rinv @ (s * w)."""
    scores, dxs = [], []
    sw = s * w[:, None]
    for x_c in torch.split(x, _PLAIN_ROWS):
        d2 = torch.sum((x_c[:, None, :] - s[None, :, :]) ** 2, dim=-1)
        d2 = torch.clamp(d2, min=0.0) + 1e-12
        rinv = torch.rsqrt(d2)
        r = d2 * rinv
        scores.append(r @ w)
        rowsum = rinv @ w
        dxs.append(x_c * rowsum[:, None] - rinv @ sw)
    if not scores:
        return x.new_zeros(0), x.new_zeros(x.shape)
    return torch.cat(scores), torch.cat(dxs)


def _poly_launch(x, s, w, *args, entry='poly_score_grad'):
    """Check B2's inputs, allocate its outputs and launch the C function
    ``entry`` of ``csrc/poly_score.cu`` with ``args`` after F, counted in
    ``launches.<entry>`` (``_native.launch``): (score [B], dx [B, F]).
    Past ``_native.TC_MAX_F`` the wide instance, ``poly_score_grad_wide``,
    runs instead (still counted in ``launches.<entry>``), after the wide
    block's prologue (``_native.wide_prep``), without ``args``: it has
    no guard."""
    _native.check_cuda_inputs('poly_score_grad', x, s, w)
    B, F = x.shape
    S = s.shape[0]
    if s.shape[1] != F or w.shape != (S,):
        raise ValueError(f'poly_score_grad: shapes x {tuple(x.shape)}, '
                         f's {tuple(s.shape)}, w {tuple(w.shape)}')
    if F > _native.MAX_F:
        raise ValueError(f'poly_score_grad: F = {F} > {_native.MAX_F}')
    score = torch.empty(B, dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x)
    if B > 0:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if F > _native.TC_MAX_F:
            prep = s.new_empty(2 * _native.wide_prep_doubles(S, F, 1))
            _native.wide_prep('poly_score', s, w, F, 1, prep, stream)
            _native.launch('poly_score', 'poly_score_grad_wide',
                           x.data_ptr(), prep.data_ptr(), score.data_ptr(),
                           dx.data_ptr(), B, S, F, stream, kernel=entry)
        else:
            _native.launch('poly_score', entry, x.data_ptr(), s.data_ptr(),
                           w.data_ptr(), score.data_ptr(), dx.data_ptr(), B,
                           S, F, *args, stream)
    return score, dx


def poly_score_grad(x, s, w):
    """Score and gradient in one pass: x [B, F] -> (score [B], dx [B, F]).

    A CUDA tensor launches ``csrc/poly_score.cu`` (the tensor-core kernel,
    ``csrc/tc_score_block.cuh``, or at F <= 8 its fp64 instance and at
    F = 65-192 its wide one) or raises; a CPU tensor runs the plain
    twin."""
    if x.device.type == 'cpu':
        return _poly_score_grad_plain(x, s, w)
    return _poly_launch(x, s, w)


def poly_score_guard_pairs(x, s, w, kappa):
    """B2's kernel in its measurement build (``poly_score_grad_guard``)
    with the near-pair guard at threshold ``kappa``: (score [B], dx [B, F],
    the number of (row, support) pairs the guard recomputed; 0 past
    ``_native.TC_MAX_F``, where the wide instance, which has no guard,
    runs). A measurement entry for float32 CUDA tensors, counted under its
    own entry name; production launches go through ``poly_score_grad``."""
    pairs = torch.zeros(1, dtype=torch.int64, device=x.device)
    score, dx = _poly_launch(x, s, w, ctypes.c_float(kappa),
                             pairs.data_ptr(), entry='poly_score_grad_guard')
    return score, dx, int(pairs.item())


class _PolyScoreFused(torch.autograd.Function):
    """score [B, 1] whose VJP reuses the dx of the same pass. Supports and
    weights are trained constants here: their cotangents are zero, and
    forward mode raises."""

    @staticmethod
    def forward(ctx, x, s, w):
        score, dx = poly_score_grad(x.contiguous(), s.contiguous(),
                                    w.contiguous())
        ctx.save_for_backward(dx)
        ctx.shapes = (s.shape, w.shape)
        return score[:, None]

    @staticmethod
    def backward(ctx, g):
        dx, = ctx.saved_tensors
        s_shape, w_shape = ctx.shapes
        return (g * dx, g.new_zeros(s_shape), g.new_zeros(w_shape))

    @staticmethod
    def jvp(ctx, *tangents):
        raise RuntimeError(
            'polyharmonic_score_fused has no forward-mode derivative (the '
            'JAX twin is a custom_vjp); for forward mode keep the batch '
            f'below {_FUSED_MIN_BATCH} or pass a float64 tensor')


def polyharmonic_score_fused(x, s, w):
    return _PolyScoreFused.apply(x, s, w)


def _poly_score_xla(x, s, w, valid_mask=None):
    """score = ||x - s|| @ w [B, 1] via the expanded-square distance
    product (the JAX package's fp32 XLA route); weight columns W [S, C]
    give [B, C]."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    s2 = torch.sum(s * s, dim=1, keepdim=True)
    xs = x @ s.T
    r = torch.sqrt(torch.clamp(x2 + s2.T - 2.0 * xs, min=0.0) + 1e-12)
    if valid_mask is not None:
        r = r * valid_mask[None, :]
    return r @ (w.reshape(-1, 1) if w.dim() == 1 else w)


def polyharmonic_score(x, supports, weights, valid_mask=None,
                       epsilon: float = 1.0):
    """score(x) = sum_j w_j ||x - s_j|| / epsilon  [B, 1].

    x: [B, F]; supports: [S, F]; weights: [S]. ``valid_mask`` folds into
    the weights. Float32 CUDA batches >= ``_FUSED_MIN_BATCH`` take the
    one-pass route (the CUDA kernel), everything else the plain route."""
    w = weights.reshape(-1)
    if valid_mask is not None:
        w = w * valid_mask.to(w.dtype)
    if epsilon != 1.0:
        w = w / epsilon
    if (x.is_cuda and x.dtype == torch.float32
            and x.shape[0] >= _FUSED_MIN_BATCH):
        return polyharmonic_score_fused(x, supports, w)
    return _poly_score_xla(x, supports, w)


def rq_score(x, supports, weights, gamma: float = 10.0, p: int = 2,
             valid_mask=None):
    """Rational-quadratic perceptron score [B, 1] (``score_original`` of an
    RQ-kernel DiffCo). Plain PyTorch: the JAX package has no kernel for it
    either (the RQ kernel serves the Gram build, where the full matrix is
    needed anyway)."""
    w = weights.reshape(-1)
    if valid_mask is not None:
        w = w * valid_mask.to(w.dtype)
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    s2 = torch.sum(supports * supports, dim=1, keepdim=True)
    with fp32_matmul():
        d2 = torch.clamp(x2 + s2.T - 2.0 * (x @ supports.T), min=0.0)
        return ((1.0 + (gamma / p) * d2) ** (-p)) @ w.reshape(-1, 1)
