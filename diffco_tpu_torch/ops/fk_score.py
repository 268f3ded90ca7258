"""Chain FK + polyharmonic score + configuration gradient (PyTorch
counterpart of ``diffco_tpu/ops/fk_score.py``, DH and general-chain
branches, one weight column or C of them).

The trajopt inner-loop primitive is ``score(fkine(q))`` with its gradient
in ``q``. For a float32 CUDA tensor at batch >= ``_FK_FUSED_MIN_BATCH``
it runs FK, score and the configuration gradient in one pass, through a
hand-written CUDA kernel:

- ``dh_score_grad`` (``csrc/dh_score.cu``) and ``chain_score_grad``
  (``csrc/chain_score.cu``) for a DH or a URDF robot, weights w [S];
- ``dh_multi_score_grad`` (``csrc/dh_multi_score.cu``) and
  ``chain_multi_score_grad`` (``csrc/chain_multi_score.cu``) for the
  multi-class proxy, weight columns W [S, C] -> score [B, C] and
  dq [C, B, D].

Each takes any chain up to 64 moving joints, dofs and control points:
within its own block's bounds on its by-value spec, past them on the wide
instance (``csrc/chain_wide.cuh``), which every one of the four sources
builds. Each has a plain twin (``_<name>_plain``) that a CPU tensor runs.
Below the gate, on the CPU, in float64 and for other robots, it is FK +
the plain score route.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from . import _native
from .fused_score import (_poly_score_grad_plain, _poly_score_xla,
                          polyharmonic_score)
from ..device import fp32_matmul
from ..profiling import count, span, spanned
from ..robots.analytic import DHChainRobot
from ..robots.fk_jvp import (_FIXED, _IDENT9, _ZERO3, ChainStatics,
                             DHStatics, chain_vjp, dh_chain, dh_vjp,
                             eval_chain)
from ..robots.soa import stack_points
from ..robots.urdf import URDFRobot

# the JAX package's batch gate (fk_score.py:693-701), kept as the contract:
# below it the route stays twice-differentiable in every argument
_FK_FUSED_MIN_BATCH = 4096


def robot_spec(robot) -> Tuple:
    """Hashable (dh_const, point_specs, base) spec for a DHChainRobot."""
    dh_const = tuple(tuple(float(v) for v in row)
                     for row in robot._dh_const)
    point_specs = tuple((int(fi), tuple(float(v) for v in off))
                        for fi, off in robot._point_specs)
    # the suffix-sum backward (dh_vjp, csrc/dh_chain.cuh) needs
    # non-decreasing frame ids; a violation would give silently wrong
    # gradients, so this is a hard error (not an assert, which -O strips)
    frame_ids = [fi for fi, _ in point_specs]
    if not all(a <= b for a, b in zip(frame_ids, frame_ids[1:])):
        raise ValueError(
            'point_specs frame indices must be non-decreasing for the '
            f'fused DH score kernel backward pass, got {frame_ids}')
    base = robot._base_soa()
    if base is not None:
        base = (tuple(base[0]), tuple(base[1]))
    return (dh_const, point_specs, base)


def _statics(spec) -> DHStatics:
    dh_const, point_specs, base = spec
    if base is None:
        return DHStatics(dh_const, point_specs, _IDENT9, _ZERO3)
    return DHStatics(dh_const, point_specs, tuple(base[0]), tuple(base[1]))


@functools.lru_cache(maxsize=64)
def _c_spec(spec):
    """The kernel's argument for a DH spec (cached per spec): the by-value
    DHSpec of the tensor-core and multi-class kernels, or for a chain past
    their bounds (J > ``_native.MAX_J`` or P > ``_native.MAX_P``) the
    ChainSpecWide of the wide instance (``csrc/chain_wide.cuh``), the DH
    chain folded into chain form (``_fold_dh``). Raises beyond the wide
    instance's bounds."""
    dh_const, point_specs, base = spec
    st = _statics(spec)
    J = len(dh_const)
    if not all(1 <= fi <= J for fi, _ in point_specs):
        raise ValueError('dh_score_grad: point frame ids must lie in 1..J')
    c = _native.dh_spec(st)
    if c is None:
        return _chain_struct(*_fold_dh(st), J, 'dh_score_grad', narrow=False)
    return c


def _fold_dh(st: DHStatics):
    """A DH chain in ``_fold_chain``'s form: joint j a revolute about its
    frame's z (theta = q_j + offset) behind the constant transform that
    ends joint j - 1, (Rx(alpha), (a, 0, d)), or the base for j = 0; a
    point on frame fi at that transform of its offset, in the frame of
    joint fi - 1. The joint transform Rz(theta) Rx(alpha), (a cos theta,
    a sin theta, d) of ``dh_rot_trans`` is Rz(theta) followed by it."""
    pre = [(np.asarray(st.base_rot, np.float64).reshape(3, 3),
            np.asarray(st.base_trans, np.float64))]
    for a, d, sa, ca, _ in st.dh_const:
        pre.append((np.array([[1.0, 0.0, 0.0], [0.0, ca, -sa],
                              [0.0, sa, ca]]), np.array([a, 0.0, d])))
    joints = [(j - 1, 1, j, 1.0, th, (0.0, 0.0, 1.0), *pre[j])
              for j, (_, _, _, _, th) in enumerate(st.dh_const)]
    points = [(fi - 1, pre[fi][0] @ np.asarray(off, np.float64)
               + pre[fi][1]) for fi, off in st.point_specs]
    return joints, points


def _dh_score_grad_plain(q, s, w, spec):
    """Plain PyTorch twin of ``csrc/dh_score.cu``: the port's FK, the score
    block of ``_poly_score_grad_plain``, then the suffix-sum backward.
    q [B, J] -> (score [B], dq [B, J])."""
    st = _statics(spec)
    axes, pts = dh_chain(st, q)
    x = torch.stack([c for p in pts for c in p], dim=-1)       # [B, 3P]
    score, dx = _poly_score_grad_plain(x, s, w)
    return score, dh_vjp(st, axes, pts, dx)


@functools.lru_cache(maxsize=64)
def _on_device(blob: bytes, device: torch.device) -> torch.Tensor:
    """A spec's bytes copied to ``device`` once (cached per spec and
    device)."""
    return torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(device)


def _launch(name, lib, q, s, w, c, D, P, *ints, entry=None, dq=True):
    """Check the inputs of a one-pass FK kernel, allocate its outputs and
    launch the C function ``entry`` (default ``name``) of ``lib``, with
    ``ints`` after B and S, counted in ``launches.<name>``
    (``_native.launch``): weights w [S] give (score [B], dq [B, D]),
    weight columns W [S, C] give (score [B, C], dq [C, B, D]);
    ``dq=False`` gives score [B] alone. A ``_native.ChainSpecWide`` ``c``
    launches the wide instance, ``<name>_wide``, after the wide block's
    prologue (``_native.wide_prep``, counted in ``launches.wide_prep``)
    has written the supports and weights ready for the tensor cores into
    a buffer of its own, with the spec's device copy and a scratch of
    ``_native.wide_scratch_floats`` for the joints' axes and origins (the
    three made in the span ``diffco.ops.wide_args``); it counts the wide
    instance in the counter ``ops.wide_launches`` too. Each launch runs in
    a span ``diffco.ops.launch``."""
    _native.check_cuda_inputs(name, q, s, w)
    B, S = q.shape[0], s.shape[0]
    multi = w.dim() == 2
    if (q.dim() != 2 or q.shape[1] != D or s.shape[1] != 3 * P
            or w.dim() not in (1, 2) or w.shape[0] != S
            or ('multi' in name) != multi):
        raise ValueError(f'{name}: shapes q {tuple(q.shape)}, '
                         f's {tuple(s.shape)}, w {tuple(w.shape)} do not '
                         f'fit {D} configuration columns, {P} points')
    C = w.shape[1] if multi else 1
    if not 1 <= C <= _native.MAX_C:
        raise ValueError(f'{name}: {C} classes, the kernel takes 1 to '
                         f'{_native.MAX_C}')
    outs = [q.new_empty((B, C) if multi else (B,))]
    if dq:
        outs.append(q.new_empty((C, B, D) if multi else (B, D)))
    # the wide instance reads its spec from a device copy
    wide = isinstance(c, _native.ChainSpecWide)
    if wide and entry is not None:
        raise ValueError(f'{name}: the wide instance has no entry {entry}')
    if B > 0:
        # held until the launch is queued, so that no buffer's memory goes
        # to another
        inputs, extra = (q, s, w), ()
        if wide:
            with span('diffco.ops.wide_args'):
                prep = q.new_empty(2 * _native.wide_prep_doubles(S, 3 * P, C))
                extra = (_on_device(bytes(c), q.device),
                         q.new_empty(_native.wide_scratch_floats(B, c.M)))
                stream = torch.cuda.current_stream(q.device).cuda_stream
            with span('diffco.ops.launch'):
                _native.wide_prep(lib, s, w, 3 * P, C, prep, stream)
            inputs = (q, prep)
        with span('diffco.ops.launch'):
            _native.launch(
                lib, entry or (f'{name}_wide' if wide else name),
                *(t.data_ptr() for t in (*inputs, *outs)), B, S,
                *((C,) if multi else ()), *ints, ctypes.byref(c),
                *(t.data_ptr() for t in extra),
                torch.cuda.current_stream(q.device).cuda_stream, kernel=name)
        if wide:
            count('ops.wide_launches')
    return tuple(outs) if dq else outs[0]


def dh_score_grad(q, s, w, spec):
    """Score and configuration gradient in one pass: q [B, J] ->
    (score [B], dq [B, J]). A CUDA tensor launches ``csrc/dh_score.cu``
    (the tensor-core kernel, ``csrc/tc_score_block.cuh``; past its bounds
    the wide instance, ``csrc/chain_wide.cuh``) or raises; a CPU tensor
    runs the plain twin."""
    if q.device.type == 'cpu':
        return _dh_score_grad_plain(q, s, w, spec)
    return _launch('dh_score_grad', 'dh_score', q, s, w, _c_spec(spec),
                   len(spec[0]), len(spec[1]))


def dh_score_guard_pairs(q, s, w, spec, kappa):
    """B1's kernel in its measurement build (``dh_score_grad_guard``) with
    the near-pair guard at threshold ``kappa`` (``csrc/tc_score_block.cuh``
    recomputes d2 by direct difference where the expanded form falls below
    kappa (|x~|^2 + |s~|^2)): (score [B], dq [B, J], the number of
    (configuration, support) pairs the guard recomputed). A measurement
    entry for float32 CUDA tensors, counted under its own entry name;
    production launches go through ``dh_score_grad``."""
    pairs = torch.zeros(1, dtype=torch.int64, device=q.device)
    score, dq = _launch('dh_score_grad_guard', 'dh_score', q, s, w,
                        _c_spec(spec), len(spec[0]), len(spec[1]),
                        ctypes.c_float(kappa), pairs.data_ptr(),
                        entry='dh_score_grad_guard')
    return score, dq, int(pairs.item())


def _per_class(x, s, W, vjp):
    """The plain score block per weight column of W [S, C], each class's
    point gradient pulled back by ``vjp``: (score [B, C], dq [C, B, D])."""
    scores, dqs = [], []
    for c in range(W.shape[1]):
        score, dx = _poly_score_grad_plain(x, s, W[:, c].contiguous())
        scores.append(score)
        dqs.append(vjp(dx))
    return torch.stack(scores, 1), torch.stack(dqs, 0)


def _dh_multi_score_grad_plain(q, s, W, spec):
    """Plain PyTorch twin of ``csrc/dh_multi_score.cu``: the port's FK
    once, then per class the score block of ``_poly_score_grad_plain``
    and the suffix-sum backward. q [B, J], W [S, C] ->
    (score [B, C], dq [C, B, J])."""
    st = _statics(spec)
    axes, pts = dh_chain(st, q)
    x = torch.stack([c for p in pts for c in p], dim=-1)       # [B, 3P]
    return _per_class(x, s, W, lambda dx: dh_vjp(st, axes, pts, dx))


def dh_multi_score_grad(q, s, W, spec):
    """All class scores and their configuration gradients in one pass:
    q [B, J], W [S, C] -> (score [B, C], dq [C, B, J]). A CUDA tensor
    launches ``csrc/dh_multi_score.cu`` (or raises); a CPU tensor runs the
    plain twin."""
    if q.device.type == 'cpu':
        return _dh_multi_score_grad_plain(q, s, W, spec)
    return _launch('dh_multi_score_grad', 'dh_multi_score', q, s, W,
                   _c_spec(spec), len(spec[0]), len(spec[1]))


class _FKPolyScore(torch.autograd.Function):
    """score [B, 1] (weights w [S]) or [B, C] (weight columns W [S, C])
    whose VJP comes from the dq of the same pass of ``score_grad``:
    ``g * dq``, or ``einsum('bc,cbj->bj', g, dq)`` over the classes.
    Supports and weights get zero cotangents; forward mode raises."""

    @staticmethod
    def forward(ctx, q, s, w, score_grad, spec):
        score, dq = score_grad(q.contiguous(), s.contiguous(),
                               w.contiguous(), spec)
        ctx.save_for_backward(dq)
        ctx.shapes = (s.shape, w.shape)
        return score[:, None] if score.dim() == 1 else score

    @staticmethod
    def backward(ctx, g):
        dq, = ctx.saved_tensors
        s_shape, w_shape = ctx.shapes
        g_q = g * dq if dq.dim() == 2 else torch.einsum('bc,cbj->bj', g, dq)
        return g_q, g.new_zeros(s_shape), g.new_zeros(w_shape), None, None

    @staticmethod
    def jvp(ctx, *tangents):
        raise RuntimeError(
            'the one-pass FK score has no forward-mode derivative (the JAX '
            'twin is a custom_vjp); for forward mode keep the batch below '
            f'{_FK_FUSED_MIN_BATCH} or pass a float64 tensor')


def dh_polyharmonic_score(q, supports, weights, spec):
    """Polyharmonic DiffCo score through DH-chain FK, [B, 1].

    DIFFERENTIATION CONTRACT: differentiable w.r.t. ``q`` only; supports
    and weights get zero cotangents and forward mode raises. The router
    takes it only for a float32 CUDA batch at ``_FK_FUSED_MIN_BATCH``;
    callers that need more stay below the gate or pass float64."""
    return _FKPolyScore.apply(q, supports, weights, dh_score_grad, spec)


def dh_polyharmonic_multi_score(q, supports, W, spec):
    """Per-class polyharmonic DiffCo scores through DH-chain FK, [B, C],
    with the differentiation contract of ``dh_polyharmonic_score``."""
    return _FKPolyScore.apply(q, supports, W, dh_multi_score_grad, spec)


# ---------------------------------------------------------------------------
# general chains (URDF robots): kernel B3


def robot_chain_statics(robot) -> ChainStatics:
    """ChainStatics of a URDFRobot's control-point fkine (the statics its
    ``fkine`` evaluates), or None if it has no unique-position links."""
    fk = robot._fkine_sel
    return None if fk is None else fk.statics


def _fold_chain(cs: ChainStatics):
    """Fold every fixed joint of ``cs`` into the constant transform in
    front of the next moving joint (float64 on the host), the form
    ``csrc/chain_fk.cuh`` composes. Returns (joints, points): per moving
    joint (moving parent or -1, joint type, dof, mult, offset, axis,
    pre rotation [3, 3], pre translation [3]) in topological order, and
    per point (moving joint or -1, offset in that frame, or the world
    point when -1)."""
    base = (np.asarray(cs.base_rot, np.float64).reshape(3, 3),
            np.asarray(cs.base_trans, np.float64))
    # per link: the moving joint whose frame it is rigid in (-1: the
    # world) and its pose in that frame
    anchor, rel, joints = [], [], []
    for i, p in enumerate(cs.parent):
        pa, (pr, pt) = (anchor[p], rel[p]) if p >= 0 else (-1, base)
        f_rot = np.asarray(cs.f_rot[i], np.float64).reshape(3, 3)
        r, t = pr @ f_rot, pt + pr @ np.asarray(cs.f_trans[i], np.float64)
        if cs.jtype[i] == _FIXED:
            anchor.append(pa)
            rel.append((r, t))
        else:
            anchor.append(len(joints))
            rel.append((np.eye(3), np.zeros(3)))
            joints.append((pa, cs.jtype[i], cs.dof_idx[i], cs.m_mult[i],
                           cs.m_off[i], cs.axis[i], r, t))
    points = [(anchor[li], rel[li][0] @ np.asarray(off, np.float64)
               + rel[li][1]) for li, off in cs.point_specs]
    return joints, points


def _chain_struct(joints, points, D, name, narrow=True):
    """The kernel's spec of a folded chain (``_fold_chain``'s form): the
    by-value ChainSpec within 1 to ``_native.MAX_M`` moving joints,
    ``MAX_D`` dofs and ``MAX_CP`` points (``narrow``), else the wide
    instance's ChainSpecWide within ``WIDE_MAX_M``, ``WIDE_MAX_D`` and
    ``WIDE_MAX_CP``; raises beyond those. The one place the kernels' bounds
    are read."""
    counts = (('moving joints', len(joints), _native.MAX_M,
               _native.WIDE_MAX_M), ('dofs', D, _native.MAX_D,
                                     _native.WIDE_MAX_D),
              ('control points', len(points), _native.MAX_CP,
               _native.WIDE_MAX_CP))
    for what, n, _, bound in counts:
        if not 1 <= n <= bound:
            raise ValueError(f'{name}: {n} {what}, the kernel takes 1 to '
                             f'{bound}')
    wide = not (narrow and all(n <= b for _, n, b, _ in counts))
    c = (_native.ChainSpecWide if wide else _native.ChainSpec)()
    c.M, c.P, c.D = len(joints), len(points), D
    for m, (mp, jt, dof, mult, off, axis, r, t) in enumerate(joints):
        c.mparent[m], c.jtype[m], c.dof[m] = mp, jt, dof
        c.mult[m], c.off[m] = mult, off
        c.axis[m][:] = axis
        c.pre_r[m][:] = np.asarray(r).reshape(-1).tolist()
        c.pre_t[m][:] = np.asarray(t).tolist()
    for k, (m, off) in enumerate(points):
        c.pframe[k] = m
        c.poff[k][:] = off.tolist()
    return c


@functools.lru_cache(maxsize=64)
def _c_chain_spec(cs: ChainStatics):
    """The kernel's spec for a chain (cached per chain): the by-value
    ChainSpec of the tensor-core and multi-class kernels, or for a chain
    past their bounds the wide instance's ChainSpecWide
    (``_chain_struct``)."""
    joints, points = _fold_chain(cs)
    return _chain_struct(joints, points, cs.n_dofs, 'chain_score_grad')


def _chain_score_grad_plain(q, s, w, cs: ChainStatics):
    """Plain PyTorch twin of ``csrc/chain_score.cu``: the port's
    ``eval_chain``, the score block of ``_poly_score_grad_plain``, then
    the moving-ancestor backward. q [B, D] -> (score [B], dq [B, D])."""
    joints, pts = eval_chain(cs, q)
    score, dx = _poly_score_grad_plain(stack_points(pts, flat=True), s, w)
    return score, chain_vjp(cs, joints, pts, dx)


def chain_score_grad(q, s, w, cs: ChainStatics):
    """Score and configuration gradient in one pass: q [B, D] ->
    (score [B], dq [B, D]). A CUDA tensor launches ``csrc/chain_score.cu``
    (the tensor-core kernel, ``csrc/tc_score_block.cuh``; past its bounds
    the wide instance, ``csrc/chain_wide.cuh``) or raises; a CPU tensor
    runs the plain twin."""
    if q.device.type == 'cpu':
        return _chain_score_grad_plain(q, s, w, cs)
    c = _c_chain_spec(cs)
    return _launch('chain_score_grad', 'chain_score', q, s, w, c, c.D, c.P)


def chain_score_guard_pairs(q, s, w, cs: ChainStatics, kappa):
    """B3's kernel in its measurement build (``chain_score_grad_guard``),
    as ``dh_score_guard_pairs`` is B1's: (score [B], dq [B, D], the
    number of pairs the near-pair guard recomputed at threshold
    ``kappa``), counted under its own entry name."""
    c = _c_chain_spec(cs)
    pairs = torch.zeros(1, dtype=torch.int64, device=q.device)
    score, dq = _launch('chain_score_grad_guard', 'chain_score', q, s, w, c,
                        c.D, c.P, ctypes.c_float(kappa), pairs.data_ptr(),
                        entry='chain_score_grad_guard')
    return score, dq, int(pairs.item())


def _chain_multi_score_grad_plain(q, s, W, cs: ChainStatics):
    """Plain PyTorch twin of ``csrc/chain_multi_score.cu``: ``eval_chain``
    once, then per class the score block and the moving-ancestor backward.
    q [B, D], W [S, C] -> (score [B, C], dq [C, B, D])."""
    joints, pts = eval_chain(cs, q)
    return _per_class(stack_points(pts, flat=True), s, W,
                      lambda dx: chain_vjp(cs, joints, pts, dx))


def chain_multi_score_grad(q, s, W, cs: ChainStatics):
    """The URDF-chain form of ``dh_multi_score_grad``: q [B, D], W [S, C]
    -> (score [B, C], dq [C, B, D]). A CUDA tensor launches
    ``csrc/chain_multi_score.cu`` (or raises); a CPU tensor runs the plain
    twin."""
    if q.device.type == 'cpu':
        return _chain_multi_score_grad_plain(q, s, W, cs)
    c = _c_chain_spec(cs)
    return _launch('chain_multi_score_grad', 'chain_multi_score', q, s, W,
                   c, c.D, c.P)


def chain_polyharmonic_score(q, supports, weights, cs: ChainStatics):
    """URDF-chain counterpart of ``dh_polyharmonic_score``, [B, 1], with
    the same differentiation contract (``q`` only; forward mode
    raises)."""
    return _FKPolyScore.apply(q, supports, weights, chain_score_grad, cs)


def chain_polyharmonic_multi_score(q, supports, W, cs: ChainStatics):
    """URDF-chain counterpart of ``dh_polyharmonic_multi_score``, [B, C]."""
    return _FKPolyScore.apply(q, supports, W, chain_multi_score_grad, cs)


def _one_pass(q) -> bool:
    """The one-pass Functions serve float32 CUDA tensors at batch >= the
    gate, as the JAX package takes its custom_vjp routes only on its
    accelerator (fk_score.py:704-714). Everything else (the CPU, float64)
    stays on the plain route, differentiable in every argument and in
    forward mode."""
    return (q.is_cuda and q.dtype == torch.float32
            and q.shape[0] >= _FK_FUSED_MIN_BATCH)


def dh_score_grad_available(robot, q) -> bool:
    """Whether ``q`` of this robot takes the one-pass DH route (B1, or B4
    for several classes): a DH robot and ``_one_pass``, at any shape, as
    the JAX package takes its kernel at every size
    (``diffco_tpu/ops/fk_score.py:704-714``). A chain past the tensor-core
    and multi-class blocks' bounds launches their wide instance; past
    that one's (``_native.WIDE_MAX_*``) the kernel raises."""
    return isinstance(robot, DHChainRobot) and _one_pass(q)


def chain_score_grad_available(robot, q) -> bool:
    """Whether ``q`` of this robot takes the one-pass URDF-chain route (B3,
    or B5 for several classes), at any shape, as
    ``dh_score_grad_available``: a chain past the kernels' own bounds (a
    35-link rope) launches their wide instance."""
    return (isinstance(robot, URDFRobot) and _one_pass(q)
            and robot._fkine_sel is not None)


def _dh_spec(robot):
    spec = getattr(robot, '_dh_spec_cache', None)
    if spec is None:
        spec = robot_spec(robot)
        robot._dh_spec_cache = spec
    return spec


@spanned('diffco.ops.fk_score')
def fk_polyharmonic_score_auto(q, robot, supports, weights, valid_mask=None,
                               epsilon: float = 1.0):
    """Route ``score(fkine(q))`` [B, 1] through the one-pass route of a DH
    or URDF robot when available (a float32 CUDA batch at the gate), else
    FK + ``polyharmonic_score``."""
    w = weights.reshape(-1)
    if valid_mask is not None:
        w = w * valid_mask.to(w.dtype)
    if epsilon != 1.0:
        w = w / epsilon
    if dh_score_grad_available(robot, q):
        return dh_polyharmonic_score(q, supports, w, _dh_spec(robot))
    if chain_score_grad_available(robot, q):
        return chain_polyharmonic_score(q, supports, w,
                                        robot_chain_statics(robot))
    if isinstance(robot, DHChainRobot):
        pts = robot.fkine(q, flat=True)
    else:
        pts = robot.fkine(q) if hasattr(robot, 'fkine') else robot(q)
    return polyharmonic_score(pts.reshape(q.shape[0], -1), supports, w)


def fk_polyharmonic_multi_score_auto(q, robot, supports, W, valid_mask=None,
                                     epsilon: float = 1.0):
    """Multi-class ``fk_polyharmonic_score_auto``: ``scores(fkine(q))``
    [B, C] for weight columns W [S, C], through kernel B4 (DH) or B5 (URDF
    chain) for a float32 CUDA batch >= ``_FK_FUSED_MIN_BATCH``, else FK +
    the plain ``[B, S] @ [S, C]`` route, twice-differentiable in every
    argument."""
    if valid_mask is not None:
        W = W * valid_mask.to(W.dtype)[:, None]
    if epsilon != 1.0:
        W = W / epsilon
    if dh_score_grad_available(robot, q):
        return dh_polyharmonic_multi_score(q, supports, W, _dh_spec(robot))
    if chain_score_grad_available(robot, q):
        return chain_polyharmonic_multi_score(q, supports, W,
                                              robot_chain_statics(robot))
    pts = robot.fkine(q).reshape(q.shape[0], -1)
    with fp32_matmul():
        return _poly_score_xla(pts, supports, W)
