"""Trajectory optimization over waypoint matrices (PyTorch counterpart of
``diffco_tpu/optim.py``).

- ``adam_traj_optimize`` and ``adam_traj_optimize_batch``: penalty-method
  Adam. All restarts of all problems run together as one batch of paths
  [P * T, N, dof]: every step evaluates the loss of every path with one
  score call, one FK call and one backward, and applies Adam (optax's
  defaults, written out by hand) with a per-restart freeze once a restart
  has converged. Nothing returns to the host until the end.
- ``al_traj_optimize``: augmented-Lagrangian Adam over the same batch of
  restarts, with a feasibility-restoration epilogue.
- ``givengrad_traj_optimize`` (SLSQP), ``trustconstr_traj_optimize`` and
  ``gradient_free_traj_optimize`` (trust-constr): scipy's host loops. By
  default (``options['scipy_fp64']``) every value, Jacobian and Hessian
  they ask for is evaluated on CPU float64 tensors, the JAX package's own
  design for these host-side solvers: float32 gradient noise (~1e-3
  relative) sits at scipy's termination tolerances. ``scipy_fp64=False``
  evaluates in float32 on the device of ``start_cfg``. Each record names
  the device and dtype it evaluated in.
- ``TrajOptimizer`` / ``Weighted``: the MPC-style stepper.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from collections import namedtuple
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import utils
from .device import fp32_matmul, resolve_device
from .profiling import span

_B1, _B2, _EPS = 0.9, 0.999, 1e-8   # optax.adam defaults


def _default_options(options: Optional[Dict]) -> Dict:
    o = dict(options or {})
    o.setdefault('N_WAYPOINTS', 20)
    o.setdefault('NUM_RE_TRIALS', 10)
    o.setdefault('MAXITER', 200)
    o.setdefault('history', False)
    o.setdefault('safety_margin', 0.0)
    o.setdefault('max_speed', 1.5)
    o.setdefault('seed', 0)
    # densify the collision term between waypoints (dense_sub >= 3), so
    # the optimizer cannot thread between waypoints
    o.setdefault('dense_sub', 3)
    o.setdefault('extra_optimizer_options', {})
    return o


def _resample_init(init, n_waypoints):
    """Resample an ``init_solution`` of any length (>= 2 waypoints) onto
    exactly ``n_waypoints``: densify each segment, then pick evenly spaced
    rows (host numpy). Returns a float32 numpy array."""
    init = np.asarray(init, np.float32)
    if init.shape[0] < 2:
        raise ValueError(
            f'init_solution needs >= 2 waypoints, got {init.shape[0]}')
    if init.shape[0] != n_waypoints:
        num_sub = max(1, -(-(n_waypoints - 1) // (init.shape[0] - 1)))
        fr = (np.arange(num_sub, dtype=np.float32) / num_sub)[None, :, None]
        seg_start = init[:-1][:, None, :]
        delta = (init[1:] - init[:-1])[:, None, :]
        dense = (seg_start + fr * delta).reshape(-1, init.shape[1])
        dense = np.concatenate([dense, init[-1:]], axis=0)
        idx = np.linspace(0, dense.shape[0] - 1, n_waypoints).astype(int)
        init = dense[idx]
    return init


def _loss_terms(p, robot_fkine, dist_est, limits, safety_margin, max_speed):
    """Penalty terms of paths p [T, N, dof], each [T]. The control points
    keep the robot's own point dimension d (``robot_fkine``: [B, M, d]; 2
    for a planar arm), over which each point's squared move is summed."""
    scores = dist_est(p)                                   # [T, M]
    collision = torch.sum(torch.clamp(scores - safety_margin, min=0.0), -1)
    T, N, dof = p.shape
    cp = robot_fkine(p.reshape(T * N, dof))
    cp = cp.reshape((T, N) + tuple(cp.shape[1:]))          # [T, N, M, d]
    seg = cp[:, 1:] - cp[:, :-1]
    max_move = torch.sum(torch.clamp(
        torch.sum(seg ** 2, dim=3) - max_speed ** 2, min=0.0), dim=(1, 2))
    joint_limit = torch.sum(torch.clamp(limits[:, 0] - p, min=0.0)
                            + torch.clamp(p - limits[:, 1], min=0.0),
                            dim=(1, 2))
    diff = torch.sum(seg ** 2, dim=(1, 2, 3))
    return diff, collision, max_move, joint_limit


def _adam_update(g, mu, nu, count, lr):
    """One optax.adam update of the gradient g [T, ...] with per-row step
    counts ``count`` [T] (or one count, []): moments, bias correction,
    -lr scaling. Returns (updates, mu, nu, count)."""
    mu = (1 - _B1) * g + _B1 * mu
    nu = (1 - _B2) * g ** 2 + _B2 * nu
    count = count + 1
    cnt = count.to(g.dtype).reshape(
        count.shape + (1,) * (g.dim() - count.dim()))
    mu_hat = mu / (1 - _B1 ** cnt)
    nu_hat = nu / (1 - _B2 ** cnt)
    return -lr * (mu_hat / (torch.sqrt(nu_hat) + _EPS)), mu, nu, count


def _straight(starts, targets, n_waypoints):
    """Straight lines [P, N, dof] with jnp.linspace's arithmetic: start +
    i * delta, the end exactly."""
    delta = (targets - starts) / (n_waypoints - 1)
    line = (starts[:, None, :]
            + torch.arange(n_waypoints, dtype=starts.dtype,
                           device=starts.device)[None, :, None]
            * delta[:, None, :])
    line[:, -1] = targets
    return line


def _draws(generators, num_trials, n_waypoints, dof, dt, dev):
    """Uniform [0, 1) draws [P, T, N, dof], one CPU generator per problem
    (the restarts' random initial paths)."""
    return torch.stack([
        torch.rand((num_trials, n_waypoints, dof), generator=g, dtype=dt,
                   device=g.device) for g in generators]).to(dev)


def _endpoint_mask(n_waypoints, dt, dev):
    mask = torch.ones((n_waypoints, 1), dtype=dt, device=dev)
    mask[0] = 0.0
    mask[-1] = 0.0
    return mask


def _limits(robot):
    return torch.as_tensor(robot.limits if hasattr(robot, 'limits')
                           else robot.joint_limits, dtype=torch.float32)


def _first_trials(inits, offset, first, second=None):
    """Trial 0 (global index) of each problem = ``first``, trial 1 =
    ``second`` if given, where they fall in the block of trials [offset,
    offset + T) that ``inits`` [P, T, ...] holds."""
    T = inits.shape[1]
    for t, path in ((0, first), (1, second)):
        if path is not None and offset <= t < offset + T:
            inits[:, t - offset] = path


def _adam_batch_core(starts, targets, limits, init_firsts, rand,
                     robot_fkine: Callable, dist_est: Callable,
                     n_waypoints: int, maxiter: int, lr: float,
                     safety_margin, max_speed: float, history: bool = False,
                     dense_sub: int = 1, trials=None):
    """P problems x T restarts in one batch of paths, all steps in one
    loop.

    starts, targets [P, dof]; ``init_firsts`` [P, N, dof] or None; ``rand``
    [P, T, N, dof] uniform draws for the random restarts. Weights and
    thresholds: diff 1, collision/max_move/joint_limit 10; valid iff
    constraint <= 1e-2; a restart is done (frozen) once valid with
    ||grad|| < 1e-4. ``dist_est`` maps [B, dof] -> [B]. Returns per
    problem (solution [P, N, dof], cost, success, step, hist) with hist
    [P, T, maxiter, N, dof] when ``history``.

    ``trials`` (a ``parallel.sharding.RowShard``) marks ``rand`` as this
    rank's block of the restarts of a mesh: the restarts run here, and the
    per-restart bests of every rank are gathered before the choice, which
    is then the unsharded run's.
    """
    dev, dt = starts.device, starts.dtype
    P, T = rand.shape[:2]
    dof = starts.shape[-1]
    collision_w, max_move_w, joint_limit_w, dif_w = 10.0, 10.0, 10.0, 1.0
    lo, hi = limits[:, 0], limits[:, 1]

    # initial paths: trial 0 = the given init (or the straight line), the
    # straight line next when an init was given, the others random
    inits = rand * (hi - lo) + lo
    straight = _straight(starts, targets, n_waypoints)
    _first_trials(inits, 0 if trials is None else trials.offset,
                  straight if init_firsts is None else init_firsts,
                  None if init_firsts is None else straight)
    inits[:, :, 0] = starts[:, None]
    inits[:, :, -1] = targets[:, None]
    endpoint_mask = _endpoint_mask(n_waypoints, dt, dev)

    def loss_fn(p):
        # the collision term on the densified path, fixed endpoints excluded
        p_check = (utils.dense_path(p, dense_sub)
                   if dense_sub > 1 else p)[:, 1:-1]
        M = p_check.shape[1]

        def scores(_):
            return dist_est(p_check.reshape(-1, dof)).reshape(-1, M)

        diff, collision, max_move, joint_limit = _loss_terms(
            p, robot_fkine, scores, limits, safety_margin, max_speed)
        constraint = (collision_w * collision + max_move_w * max_move
                      + joint_limit_w * joint_limit)
        objective = dif_w * diff
        return objective + constraint, objective, constraint

    B = P * T
    p = inits.reshape(B, n_waypoints, dof)
    mu = torch.zeros_like(p)
    nu = torch.zeros_like(p)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    inf = torch.full((B,), float('inf'), dtype=dt, device=dev)
    b_loss, b_loss_obj, b_valid_obj = inf.clone(), inf.clone(), inf.clone()
    b_loss_p, b_valid_p = p.clone(), p.clone()
    b_loss_step = torch.zeros(B, dtype=torch.long, device=dev)
    b_valid_step = torch.zeros(B, dtype=torch.long, device=dev)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    hist = []
    for it in range(maxiter):
        with span('diffco.optim.step'):
            pv = p.detach().requires_grad_(True)
            with torch.enable_grad():
                with span('diffco.optim.loss'):
                    loss, objective, constraint = loss_fn(pv)
                with span('diffco.optim.backward'):
                    g, = torch.autograd.grad(loss.sum(), pv)
            loss, objective, constraint = (
                loss.detach(), objective.detach(), constraint.detach())
            with span('diffco.optim.update'):
                g = g * endpoint_mask
                gnorm = torch.sqrt(torch.sum(g ** 2, dim=(1, 2)))
                updates, new_mu, new_nu, new_count = _adam_update(
                    g, mu, nu, count, lr)
                d3 = done[:, None, None]
                freeze = done.to(dt)[:, None, None]
                p_new = p + updates * (1.0 - freeze)
                mu = torch.where(d3, mu, new_mu)
                nu = torch.where(d3, nu, new_nu)
                count = torch.where(done, count, new_count)
                p_next = torch.where(d3, p, p_new)

                better_loss = ~done & (loss < b_loss)
                bl3 = better_loss[:, None, None]
                b_loss = torch.where(better_loss, loss, b_loss)
                b_loss_p = torch.where(bl3, p, b_loss_p)
                b_loss_obj = torch.where(better_loss, objective, b_loss_obj)
                b_loss_step = torch.where(better_loss, it, b_loss_step)
                valid = constraint <= 1e-2
                better_valid = ~done & valid & (objective < b_valid_obj)
                b_valid_obj = torch.where(better_valid, objective,
                                          b_valid_obj)
                b_valid_p = torch.where(better_valid[:, None, None], p,
                                        b_valid_p)
                b_valid_step = torch.where(better_valid, it, b_valid_step)
                found = found | valid
                done = done | (valid & (gnorm < 1e-4))
                if history:
                    hist.append(p)
                p = p_next

    hists = (torch.stack(hist, dim=1).reshape(
        (P, T) + (maxiter, n_waypoints, dof)) if history else None)
    if trials is not None:
        # every rank's restarts, [P, T_local, ...] blocks along the restarts
        per_trial = [trials.gather(a.reshape((P, T) + a.shape[1:]), dim=1)
                     for a in (found, b_loss, b_valid_p, b_loss_p,
                               b_valid_obj, b_loss_obj, b_valid_step,
                               b_loss_step)]
        hists = None if hists is None else trials.gather(hists, dim=1)
        T = per_trial[0].shape[1]
        (found, b_loss, b_valid_p, b_loss_p, b_valid_obj, b_loss_obj,
         b_valid_step, b_loss_step) = [a.reshape((P * T,) + a.shape[2:])
                                       for a in per_trial]

    # per problem: the first restart with a valid solution, else the
    # lowest loss
    found = found.reshape(P, T)
    any_found = torch.any(found, dim=1)
    trial = torch.arange(T, device=dev).expand(P, T)
    first_valid = torch.argmin(torch.where(found, trial, T), dim=1)
    lowest = torch.argmin(b_loss.reshape(P, T), dim=1)
    sel = (torch.arange(P, device=dev) * T
           + torch.where(any_found, first_valid, lowest))
    solution = torch.where(any_found[:, None, None], b_valid_p[sel],
                           b_loss_p[sel])
    cost = torch.where(any_found, b_valid_obj[sel], b_loss_obj[sel])
    step_sel = torch.where(any_found, b_valid_step[sel], b_loss_step[sel])
    return solution, cost, any_found, step_sel, hists


def _adam_traj_core(start_cfg, target_cfg, limits, init_first, generator,
                    robot_fkine: Callable, dist_est: Callable,
                    n_waypoints: int, num_trials: int, maxiter: int,
                    lr: float, safety_margin, max_speed: float,
                    history: bool = False, dense_sub: int = 1, trials=None):
    """One problem's restarts through ``_adam_batch_core``: ``init_first``
    [N, dof] or None, the random restarts drawn from ``generator`` (all of
    them; with ``trials`` this rank's block of them runs). Returns
    (solution, cost, success, step, hist) with hist [T, maxiter, N, dof]
    when ``history``."""
    dof = start_cfg.shape[-1]
    rand = _draws([generator], num_trials, n_waypoints, dof,
                  start_cfg.dtype, start_cfg.device)
    if trials is not None:
        rand = rand[:, trials.rows]
    out = _adam_batch_core(
        start_cfg[None], target_cfg[None], limits,
        None if init_first is None else init_first[None], rand,
        robot_fkine, dist_est, n_waypoints, maxiter, lr, safety_margin,
        max_speed, history=history, dense_sub=dense_sub, trials=trials)
    solution, cost, success, step, hists = out
    return (solution[0], cost[0], success[0], step[0],
            None if hists is None else hists[0])


def _device_of(start_cfg):
    """The device an optimizer runs on: ``start_cfg``'s, CUDA for numpy
    inputs."""
    return start_cfg.device if torch.is_tensor(start_cfg) \
        else resolve_device(None)


def _mesh_shard(o, n: int):
    """``options['mesh']`` as a ``parallel.sharding.RowShard`` over n
    restarts or problems rounded up to a multiple of the mesh's first
    axis, or None without a mesh. The optimizers draw every restart's
    initial path on every rank and run the rank's block, under
    ``sharding.rank_local()`` (a meshed checker's score then scores the
    rank's own paths)."""
    if o.get('mesh') is None:
        return None
    from .parallel import sharding
    return sharding.row_shard(o['mesh'], n)


def _local(shard):
    """``sharding.rank_local()`` with a mesh, else nothing."""
    if shard is None:
        return contextlib.nullcontext()
    from .parallel import sharding
    return sharding.rank_local()


def _n_check(n_waypoints, dsub):
    """Points each restart checks per step: the densified interior with
    dense_sub > 1, else the n - 2 interior waypoints."""
    return ((n_waypoints - 1) * dsub - 1) if dsub > 1 else n_waypoints - 2


def adam_traj_optimize(robot, dist_est, start_cfg, target_cfg, options=None):
    """Penalty-method Adam trajectory optimization.

    ``dist_est`` maps [B, dof] -> [B] on the device of ``start_cfg`` (a
    tensor; numpy inputs go to CUDA). Restarts beyond the first draw their
    random initial paths from a CPU ``torch.Generator`` seeded with
    ``options['seed']``. Returns {start_cfg, target_cfg, cnt_check, cost,
    time, success, seed, solution}.

    ``options['mesh']`` (``parallel.make_mesh``) shards the restarts over
    the mesh's first axis, rounded up to a multiple of its size: every
    rank draws all restarts' initial paths, runs its block and the best is
    chosen over all of them (with restarts that divide the mesh, the
    unsharded run's result).
    """
    o = _default_options(options)
    lr = float(o['extra_optimizer_options'].get('lr', 5e-1))
    dev = _device_of(start_cfg)
    start_cfg = torch.as_tensor(start_cfg, dtype=torch.float32, device=dev)
    target_cfg = torch.as_tensor(target_cfg, dtype=torch.float32, device=dev)
    n_waypoints = int(o['N_WAYPOINTS'])
    generator = torch.Generator().manual_seed(int(o['seed']))
    init_first = None
    if o.get('init_solution') is not None:
        init_first = torch.as_tensor(
            _resample_init(o['init_solution'], n_waypoints), device=dev)
    limits = _limits(robot).to(dev)
    num_trials = int(o['NUM_RE_TRIALS'])
    dsub = int(o.get('dense_sub', 1))
    trials = _mesh_shard(o, num_trials)
    if trials is not None:
        num_trials = trials.n_pad

    start_t = time.time()
    with _local(trials):
        solution, cost, success, _, _ = _adam_traj_core(
            start_cfg, target_cfg, limits, init_first, generator,
            robot.fkine, dist_est, n_waypoints, num_trials,
            int(o['MAXITER']), lr, float(o['safety_margin']),
            float(o['max_speed']), history=bool(o['history']),
            dense_sub=dsub, trials=trials)
    solution = solution.cpu().numpy()
    elapsed = time.time() - start_t

    return {
        'start_cfg': start_cfg.cpu().numpy().tolist(),
        'target_cfg': target_cfg.cpu().numpy().tolist(),
        'cnt_check': num_trials * int(o['MAXITER']) * _n_check(n_waypoints,
                                                               dsub),
        'cost': float(cost),
        'time': elapsed,
        'success': bool(success),
        'seed': int(o['seed']),
        'solution': solution.tolist(),
    }


def adam_traj_optimize_batch(robot, dist_est, start_cfgs, target_cfgs,
                             options=None):
    """P trajectory-optimization problems as one batch: P x NUM_RE_TRIALS
    restarts x MAXITER Adam steps, each step one score call over every
    path of every problem (the serving-shaped entry point).

    Problem i draws its random restarts from a CPU ``torch.Generator``
    seeded ``seed + i``, in the order ``adam_traj_optimize`` draws them,
    so the records equal P independent calls with those seeds.
    ``options['init_solutions']`` [P, N_WAYPOINTS, dof] warm-starts trial 0
    of each problem (e.g. a batched repair of proxy solutions).
    ``options['mesh']`` shards the problems over the mesh's first axis
    (padded to a multiple of its size with repeats of the first problems,
    whose records are dropped). Returns a list of P record dicts.
    """
    o = _default_options(options)
    lr = float(o['extra_optimizer_options'].get('lr', 5e-1))
    dev = _device_of(start_cfgs)
    starts = torch.as_tensor(start_cfgs, dtype=torch.float32, device=dev)
    targets = torch.as_tensor(target_cfgs, dtype=torch.float32, device=dev)
    if starts.shape != targets.shape or starts.dim() != 2:
        raise ValueError(f'start_cfgs {tuple(starts.shape)} and target_cfgs '
                         f'{tuple(targets.shape)} must both be [P, dof]')
    P, dof = starts.shape
    n_waypoints = int(o['N_WAYPOINTS'])
    num_trials = int(o['NUM_RE_TRIALS'])
    seed = int(o['seed'])
    init_firsts = None
    if o.get('init_solutions') is not None:
        init_firsts = torch.as_tensor(np.asarray(o['init_solutions']),
                                      dtype=torch.float32, device=dev)
        if init_firsts.shape != (P, n_waypoints, dof):
            raise ValueError(f'init_solutions {tuple(init_firsts.shape)}, '
                             f'expected {(P, n_waypoints, dof)}')
    limits = _limits(robot).to(dev)
    dsub = int(o.get('dense_sub', 1))
    problems = _mesh_shard(o, P)
    # problem i of the padded set is problem i % P
    mine = torch.arange(P if problems is None else problems.n_pad) % P
    if problems is not None:
        mine = mine[problems.rows]
    generators = [torch.Generator().manual_seed(seed + int(i))
                  for i in mine]

    start_t = time.time()
    rand = _draws(generators, num_trials, n_waypoints, dof, starts.dtype,
                  dev)
    mine = mine.to(dev)
    with _local(problems):
        sols, costs, succs, _, _ = _adam_batch_core(
            starts[mine], targets[mine], limits,
            None if init_firsts is None else init_firsts[mine], rand,
            robot.fkine, dist_est, n_waypoints, int(o['MAXITER']), lr,
            float(o['safety_margin']), float(o['max_speed']),
            dense_sub=dsub)
    if problems is not None:
        sols, costs, succs = (problems.gather(t)[:P]
                              for t in (sols, costs, succs))
    sols, costs, succs = sols.cpu().numpy(), costs.tolist(), succs.tolist()
    elapsed = time.time() - start_t

    starts, targets = starts.cpu().numpy(), targets.cpu().numpy()
    cnt_check = num_trials * int(o['MAXITER']) * _n_check(n_waypoints, dsub)
    return [{'start_cfg': starts[i].tolist(),
             'target_cfg': targets[i].tolist(),
             'cnt_check': cnt_check,
             'cost': costs[i],
             'time': elapsed / P,
             'success': bool(succs[i]),
             'seed': seed + i,
             'solution': sols[i].tolist()} for i in range(P)]


# ---------------------------------------------------------------------------
# augmented Lagrangian


def _al_traj_core(start_cfg, target_cfg, limits, init_first, rand,
                  robot_fkine: Callable, dist_est: Callable,
                  n_waypoints: int, outer_iters: int, inner_iters: int,
                  lr: float, safety_margin, num_sub: int,
                  restore_iters: int = 0, trials=None):
    """Augmented-Lagrangian trajectory optimization over the restarts as
    one batch of paths [T, N, dof] (``rand`` [T, N, dof] uniform draws).

    Constraints per restart, each <= 0 required: ``segment_violations`` of
    the score on ``dense_path(p, num_sub)[1:-1]`` (one per segment) and
    the summed joint-limit violation. Objective: the squared FK
    displacement. ``outer_iters`` x ``inner_iters`` Adam steps on the AL,
    a fresh Adam state each outer iteration; then lambda <- max(0,
    lambda + mu g), mu <- min(2 mu, 1e4).

    ``restore_iters > 0`` appends a feasibility restoration: Adam (its own
    state) on 0.5 sum g^2 alone, each restart frozen, with its Adam state,
    from the step at which max g <= 1e-4. When the collision constraint
    is active at the optimum the AL leaves a residual above that gate;
    descent on sum g^2 only moves the path away from violated
    constraints. Selection: the feasible restart with the lowest
    objective, else the least summed violation. Returns (solution, cost,
    success, max violation). ``trials``: as ``_adam_batch_core``'s
    (``rand`` this rank's block of the restarts).
    """
    dev, dt = start_cfg.device, start_cfg.dtype
    T, _, dof = rand.shape
    lo, hi = limits[:, 0], limits[:, 1]

    def constraints(p):
        dense = utils.dense_path(p, num_sub)[:, 1:-1]
        s = dist_est(dense.reshape(-1, dof))
        s = s.reshape(dense.shape[:2] + s.shape[1:])
        g_col = utils.segment_violations(s, n_waypoints - 1, num_sub,
                                         safety_margin, batch_dims=1)
        g_jl = torch.sum(torch.clamp(lo - p, min=0.0)
                         + torch.clamp(p - hi, min=0.0), dim=(1, 2))
        return torch.cat([g_col, g_jl[:, None]], dim=1)

    def objective(p):
        cp = robot_fkine(p.reshape(-1, dof)).reshape(p.shape[0],
                                                      n_waypoints, -1)
        return torch.sum((cp[:, 1:] - cp[:, :-1]) ** 2, dim=(1, 2))

    endpoint_mask = _endpoint_mask(n_waypoints, dt, dev)

    def grad(loss_fn, p):
        """The masked gradient of loss_fn(p)[0] (per restart) and the
        detached rest of its outputs."""
        pv = p.detach().requires_grad_(True)
        with torch.enable_grad():
            out = loss_fn(pv)
            g, = torch.autograd.grad(out[0].sum(), pv)
        return g * endpoint_mask, [o.detach() for o in out[1:]]

    # trial 0 = the given init or the straight line (unlike Adam, no
    # straight line next to a given init), the others random
    inits = rand * (hi - lo) + lo
    _first_trials(inits[None], 0 if trials is None else trials.offset,
                  _straight(start_cfg[None], target_cfg[None], n_waypoints)[0]
                  if init_first is None else init_first)
    inits[:, 0] = start_cfg
    inits[:, -1] = target_cfg

    def al_loss(pv):   # the current outer iteration's lam and mu
        g = constraints(pv)
        return (objective(pv) + torch.sum(lam * g, dim=1)
                + 0.5 * mu * torch.sum(g * g, dim=1),)

    p = inits
    lam = torch.zeros((T, n_waypoints), dtype=dt, device=dev)
    mu = 10.0
    for _ in range(outer_iters):
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        count = torch.zeros(T, dtype=torch.int32, device=dev)
        for _ in range(inner_iters):
            g, _ = grad(al_loss, p)
            updates, m, v, count = _adam_update(g, m, v, count, lr)
            p = p + updates
        lam = torch.clamp(lam + mu * constraints(p), min=0.0)
        mu = min(mu * 2.0, 1e4)

    if restore_iters:
        def feas_loss(pv):
            g = constraints(pv)
            return 0.5 * torch.sum(g * g, dim=1), g.amax(dim=1)

        m, v = torch.zeros_like(p), torch.zeros_like(p)
        count = torch.zeros(T, dtype=torch.int32, device=dev)
        done = torch.zeros(T, dtype=torch.bool, device=dev)
        for _ in range(restore_iters):
            g, (gmax,) = grad(feas_loss, p)
            done = done | (gmax <= 1e-4)
            if bool(done.all()):    # every restart frozen: p is final
                break
            updates, new_m, new_v, new_count = _adam_update(g, m, v, count,
                                                            lr)
            d3 = done[:, None, None]
            p_new = p + updates * (1.0 - done.to(dt)[:, None, None])
            m = torch.where(d3, m, new_m)
            v = torch.where(d3, v, new_v)
            count = torch.where(done, count, new_count)
            p = torch.where(d3, p, p_new)

    with torch.no_grad():
        g = constraints(p)
        objs = objective(p)
    if trials is not None:
        p, g, objs = (trials.gather(a) for a in (p, g, objs))
    feasible = g.amax(dim=1) <= 1e-4
    any_found = torch.any(feasible)
    sel = torch.where(any_found,
                      torch.argmin(torch.where(feasible, objs, float('inf'))),
                      torch.argmin(g.sum(dim=1)))
    return p[sel], objs[sel], any_found, g[sel].amax()


def al_traj_optimize(robot, dist_est, start_cfg, target_cfg, options=None):
    """Augmented-Lagrangian trajectory optimization on the device of
    ``start_cfg`` (CUDA for numpy inputs): the constraint semantics of the
    scipy paths, all restarts in one batch. Options beyond Adam's:
    ``outer_iters`` (10), ``inner_iters`` (MAXITER // 10), ``num_sub`` (4),
    ``restore_iters`` (400; 0 turns the restoration epilogue off), lr in
    ``extra_optimizer_options`` (0.1). Trial 0 is ``init_solution`` or the
    straight line; the others are random, drawn from a CPU generator
    seeded ``seed``. ``options['mesh']`` shards the restarts as
    ``adam_traj_optimize`` does. Returns Adam's record plus
    ``max_violation``."""
    o = _default_options(options)
    o.setdefault('outer_iters', 10)
    o.setdefault('inner_iters', max(1, int(o['MAXITER']) // 10))
    o.setdefault('num_sub', 4)
    # 400 restoration steps close the worst residual of the JAX package's
    # Baxter study (benchmarks/baxter_al_budget.json); restarts frozen
    # once strictly feasible make the epilogue cheap
    o.setdefault('restore_iters', 400)
    lr = float(o['extra_optimizer_options'].get('lr', 1e-1))
    dev = _device_of(start_cfg)
    start_cfg = torch.as_tensor(start_cfg, dtype=torch.float32, device=dev)
    target_cfg = torch.as_tensor(target_cfg, dtype=torch.float32, device=dev)
    n_waypoints = int(o['N_WAYPOINTS'])
    num_trials = int(o['NUM_RE_TRIALS'])
    dof = start_cfg.shape[-1]
    init_first = None
    if o.get('init_solution') is not None:
        init_first = torch.as_tensor(
            _resample_init(o['init_solution'], n_waypoints), device=dev)
    limits = _limits(robot).to(dev)
    outer, inner = int(o['outer_iters']), int(o['inner_iters'])
    restore, num_sub = int(o['restore_iters']), int(o['num_sub'])

    trials = _mesh_shard(o, num_trials)
    if trials is not None:
        num_trials = trials.n_pad

    start_t = time.time()
    rand = _draws([torch.Generator().manual_seed(int(o['seed']))],
                  num_trials, n_waypoints, dof, start_cfg.dtype, dev)[0]
    with _local(trials):
        solution, cost, success, max_viol = _al_traj_core(
            start_cfg, target_cfg, limits, init_first,
            rand if trials is None else rand[trials.rows], robot.fkine,
            dist_est, n_waypoints, outer, inner, lr,
            float(o['safety_margin']), num_sub, restore_iters=restore,
            trials=trials)
    solution = solution.cpu().numpy()
    elapsed = time.time() - start_t
    n_dense = (n_waypoints - 1) * num_sub + 1
    return {
        'start_cfg': start_cfg.cpu().numpy().tolist(),
        'target_cfg': target_cfg.cpu().numpy().tolist(),
        'cnt_check': num_trials * (outer * inner + restore) * n_dense,
        'cost': float(cost),
        'time': elapsed,
        'success': bool(success),
        'max_violation': float(max_viol),
        'seed': int(o['seed']),
        'solution': solution.tolist(),
    }


# ---------------------------------------------------------------------------
# scipy's host loops (SLSQP, trust-constr)


def _np64(t):
    if torch.is_tensor(t):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float64)


def _host_fns(build, dev, dt):
    """``build(dev, dt)``'s torch callables, each taking numpy arrays
    (moved to ``dt`` tensors on ``dev``) and returning float64 numpy (a
    tuple of them for a tuple)."""
    def wrap(fn):
        def call(*args):
            out = fn(*(torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
                       for a in args))
            return (tuple(_np64(t) for t in out) if isinstance(out, tuple)
                    else _np64(out))
        return call
    return {k: wrap(f) for k, f in build(dev, dt).items()}


def _scipy_fns(build, probe, o, start_cfg, closure):
    """The scipy paths' callables on their route: CPU float64 with
    ``options['scipy_fp64']`` (the default), else float32 on the device of
    ``start_cfg``. The float64 route is probed once: a user closure that
    cannot run in float64 is rebuilt in float32 on that device, with a
    warning naming it (the retry's own error propagates); a checker's
    ``score_fn`` (``follows_input``) must run in float64. Returns (fns,
    device, dtype)."""
    if not bool(o.get('scipy_fp64', True)):
        dev = _device_of(start_cfg)
        return _host_fns(build, dev, torch.float32), dev, torch.float32
    dev = torch.device('cpu')
    fns = _host_fns(build, dev, torch.float64)
    try:
        probe(fns)
    except Exception as err:
        if getattr(closure, 'follows_input', False):
            raise
        dev = _device_of(start_cfg)
        warnings.warn(f'{closure!r} does not run on CPU float64 tensors '
                      f'({err!r}); the scipy path evaluates it in float32 '
                      f'on {dev}', RuntimeWarning, stacklevel=3)
        fns = _host_fns(build, dev, torch.float32)
        probe(fns)
        return fns, dev, torch.float32
    return fns, dev, torch.float64


def _init_path(o, trial, rng, start_np, target_np, limits, n_waypoints):
    """Trial 0: ``init_solution`` (resampled, copied) or the straight
    line; later trials uniform within the limits from ``rng``; the
    endpoints pinned."""
    if trial == 0 and o.get('init_solution') is not None:
        path = np.array(_resample_init(o['init_solution'], n_waypoints),
                        np.float64)
    elif trial == 0:
        path = np.linspace(start_np, target_np, n_waypoints)
    else:
        path = (rng.rand(n_waypoints, start_np.shape[0])
                * (limits[:, 1] - limits[:, 0]) + limits[:, 0])
    path[0], path[-1] = start_np, target_np
    return path


def _scipy_setup(robot, start_cfg, target_cfg, options):
    o = _default_options(options)
    limits = _limits(robot).numpy().astype(np.float64)
    return (o, int(o['N_WAYPOINTS']), int(start_cfg.shape[-1]), limits,
            np.random.RandomState(int(o['seed'])), _np64(start_cfg),
            _np64(target_cfg))


def _jacobian(fn, x):
    """``torch.autograd.functional.jacobian``, its backward passes batched
    over the outputs (``vectorize``: the FK Functions' backward takes its
    plain torch ops, which batch, on a cotangent batched by vmap; the DH
    FK's VJP kernel takes only cotangents with storage,
    ``robots.fk_jvp.takes_kernel``)."""
    return torch.autograd.functional.jacobian(fn, x, vectorize=True)


def _hessian(fn, x):
    """``torch.autograd.functional.hessian``, vectorized as
    ``_jacobian``."""
    return torch.autograd.functional.hessian(fn, x, vectorize=True)


def _jl_violation(p, lim):
    return torch.sum(torch.clamp(lim[:, 0] - p, min=0.0)
                     + torch.clamp(p - lim[:, 1], min=0.0))


def _fk_displacement(robot, p):
    cp = robot.fkine(p)
    return torch.sum((cp[1:] - cp[:-1]) ** 2)


def givengrad_traj_optimize(robot, dist_est, start_cfg, target_cfg,
                            options=None):
    """SLSQP (scipy's host loop) with Jacobians from
    ``torch.autograd.functional.jacobian``, evaluated on CPU float64
    tensors unless ``options['scipy_fp64']`` is False. Constraints: the
    per-segment ``segment_violations`` of ``dist_est`` on the path
    densified ``num_sub`` times (default: the straight line's segment
    length over ``max_speed``, rounded up) and the joint limits; cost:
    the squared FK displacement. Returns the record with ``feasible`` (max
    violation <= 1e-4 at the returned path), ``num_sub`` and the
    evaluation's ``eval_device`` and ``eval_dtype``."""
    from scipy.optimize import minimize
    o, n_waypoints, dof, limits, rng, start_np, target_np = _scipy_setup(
        robot, start_cfg, target_cfg, options)
    margin = float(np.max(np.asarray(o['safety_margin'])))
    num_sub = o.get('num_sub')
    if num_sub is None:
        # the JAX package's density: ~1 point per segment at its defaults
        # on the straight-line seed, where a fixed 4 hands SLSQP a harder
        # feasible set (benchmarks/reference_flag_parity.json)
        seg = float(np.linalg.norm(target_np - start_np)) / max(
            n_waypoints - 1, 1)
        num_sub = max(1, int(np.ceil(seg / float(o.get('max_speed', 2.0)))))
    num_sub = int(num_sub)
    n_seg = n_waypoints - 1

    def build(dev, dt):
        lim = torch.as_tensor(limits, dtype=dt, device=dev)
        ends = [torch.as_tensor(e, dtype=dt, device=dev)[None]
                for e in (start_np, target_np)]

        def assemble(x):
            return torch.cat([ends[0], x.reshape(-1, dof), ends[1]])

        def con_collision(x):
            dense = utils.dense_path(assemble(x), num_sub)
            return -utils.segment_violations(dist_est(dense[1:-1]), n_seg,
                                             num_sub, margin)

        def con_jl(x):
            return -_jl_violation(assemble(x), lim)

        def cost(x):
            return _fk_displacement(robot, assemble(x))

        jac = _jacobian
        return {'f_col': con_collision, 'f_jl': con_jl, 'f_cost': cost,
                'jac_col': lambda x: jac(con_collision, x),
                'grad_jl': lambda x: jac(con_jl, x),
                'grad_cost': lambda x: jac(cost, x)}

    fns, dev, dt = _scipy_fns(
        build, lambda f: f['f_col'](np.zeros((n_waypoints - 2) * dof)), o,
        start_cfg, dist_est)
    f_col, f_jl, f_cost = fns['f_col'], fns['f_jl'], fns['f_cost']

    cnt_check = 0

    def count_col(x):
        nonlocal cnt_check
        cnt_check += n_seg * num_sub + 1
        return f_col(x)

    start_t = time.time()
    success = False
    lowest_const_loss = np.inf
    solution_rec = None
    for trial in range(int(o['NUM_RE_TRIALS'])):
        init_path = _init_path(o, trial, rng, start_np, target_np, limits,
                               n_waypoints)
        res = minimize(
            lambda x: float(f_cost(x)), init_path[1:-1].reshape(-1),
            jac=lambda x: fns['grad_cost'](x).reshape(-1),
            method='slsqp',
            constraints=[
                {'fun': count_col, 'type': 'ineq',
                 'jac': lambda x: fns['jac_col'](x).reshape(n_seg, -1)},
                {'fun': lambda x: float(f_jl(x)), 'type': 'ineq',
                 'jac': lambda x: fns['grad_jl'](x).reshape(-1)}],
            options={'maxiter': int(o['MAXITER']),
                     **o['extra_optimizer_options']})
        if res.success:
            success = True
            solution_rec = res
            break
        tmp = -(count_col(res.x).sum() + float(f_jl(res.x)))
        if tmp < lowest_const_loss:
            lowest_const_loss = tmp
            solution_rec = res
    elapsed = time.time() - start_t
    cnt_final = cnt_check   # before the feasibility check below
    sol = np.concatenate([start_np[None], solution_rec.x.reshape(-1, dof),
                          target_np[None]])
    feasible = bool(float(np.min(f_col(solution_rec.x))) >= -1e-4
                    and float(f_jl(solution_rec.x)) >= -1e-4)
    return {
        'start_cfg': start_np.tolist(),
        'target_cfg': target_np.tolist(),
        'cnt_check': cnt_final,
        'cost': float(solution_rec.fun),
        'time': elapsed,
        'success': success,
        'feasible': feasible,
        'seed': int(o['seed']),
        'num_sub': num_sub,
        'eval_device': str(dev),
        'eval_dtype': str(dt).replace('torch.', ''),
        'solution': sol.tolist(),
    }


def gradient_free_traj_optimize(robot, checker, start_cfg, target_cfg,
                                options=None):
    """trust-constr without gradients (scipy's finite differences), for
    binary checkers: ``checker`` maps [B, dof] -> scores, thresholded at
    exactly 0 (``safety_margin`` is ignored, as in the JAX package: a
    margin means nothing to a {0, 1} score). Evaluated on CPU float64
    tensors unless ``options['scipy_fp64']`` is False."""
    from scipy.optimize import minimize, NonlinearConstraint
    o, n_waypoints, dof, limits, rng, start_np, target_np = _scipy_setup(
        robot, start_cfg, target_cfg, options)
    num_sub = int(o.get('num_sub', 4))
    n_dense = (n_waypoints - 1) * num_sub + 1

    def pre(x):
        return np.concatenate([start_np[None], x.reshape(-1, dof),
                               target_np[None]])

    def build(dev, dt):
        return {'scores': lambda p: checker(
                    utils.dense_path(p, num_sub)[1:-1]),
                'fkine': robot.fkine}

    fns, dev, dt = _scipy_fns(
        build, lambda f: f['scores'](np.zeros((n_waypoints, dof))), o,
        start_cfg, checker)
    cnt_check = 0

    def con_collision(x):
        nonlocal cnt_check
        cnt_check += n_dense
        return -utils.segment_violations(fns['scores'](pre(x)),
                                         n_waypoints - 1, num_sub, 0.0,
                                         xp=np)

    def con_jl(x):
        p = pre(x)
        return -np.sum(np.maximum(limits[:, 0] - p, 0)
                       + np.maximum(p - limits[:, 1], 0))

    def cost(x):
        cp = fns['fkine'](pre(x))
        return float(((cp[1:] - cp[:-1]) ** 2).sum())

    start_t = time.time()
    success = False
    res = None
    for trial in range(int(o['NUM_RE_TRIALS'])):
        init_path = _init_path(o, trial, rng, start_np, target_np, limits,
                               n_waypoints)
        res = minimize(
            cost, init_path[1:-1].reshape(-1), method='trust-constr',
            constraints=[NonlinearConstraint(con_collision, 0, np.inf),
                         NonlinearConstraint(con_jl, 0, np.inf)],
            options={'maxiter': int(o['MAXITER']),
                     **o['extra_optimizer_options']})
        if res.success:
            success = True
            break
    elapsed = time.time() - start_t
    cnt_final = cnt_check   # before the feasibility check below
    feasible = bool(float(np.min(con_collision(res.x))) >= -1e-4
                    and float(con_jl(res.x)) >= -1e-4)
    return {
        'start_cfg': start_np.tolist(),
        'target_cfg': target_np.tolist(),
        'cnt_check': cnt_final,
        'cost': float(res.fun),
        'time': elapsed,
        'success': success,
        'feasible': feasible,
        'seed': int(o['seed']),
        'eval_device': str(dev),
        'eval_dtype': str(dt).replace('torch.', ''),
        'solution': pre(res.x).tolist(),
    }


def trustconstr_traj_optimize(robot, dist_est, start_cfg, target_cfg,
                              options=None):
    """trust-constr (scipy's host loop) with the collision constraint's
    Jacobian and multiplier-weighted Hessian from
    ``torch.autograd.functional.jacobian`` / ``hessian``, evaluated on CPU
    float64 tensors unless ``options['scipy_fp64']`` is False.

    - ``constraint_form``: 'max' (default), ``margin - max score`` per
      segment, the feasible set of the reference's clamped sum but with a
      nonzero Jacobian on and inside the boundary, which the interior-point
      method needs to certify optimality; 'clamp' is the reference's
      ``-segment_violations``.
    - ``constraint_hess``: 'analytic' (default) or 'bfgs' (scipy's
      quasi-Newton update, no Hessian evaluations).
    - ``free_waypoints`` K (default N_WAYPOINTS): optimize K control
      waypoints, linearly interpolated to the N_WAYPOINTS rows by a fixed
      matrix W; the constraints hold on the same densified full path.

    Value and Jacobian are evaluated together, memoised on x (scipy asks
    for them at the same points). Returns the record with ``feasible``,
    ``eval_device`` and ``eval_dtype``."""
    from scipy.optimize import minimize, NonlinearConstraint, BFGS
    o, n_waypoints, dof, limits, rng, start_np, target_np = _scipy_setup(
        robot, start_cfg, target_cfg, options)
    margin = float(np.max(np.asarray(o['safety_margin'])))
    num_sub = int(o.get('num_sub', 4))
    n_dense = (n_waypoints - 1) * num_sub + 1
    n_seg = n_waypoints - 1
    use_max_form = str(o.get('constraint_form', 'max')) == 'max'

    # K control waypoints interpolated to the full n_waypoints rows by a
    # fixed W (its rows at t = 0 and 1 exact, so the endpoints hold); the
    # identity when K == n_waypoints
    k_ctrl = int(o.get('free_waypoints') or n_waypoints)
    k_ctrl = max(3, min(k_ctrl, n_waypoints))
    tgrid = np.linspace(0.0, k_ctrl - 1.0, n_waypoints)
    jseg = np.minimum(tgrid.astype(int), k_ctrl - 2)
    frac = tgrid - jseg
    W_np = np.zeros((n_waypoints, k_ctrl))
    W_np[np.arange(n_waypoints), jseg] = 1.0 - frac
    W_np[np.arange(n_waypoints), jseg + 1] += frac
    ctrl_idx = np.round(np.linspace(0, n_waypoints - 1, k_ctrl)).astype(int)
    n_free = (k_ctrl - 2) * dof

    def build(dev, dt):
        lim = torch.as_tensor(limits, dtype=dt, device=dev)
        ends = [torch.as_tensor(e, dtype=dt, device=dev)[None]
                for e in (start_np, target_np)]
        W = torch.as_tensor(W_np, dtype=dt, device=dev)

        def assemble(x):
            ctrl = torch.cat([ends[0], x.reshape(-1, dof), ends[1]])
            if k_ctrl == n_waypoints:
                return ctrl
            with fp32_matmul():
                return W @ ctrl

        def con_collision(x):
            dense = utils.dense_path(assemble(x), num_sub)
            scores = dist_est(dense[1:-1])
            if use_max_form:
                return margin - utils.segment_max_scores(scores, n_seg,
                                                         num_sub)
            return -utils.segment_violations(scores, n_seg, num_sub, margin)

        def con_jl(x):
            return -_jl_violation(assemble(x), lim)

        def cost(x):
            return _fk_displacement(robot, assemble(x))

        jac, hess = _jacobian, _hessian
        return {
            'col_val_jac': lambda x: (con_collision(x),
                                      jac(con_collision, x), con_jl(x),
                                      jac(con_jl, x)),
            'cost_val_grad': lambda x: (cost(x), jac(cost, x)),
            # H(x, v) = d^2/dx^2 [v . c(x)]
            'hess_col': lambda x, v: hess(
                lambda y: torch.dot(con_collision(y), v), x),
        }

    fns, dev, dt = _scipy_fns(
        build, lambda f: f['col_val_jac'](np.zeros(n_free)), o, start_cfg,
        dist_est)
    cnt_check = 0
    memo, cost_memo = {}, {}

    def _bundle(x):
        key = np.asarray(x, np.float64).tobytes()
        if memo.get('key') != key:
            nonlocal cnt_check
            cnt_check += n_dense
            cv, cj, jv, jj = fns['col_val_jac'](x)
            memo.update(key=key, col=cv, col_jac=cj.reshape(n_seg, n_free),
                        jl=float(jv), jl_jac=jj.reshape(1, -1))
        return memo

    def _cost_bundle(x):
        key = np.asarray(x, np.float64).tobytes()
        if cost_memo.get('key') != key:
            fv, gv = fns['cost_val_grad'](x)
            cost_memo.update(key=key, f=float(fv), g=gv.reshape(-1))
        return cost_memo

    if str(o.get('constraint_hess', 'analytic')) == 'bfgs':
        hess_arg = BFGS()
    else:
        def hess_arg(x, v):
            return fns['hess_col'](x, v).reshape(n_free, n_free)

    def count_col(x):
        return _bundle(x)['col']

    start_t = time.time()
    success = False
    lowest_const_loss = np.inf
    solution_rec = None
    for trial in range(int(o['NUM_RE_TRIALS'])):
        init_path = _init_path(o, trial, rng, start_np, target_np, limits,
                               n_waypoints)
        res = minimize(
            lambda x: _cost_bundle(x)['f'],
            init_path[ctrl_idx][1:-1].reshape(-1),
            jac=lambda x: _cost_bundle(x)['g'],
            method='trust-constr',
            constraints=[
                NonlinearConstraint(count_col, 0, np.inf,
                                    jac=lambda x: _bundle(x)['col_jac'],
                                    hess=hess_arg),
                NonlinearConstraint(lambda x: _bundle(x)['jl'], 0, np.inf,
                                    jac=lambda x: _bundle(x)['jl_jac'])],
            options={'maxiter': int(o['MAXITER']),
                     **o['extra_optimizer_options']})
        if res.success:
            success = True
            solution_rec = res
            break
        tmp = -(count_col(res.x).sum() + _bundle(res.x)['jl'])
        if tmp < lowest_const_loss:
            lowest_const_loss = tmp
            solution_rec = res
    elapsed = time.time() - start_t
    cnt_final = cnt_check   # before the feasibility check below
    ctrl_sol = np.concatenate([start_np[None],
                               solution_rec.x.reshape(-1, dof),
                               target_np[None]])
    fin = _bundle(solution_rec.x)
    feasible = bool(float(np.min(fin['col'])) >= -1e-4
                    and fin['jl'] >= -1e-4)
    return {
        'start_cfg': start_np.tolist(),
        'target_cfg': target_np.tolist(),
        'cnt_check': cnt_final,
        'cost': float(solution_rec.fun),
        'time': elapsed,
        'success': success,
        'feasible': feasible,
        'seed': int(o['seed']),
        'eval_device': str(dev),
        'eval_dtype': str(dt).replace('torch.', ''),
        'solution': (W_np @ ctrl_sol).tolist(),
    }


# ---------------------------------------------------------------------------
# the MPC-style stepper

OptimizerResult = namedtuple('OptimizerResult', ['x', 'misc'])


class TrajOptimizer:
    def __init__(self, robot, checker, options):
        self.robot = robot
        self.checker = checker
        self.options = options
        self.normalizer = lambda x: x
        self.unnormalizer = lambda x: x

    def step(self, x):
        raise NotImplementedError

    def set_unnormalizer(self, f):
        self.unnormalizer = f

    def set_normalizer(self, f):
        self.normalizer = f

    def set_checker(self, checker):
        self.checker = checker

    def set_robot(self, robot):
        self.robot = robot


class Weighted(TrajOptimizer):
    """Weighted-penalty stepper: ``step`` runs up to ``maxiter`` Adam steps
    on the weighted loss (a fresh Adam state per call), applies
    ``robot.wrap`` after each, stops once the constraint loss is <= 0.5,
    and returns the (normalized) path. ``checker`` is a proxy: its
    ``rbf_score`` if it has one, else its ``poly_score``. Runs on the
    device of the path (CUDA for numpy input)."""

    def __init__(self, robot, checker, options):
        super().__init__(robot, checker, options)
        self.n_waypoints = options['n_waypoints']
        self.maxiter = options['maxiter']
        self.history = options.get('history', False)
        self.dif_weight = 1.0
        self.max_move_weight = options['max_move_weight']
        self.collision_weight = options['collision_weight']
        self.joint_limit_weight = options['joint_limit_weight']
        self.safety_bias = options['safety_bias']
        self.max_speed = options['max_speed']
        self.lr = options.get('optimizer_params', {}).get('lr', 1e-1)
        self.dense_check = options.get('dense_check', False)
        self.num_sub = options.get('num_sub', 4)
        self._logger = None

    def setup_logger(self, logger):
        self._logger = logger

    def step(self, p, maxiter=None, mask=None, write=True, verbose=False):
        del write, verbose
        start_t = time.time()
        p = torch.as_tensor(p, dtype=torch.float32, device=_device_of(p))
        p = self.unnormalizer(p)
        maxiter = int(maxiter if maxiter is not None else self.maxiter)
        limits = _limits(self.robot).to(p.device)
        dist_est = (self.checker.rbf_score
                    if hasattr(self.checker, 'rbf_score')
                    else self.checker.poly_score)
        grad_mask = (torch.ones((p.shape[0], 1), dtype=p.dtype,
                                device=p.device) if mask is None else
                     torch.as_tensor(mask, dtype=p.dtype,
                                     device=p.device).reshape(-1, 1))

        def loss_fn(p):
            collision = 0.0
            if self.collision_weight != 0:
                check_p = (utils.dense_path(p, self.num_sub)
                           if self.dense_check else p)
                collision = torch.mean(torch.clamp(
                    dist_est(check_p) + self.safety_bias,
                    min=0.0)) * p.shape[0]
            cp = self.robot.fkine(p)
            seg = cp[1:] - cp[:-1]
            max_move = torch.sum(torch.clamp(
                torch.sum(seg ** 2, dim=2) - self.max_speed ** 2, min=0.0))
            diff = torch.sum(seg ** 2)
            constraint = (self.collision_weight * collision
                          + self.max_move_weight * max_move
                          + self.joint_limit_weight * _jl_violation(p,
                                                                    limits))
            return self.dif_weight * diff + constraint, constraint

        m, v = torch.zeros_like(p), torch.zeros_like(p)
        count = torch.zeros((), dtype=torch.int32, device=p.device)
        path_history = []
        for _ in range(maxiter):
            pv = p.detach().requires_grad_(True)
            with torch.enable_grad():
                loss, constraint = loss_fn(pv)
                g, = torch.autograd.grad(loss, pv)
            updates, m, v, count = _adam_update(g * grad_mask, m, v, count,
                                                self.lr)
            p = self.robot.wrap(p + updates)
            if self.history:
                path_history.append(self.normalizer(p).cpu().numpy())
            if float(constraint.detach()) <= 0.5:
                break
        return OptimizerResult(
            x=self.normalizer(p), misc={'path_history': path_history,
                                        'time': time.time() - start_t})
