"""Penalty-method Adam trajectory optimization (PyTorch counterpart of
``diffco_tpu/optim.py``: ``_default_options``, ``_resample_init``,
``_loss_terms``, ``_adam_traj_core``, ``adam_traj_optimize``).

All restarts run together as one batch of paths [T, N, dof]: every step
evaluates the loss of every restart with one score call, one FK call and
one backward, and applies Adam (optax's defaults, written out by hand)
with a per-restart freeze once a restart has converged. Nothing returns
to the host until the end.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import utils

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
    """Penalty terms of paths p [T, N, dof], each [T]."""
    scores = dist_est(p)                                   # [T, M]
    collision = torch.sum(torch.clamp(scores - safety_margin, min=0.0), -1)
    T, N, dof = p.shape
    cp = robot_fkine(p.reshape(T * N, dof)).reshape(T, N, -1, 3)
    seg = cp[:, 1:] - cp[:, :-1]
    max_move = torch.sum(torch.clamp(
        torch.sum(seg ** 2, dim=3) - max_speed ** 2, min=0.0), dim=(1, 2))
    joint_limit = torch.sum(torch.clamp(limits[:, 0] - p, min=0.0)
                            + torch.clamp(p - limits[:, 1], min=0.0),
                            dim=(1, 2))
    diff = torch.sum(seg ** 2, dim=(1, 2, 3))
    return diff, collision, max_move, joint_limit


def _adam_traj_core(start_cfg, target_cfg, limits, init_first, generator,
                    robot_fkine: Callable, dist_est: Callable,
                    n_waypoints: int, num_trials: int, maxiter: int,
                    lr: float, safety_margin, max_speed: float,
                    history: bool = False, dense_sub: int = 1):
    """All restarts in one batch, all steps in one loop.

    Weights and thresholds: diff 1, collision/max_move/joint_limit 10;
    valid iff constraint <= 1e-2; a restart is done (frozen) once valid
    with ||grad|| < 1e-4. ``init_first`` [N, dof] or None. ``dist_est``
    maps [B, dof] -> [B]. Returns (solution, cost, success, step, hist)
    with hist [T, maxiter, N, dof] when ``history``.
    """
    dev, dt = start_cfg.device, start_cfg.dtype
    dof = start_cfg.shape[-1]
    collision_w, max_move_w, joint_limit_w, dif_w = 10.0, 10.0, 10.0, 1.0
    lo, hi = limits[:, 0], limits[:, 1]

    # initial paths: trial 0 = the given init (or the straight line), the
    # straight line next when an init was given, the others random
    rand = torch.rand((num_trials, n_waypoints, dof), generator=generator,
                      dtype=dt, device=generator.device).to(dev)
    inits = rand * (hi - lo) + lo
    # jnp.linspace's arithmetic: start + i * delta, the end exactly
    delta = (target_cfg - start_cfg) / (n_waypoints - 1)
    straight = (start_cfg + torch.arange(n_waypoints, dtype=dt, device=dev)
                [:, None] * delta)
    straight[-1] = target_cfg
    if init_first is None:
        inits[0] = straight
    else:
        inits[0] = init_first
        if num_trials > 1:
            inits[1] = straight
    inits[:, 0] = start_cfg
    inits[:, -1] = target_cfg

    endpoint_mask = torch.ones((n_waypoints, 1), dtype=dt, device=dev)
    endpoint_mask[0] = 0.0
    endpoint_mask[-1] = 0.0

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

    T = num_trials
    p = inits
    mu = torch.zeros_like(p)
    nu = torch.zeros_like(p)
    count = torch.zeros(T, dtype=torch.int32, device=dev)
    done = torch.zeros(T, dtype=torch.bool, device=dev)
    inf = torch.full((T,), float('inf'), dtype=dt, device=dev)
    b_loss, b_loss_obj, b_valid_obj = inf.clone(), inf.clone(), inf.clone()
    b_loss_p, b_valid_p = p.clone(), p.clone()
    b_loss_step = torch.zeros(T, dtype=torch.long, device=dev)
    b_valid_step = torch.zeros(T, dtype=torch.long, device=dev)
    found = torch.zeros(T, dtype=torch.bool, device=dev)
    hist = []
    for it in range(maxiter):
        pv = p.detach().requires_grad_(True)
        with torch.enable_grad():
            loss, objective, constraint = loss_fn(pv)
            g, = torch.autograd.grad(loss.sum(), pv)
        loss, objective, constraint = (
            loss.detach(), objective.detach(), constraint.detach())
        g = g * endpoint_mask
        gnorm = torch.sqrt(torch.sum(g ** 2, dim=(1, 2)))
        # optax.adam: moments, bias correction, -lr scaling
        new_mu = (1 - _B1) * g + _B1 * mu
        new_nu = (1 - _B2) * g ** 2 + _B2 * nu
        new_count = count + 1
        cnt = new_count.to(dt)[:, None, None]
        mu_hat = new_mu / (1 - _B1 ** cnt)
        nu_hat = new_nu / (1 - _B2 ** cnt)
        updates = -lr * (mu_hat / (torch.sqrt(nu_hat) + _EPS))
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
        b_valid_obj = torch.where(better_valid, objective, b_valid_obj)
        b_valid_p = torch.where(better_valid[:, None, None], p, b_valid_p)
        b_valid_step = torch.where(better_valid, it, b_valid_step)
        found = found | valid
        done = done | (valid & (gnorm < 1e-4))
        if history:
            hist.append(p)
        p = p_next

    # prefer the first restart with a valid solution, else the lowest loss
    any_found = torch.any(found)
    valid_rank = torch.where(found, torch.arange(T, device=dev),
                             torch.full((T,), T, device=dev))
    first_valid = torch.argmin(valid_rank)
    lowest = torch.argmin(b_loss)
    sel = torch.where(any_found, first_valid, lowest)
    solution = torch.where(any_found, b_valid_p[sel], b_loss_p[sel])
    cost = torch.where(any_found, b_valid_obj[sel], b_loss_obj[sel])
    step_sel = torch.where(any_found, b_valid_step[sel], b_loss_step[sel])
    hists = torch.stack(hist, dim=1) if history else None
    return solution, cost, any_found, step_sel, hists


def adam_traj_optimize(robot, dist_est, start_cfg, target_cfg, options=None):
    """Penalty-method Adam trajectory optimization.

    ``dist_est`` maps [B, dof] -> [B] on the device of ``start_cfg`` (a
    tensor; numpy inputs go to CUDA). Restarts beyond the first draw their
    random initial paths from a CPU ``torch.Generator`` seeded with
    ``options['seed']``. Returns {start_cfg, target_cfg, cnt_check, cost,
    time, success, seed, solution}.
    """
    o = _default_options(options)
    if o.get('mesh') is not None:
        raise NotImplementedError(
            "options['mesh'] is not ported yet (ROADMAP A15)")
    lr = float(o['extra_optimizer_options'].get('lr', 5e-1))
    if torch.is_tensor(start_cfg):
        dev = start_cfg.device
    else:
        from .device import resolve_device
        dev = resolve_device(None)
    start_cfg = torch.as_tensor(start_cfg, dtype=torch.float32, device=dev)
    target_cfg = torch.as_tensor(target_cfg, dtype=torch.float32, device=dev)
    n_waypoints = int(o['N_WAYPOINTS'])
    generator = torch.Generator().manual_seed(int(o['seed']))
    init_first = None
    if o.get('init_solution') is not None:
        init_first = torch.as_tensor(
            _resample_init(o['init_solution'], n_waypoints), device=dev)
    limits = torch.as_tensor(robot.limits if hasattr(robot, 'limits')
                             else robot.joint_limits,
                             dtype=torch.float32).to(dev)
    num_trials = int(o['NUM_RE_TRIALS'])
    dsub = int(o.get('dense_sub', 1))

    start_t = time.time()
    solution, cost, success, _, _ = _adam_traj_core(
        start_cfg, target_cfg, limits, init_first, generator,
        robot.fkine, dist_est, n_waypoints, num_trials, int(o['MAXITER']),
        lr, float(o['safety_margin']), float(o['max_speed']),
        history=bool(o['history']), dense_sub=dsub)
    solution = solution.cpu().numpy()
    elapsed = time.time() - start_t

    n_check = ((n_waypoints - 1) * dsub - 1) if dsub > 1 else n_waypoints - 2
    return {
        'start_cfg': start_cfg.cpu().numpy().tolist(),
        'target_cfg': target_cfg.cpu().numpy().tolist(),
        'cnt_check': num_trials * int(o['MAXITER']) * n_check,
        'cost': float(cost),
        'time': elapsed,
        'success': bool(success),
        'seed': int(o['seed']),
        'solution': solution.tolist(),
    }
