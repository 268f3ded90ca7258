"""Samplers (counterpart of ``diffco_tpu/sampler.py``): the path bands of
path-targeted active learning. Pure numpy; the escape sampler
(``OptimSampler``) and the FK-manifold sampler are not ported yet
(ROADMAP A13)."""
from __future__ import annotations

import numpy as np


def path_band_samples(paths, limits, rng, n_total=2048, num_sub=8,
                      scales=(0.05, 0.15, 0.35)):
    """Jittered bands around densified path(s): the corridor exploit set
    for path-targeted active learning (``RBFDiffCo.update(exploit_paths=)``,
    ``checkers.corridor_update``).

    Each path is densified to ``num_sub`` points per segment; 90 % of
    ``n_total`` are drawn from those points in equal shares per noise scale
    (the tightest band labels the corridor's interior, the wider ones
    straddle its walls) and the rest uniformly within the limits, so the
    total is exactly ``n_total``.

    paths: iterable of [N_i, dof] waypoint arrays (paths with fewer than 2
    waypoints are skipped; ValueError if none is left). limits: [dof, 2]
    joint limits. rng: a numpy ``RandomState`` (``randint``) or
    ``Generator`` (``integers``). Returns [n_total, dof] float32, clipped
    to the limits."""
    limits = np.asarray(limits, np.float64)
    bands = []
    for path in paths:
        p = np.asarray(path, np.float32)
        if p.ndim != 2 or p.shape[0] < 2:
            continue
        fr = (np.arange(num_sub, dtype=np.float32) / num_sub)[None, :, None]
        dense = (p[:-1][:, None, :]
                 + fr * (p[1:] - p[:-1])[:, None, :]).reshape(-1, p.shape[1])
        bands.append(dense)
    if not bands:
        raise ValueError('path_band_samples needs at least one path with '
                         '>= 2 waypoints')
    dense = np.concatenate(bands, axis=0)
    n_band = int(n_total * 0.9)
    per_scale = n_band // len(scales)
    out = []
    for s in scales:
        idx = rng.randint(0, dense.shape[0], per_scale) \
            if hasattr(rng, 'randint') \
            else rng.integers(0, dense.shape[0], per_scale)
        out.append(dense[idx] + rng.normal(size=(per_scale,
                                                 dense.shape[1])) * s)
    n_uniform = n_total - per_scale * len(scales)
    out.append(rng.uniform(limits[:, 0], limits[:, 1],
                           (n_uniform, dense.shape[1])))
    return np.clip(np.concatenate(out, axis=0),
                   limits[:, 0], limits[:, 1]).astype(np.float32)
