"""Predefined 2-D experiment environments (the port's own copy of
``diffco_tpu/envs/presets2d.py``; numpy only).

The obstacle layouts of the reference's 2-D data-generation script
('1rect', '3circle', '1rect_1circle', '2class_1', '2class_2',
'1rect_active', '7d_narrow', ...) as obstacle tuple lists for
``geometry.geometry2d.Obstacles2D``, in the [-8, 8]^2 workspace of the
planar arms. Layouts and seeded ``RandomState`` draws are the JAX
package's, coordinate for coordinate.
"""
from __future__ import annotations

import numpy as np

# (kind, position, size[, class[, angle]])
# Layouts are COORDINATE-EXACT copies of the reference's
# predefined_obstacles (2d_data_generation.py:9-58) so datasets and
# benchmarks run under these names are like-for-like comparable.
ENVS = {
    '2circle': [('circle', (3, 2), 2.0),
                ('circle', (-2, 3), 0.5)],
    '1rect': [('rect', (3, 2), (2, 2))],
    '3circle': [('circle', (0, 4.5), 1.0),
                ('circle', (-2, -3), 2.0),
                ('circle', (-2, 2), 1.5)],
    '1rect_1circle': [('rect', (4, 3), (2, 2)),
                      ('circle', (-4, -3), 1.0)],
    '1rect_active': [('rect', (-7, 3), (2, 2))],
    '2rect': [('rect', (4, 3), (2, 2)),
              ('rect', (-4, -3), (2, 2))],
    '1rect_1circle_7d': [('circle', (-2, 3), 1.0),
                         ('rect', (3, 2), (2, 2))],
    '2class_1': [('rect', (5, 0), (2, 2), 0),
                 ('circle', (-3, 6), 1.0, 1),
                 ('rect', (-5, 2), (2, 1.5), 1),
                 ('circle', (-5, -2), 1.5, 1),
                 ('circle', (-3, -6), 1.0, 1)],
    '2class_2': [('rect', (0, 3), (16, 0.5), 1),
                 ('rect', (0, -3), (16, 0.5), 0)],
    '3circle_7d': [('circle', (-2, 2), 1.0),
                   ('circle', (-3, 3), 1.0),
                   ('circle', (-6, -3), 1.0)],
    '2instance_big': [('rect', (5, 4), (4, 4), 0),
                      ('circle', (-5, -4), 2.0, 1)],
}


def narrow_env(num_boxes=300, seed=1917, box_size=1.0, gap=2.0):
    """'7d_narrow': a wall of unit boxes with a narrow free corridor
    (ref 2d_data_generation.py:60-76: 150 boxes uniform in
    [-8, 8] x [1, 8] + 150 in [-8, 8] x [-8, -1], all size (1, 1) — the
    free band is |y| < 1). The reference never seeds its layout; a seeded
    rng here is the one deliberate difference (reproducibility)."""
    rng = np.random.RandomState(seed)
    obstacles = []
    half = num_boxes // 2
    for i in range(num_boxes):
        x = rng.uniform(-8, 8)
        lo, hi = (gap / 2, 8.0) if i < half else (-8.0, -gap / 2)
        y = rng.uniform(lo, hi)
        obstacles.append(('rect', (x, y), (box_size, box_size)))
    return obstacles


def random_env(num_obstacles=5, seed=0, kinds=('rect', 'circle'),
               workspace=8.0, min_size=0.5, max_size=2.0, num_class=1):
    """Random obstacle layout (ref generate_batch_data_2d.py random mode)."""
    rng = np.random.RandomState(seed)
    obstacles = []
    for i in range(num_obstacles):
        kind = kinds[rng.randint(len(kinds))]
        pos = tuple(rng.uniform(-workspace, workspace, 2))
        label = i % num_class
        if kind == 'circle':
            obstacles.append(('circle', pos,
                              rng.uniform(min_size, max_size), label))
        else:
            obstacles.append(('rect', pos,
                              (rng.uniform(min_size, max_size),
                               rng.uniform(min_size, max_size)), label))
    return obstacles


def get_env(name: str, **kwargs):
    if name == '7d_narrow':
        return narrow_env(**kwargs)
    if name.startswith('random'):
        return random_env(**kwargs)
    return ENVS[name]
