"""Carry a fitted proxy's state across from the JAX package.

The arrays are plain numpy, taken off a fitted ``diffco_tpu`` checker or
perceptron (``np.asarray`` of each attribute), so this module needs
nothing of JAX. Once loaded, both packages compute the same scores. It
carries the state of a ``DiffCo``, a ``MultiDiffCo`` ([S, C] gains and
nodes), a ``DiffCoBeta`` (with its regressed distances) and a
``MultiDimDiffCo`` ([S, M, d] supports, [S, S, C] kernel matrix). The
target keeps its own transform: a q-space proxy (a ``RigidPlanarBody``'s
configurations) or one over any callable's features (a ``RigidBody``'s
``fkine`` behind a lambda) takes the same arrays.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .device import resolve_device
from .kernels import MultiDimRQKernel, MultiQuadratic, Polyharmonic

# proxy attributes carried as float32 tensors; 'distance' is optional
_TENSOR_FIELDS = ('support_points', 'support_transformed', 'gains',
                  'hypothesis', 'y', 'kernel_matrix', 'rbf_nodes')

# the surrogate kernel, by class name, from its parameters
_RBF_KERNELS = {
    'Polyharmonic': lambda a: Polyharmonic(k=int(a.get('k', 1)),
                                           epsilon=float(a['epsilon'])),
    'MultiQuadratic': lambda a: MultiQuadratic(float(a['epsilon'])),
    'MultiDimRQKernel': lambda a: MultiDimRQKernel(float(a['gamma']),
                                                   int(a.get('p', 2))),
}


def load_reference_state(target, arrays: Dict[str, np.ndarray],
                         device=None):
    """Fill a port checker (``RBFDiffCo`` / ``ForwardKinematicsDiffCo``,
    through its perceptron) or a bare perceptron with a fitted state.

    ``arrays`` holds ``support_points``, ``support_transformed``,
    ``gains``, ``hypothesis``, ``y``, ``kernel_matrix``, ``rbf_nodes``,
    ``valid_mask``, ``num_valid``; optionally ``distance`` and
    ``num_class`` (a ``MultiDiffCo``'s, else read off the gains); the
    surrogate kernel as ``rbf_kernel``, a class name with its parameters:
    ``Polyharmonic`` (the default; ``k``, default 1, and ``epsilon``),
    ``MultiQuadratic`` (``epsilon``) or ``MultiDimRQKernel`` (``gamma``,
    ``p``); and, for a checker, ``safety_bias``. A bare perceptron's
    tensors go to ``device`` (CUDA unless the caller asks for the CPU), a
    checker's to its own device. Returns ``target``."""
    checker = target if hasattr(target, 'perceptron') else None
    p = target if checker is None else checker.perceptron
    dev = resolve_device(device) if checker is None else checker.device
    fields = _TENSOR_FIELDS + (('distance',) if 'distance' in arrays else ())
    for k in fields:
        setattr(p, k, torch.tensor(np.asarray(arrays[k], np.float32),
                                   device=dev))
    p.valid_mask = torch.tensor(np.asarray(arrays['valid_mask'], bool),
                                device=dev)
    p.num_valid = int(arrays['num_valid'])
    if hasattr(p, 'num_class'):
        p.num_class = int(arrays.get('num_class', p.gains.shape[1]))
    name = str(np.asarray(arrays.get('rbf_kernel', 'Polyharmonic')))
    if name not in _RBF_KERNELS:
        raise ValueError(f'rbf_kernel {name!r} is not one of '
                         f'{sorted(_RBF_KERNELS)}')
    p.rbf_kernel = _RBF_KERNELS[name](arrays)
    if checker is not None:
        checker.safety_bias = float(arrays['safety_bias'])
        checker.perceptron_trained = True
    return target
