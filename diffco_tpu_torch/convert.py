"""Carry a fitted checker's state across from the JAX package.

The arrays are plain numpy, taken off a fitted ``diffco_tpu`` checker
(``np.asarray`` of each ``DiffCo`` attribute), so this module needs
nothing of JAX. Once loaded, both packages compute the same scores.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .kernels import Polyharmonic

# DiffCo attributes carried as tensors (float32 unless noted)
_TENSOR_FIELDS = ('support_points', 'support_transformed', 'gains',
                  'hypothesis', 'y', 'kernel_matrix', 'rbf_nodes')


def load_reference_state(checker, arrays: Dict[str, np.ndarray]):
    """Fill a port checker (``RBFDiffCo`` / ``ForwardKinematicsDiffCo``)
    with a fitted state: ``support_points``, ``support_transformed``,
    ``gains``, ``hypothesis``, ``y``, ``kernel_matrix``, ``rbf_nodes``,
    ``valid_mask``, ``num_valid``, the linear ``Polyharmonic`` epsilon
    (``epsilon``) and ``safety_bias``. Returns the checker."""
    p = checker.perceptron
    dev = checker.device
    for k in _TENSOR_FIELDS:
        setattr(p, k, torch.tensor(np.asarray(arrays[k], np.float32),
                                   device=dev))
    p.valid_mask = torch.tensor(np.asarray(arrays['valid_mask'], bool),
                                device=dev)
    p.num_valid = int(arrays['num_valid'])
    p.rbf_kernel = Polyharmonic(k=1, epsilon=float(arrays['epsilon']))
    checker.safety_bias = float(arrays['safety_bias'])
    checker.perceptron_trained = True
    return checker
