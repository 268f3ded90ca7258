"""diffco_tpu_torch: the PyTorch/CUDA port of ``diffco_tpu``.

Differentiable kernel-perceptron collision proxies for motion planning,
on PyTorch tensors, with hand-written CUDA kernels (``csrc/``) on the
hot paths. It holds the ``PandaFK`` DH robot and the URDF robots
(``URDFRobot``, ``FrankaPanda`` and the other convenience robots) with
their analytic FK derivatives, a ``ShapeEnv`` scene with the
``CapsuleChainCollision`` or sphere-model ground truth, the proxies
(``DiffCo``, the multi-class ``MultiDiffCo``, the distance-regressing
``DiffCoBeta`` and the vector-gain ``MultiDimDiffCo``),
``ForwardKinematicsDiffCo`` (fit, verify, collision_score) and Adam
trajectory optimization.

Entry points run on CUDA unless the caller passes ``device='cpu'``; they
raise rather than fall back when no card is present. Nothing here imports
JAX or ``diffco_tpu``.
"""

from . import utils
from . import kernels
from . import optim
from .device import resolve_device
from .robots import Model, DHParameters, DHChainRobot, PandaFK
from .robots.capsule_chain import CapsuleChainCollision
from .robots.urdf import (URDFRobot, KUKAiiwa, FrankaPanda, TwoLinkRobot,
                          TrifingerEdu, parse_urdf, robot_description_folder)
from .envs import ShapeEnv
from .perceptron import (Perceptron, DiffCo, DiffCoBeta, MultiDiffCo,
                         MultiDimDiffCo)
from .checkers import CollisionChecker, RBFDiffCo, ForwardKinematicsDiffCo
from .convert import load_reference_state

__all__ = [
    'utils', 'kernels', 'optim', 'resolve_device', 'Model', 'DHParameters',
    'DHChainRobot', 'PandaFK', 'CapsuleChainCollision', 'URDFRobot',
    'KUKAiiwa', 'FrankaPanda', 'TwoLinkRobot', 'TrifingerEdu', 'parse_urdf',
    'robot_description_folder', 'ShapeEnv',
    'Perceptron', 'DiffCo', 'DiffCoBeta', 'MultiDiffCo', 'MultiDimDiffCo',
    'CollisionChecker', 'RBFDiffCo',
    'ForwardKinematicsDiffCo', 'load_reference_state',
]
