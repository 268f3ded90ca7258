"""diffco_tpu_torch: the PyTorch/CUDA port of ``diffco_tpu``.

Differentiable kernel-perceptron collision proxies for motion planning,
on PyTorch tensors, with hand-written CUDA kernels (``csrc/``) on the
hot paths. It holds the ``PandaFK`` and Baxter DH robots (``BaxterLeftArmFK``,
``BaxterRightArmFK``, ``BaxterFK``, the dual-arm ``BaxterDualArmFK`` and
``DualPandaFK``) and the URDF robots
(``URDFRobot``, ``FrankaPanda`` and the other convenience robots) with
their analytic FK derivatives, a ``ShapeEnv`` scene with the
``CapsuleChainCollision`` or sphere-model ground truth, the proxies
(``DiffCo``, the multi-class ``MultiDiffCo``, the distance-regressing
``DiffCoBeta`` and the vector-gain ``MultiDimDiffCo``),
``ForwardKinematicsDiffCo`` (fit, verify, collision_score, the
active-learning ``update``), the ``HybridForwardKinematicsDiffCo`` and
``OptimisticChecker`` that re-check the uncertain band with the ground
truth, ``corridor_update`` for a bare perceptron, and the
trajectory optimizers (``optim``: Adam, batched Adam, the augmented
Lagrangian, scipy's SLSQP and trust-constr, the ``Weighted`` stepper).
The planar path of the paper's 2-D experiments: the
``RevolutePlanarRobot`` and ``RigidPlanarBody`` robots, the 2-D ground
truth (``geometry.geometry2d``: ``Obstacles2D``,
``planar_robot_signed_dist``), the preset scenes (``envs.presets2d``),
dataset and checkpoint I/O (``routines``), the escape and FK-manifold
samplers (``sampler``: ``OptimSampler``) and the RRT-Connect and RRT*
planners (``planning``: ``MotionPlanner``, ``RRTStar``).
The rigid-body and scene-file path: the SE(3) free flyer ``RigidBody``,
the exp / log maps, quaternions and geodesic interpolation of ``se3``,
mesh obstacles in a ``ShapeEnv`` (sphere decompositions), the point-cloud
world ``PCDEnv``, the MoveIt ``.scene`` loader (``load_moveit_scene``)
and the tutorial Panda environments on the ``CollisionEnv`` template
(``envs.panda_envs``).
The multi-robot, temporal and host-side pieces: ``MultiURDFRobot``
(several URDF robots with concatenated configurations and inter-robot
checks), the space-time ``PointRobot1D`` with the moving-obstacle ground
truth of ``dynamics`` (``LinearMotion``, ``SineMotion``,
``Dynamic1DChecker``, ``temporal_dataset``), the reference's legacy
obstacle-list API (``legacy``: ``Obstacle``, ``FCLObstacle``,
``FCLChecker``, ``Simple1DDynamicObstacle``, ``Simple1DDynamicChecker``),
the timers, check counter and trace capture of ``profiling``, and the
float64 host oracle ``native`` (g++ at first use).
Multi-device scale-out on ``torch.distributed`` (``parallel``:
``make_mesh``, the sharded sweeps, Gram, fits and trajectory
optimization, SPMD; every ``mesh=`` argument and ``options['mesh']``),
the checkpoint pair ``routines.save_checker_dcp`` / ``load_checker_dcp``,
and the ROS/MoveIt interface (``ros_interface``; a checker's
``robot_topic=``).

Entry points run on CUDA unless the caller passes ``device='cpu'``; they
raise rather than fall back when no card is present. Nothing here imports
JAX or ``diffco_tpu``.
"""

from . import utils
from . import kernels
from . import optim
from . import routines
from . import se3
from .device import resolve_device
from .robots import (Model, RevolutePlanarRobot, RigidPlanarBody, RigidBody,
                     DHParameters, DHChainRobot, PandaFK,
                     DualPandaFK, BaxterLeftArmFK, BaxterRightArmFK,
                     BaxterFK, BaxterDualArmFK, PointRobot1D, ChainSpec)
from .robots.capsule_chain import CapsuleChainCollision
from .robots.urdf import (URDFRobot, MultiURDFRobot, KUKAiiwa, FrankaPanda,
                          TwoLinkRobot, TrifingerEdu, RopeRobot, parse_urdf,
                          robot_description_folder)
from .envs import ShapeEnv, PCDEnv, CollisionEnv, load_moveit_scene
from .geometry.geometry2d import (Obstacles2D, planar_robot_signed_dist,
                                  planar_robot_collision)
from .sampler import OptimSampler
from .planning import MotionPlanner, RRTStar
from .perceptron import (Perceptron, DiffCo, DiffCoBeta, MultiDiffCo,
                         MultiDimDiffCo)
from .checkers import (CollisionChecker, RBFDiffCo, ForwardKinematicsDiffCo,
                       HybridForwardKinematicsDiffCo, OptimisticChecker,
                       corridor_update)
from .convert import load_reference_state
from . import profiling
from .dynamics import (ObstacleMotion, LinearMotion, SineMotion,
                       Dynamic1DChecker, temporal_dataset)
# the reference's legacy obstacle-list names, which its experiment scripts
# still import
from . import legacy
from .legacy import (Obstacle, FCLObstacle, FCLChecker,
                     Simple1DDynamicObstacle, Simple1DDynamicChecker)
from .optim import (adam_traj_optimize, adam_traj_optimize_batch,
                    al_traj_optimize, givengrad_traj_optimize,
                    gradient_free_traj_optimize, trustconstr_traj_optimize,
                    TrajOptimizer, Weighted)

__all__ = [
    'utils', 'kernels', 'optim', 'routines', 'se3', 'resolve_device',
    'Model', 'RevolutePlanarRobot', 'RigidPlanarBody', 'RigidBody',
    'DHParameters', 'PointRobot1D', 'ChainSpec', 'MultiURDFRobot',
    'DHChainRobot', 'PandaFK', 'DualPandaFK', 'BaxterLeftArmFK',
    'BaxterRightArmFK', 'BaxterFK', 'BaxterDualArmFK', 'CapsuleChainCollision', 'URDFRobot',
    'KUKAiiwa', 'FrankaPanda', 'TwoLinkRobot', 'TrifingerEdu', 'RopeRobot',
    'parse_urdf',
    'robot_description_folder', 'ShapeEnv', 'PCDEnv', 'CollisionEnv',
    'load_moveit_scene', 'Obstacles2D',
    'planar_robot_signed_dist', 'planar_robot_collision', 'OptimSampler',
    'MotionPlanner', 'RRTStar',
    'Perceptron', 'DiffCo', 'DiffCoBeta', 'MultiDiffCo', 'MultiDimDiffCo',
    'CollisionChecker', 'RBFDiffCo',
    'ForwardKinematicsDiffCo', 'HybridForwardKinematicsDiffCo',
    'OptimisticChecker', 'corridor_update',
    'load_reference_state',
    'adam_traj_optimize', 'adam_traj_optimize_batch', 'al_traj_optimize',
    'givengrad_traj_optimize', 'gradient_free_traj_optimize',
    'trustconstr_traj_optimize', 'TrajOptimizer', 'Weighted',
    'profiling', 'ObstacleMotion', 'LinearMotion', 'SineMotion',
    'Dynamic1DChecker', 'temporal_dataset', 'legacy', 'Obstacle',
    'FCLObstacle', 'FCLChecker', 'Simple1DDynamicObstacle',
    'Simple1DDynamicChecker',
]
