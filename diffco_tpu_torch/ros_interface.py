"""ROS/MoveIt ground-truth interface (PyTorch counterpart of
``diffco_tpu/ros_interface.py``: ``ROSRobotEnv`` and
``PlanningSceneModifier``).

``ROSRobotEnv`` labels configurations with MoveIt's StateValidity service,
one service call per configuration; ``PlanningSceneModifier`` publishes
box obstacles to the planning scene as ``CollisionObject`` diffs. Both need
``rospy`` and the MoveIt messages, and raise ImportError without them. ROS
is middleware: nothing here touches the card, and the labels are host
numpy arrays (a checker moves them to its device).

The service-call and scene-diff plumbing is tested against a mocked
transport (tests/test_torch_ros_interface.py); behaviour against a live
MoveIt stack is untested.
"""
from __future__ import annotations

import numpy as np

try:
    import rospy
    from moveit_msgs.srv import GetStateValidity, GetStateValidityRequest
    from moveit_msgs.msg import RobotState, PlanningScene, CollisionObject
    from shape_msgs.msg import SolidPrimitive
    from geometry_msgs.msg import Pose
    from sensor_msgs.msg import JointState
    _HAS_ROS = True
except ImportError:
    _HAS_ROS = False


def _ensure_node(name: str):
    """Start a ROS node unless one is up: publishers and service proxies
    need one, and ``rospy.init_node`` may run only once per process."""
    is_init = getattr(getattr(rospy, 'core', None), 'is_initialized', None)
    if is_init is not None and is_init():
        return
    rospy.init_node(name, anonymous=True, disable_signals=True)


def _numpy(q):
    if hasattr(q, 'detach'):
        q = q.detach().cpu().numpy()
    return np.asarray(q)


class ROSRobotEnv:
    """Ground-truth checking through the MoveIt StateValidity service.
    The joint names come from the ``<robot_topic>/joint_names`` parameter
    (``joint_names`` without a topic)."""

    def __init__(self, robot_topic=None, planning_scene_topic=None,
                 name='', device=None):
        del device
        if not _HAS_ROS:
            raise ImportError(
                'ROSRobotEnv requires rospy + moveit_msgs; install ROS or '
                'use URDFRobot with a ShapeEnv for a self-contained ground '
                'truth.')
        self.name = name or (robot_topic or 'ros_robot').split('/')[-1]
        self.robot_topic = robot_topic
        self.planning_scene_topic = planning_scene_topic
        _ensure_node(f'diffco_{self.name}')
        rospy.wait_for_service('/check_state_validity', timeout=10)
        self._sv = rospy.ServiceProxy('/check_state_validity',
                                      GetStateValidity)
        param = (f'{robot_topic}/joint_names' if robot_topic
                 else 'joint_names')
        self._joint_names = rospy.get_param(param, None)
        if not self._joint_names:
            # fail at construction with the cause, not at the first query
            # with a reshape into (..., 0)
            raise ValueError(
                f'ROS param {param!r} is unset or empty; set it to the '
                f'ordered joint-name list for the StateValidity checks')
        self._n_dofs = len(self._joint_names)

    def collision(self, q, other=None, show=False):
        """bool [B]: True where MoveIt reports the configuration invalid.
        q: [B, dof] or one [dof] configuration, numpy or a tensor."""
        del other, show
        q = _numpy(q).reshape(-1, self._n_dofs)
        labels = np.zeros(len(q), bool)
        for i, cfg in enumerate(q):
            req = GetStateValidityRequest()
            rs = RobotState()
            rs.joint_state = JointState(name=self._joint_names,
                                        position=list(map(float, cfg)))
            req.robot_state = rs
            res = self._sv(req)
            labels[i] = not res.valid
        return labels


class PlanningSceneModifier:
    """Adds and moves box obstacles in the MoveIt planning scene by
    publishing ``CollisionObject`` diffs.

    obstacles: ``{name: {'pose': (x, y, z), 'dim': (dx, dy, dz),
    'orientation': (x, y, z, w) optional, 'z_offset': float optional,
    'frame_id': str optional}}``.
    """

    def __init__(self, obstacles: dict, port=None):
        del port
        if not _HAS_ROS:
            raise ImportError('PlanningSceneModifier requires rospy')
        self._obstacles = obstacles
        _ensure_node('diffco_scene_modifier')
        self._scene_pub = rospy.Publisher('planning_scene', PlanningScene,
                                          queue_size=5)

    def permute_obstacles(self, pose_dict):
        for name, pose in pose_dict.items():
            self._obstacles[name]['pose'] = pose
        self.publish_scene()

    def _collision_object(self, name, spec):
        if spec.get('is_mesh'):
            raise NotImplementedError(
                'mesh obstacles need moveit_commander.'
                'PlanningSceneInterface.add_mesh; use box dims here, or a '
                'ShapeEnv Mesh shape for a self-contained ground truth')
        co = CollisionObject()
        co.id = name
        co.header.frame_id = spec.get('frame_id', 'world')
        # ADD with an existing id replaces the object, so one diff both
        # creates and moves an obstacle
        co.operation = CollisionObject.ADD
        pose = Pose()
        p = spec.get('pose', (0.0, 0.0, 0.0))
        pose.position.x = float(p[0])
        pose.position.y = float(p[1])
        pose.position.z = float(p[2]) + float(spec.get('z_offset', 0.0))
        quat = spec.get('orientation') or (0.0, 0.0, 0.0, 1.0)
        (pose.orientation.x, pose.orientation.y,
         pose.orientation.z, pose.orientation.w) = map(float, quat)
        prim = SolidPrimitive()
        prim.type = SolidPrimitive.BOX
        prim.dimensions = [float(v) for v in spec['dim']]
        co.primitives = [prim]
        co.primitive_poses = [pose]
        return co

    def publish_scene(self):
        """Publish every tracked obstacle as a CollisionObject diff (an
        empty diff would change nothing in MoveIt)."""
        scene = PlanningScene()
        scene.is_diff = True
        scene.world.collision_objects = [
            self._collision_object(name, spec)
            for name, spec in self._obstacles.items()]
        self._scene_pub.publish(scene)
