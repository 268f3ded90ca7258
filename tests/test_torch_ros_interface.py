"""The port's ROS/MoveIt interface (``diffco_tpu_torch.ros_interface``)
against the JAX package's, each on its own mocked transport: the fake
``rospy`` / ``moveit_msgs`` / ``shape_msgs`` / ``geometry_msgs`` /
``sensor_msgs`` modules of tests/test_ros_interface.py, installed once per
package and the module reloaded on them, so that the labels, the service
requests and the published ``CollisionObject``s of the two can be
compared."""
import importlib
import sys
import types

import numpy as np
import pytest
import torch

from test_ros_interface import (_FakeCollisionObject, _FakeJointState,
                                _FakePlanningScene, _FakePose,
                                _FakePublisher, _FakeRequest,
                                _FakeRobotState, _FakeServiceProxy,
                                _FakeSolidPrimitive)

_ROS_MODULES = ['rospy', 'moveit_msgs', 'moveit_msgs.srv', 'moveit_msgs.msg',
                'shape_msgs', 'shape_msgs.msg', 'geometry_msgs',
                'geometry_msgs.msg', 'sensor_msgs', 'sensor_msgs.msg']
JOINT_NAMES = ['j1', 'j2', 'j3']


def _fake_ros():
    """A fresh fake transport: {module name: module} and its node state."""
    node_state = {'initialized': False, 'init_calls': 0}
    rospy = types.ModuleType('rospy')
    rospy.wait_for_service = lambda name, timeout=None: None
    rospy.ServiceProxy = _FakeServiceProxy
    rospy.Publisher = _FakePublisher

    def get_param(key, default=None):
        if key.endswith('/joint_names') and 'my_robot' in key:
            return list(JOINT_NAMES)
        return default
    rospy.get_param = get_param

    def init_node(name, anonymous=False, disable_signals=False):
        node_state['initialized'] = True
        node_state['init_calls'] += 1
    rospy.init_node = init_node
    core = types.ModuleType('rospy.core')
    core.is_initialized = lambda: node_state['initialized']
    rospy.core = core

    mods = {'rospy': rospy}
    for pkg, sub, names in (
            ('moveit_msgs', 'srv', {'GetStateValidity': object(),
                                    'GetStateValidityRequest': _FakeRequest}),
            ('moveit_msgs', 'msg', {'RobotState': _FakeRobotState,
                                    'PlanningScene': _FakePlanningScene,
                                    'CollisionObject': _FakeCollisionObject}),
            ('shape_msgs', 'msg', {'SolidPrimitive': _FakeSolidPrimitive}),
            ('geometry_msgs', 'msg', {'Pose': _FakePose}),
            ('sensor_msgs', 'msg', {'JointState': _FakeJointState})):
        top = mods.setdefault(pkg, types.ModuleType(pkg))
        mod = types.ModuleType(f'{pkg}.{sub}')
        for k, v in names.items():
            setattr(mod, k, v)
        setattr(top, sub, mod)
        mods[f'{pkg}.{sub}'] = mod
    return mods, node_state


@pytest.fixture()
def both(monkeypatch):
    """(port module, reference module), each reloaded on its own fake
    transport (its node state as ``_node_state``); both restored to their
    ROS-less state after the test."""
    import diffco_tpu.ros_interface as jri
    import diffco_tpu_torch.ros_interface as tri
    out = []
    for mod in (tri, jri):
        fakes, state = _fake_ros()
        for name, m in fakes.items():
            monkeypatch.setitem(sys.modules, name, m)
        importlib.reload(mod)
        mod._node_state = state
        out.append(mod)
    yield tuple(out)
    for name in _ROS_MODULES:
        sys.modules.pop(name, None)
    for mod in (tri, jri):
        importlib.reload(mod)


def _requests(env):
    return [(r.robot_state.joint_state.name,
             r.robot_state.joint_state.position) for r in env._sv.calls]


def test_ros_env_collision_labels(both):
    tri, jri = both
    q = np.array([[0.5, 0.0, 0.0], [-0.2, 1.0, 0.0], [0.1, -1.0, 2.0]])
    envs = [m.ROSRobotEnv(robot_topic='/my_robot') for m in both]
    assert all(m._node_state['initialized'] for m in both)
    assert envs[0]._n_dofs == envs[1]._n_dofs == 3
    labels = [env.collision(q) for env in envs]
    assert labels[0].dtype == bool
    assert labels[0].tolist() == labels[1].tolist() == [True, False, True]
    assert _requests(envs[0]) == _requests(envs[1])
    assert _requests(envs[0])[0] == (JOINT_NAMES, [0.5, 0.0, 0.0])
    # a tensor on the CPU is labelled as its numpy array
    assert envs[0].collision(torch.from_numpy(q)).tolist() == \
        labels[1].tolist()


def test_ros_env_flat_config(both):
    q = np.array([1.0, 0.0, 0.0])
    out = [m.ROSRobotEnv(robot_topic='/my_robot').collision(q).tolist()
           for m in both]
    assert out[0] == out[1] == [True]


def test_ros_env_missing_joint_names_fails_fast(both):
    for m in both:
        with pytest.raises(ValueError, match='joint_names'):
            m.ROSRobotEnv(robot_topic='/other_robot')


def test_init_node_called_once(both):
    for m in both:
        m.ROSRobotEnv(robot_topic='/my_robot')
        m.PlanningSceneModifier({})
        assert m._node_state['init_calls'] == 1


def _object(co):
    p = co.primitive_poses[0]
    return (co.id, co.header.frame_id, co.operation, co.primitives[0].type,
            co.primitives[0].dimensions, (p.position.x, p.position.y,
                                          p.position.z),
            (p.orientation.x, p.orientation.y, p.orientation.z,
             p.orientation.w))


def test_planning_scene_modifier_publishes_objects(both):
    published = []
    for m in both:
        obstacles = {
            'box': {'pose': [0, 0, 0], 'dim': [0.2, 0.3, 0.4],
                    'z_offset': 0.1},
            'tilted': {'pose': [0.5, 0.0, 0.2], 'dim': [0.1, 0.1, 0.1],
                       'orientation': (0.0, 0.0, 0.38268343, 0.92387953),
                       'frame_id': 'base'}}
        mod = m.PlanningSceneModifier(obstacles)
        mod.permute_obstacles({'box': [1.0, 2.0, 3.0]})
        assert obstacles['box']['pose'] == [1.0, 2.0, 3.0]
        assert len(mod._scene_pub.published) == 1
        scene = mod._scene_pub.published[0]
        assert scene.is_diff is True
        published.append([_object(co)
                          for co in scene.world.collision_objects])
    assert published[0] == published[1]
    box = published[0][0]
    assert box[0] == 'box' and box[2] == _FakeCollisionObject.ADD
    assert box[4] == [0.2, 0.3, 0.4]
    assert box[5][:2] == (1.0, 2.0)
    assert box[5][2] == pytest.approx(3.1)     # pose z + z_offset


def test_planning_scene_mesh_rejected(both):
    for m in both:
        mod = m.PlanningSceneModifier(
            {'m': {'pose': [0, 0, 0], 'is_mesh': True,
                   'mesh_file': 'x.stl', 'dim': [1, 1, 1]}})
        with pytest.raises(NotImplementedError):
            mod.publish_scene()


def test_import_error_without_ros():
    """Without rospy both raise a clear ImportError."""
    import diffco_tpu.ros_interface as jri
    import diffco_tpu_torch.ros_interface as tri
    for m in (tri, jri):
        if m._HAS_ROS:   # pragma: no cover - no ROS in this environment
            pytest.skip('real ROS present')
        with pytest.raises(ImportError):
            m.ROSRobotEnv(robot_topic='/x')
        with pytest.raises(ImportError):
            m.PlanningSceneModifier({})


def test_checker_robot_topic_takes_the_ros_robot(both):
    """CollisionChecker(robot_topic=...) builds a ROSRobotEnv and labels
    through its service, as the JAX package's checker does."""
    import jax.numpy as jnp
    import diffco_tpu as jdc
    import diffco_tpu_torch as tdc
    tri, jri = both
    q = np.array([[0.5, 0.0, 0.0], [-0.2, 1.0, 0.0]], np.float32)
    tck = tdc.CollisionChecker(robot_topic='/my_robot', device='cpu')
    jck = jdc.CollisionChecker(robot_topic='/my_robot')
    assert isinstance(tck.robot, tri.ROSRobotEnv)
    assert isinstance(jck.robot, jri.ROSRobotEnv)
    out = np.asarray(tck.collision(torch.from_numpy(q)))
    np.testing.assert_array_equal(out, np.asarray(jck.collision(
        jnp.asarray(q))))
    assert out.tolist() == [True, False]
