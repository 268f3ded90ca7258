from .shape_env import ShapeEnv, PCDEnv
from .collision_env import CollisionEnv
from .moveit_scene import load_moveit_scene, parse_scene_text
from .panda_envs import (PandaEnv, PandaSingleCylinderEnv,
                         PandaThreeCylinderEnv, PandaSingleCuboidEnv)
from .presets2d import ENVS, get_env, narrow_env, random_env

__all__ = ['ShapeEnv', 'PCDEnv', 'CollisionEnv', 'load_moveit_scene',
           'parse_scene_text', 'PandaEnv', 'PandaSingleCylinderEnv',
           'PandaThreeCylinderEnv', 'PandaSingleCuboidEnv', 'ENVS',
           'get_env', 'narrow_env', 'random_env']
