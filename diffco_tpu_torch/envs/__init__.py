from .shape_env import ShapeEnv
from .presets2d import ENVS, get_env, narrow_env, random_env

__all__ = ['ShapeEnv', 'ENVS', 'get_env', 'narrow_env', 'random_env']
