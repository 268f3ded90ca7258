from .shape_env import ShapeEnv

__all__ = ['ShapeEnv']
