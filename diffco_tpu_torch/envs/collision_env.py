"""The collision-environment template (PyTorch counterpart of
``diffco_tpu/envs/collision_env.py``): the ground-truth checker interface
of a proxy's tutorial environments (``envs.panda_envs``)."""


class CollisionEnv:
    """A template collision environment, the ground-truth checker of a
    proxy collision checker."""

    def __init__(self):
        pass

    def is_collision(self, qs):
        raise NotImplementedError

    def distance(self, qs):
        raise NotImplementedError

    def sample_q(self):
        raise NotImplementedError

    def plot(self, qs):
        raise NotImplementedError
