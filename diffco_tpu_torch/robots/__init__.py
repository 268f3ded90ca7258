from .analytic import Model, DHParameters, DHChainRobot, PandaFK

__all__ = ['Model', 'DHParameters', 'DHChainRobot', 'PandaFK']
