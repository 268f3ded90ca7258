from .analytic import Model, DHParameters, DHChainRobot, PandaFK
from .kinematics import ChainSpec
from .urdf import URDFRobot, KUKAiiwa, FrankaPanda, TwoLinkRobot, TrifingerEdu

__all__ = ['Model', 'DHParameters', 'DHChainRobot', 'PandaFK', 'ChainSpec',
           'URDFRobot', 'KUKAiiwa', 'FrankaPanda', 'TwoLinkRobot',
           'TrifingerEdu']
