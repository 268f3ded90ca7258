from .analytic import (Model, RevolutePlanarRobot, RigidPlanarBody,
                       RigidBody, DHParameters, DHChainRobot, PandaFK,
                       DualPandaFK, BaxterLeftArmFK, BaxterRightArmFK,
                       BaxterFK, BaxterDualArmFK)
from .kinematics import ChainSpec
from .urdf import URDFRobot, KUKAiiwa, FrankaPanda, TwoLinkRobot, TrifingerEdu

__all__ = ['Model', 'RevolutePlanarRobot', 'RigidPlanarBody', 'RigidBody',
           'DHParameters', 'DHChainRobot', 'PandaFK', 'DualPandaFK',
           'BaxterLeftArmFK', 'BaxterRightArmFK', 'BaxterFK',
           'BaxterDualArmFK', 'ChainSpec', 'URDFRobot', 'KUKAiiwa',
           'FrankaPanda', 'TwoLinkRobot', 'TrifingerEdu']
