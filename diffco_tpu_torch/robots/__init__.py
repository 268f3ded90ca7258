from .analytic import (Model, RevolutePlanarRobot, RigidPlanarBody,
                       RigidBody, DHParameters, DHChainRobot, PandaFK,
                       DualPandaFK, BaxterLeftArmFK, BaxterRightArmFK,
                       BaxterFK, BaxterDualArmFK, PointRobot1D)
from .kinematics import ChainSpec
from .urdf import (URDFRobot, MultiURDFRobot, KUKAiiwa, FrankaPanda,
                   TwoLinkRobot, TrifingerEdu, RopeRobot)

__all__ = ['Model', 'RevolutePlanarRobot', 'RigidPlanarBody', 'RigidBody',
           'DHParameters', 'DHChainRobot', 'PandaFK', 'DualPandaFK',
           'BaxterLeftArmFK', 'BaxterRightArmFK', 'BaxterFK',
           'BaxterDualArmFK', 'PointRobot1D', 'ChainSpec', 'URDFRobot',
           'MultiURDFRobot', 'KUKAiiwa', 'FrankaPanda', 'TwoLinkRobot',
           'TrifingerEdu', 'RopeRobot']
