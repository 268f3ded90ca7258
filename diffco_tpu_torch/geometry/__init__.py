from .geometry2d import (Obstacles2D, planar_robot_signed_dist,
                         planar_robot_collision, rect_rect_signed_dist,
                         rigid_body_signed_dist)
