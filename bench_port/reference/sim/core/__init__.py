from .math import const, cpos, normalize, off_diag, symexp, symlog
from .quat import (
    axis_angle_to_quaternion,
    euler_to_quaternion,
    quat_axis,
    quat_conjugate,
    quat_integrate,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_rotate_inverse,
    quaternion_to_euler,
    quaternion_to_rotation_matrix,
)

__all__ = [
    "const",
    "cpos",
    "normalize",
    "off_diag",
    "symexp",
    "symlog",
    "axis_angle_to_quaternion",
    "euler_to_quaternion",
    "quat_axis",
    "quat_conjugate",
    "quat_integrate",
    "quat_mul",
    "quat_normalize",
    "quat_rotate",
    "quat_rotate_inverse",
    "quaternion_to_euler",
    "quaternion_to_rotation_matrix",
]
