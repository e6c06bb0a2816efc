from .params import DRONE_ZOO, QuadrotorParams, RigidBodyCfg, make_params
from .quadrotor import DroneState, hover_state, step

__all__ = ["DRONE_ZOO", "QuadrotorParams", "RigidBodyCfg", "make_params", "DroneState",
           "hover_state", "step"]
