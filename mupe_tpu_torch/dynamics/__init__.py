from .dragon import (
    DragonCfg,
    DragonLinkState,
    dragon_init,
    dragon_state_vector,
    dragon_step,
)
from .params import DRONE_ZOO, QuadrotorParams, RigidBodyCfg, make_params
from .quadrotor import (
    DroneState,
    body_wrench,
    downwash_forces,
    hover_state,
    integrate,
    rotor_response,
    step,
)

__all__ = [
    "DragonCfg",
    "DragonLinkState",
    "dragon_init",
    "dragon_state_vector",
    "dragon_step",
    "DRONE_ZOO",
    "QuadrotorParams",
    "RigidBodyCfg",
    "make_params",
    "DroneState",
    "body_wrench",
    "downwash_forces",
    "hover_state",
    "integrate",
    "rotor_response",
    "step",
]
