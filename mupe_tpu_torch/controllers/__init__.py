from .dsl_pid import DSLPIDState, dsl_pid_control
from .lee import (
    LEE_GAINS,
    MixerParams,
    attitude_control,
    lee_position_control,
    make_mixer,
    rate_control,
)
from .pid_rate import PIDRateState, pid_rate_control

__all__ = [
    "PIDRateState",
    "pid_rate_control",
    "LEE_GAINS",
    "MixerParams",
    "attitude_control",
    "lee_position_control",
    "make_mixer",
    "rate_control",
    "DSLPIDState",
    "dsl_pid_control",
]
