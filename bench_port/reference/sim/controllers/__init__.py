from .pid_rate import PIDRateState, pid_rate_control

__all__ = ["PIDRateState", "pid_rate_control"]
