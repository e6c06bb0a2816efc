"""PID body-rate controller tracking: command a roll-rate setpoint and
print the response (counterpart of examples/demo_rate_tracking.py).

    python -m mupe_tpu_torch.examples.demo_rate_tracking [--device cpu]
"""
import math

import torch

from mupe_tpu_torch.controllers import PIDRateState, pid_rate_control
from mupe_tpu_torch.dynamics import hover_state, make_params, step
from mupe_tpu_torch.examples import device_arg


def main(device: str = "cuda") -> None:
    params = make_params("crazyflie", device)
    state = hover_state(params, torch.tensor([[[0.0, 0.0, 1.0]]], device=device),
                        torch.tensor([[[1.0, 0.0, 0.0, 0.0]]], device=device))
    pid = PIDRateState.zeros((1, 1), device=device)
    target = torch.tensor([[[45.0, 0.0, 0.0]]], device=device)  # deg/s roll
    thrust = torch.full((1, 1, 1), float(params.hover_throttle) * 2**16, device=device)
    print("t[s]  roll_rate[deg/s] (target 45)")
    for i in range(120):
        cmds, _, pid = pid_rate_control(state.quat, state.angvel, target, thrust, pid, 0.01)
        state, _ = step(params, state, cmds, 0.01)
        if i % 20 == 19:
            rate = float(state.body_rate[0, 0, 0]) * 180.0 / math.pi
            print(f"{(i+1)*0.01:4.2f}  {rate:8.2f}")


if __name__ == "__main__":
    main(device_arg())
