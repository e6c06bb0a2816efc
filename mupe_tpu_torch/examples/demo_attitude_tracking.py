"""Attitude-controller tracking: command a sequence of roll / pitch
setpoints and report the tracking error (counterpart of
examples/demo_attitude_tracking.py).

    python -m mupe_tpu_torch.examples.demo_attitude_tracking [--device cpu]
"""
import torch

from mupe_tpu_torch.controllers import attitude_control, make_mixer
from mupe_tpu_torch.core import quaternion_to_euler
from mupe_tpu_torch.dynamics import hover_state, make_params, step
from mupe_tpu_torch.examples import device_arg

SETPOINTS = [(0.0, 0.0), (0.15, 0.0), (0.0, 0.15), (-0.15, -0.15), (0.0, 0.0)]


def main(device: str = "cuda") -> None:
    params = make_params("crazyflie", device)
    mixer = make_mixer("crazyflie", device)
    state = hover_state(params, torch.tensor([[[0.0, 0.0, 1.0]]], device=device),
                        torch.tensor([[[1.0, 0.0, 0.0, 0.0]]], device=device))
    dt = 0.01
    # the JAX demo's hover thrust, mass * gravity, kept as it is
    thrust = torch.full((1, 1, 1), float(params.mass * params.gravity), device=device)
    yaw_rate = torch.zeros((1, 1, 1), device=device)

    def run_1s(state, roll, pitch):
        target_roll = torch.full((1, 1, 1), roll, device=device)
        target_pitch = torch.full((1, 1, 1), pitch, device=device)
        for _ in range(100):
            cmds = attitude_control(mixer, state.quat, state.angvel, target_thrust=thrust,
                                    target_yaw_rate=yaw_rate, target_roll=target_roll,
                                    target_pitch=target_pitch)
            state, _ = step(params, state, cmds, dt)
        return state

    print("target_rp          achieved_rp            err[rad]")
    for roll, pitch in SETPOINTS:
        state = run_1s(state, roll, pitch)
        rpy = quaternion_to_euler(state.quat)[0, 0]
        err = float(torch.linalg.vector_norm(rpy[:2] - torch.tensor([roll, pitch], device=device)))
        print(f"({roll:+.2f},{pitch:+.2f})      "
              f"({float(rpy[0]):+.3f},{float(rpy[1]):+.3f})      {err:.4f}")


if __name__ == "__main__":
    main(device_arg())
