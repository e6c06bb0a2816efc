"""Drone zoo: spawn each model and hold hover for 1 s
(counterpart of examples/demo_drone_zoo.py).

    python -m mupe_tpu_torch.examples.demo_drone_zoo [--device cpu]
"""
import torch

from mupe_tpu_torch.dynamics import DRONE_ZOO, hover_state, make_params, step
from mupe_tpu_torch.examples import device_arg


def main(device: str = "cuda") -> None:
    for name in DRONE_ZOO:
        params = make_params(name, device)
        pos = torch.tensor([[[0.0, 0.0, 1.0]]], device=device)
        state = hover_state(params, pos, torch.tensor([[[1.0, 0.0, 0.0, 0.0]]], device=device))
        h = params.hover_throttle
        cmds = (2.0 * h**2 - 1.0).expand(1, 1, params.num_rotors)
        for _ in range(100):
            state, _ = step(params, state, cmds, 0.01)
        drift = float(torch.linalg.vector_norm(state.pos - pos))
        print(f"{name:18s} rotors={params.num_rotors:2d} "
              f"mass={float(params.mass):7.4f} kg  1s-hover drift={drift:.4f} m")


if __name__ == "__main__":
    main(device_arg())
