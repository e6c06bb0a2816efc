"""Downwash: 4 drones hovering in a vertical column; the downwash force
each one receives, then the column after 1 s of hover commands
(counterpart of examples/demo_downwash.py).

    python -m mupe_tpu_torch.examples.demo_downwash [--device cpu]
"""
import torch

from mupe_tpu_torch.dynamics import downwash_forces, hover_state, make_params, step
from mupe_tpu_torch.examples import device_arg


def main(device: str = "cuda") -> None:
    params = make_params("crazyflie", device)
    heights = torch.tensor([2.0, 1.5, 1.0, 0.5], device=device)
    zeros = torch.zeros(4, device=device)
    pos = torch.stack([zeros, zeros, heights], dim=-1)[None]  # [1, 4, 3]
    quat = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device).expand(1, 4, 4).contiguous()
    state = hover_state(params, pos, quat)

    thrust_w = torch.stack([torch.zeros((), device=device), torch.zeros((), device=device),
                            params.gravity]).expand(1, 4, 3)
    f = downwash_forces(state.pos, thrust_w)
    print("drone  height  downwash_z [N]")
    for i in range(4):
        print(f"  {i}     {float(heights[i]):.1f}    {float(f[0, i, 2]):+.6f}")

    # hold the hover command for 100 ticks and watch the column sag
    h = params.hover_throttle
    cmds = (2.0 * h**2 - 1.0).expand(1, 4, 4)
    for _ in range(100):
        state, _ = step(params, state, cmds, 0.01)
    print("\nheights after 1 s of hover commands (lower drones sag from wake):")
    print(" ", [round(float(z), 3) for z in state.pos[0, :, 2]])


if __name__ == "__main__":
    main(device_arg())
