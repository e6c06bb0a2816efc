"""Depth camera: an onboard depth image of a HideAndSeek-style scene as
ASCII art (counterpart of examples/demo_depth_camera.py).

    python -m mupe_tpu_torch.examples.demo_depth_camera [--device cpu]
"""
import torch

from mupe_tpu_torch.core import euler_to_quaternion
from mupe_tpu_torch.examples import device_arg
from mupe_tpu_torch.sensors import DepthCameraCfg, depth_image


def main(device: str = "cuda") -> None:
    cfg = DepthCameraCfg(width=72, height=24, max_range=3.0)
    # the camera at one side of the arena, level, looking across
    cam_pos = torch.tensor([-0.7, 0.0, 0.6], device=device)
    cam_quat = euler_to_quaternion(torch.tensor([0.0, 0.15, 0.0], device=device))
    cylinders = torch.tensor([[0.0, 0.0, 0.6], [0.3, 0.35, 0.6], [-0.2, -0.4, 0.6],
                              [0.5, -0.15, 0.6], [0.0, 0.0, -20.0]],  # the last one parked
                             device=device)
    img = depth_image(cfg, cam_pos, cam_quat, cylinders=cylinders, cylinder_size=0.1,
                      arena_size=0.9, max_height=1.2,
                      target_pos=torch.tensor([0.45, 0.25, 0.6], device=device),
                      target_radius=0.075)
    shades = " .:-=+*#%@"
    norm = 1.0 - (img - cfg.min_range) / (cfg.max_range - cfg.min_range)
    idx = torch.clamp((norm * (len(shades) - 1)).to(torch.int64), 0, len(shades) - 1).cpu()
    print(f"depth {cfg.width}x{cfg.height}  (near=@, far=space)")
    for row in idx:
        print("".join(shades[int(i)] for i in row))


if __name__ == "__main__":
    main(device_arg())
