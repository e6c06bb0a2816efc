"""Headless demos of the port (counterparts of the repo's examples/).

    python -m mupe_tpu_torch.examples.<name> [--device cpu]

Each runs on the card by default and prints what the JAX package's demo of
the same name prints, computed the same way (a Python loop over steps where
the JAX demo scans): demo_attitude_tracking, demo_rate_tracking,
demo_transport, demo_downwash, demo_drone_zoo, demo_depth_camera,
demo_vision_policy and demo_hideandseek_rollout (`--gif` writes its video
with `utils/render.py`).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

EXAMPLES = ("demo_attitude_tracking", "demo_rate_tracking", "demo_transport", "demo_downwash",
            "demo_drone_zoo", "demo_depth_camera", "demo_vision_policy",
            "demo_hideandseek_rollout")


def device_arg(argv: Optional[Sequence[str]] = None) -> str:
    """`--device` from the command line, "cuda" by default."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv).device
