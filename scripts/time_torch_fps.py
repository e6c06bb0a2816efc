#!/usr/bin/env python3
"""Build the port's FPS kernel, check it against its plain version and time
it on one GPU at the AEG's pool (N = 9,096 tasks of D = 27, K = 5,000): the
FPS part of `chip_smoke.py`'s phase 2, alone.

    python3 scripts/time_torch_fps.py
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # repo root

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch_fps: needs a CUDA device", file=sys.stderr)
        return 2
    chip_smoke.log(f"card: {chip_smoke.card_line()}")
    chip_smoke.phase_build()
    chip_smoke.phase_fps_kernel(torch.device("cuda", 0), torch.Generator().manual_seed(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
