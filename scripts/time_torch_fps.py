#!/usr/bin/env python3
"""Build the port's FPS kernel, check it against its plain version and time
it on one GPU: the FPS part of `chip_smoke.py`'s phase 2, alone (every
equality check, then the register instance at the AEG's pool, N = 9,096
tasks of D = 27, K = 5,000, and the streamed instance at N = 49,153), and
the chain's floor at both pools: the same cluster's round without its
distance pass (`scripts/fps_empty_round.cu`, built here with nvcc).
Prints, for each, the cluster size C that ran, the instance, ms a call and
us a round.

    python3 scripts/time_torch_fps.py
"""
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)  # repo root

import chip_smoke  # noqa: E402
from mupe_tpu_torch.ops import build, fps  # noqa: E402

EMPTY_SRC = os.path.join(ROOT, "scripts", "fps_empty_round.cu")


def empty_round_library() -> ctypes.CDLL:
    out = build.BUILD_DIR / "libfps_empty_round.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", str(out), EMPTY_SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        if "empty_round" in line or "registers" in line or "rror" in line:
            chip_smoke.log(f"  ptxas: {line.strip()}")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.mupe_fps_empty_rounds.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    lib.mupe_fps_empty_rounds.restype = ctypes.c_int
    return lib


def empty_round_us(dev, n: int, d: int, k: int) -> float:
    """us a round of the exchange alone, in the cluster, threads and shared
    memory of the instance the kernel runs at (n, d)."""
    lib = empty_round_library()
    c, inst = fps.plan(n, d, dev)
    out = torch.empty((k,), dtype=torch.int32, device=dev)

    def run():
        err = lib.mupe_fps_empty_rounds(n, d, k, c, fps.INSTANCES.index(inst), out.data_ptr(),
                                        torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "mupe_fps_empty_rounds")

    ms = chip_smoke.cuda_time_ms(run, runs=5)
    us = ms * 1e3 / (k - 1)
    chip_smoke.log(f"  empty rounds N={n} D={d} K={k}: cluster {c}, {inst}: {ms:.4f} ms "
                   f"({us:.4f} us a round)")
    return us


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch_fps: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    chip_smoke.log(f"card: {chip_smoke.card_line()}")
    chip_smoke.phase_build()
    chip_smoke.phase_fps_kernel(dev, torch.Generator().manual_seed(0))
    for n in (chip_smoke.FPS_N, chip_smoke.FPS_STREAMED_N):
        empty_round_us(dev, n, chip_smoke.FPS_D, chip_smoke.AEG_BUFFER)
    return 0


if __name__ == "__main__":
    sys.exit(main())
