"""Build the package's CUDA kernels into one shared library, at first use.

The sources in `mupe_tpu_torch/csrc/` are compiled by `nvcc` for `sm_90a`,
one process per source, all started together, and linked into a shared
library with a plain C interface, loaded with `ctypes`.  The
library's file name carries a hash of the sources and flags, so an edited
source builds anew and an unchanged one is loaded from
`mupe_tpu_torch/_build/`.  A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("fused_encoder.cu", "fused_encoder_bwd.cu", "fused_encoder_loss.cu", "weight_grad.cu",
           "tp_lstm.cu", "tp_lstm_bwd.cu", "fps.cu")
HEADERS = ("common.cuh", "encoder_bwd_tile.cuh", "tp_tile.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every exported C function (pointers as c_void_p: ctypes would
# otherwise pass a Python int as a 32-bit int and cut the address)
C_FUNCTIONS = {
    "mupe_encoder_forward_scratch": (_I, _I, _P, _P, _I, _I, _P),
    "mupe_encoder_forward": (
        _P, _I, _I, _I, _I, _P, _P, _I, _P, _I, _P, _P, _P, _P,
    ),
    "mupe_tp_lstm_forward": (
        _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P,
    ),
    "mupe_encoder_bwd_blocks": (_I, _I, _P, _P, _I, _I, _P),
    "mupe_encoder_bwd_scratch": (_I, _I, _P, _P, _I, _I, _P),
    "mupe_encoder_bwd_operands": (
        _P, _I, _I, _I, _I, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
    ),
    "mupe_encoder_fwd_loss_scratch": (_I, _I, _P, _P, _I, _I, _P),
    "mupe_encoder_fwd_loss": (_P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P),
    "mupe_encoder_fwd_loss_agrad_blocks": (_I, _I, _P, _P, _I, _P),
    "mupe_encoder_fwd_loss_agrad": (
        _P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P,
    ),
    "mupe_weight_grads": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    "mupe_tp_lstm_bwd_blocks": (_I, _I, _I, _I, _P),
    "mupe_tp_lstm_bwd_operands": (
        _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
    ),
    "mupe_fps_clusters": (_I, _I, _I, _I, _P),
    "mupe_fps": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libmupe_kernels-{source_hash()}.so"


@functools.lru_cache(maxsize=1)
def build() -> dict:
    """Compile (if needed) and describe the library: path, seconds, the
    nvcc commands and their output (register and spill report)."""
    path = library_path()
    if path.exists():
        return {"path": str(path), "built": False, "seconds": 0.0,
                "command": None, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    nvcc = nvcc_path()
    objs = [tmp.with_suffix(f".{Path(s).stem}.o") for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
            for s, o in zip(SOURCES, objs)]
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]

    def run(cmd):
        return subprocess.run(cmd, capture_output=True, text=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cmds)) as pool:
        procs = list(pool.map(run, cmds))
    if all(p.returncode == 0 for p in procs):
        procs.append(run(link))
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    log = "".join(p.stdout + p.stderr for p in procs)
    failed = [p for p in procs if p.returncode != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({' '.join(failed[0].args)}):\n{log}")
    os.replace(tmp, path)  # atomic: concurrent builders never see a partial file
    return {"path": str(path), "built": True, "seconds": seconds,
            "command": " ; ".join(" ".join(c) for c in cmds + [link]), "log": log}


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in C_FUNCTIONS.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def ptr_array(ptrs) -> ctypes.Array:
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def int_array(vals) -> ctypes.Array:
    return (ctypes.c_int * len(vals))(*vals)


def float_array(vals) -> ctypes.Array:
    """Host f32 values (each double rounded to the nearest float)."""
    return (ctypes.c_float * len(vals))(*vals)
