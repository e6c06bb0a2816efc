"""Native host-side components (C++ via ctypes; counterpart of
mupe_tpu/native/__init__.py).

The one branchy, sequential piece of the AEG is host work: the easy-case
BFS that bootstraps the history buffer.  `generate_easy_tasks` builds
`easy_tasks.cpp` with g++ at first use into `mupe_tpu_torch/_build/` and
loads it; where no compiler is found, a pure-Python BFS keeps it working
(another random stream, the same structure).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from collections import deque
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "easy_tasks.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


@functools.lru_cache(maxsize=1)
def _load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the library; None without a compiler."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()
    path = BUILD_DIR / f"libmupe_native-{digest[:16]}.so"
    if not path.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)  # atomic: concurrent builders never see a partial file
    lib = ctypes.CDLL(str(path))
    lib.generate_easy_tasks.restype = ctypes.c_int
    lib.generate_easy_tasks.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_uint64,
    ]
    return lib


def _inside(i: int, j: int, n: int) -> bool:
    r = n // 2
    return (i - r) ** 2 + (j - r) ** 2 < r * r


def _py_easy_tasks(num_tasks: int, n: int, num_agents: int, seed: int) -> np.ndarray:
    """Python fallback of the BFS generator."""
    rng = np.random.default_rng(seed)
    free = [(i, j) for i in range(n) for j in range(n) if _inside(i, j, n)]
    out = np.zeros((num_tasks, num_agents + 1, 2), np.int32)
    for t in range(num_tasks):
        tx, ty = free[rng.integers(len(free))]
        visited = {(tx, ty)}
        queue = deque([(tx, ty)])
        found = []
        while queue and len(found) < num_agents:
            cx, cy = queue.popleft()
            for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                nx, ny = cx + dx, cy + dy
                if not (0 <= nx < n and 0 <= ny < n) or (nx, ny) in visited:
                    continue
                visited.add((nx, ny))
                if _inside(nx, ny, n):
                    found.append((nx, ny))
                    if len(found) == num_agents:
                        break
                queue.append((nx, ny))
        while len(found) < num_agents:
            found.append((tx, ty))
        out[t, :num_agents] = found
        out[t, num_agents] = (tx, ty)
    return out


def generate_easy_tasks(
    num_tasks: int, num_grid: int, num_agents: int, seed: int = 0
) -> np.ndarray:
    """→ [num_tasks, num_agents + 1, 2] int32 grid cells (pursuers…, evader)."""
    lib = _load()
    if lib is None:
        return _py_easy_tasks(num_tasks, num_grid, num_agents, seed)
    out = np.zeros((num_tasks, num_agents + 1, 2), np.int32)
    rc = lib.generate_easy_tasks(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        num_tasks,
        num_grid,
        num_agents,
        seed,
    )
    if rc != 0:
        raise RuntimeError(f"generate_easy_tasks failed with {rc}")
    return out
