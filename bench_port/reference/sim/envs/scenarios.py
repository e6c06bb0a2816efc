"""Fixed evaluation scenarios: empty / passage / wall / random / narrow_gap
(counterpart of mupe_tpu/envs/scenarios.py; the same numpy tables).

Cylinder layouts from HideAndSeek._design_scene
(omni_drones/envs/hide_and_seek/hideandseek.py:480-531) and the matching
fixed spawn poses from _reset_idx (:632-682).  Positions are expressed with
cylinder_size s = 0.1 and cylinder_height h = max_height.  HideAndSeek turns
them into device tensors.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

INVALID_Z = -20.0  # parking depth for inactive cylinders (hideandseek.py:451)

EVAL_SCENARIOS = ("empty", "passage", "wall", "random", "narrow_gap")


def scenario_cylinders(
    flag: str, num_cylinders: int, cylinder_size: float, cylinder_height: float
) -> Tuple[np.ndarray, int]:
    """Returns ([num_cylinders, 3] positions with inactive parked below
    ground, num_active).  Raises ValueError for an unknown flag and for a
    layout with more cylinders than `num_cylinders` (passage and random
    need 6)."""
    s = cylinder_size
    z = 0.5 * cylinder_height
    layouts: Dict[str, list] = {
        "empty": [],
        "passage": [
            [0.0, 3 * s, z],
            [-2 * s, 3 * s, z],
            [2 * s, 3 * s, z],
            [2 * s, -2 * s, z],
            [-2 * s, -2 * s, z],
            [0.0, -2 * s, z],
        ],
        "wall": [
            [0.0, 1.5 * s, z],
            [0.0, -1.5 * s, z],
            [0.0, 4.5 * s, z],
            [0.0, -4.5 * s, z],
        ],
        "random": [
            [0.6, 0.4, 0.6],
            [-0.6, 0.4, 0.6],
            [-0.2, 0.4, 0.6],
            [0.0, 0.2, 0.6],
            [-0.2, -0.4, 0.6],
            [0.0, -0.2, 0.6],
        ],
        "narrow_gap": [
            [3 * s, -3 * s, z],
            [3 * s, 3 * s, z],
            [-3 * s, 3 * s, z],
            [-3 * s, -3 * s, z],
            [0.0, 3 * s, z],
        ],
    }
    if flag not in layouts:
        raise ValueError(f"unknown scenario {flag!r}")
    active = np.asarray(layouts[flag], dtype=np.float32).reshape(-1, 3)
    n_active = len(active)
    if n_active > num_cylinders:
        raise ValueError(
            f"scenario {flag!r} has {n_active} cylinders; the arena holds {num_cylinders}")
    out = np.zeros((num_cylinders, 3), dtype=np.float32)
    # park everything underground first (hideandseek.py:455-460)
    out[:, 0] = np.arange(num_cylinders) * 2 * s
    out[:, 2] = INVALID_Z
    out[:n_active] = active
    return out, n_active


def scenario_spawns(flag: str, num_agents: int) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed drone/target spawn XYZ per scenario (hideandseek.py:632-682):
    ([min(num_agents, 4), 3], [1, 3])."""
    drones: Dict[str, list] = {
        "empty": [[0.6, 0.0, 0.5], [0.8, 0.0, 0.5], [0.8, -0.2, 0.5], [0.8, 0.2, 0.5]],
        "wall": [[0.6, 0.4, 0.5], [0.6, 0.0, 0.5], [0.6, -0.4, 0.5], [0.8, 0.2, 0.5]],
        "narrow_gap": [
            [0.0, 0.7, 0.5], [0.2, 0.7, 0.5], [-0.2, 0.7, 0.5], [0.8, 0.2, 0.5]
        ],
        "random": [[0.6, 0.0, 0.5], [0.8, 0.0, 0.5], [0.8, -0.2, 0.5], [0.8, 0.2, 0.5]],
        "passage": [
            [0.6, 0.0, 0.5], [0.8, 0.2, 0.5], [0.8, -0.2, 0.5], [0.8, 0.2, 0.5]
        ],
    }
    targets: Dict[str, list] = {
        "empty": [[-0.8, 0.0, 0.5]],
        "wall": [[-0.8, 0.0, 0.5]],
        "narrow_gap": [[-0.5, 0.2, 0.5]],
        "random": [[-0.8, 0.0, 0.5]],
        "passage": [[0.0, 0.6, 0.5]],
    }
    return (
        np.asarray(drones[flag][:num_agents], dtype=np.float32),
        np.asarray(targets[flag], dtype=np.float32),
    )
