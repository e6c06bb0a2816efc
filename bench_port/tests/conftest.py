"""Fixtures of the benchmark's CPU tests: a throwaway checkout root that
holds the benchmark's folder and a manifest with tiny cells of its own,
added as files only (configurations, cells, a traffic mix), which the
harness finds by name.

    python -m pytest bench_port/tests -q
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
TRAIN_LIMITS = {"env": 1e-3, "act": 5e-2, "loss": 1e-2, "grad": 5e-2, "change": 5e-1}
# the tiny Hover cell's 32-wide bf16 MLPs: a sign that rounding flips in
# Adam's first steps moves the third minibatch's loss by up to ~5% (31%
# between the bf16 and the float32 reference), far from the float8
# control's (~4.7x)
TINY_HOVER_LIMITS = {**TRAIN_LIMITS, "loss": 0.25}
EVAL_LIMITS = {"env": 1e-3, "act": 5e-2, "stats": 1e-3}
TINY = {
    "configs": {
        "tiny_hns": {"source": "tests", "task": "HideAndSeek", "algo": "mappo",
                     "env": {"num_envs": 16, "max_episode_length": 800},
                     "algo_cfg": {"train_every": 8, "num_minibatches": 2, "use_tp_net": True},
                     "reduced": ["num_envs", "train_every", "num_minibatches"]},
        "tiny_hover": {"source": "tests", "task": "Hover", "algo": "mappo",
                       "env": {"num_envs": 16, "max_episode_length": 300},
                       "algo_cfg": {"train_every": 8, "num_minibatches": 2,
                                    "hidden_units": [32, 32]},
                       "reduced": ["num_envs", "train_every", "num_minibatches"]},
    },
    "traffic": {"eval_short": {"kind": "eval", "warmup_steps": 2, "min_evals": 2,
                               "check_steps": 4, "trace_from": 5, "trace_steps": 5}},
    "workloads": {
        "tiny.train": {"config": "tiny_hns", "traffic": "train", "limits": TRAIN_LIMITS},
        "tinyh.train": {"config": "tiny_hover", "traffic": "train",
                        "limits": TINY_HOVER_LIMITS},
        "tiny.eval": {"config": "tiny_hns", "traffic": "eval_short", "limits": EVAL_LIMITS,
                      "env": {"use_eval": True, "use_random_cylinder": False,
                              "scenario_flag": "wall", "max_episode_length": 40}},
    },
}
# the evaluation metrics, whose readers are in bench_port/metrics: the
# tiny evaluation cell brings their entries (no cell of BENCHMARK.json
# evaluates yet)
EVAL_METRICS = {
    "end_to_end": [{"name": "eval_env_steps_per_s", "unit": "env-steps/s", "better": "higher",
                    "bound": 0.25, "source": "host_clock", "workloads": ["tiny.eval"]}],
    "per_layer": [{"name": n, "unit": u, "better": b, "source": "device_trace", "layer": l,
                   "moves": "eval_env_steps_per_s", "workloads": ["tiny.eval"]}
                  for n, u, b, l in (
                      ("launches_per_step.eval", "launches/step", "lower",
                       "Env step and act: host dispatch"),
                      ("pair_fwd_roofline.eval", "%", "higher", "Kernels"),
                      ("device_idle.eval", "%", "lower", "Device"),
                      ("mfu.eval", "%", "higher", "Device"))],
}


def manifest() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(BENCH, root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    b = root / "bench_port"
    for kind, files in TINY.items():
        for name, body in files.items():
            (b / kind / f"{name}.json").write_text(json.dumps(body))
    m = manifest()
    for name, body in TINY["workloads"].items():
        m["workloads"].append({"name": name, "config": body["config"], "traffic": body["traffic"],
                               "chips": 1, "why": "a CPU test's cell"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if "hns.train" in metric.get("workloads", []):
            metric["workloads"] += ["tiny.train", "tinyh.train"]
    for kind, entries in EVAL_METRICS.items():
        m[kind] += entries
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skipped where there is none")
