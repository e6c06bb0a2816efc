"""The benchmark's data-parallel driver (`bench_port/drivers/train_dp.py`)
on the CPU: two ranks over gloo, tiny, against one rank of the same cell,
and a rank that fails ending the run non-zero in bounded time.

    python -m pytest tests/test_bench_port_dp.py -q

The benchmark's runs refuse a process that loaded JAX, which this test
suite's conftest imports: the runs are child processes.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
LIMITS = {"env": 1e-3, "act": 5e-2, "first_loss": 1e-2, "grad": 5e-2, "median_change": 0.5}
TINY = {"source": "tests", "task": "HideAndSeek", "algo": "mappo",
        "env": {"num_envs": 16, "max_episode_length": 800},
        "algo_cfg": {"train_every": 8, "num_minibatches": 2, "use_tp_net": True}, "reduced": []}

_RUN = r"""
import sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from bench_port import core
for cell in sys.argv[3:]:
    rc = core.main(["--workload", cell, "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
                   root=Path(sys.argv[2]), device="cpu")
    print("RESULT", cell, rc, flush=True)
"""


_FAILURE = """

_ranked_sound = _ranked


def _ranked(run, rank, world, ctl):
    if rank == {rank}:
        base.Setup(run)
        raise RuntimeError(f"rank {{rank}} fails after set-up")
    return _ranked_sound(run, rank, world, ctl)
"""


def plant_failure(driver: Path, rank: int) -> None:
    """Make rank `rank` of the copied driver die after its set-up, in rank
    0's process and in the children, which run the file itself."""
    head, main, tail = driver.read_text().rpartition('\n\nif __name__ == "__main__":')
    driver.write_text(head + _FAILURE.format(rank=rank) + main + tail)


def tiny_root(tmp_path, fail_rank=None) -> Path:
    """A checkout root with the benchmark's files and two tiny cells of one
    HideAndSeek configuration: `tinydp.train` (2 ranks over gloo, the
    traffic of `hns.train_dp4` otherwise) and `tiny1.train` (`train`)."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "bench_port", root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    b = root / "bench_port"
    (b / "configs" / "tiny_hns.json").write_text(json.dumps(TINY))
    traffic = json.loads((b / "traffic" / "train_dp4.json").read_text())
    traffic.update(ranks=2, backend="gloo")
    (b / "traffic" / "tiny_dp.json").write_text(json.dumps(traffic))
    if fail_rank is not None:
        plant_failure(b / "drivers" / "train_dp.py", fail_rank)
    cells = {"tinydp.train": ("tiny_dp", dict(LIMITS, ranks=0.5)), "tiny1.train": ("train", LIMITS)}
    m = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, (tr, limits) in cells.items():
        (b / "workloads" / f"{name}.json").write_text(json.dumps(
            {"config": "tiny_hns", "traffic": tr, "limits": limits}))
        m["workloads"].append({"name": name, "config": "tiny_hns", "traffic": tr, "chips": 1,
                               "why": "a CPU test's cell"})
    m["end_to_end"][0]["workloads"] += list(cells)
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root


def _run(root: Path, *cells, timeout=600):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    env["OMP_NUM_THREADS"] = "1"   # two ranks share the CPU
    return subprocess.run([sys.executable, "-c", _RUN, str(REPO), str(root), *cells], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout, env=env)


def test_two_ranks_over_gloo_hold_the_one_rank_result(tmp_path):
    """The reference follows the one-process iteration of both ranks'
    arenas: the env, the act and the first update read as one rank's run
    of the same cell, and the ranks' learners hold the same bits."""
    p = _run(tiny_root(tmp_path), "tiny1.train", "tinydp.train")
    rcs = [l.split()[1:] for l in p.stdout.splitlines() if l.startswith("RESULT")]
    assert rcs == [["tiny1.train", "0"], ["tinydp.train", "0"]], p.stderr[-3000:]
    one, two = [json.loads(l) for l in p.stdout.splitlines() if l.startswith("{")]
    assert one["correct"] and two["correct"], (one["checks"], two["checks"])
    assert two["checks"]["ranks"]["value"] == 0
    assert two["metrics"]["train_env_steps_per_s"]["value"] > 0
    for k in ("env", "act", "first_loss", "grad"):
        assert abs(two["checks"][k]["value"] - one["checks"][k]["value"]) <= 0.01 * LIMITS[k], k


@pytest.mark.parametrize("rank", [0, 1])
def test_a_failing_rank_ends_the_run(tmp_path, rank):
    t = time.time()
    p = _run(tiny_root(tmp_path, fail_rank=rank), "tinydp.train", timeout=300)
    assert p.returncode != 0 and not any(l.startswith("{") for l in p.stdout.splitlines())
    assert f"rank {rank} fails" in p.stderr
    assert time.time() - t < 120
