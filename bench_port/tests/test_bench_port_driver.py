"""The window drivers at a tiny size on the CPU, end to end through
`core.main`: the result line, and `correct` false under every fault that
the cell can have and under the lower-precision control."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from bench_port import core, faults, readings
from conftest import BENCH, REPO

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def run_cell(root, capsys, workload, trace=0, seed=4294967311):
    rc = core.main(["--workload", workload, "--seed", str(seed), "--seconds", "1",
                    "--trace", str(trace)], root=root, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1]) if out else None


@pytest.mark.parametrize("workload", ["tiny.train", "tinyh.train", "tiny.eval"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(tiny_root, capsys, workload, trace):
    rc, res = run_cell(tiny_root, capsys, workload, trace)
    assert rc == 0
    assert KEYS <= set(res) and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    m = core.load_json(tiny_root / "BENCHMARK.json")
    if trace:
        assert {"busy_s", "window_s", } <= set(res["device"]) and "breakdown" in res
        # no device here: the device readers find nothing and are left out
        assert set(res["metrics"]) <= {p["name"] for p in core.cell_metrics(
            m, "per_layer", workload)}
    else:
        assert set(res["metrics"]) == {e["name"] for e in core.cell_metrics(
            m, "end_to_end", workload)}
        assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("workload,kind,fault", [
    ("tiny.train", "train", f) for f in faults.TRAIN] + [
    ("tinyh.train", "train", f) for f in faults.TRAIN] + [
    ("tiny.eval", "eval", f) for f in faults.EVAL])
def test_a_fault_reads_not_correct(tiny_root, capsys, workload, kind, fault):
    task = "Hover" if workload.startswith("tinyh") else "HideAndSeek"
    with faults.plant(kind, fault, task):
        rc, res = run_cell(tiny_root, capsys, workload)
    assert rc == 0 and res["correct"] is False, res["checks"]


@pytest.mark.parametrize("workload", ["tiny.train", "tinyh.train", "tiny.eval"])
def test_the_control_reads_not_correct(tiny_root, capsys, workload):
    assert readings.main(["--workload", workload, "--control-seeds", "3"], root=tiny_root,
                         device="cpu") == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    control = next(l for l in lines if l["side"] == "control")
    limits = core.load_json(tiny_root / "bench_port" / "workloads" / f"{workload}.json")["limits"]
    assert any(control[k] > limits[k] for k in limits if k in control), control


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    rc = core.main(["--workload", "hns.train", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_a_folder_without_the_program_fails(tmp_path):
    import shutil

    shutil.copytree(BENCH, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "hns.train",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.gpu
def test_a_cell_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    p = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "hns.train",
                        "--seed", "5", "--seconds", "3", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
