"""The manifest against the benchmark's contract, and every name in it
found as a file of the benchmark's folder."""
from __future__ import annotations

import json
import re

import pytest

from bench_port.drivers import train
from conftest import BENCH, REPO, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
# the numbers each driver reads; a cell compares those its limits name
CHECKS = {"train": set(train.NUMBERS), "train_dp": set(train.NUMBERS) | {"ranks"},
          "train_vision": {"env", "act"} | set(train.UPDATE_NUMBERS),
          "eval": {"env", "act", "stats"}}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|_dim$|_rank$)")


def test_top_level_keys_and_sizes():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(m["command"]) <= 32 and all(1 <= len(w) <= 200 for w in m["command"])
    assert m["command"] == ["python3", "bench_port/run.py"]
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert 1 <= len(m["configs"]) <= 24 and 1 <= len(m["workloads"]) <= 24
    assert 1 <= len(m["end_to_end"]) <= 16 and 1 <= len(m["per_layer"]) <= 128


def test_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (manifest()["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section,keys,extra", [
    ("configs", {"name", "source", "file", "reduced", "why"}, set()),
    ("workloads", {"name", "config", "traffic", "chips", "why"}, set()),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}, {"workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}, {"workloads"}),
])
def test_entries_have_the_contract_keys(section, keys, extra):
    for entry in manifest()[section]:
        assert keys <= set(entry) <= keys | extra, entry
        assert NAME.match(entry["name"]), entry["name"]
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
                assert "\t" not in entry[key]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")


def test_names_are_unique_and_metrics_well_formed():
    m = manifest()
    names = [e["name"] for s in ("end_to_end", "per_layer") for e in m[s]]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in m["workloads"]}) == len(m["workloads"])
    assert len({(w["config"], w["traffic"]) for w in m["workloads"]}) == len(m["workloads"])
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    for p in m["per_layer"]:
        assert p["moves"] in e2e and p["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[p["moves"]]
        for w in p["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"], (p["name"], w)
        if "roofline" in p["name"] or "mfu" in p["name"]:
            assert p["unit"] == "%"


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    m = manifest()
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, len(m["workloads"]) // 4)
    for w in m["workloads"]:
        assert w["chips"] in (1, 4)
        e2e = [e["name"] for e in m["end_to_end"]
               if "workloads" not in e or w["name"] in e["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in p["workloads"] for p in m["per_layer"])


def test_layers_share_one_name_a_layer():
    layers = {p["layer"] for p in manifest()["per_layer"]}
    assert layers <= {"Policy act", "Env step", "Env step and act: host dispatch", "Auto-reset",
                      "Update", "Kernels", "Device"}


def test_every_name_is_found_as_a_file():
    m = manifest()
    for c in m["configs"]:
        assert c["file"] == f"bench_port/configs/{c['name']}.json"
        body = json.loads((REPO / c["file"]).read_text())
        assert body["reduced"] == c["reduced"] and body["source"] == c["source"]
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert {"task", "algo"} <= set(body)
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}
    for w in m["workloads"]:
        cell = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['kind']}.py").is_file()
        assert cell["limits"] and set(cell["limits"]) <= CHECKS[traffic["kind"]]
        assert all(v > 0 for v in cell["limits"].values())
    for p in m["per_layer"]:
        assert (BENCH / "metrics" / f"{p['name']}.py").is_file(), p["name"]
