"""The benchmark's frame: one cell, one seed, one window, one result line.

`main` reads `BENCHMARK.json`, the cell's files (`workloads/<cell>.json`,
`configs/<config>.json`, `traffic/<traffic>.json`) and the traffic's driver
(`drivers/<kind>.py`), all found by name, requires the cards the cell asks
for, and hands the driver a `Run`.  The driver builds the program, warms up,
measures the window, traces (with `--trace 1`) and returns an `Outcome`: the
end-to-end values, the traced run's record, the attempted and failed units
and the numbers that decide `correct`.  The per-layer metrics are read from
that record by `metrics/<metric>.py`, one file a metric.  The result is the
last line of standard output; every compared number with its limit is
printed last on standard error too.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent
# modules that may not be loaded in the process that prints the result,
# compared by top-level name (the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "mupe_tpu")
PROGRAM = "mupe_tpu_torch"


class BenchError(Exception):
    """A run that cannot give a result: exit with `code`, no result line."""

    def __init__(self, msg: str, code: int = 2):
        super().__init__(msg)
        self.code = code


@dataclasses.dataclass
class Check:
    """One compared number and its limit: correct while value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver measured: end-to-end values (untraced run), the traced
    run's record for the per-layer readers, the units attempted and failed
    in the window, and the checks that decide `correct`."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    device: Dict[str, Any]
    record: Optional[Dict[str, Any]] = None
    breakdown: Optional[Dict[str, list]] = None


@dataclasses.dataclass
class Run:
    """Everything a driver gets: the cell, its configuration and traffic,
    the seed, the window's length, whether to trace, the device and the
    time the process started (set-up is measured from it)."""

    name: str
    config: Dict[str, Any]
    cell: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    bench_dir: Path = BENCH_DIR

    def sub_seed(self, tag: str) -> int:
        """A 63-bit seed for one use (`tag`) of the run's seed: the same
        seed gives the same inputs, and uses do not share a stream."""
        key = [ord(c) for c in tag]
        state = np.random.SeedSequence(self.seed % 2 ** 64, spawn_key=key).generate_state(
            2, np.uint32)
        return int(state[0]) << 31 | int(state[1]) >> 1

    def generator(self, tag: str, device=None):
        import torch

        dev = torch.device(self.device if device is None else device)
        return torch.Generator(device=dev).manual_seed(self.sub_seed(tag))

    def env_overrides(self) -> Dict[str, Any]:
        return {**self.config.get("env", {}), **self.cell.get("env", {})}

    def algo_overrides(self) -> Dict[str, Any]:
        return {**self.config.get("algo_cfg", {}), **self.cell.get("algo_cfg", {})}


def load_json(path: Path) -> Any:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError as e:
        raise BenchError(f"missing file {path}") from e


def load_module(path: Path, name: str):
    """A module from a file under the benchmark's folder, by path (metric
    names hold dots, so they are not importable by name)."""
    if not path.is_file():
        raise BenchError(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest_entry(manifest: Dict[str, Any], workload: str) -> Dict[str, Any]:
    for w in manifest["workloads"]:
        if w["name"] == workload:
            return w
    raise BenchError(f"no workload {workload!r} in BENCHMARK.json")


def cell_metrics(manifest: Dict[str, Any], kind: str, workload: str) -> List[Dict[str, Any]]:
    """The metrics of `kind` ("end_to_end" or "per_layer") that `workload`
    reports: those listing it, and those without a `workloads` key whose
    end-to-end metric (`moves`, for a per-layer one) the cell reports."""
    e2e_here = {m["name"] for m in manifest["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]}
    out = []
    for m in manifest[kind]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e_here:
            out.append(m)
    return out


def card_info(device) -> Dict[str, Any]:
    """The card's name, the cards used, the peak of allocated memory and
    the power limit (nvidia-smi), read once the window has closed."""
    import torch

    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0}
    info["power_limit"] = power_limit()
    return info


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def forbidden_modules() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def check_program_location() -> None:
    """The program has to come from this checkout, not from an installed
    copy elsewhere: a folder without the program fails."""
    spec = importlib.util.find_spec(PROGRAM)
    origin = Path(spec.origin).resolve() if spec and spec.origin else None
    if origin is None or REPO not in origin.parents:
        raise BenchError(f"{PROGRAM} is not in this checkout ({REPO}); found {origin}", 3)


def fixed_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the port builds its kernels into mupe_tpu_torch/_build/ itself; Triton
    and torch's extension builds, if anything uses them, go here."""
    cache = BENCH_DIR / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None, root: Path = REPO,
         device: Optional[str] = None) -> int:
    """Run one cell and print its result.  `root` holds BENCHMARK.json and
    `bench_port/`; `device` (tests only) skips the look for cards and runs
    on that device."""
    t_start = time.time() if t_start is None else t_start
    args = parse(argv)
    try:
        result, checks = run_cell(args, t_start, Path(root), device)
    except BenchError as e:
        print(f"bench_port: {e}", file=sys.stderr)
        return e.code
    found = forbidden_modules()
    if found:
        print(f"bench_port: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    for c in checks:
        print(f"check {c.name}: {c.value:.6g} limit {c.limit:.6g} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def run_cell(args, t_start: float, root: Path, device: Optional[str]):
    import torch

    bench_dir = root / "bench_port"
    manifest = load_json(root / "BENCHMARK.json")
    entry = manifest_entry(manifest, args.workload)
    cell = load_json(bench_dir / "workloads" / f"{args.workload}.json")
    for key in ("config", "traffic"):
        if cell.get(key) != entry[key]:
            raise BenchError(f"workloads/{args.workload}.json names {key} {cell.get(key)!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    config = load_json(bench_dir / "configs" / f"{entry['config']}.json")
    traffic = load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    if device is None:
        check_program_location()
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise BenchError(f"cell {args.workload} needs {entry['chips']} CUDA card(s); "
                             f"found {n}", 3)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    driver = load_module(bench_dir / "drivers" / f"{traffic['kind']}.py",
                         f"bench_port_driver_{traffic['kind']}")
    run = Run(name=args.workload, config=config, cell=cell, traffic=traffic, seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace), device=dev, t_start=t_start,
              bench_dir=bench_dir)
    out: Outcome = driver.run(run)
    if args.trace:
        if out.record is not None and "trace" in out.record:
            print(f"info: trace: {out.record['trace']['matched_launches']:.4f} of the device's "
                  "operations placed by their launch call", file=sys.stderr)
        metrics = {}
        for m in cell_metrics(manifest, "per_layer", args.workload):
            reader = load_module(bench_dir / "metrics" / f"{m['name']}.py",
                                 f"bench_port_metric_{m['name'].replace('.', '_')}")
            value = reader.read(out.record) if out.record is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out.e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell_metrics(manifest, "end_to_end", args.workload)}
    result = {"correct": all(c.ok for c in out.checks) and bool(out.checks),
              "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
              "device": dict(out.device)}
    if args.trace:
        for key in ("busy_s", "window_s"):
            result["device"][key] = out.record[key] if out.record else 0.0
        if out.breakdown is not None:
            result["breakdown"] = out.breakdown
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return result, out.checks
