#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from, on the chip:

    python3 bench_port/readings.py --workload hns.train --seeds 1-12 \
        --control-seeds 1-3 --fault-seeds 1-3

For each seed, one JSON line a side: `program` (the program against the
reference, as a run compares them), `control` (the reference computed in
the next lower precision, float8 e4m3 with a per-tensor scale, in the
program's place: no window needed), and `fault:<name>` (the program with
a fault of `faults.py` planted).  Each line has every compared number and,
for training, each step's loss on both sides.  The benchmark's own runs
never run this.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_port import core, faults, program  # noqa: E402


def seeds(text: str):
    out = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += list(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def make_run(args, seed, root: Path, device) -> core.Run:
    bench_dir = root / "bench_port"
    manifest = core.load_json(root / "BENCHMARK.json")
    entry = core.manifest_entry(manifest, args.workload)
    return core.Run(name=args.workload,
                    config=core.load_json(bench_dir / "configs" / f"{entry['config']}.json"),
                    cell=core.load_json(bench_dir / "workloads" / f"{args.workload}.json"),
                    traffic=core.load_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
                    seed=seed, seconds=0.0, trace=False, device=device, t_start=time.time(),
                    bench_dir=bench_dir)


def train_lines(run, driver, want_control: bool, fault: str = None):
    import torch

    lines = []
    st = driver.Setup(run)
    st.release()
    ref = driver.reference(run, st.layout, st.algo_cfg, program.rounding(st.algo_cfg))
    first = st.cap.rollouts[0]["traj"]
    r_logp, r_value = driver.act_outputs(first, ref, run.device)
    got = st.readings(run, ref)
    ref_up = _ref_update(run, st, driver, program.rounding(st.algo_cfg))
    prog_up = driver.program_update(st.cap, st.prog_after, st.layout)
    got.update(prog_losses=prog_up["losses"] + prog_up["tp_losses"],
               ref_losses=ref_up["losses"] + ref_up["tp_losses"],
               act_logp=driver.checks.widest_gap(first["logp"].to(run.device), r_logp),
               act_value=driver.checks.widest_gap(first["value"].to(run.device), r_value))
    lines.append(("program" if fault is None else f"fault:{fault}", got))
    if want_control:
        ctrl = driver.reference(run, st.layout, st.algo_cfg, "fp8")
        c_logp, c_value = driver.act_outputs(first, ctrl, run.device)
        got = {"env": driver.env_reading(run, st.cap, st.first_obs, st.reset_gen, st.env_cfg, ref,
                                         control=True),
               "act": driver.act_reading(c_logp, c_value, first, ref, run.device)}
        ctrl_up = driver.update_reference(ctrl, st.cap.rollouts, run.device)
        got.update(driver.update_readings(ctrl_up, ref_up))
        got.update(prog_losses=ctrl_up["losses"] + ctrl_up["tp_losses"])
        lines.append(("control", got))
    del st
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return lines


def _ref_update(run, st, driver, rnd):
    ref = driver.reference(run, st.layout, st.algo_cfg, rnd)
    return driver.update_reference(ref, st.cap.rollouts, run.device)


def eval_lines(run, driver, want_control: bool, fault: str = None):
    import torch
    from mupe_tpu_torch import harness

    dev = run.device
    env, policy, env_cfg, algo_cfg = harness.build(run.config["task"], run.env_overrides(),
                                                   run.algo_overrides(), run.config["algo"], dev)
    layout = program.layout_of(env, policy)
    ts = program.init_state(env, policy, program.draw_parameters(
        layout, run.generator("params"), dev))
    prog = harness._make_eval_prog(env, policy, run.sub_seed("eval") % (2 ** 31))
    out = {k: float(v) for k, v in prog(ts, 0).items()}
    rec = driver._recorded(run, env, policy, prog, ts, 0, env.cfg.max_episode_length,
                           run.traffic["check_steps"])
    del env, policy, ts, prog
    with torch.no_grad():
        lines = [("program" if fault is None else f"fault:{fault}",
                  driver.readings(run, rec, out, env_cfg, algo_cfg, layout))]
        if want_control:
            lines.append(("control", driver.readings(run, rec, out, env_cfg, algo_cfg, layout,
                                                     control=True)))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return lines


def main(argv=None, root: Path = core.REPO, device=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default="")
    args = p.parse_args(argv)
    dev = torch.device(device or "cuda")
    first = make_run(args, 0, root, dev)
    driver = core.load_module(first.bench_dir / "drivers" / f"{first.traffic['kind']}.py",
                              f"bench_port_driver_{first.traffic['kind']}")
    lines_of = train_lines if first.traffic["kind"] == "train" else eval_lines
    control = set(seeds(args.control_seeds))
    for seed in sorted(set(seeds(args.seeds)) | control):
        t = time.time()
        for side, got in lines_of(make_run(args, seed, root, dev), driver, seed in control):
            print(json.dumps({"seed": seed, "side": side, "seconds": time.time() - t, **got}),
                  flush=True)
    names = [f for f in args.faults.split(",") if f]
    for seed in seeds(args.fault_seeds):
        for name in names:
            run = make_run(args, seed, root, dev)
            with faults.plant(run.traffic["kind"], name, run.config["task"]):
                for side, got in lines_of(run, driver, False, name):
                    print(json.dumps({"seed": seed, "side": side, **got}), flush=True)
    found = core.forbidden_modules()
    if found:
        print(f"loaded: {found}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    core.fixed_caches()
    sys.exit(main())
