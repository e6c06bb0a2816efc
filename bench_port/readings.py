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


def train_lines(run, driver, want_control: bool, fault: str = None, diagnose: bool = False,
                leaf: str = None, cpu: bool = False):
    import torch

    lines = []
    st = driver.Setup(run)
    st.release()
    rnd = program.rounding(st.algo_cfg)
    ref = driver.reference(run, st.layout, st.algo_cfg, rnd)
    first = st.cap.rollouts[0]["traj"]
    r_act = driver.act_outputs(first, ref, run.device)
    got = st.readings(run, ref)
    ref_up = _ref_update(run, st, driver, rnd)
    prog_up = driver.program_update(st.cap, st.prog_after, st.layout)
    got.update(prog_losses=prog_up["losses"] + prog_up["tp_losses"],
               ref_losses=ref_up["losses"] + ref_up["tp_losses"],
               **_act_steps((first["logp"], first["value"]), r_act))
    if diagnose:
        got.update(_by_leaf(driver, prog_up, ref_up, st.layout, leaf))
    lines.append(("program" if fault is None else f"fault:{fault}", got))
    sides = (["control"] if want_control else []) + (
        ["exact"] if diagnose and fault is None and rnd != "exact" else []) + (
        ["cpu"] if diagnose and fault is None and cpu else [])
    for side in sides:
        # in the program's place, the reference at another rounding: float8
        # (the control) or none (a second reference as valid as the
        # configuration's); or at the configuration's rounding on the CPU
        # (the same arithmetic summed in another order)
        other = driver.reference(run, st.layout, st.algo_cfg, {"control": "fp8", "exact": "exact"}
                                 .get(side, rnd))
        dev = run.device
        if side == "cpu":
            other, dev = _on_cpu(other), torch.device("cpu")
        o_act = driver.act_outputs(first, other, dev)
        got = {**driver.act_readings(o_act, r_act), **_act_steps(o_act, r_act)}
        if side == "control":
            got["env"] = driver.env_reading(run, st.cap, st.first_obs, st.reset_gen, st.env_cfg,
                                            driver.reference(run, st.layout, st.algo_cfg, rnd),
                                            control=True)
        other_up = driver.update_reference(other, st.cap.rollouts, dev)
        got.update(driver.update_readings(other_up, ref_up))
        got.update(prog_losses=other_up["losses"] + other_up["tp_losses"])
        if diagnose:
            got.update(_by_leaf(driver, other_up, ref_up, st.layout, leaf))
        lines.append((side, got))
    del st
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return lines


def _on_cpu(learner):
    """A learner that has not stepped yet, with its parameters on the CPU."""
    import dataclasses

    cpu = lambda ls: None if ls is None else [l.cpu() for l in ls]  # noqa: E731
    return dataclasses.replace(learner, actor=cpu(learner.actor), log_std=learner.log_std.cpu(),
                               critic=cpu(learner.critic), tp=cpu(learner.tp))


def _ref_update(run, st, driver, rnd):
    ref = driver.reference(run, st.layout, st.algo_cfg, rnd)
    return driver.update_reference(ref, st.cap.rollouts, run.device)


def _act_steps(side, ref):
    """The rollout step at which the widest gap of the log-probs, and of
    the values, lies."""
    return {f"act_{k}_step": int((p.to(r.device).double() - r.double()).abs()
                                 .reshape(p.shape[0], -1).amax(1).argmax())
            for k, p, r in zip(("logp", "value"), side, ref)}


def _by_leaf(driver, side, ref, layout, leaf=None):
    """Each leaf's norms (first clipped gradient, change) on this side and
    the reference's, with the leaves' names; and for `leaf`, if named,
    `_elements`."""
    g_s, g_r, c_s, c_r, _ = driver.leaf_norms_of(side, ref)
    names = layout.leaf_names()
    out = {"norms": {"grad": g_s, "change": c_s}, "ref_norms": {"grad": g_r, "change": c_r},
           "leaves": names}
    if leaf:
        out["elements"] = _elements(side, ref, names, leaf)
    return out


def _elements(side, ref, names, leaf):
    """One leaf's elements against the reference's: how many the side's
    first gradient gives the other sign (`grad_turned`), and its change
    over the steps (`change_turned`); for each, the largest of the
    reference's first gradient there, over the leaf's median (`*_at`):
    a sign that rounding turns sits where the gradient is all but nought;
    and the share of the squared difference of the changes that lies on
    the elements whose change turned (`change_turned_share`)."""
    import torch

    k = leaf.split(".")[0]
    i = [n for n in names if n.split(".")[0] == k].index(leaf)
    flat = lambda t: t.detach().double().flatten().cpu()  # noqa: E731
    g_s, g_r = flat(side["first"][k][i]), flat(ref["first"][k][i])
    before = flat(ref["before"][k][i])
    c_s, c_r = flat(side["after"][k][i]) - before, flat(ref["after"][k][i]) - before
    scale = float(g_r.abs().median()) or 1e-30
    out = {"leaf": leaf, "count": g_r.numel()}
    for name, a, b in (("grad", g_s, g_r), ("change", c_s, c_r)):
        turned = torch.sign(a) != torch.sign(b)
        out[f"{name}_turned"] = int(turned.sum())
        out[f"{name}_turned_at"] = float(g_r.abs()[turned].max()) / scale if turned.any() else 0.0
    sq = (c_s - c_r) ** 2
    out["change_turned_share"] = float(sq[turned].sum() / sq.sum()) if sq.sum() > 0 else 0.0
    return out


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
    p.add_argument("--diagnose", action="store_true",
                   help="add each leaf's norms, and a line for the reference without rounding in "
                        "the program's place (training)")
    p.add_argument("--leaf", default="",
                   help="with --diagnose, one leaf's elements (`<group>.<leaf>`, as "
                        "`Layout.leaf_names` gives them)")
    p.add_argument("--cpu", action="store_true",
                   help="with --diagnose, a line for the configuration's reference on the CPU "
                        "in the program's place")
    args = p.parse_args(argv)
    dev = torch.device(device or "cuda")
    first = make_run(args, 0, root, dev)
    driver = core.load_module(first.bench_dir / "drivers" / f"{first.traffic['kind']}.py",
                              f"bench_port_driver_{first.traffic['kind']}")
    lines_of = train_lines if first.traffic["kind"] == "train" else eval_lines
    control = set(seeds(args.control_seeds))
    diag = ({"diagnose": True, "leaf": args.leaf or None, "cpu": args.cpu}
            if args.diagnose and lines_of is train_lines else {})
    for seed in sorted(set(seeds(args.seeds)) | control):
        t = time.time()
        for side, got in lines_of(make_run(args, seed, root, dev), driver, seed in control,
                                  **diag):
            print(json.dumps({"seed": seed, "side": side, "seconds": time.time() - t, **got}),
                  flush=True)
    names = [f for f in args.faults.split(",") if f]
    for seed in seeds(args.fault_seeds):
        for name in names:
            run = make_run(args, seed, root, dev)
            with faults.plant(run.traffic["kind"], name, run.config["task"]):
                for side, got in lines_of(run, driver, False, name, **diag):
                    print(json.dumps({"seed": seed, "side": side, **got}), flush=True)
    found = core.forbidden_modules()
    if found:
        print(f"loaded: {found}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    core.fixed_caches()
    sys.exit(main())
