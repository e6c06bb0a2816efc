#!/usr/bin/env python3
"""The readings that `hover_vision.train`'s limits are set from, on the chip:

    python3 bench_port/readings_vision.py --seeds 1-12 --control-seeds 1-3 \
        --fault-seeds 1-3 --faults se,hswish,unchanged

For each seed, one JSON line a side, each with every compared number:
`program` (the program against the reference, as a run compares them),
`control` (the same program with TF32 convolutions, the lower precision an
H100 takes silently, `torch.backends.cudnn.allow_tf32 = True`, against the
float32 reference; its `env`, the reference stepping from bfloat16 states)
and `fault:<name>` (a fault of `faults_vision.py`
planted).  The benchmark's own runs never run this.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_port import core, faults_vision  # noqa: E402
from bench_port.readings import make_run, seeds  # noqa: E402


def lines(run, driver, side: str):
    import torch

    st = driver.Setup(run)
    torch.backends.cudnn.allow_tf32 = False
    st.release()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = driver.reference(run, st)
    got = driver.readings(run, st, ref)
    if side == "control":
        # the env's lower precision: the reference stepping from its
        # states held in bfloat16, in the program's place
        got["env"] = driver.base.env_reading(run, st.cap, st.first_obs, st.reset_gen,
                                             st.env_cfg, ref, control=True)
    return {"side": side, **got}


def main(argv=None, root: Path = core.REPO, device=None) -> int:
    import torch

    # the program's import turns TF32 off: it comes before the control's flag
    import mupe_tpu_torch  # noqa: F401

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="hover_vision.train")
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default="")
    args = p.parse_args(argv)
    dev = torch.device(device or "cuda")
    first = make_run(args, 0, root, dev)
    driver = core.load_module(first.bench_dir / "drivers" / f"{first.traffic['kind']}.py",
                              f"bench_port_driver_{first.traffic['kind']}")
    for seed in seeds(args.seeds):
        t = time.time()
        out = lines(make_run(args, seed, root, dev), driver, "program")
        print(json.dumps({"seed": seed, "seconds": time.time() - t, **out}), flush=True)
    for seed in seeds(args.control_seeds):
        torch.backends.cudnn.allow_tf32 = True
        out = lines(make_run(args, seed, root, dev), driver, "control")
        print(json.dumps({"seed": seed, **out}), flush=True)
    for seed in seeds(args.fault_seeds):
        for name in [f for f in args.faults.split(",") if f]:
            with faults_vision.VISION[name]():
                out = lines(make_run(args, seed, root, dev), driver, f"fault:{name}")
            print(json.dumps({"seed": seed, **out}), flush=True)
    found = core.forbidden_modules()
    if found:
        print(f"loaded: {found}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    core.fixed_caches()
    sys.exit(main())
