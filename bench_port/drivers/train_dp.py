"""Traffic kind `train_dp`: `train`'s whole iterations on `ranks` processes,
one a card, each holding its share of the cell's arenas (the program's
data parallelism: `mupe_tpu_torch/parallel/dist.py`).

The benchmark's process is rank 0: it builds the kernels once, starts
ranks 1.. as children of this file (`--dp-rank`), forms the group over
`backend` at a `localhost` port and measures and prints; every rank checks
that it loaded no JAX module.  Each rank runs `train.Setup` (the program
built through `harness.build`, which shards the arenas over the group,
and the check iterations captured), then the window: rank 0 says over a
host-side gloo group before each iteration whether the window goes on,
so every rank runs the same iterations.  With `--trace 1` rank 0 times
`trace_iters` iterations untraced and as many traced, while the other
ranks run as many.  The record is rank 0's: its model counts rank 0's
arenas and its share of each minibatch's rows.

The check has two parts.  The ranks' learners (parameters, optimizer
states, value normaliser) must hold the same bits when the iterations
end (`ranks`: how many ranks differ from rank 0, by an all-gathered
digest).  And rank 0 is held to the reference as `train` holds its
process: the captured rollouts, env steps and first observation are
gathered from every rank in arena order, so the reference follows the
one-process iteration of every rank's arenas.

A rank that fails or stalls ends the run non-zero in bounded time: the
group's collectives time out after `timeout_s`, and rank 0's watchdog
kills the children and exits as soon as one exits non-zero, or when the
run outlives `seconds + deadline_s`.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import hashlib
import os
import socket
import subprocess
import sys
import threading
import time
import traceback
import types
from pathlib import Path
from typing import Any, Dict, List

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402
import torch.distributed as tdist  # noqa: E402

from bench_port import checks, core, program, tracing  # noqa: E402
from bench_port.drivers import train as base  # noqa: E402

CHILD = "--dp-rank"


def run(run: core.Run) -> core.Outcome:
    """Rank 0: start the other ranks, run this one, wait for them."""
    tr = run.traffic
    world = int(tr["ranks"])
    if run.device.type == "cuda":
        from mupe_tpu_torch.ops import build

        build.library()  # once, before the ranks start
    port = _free_port()
    if tr["backend"] == "nccl":
        # every rank is on this host: NCCL's bootstrap over the loopback
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    # the children import the program this process imported
    import mupe_tpu_torch

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(mupe_tpu_torch.__file__).resolve().parents[1])]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen(
        [sys.executable, __file__, CHILD, str(r), "--port", str(port), "--workload", run.name,
         "--seed", str(run.seed), "--seconds", repr(run.seconds), "--trace", str(int(run.trace)),
         "--root", str(run.bench_dir.parent), "--device", run.device.type],
        stdout=sys.stderr, cwd=str(run.bench_dir.parent), env=env) for r in range(1, world)]
    done = threading.Event()
    deadline = time.time() + run.seconds + float(tr["deadline_s"])
    watch = threading.Thread(target=_watchdog, args=(procs, done, deadline), daemon=True)
    watch.start()
    try:
        out = rank_main(run, 0, world, port)
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 1.0))
    except BaseException:
        # the group may still wait on the children: end them, then this
        # process, without tearing the group down
        done.set()
        _kill(procs)
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(3)
    done.set()
    _kill(procs)
    if any(p.returncode != 0 for p in procs):
        raise core.BenchError(f"a rank failed: exit codes {[p.returncode for p in procs]}", 3)
    return out


def _watchdog(procs, done: threading.Event, deadline: float) -> None:
    """End the run (exit 3, no result) when a child exits non-zero or the
    run outlives its deadline."""
    while not done.wait(0.5):
        failed = [p.returncode for p in procs if p.poll() not in (None, 0)]
        late = time.time() > deadline
        if failed or late:
            why = f"rank exit codes {failed}" if failed else "the run outlived its deadline"
            print(f"bench_port: train_dp: {why}; ending every rank", file=sys.stderr, flush=True)
            _kill(procs)
            os._exit(3)


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _device(kind: str, rank: int) -> torch.device:
    if kind != "cuda":
        return torch.device(kind)
    return torch.device("cuda", rank % torch.cuda.device_count())


def rank_main(run: core.Run, rank: int, world: int, port: int):
    """One rank's run: join, set up, window, trace, gather, and on rank 0
    the check against the reference (its Outcome; None elsewhere)."""
    tr = run.traffic
    dev = run.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if tr["backend"] == "nccl" else {}
    tdist.init_process_group(tr["backend"], init_method=f"tcp://127.0.0.1:{port}",
                             world_size=world, rank=rank,
                             timeout=datetime.timedelta(seconds=float(tr["timeout_s"])), **kw)
    ctl = tdist.new_group(backend="gloo") if tr["backend"] != "gloo" else None
    out = _ranked(run, rank, world, ctl)
    tdist.destroy_process_group()
    return out


def _ranked(run: core.Run, rank: int, world: int, ctl):
    tr = run.traffic
    dev = run.device
    st = base.Setup(run)
    env, policy, train_iter, carry, t_len = st.env, st.policy, st.train_iter, st.carry, st.t_len
    spans = tracing.Spans(dev) if run.trace and rank == 0 else None
    mark_fn = None
    if spans is not None:
        mark_fn = base._install_spans(env, policy, spans, env.cfg.max_episode_length,
                                      start=tr["check_iters"] * t_len)
    t0 = time.time()
    setup_s = t0 - run.t_start
    iters, failed, pending, blocks = 0, 0, [], [t0]
    while _go_on(rank == 0 and time.time() - t0 < run.seconds, ctl):
        carry, metrics, _ = train_iter(carry, mark=mark_fn)
        iters += 1
        pending.append(metrics)
        if iters % tr["log_interval"] == 0:
            failed += sum(not checks.finite(m.values()) for m in pending)
            pending = []
            blocks.append(time.time())
    base._sync(dev)
    wall = time.time() - t0
    if rank == 0:
        print("info: window blocks of %d iterations, s: %s" % (tr["log_interval"], " ".join(
            f"{b - a:.3f}" for a, b in zip(blocks, blocks[1:]))), file=sys.stderr)
    failed += sum(not checks.finite(m.values()) for m in pending)
    record = breakdown = None
    if run.trace:
        if rank == 0:
            tracing.unwrap(env, "step")
            tracing.unwrap(policy, "act")
            record, breakdown = base._traced(run, env, policy, train_iter, carry, spans,
                                             tr["trace_iters"], t_len)
            m = local_model(env, st.layout, st.algo_cfg, world)
            record.update(kind="train_dp", model=m, window={"iters": iters, "wall_s": wall},
                          iter_flops=base.iteration_flops(m))
        else:
            for _ in range(2 * tr["trace_iters"]):
                carry, _, _ = train_iter(carry)
            base._sync(dev)
    differ = ranks_differing(carry.ts, ctl)
    gathered = gather_capture(st, ctl)
    device = core.card_info(dev) if rank == 0 else None
    st.release()
    del carry, train_iter, env, policy
    if rank != 0:
        return None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        device["count"] = world
    t = time.time()
    ref = base.reference(run, st.layout, st.algo_cfg, program.rounding(st.algo_cfg))
    got = base.readings(run, gathered["cap"], gathered["first_obs"], st.reset_gen,
                        st.prog_after, st.env_cfg, ref, st.layout)
    got["ranks"] = float(differ)
    print(f"info: {world} ranks, {iters} iterations in {wall:.2f} s; build "
          f"{st.times['build']:.2f} s, check iterations {st.times['check_iters']:.2f} s, "
          f"reference {time.time() - t:.2f} s", file=sys.stderr)
    checks_ = [core.Check(name, got[name], limit) for name, limit in run.cell["limits"].items()]
    e2e = {"train_env_steps_per_s": iters * st.env_cfg.num_envs * t_len / wall,
           "setup_s": setup_s}
    return core.Outcome(e2e=e2e, attempted=iters, failed=failed, checks=checks_, device=device,
                        record=record, breakdown=breakdown)


def _go_on(flag: bool, ctl) -> bool:
    """Rank 0's `flag` on every rank (a host-side broadcast)."""
    x = torch.tensor([int(flag)], dtype=torch.int32)
    tdist.broadcast(x, src=0, group=ctl)
    return bool(x.item())


def local_model(env, layout, algo_cfg, world: int) -> Dict[str, Any]:
    """`train`'s model of the shapes at rank 0's share: its arenas, a
    quarter (1 / world) of each minibatch's rows, its TP windows."""
    m = base._model(env, layout, algo_cfg)
    m["arenas"] = env.shard.size
    m["mb_rows"] //= world
    if m["tp"] is not None:
        m["tp"]["windows"] //= world
    return m


# ------------------------------------------------------------ gathering
def _gather(x: torch.Tensor, axis: int, ctl) -> torch.Tensor:
    """Every rank's `x` (on the host) joined along `axis` in rank order."""
    y = x.detach().cpu().contiguous()
    is_bool = y.dtype == torch.bool
    if is_bool:
        y = y.to(torch.uint8)
    parts = [torch.empty_like(y) for _ in range(tdist.get_world_size())]
    tdist.all_gather(parts, y, group=ctl)
    out = torch.cat(parts, dim=axis)
    return out.bool() if is_bool else out


def _tree(x, fn):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree(v, fn) for v in x)
    return x


def gather_capture(st, ctl) -> Dict[str, Any]:
    """The captured rollouts ([T, E, ...]: arenas on axis 1), env steps and
    first observation of every rank, in the one-process layout."""
    from mupe_tpu_torch.parallel import dist

    cap = st.cap
    rollouts = []
    for r in cap.rollouts:
        rollouts.append({"traj": _tree(r["traj"], lambda x: _gather(x, 1, ctl)),
                         "last_obs": _tree(r["last_obs"], lambda x: _gather(x, 0, ctl)),
                         "perms": r["perms"], "metrics": r["metrics"]})
    arenas = lambda x: dist._map_arena_leaves(x, lambda y: _gather(y, 0, ctl))  # noqa: E731
    snaps = [dict(s, state=arenas(s["state"]), action=_gather(s["action"], 0, ctl),
                  out=arenas(s["out"])) for s in cap.snaps]
    gcap = types.SimpleNamespace(rollouts=rollouts, snaps=snaps, first=cap.first,
                                 mb_losses=cap.mb_losses, after_steps=cap.after_steps)
    return {"cap": gcap, "first_obs": _tree(st.first_obs, lambda x: _gather(x, 0, ctl))}


def _learner_tensors(x, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """Every tensor of the learner state, in a fixed order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, torch.nn.Module):
        out += list(x.parameters()) + list(x.buffers())
    elif isinstance(x, (list, tuple)):
        for v in x:
            _learner_tensors(v, out)
    elif isinstance(x, dict):
        for k in sorted(x):
            _learner_tensors(x[k], out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _learner_tensors(getattr(x, f.name), out)
    return out


def digest(ts) -> int:
    h = hashlib.sha256()
    for t in _learner_tensors(ts, []):
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return int.from_bytes(h.digest()[:8], "little", signed=True)


def ranks_differing(ts, ctl) -> int:
    """How many ranks' learner bits differ from rank 0's."""
    d = _gather(torch.tensor([digest(ts)], dtype=torch.int64), 0, ctl)
    return int(torch.sum(d != d[0]))


# ------------------------------------------------------------ a child rank
def child(argv=None) -> int:
    p = argparse.ArgumentParser(description="One rank (> 0) of a train_dp cell.")
    p.add_argument(CHILD, dest="rank", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, required=True)
    p.add_argument("--root", required=True)
    p.add_argument("--device", required=True)
    args = p.parse_args(argv)
    root = Path(args.root)
    bench_dir = root / "bench_port"
    manifest = core.load_json(root / "BENCHMARK.json")
    entry = core.manifest_entry(manifest, args.workload)
    traffic = core.load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    run = core.Run(name=args.workload,
                   config=core.load_json(bench_dir / "configs" / f"{entry['config']}.json"),
                   cell=core.load_json(bench_dir / "workloads" / f"{args.workload}.json"),
                   traffic=traffic, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                   device=_device(args.device, args.rank), t_start=time.time(),
                   bench_dir=bench_dir)
    try:
        rank_main(run, args.rank, int(traffic["ranks"]), args.port)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    found = core.forbidden_modules()
    if found:
        print(f"bench_port: rank {args.rank} loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    core.fixed_caches()
    sys.exit(child())
