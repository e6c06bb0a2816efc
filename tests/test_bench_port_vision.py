"""ppo_vision's MobileNetV3-Small path against the benchmark's plain
reference (`bench_port/reference/vision.py`) on the CPU, its spans, the
backbone's operation count, and the cell `hover_vision.train` end to end
at a tiny size (its faults read not correct).

    python -m pytest tests/test_bench_port_vision.py -q

The benchmark's runs refuse a process that loaded JAX, which this test
suite's conftest imports: the cell runs in a child process.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from bench_port.drivers import train_vision as tv  # noqa: E402
from bench_port.flops import mobilenet as mnv3  # noqa: E402
from bench_port.reference import nets, vision  # noqa: E402
from bench_port.reference.update import clip_global  # noqa: E402
from mupe_tpu_torch import harness  # noqa: E402
from mupe_tpu_torch.learning import init_carry, make_train_iter  # noqa: E402
from mupe_tpu_torch.learning.rollout import make_rollout  # noqa: E402
from mupe_tpu_torch.utils import trace  # noqa: E402

ENV = {"num_envs": 8, "max_episode_length": 300, "obs_depth": True, "depth_width": 64,
       "depth_height": 48}
ALGO = {"train_every": 4, "num_minibatches": 2, "ppo_epochs": 1,
        "vision_encoder": "mobilenet_v3_small"}


def _build(algo=ALGO):
    env, policy, _, algo_cfg = harness.build("Hover", ENV, algo, "ppo_vision", "cpu")
    layout = tv.layout_of(env, policy)
    params = tv.draw_parameters(layout, torch.Generator().manual_seed(5), "cpu")
    ts = policy.init(tv.obs_example(layout, "cpu"), actor_leaves=params["actor"],
                     log_std=params["log_std"], critic_leaves=params["critic"])
    carry = init_carry(env, policy, torch.Generator().manual_seed(6), ts=ts)
    ref = vision.VisionLearner(
        actor=[l.clone() for l in params["actor"]], log_std=params["log_std"].clone(),
        critic=[l.clone() for l in params["critic"]], tp=None,
        cfg={k: getattr(algo_cfg, k) for k in tv.program.ALGO_KEYS}, rnd=nets.exact,
        frame=layout.frame)
    return env, policy, layout, carry, ref


def _split(flat, layout):
    sizes = [vision.layout_size([l]) for l in layout]
    return [p.reshape(s) for p, (s, _) in zip(torch.split(flat.detach(), sizes), layout)]


def test_the_port_matches_the_reference():
    """8 arenas x 4 steps of 64 x 48 frames, 2 minibatches: the act's
    log-probs and values, the first minibatch's loss and clipped gradients
    by leaf, every leaf after the 2 steps."""
    env, policy, layout, carry, ref = _build()
    before = [l.clone() for l in ref.actor + [ref.log_std] + ref.critic]
    carry, traj, _ = make_rollout(env, policy)(carry)
    r_logp, r_value = tv.act_outputs(traj, ref, "cpu")
    torch.testing.assert_close(traj["logp"], r_logp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(traj["value"], r_value, rtol=1e-4, atol=1e-5)
    seen = {"info": [], "actor": [], "critic": []}
    for attr in ("_actor_step", "_critic_step"):
        orig = getattr(policy, attr)
        which = attr[1:].split("_")[0]
        setattr(policy, attr, lambda ts, g, stop, _o=orig, _w=which: (
            seen[_w].append([x.clone() for x in g]), _o(ts, g, stop))[1])
    orig_mb = policy._update_actor_critic
    policy._update_actor_critic = lambda *a, **kw: (
        lambda info: (seen["info"].append({k: float(v) for k, v in info.items()}), info)[1])(
        orig_mb(*a, **kw))
    perms = torch.randperm(4 * 8, generator=torch.Generator().manual_seed(7))[None]
    first = {}
    out = ref.train_op(traj, carry.obs, perms, first=first)
    policy.train_op(carry.ts, traj, carry.obs, perms=perms)
    assert len(seen["info"]) == len(out["steps"]) == 2
    i0 = seen["info"][0]
    assert i0["policy_loss"] + i0["value_loss"] == pytest.approx(sum(out["steps"][0]), rel=1e-5)
    ga = clip_global(seen["actor"][0], 10.0)
    gc = clip_global(seen["critic"][0], 10.0)
    prog_g = _split(ga[0], layout.actor()) + [ga[1]] + _split(gc[0], layout.critic())
    ref_g = first["actor"] + [first["log_std"]] + first["critic"]
    assert len(prog_g) == len(ref_g)
    # leaves whose gradient vanishes (a norm's offset before another norm)
    # hold rounding noise: each leaf is held against the median leaf's norm
    med = sorted(float(r.norm()) for r in ref_g)[len(ref_g) // 2]
    for p, r in zip(prog_g, ref_g):
        assert float((p - r).norm()) <= 1e-3 * max(float(r.norm()), med)
    # each leaf's change over the 2 steps, against the larger of its own
    # and the median leaf's: Adam's first steps move an element by about
    # its rate whatever its gradient, so an element whose gradient is
    # rounding noise may move either way; leaves whose first gradient
    # vanishes are left out
    after = (_split(carry.ts.actor.flat, layout.actor()) + [carry.ts.log_std]
             + _split(carry.ts.critic.flat, layout.critic()))
    ref_after = ref.actor + [ref.log_std] + ref.critic
    moved = [float((r - b).norm()) for r, b in zip(ref_after, before)]
    med_moved = sorted(moved)[len(moved) // 2]
    gaps = sorted(float(((p - b) - (r - b)).norm()) / max(m, med_moved)
                  for p, r, b, m, g in zip(after, ref_after, before, moved, ref_g)
                  if float(g.norm()) >= 1e-3 * med)
    assert len(gaps) > 0.9 * len(after) and gaps[-1] < 0.1 and gaps[len(gaps) // 2] < 1e-2


def test_the_new_spans_count_an_iteration():
    """`vision.backbone` (each network call), `env.depth` (each observed
    frame), `update.actor` / `update.critic` (each minibatch)."""
    env, policy, _, carry, _ = _build(dict(ALGO, ppo_epochs=2))
    train_iter = make_train_iter(env, policy)
    before = trace.counts().copy()
    train_iter(carry)
    got = {k: trace.counts()[k] - before[k] for k in
           ("vision.backbone", "env.depth", "update.actor", "update.critic", "env.step")}
    # 4 steps: actor and critic each act; the bootstrap value; 2 x 2
    # minibatches of both networks
    assert got == {"vision.backbone": 4 * 2 + 1 + 4 * 2, "env.depth": 4, "update.actor": 4,
                   "update.critic": 4, "env.step": 4}


_DIST = r"""
import json, sys, torch, torch.distributed as tdist
from mupe_tpu_torch.parallel import dist
from mupe_tpu_torch.utils import trace
rank, store = int(sys.argv[1]), sys.argv[2]
tdist.init_process_group("gloo", init_method=store, world_size=2, rank=rank)
x = torch.ones(3, requires_grad=True)
dist.all_reduce_sum_grad(x).sum().backward()   # forward and backward: 2
dist.all_reduce_sum(torch.ones(2)); dist.all_reduce_max(torch.ones(2))
dist.all_reduce_tensors([torch.ones(2), torch.ones(3)]); dist.any_across(torch.ones(1))
dist.all_gather_envs(torch.ones(2, 2))
tdist.destroy_process_group()
print(json.dumps({k: v for k, v in trace.counts().items() if k.startswith(("dist.", "sync."))}))
"""


def test_the_collectives_are_spans(tmp_path):
    store = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen([sys.executable, "-c", _DIST, str(r), store], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env={**_env(), "OMP_NUM_THREADS": "1"}) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    for out, _ in outs:
        counts = json.loads(out.strip().splitlines()[-1])
        assert counts == {"dist.all_reduce": 6, "dist.all_gather": 1, "sync.any_across": 1}


def _env():
    import os

    return {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}


def test_the_backbone_count_by_hand():
    """At 64 x 48 (H 48, W 64): the stem 3 x 3 stride 2 over 3 channels to
    16 at 24 x 32; blocks 1 and 2 halve it twice; block 4 (index 3: 5 x 5,
    24 -> 96 -> 40, gate 24, stride 2) takes 6 x 8 to 3 x 4."""
    layers = mnv3.layers(48, 64)
    stem = layers[0]
    assert (stem["ho"], stem["wo"]) == (24, 32)
    # blocks 1-3 hold 2, 3, 3 convolutions (block 1 has no expansion)
    expand, depthwise, project = layers[1 + 2 + 3 + 3:][:3]
    assert (expand["h"], expand["w"], depthwise["ho"], depthwise["wo"]) == (6, 8, 3, 4)
    macs = 6 * 8 * 96 * 24 + 3 * 4 * 96 * 25 + 2 * 96 * 24 + 3 * 4 * 40 * 96
    assert sum(mnv3._macs(l) for l in (expand, depthwise, project)) == macs
    assert mnv3._macs(stem) == 24 * 32 * 16 * 27
    # 11 blocks (10 with an expansion) + the stem and the last convolution
    assert len(layers) == 1 + 10 * 3 + 2 + 1
    assert layers[-1]["c_out"] == 576 and (layers[-1]["ho"], layers[-1]["wo"]) == (2, 2)
    f = mnv3.forward_flops(48, 64, 10)
    assert mnv3.fwd_bwd_flops(48, 64, 10) == 3 * f - 2 * 10 * 24 * 32 * 16 * 27
    # bytes (float32): the input and output, the norm's two reads and one
    # write, the kernel and the gate's two Dense layers once
    assert mnv3._bytes(depthwise, 10) == 4 * (10 * (96 * 6 * 8 + 4 * 96 * 3 * 4)
                                             + 96 * 25 + 2 * 96 * 24)
    assert mnv3.forward_bytes(48, 64, 10) == sum(mnv3._bytes(l, 10) for l in layers)
    assert mnv3.fwd_bwd_bytes(48, 64, 10) == 3 * mnv3.forward_bytes(48, 64, 10)
    assert mnv3.bound_s(67e12, 0) == 1.0 and mnv3.bound_s(0, 3.35e12) == 1.0


_CELL = r"""
import json, sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from bench_port import core, faults_vision
root = Path(sys.argv[2])
args = ["--workload", "tinyv.train", "--seed", "4294967311", "--seconds", "1", "--trace"]
out = {}
for name in ["none", "se", "hswish", "unchanged"]:
    if name == "none":
        rc = core.main(args + ["1"], root=root, device="cpu")
    else:
        with faults_vision.VISION[name]():
            rc = core.main(args + ["0"], root=root, device="cpu")
    out[name] = rc
    print("RESULT " + name + " " + str(rc), flush=True)
"""


def tiny_vision_root(tmp_path) -> Path:
    """A checkout root holding the benchmark's files and the cell
    `tinyv.train`: hover_vision.train's files at 8 arenas x 4 steps, 2
    minibatches and 2 epochs."""
    import shutil

    root = tmp_path / "checkout"
    shutil.copytree(REPO / "bench_port", root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    b = root / "bench_port"
    cfg = json.loads((b / "configs" / "hover_vision_mnv3s.json").read_text())
    cfg["env"]["num_envs"] = 8
    cfg["algo_cfg"].update(train_every=4, num_minibatches=2, ppo_epochs=2)
    (b / "configs" / "tiny_vision.json").write_text(json.dumps(cfg))
    cell = json.loads((b / "workloads" / "hover_vision.train.json").read_text())
    (b / "workloads" / "tinyv.train.json").write_text(json.dumps(dict(cell, config="tiny_vision")))
    m = json.loads((REPO / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "tinyv.train", "config": "tiny_vision",
                           "traffic": "train_vision", "chips": 1, "why": "a CPU test's cell"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if "hover_vision.train" in metric.get("workloads", []):
            metric["workloads"].append("tinyv.train")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root


def test_the_cell_runs_and_each_fault_reads_not_correct(tmp_path):
    root = tiny_vision_root(tmp_path)
    p = subprocess.run([sys.executable, "-c", _CELL, str(REPO), str(root)], cwd=REPO,
                       capture_output=True, text=True, timeout=600,
                       env={**_env(), "OMP_NUM_THREADS": "2"})
    lines = p.stdout.splitlines()
    rcs = {l.split()[1]: int(l.split()[2]) for l in lines if l.startswith("RESULT ")}
    assert p.returncode == 0 and rcs == {"none": 0, "se": 0, "hswish": 0, "unchanged": 0}, \
        p.stderr[-3000:]
    results = [json.loads(l) for l in lines if l.startswith("{")]
    assert [r["correct"] for r in results] == [True, False, False, False], \
        [r["checks"] for r in results]
    traced = results[0]
    assert traced["failed"] == 0 and traced["attempted"] >= 1
    assert {"busy_s", "window_s"} <= set(traced["device"])
    # no card: the program's spans hold no device times, so the span
    # readers find nothing; what is read is a finite number
    assert all(v["value"] == v["value"] for v in traced["metrics"].values())
