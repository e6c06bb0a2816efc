"""The joint PPO minibatch as one CUDA graph (`MAPPOPolicy._minibatch`,
`mupe_tpu_torch/utils/graphs.py`) and Adam's device-held betas.

On the CPU the minibatch runs eagerly and gives the bits of the sequence
it replaced (`_joint_grads`, `_step`, the info metrics), an Adam step gives
the bits of the betas copied from the host without a copy, and with a
process group the site is not entered.  On a card replayed minibatches
give the eager path's bits over two iterations from one capture, leave
their kernel spans under a profiler, and give the benchmark's check
readings of an eager policy:

    python -m pytest tests/test_torch_update_graph.py -m gpu --noconftest -q

This file imports no JAX, so it runs on a card without the conftest.
"""
from __future__ import annotations

import contextlib
import copy
import importlib.util
from pathlib import Path

import pytest
import torch
import torch.distributed as tdist

from mupe_tpu_torch import harness
from mupe_tpu_torch.learning import init_carry, make_rollout
from mupe_tpu_torch.learning.mappo import compute_pack_meta
from mupe_tpu_torch.learning.optim import AdamState, adam_updates, global_norm
from mupe_tpu_torch.parallel import dist
from mupe_tpu_torch.utils import trace

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]
INFO_KEYS = ("policy_loss", "actor_grad_norm", "entropy", "ESS", "value_loss",
             "critic_grad_norm", "explained_var", "approx_kl")


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device(name)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _same(xs, ys) -> bool:
    xs, ys = list(xs), list(ys)
    return len(xs) == len(ys) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(_bits(x), _bits(y))
        for x, y in zip(xs, ys))


def _syncs() -> dict:
    return {k: v for k, v in trace.counts().items() if k.startswith("sync.")}


# ------------------------------------------------------------ Adam's betas
def _adam_host_betas(grads, state, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                     params=None):
    """`adam_updates` as it was: each beta copied from the host a step."""
    mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
    nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)]
    count = state.count + 1
    c = count.to(torch.float32)
    bc1 = 1 - torch.pow(torch.as_tensor(b1, dtype=torch.float32, device=c.device), c)
    bc2 = 1 - torch.pow(torch.as_tensor(b2, dtype=torch.float32, device=c.device), c)
    direction = [(m / bc1) / (torch.sqrt(v / bc2) + eps) for m, v in zip(mu, nu)]
    if weight_decay > 0.0:
        direction = [d + weight_decay * p for d, p in zip(direction, params)]
    return [(-lr) * d for d in direction], AdamState(mu=mu, nu=nu, count=count)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
@pytest.mark.parametrize("start", [0, 997])
def test_adam_with_device_betas_gives_the_host_copys_bits(device, weight_decay, start):
    """Four steps from a count of `start`, both AdamW branches: the same
    updates and state, and no `sync.*` span entered."""
    dev = _device(device)
    g = torch.Generator().manual_seed(start + 1)
    params = [torch.randn(1000, generator=g).to(dev), torch.randn(4, generator=g).to(dev)]
    ours = AdamState.zeros_like(params)
    ours.count.fill_(start)
    theirs = copy.deepcopy(ours)
    before = _syncs()
    for _ in range(4):
        grads = [torch.randn(p.shape, generator=g).to(dev) for p in params]
        upd, ours = adam_updates(grads, ours, 5e-4, weight_decay=weight_decay, params=params)
        want, theirs = _adam_host_betas(grads, theirs, 5e-4, weight_decay=weight_decay,
                                        params=params)
        assert _same(upd, want) and _same(ours.tensors(), theirs.tensors())
    assert _syncs() == before


# ------------------------------------------------------------ the minibatch
def _policy(dev, algo=None, num_envs=8, steps=8, minibatches=2):
    algo = {"train_every": steps, "num_minibatches": minibatches, "ppo_epochs": 1,
            **(algo or {})}
    env, pol, _, _ = harness.build("HideAndSeek", {"num_envs": num_envs,
                                                   "max_episode_length": 50}, algo, device=dev)
    carry = init_carry(env, pol, torch.Generator(device=dev).manual_seed(0))
    return env, pol, carry


def _minibatches(pol, obs, rows: int, count: int, dev):
    """`count` random minibatches of `rows` rows in the joint update's
    layout."""
    meta = compute_pack_meta(obs, pol.n_agents, pol.action_dim)
    g = torch.Generator().manual_seed(rows + count)
    s = rows * pol.n_agents
    out = []
    for _ in range(count):
        mb = {"obs_rows": torch.randn(s, meta.obs_dim, generator=g),
              "action": torch.randn(s, pol.action_dim, generator=g),
              "logp": torch.randn(s, generator=g) - 4.0,
              "value": torch.randn(s, generator=g),
              "advantages": torch.randn(s, generator=g),
              "returns": 1.5 * torch.randn(s, generator=g)}
        out.append({k: v.to(dev) for k, v in mb.items()})
    return out


def _state_tensors(ts):
    out = [*ts.actor_params(), *ts.critic_params(), *ts.actor_opt.tensors(),
           *ts.critic_opt.tensors()]
    return out + ([ts.entropy_coef] if ts.entropy_coef is not None else [])


def _sequence_before(pol, ts, mb, stop, mb_rows):
    """The minibatch as `_update_joint_flat` ran it before it was a graph
    site: `_joint_grads`, `_step`, the info metrics from the sums."""
    ga, gc, terms = pol._joint_grads(ts, mb, mb_rows)
    pol._step(ts, ga, gc, stop)
    with torch.no_grad():
        n = terms["count"]
        ratio, ratio2, kl, sqerr, ret, ret2 = terms["sums"].unbind()
        ret_var = ret2 / n - torch.square(ret / n)
        return {"policy_loss": terms["policy_loss"], "actor_grad_norm": global_norm(ga),
                "entropy": terms["entropy"], "ESS": torch.square(ratio) / (ratio2 * n),
                "value_loss": terms["value_loss"], "critic_grad_norm": global_norm(gc),
                "explained_var": 1.0 - (sqerr / n) / (ret_var + 1e-8), "approx_kl": kl / n}


@pytest.mark.parametrize("algo", [{}, {"target_kl": 0.01, "entropy_target": 1.0,
                                       "min_log_std": -1.0, "weight_decay": 1e-3}])
def test_the_minibatch_step_gives_the_sequence_it_replaced(algo):
    """Three minibatches on the CPU (eager): the same parameters, Adam
    states and info metrics, bit for bit, as the sequence before; with
    `target_kl` the stop flag is carried as `train_op` carries it."""
    _, pol, carry = _policy("cpu", algo)
    ts_a, ts_b = carry.ts, copy.deepcopy(carry.ts)
    if ts_a.entropy_coef is not None:
        ts_a.entropy_coef.fill_(0.004)
        ts_b.entropy_coef.fill_(0.004)
    stop_a = stop_b = (torch.zeros((), dtype=torch.bool) if pol.cfg.target_kl is not None
                       else None)
    for mb in _minibatches(pol, carry.obs, 16, 3, "cpu"):
        got = pol._update_joint_flat(ts_a, mb, stop_a, mb_rows=16)
        want = _sequence_before(pol, ts_b, mb, stop_b, 16)
        assert set(got) == set(INFO_KEYS)
        assert _same([got[k] for k in INFO_KEYS], [want[k] for k in INFO_KEYS])
        assert _same(_state_tensors(ts_a), _state_tensors(ts_b))
        if stop_a is not None:
            stop_a = torch.logical_or(stop_a, got["approx_kl"] > pol.cfg.target_kl)
            stop_b = torch.logical_or(stop_b, want["approx_kl"] > pol.cfg.target_kl)


@contextlib.contextmanager
def _process_group(tmp_path):
    """A gloo group of one rank in this process (a `file://` store)."""
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                             world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy()


def test_the_minibatch_site_runs_eagerly_on_the_cpu_and_is_bypassed_with_ranks(tmp_path):
    """On the CPU the site opens `graph.eager` and keeps no graph; with a
    process group the minibatch does not enter the site at all, and gives
    the same bits (one rank)."""
    _, pol, carry = _policy("cpu")
    ts_a, ts_b = carry.ts, copy.deepcopy(carry.ts)
    (mb,) = _minibatches(pol, carry.obs, 16, 1, "cpu")
    before = trace.counts().copy()
    info_a = pol._update_joint_flat(ts_a, mb, None, mb_rows=16)
    assert trace.counts()["graph.eager"] - before["graph.eager"] == 1
    assert not pol._update_graph.graphs
    with _process_group(tmp_path):
        assert dist.is_initialized()
        before = trace.counts().copy()
        info_b = pol._update_joint_flat(ts_b, mb, None, mb_rows=16)
        assert all(trace.counts()[k] == before[k]
                   for k in ("graph.eager", "graph.replay", "graph.capture"))
    assert _same([info_a[k] for k in INFO_KEYS], [info_b[k] for k in INFO_KEYS])
    assert _same(_state_tensors(ts_a), _state_tensors(ts_b))


def _reader(name: str):
    path = Path(__file__).resolve().parents[1] / "bench_port" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_ppo_replay_share_reads_the_minibatches_graph_spans(monkeypatch):
    read = _reader("ppo_graph_replay_share.train").read
    ppo = ("train.iter", "update", "update.ppo")

    def rec(name, path, ms=1.0):
        return {"name": name, "path": path, "device_ms": ms, "host_ms": 1.0}

    recs = [rec("train.iter", ()), rec("update", ppo[:1]), rec("update.ppo", ppo[:2])]
    recs += [rec("graph.replay", ppo), rec("graph.replay", ppo), rec("graph.replay", ppo),
             rec("kernel.pair_fwd", ppo + ("graph.replay",)), rec("graph.eager", ppo),
             rec("graph.capture", ppo), rec("graph.replay", ("train.iter", "rollout")),
             rec("graph.eager", ("train.iter", "rollout", "env.step"))]
    monkeypatch.setattr(trace, "recorded", lambda: recs)
    assert read({}) == 0.75
    # a program whose minibatches open no graph span: nothing
    monkeypatch.setattr(trace, "recorded",
                        lambda: [r for r in recs if "update.ppo" not in r["path"]])
    assert read({}) is None
    monkeypatch.setattr(trace, "recorded", lambda: [dict(r, device_ms=None) for r in recs])
    assert read({}) is None


# ------------------------------------------------------------ on a card
def _eager(fn, *args, generators=(), **_):
    """A graphed site's eager twin: the function itself."""
    with trace.span("graph.eager"):
        return fn(*generators, *args)


@contextlib.contextmanager
def _eager_update(pol):
    saved = pol._update_graph
    pol._update_graph = _eager
    try:
        yield
    finally:
        pol._update_graph = saved


def _card_iteration_inputs(dev, algo=None):
    """A policy at 256 arenas x 16 steps with 16 minibatches of one epoch,
    its carry after one rollout, the rollout and the epoch's permutation."""
    env, pol, carry = _policy(dev, algo, num_envs=256, steps=16, minibatches=16)
    carry, traj, _ = make_rollout(env, pol)(carry)
    g = torch.Generator(device=dev).manual_seed(5)
    perms = torch.stack([torch.randperm(256 * 16, generator=g, device=dev)])
    return pol, carry, traj, perms


def _all_state(ts):
    return _state_tensors(ts) + [*ts.tp_net.leaves(), *ts.tp_opt.tensors(),
                                 ts.value_norm.running_mean, ts.value_norm.running_mean_sq,
                                 ts.value_norm.debiasing_term]


def _iterations(pol, ts, carry, traj, perms, n=2):
    metrics = []
    for _ in range(n):
        _, m = pol.train_op(ts, traj, carry.obs, perms=perms)
        metrics.append(m)
    return metrics


@pytest.mark.gpu
@pytest.mark.parametrize("algo", [{}, {"use_inkernel_loss": True, "direct_mode": "fwdloss"}])
def test_replayed_minibatches_give_the_eager_bits_from_one_capture(cuda, algo):
    """Two iterations of 16 minibatches on the same rollout (`packed` is
    rebuilt each): the eager path repeats its own bits, and the graphed
    one gives them (state and metrics) with one capture in all."""
    pol, carry, traj, perms = _card_iteration_inputs(cuda, algo)
    states = [copy.deepcopy(carry.ts) for _ in range(3)]
    with _eager_update(pol):
        eager = [_iterations(pol, ts, carry, traj, perms) for ts in states[:2]]
    assert _same(_all_state(states[0]), _all_state(states[1]))
    before = trace.counts().copy()
    graphed = _iterations(pol, states[2], carry, traj, perms)
    counted = trace.counts() - before
    assert counted["graph.capture"] == 1 and counted["graph.replay"] == 31
    assert len(pol._update_graph.graphs) == 1
    assert _same(_all_state(states[2]), _all_state(states[0]))
    for got, want in zip(graphed, eager[0]):
        assert set(got) == set(want) and _same([got[k] for k in want], list(want.values()))


@pytest.mark.gpu
def test_profiled_replays_leave_their_kernel_spans(cuda):
    """After the capture, an iteration under the profiler: no capture, and
    each of its 16 replays leaves `kernel.pair_fwd`, `kernel.pair_bwd` and
    its child `kernel.weight_grad` under `update.ppo`, each with a device
    time inside the replay's; the replay share reads 1."""
    pol, carry, traj, perms = _card_iteration_inputs(cuda)
    ts = carry.ts
    pol.train_op(ts, traj, carry.obs, perms=perms)
    before = trace.counts().copy()
    trace.clear()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        pol.train_op(ts, traj, carry.obs, perms=perms)
    pol.train_op(ts, traj, carry.obs, perms=perms)  # a replay after the profiler
    recs = trace.recorded()
    assert trace.counts()["graph.capture"] == before["graph.capture"]
    ppo = [r for r in recs if "update.ppo" in r["path"]]
    replays = [r for r in ppo if r["name"] == "graph.replay"]
    assert len(replays) == 16
    by_index = {r["index"]: r for r in recs}
    for name, parent in (("kernel.pair_fwd", "graph.replay"), ("kernel.pair_bwd", "graph.replay"),
                         ("kernel.weight_grad", "kernel.pair_bwd")):
        mine = [r for r in ppo if r["name"] == name]
        assert len(mine) == 16, name
        for r in mine:
            up = by_index[r["parent"]]
            assert up["name"] == parent and r["path"][-1] == parent
            assert "graph.replay" in r["path"] and r["host_ms"] == 0.0
            assert 0.0 < r["device_ms"] <= up["device_ms"]
    for rep in replays:
        kids = [r["device_ms"] for r in ppo if r["parent"] == rep["index"]]
        assert len(kids) == 2
        assert rep["self_ms"] == pytest.approx(rep["device_ms"] - sum(kids), abs=1e-3)
    assert _reader("ppo_graph_replay_share.train").read({}) == 1.0
    trace.clear()


def _check_readings(pol, ts, carry, traj, perms):
    """What the benchmark reads in its check iterations, by its wrappers on
    the policy instance: Adam's first moments after the first actor and
    critic steps, the first 3 minibatches' policy + value losses, every
    parameter after the 3rd minibatch."""
    got = {"first": {}, "losses": []}

    def wrap(attr, make):
        setattr(pol, attr, make(getattr(pol, attr)))

    def opt_step(original, which):
        def step(ts_, grads, stop):
            out = original(ts_, grads, stop)
            if which not in got["first"]:
                opt = ts_.actor_opt if which == "actor" else ts_.critic_opt
                got["first"][which] = [m.detach().cpu() / 0.1 for m in opt.mu]
            return out
        return step

    def update(original):
        def call(ts_, mb, stop=None, mb_rows=None):
            info = original(ts_, mb, stop, mb_rows=mb_rows)
            if len(got["losses"]) < 3:
                got["losses"].append(float(info["policy_loss"]) + float(info["value_loss"]))
                if len(got["losses"]) == 3:
                    got["after"] = [t.cpu().clone() for t in _state_tensors(ts_)[:3]]
            return info
        return call

    wrap("_update_joint_flat", update)
    wrap("_actor_step", lambda f: opt_step(f, "actor"))
    wrap("_critic_step", lambda f: opt_step(f, "critic"))
    try:
        pol.train_op(ts, traj, carry.obs, perms=perms)
    finally:
        for attr in ("_update_joint_flat", "_actor_step", "_critic_step"):
            delattr(pol, attr)
    return got


@pytest.mark.gpu
def test_the_benchmarks_check_readings_match_an_eager_policy(cuda):
    """The first call of the site is the real, eager step (the first
    moments' host read happens there, not in the capture), the 2nd and 3rd
    minibatches replay: every reading equals the eager policy's."""
    pol, carry, traj, perms = _card_iteration_inputs(cuda)
    ts_g, ts_e = copy.deepcopy(carry.ts), copy.deepcopy(carry.ts)
    graphed = _check_readings(pol, ts_g, carry, traj, perms)
    assert len(pol._update_graph.graphs) == 1
    with _eager_update(pol):
        eager = _check_readings(pol, ts_e, carry, traj, perms)
    assert graphed["losses"] == eager["losses"] and len(eager["losses"]) == 3
    for which in ("actor", "critic"):
        assert _same(graphed["first"][which], eager["first"][which])
    assert _same(graphed["after"], eager["after"])
