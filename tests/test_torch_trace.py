"""The program's spans and counters (`mupe_tpu_torch/utils/trace.py`).

Without a profiler a span only counts; under `torch.profiler` it records
its tree (name, parent, root, host times; device times on a card) and a
span that holds no other span opens a profiler range.  A tiny HideAndSeek
iteration records the tree its configuration implies.  On a card, every
host synchronisation of an iteration sits in a `sync.*` span:

    python -m pytest tests/test_torch_trace.py -m gpu --noconftest -q

This file imports no JAX, so it runs on a card without the conftest.
"""
from __future__ import annotations

import collections
import json
import time
import warnings

import pytest
import torch

from mupe_tpu_torch import harness
from mupe_tpu_torch.envs import HideAndSeek
from mupe_tpu_torch.envs.hideandseek import HideAndSeekCfg
from mupe_tpu_torch.learning import MAPPOCfg, MAPPOPolicy, init_carry, make_train_iter
from mupe_tpu_torch.utils import trace

ENV_PARTS = ("env.action", "env.prey", "env.dynamics", "env.detect", "env.reward",
             "env.tp_frame", "env.tp_predict", "env.observe")


def _busy(seconds: float) -> None:
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        pass


def _profiled(fn):
    """Run `fn` under a CPU profiler; (its records, the profiler)."""
    trace.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    recs = trace.recorded()
    trace.clear()
    return recs, prof


def _nest():
    with trace.span("train.iter"):
        with trace.span("rollout"):
            with trace.span("env.step"):
                with trace.span("env.reward"):
                    _busy(2e-3)
                _busy(1e-3)
                with trace.span("sync.any_across"):
                    _busy(2e-3)
        with trace.span("update"):
            with trace.span("update.prep"):
                _busy(1e-3)


def test_without_a_profiler_a_span_only_counts():
    trace.clear()
    before = trace.counts()["env.reward"]
    for _ in range(3):
        with trace.span("env.reward"):
            pass
    assert trace.counts()["env.reward"] == before + 3
    assert trace.counts()["never.entered"] == 0
    assert trace.recorded() == []


def test_under_a_profiler_a_span_records_its_tree():
    recs, _ = _profiled(_nest)
    names = [r["name"] for r in recs]
    assert names == ["train.iter", "rollout", "env.step", "env.reward", "sync.any_across",
                     "update", "update.prep"]
    by = {r["name"]: r for r in recs}
    assert [r["index"] for r in recs] == list(range(len(recs)))
    assert by["train.iter"]["parent"] is None and by["train.iter"]["root"] == 0
    assert by["env.reward"]["parent"] == by["env.step"]["index"]
    assert by["update.prep"]["parent"] == by["update"]["index"]
    assert all(r["root"] == 0 for r in recs)
    assert by["sync.any_across"]["path"] == ("train.iter", "rollout", "env.step")
    assert all(r["device_ms"] is None and r["host_ms"] > 0 for r in recs)
    assert by["env.reward"]["host_ms"] >= 2.0 and by["env.step"]["host_ms"] >= 5.0
    # self = the duration less the children's (host clock without a card)
    step = by["env.step"]
    kids = by["env.reward"]["host_ms"] + by["sync.any_across"]["host_ms"]
    assert step["self_ms"] == pytest.approx(step["host_ms"] - kids, rel=1e-9)
    assert 0.9 <= step["self_ms"] < step["host_ms"] - 3.9
    assert by["env.reward"]["self_ms"] == by["env.reward"]["host_ms"]


def test_only_spans_without_children_open_profiler_ranges():
    _, prof = _profiled(_nest)
    ranges = {e.name for e in prof.events()}
    assert {"env.reward", "sync.any_across", "update.prep"} <= ranges
    assert not {"train.iter", "rollout", "env.step", "update"} & ranges


def test_a_root_starts_a_tree_of_its_own():
    def two_iters():
        for _ in range(2):
            with trace.span("train.iter"), trace.span("rollout"):
                pass
        with trace.span("eval.episode"), trace.span("env.step"):
            pass
    recs, _ = _profiled(two_iters)
    assert [(r["name"], r["root"]) for r in recs] == [
        ("train.iter", 0), ("rollout", 0), ("train.iter", 2), ("rollout", 2),
        ("eval.episode", 4), ("env.step", 4)]


def test_profile_trace_writes_the_spans_summary(tmp_path):
    with trace.profile_trace(str(tmp_path)):
        _nest()
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert spans["env.step"]["count"] == 1 and spans["env.reward"]["count"] == 1
    assert spans["env.step"]["self_ms"] < spans["env.step"]["total_ms"]
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert "env.reward" in {e.get("name") for e in events}
    trace.clear()


def _hideandseek(num_envs=8, steps=8, episode=6, device="cpu"):
    env = HideAndSeek(HideAndSeekCfg(num_envs=num_envs, max_episode_length=episode),
                      device=device)
    pol = MAPPOPolicy(MAPPOCfg(train_every=steps, num_minibatches=2, ppo_epochs=1,
                               use_tp_net=True),
                      n_agents=3, action_dim=4, obs_is_dict=True,
                      tp_input_dim=env.cfg.tp_input_dim, device=device)
    carry = init_carry(env, pol, torch.Generator(device=device).manual_seed(0))
    return env, pol, carry


def test_a_hideandseek_iteration_records_the_tree_of_its_configuration():
    """8 arenas x 8 steps, 2 minibatches, the TP net, 6-step episodes (one
    reset in the rollout)."""
    env, pol, carry = _hideandseek()
    train_iter = make_train_iter(env, pol)
    recs, _ = _profiled(lambda: train_iter(carry))
    where = collections.Counter("/".join(r["path"] + (r["name"],)) for r in recs)
    steps = 8
    step, update = "train.iter/rollout/env.step", "train.iter/update"
    want = {"train.iter": 1, "train.iter/rollout": 1, update: 1,
            "train.iter/rollout/policy.act": steps, step: steps,
            # the graphed sites run eagerly on the CPU: act, the step's two
            # segments and the two PPO minibatches
            "train.iter/rollout/policy.act/graph.eager": steps, f"{step}/graph.eager": 2 * steps,
            f"{step}/sync.any_across": steps, f"{step}/env.reset": 1,
            f"{update}/update.prep": 1, f"{update}/update.tp": 1, f"{update}/update.ppo": 1,
            f"{update}/update.ppo/graph.eager": 2,
            # copies from the host: each waits for a card (none left in a step,
            # none in an Adam step: its betas are device constants)
            f"{step}/env.reset/sync.outside_circle": 9, f"{step}/env.reset/sync.uniform_bounds": 10}
    want.update({f"{step}/graph.eager/{p}": steps for p in ENV_PARTS})
    assert dict(where) == want
    assert all(r["root"] == 0 and r["host_ms"] is not None for r in recs)
    # the counts count what ran, with or without a profiler
    before = trace.counts().copy()
    train_iter(carry)
    after = trace.counts()
    assert after["env.step"] - before["env.step"] == steps
    assert after["sync.any_across"] - before["sync.any_across"] == steps
    assert after["update.tp"] - before["update.tp"] == 1
    # the CPU runs the plain versions: no kernel launches
    assert all(after[k] == before[k] for k in after if k.startswith("kernel."))


def test_hover_and_the_evaluation_record_their_spans():
    env, pol, _, _ = harness.build("Hover", {"num_envs": 4, "max_episode_length": 5},
                                   {"train_every": 6, "num_minibatches": 2}, device="cpu")
    carry = init_carry(env, pol, torch.Generator().manual_seed(1))
    recs, _ = _profiled(lambda: make_train_iter(env, pol)(carry))
    names = collections.Counter(r["name"] for r in recs)
    assert names["env.step"] == 6 and names["sync.any_across"] == 6 and names["env.reset"] == 1
    assert not any(n in names for n in ENV_PARTS)
    state = env.reset(torch.Generator().manual_seed(2))
    obs = env.observe(state)
    recs, _ = _profiled(lambda: harness._greedy_episode(
        env, pol, carry.ts, state, obs, torch.Generator().manual_seed(3)))
    paths = collections.Counter("/".join(r["path"] + (r["name"],)) for r in recs)
    assert paths["eval.episode"] == 1 and paths["eval.episode/policy.act"] == 5
    assert paths["eval.episode/env.step/env.reset"] == 1
    assert all(r["root"] == 0 for r in recs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


def _synced(train_iter, carry):
    """One iteration under `torch.cuda.set_sync_debug_mode("warn")`: (the
    carry, the synchronisations it reports, the `sync.*` spans entered)."""
    before = trace.counts().copy()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            carry, *_ = train_iter(carry)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # one warning a synchronisation ("... called a synchronizing CUDA
    # operation"), besides a notice that the mode is a prototype
    syncs = [w for w in caught if "synchronizing" in str(w.message)
             and "prototype" not in str(w.message)]
    spans = {k: v - before[k] for k, v in trace.counts().items()
             if k.startswith("sync.") and v > before[k]}
    return carry, syncs, spans


@pytest.mark.gpu
@pytest.mark.parametrize("task", ["HideAndSeek", "HideAndSeek_envgen"])
def test_every_host_sync_of_an_iteration_is_a_sync_span(cuda, task):
    """Two iterations at 1,024 arenas x 16 steps with 8-step episodes (two
    resets each; the AEG closes a cycle): in each the `sync.*` spans count
    exactly the synchronisations `torch.cuda.set_sync_debug_mode("warn")`
    reports.  The first captures the rollout's graphs (a twin's iteration
    before it built the kernels and cached constants); the step's host
    copies (`quat_axis`) and boolean mask (`offdiag`) are gone, the reset
    gate is its one sync outside a reset."""
    env_kw = {"num_envs": 1024, "max_episode_length": 8}
    if task == "HideAndSeek_envgen":
        env_kw.update(buffer_length=256, use_init_easy_cases=True, r_min=0.0)

    def build():
        env, pol, _, _ = harness.build(task, env_kw, {"train_every": 16}, device=cuda)
        carry = init_carry(env, pol, torch.Generator(device=cuda).manual_seed(0))
        return make_train_iter(env, pol), carry

    twin_iter, twin = build()
    twin_iter(twin)
    train_iter, carry = build()
    for first in (True, False):
        before = trace.counts().copy()
        carry, syncs, spans = _synced(train_iter, carry)
        sites = collections.Counter(f"{w.filename}:{w.lineno}" for w in syncs)
        assert (trace.counts()["graph.capture"] > before["graph.capture"]) == first
        assert spans.get("sync.any_across", 0) >= 16
        assert not {"sync.quat_axis", "sync.offdiag_mask"} & set(spans)
        assert sum(spans.values()) == len(syncs), (spans, sites)
