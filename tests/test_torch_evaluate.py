"""Evaluation and the rest of the harness in the PyTorch port: `evaluate`
against the JAX package's, in-training evaluation, the NaN guard, the
profiler hook and the two entry modules, all on the CPU.

`evaluate` parity: the wall scenario in eval mode (8 envs, a 16-step greedy
episode) draws nothing, so both packages run the same episode from the
same parameters: the JAX package's `evaluate` with its `init_carry` handing
it these parameters (and the first observation taken with them, as the
port's `evaluate` takes it after a warm start), the port's from a
checkpoint of the bridged parameters.  The JAX env predicts the evader
through `tp_apply_t` and the JAX policy acts through the pair kernel's math
(`use_fused_act`), as in tests/test_torch_rollout.py, whose tolerances hold
here: the episode's stats are means over a free-running episode, the
reward terms within atol 1e-3 (measured on this CPU: `return` 2.2e-4,
`distance_reward` 1.4e-5, the others 0), the rest within 1e-2, as the
observations (measured: `smoothness_mean` 7.3e-3, `action_error_order1_mean`
6.0e-3, the TP-derived `target_predicted_error` 2.3e-3 and
`distance_predicted_reward` 1.7e-3, `smoothness_max` 3.6e-4); the 0/1
stats, the counts, the capture steps and their percentiles must be equal.

In-training evaluation must leave training bit-identical: its episode
runs on a generator of its own.  The guard must put back an iteration
that updated the learner in place, generator included, bit for bit.
"""
import csv
import functools
import inspect
import json
import math
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from mupe_tpu import harness as jharness
from mupe_tpu.envs.hideandseek import HideAndSeekCfg as JEnvCfg
from mupe_tpu.learning.rollout import init_carry as jinit_carry
from mupe_tpu_torch import bridge, harness
from mupe_tpu_torch.harness import build, evaluate, train
from mupe_tpu_torch.learning import MAPPOCfg, MAPPOPolicy, init_carry, make_train_iter
from mupe_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint, to_plain
from mupe_tpu_torch.utils.config import parse_cli
from mupe_tpu_torch.utils.debug import check_finite, guard_train_iter
from test_torch_harness import TINY, _assert_equal_trees, _run
from test_torch_hideandseek import KernelTPEnv, to_np

torch.set_num_threads(1)
E, T = 8, 16
EVAL_ARGV = [f"env.num_envs={E}", f"env.max_episode_length={T}",
             "env.use_random_cylinder=false", "env.scenario_flag=wall", "seed=0"]
BINARY = ("success", "out_of_arena", "scene_fallback", "scene_degraded", "first_capture_step",
          "first_capture_step_p25", "first_capture_step_p50", "first_capture_step_p75",
          "episodes", "smoothness_coef", "sum_detect_step")
REWARD_ATOL = 1e-3
STATE_ATOL = 1e-2
REWARDS = ("return", "distance_reward", "catch_reward",
           "collision_reward", "speed_reward", "detect_reward", "smoothness_reward")


def _trees_equal(a, b) -> bool:
    try:
        _assert_equal_trees(a, b)
    except AssertionError:
        return False
    return True


def evaluate_both(ckpt, extra=()):
    """(JAX result, port result) of one evaluation from the same
    parameters (the port's from a checkpoint written to `ckpt`), with the
    arguments `extra` on both sides."""
    jcfg = JEnvCfg(num_envs=E, max_episode_length=T, use_random_cylinder=False, use_eval=True)
    jenv = KernelTPEnv(jcfg)
    jpol = jharness.make_policy("mappo", jenv, {"use_fused_act": True})
    jcarry = jinit_carry(jenv, jpol, jax.random.PRNGKey(0))
    # heads at unit gain (initialised at 0.01) so actions move the drones
    actor, critic = jcarry.ts.actor_params, jcarry.ts.critic_params
    head = actor["params"]["DiagGaussianHead_0"]
    head["Dense_0"]["kernel"] = head["Dense_0"]["kernel"] * 100.0
    critic["params"]["Dense_0"]["kernel"] = critic["params"]["Dense_0"]["kernel"] * 100.0
    tp = jcarry.ts.tp_params

    def given_params(env, policy, key, mesh=None):
        c = jinit_carry(env, policy, key)
        obs, state = env.observe_full(c.env_state, tp)
        return c.replace(ts=c.ts.replace(actor_params=actor, critic_params=critic, tp_params=tp),
                         obs=obs, state=state)

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jharness.TASK_CFGS, "HideAndSeek", (KernelTPEnv, JEnvCfg))
        mp.setattr(jharness, "init_carry", given_params)
        want = jharness.evaluate(EVAL_ARGV + ["algo.use_fused_act=true", *extra])

    tpol = MAPPOPolicy(MAPPOCfg(use_tp_net=True), n_agents=3, action_dim=4, obs_is_dict=True,
                       tp_input_dim=16, device="cpu")
    ts = bridge.policy_state(tpol, bridge.tensors(to_np(jcarry.obs)), jax.device_get(actor),
                             jax.device_get(critic), jax.device_get(tp))
    save_checkpoint(ckpt, 0, ts)
    got = evaluate(EVAL_ARGV + [f"model_dir={ckpt}", *extra], device="cpu")
    return want, got


@pytest.fixture(scope="module")
def eval_pair(tmp_path_factory):
    """(JAX result, port result) of one evaluation from the same parameters."""
    return evaluate_both(tmp_path_factory.mktemp("eval") / "checkpoints")


def test_evaluate_matches_jax(eval_pair):
    want, got = eval_pair
    assert set(got) == set(want)
    assert got["episodes"] == want["episodes"] == E
    for k in BINARY:
        assert got[k] == want[k], k
    for k in REWARDS:
        assert math.isclose(got[k], want[k], rel_tol=0, abs_tol=REWARD_ATOL), k
    for k in set(got) - set(BINARY) - set(REWARDS):
        assert math.isclose(got[k], want[k], rel_tol=0, abs_tol=STATE_ATOL), k
    assert want["return"] != 0.0 and want["smoothness_mean"] > 0.0


def test_evaluate_prints_the_jax_lines(eval_pair, capsys):
    """One `key: value` line per result, sorted, values to 4 decimals."""
    _, got = eval_pair
    jharness_lines = [f"{k}: {got[k]:.4f}" for k in sorted(got)]
    evaluate(EVAL_ARGV + ["env.num_envs=2", "env.max_episode_length=2"], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [ln.split(":")[0] for ln in jharness_lines]
    assert "episodes: 2.0000" in lines


def test_evaluate_video_raises_and_entry_points_default_to_the_card(tmp_path, capsys):
    """`video` writes the GIF (it raised NotImplementedError before the
    renderer was ported; tests/test_torch_video.py holds the rest)."""
    evaluate(EVAL_ARGV + [f"video={tmp_path}/ev.gif"], device="cpu")
    assert f"video: {tmp_path}/ev.gif" in capsys.readouterr().out
    assert (tmp_path / "ev.gif").read_bytes()[:6] == b"GIF89a"
    for fn in (evaluate, train, build):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


# ------------------------------------------------------------------ in-training evaluation
def test_in_training_eval_rows_leave_training_bit_identical(tmp_path):
    plain = _run(tmp_path, "plain", "max_iters=3", "save_interval=-1")
    ev = _run(tmp_path, "ev", "max_iters=3", "save_interval=-1", "eval_interval=1")
    with open(tmp_path / "ev" / "metrics.csv") as f:
        rows = [r for r in csv.DictReader(f) if r.get("eval/episode_count")]
    assert len(rows) == 3
    for r in rows:
        assert float(r["eval/episode_count"]) == 8.0  # one 8-step episode per env
        assert all(math.isfinite(float(r[k])) for k in r if k.startswith("eval/"))
    assert {"eval/success", "eval/return", "eval/history_buffer"} <= set(ev)
    timing = {"rollout_fps", "rollout_fps_med", "rollout_fps_avg", "total_time_s"}
    for k in set(plain) - timing:
        assert plain[k] == ev[k] or (math.isnan(plain[k]) and math.isnan(ev[k])), k
    _assert_equal_trees(load_checkpoint(tmp_path / "ev" / "checkpoints" / "full"),
                        load_checkpoint(tmp_path / "plain" / "checkpoints" / "full"))


def test_eval_prog_draws_from_its_own_generator():
    sections, _ = parse_cli(TINY)
    env, policy, _, _ = build("HideAndSeek_envgen", sections["env"], sections["algo"],
                              device="cpu")
    carry = init_carry(env, policy, torch.Generator().manual_seed(1))
    prog = harness._make_eval_prog(env, policy, seed=0)
    before = carry.generator.get_state()
    a, b, c = prog(carry.ts, 0), prog(carry.ts, 0), prog(carry.ts, 1)
    assert torch.equal(carry.generator.get_state(), before)
    assert all(torch.equal(a[k], b[k]) for k in a)          # seeded by (seed, iteration)
    assert any(not torch.equal(a[k], c[k]) for k in a)      # another iteration, another scene


def test_profile_dir_writes_a_trace(tmp_path):
    _run(tmp_path, "p", "max_iters=2", f"profile_dir={tmp_path}/prof")
    with open(tmp_path / "prof" / "trace.json") as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    # the program's ranges, and every span's summary (iteration 1 alone here)
    assert {"env.reward", "sync.any_across", "update.prep"} <= names
    spans = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert spans["train.iter"]["count"] == 1 and spans["update.ppo"]["count"] == 1


# ------------------------------------------------------------------ the NaN guard
def test_guard_train_iter_nan_recovery():
    """The counterpart of tests/test_harness_features.py's."""
    calls = {"n": 0}

    def bad_iter(carry):
        calls["n"] += 1
        if calls["n"] == 2:
            return carry + 1.0, {"policy_loss": torch.tensor(float("nan"))}, {}
        return carry + 1.0, {"policy_loss": torch.tensor(0.5)}, {}

    guarded = guard_train_iter(bad_iter)
    carry, m, s = guarded(torch.tensor(0.0))
    assert float(carry) == 1.0 and "nan_skipped" not in s
    carry, m, s = guarded(carry)  # NaN → the carry must not advance
    assert float(carry) == 1.0 and float(s["nan_skipped"]) == 1.0
    carry, m, s = guarded(carry)
    assert float(carry) == 2.0


def test_guard_restores_an_in_place_iteration_bit_for_bit():
    """The port's iteration updates the learner in place, so handing back
    the old carry object would skip nothing: the guard restores it."""
    sections, _ = parse_cli(TINY)
    env, policy, _, _ = build("HideAndSeek_envgen", sections["env"], sections["algo"],
                              device="cpu")

    def fresh():
        return init_carry(env, policy, torch.Generator().manual_seed(3))

    real = make_train_iter(env, policy)

    def poisoned(c, *a, **k):
        c, m, s = real(c, *a, **k)
        return c, {**m, "policy_loss": torch.tensor(float("nan"))}, s

    # the trap: an iteration writes into the carry's own tensors
    probe = fresh()
    ts_obj, ts_before = probe.ts, to_plain(probe.ts)
    real(probe)
    assert not _trees_equal(to_plain(ts_obj), ts_before)

    carry = fresh()
    before = to_plain(carry)
    out, _, stats = guard_train_iter(poisoned)(carry)
    assert out is carry and float(stats["nan_skipped"]) == 1.0
    _assert_equal_trees(to_plain(carry), before)  # generator state included
    # the restored carry trains on exactly as a fresh one
    a, _, s_a = guard_train_iter(real)(carry)
    b, _, _ = real(fresh())
    assert "nan_skipped" not in s_a
    _assert_equal_trees(to_plain(a), to_plain(b))


def test_train_with_guard_nan(tmp_path):
    m = _run(tmp_path, "g", "max_iters=2", "guard_nan=true")
    assert math.isfinite(m["policy_loss"]) and "stats/nan_skipped" not in m


def test_check_finite_reports_each_leaf():
    tree = {"a": torch.ones(3), "b": [torch.tensor([1.0, float("inf")]), torch.arange(3)]}
    ok, report = check_finite(tree)
    assert not bool(ok) and set(report) == {"['a']", "['b'][0]"}
    assert bool(report["['a']"]) and not bool(report["['b'][0]"])
    assert bool(check_finite({"a": torch.ones(2)})[0])


# ------------------------------------------------------------------ entry modules
def test_eval_module_runs_tiny_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(harness, "evaluate", functools.partial(harness.evaluate, device="cpu"))
    monkeypatch.setattr(sys, "argv", ["eval", "env.num_envs=2", "env.max_episode_length=3"])
    runpy.run_module("mupe_tpu_torch.eval", run_name="__main__")
    out = capsys.readouterr().out
    assert "episodes: 2.0000" in out and "first_capture_step_p50: " in out


def test_train_deploy_module_runs_tiny_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(harness, "train", functools.partial(harness.train, device="cpu"))
    monkeypatch.setattr(sys, "argv", [
        "train_deploy", "env.num_envs=4", "env.max_episode_length=8", "algo.train_every=8",
        "algo.num_minibatches=2", "algo.ppo_epochs=1", "max_iters=2", "env.smooth_lr=0.5",
        f"run_dir={tmp_path}", "run_name=d"])
    runpy.run_module("mupe_tpu_torch.train_deploy", run_name="__main__")
    full = load_checkpoint(tmp_path / "d" / "checkpoints" / "full")
    assert float(full["env_state"]["update_epoch"]) == 1.0
    with open(tmp_path / "d" / "config.json") as f:
        assert json.load(f)["HideAndSeekCfg"]["use_deployment"] is True
