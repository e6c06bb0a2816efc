"""The port's training entry point (`mupe_tpu_torch.harness.train`) on the
CPU with the AEG task: logs and checkpoints, exact resume, warm start, a
checkpoint of the wrong kind refused, the deploy-stage ramp and the
configurations refused where the JAX package fails; and the config helpers
against the JAX package's.  (`video` is tests/test_torch_video.py's.)

Exact resume: 2 iterations, save, load the full carry, 1 more iteration,
against 3 straight iterations; parameters, Adam states, the value
normaliser, the AEG buffer and the generator's state must be bit-identical
(as tests/test_checkpoint_resume.py checks for JAX).  The AEG cycle (3
episodes of 8 steps, one an iteration) closes in the third iteration, on
the FPS path (the buffer starts full from the easy cases, r_min = 0).
"""
import csv
import dataclasses
import json
import math

import pytest
import torch

from mupe_tpu_torch.harness import build, train
from mupe_tpu_torch.learning import init_carry
from mupe_tpu_torch.utils.checkpoint import load_checkpoint, to_plain
from mupe_tpu_torch.utils.config import RunCfg, apply_overrides, parse_cli

TINY = ["env.num_envs=8", "env.max_episode_length=8", "env.buffer_length=16",
        "env.use_init_easy_cases=true", "env.r_min=0.0", "algo.train_every=8",
        "algo.num_minibatches=2", "algo.ppo_epochs=1", "log_interval=1"]


def _run(tmp_path, name, *extra, **kw):
    return train(TINY + [f"run_dir={tmp_path}", f"run_name={name}", *extra],
                 default_task="HideAndSeek_envgen", device="cpu", **kw)


def _assert_equal_trees(a, b, path=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_equal_trees(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_equal_trees(u, v, f"{path}[{i}]")
    else:
        assert a == b, path


def test_train_writes_a_log_and_checkpoints(tmp_path):
    m = _run(tmp_path, "a", "max_iters=2", "save_interval=1")
    run = tmp_path / "a"
    with open(run / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [float(r["env_frames"]) for r in rows] == [64.0, 128.0]
    for key in ("policy_loss", "TP_loss", "rollout_fps", "rollout_fps_med", "rollout_fps_avg",
                "stats/history_buffer", "stats/success", "stats/episode_count"):
        assert key in rows[-1] and key in m
    assert m["env_frames"] == 128 and m["total_time_s"] > 0
    ckpt = run / "checkpoints"
    assert {p.name for p in ckpt.glob("step_*")} == {"step_1", "step_2"}
    assert {p.name for p in (ckpt / "full").glob("step_*")} == {"step_1", "step_2"}
    full = load_checkpoint(ckpt / "full")
    assert set(full) == {"ts", "env_state", "obs", "state", "generator"}
    assert set(full["env_state"]["gen"]) >= {"history", "history_len", "eval_tasks"}
    assert (run / "config.json").exists()


def test_resume_continues_bit_identically(tmp_path):
    _run(tmp_path, "straight", "max_iters=3")
    _run(tmp_path, "first", "max_iters=2")
    _run(tmp_path, "resumed", "max_iters=1", f"resume_dir={tmp_path}/first/checkpoints/full")
    want = load_checkpoint(tmp_path / "straight" / "checkpoints" / "full" / "step_3")
    got = load_checkpoint(tmp_path / "resumed" / "checkpoints" / "full" / "step_1")
    assert int(want["env_state"]["gen"]["history_len"]) == 16   # the cycle closed (FPS)
    assert int(want["ts"]["actor_opt"]["count"]) == 3 * 2
    _assert_equal_trees(got, want)


def test_model_dir_warm_starts_the_learner(tmp_path):
    _run(tmp_path, "w", "max_iters=1")
    saved = load_checkpoint(tmp_path / "w" / "checkpoints")
    sections, _ = parse_cli(TINY)
    env, policy, _, _ = build("HideAndSeek_envgen", sections["env"], sections["algo"],
                              device="cpu")
    carry = init_carry(env, policy, torch.Generator().manual_seed(5))
    ts = load_checkpoint(tmp_path / "w" / "checkpoints", target=carry.ts)
    _assert_equal_trees(to_plain(ts), saved)


@pytest.mark.parametrize("option,other", [("resume_dir", "checkpoints"),
                                          ("model_dir", "checkpoints/full")])
def test_a_checkpoint_of_the_other_kind_is_refused(tmp_path, option, other):
    """The learner state given as `resume_dir`, or the full carry as
    `model_dir`, would otherwise start from fresh weights unnoticed."""
    _run(tmp_path, "w", "max_iters=1")
    with pytest.raises(ValueError, match="lacks"):
        _run(tmp_path, "r", "max_iters=1", f"{option}={tmp_path}/w/{other}")


def test_deploy_stage_ramps_update_epoch(tmp_path):
    _run(tmp_path, "d", "max_iters=2", deploy_stage=True)
    full = load_checkpoint(tmp_path / "d" / "checkpoints" / "full")
    assert float(full["env_state"]["update_epoch"]) == 1.0


@pytest.fixture(scope="module")
def default_keys(tmp_path_factory):
    """The metric keys of one iteration of the default update."""
    return set(_run(tmp_path_factory.mktemp("default"), "d", "max_iters=1"))


@pytest.mark.parametrize("mode", ["fwdloss", "agrad"])
def test_train_runs_the_inkernel_loss_update(tmp_path, default_keys, mode):
    """`algo.use_inkernel_loss` / `algo.direct_mode` reach the update from the
    entry point: one iteration with the default path's metrics, all finite."""
    m = _run(tmp_path, mode, "max_iters=1", "algo.use_inkernel_loss=true",
             f"algo.direct_mode={mode}")
    assert set(m) == default_keys
    assert all(math.isfinite(v) for v in m.values())
    with open(tmp_path / mode / "config.json") as f:
        algo = json.load(f)["MAPPOCfg"]
    assert algo["use_inkernel_loss"] is True and algo["direct_mode"] == mode


# configurations the JAX package cannot train either: ppo_adapt on
# HideAndSeek (no intrinsics: JAX's init_carry fails with KeyError), and
# MAPPO's default networks on Hover's depth dict (JAX's MAPPO fails on it)
REFUSED = {"algo=ppo_adapt": ((), ("algo=ppo_adapt",), KeyError, "intrinsics"),
           "task=Hover": (("task=Hover", "env.obs_depth=true"), (), ValueError, "ppo_vision")}


@pytest.mark.parametrize("arg", list(REFUSED))
def test_configurations_jax_cannot_train_are_refused(tmp_path, arg):
    task, rest, exc, match = REFUSED[arg]
    with pytest.raises(exc, match=match):
        if task:
            train([*task, "env.num_envs=4", "max_iters=1", f"run_dir={tmp_path}"], device="cpu")
        else:
            _run(tmp_path, "x", "max_iters=1", *rest)


def test_config_helpers_match_jax():
    from mupe_tpu.utils import config as jconfig

    argv = ["task=HideAndSeek_envgen", "max_iters=3", "env.num_envs=16", "algo.clip_param=0.2",
            "env.eval_mix_scenarios=null", "wandb_entity=none"]
    assert parse_cli(argv) == jconfig.parse_cli(argv)
    _, top = parse_cli(argv)
    assert dataclasses.asdict(apply_overrides(RunCfg(), top)) == dataclasses.asdict(
        jconfig.apply_overrides(jconfig.RunCfg(), top))
    assert ({f.name: f.default for f in dataclasses.fields(RunCfg)}
            == {f.name: f.default for f in dataclasses.fields(jconfig.RunCfg)})
