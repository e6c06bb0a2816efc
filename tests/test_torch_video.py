"""Evaluation videos in the port (`video=` of `evaluate` and `train`) on
the CPU, against the JAX package's.

* The frame dict: the wall scenario in eval mode (8 arenas, a 16-step
  greedy episode) from the same parameters on both sides, as
  tests/test_torch_evaluate.py runs it; JAX's `episode_video` is replaced
  by a recorder, so its host frames [T, E, ...] are captured without
  matplotlib.  The port keeps one arena, [T, 1, ...]: at arena 0 and at
  the last, every key of JAX's frames at that index must be there with its
  shape; the pursuers' positions within that file's STATE_ATOL (measured:
  6.1e-4), the cylinders and `capture` equal, the evader's x and z within
  STATE_ATOL (measured: equal).  The scene is mirror-symmetric about y = 0,
  where the evader starts: the y component of its potential-field force
  is rounding noise there, and its componentwise-normalised velocity turns
  that noise's sign into a full step of v dt = 0.013 m, so both evaders
  zig-zag about y = 0 out of phase; their y is held within two such steps
  (measured: 1.97e-2).  The TP net's prediction reads that history, so it
  is held within STATE_ATOL at the first step (measured 2.7e-4) and the
  last (after the reset that ends the episode; measured 1.5e-8), finite
  between.
* `evaluate` with `video`: the GIF holds ceil(T / 2) frames, equal to
  `render_trajectory` of the collected arrays, `video: <path>` is printed
  before the stats, and the stats equal the run without a video.  A task
  without render info prints that it skipped (FakeHideAndSeek: Hover's
  `evaluate` is refused earlier, by `use_eval`, in both packages).
* `train` with `eval_interval` and `video`: eval_<i>.gif each evaluation,
  the learner bit-identical to the run without; nothing without
  `eval_interval`; Hover fails with KeyError 'target_pos' at its first
  evaluation, as JAX's `episode_video` does.  A recurrent policy's
  evaluation writes its GIF: no registered task has both (ppo_rnn takes
  flat observations, which only Hover has, and Hover has no render info),
  so `_make_eval_prog` runs ppo_rnn on a Hover that reports its target.
* Two gloo ranks (tests/torch_dist_worker.py's `video` job) with the
  arena on rank 1's half: rank 0 writes the GIFs, rank 1 none, and the
  frames equal the one-rank run's.  Training runs at learning rate 0 so
  that both evaluate the same learner (two ranks' learners part from one
  rank's by ~lr a step, tests/test_torch_parallel_train.py).
* Importing the renderer, the harness and the demo loads neither
  matplotlib, PIL, jax nor the JAX package.
"""
import functools
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_worker as w
from mupe_tpu import harness as jharness
from mupe_tpu.utils import render as jrender
from mupe_tpu_torch import harness
from mupe_tpu_torch.envs import HideAndSeekCfg, Hover
from mupe_tpu_torch.learning.rollout import init_rnn_carry
from mupe_tpu_torch.utils import render
from mupe_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_evaluate import E, EVAL_ARGV, STATE_ATOL, T, evaluate_both
from test_torch_harness import _assert_equal_trees, _run
from test_torch_render import decode_gif

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
TIMING = {"rollout_fps", "rollout_fps_med", "rollout_fps_avg", "total_time_s"}


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """JAX's recorded host frames; the port's collected frames and results
    at arena 0 and at the last, and its result without a video."""
    tmp = tmp_path_factory.mktemp("video")
    seen = {"jax": [], "port": []}
    real = harness.episode_video

    def port_recorder(info, cfg, path, *a, **k):
        seen["port"].append(info)
        return real(info, cfg, path, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrender, "episode_video", lambda info, *a, **k: seen["jax"].append(info))
        mp.setattr(harness, "episode_video", port_recorder)
        _, got0 = evaluate_both(tmp / "ckpt", [f"video={tmp}/first.gif", "video_env_index=0"])
        got_last = harness.evaluate(EVAL_ARGV + [f"model_dir={tmp}/ckpt", f"video={tmp}/last.gif",
                                                 f"video_env_index={E - 1}"], device="cpu")
    plain = harness.evaluate(EVAL_ARGV + [f"model_dir={tmp}/ckpt"], device="cpu")
    (jframes,) = seen["jax"]
    return dict(tmp=tmp, jax=jframes, port=dict(zip((0, E - 1), seen["port"])),
                results=(got0, got_last), plain=plain)


@pytest.mark.parametrize("idx", [0, E - 1])
def test_frame_dict_matches_jax(videos, idx):
    want, got = videos["jax"], videos["port"][idx]
    assert set(got) == set(want) == {"drone_pos", *harness.RENDER_KEYS}
    want = {k: np.asarray(v)[:, idx:idx + 1] for k, v in want.items()}
    for k in want:
        assert got[k].shape == want[k].shape == (T, 1) + want[k].shape[2:], k
    for k in ("cylinders", "capture"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    close = functools.partial(np.testing.assert_allclose, rtol=0, atol=STATE_ATOL)
    close(got["drone_pos"], want["drone_pos"])
    close(got["target_pos"][..., [0, 2]], want["target_pos"][..., [0, 2]])
    step = HideAndSeekCfg().v_prey * HideAndSeekCfg().v_drone * HideAndSeekCfg().dt
    close(got["target_pos"][..., 1], want["target_pos"][..., 1], atol=2 * step)
    close(got["tp_pred"][[0, -1]], want["tp_pred"][[0, -1]])
    assert np.isfinite(got["tp_pred"]).all()
    assert np.abs(np.diff(got["drone_pos"], axis=0)).max() > 1e-4  # the drones move


def test_evaluate_video_keeps_the_stats_and_holds_the_frames(videos):
    for result in videos["results"]:
        assert result == videos["plain"]
    for idx, name in ((0, "first"), (E - 1, "last")):
        gif = decode_gif((videos["tmp"] / f"{name}.gif").read_bytes())
        info = videos["port"][idx]
        want = render.render_trajectory(info["drone_pos"][:, 0], info["target_pos"][:, 0, 0],
                                        info["cylinders"][:, 0],
                                        captured=info["capture"][:, 0, 0],
                                        predicted=info["tp_pred"][:, 0])
        assert len(gif["frames"]) == len(want) == math.ceil(T / 2)
        assert all(np.array_equal(a, b) for a, b in zip(gif["frames"], want))


def test_evaluate_prints_the_video_line_first(tmp_path, capsys):
    argv = EVAL_ARGV + ["env.num_envs=2", "env.max_episode_length=4"]
    harness.evaluate(argv, device="cpu")
    plain = capsys.readouterr().out.splitlines()
    harness.evaluate(argv + [f"video={tmp_path}/v.gif"], device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"video: {tmp_path}/v.gif"] + plain
    assert len(decode_gif((tmp_path / "v.gif").read_bytes())["frames"]) == 2


def test_evaluate_without_render_info_skips(tmp_path, capsys):
    harness.evaluate(["task=FakeHideAndSeek", "env.num_envs=2", "env.max_episode_length=4",
                      f"video={tmp_path}/f.gif"], device="cpu")
    assert "video: task provides no render info; skipped" in capsys.readouterr().out
    assert not (tmp_path / "f.gif").exists()
    for fn in (jharness.evaluate, lambda a: harness.evaluate(a, device="cpu")):
        with pytest.raises(KeyError, match="use_eval"):  # Hover: refused before the episode
            fn(["task=Hover", "env.num_envs=2", f"video={tmp_path}/h.gif"])


def test_video_index_past_the_arenas_raises(tmp_path):
    with pytest.raises(IndexError):
        harness.evaluate(EVAL_ARGV + [f"video={tmp_path}/x.gif", f"video_env_index={E}"],
                         device="cpu")
    with pytest.raises(IndexError):
        _run(tmp_path, "x", "max_iters=1", "eval_interval=1", "video=1", "video_env_index=8")


# ------------------------------------------------------------------ train
def test_train_writes_eval_gifs_and_trains_as_without(tmp_path):
    plain = _run(tmp_path, "plain", "max_iters=2", "eval_interval=1", "save_interval=-1")
    vid = _run(tmp_path, "vid", "max_iters=2", "eval_interval=1", "save_interval=-1", "video=1",
               "video_env_index=5")
    for k in set(plain) - TIMING:
        assert plain[k] == vid[k] or (math.isnan(plain[k]) and math.isnan(vid[k])), k
    _assert_equal_trees(load_checkpoint(tmp_path / "vid" / "checkpoints" / "full"),
                        load_checkpoint(tmp_path / "plain" / "checkpoints" / "full"))
    assert sorted(p.name for p in (tmp_path / "vid").glob("*.gif")) == ["eval_1.gif", "eval_2.gif"]
    for name in ("eval_1.gif", "eval_2.gif"):
        gif = decode_gif((tmp_path / "vid" / name).read_bytes())
        assert len(gif["frames"]) == 4  # 8-step episodes, every 2nd step
    assert not list((tmp_path / "plain").glob("*.gif"))


def test_train_without_eval_interval_writes_no_video(tmp_path):
    _run(tmp_path, "v", "max_iters=2", "video=1")
    assert not list((tmp_path / "v").glob("*.gif"))


def test_hover_train_fails_at_its_first_evaluation(tmp_path):
    argv = ["task=Hover", "env.num_envs=4", "env.max_episode_length=8", "algo.train_every=8",
            "max_iters=2", "eval_interval=1", "log_interval=1", "video=1",
            f"run_dir={tmp_path}", "run_name=h"]
    with pytest.raises(KeyError, match="target_pos"):
        harness.train(argv, device="cpu")
    with open(tmp_path / "h" / "metrics.csv") as f:
        assert len(f.read().strip().splitlines()) == 2  # the header and iteration 1


class TargetHover(Hover):
    """Hover whose steps report its target as the evader, no cylinders and
    no capture (the render info HideAndSeek's steps give)."""

    def step(self, state, action, gen=None):
        state, tr = super().step(state, action, gen)
        e = self.cfg.num_envs
        tr.info.update(target_pos=state.target_pos, cylinders=torch.zeros((e, 0, 3)),
                       capture=torch.zeros((e, 1)))
        return state, tr


def test_recurrent_evaluation_writes_its_gif(tmp_path, monkeypatch):
    env = TargetHover(Hover.cfg_cls(num_envs=4, max_episode_length=8), device="cpu")
    policy = harness.make_policy("ppo_rnn", env, {"train_every": 8}, "cpu")
    carry = init_rnn_carry(env, policy, torch.Generator().manual_seed(0))
    seen, real = [], harness.episode_video
    # Hover's cfg has no arena geometry: draw it in HideAndSeek's
    monkeypatch.setattr(harness, "episode_video", lambda info, cfg, path, *a, **k: (
        seen.append(info), real(info, HideAndSeekCfg(), path, *a, **k))[1])
    prog = harness._make_eval_prog(env, policy, 0, recurrent=True, video_dir=tmp_path,
                                   video_index=3)
    stats = prog(carry.ts, 4)
    assert float(stats["episode_count"]) == 4.0
    (info,) = seen
    assert info["drone_pos"].shape == (8, 1, 1, 3) and np.isfinite(info["drone_pos"]).all()
    gif = decode_gif((tmp_path / "eval_5.gif").read_bytes())
    assert len(gif["frames"]) == 4


def test_two_ranks_write_the_video_on_rank_0(tmp_path):
    """Arena 6 of 8 lies on rank 1 (arenas 4-7)."""
    inp = {"video/index": np.asarray(6),
           "video/extra": np.asarray(["algo.actor_lr=0", "algo.critic_lr=0", "algo.tp_lr=0"])}
    ranks = w.launch(2, ["video"], {**inp, "video/run_dir": np.asarray(str(tmp_path / "two"))},
                     tmp_path / "ranks")
    one = w.run_jobs(["video"], {**inp, "video/run_dir": np.asarray(str(tmp_path / "one"))})
    assert [len(r["video"]["written"]) for r in ranks] == [2, 0]
    assert len(one["video"]["written"]) == 2
    for name in ("eval_1.gif", "eval_2.gif"):
        a = decode_gif((tmp_path / "two" / "video" / name).read_bytes())["frames"]
        b = decode_gif((tmp_path / "one" / "video" / name).read_bytes())["frames"]
        assert len(a) == len(b) == 4
        assert all(np.array_equal(x, y) for x, y in zip(a, b)), name


def test_port_modules_import_no_plotting_library_or_jax():
    code = ("import sys\n"
            "import mupe_tpu_torch.utils.render, mupe_tpu_torch.harness\n"
            "import mupe_tpu_torch.examples.demo_hideandseek_rollout\n"
            "bad = {'matplotlib', 'PIL', 'jax', 'flax', 'mupe_tpu'} & "
            "{m.split('.')[0] for m in sys.modules}\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(REPO), timeout=300)
