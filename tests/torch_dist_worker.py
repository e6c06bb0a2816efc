"""Jobs of the port's data-parallel tests, run at any world size.

    python tests/torch_dist_worker.py RANK WORLD INIT_METHOD IN.npz OUT_DIR

joins a gloo group of WORLD ranks through INIT_METHOD (a `file://` store;
"-" runs without a group), runs every job named in IN.npz's `jobs` on this
rank's share of the arenas and writes each job's arrays to
OUT_DIR/<job>_<RANK>.npz.  It imports the port only (no JAX).  The tests
call `launch` to run the ranks as subprocesses and `run_jobs` to run the
one-rank references in their own process.

Each job takes the flat arrays of IN.npz (`flatten` / `unflatten` of the
port's `to_plain` trees, keyed by path) and returns flat arrays:

* `update[:tag]`: `train_op` (or `_update_tp`) of a learner given as arrays on a
  global trajectory, this rank holding its arenas' rows; the gradients each
  optimizer step took are recorded;
* `iteration`: one HideAndSeek iteration with the TP net from a seed (a
  rollout with a reset in it, then `train_op`);
* `aeg`: the AEG env rolled out through a closed cycle from a seed;
* `trap`: one rank's arenas end an episode and the other's do not
  (HideAndSeek and Hover);
* `harness`: `harness.train` on Hover with the argv of the JAX package's
  two-process test, algo=ppo through it, and the configurations refused
  across ranks;
* `family:<case>`: one iteration of a PPO-family algorithm (`FAMILY`) from
  a seed through `harness.build` (a rollout with a reset in it, then
  `train_op`; ppo_rnn's chunk permutations injected from the input);
* `sdf`: ppo_sdf's `train_op` on a synthetic global trajectory with
  `sdf_points`, this rank holding its arenas' rows;
* `video`: `harness.train` on HideAndSeek with an evaluation video of
  arena `video/index` each iteration (run directory `video/run_dir`); the
  number of GIFs this rank wrote.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mupe_tpu_torch.learning.mappo as tmappo  # noqa: E402
import mupe_tpu_torch.learning.ppo.ppo_rnn as tppo_rnn  # noqa: E402
from mupe_tpu_torch.envs import (HideAndSeek, HideAndSeekCfg, HideAndSeekEnvgen,  # noqa: E402
                                 HideAndSeekEnvgenCfg, Hover, HoverCfg)
from mupe_tpu_torch.learning import MAPPOCfg, MAPPOPolicy, init_carry  # noqa: E402
from mupe_tpu_torch.learning.rollout import make_rollout  # noqa: E402
from mupe_tpu_torch.parallel import dist  # noqa: E402
from mupe_tpu_torch.utils.checkpoint import restore, to_plain  # noqa: E402

WORKER = Path(__file__).resolve()


# ------------------------------------------------------------- flat arrays
def flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Every tensor (or array) of a dict / list / dataclass / module tree,
    keyed `prefix/path`."""
    plain = to_plain(tree)

    def walk(x, path):
        if isinstance(x, torch.Tensor):
            out[path] = x.numpy()
        elif isinstance(x, np.ndarray):
            out[path] = x
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}/{k}")
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(v, f"{path}/{i}")

    walk(plain, prefix)
    return out


def unflatten(template: Any, arrays: Dict[str, np.ndarray], prefix: str) -> Any:
    """`template` (a port object) with every tensor leaf taken from
    `arrays` at its path (`flatten`'s keys)."""
    plain = to_plain(template)

    def walk(x, path):
        if isinstance(x, torch.Tensor):
            return torch.as_tensor(arrays[path]).clone()
        if isinstance(x, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(x)]
        return x

    return restore(template, walk(plain, prefix))


def sub(arrays: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    """The nested dict of tensors under `prefix` (`flatten`'s keys)."""
    out: Dict[str, Any] = {}
    for key, v in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.as_tensor(v)
    return out


def rows(tree: Any, shard: dist.EnvShard, axis: int) -> Any:
    """This rank's arenas of every tensor of a (nested) dict."""
    if isinstance(tree, dict):
        return {k: rows(v, shard, axis) for k, v in tree.items()}
    return shard.rows(tree, axis).contiguous()


@contextlib.contextmanager
def recorded_grads():
    """The gradients every optimizer step of `mupe_tpu_torch.learning.mappo`
    and of ppo_rnn is given, in call order."""
    seen: List[List[torch.Tensor]] = []
    real = tmappo.adam_updates

    def recording(grads, state, lr, **kw):
        seen.append([g.detach().clone() for g in grads])
        return real(grads, state, lr, **kw)

    tmappo.adam_updates = tppo_rnn.adam_updates = recording
    try:
        yield seen
    finally:
        tmappo.adam_updates = tppo_rnn.adam_updates = real


def _grads_out(seen, out):
    for i, gs in enumerate(seen):
        for j, g in enumerate(gs):
            out[f"grad/{i}/{j}"] = g.numpy()
    return out


def _metrics_out(metrics, prefix, out):
    for k, v in metrics.items():
        out[f"{prefix}/{k}"] = np.asarray(float(v), np.float64)
    return out


# ------------------------------------------------------------- jobs
def job_update(inp: Dict[str, np.ndarray], name: str, shard_of) -> Dict[str, np.ndarray]:
    """`train_op` (or `_update_tp`) on this rank's rows of a global
    trajectory from a learner given as arrays under `name/`."""
    spec = json.loads(str(inp[f"{name}/spec"]))
    policy = MAPPOPolicy(MAPPOCfg(**{k: tuple(v) if isinstance(v, list) else v
                                     for k, v in spec["cfg"].items()}),
                         device="cpu", **spec["policy"])
    traj = sub(inp, f"{name}/traj")
    e_total = traj["reward"].shape[1] if "reward" in traj else traj["tp_gt"].shape[1]
    shard = shard_of(e_total)
    last_obs = sub(inp, f"{name}/last_obs")
    last_obs = last_obs.get("x", last_obs)  # a flat observation is stored as x
    ts = unflatten(policy.init(last_obs, torch.Generator().manual_seed(0)), inp, f"{name}/ts")
    out: Dict[str, np.ndarray] = {}
    local = rows(traj, shard, 1)
    with recorded_grads() as seen:
        if spec["op"] == "update_tp":
            metrics = policy._update_tp(ts, local)
        else:
            perms = torch.as_tensor(inp[f"{name}/perms"])
            ts, metrics = policy.train_op(ts, local, rows(last_obs, shard, 0), perms=perms,
                                          shard=shard)
    flatten(ts, "ts", out)
    _metrics_out(metrics, "metrics", out)
    return _grads_out(seen, out)


ITER_ENV = dict(num_envs=8, max_episode_length=6)
ITER_ALGO = dict(train_every=8, num_minibatches=2, ppo_epochs=1, use_tp_net=True)


def job_iteration(inp, name, shard_of) -> Dict[str, np.ndarray]:
    """One HideAndSeek iteration with the TP net from seed 3: a rollout of
    8 steps over 6-step episodes (one reset), then `train_op`."""
    env = HideAndSeek(HideAndSeekCfg(**ITER_ENV), device="cpu",
                      shard=shard_of(ITER_ENV["num_envs"]))
    policy = MAPPOPolicy(MAPPOCfg(**ITER_ALGO), n_agents=env.num_agents, action_dim=4,
                         obs_is_dict=True, tp_input_dim=env.cfg.tp_input_dim, device="cpu")
    carry = init_carry(env, policy, torch.Generator().manual_seed(3))
    carry, traj, ep_stats = make_rollout(env, policy)(carry)
    out = flatten(traj, "traj", {})
    flatten(carry.generator.get_state(), "gen_rollout", out)
    with recorded_grads() as seen:
        ts, metrics = policy.train_op(carry.ts, traj, carry.obs, carry.generator,
                                      shard=env.shard)
    flatten(ts, "ts", out)
    flatten(carry.generator.get_state(), "gen", out)
    _metrics_out(metrics, "metrics", out)
    _metrics_out(ep_stats, "ep_stats", out)
    return _grads_out(seen, out)


AEG_ENV = dict(num_envs=8, max_episode_length=4, buffer_length=12, use_init_easy_cases=True,
               r_min=0.0, use_tp_net=False)
AEG_STEPS = 13  # 3 episodes of 4 steps close a cycle at step 12


def job_aeg(inp, name, shard_of) -> Dict[str, np.ndarray]:
    """The AEG env acted on by a fresh MAPPO policy for 13 steps from seed
    5: a cycle of 3 episodes closes (on the FPS path: the buffer starts
    full of easy cases, r_min = 0) and a new task set is drawn."""
    from mupe_tpu_torch.ops import fps

    env = HideAndSeekEnvgen(HideAndSeekEnvgenCfg(**AEG_ENV), device="cpu",
                            shard=shard_of(AEG_ENV["num_envs"]))
    policy = MAPPOPolicy(MAPPOCfg(train_every=AEG_STEPS), n_agents=env.num_agents,
                         action_dim=4, obs_is_dict=True, device="cpu")
    carry = init_carry(env, policy, torch.Generator().manual_seed(5))
    fps_calls = []
    real = fps.reference_fps

    def counting(*a, **k):
        fps_calls.append(1)
        return real(*a, **k)

    fps.reference_fps = counting
    try:
        carry, traj, ep_stats = make_rollout(env, policy)(carry)
    finally:
        fps.reference_fps = real
    out = flatten(carry.env_state.gen, "gb", {})
    flatten(traj["reward"], "reward", out)
    flatten(carry.env_state.cylinders, "cylinders", out)
    flatten(carry.generator.get_state(), "gen", out)
    out["fps_calls"] = np.asarray(len(fps_calls))
    return _metrics_out(ep_stats, "ep_stats", out)


def job_trap(inp, name, shard_of) -> Dict[str, np.ndarray]:
    """Rank 0's arenas (the first half) end an episode on the next step,
    the others' do not: every rank must draw the fresh scene, at the global
    count.  HideAndSeek (8 arenas), then Hover (8 arenas)."""
    out: Dict[str, np.ndarray] = {}
    for name, env in (("hideandseek", HideAndSeek(HideAndSeekCfg(num_envs=8,
                                                                 max_episode_length=5,
                                                                 use_tp_net=False),
                                                  device="cpu", shard=shard_of(8))),
                      ("hover", Hover(HoverCfg(num_envs=8, max_episode_length=5),
                                      device="cpu", shard=shard_of(8)))):
        gen = torch.Generator().manual_seed(11)
        state = env.reset(gen)
        first = torch.arange(env.shard.offset, env.shard.offset + env.shard.size) < 4
        state.progress = torch.where(first, 4, 0).to(torch.int32)
        action = torch.zeros((env.shard.size, env.num_agents, 4))
        for _ in range(2):
            state, tr = env.step(state, action, gen)
        flatten(gen.get_state(), f"{name}/gen", out)
        flatten(state.drone.pos, f"{name}/pos", out)
        flatten(state.progress, f"{name}/progress", out)
    return out


HARNESS_ARGV = ["env.num_envs=16", "env.max_episode_length=16", "max_iters=2", "log_interval=1",
                "save_interval=1", "algo.train_every=8", "algo.num_minibatches=2"]


def job_harness(inp, name, shard_of) -> Dict[str, np.ndarray]:
    """`harness.train` on Hover (run directory `harness/run_dir` of the
    input) for 2 iterations, again for 1 from its checkpoint of iteration 1,
    then algo=ppo (which trains across ranks) and the refusals across
    ranks: algo=ppo_adapt and 15 arenas."""
    from mupe_tpu_torch.harness import train

    run_dir = str(inp[f"{name}/run_dir"])
    metrics = train([*HARNESS_ARGV, f"run_dir={run_dir}", "run_name=shared"],
                    default_task="Hover", device="cpu")
    out = _metrics_out(metrics, "metrics", {})
    # resume iteration 2 at this world size from the gathered checkpoint of 1
    resumed = train([*HARNESS_ARGV[:2], "max_iters=1", *HARNESS_ARGV[3:],
                     f"run_dir={run_dir}", "run_name=resumed",
                     f"resume_dir={run_dir}/shared/checkpoints/full/step_1"],
                    default_task="Hover", device="cpu")
    _metrics_out(resumed, "resumed", out)
    refused, messages = [], []
    for extra in (["algo=ppo"], ["algo=ppo_adapt"], ["env.num_envs=15"]):
        try:
            m = train([*HARNESS_ARGV, *extra, f"run_dir={run_dir}", "run_name=refused"],
                      default_task="Hover", device="cpu")
            _metrics_out(m, extra[0], out)
            refused.append("trained")
            messages.append("")
        except (NotImplementedError, ValueError) as e:
            refused.append(type(e).__name__)
            messages.append(str(e))
    try:
        dist.local_env_slice(15)
        refused.append("none")
    except ValueError as e:
        refused.append(type(e).__name__)
    out["refused"] = np.asarray(refused)
    out["refused_messages"] = np.asarray(messages)
    return out


# the PPO family: (algo, task, env overrides, algo overrides) over FAMILY_ENV
# and FAMILY_ALGO; 6-step episodes reset inside the 8-step rollout
FAMILY_ENV = dict(num_envs=8, max_episode_length=6)
FAMILY_ALGO = dict(train_every=8, num_minibatches=2, ppo_epochs=1)
HOVER_DEPTH = dict(obs_depth=True, depth_width=16, depth_height=12)
FAMILY = {
    "ppo": ("ppo", "Hover", {}, {}),
    "ppo_priv": ("ppo", "Hover", dict(dr_mass_scale=(0.8, 1.2), dr_t2w_scale=(0.9, 1.1)),
                 dict(priv_actor=True, priv_critic=True)),
    "ppo_tconv": ("ppo_tconv", "Hover", dict(obs_history_len=16), {}),
    "ppo_rnn": ("ppo_rnn", "Hover", {}, dict(train_seq_len=4)),
    "transformer": ("transformer", "HideAndSeek", {}, {}),
    "ppo_vision": ("ppo_vision", "Hover", HOVER_DEPTH, {}),
    "ppo_vision_mobilenet": ("ppo_vision", "Hover", HOVER_DEPTH,
                             dict(vision_encoder="mobilenet_v3_small")),
}
FAMILY_TRAJ_KEYS = ("action", "logp", "value", "reward", "done")
FAMILY_SEED = 13


def job_family(inp, name, shard_of) -> Dict[str, np.ndarray]:
    """One iteration of `FAMILY[case]` from seed 13 on this rank's arenas:
    the rollout's trajectory, the generator's state after the rollout and
    after the update, the gradients of every optimizer step, the learner
    and the metrics.  ppo_rnn takes its chunk permutations from
    `name/perms` where the input has them."""
    from mupe_tpu_torch import harness
    from mupe_tpu_torch.learning.registry import is_recurrent
    from mupe_tpu_torch.learning.rollout import init_rnn_carry, make_rnn_rollout

    algo, task, env_kw, algo_kw = FAMILY[name.split(":")[1]]
    env, policy, _, _ = harness.build(task, {**FAMILY_ENV, **env_kw},
                                      {**FAMILY_ALGO, **algo_kw}, algo, device="cpu")
    assert env.shard == shard_of(FAMILY_ENV["num_envs"])
    gen = torch.Generator().manual_seed(FAMILY_SEED)
    recurrent = is_recurrent(policy)
    if recurrent:
        carry = init_rnn_carry(env, policy, gen)
        carry, traj, ep_stats = make_rnn_rollout(env, policy)(carry)
    else:
        carry = init_carry(env, policy, gen)
        carry, traj, ep_stats = make_rollout(env, policy)(carry)
    out: Dict[str, np.ndarray] = {}
    for k in FAMILY_TRAJ_KEYS:
        out[f"traj/{k}"] = traj[k].float().numpy()
    flatten(gen.get_state(), "gen_rollout", out)
    with recorded_grads() as seen:
        if recurrent:
            perms = inp.get(f"{name}/perms")
            ts, metrics = policy.train_op(carry.ts, traj, gen,
                                          None if perms is None else torch.as_tensor(perms),
                                          shard=env.shard)
        else:
            ts, metrics = policy.train_op(carry.ts, traj, carry.obs, gen,
                                          last_state=carry.state, shard=env.shard)
    flatten(ts, "ts", out)
    flatten(gen.get_state(), "gen", out)
    _metrics_out(metrics, "metrics", out)
    _metrics_out(ep_stats, "ep_stats", out)
    return _grads_out(seen, out)


SDF_T, SDF_E = 8, 8


def job_sdf(inp, name, shard_of) -> Dict[str, np.ndarray]:
    """ppo_sdf (no env emits `sdf_points`): `train_op` of a fresh
    `PPOSDFNavPolicy` on a synthetic global trajectory from
    `np.random.default_rng(17)`, this rank holding its arenas' rows, with
    the minibatch permutation from `name/perms`."""
    from mupe_tpu_torch.learning.ppo import PPOSDFNavPolicy

    rng = np.random.default_rng(17)
    t, e = SDF_T, SDF_E

    def obs(lead):
        return {"observation": torch.as_tensor(rng.normal(size=lead + (1, 20)),
                                               dtype=torch.float32),
                "sdf_points": torch.as_tensor(rng.normal(size=lead + (1, 16, 3)),
                                              dtype=torch.float32)}

    traj = {"obs": obs((t, e)),
            "action": torch.as_tensor(rng.normal(size=(t, e, 1, 4)), dtype=torch.float32),
            "logp": torch.as_tensor(rng.normal(-4.0, 0.5, (t, e, 1, 1)), dtype=torch.float32),
            "value": torch.as_tensor(rng.normal(size=(t, e, 1, 1)), dtype=torch.float32),
            "reward": torch.as_tensor(rng.normal(size=(t, e, 1, 1)), dtype=torch.float32),
            "done": torch.as_tensor(rng.uniform(size=(t, e, 1)) < 0.1, dtype=torch.float32)}
    last_obs = obs((e,))
    policy = PPOSDFNavPolicy(tmappo.MAPPOCfg(gamma=0.99, train_every=t, num_minibatches=2,
                                             ppo_epochs=1, use_tp_net=False), device="cpu")
    ts = policy.init(last_obs, torch.Generator().manual_seed(0))
    shard = shard_of(e)
    out: Dict[str, np.ndarray] = {}
    with recorded_grads() as seen:
        ts, metrics = policy.train_op(ts, rows(traj, shard, 1), rows(last_obs, shard, 0),
                                      perms=torch.as_tensor(inp[f"{name}/perms"]), shard=shard)
    flatten(ts, "ts", out)
    _metrics_out(metrics, "metrics", out)
    return _grads_out(seen, out)


VIDEO_ARGV = ["env.num_envs=8", "env.max_episode_length=8", "algo.train_every=8",
              "algo.num_minibatches=2", "algo.ppo_epochs=1", "max_iters=2", "log_interval=1",
              "eval_interval=1", "video=1", "save_interval=-1"]


def job_video(inp, name, shard_of) -> Dict[str, np.ndarray]:
    """`harness.train` (VIDEO_ARGV and the input's `extra` arguments) with
    an evaluation video of arena `index` after each of its 2 iterations:
    the GIFs this rank wrote (rank 0 writes them all)."""
    from mupe_tpu_torch import harness

    written = []
    real = harness.episode_video

    def recording(info, cfg, path, *args, **kwargs):
        written.append(path)
        return real(info, cfg, path, *args, **kwargs)

    harness.episode_video = recording
    try:
        harness.train([*VIDEO_ARGV, *[str(a) for a in inp[f"{name}/extra"]],
                       f"video_env_index={int(inp[f'{name}/index'])}",
                       f"run_dir={inp[f'{name}/run_dir']}", "run_name=video"], device="cpu")
    finally:
        harness.episode_video = real
    return {"written": np.asarray(written, dtype=str)}


JOBS = {"update": job_update, "iteration": job_iteration, "aeg": job_aeg, "trap": job_trap,
        "harness": job_harness, "family": job_family, "sdf": job_sdf, "video": job_video}


def run_jobs(jobs, inp: Dict[str, np.ndarray], rank: int = 0, world: int = 1):
    """{job: arrays} for this rank (the group, if any, already formed).  A
    job is named `kind` or `kind:tag`; it reads its inputs under `name/`."""
    torch.set_num_threads(1)

    def shard_of(num_envs):
        return dist.EnvShard.of(num_envs, rank, world)

    return {job: JOBS[job.split(":")[0]](inp, job, shard_of) for job in jobs}


def launch(world: int, jobs, inp: Dict[str, np.ndarray], tmp: Path,
           timeout: float = 240.0) -> List[Dict[str, Dict[str, np.ndarray]]]:
    """Run `jobs` in `world` subprocess ranks over a gloo group (a file
    store under `tmp`); each wait is bounded and the children are killed on
    the way out.  Returns each rank's {job: arrays}."""
    tmp.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / "in.npz", jobs=np.asarray(list(jobs)), **inp)
    store = tmp / "store"
    if store.exists():
        store.unlink()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(world),
                               f"file://{store}", str(tmp / "in.npz"), str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=str(REPO), env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n{out[-4000:]}")
    return [{job: dict(np.load(tmp / f"{_file(job)}_{r}.npz")) for job in jobs}
            for r in range(world)]


def _file(job: str) -> str:
    return job.replace(":", "-")


def main(argv) -> int:
    rank, world, init_method, inp_path, out_dir = argv
    rank, world = int(rank), int(world)
    if init_method != "-":
        dist.init_distributed(backend="gloo", init_method=init_method, world_size=world,
                              rank=rank)
    inp = dict(np.load(inp_path))
    results = run_jobs([str(j) for j in inp.pop("jobs")], inp, rank, world)
    for job, arrays in results.items():
        np.savez(Path(out_dir) / f"{_file(job)}_{rank}.npz", **arrays)
    dist.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
