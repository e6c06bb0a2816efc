"""Traffic kind `train_vision`: ppo_vision's whole training iterations back
to back, the depth frame through MobileNetV3-Small.

The path no `train` cell runs: networks injected into `MAPPOPolicy`
(`VisionNet`), dict observations, the act taken eagerly (no CUDA graph),
and the non-joint update (`_update_actor_critic`: an actor step, then a
critic step, each over the whole minibatch in one call, as the
backbone's batch statistics require).

Set-up builds through `harness.build`, draws the parameters from the seed
on the device in one draw (`reference/vision.py`'s layout, which is the
program's leaf order), resets through `init_carry` and runs the traffic's
`check_iters` iterations through `make_train_iter`: the warm-up, and what
the check compares (`train.Capture`).  The window runs whole iterations
for `--seconds` and ends with a synchronisation.  With `--trace 1` the
window's act, env steps and updates are timed by CUDA events as `train`'s
are (`train._install_spans`), then `trace_iters` iterations run untraced
and as many under the profiler.

The check follows the program from its own state, as `train` does: the
reset and 3 env steps (one of which resets every other arena) with the
depth frame; each step's log-probs and values, one call a step as the
program's act (the batch statistics are those of a step's frames); the
first minibatch's loss, its clipped gradients by leaf and the median
leaf's change after 3 steps, against `reference/vision.py`.
"""
from __future__ import annotations

import sys
import time
from typing import Any, Dict

import torch

from bench_port import checks, core, program, tracing
from bench_port.drivers import train as base
from bench_port.flops import mlp_flops
from bench_port.flops import mobilenet as mnv3
from bench_port.reference import nets, vision


class Layout:
    """The vision networks' leaf layouts (`program.program_leaves` and
    `train.program_update` split the program's flat vectors by them)."""

    def __init__(self, obs_dim: int, frame, action_dim: int):
        self.obs_dim, self.frame, self.action_dim = obs_dim, tuple(frame), action_dim

    def actor(self):
        return vision.net_leaves(self.obs_dim, self.action_dim)

    def critic(self):
        return vision.net_leaves(self.obs_dim, 1)


def layout_of(env, policy) -> Layout:
    cfg = env.cfg
    return Layout(cfg.obs_dim, (cfg.depth_height, cfg.depth_width, 1), policy.action_dim)


def draw_parameters(layout: Layout, gen: torch.Generator, device) -> Dict[str, Any]:
    """The actor's leaves, log_std and the critic's from one standard-normal
    draw on `device`."""
    lays = [layout.actor(), [((layout.action_dim,), "b")], layout.critic()]
    sizes = [vision.layout_size(l) for l in lays]
    parts = torch.split(torch.randn(sum(sizes), generator=gen, device=device), sizes)
    return {"actor": vision.make_leaves(lays[0], parts[0]), "log_std": -0.5 + parts[1],
            "critic": vision.make_leaves(lays[2], parts[2])}


def obs_example(layout: Layout, device) -> Dict[str, torch.Tensor]:
    return {"depth": torch.zeros((1, 1) + layout.frame, device=device),
            "observation": torch.zeros((1, 1, layout.obs_dim), device=device)}


def model(env, layout: Layout, algo_cfg) -> Dict[str, Any]:
    e, t = env.shard.total, algo_cfg.train_every
    return dict(frame=list(layout.frame[:2]), obs_dim=layout.obs_dim,
                action_dim=layout.action_dim, arenas=e, steps=t,
                minibatches=algo_cfg.num_minibatches, epochs=algo_cfg.ppo_epochs,
                mb_frames=e * t // algo_cfg.num_minibatches)


def network_flops(m: Dict[str, Any], head: int, frames: int, backward: bool) -> float:
    """One network's operations on `frames` frames: the backbone, the state
    MLP, the joining MLP and the head (a backward adds two products per
    forward product, less the inputs' gradients)."""
    h, w = m["frame"]
    mlp = (mlp_flops(m["obs_dim"], (vision.STATE_HIDDEN[0],), vision.STATE_HIDDEN[1], frames)
           + mlp_flops(vision.LAST + vision.STATE_HIDDEN[-1], (vision.OUT_DIM,), head, frames))
    if not backward:
        return float(mnv3.forward_flops(h, w, frames) + mlp)
    return float(mnv3.fwd_bwd_flops(h, w, frames) + 3 * mlp
                 - 2 * frames * m["obs_dim"] * vision.STATE_HIDDEN[0])


def iteration_flops(m: Dict[str, Any]) -> float:
    """Every step's act (both networks), the bootstrap value and every
    minibatch's forward and backward of both networks."""
    a, e = m["action_dim"], m["arenas"]
    total = m["steps"] * (network_flops(m, a, e, False) + network_flops(m, 1, e, False))
    total += network_flops(m, 1, e, False)
    total += m["minibatches"] * m["epochs"] * (network_flops(m, a, m["mb_frames"], True)
                                               + network_flops(m, 1, m["mb_frames"], True))
    return total


class Setup:
    """The program after set-up: built, seeded, through its check
    iterations, with what the check needs captured."""

    def __init__(self, run: core.Run):
        from mupe_tpu_torch import harness
        from mupe_tpu_torch.learning import init_carry, make_train_iter

        dev = run.device
        tr = run.traffic
        t = time.time()
        self.env, self.policy, self.env_cfg, self.algo_cfg = harness.build(
            run.config["task"], run.env_overrides(), run.algo_overrides(), run.config["algo"], dev)
        self.layout = layout_of(self.env, self.policy)
        params = draw_parameters(self.layout, run.generator("params"), dev)
        ts = self.policy.init(obs_example(self.layout, dev), actor_leaves=params["actor"],
                              log_std=params["log_std"], critic_leaves=params["critic"])
        gen = run.generator("env")
        self.reset_gen = gen.get_state()
        self.carry = init_carry(self.env, self.policy, gen, ts=ts)
        self.first_obs = program.tree_clone(self.carry.obs, "cpu")
        self.train_iter = make_train_iter(self.env, self.policy)
        self.t_len = self.algo_cfg.train_every
        _sync(dev)
        self.times = {"build": time.time() - t}
        t = time.time()
        pick = torch.Generator().manual_seed(run.sub_seed("steps"))
        steps = [0] + [int(s) for s in torch.randint(1, self.t_len, (tr["check_steps"] - 1,),
                                                     generator=pick)]
        self.cap = base.Capture(run, self.env, self.policy, self.layout, steps, reset_step=int(
            torch.randint(1, self.t_len, (1,), generator=pick)))
        for _ in range(tr["check_iters"]):
            self.carry, _, _ = self.train_iter(self.carry)
        self.cap.remove()
        self.prog_after = {k: [l.cpu().clone() for l in v] for k, v in
                           program.program_leaves(self.carry.ts, self.layout).items()}
        _sync(dev)
        self.times["check_iters"] = time.time() - t

    def release(self):
        """Drop the program's state, keeping what the check reads."""
        self.cap.env = self.cap.policy = None
        self.env = self.policy = self.carry = self.train_iter = None


def run(run: core.Run) -> core.Outcome:
    dev = run.device
    tr = run.traffic
    st = Setup(run)
    env, policy, train_iter, carry, t_len = st.env, st.policy, st.train_iter, st.carry, st.t_len
    spans = tracing.Spans(dev) if run.trace else None
    mark_fn = None
    if spans is not None:
        mark_fn = base._install_spans(env, policy, spans, env.cfg.max_episode_length,
                                      start=tr["check_iters"] * t_len)
    t0 = time.time()
    setup_s = t0 - run.t_start
    iters, failed = 0, 0
    while time.time() - t0 < run.seconds:
        carry, metrics, _ = train_iter(carry, mark=mark_fn)
        iters += 1
        # an iteration lasts seconds: its metrics are read as it ends
        failed += not checks.finite(metrics.values())
    _sync(dev)
    wall = time.time() - t0
    e2e = {"train_env_steps_per_s": iters * env.shard.total * t_len / wall, "setup_s": setup_s}
    record = breakdown = None
    if run.trace:
        m = model(env, st.layout, st.algo_cfg)
        tracing.unwrap(env, "step")
        tracing.unwrap(policy, "act")
        record, breakdown = base._traced(run, env, policy, train_iter, carry, spans,
                                         tr["trace_iters"], t_len)
        record.update(kind="train_vision", model=m, window={"iters": iters, "wall_s": wall},
                      iter_flops=iteration_flops(m))
    device = core.card_info(dev)
    st.release()
    del carry, train_iter, env, policy
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.time()
    got = readings(run, st, reference(run, st))
    print(f"info: {iters} iterations in {wall:.2f} s; build {st.times['build']:.2f} s, check "
          f"iterations {st.times['check_iters']:.2f} s, reference {time.time() - t:.2f} s",
          file=sys.stderr)
    checks_ = [core.Check(name, got[name], limit) for name, limit in run.cell["limits"].items()]
    return core.Outcome(e2e=e2e, attempted=iters, failed=failed, checks=checks_, device=device,
                        record=record, breakdown=breakdown)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reference(run, st) -> vision.VisionLearner:
    """The reference learner over the parameters the seed gives."""
    params = draw_parameters(st.layout, run.generator("params"), run.device)
    return vision.VisionLearner(
        actor=params["actor"], log_std=params["log_std"], critic=params["critic"], tp=None,
        cfg={k: getattr(st.algo_cfg, k) for k in program.ALGO_KEYS}, rnd=nets.exact,
        frame=st.layout.frame)


@torch.no_grad()
def act_outputs(traj, learner, dev):
    """(log-probs of the rollout's actions, values) [T, E, n, 1], one call a
    step: a step's frames share their batch statistics, as in the act."""
    logps, values = [], []
    for t in range(traj["action"].shape[0]):
        obs = {k: v[t].to(dev) for k, v in traj["obs"].items()}
        x = learner.obs_rows(obs)
        logps.append(nets.log_prob(traj["action"][t].to(dev), learner.mean(x),
                                   learner.log_std)[..., None])
        values.append(learner.value(x))
    return torch.stack(logps), torch.stack(values)


def act_reading(traj, ref, dev) -> float:
    r_logp, r_value = act_outputs(traj, ref, dev)
    return max(checks.widest_gap(traj["logp"].to(dev), r_logp),
               checks.widest_gap(traj["value"].to(dev), r_value))


def readings(run, st, ref) -> Dict[str, float]:
    """`env`, `act`, and the update's `loss`, `first_loss`, `grad`,
    `change`, `median_change` (`train.update_readings`)."""
    dev = run.device
    out = {"env": base.env_reading(run, st.cap, st.first_obs, st.reset_gen, st.env_cfg, ref),
           "act": act_reading(st.cap.rollouts[0]["traj"], ref, dev)}
    ref_up = base.update_reference(ref, st.cap.rollouts, dev)
    out.update(base.update_readings(base.program_update(st.cap, st.prog_after, st.layout),
                                    ref_up))
    return out
