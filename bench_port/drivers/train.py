"""Traffic kind `train`: whole training iterations back to back.

Set-up builds the env and the policy through `harness.build`, the
parameters from the seed, the carry through `init_carry`, and runs the
first `check_iters` iterations through `make_train_iter`'s own call: they
are the warm-up, and the check follows them (the minibatch permutations of
those iterations are the benchmark's, handed to `train_op`).  The window
runs iterations until `--seconds` have passed, reading the metrics to the
host every `log_interval` iterations as the port's training loop does, and
ends with a synchronisation.  With `--trace 1` the window records CUDA
events around `policy.act`, `env.step` and the `mark` callbacks, and then
`trace_iters` iterations are timed untraced and as many traced.

The check: the reference follows the program step by step from the
program's own state.  It resets from the program's generator state, steps
the env from the program's states (one step of an episode that resets
half the arenas among them), recomputes the first iteration's log-probs
and values, and runs the three updates on the program's rollouts with its
own parameters, made from the seed.
"""
from __future__ import annotations

import math
import sys
import time
from typing import Any, Dict, List

import torch

from bench_port import checks, core, flops, program, tracing
from bench_port.reference import nets
from bench_port.reference import update as _update
from bench_port.reference.update import leaf_norms

# the program's minibatch updates, one of which train_op calls
UPDATES = ("_update_joint_flat", "_update_joint_direct", "_update_actor_critic")
# the optimizer steps the reference follows; the TP net takes one an iteration
STEPS = 3
TP_FIELDS = ("tp_input", "tp_gt", "tp_done", "done")
# the numbers `update_readings` gives, and all that `readings` gives
UPDATE_NUMBERS = ("loss", "first_loss", "grad", "median_grad", "group_grad", "change",
                  "median_change", "group_change")
NUMBERS = ("env", "act", "act_logp", "act_value") + UPDATE_NUMBERS


def _model(env, layout, algo_cfg) -> Dict[str, Any]:
    """The shapes the per-layer readers count operations from."""
    e, t = env.shard.total, algo_cfg.train_every
    m = dict(groups=layout.groups, obs_dim=layout.obs_dim, n_agents=layout.n_agents,
             action_dim=layout.action_dim, hidden=list(layout.hidden), arenas=e, steps=t,
             minibatches=algo_cfg.num_minibatches, epochs=algo_cfg.ppo_epochs,
             mb_rows=e * t // algo_cfg.num_minibatches * layout.n_agents, tp=None)
    if layout.tp is not None:
        m["tp"] = dict(in_dim=layout.tp[0], out=layout.tp[1], steps=env.cfg.history_step,
                       windows=(t - algo_cfg.future_prediction_step) * e)
    return m


def iteration_flops(m: Dict[str, Any]) -> float:
    """The operations an iteration's forward and backward passes need:
    every step's act (actor and critic) and TP prediction, the bootstrap
    value, the TP step's forward and backward, every minibatch's forward
    and backward of both networks; recomputation is not counted."""
    rows_act = m["arenas"] * m["n_agents"]
    a = m["action_dim"]
    if m["groups"] is not None:
        g = m["groups"]
        fwd = lambda h, r: flops.encoder_flops(g, h, r)  # noqa: E731
        both = lambda h, r: flops.encoder_fwd_bwd_flops(g, h, r)  # noqa: E731
    else:
        d, hid = m["obs_dim"], m["hidden"]
        fwd = lambda h, r: flops.mlp_flops(d, hid, h, r)  # noqa: E731
        both = lambda h, r: flops.mlp_fwd_bwd_flops(d, hid, h, r)  # noqa: E731
    total = m["steps"] * (fwd(a, rows_act) + fwd(1, rows_act)) + fwd(1, rows_act)
    total += m["minibatches"] * m["epochs"] * (both(a, m["mb_rows"]) + both(1, m["mb_rows"]))
    if m["tp"] is not None:
        tp = m["tp"]
        total += m["steps"] * flops.tp_flops(tp["in_dim"], tp["steps"], tp["out"], m["arenas"])
        total += flops.tp_fwd_bwd_flops(tp["in_dim"], tp["steps"], tp["out"], tp["windows"])
    return float(total)


class Capture:
    """Wrappers over the program's calls during the check iterations: the
    rollouts, the benchmark's permutations, the first optimizer steps and
    the env steps the reference repeats."""

    def __init__(self, run, env, policy, layout, steps: List[int], reset_step: int):
        self.run, self.env, self.policy, self.layout = run, env, policy, layout
        self.k = 0
        self.rollouts: List[Dict[str, Any]] = []
        self.first: Dict[str, Any] = {}
        self.snaps: List[Dict[str, Any]] = []
        self.steps, self.reset_step, self.step_count = set(steps), reset_step, 0
        self.mb_losses: List[float] = []
        self.after_steps = None
        tracing.wrap(policy, "train_op", self._train_op)
        for attr in UPDATES:
            tracing.wrap(policy, attr, self._update)
        tracing.wrap(policy, "_actor_step", lambda f: self._opt_step(f, "actor"))
        tracing.wrap(policy, "_critic_step", lambda f: self._opt_step(f, "critic"))
        tracing.wrap(env, "step", self._step)

    def remove(self):
        for attr in ("train_op", "_actor_step", "_critic_step") + UPDATES:
            tracing.unwrap(self.policy, attr)
        tracing.unwrap(self.env, "step")

    def _train_op(self, original):
        def train_op(ts, traj, last_obs, generator=None, perms=None, mark=None, **kw):
            b = traj["reward"].shape[0] * self.env.shard.total
            g = self.run.generator(f"perms{self.k}")
            perms = torch.stack([torch.randperm(b, generator=g, device=g.device)
                                 for _ in range(self.policy.cfg.ppo_epochs)])
            keep = traj if self.k == 0 else {k: traj[k] for k in TP_FIELDS if k in traj}
            self.rollouts.append({"traj": program.tree_clone(keep, "cpu"),
                                  "last_obs": program.tree_clone(last_obs, "cpu"),
                                  "perms": perms.cpu()})
            out = original(ts, traj, last_obs, generator, perms, mark, **kw)
            if self.k == 0 and ts.tp_opt is not None:
                self.first["tp"] = [m.detach().cpu() / 0.1 for m in ts.tp_opt.mu]
            self.rollouts[-1]["metrics"] = {k: float(v) for k, v in out[1].items()}
            self.k += 1
            return out

        return train_op

    def _update(self, original):
        def update(ts, mb, stop=None, mb_rows=None):
            info = original(ts, mb, stop, mb_rows=mb_rows)
            if self.k == 0 and len(self.mb_losses) < STEPS:
                self.mb_losses.append(float(info["policy_loss"]) + float(info["value_loss"]))
                if len(self.mb_losses) == STEPS:
                    self.after_steps = {k: [l.cpu().clone() for l in v] for k, v in
                                        program.program_leaves(ts, self.layout).items()}
            return info

        return update

    def _opt_step(self, original, which):
        def step(ts, grads, stop):
            out = original(ts, grads, stop)
            if which not in self.first:
                # Adam's first moment after one step is (1 - b1) times the
                # clipped gradient it was given
                opt = ts.actor_opt if which == "actor" else ts.critic_opt
                self.first[which] = [m.detach().cpu() / 0.1 for m in opt.mu]
            return out

        return step

    def _step(self, original):
        def step(state, action, gen=None, *args):
            i = self.step_count
            self.step_count += 1
            if self.k > 0 or (i not in self.steps and i != self.reset_step):
                return original(state, action, gen, *args)
            gen_state = gen.get_state()
            if i == self.reset_step:
                # the same entry on a copy of the state in which every other
                # arena ends its episode now, with a copy of the generator
                mod = program.tree_clone(state)
                mod.progress[::2] = self.env.cfg.max_episode_length - 1
                g2 = program.generator_like(gen_state, gen.device)
                self.snaps.append(self._snap(mod, action, gen_state, args,
                                             original(mod, action, g2, *args), None))
            before = program.tree_clone(state) if i in self.steps else None
            out = original(state, action, gen, *args)
            if before is not None:
                self.snaps.append(self._snap(before, action, gen_state, args, out, i))
            return out

        return step

    @staticmethod
    def _snap(state, action, gen_state, args, out, progress):
        _, tr = out
        return {"state": program.tree_clone(state, "cpu"), "action": action.detach().cpu(),
                "gen": gen_state, "tp": bool(args), "progress": progress,
                "out": program.tree_clone({"obs": tr.obs, "reward": tr.reward, "done": tr.done,
                                           "stats": tr.stats}, "cpu")}


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
        self.layout = program.layout_of(self.env, self.policy)
        params = program.draw_parameters(self.layout, run.generator("params"), dev)
        ts = program.init_state(self.env, self.policy, params)
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
        self.cap = Capture(run, self.env, self.policy, self.layout, steps, reset_step=int(
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

    def readings(self, run, ref) -> Dict[str, float]:
        return readings(run, self.cap, self.first_obs, self.reset_gen, self.prog_after,
                        self.env_cfg, ref, self.layout)


def run(run: core.Run) -> core.Outcome:
    dev = run.device
    tr = run.traffic
    st = Setup(run)
    env, policy, train_iter, carry, t_len = st.env, st.policy, st.train_iter, st.carry, st.t_len
    layout, algo_cfg = st.layout, st.algo_cfg

    spans = tracing.Spans(dev) if run.trace else None
    mark_fn, reset_every = None, env.cfg.max_episode_length
    if spans is not None:
        mark_fn = _install_spans(env, policy, spans, reset_every, start=tr["check_iters"] * t_len)
    t0 = time.time()
    setup_s = t0 - run.t_start
    iters, failed, pending, blocks = 0, 0, [], [t0]
    while time.time() - t0 < run.seconds:
        carry, metrics, _ = train_iter(carry, mark=mark_fn)
        iters += 1
        pending.append(metrics)
        if iters % tr["log_interval"] == 0:
            failed += sum(not checks.finite(m.values()) for m in pending)
            pending = []
            blocks.append(time.time())
    _sync(dev)
    wall = time.time() - t0
    print("info: window blocks of %d iterations, s: %s" % (tr["log_interval"], " ".join(
        f"{b - a:.3f}" for a, b in zip(blocks, blocks[1:]))), file=sys.stderr)
    failed += sum(not checks.finite(m.values()) for m in pending)
    frames = env.shard.total * t_len
    e2e = {"train_env_steps_per_s": iters * frames / wall, "setup_s": setup_s}
    model = _model(env, layout, algo_cfg)
    record = breakdown = None
    if run.trace:
        tracing.unwrap(env, "step")
        tracing.unwrap(policy, "act")
        record, breakdown = _traced(run, env, policy, train_iter, carry, spans, tr["trace_iters"],
                                    t_len)
        record.update(model=model, window={"iters": iters, "wall_s": wall},
                      iter_flops=iteration_flops(model))
    device = core.card_info(dev)
    st.release()
    del carry, train_iter, env, policy
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.time()
    ref = reference(run, layout, algo_cfg, program.rounding(algo_cfg))
    got = st.readings(run, ref)
    print(f"info: build {st.times['build']:.2f} s, check iterations "
          f"{st.times['check_iters']:.2f} s, reference {time.time() - t:.2f} s", file=sys.stderr)
    checks_ = [core.Check(name, got[name], limit) for name, limit in run.cell["limits"].items()]
    return core.Outcome(e2e=e2e, attempted=iters, failed=failed, checks=checks_, device=device,
                        record=record, breakdown=breakdown)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _install_spans(env, policy, spans, reset_every: int, start: int):
    """CUDA events around act, env.step (reset steps apart) and the
    update (from the `rollout` mark to the `ppo` mark)."""
    count = [start]

    def wrap_act(f):
        def act(*a, **kw):
            s = spans.event()
            out = f(*a, **kw)
            spans.add("act", s, spans.event())
            return out
        return act

    def wrap_step(f):
        def step(*a, **kw):
            s = spans.event()
            out = f(*a, **kw)
            count[0] += 1
            spans.add("reset_step" if count[0] % reset_every == 0 else "env_step", s, spans.event())
            return out
        return step

    tracing.wrap(policy, "act", wrap_act)
    tracing.wrap(env, "step", wrap_step)
    open_ = {}

    def mark(name):
        if name == "rollout":
            open_["u"] = spans.event()
        elif name == "ppo" and "u" in open_:
            spans.add("update", open_.pop("u"), spans.event())

    return mark


def _traced(run, env, policy, train_iter, carry, spans, k: int, t_len: int):
    """`k` iterations timed untraced, then `k` traced with the phases
    annotated; returns the record and the breakdown."""
    dev = run.device
    _sync(dev)
    t0 = time.time()
    for _ in range(k):
        carry, _, _ = train_iter(carry)
    _sync(dev)
    untraced = time.time() - t0
    ann = tracing.Annotations()
    phases = ("rollout", "prep", "tp", "ppo")

    def mark(name):
        ann.exit(name)
        nxt = phases.index(name) + 1
        if nxt < len(phases):
            ann.enter(phases[nxt])

    def wrap_layer(f, name):
        def call(*a, **kw):
            ann.enter(name)
            out = f(*a, **kw)
            ann.exit(name)
            return out
        return call

    tracing.wrap(policy, "act", lambda f: wrap_layer(f, "act"))
    tracing.wrap(env, "step", lambda f: wrap_layer(f, "env_step"))
    with tracing.profiler() as prof:
        t1 = time.time()
        for _ in range(k):
            ann.enter("rollout")
            carry, _, _ = train_iter(carry, mark=mark)
            ann.close_all()
        _sync(dev)
        traced = time.time() - t1
    tracing.unwrap(policy, "act")
    tracing.unwrap(env, "step")
    trace = tracing.reduce_trace(prof)
    record = {"kind": "train", "trace": trace, "iters_traced": k, "steps": t_len,
              "untraced_wall_s": untraced, "busy_s": trace["busy_s"], "window_s": traced,
              "spans": {n: spans.ms(n) for n in ("act", "env_step", "reset_step", "update")}}
    return record, {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}


def reference(run, layout, algo_cfg, rnd: str):
    """A reference learner over the parameters the seed gives."""
    params = program.draw_parameters(layout, run.generator("params"), run.device)
    return program.reference_learner(layout, params, algo_cfg, nets.ROUNDING[rnd])


def readings(run, cap, first_obs, reset_gen, prog_after, env_cfg, ref, layout) -> Dict[str, float]:
    """`env` (the reset and the env steps), `act`, `act_logp`, `act_value`
    (the first rollout's log-probs and values), and the update's numbers
    (`update_readings`)."""
    dev = run.device
    out = {"env": env_reading(run, cap, first_obs, reset_gen, env_cfg, ref)}
    first = cap.rollouts[0]["traj"]
    out.update(act_readings((first["logp"], first["value"]), act_outputs(first, ref, dev)))
    ref_up = update_reference(ref, cap.rollouts, dev)
    out.update(update_readings(program_update(cap, prog_after, layout), ref_up))
    return out


def env_reading(run, cap, first_obs, reset_gen, env_cfg, ref, control: bool = False) -> float:
    """The reset and the recorded env steps; `control`: the reference
    stepping from states held in bfloat16 in the program's place."""
    dev = run.device
    ref_env = program.reference_env(run.config["task"], env_cfg, dev)
    tp_fn = checks.tp_function(ref) if ref.tp is not None else None
    gap = checks.reset_gap(reset_gen, program.tree_clone(first_obs, dev), ref_env, tp_fn, dev,
                           control)
    for snap in cap.snaps:
        gap = max(gap, checks.env_step_gap(snap, ref_env, tp_fn, dev, control))
    return gap


@torch.no_grad()
def act_outputs(traj, learner, dev, block: int = 8):
    """(log-probs of the rollout's actions, values) [T, E, n, 1] by the
    learner's networks, a block of steps at a time."""
    logps, values = [], []
    for t in range(0, traj["action"].shape[0], block):
        part = program.tree_clone({k: traj[k] for k in ("obs", "action")}, dev)
        part = {k: (v[t:t + block] if not isinstance(v, dict)
                    else {g: x[t:t + block] for g, x in v.items()}) for k, v in part.items()}
        x = learner.obs_rows(part["obs"])
        logps.append(nets.log_prob(part["action"], learner.mean(x), learner.log_std)[..., None])
        values.append(learner.value(x))
    return torch.cat(logps), torch.cat(values)


def act_readings(side, ref) -> Dict[str, float]:
    """`act_logp` and `act_value`: the widest gap of the rollout's
    log-probs and of its values (`side`, `ref`: each a pair [T, E, n, 1]),
    each against the reference's largest; `act` the larger of the two.
    A log-prob's gap grows as the inverse of the policy's smallest
    standard deviation, the values' does not."""
    out = {f"act_{k}": checks.widest_gap(p.to(r.device), r)
           for k, p, r in zip(("logp", "value"), side, ref)}
    return {"act": max(out.values()), **out}


def _params(learner) -> Dict[str, List[torch.Tensor]]:
    out = {"actor": [*learner.actor, learner.log_std], "critic": list(learner.critic)}
    if learner.tp is not None:
        out["tp"] = list(learner.tp)
    return {k: [l.detach().clone() for l in v] for k, v in out.items()}


def update_reference(learner, rollouts, dev, half: bool = False) -> Dict[str, Any]:
    """The learner's first STEPS minibatch steps on the program's first
    rollout and its TP steps on each rollout: the losses, the first
    clipped gradients, the parameters before and after."""
    before = _params(learner)
    first: Dict[str, Any] = {}
    r = rollouts[0]
    out = learner.train_op(program.tree_clone(r["traj"], dev), program.tree_clone(r["last_obs"], dev),
                           r["perms"].to(dev), half=half, first=first, max_steps=STEPS)
    after = _params(learner)
    losses = [pl + vl for pl, vl in out["steps"]]
    tp_losses = []
    if learner.tp is not None:
        tp_losses.append(out["TP_loss"])
        for r in rollouts[1:]:
            tp_losses.append(learner.tp_step(program.tree_clone(r["traj"], dev)))
        after["tp"] = [l.detach().clone() for l in learner.tp]
    grads = {"actor": first["actor"] + [first["log_std"]], "critic": first["critic"]}
    if learner.tp is not None:
        grads["tp"] = learner.first_tp
    return {"losses": losses, "tp_losses": tp_losses, "first": grads, "before": before,
            "after": after}


def program_update(cap: Capture, prog_after, layout) -> Dict[str, Any]:
    """The program's side of the same: its losses, its first gradients
    (from Adam's state after one step), its parameters after the steps."""
    first = {"actor": _split(cap.first["actor"][0], layout.actor()) + [cap.first["actor"][1]],
             "critic": _split(cap.first["critic"][0], layout.critic())}
    a = cap.after_steps
    after = {"actor": a["actor"] + a["log_std"], "critic": a["critic"]}
    if "tp" in cap.first:
        first["tp"] = cap.first["tp"]
        after["tp"] = prog_after["tp"]
    return {"losses": cap.mb_losses, "first": first, "after": after,
            "tp_losses": [r["metrics"]["TP_loss"] for r in cap.rollouts if "TP_loss" in r["metrics"]]}


def update_readings(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """`loss`: each step's loss (a minibatch's policy plus value loss; the
    TP loss), relative, and `first_loss` the first steps' alone; `grad`:
    the first clipped gradient's norm by leaf, the worst leaf's gap,
    `median_grad` the median leaf's and `group_grad` the largest of the
    parameter groups' median leaves' (actor with log_std, critic, TP);
    `change`, `median_change` and `group_change`: the same of the norm of
    each leaf's change over the steps.  The medians and `change` leave out
    the leaves whose first reference gradient is under a thousandth of the
    median leaf's (nought to rounding: Adam moves them by round-off
    alone).  A cell compares those its limits name."""
    pairs = list(zip(prog["losses"], ref["losses"])) + list(zip(prog["tp_losses"],
                                                                ref["tp_losses"]))
    if len(prog["losses"]) != len(ref["losses"]) or len(prog["tp_losses"]) != len(ref["tp_losses"]):
        return dict.fromkeys(UPDATE_NUMBERS, math.inf)
    gaps = [abs(p - r) / max(abs(r), 1e-12) for p, r in pairs]
    loss = max(gaps)
    first_loss = max(gaps[0], gaps[len(prog["losses"])] if prog["tp_losses"] else 0.0)
    g_p, g_r, c_p, c_r, groups = leaf_norms_of(prog, ref)
    med = sorted(g_r)[len(g_r) // 2]
    keep = [g >= 1e-3 * med for g in g_r]
    return {"loss": loss, "first_loss": first_loss, "grad": _update.gap_by_leaf(g_p, g_r),
            "median_grad": _update.median_gap(g_p, g_r, keep),
            "group_grad": _update.group_median_gap(g_p, g_r, groups, keep),
            "change": _update.gap_by_leaf(c_p, c_r, keep),
            "median_change": _update.median_gap(c_p, c_r, keep),
            "group_change": _update.group_median_gap(c_p, c_r, groups, keep)}


def leaf_norms_of(prog: Dict[str, Any], ref: Dict[str, Any]):
    """The norms by leaf, in the order of the reference's groups (actor
    with log_std last, critic, TP): the first clipped gradient's on each
    side, then the change's over the steps on each side; and each leaf's
    group."""
    keys = list(ref["first"])
    g_p = [n for k in keys for n in leaf_norms(prog["first"][k])]
    g_r = [n for k in keys for n in leaf_norms(ref["first"][k])]
    groups = [k for k in keys for _ in ref["first"][k]]
    c_p, c_r = [], []
    for k in keys:
        before = ref["before"][k]
        c_p += leaf_norms([a.to(b.device) - b for a, b in zip(prog["after"][k], before)])
        c_r += leaf_norms([a - b for a, b in zip(ref["after"][k], before)])
    return g_p, g_r, c_p, c_r, groups


def _split(flat: torch.Tensor, layout) -> List[torch.Tensor]:
    sizes = [nets.layout_size([l]) for l in layout]
    return [p.reshape(s) for p, (s, _) in zip(torch.split(flat, sizes), layout)]
