"""Traffic kind `eval`: greedy evaluations back to back.

Set-up builds the env and the policy through `harness.build` with the
cell's evaluation overrides, the parameters from the seed, and the
evaluation program `harness._make_eval_prog`; it warms up with a reset and
`warmup_steps` greedy steps through the same env and policy calls.  The
window runs evaluation i = 0, 1, ... (`prog(ts, i)`: a reset from its own
seed and `max_episode_length` greedy steps), reads each one's stats to the
host, and starts no evaluation that the last one's time says would end
past `--seconds`; it runs at least `min_evals`.  With `--trace 1` one more
evaluation runs with `trace_steps` steps timed untraced from step
`trace_from` and as many traced after them.

The check: one evaluation of the window, drawn from the seed, runs again
with its reset, its steps at `check_steps` positions drawn from the seed
(the first and the last among them) and its greedy actions recorded.  The
reference then follows it from the program's states: the reset from the
same generator state, the greedy action from the same observation, the env
step from the same state and action, and from the last step the stat
means, which the window's result of that evaluation must equal.
"""
from __future__ import annotations

import math
import sys
import time
from typing import Any, Dict, List

import torch

from bench_port import checks, core, flops, program, tracing
from bench_port.reference import nets


def run(run: core.Run) -> core.Outcome:
    from mupe_tpu_torch import harness

    dev = run.device
    tr = run.traffic
    env, policy, env_cfg, algo_cfg = harness.build(run.config["task"], run.env_overrides(),
                                                   run.algo_overrides(), run.config["algo"], dev)
    layout = program.layout_of(env, policy)
    params = program.draw_parameters(layout, run.generator("params"), dev)
    ts = program.init_state(env, policy, params)
    del params
    eval_seed = run.sub_seed("eval") % (2 ** 31)
    prog = harness._make_eval_prog(env, policy, eval_seed)
    _warm_up(env, policy, ts, run.generator("warmup"), tr["warmup_steps"])
    _sync(dev)
    length = env.cfg.max_episode_length

    t0 = time.time()
    setup_s = t0 - run.t_start
    outs: List[Dict[str, float]] = []
    last = 0.0
    while len(outs) < tr["min_evals"] or (time.time() - t0) + last <= run.seconds:
        t_i = time.time()
        outs.append({k: float(v) for k, v in prog(ts, len(outs)).items()})
        last = time.time() - t_i
    wall = time.time() - t0
    n = len(outs)
    print(f"info: set-up {setup_s:.2f} s, evaluations {n}, the last {last:.3f} s", file=sys.stderr)
    failed = sum(not checks.finite(o.values()) for o in outs)
    e2e = {"eval_env_steps_per_s": n * env.shard.total * length / wall, "setup_s": setup_s}
    record = breakdown = None
    if run.trace:
        record, breakdown = _traced(run, env, policy, prog, ts, n, tr)
        model = {"groups": layout.groups, "action_dim": layout.action_dim,
                 "rows": env.shard.total * layout.n_agents, "arenas": env.shard.total,
                 "tp": None if layout.tp is None else
                 dict(in_dim=layout.tp[0], out=layout.tp[1], steps=env.cfg.history_step)}
        record.update(model=model, window={"evals": n, "steps": length, "wall_s": wall},
                      step_flops=step_flops(model))
    device = core.card_info(dev)
    i_check = int(torch.randint(0, n, (1,), generator=torch.Generator().manual_seed(
        run.sub_seed("which"))))
    rec = _recorded(run, env, policy, prog, ts, i_check, length, tr["check_steps"])
    del env, policy, ts, prog
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with torch.no_grad():
        got = readings(run, rec, outs[i_check], env_cfg, algo_cfg, layout)
    checks_ = [core.Check(k, got[k], limit) for k, limit in run.cell["limits"].items()]
    return core.Outcome(e2e=e2e, attempted=n, failed=failed, checks=checks_, device=device,
                        record=record, breakdown=breakdown)


def step_flops(m: Dict[str, Any]) -> float:
    """The operations a greedy step needs: the actor over every agent's
    row and the TP prediction (a greedy action needs no value)."""
    total = flops.encoder_flops(m["groups"], m["action_dim"], m["rows"])
    if m["tp"] is not None:
        tp = m["tp"]
        total += flops.tp_flops(tp["in_dim"], tp["steps"], tp["out"], m["arenas"])
    return float(total)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def _warm_up(env, policy, ts, gen, steps: int) -> None:
    """A reset and a few greedy steps through the calls an evaluation makes."""
    state = env.reset(gen)
    tp_net = ts.tp_net if policy.cfg.use_tp_net else None
    obs, _ = env.observe_full(state, tp_net)
    for _ in range(steps):
        action, _, _ = policy.act(ts, obs, deterministic=True)
        state, trn = env.step(state, action, gen, tp_net)
        obs = trn.obs


def _traced(run, env, policy, prog, ts, i: int, tr):
    """One more evaluation: `trace_steps` steps from `trace_from` timed
    untraced, then as many traced, the steps and acts annotated."""
    dev, k, s0 = run.device, tr["trace_steps"], tr["trace_from"]
    ann = tracing.Annotations()
    marks: Dict[str, float] = {}
    prof = tracing.profiler()
    count = [0]

    def boundary(c):
        """Before step c: the stretches start and end between steps."""
        if c in (s0, s0 + k, s0 + 2 * k):
            _sync(dev)
            marks[c] = time.time()
            if c == s0 + k:
                prof.start()
                ann.enter("eval")
            elif c == s0 + 2 * k:
                ann.close_all()
                prof.stop()

    def wrap_step(f):
        def step(*a, **kw):
            traced = s0 + k <= count[0] < s0 + 2 * k
            if traced:
                ann.enter("env_step")
            out = f(*a, **kw)
            if traced:
                ann.exit("env_step")
            count[0] += 1
            boundary(count[0])
            return out
        return step

    def wrap_act(f):
        def act(*a, **kw):
            traced = s0 + k <= count[0] < s0 + 2 * k
            if traced:
                ann.enter("act")
            out = f(*a, **kw)
            if traced:
                ann.exit("act")
            return out
        return act

    tracing.wrap(env, "step", wrap_step)
    tracing.wrap(policy, "act", wrap_act)
    try:
        prog(ts, i)
    finally:
        tracing.unwrap(env, "step")
        tracing.unwrap(policy, "act")
    trace = tracing.reduce_trace(prof)
    record = {"kind": "eval", "trace": trace, "steps_traced": k,
              "untraced_wall_s": marks[s0 + k] - marks[s0], "busy_s": trace["busy_s"],
              "window_s": marks[s0 + 2 * k] - marks[s0 + k]}
    return record, {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}


def _recorded(run, env, policy, prog, ts, i: int, length: int, n_steps: int) -> Dict[str, Any]:
    """Evaluation i again, with its reset, its greedy acts and its env
    steps at the drawn positions recorded."""
    pick = torch.Generator().manual_seed(run.sub_seed("eval_steps"))
    steps = {0, length - 1} | {int(s) for s in torch.randint(1, length - 1, (n_steps - 2,),
                                                             generator=pick)}
    rec: Dict[str, Any] = {"snaps": [], "acts": []}
    count = [0]

    def wrap_reset(f):
        def reset(gen):
            rec["reset_gen"] = gen.get_state()
            return f(gen)
        return reset

    def wrap_act(f):
        def act(ts_, obs, *a, **kw):
            out = f(ts_, obs, *a, **kw)
            if count[0] in steps:
                rec["acts"].append({"obs": program.tree_clone(obs, "cpu"),
                                    "action": out[0].detach().cpu()})
            if count[0] == 0:
                rec["first_obs"] = program.tree_clone(obs, "cpu")
            return out
        return act

    def wrap_step(f):
        def step(state, action, gen=None, *args):
            c = count[0]
            count[0] += 1
            if c not in steps:
                return f(state, action, gen, *args)
            before, gen_state = program.tree_clone(state), gen.get_state()
            out = f(state, action, gen, *args)
            tr = out[1]
            rec["snaps"].append({"state": program.tree_clone(before, "cpu"),
                                 "action": action.detach().cpu(), "gen": gen_state,
                                 "tp": bool(args), "last": c == length - 1, "progress": c,
                                 "out": program.tree_clone({"obs": tr.obs, "reward": tr.reward,
                                                            "done": tr.done, "stats": tr.stats},
                                                           "cpu")})
            return out
        return step

    tracing.wrap(env, "reset", wrap_reset)
    tracing.wrap(policy, "act", wrap_act)
    tracing.wrap(env, "step", wrap_step)
    try:
        rec["out"] = {k: float(v) for k, v in prog(ts, i).items()}
    finally:
        for obj, attr in ((env, "reset"), (policy, "act"), (env, "step")):
            tracing.unwrap(obj, attr)
    return rec


def readings(run, rec, window_out, env_cfg, algo_cfg, layout, control: bool = False) -> Dict[str, float]:
    """`env`: the reset and the recorded env steps; `act`: the greedy
    actions; `stats`: the window's result of that evaluation against the
    stat means the reference gives from its last step.  `control` puts
    in the program's place the reference in the lower precision: float8
    networks, states held in bfloat16."""
    dev = run.device
    params = program.draw_parameters(layout, run.generator("params"), dev)
    ref = program.reference_learner(layout, params, algo_cfg,
                                    nets.ROUNDING[program.rounding(algo_cfg)])
    ref_env = program.reference_env(run.config["task"], env_cfg, dev)
    tp_fn = checks.tp_function(ref) if ref.tp is not None else None
    env_gap = checks.reset_gap(rec["reset_gen"], program.tree_clone(rec["first_obs"], dev),
                               ref_env, tp_fn, dev, control)
    stats = math.inf
    for snap in rec["snaps"]:
        env_gap = max(env_gap, checks.env_step_gap(snap, ref_env, tp_fn, dev, control))
        if snap["last"]:
            got = (last_step_means(snap, ref_env, tp_fn, dev, control=True) if control
                   else window_out)
            stats = checks.stats_gap(got, last_step_means(snap, ref_env, tp_fn, dev))
    if control:
        ctrl = program.reference_learner(layout, params, algo_cfg, nets.fp8)
        act = max((checks.widest_gap(ctrl.mean(ctrl.obs_rows(o)), ref.mean(ref.obs_rows(o)))
                   for o in (program.tree_clone(a["obs"], dev) for a in rec["acts"])),
                  default=0.0)
    else:
        act = act_reading(rec["acts"], ref, dev)
    return {"env": env_gap, "act": act, "stats": stats}


@torch.no_grad()
def act_reading(acts, learner, dev) -> float:
    gap = 0.0
    for a in acts:
        obs = program.tree_clone(a["obs"], dev)
        gap = max(gap, checks.widest_gap(a["action"].to(dev), learner.mean(learner.obs_rows(obs))))
    return gap


def last_step_means(snap, ref_env, tp_fn, dev, control: bool = False) -> Dict[str, float]:
    """The evaluation's result from its last step, as the reference steps
    it: each stat's mean over the arenas whose episode ended there, and
    their count (`control`: from the state held in bfloat16)."""
    state = program.to_reference(program.tree_clone(snap["state"], dev),
                                 program.reference_classes())
    if control:
        state = checks.bf16_state(state)
    args = (tp_fn,) if snap["tp"] else ()
    _, tr = ref_env.step(state, snap["action"].to(dev), program.generator_like(snap["gen"], dev),
                         *args)
    done = tr.done.float()
    n = float(done.sum())
    out = {k: (float((v * done).sum()) / n if n else math.nan) for k, v in tr.stats.items()}
    out["episode_count"] = n
    return out
