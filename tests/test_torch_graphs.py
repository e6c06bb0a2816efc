"""CUDA graphs of the rollout step (`mupe_tpu_torch/utils/graphs.py`).

On the CPU every graphed site (`MAPPOPolicy.act`, `HideAndSeek.step`'s two
segments) runs eagerly, and the two host reads the step had are gone: the
device-built `quat_axis` basis and the off-diagonal index gather give the
old bits.  On a card a graphed rollout gives the eager segments' bits, with
the generator where eager code leaves it:

    python -m pytest tests/test_torch_graphs.py -m gpu --noconftest -q

This file imports no JAX, so it runs on a card without the conftest.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch
from torch import nn

from mupe_tpu_torch import harness
from mupe_tpu_torch.core import quat_axis, quat_normalize, quat_rotate
from mupe_tpu_torch.envs import HideAndSeek
from mupe_tpu_torch.envs.hideandseek import HideAndSeekCfg
from mupe_tpu_torch.learning import init_carry, make_rollout
from mupe_tpu_torch.utils import graphs, trace

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]


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


def _equal(a, b) -> bool:
    """The same structure and the same bits in every tensor."""
    la, sa = graphs.flatten(a)
    lb, sb = graphs.flatten(b)
    return sa == sb and len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def _clone(tree):
    leaves, spec = graphs.flatten(tree)
    return graphs.unflatten(spec, [t.clone() for t in leaves])


# ------------------------------------------------------------ the host reads
def _quat_axis_host_copy(q: torch.Tensor, axis: int) -> torch.Tensor:
    """`quat_axis` as it was: the basis's 1.0 copied from the host."""
    basis = torch.zeros(3, dtype=q.dtype, device=q.device)
    basis[axis] = 1.0
    return quat_rotate(q, basis.expand(q.shape[:-1] + (3,)))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_quat_axis_basis_gives_the_host_copys_bits(device, axis):
    dev = _device(device)
    g = torch.Generator().manual_seed(axis)
    q = quat_normalize(torch.randn((4096, 3, 4), generator=g)).to(dev)
    assert torch.equal(_bits(quat_axis(q, axis)), _bits(_quat_axis_host_copy(q, axis)))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("n", [2, 3, 4])
def test_offdiag_gather_gives_the_boolean_masks_bits(device, n):
    dev = _device(device)
    env = HideAndSeek(HideAndSeekCfg(num_envs=4, num_agents=n), device=dev)
    rel = torch.randn((64, n, n, 3), generator=torch.Generator().manual_seed(n)).to(dev)
    mask = ~torch.eye(n, dtype=torch.bool, device=dev)
    assert torch.equal(_bits(rel[:, env._offdiag[0], env._offdiag[1]]), _bits(rel[:, mask]))


# ------------------------------------------------------------ on the CPU
@pytest.mark.parametrize("task, per_step", [("HideAndSeek", 3), ("Hover", 1)])
def test_the_sites_run_eagerly_on_the_cpu(task, per_step):
    """Act (both tasks) and HideAndSeek's two segments: one `graph.eager`
    span a call, no capture, no graph kept."""
    env, pol, _, _ = harness.build(task, {"num_envs": 4, "max_episode_length": 5},
                                   {"train_every": 3}, device="cpu")
    carry = init_carry(env, pol, torch.Generator().manual_seed(0))
    before = trace.counts().copy()
    make_rollout(env, pol)(carry, steps=3)
    delta = trace.counts() - before
    assert delta["graph.eager"] == 3 * per_step
    assert delta["graph.replay"] == 0 and delta["graph.capture"] == 0
    sites = [pol._act_graph] + ([env._graph_a, env._graph_b] if task == "HideAndSeek" else [])
    assert all(not site.graphs for site in sites)


def test_a_site_hands_back_the_eager_outputs_off_the_card():
    site = graphs.Graphed()
    x, y = torch.ones(3), torch.zeros(2)
    with torch.no_grad():
        out = site(lambda a, b: {"a": a, "sum": a + 1.0, "b": (b, None)}, x, y)
    assert out["a"] is x and out["b"][0] is y and out["b"][1] is None
    assert torch.equal(out["sum"], x + 1.0) and not site.graphs


def test_flatten_round_trips_a_state_and_its_transition():
    env = HideAndSeek(HideAndSeekCfg(num_envs=4), device="cpu")
    state = env.reset(torch.Generator().manual_seed(1))
    leaves, spec = graphs.flatten((state, {"k": (None, 3, state.progress)}))
    back_state, back_extra = graphs.unflatten(spec, leaves)
    assert type(back_state) is type(state) and back_state.gen is None
    assert back_state.drone.pos is state.drone.pos and back_extra["k"][:2] == (None, 3)
    assert back_extra["k"][2] is state.progress
    assert list(back_state.stats) == list(state.stats)
    assert graphs.flatten((back_state, back_extra))[1] == spec


def _reader(name: str):
    path = Path(__file__).resolve().parents[1] / "bench_port" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_replay_share_reads_the_rollouts_graph_spans(monkeypatch):
    read = _reader("graph_replay_share.train").read
    roll = ("train.iter", "rollout")

    def rec(name, path, ms=1.0):
        return {"name": name, "path": path, "device_ms": ms, "host_ms": 1.0}

    recs = [rec("train.iter", ()), rec("rollout", roll[:1])]
    recs += [rec("graph.replay", roll + ("policy.act",)), rec("graph.replay", roll + ("env.step",)),
             rec("graph.replay", roll + ("env.step",)), rec("graph.eager", roll + ("env.step",)),
             rec("graph.replay", ("eval.episode", "policy.act"))]
    monkeypatch.setattr(trace, "recorded", lambda: recs)
    assert read({}) == 0.75
    monkeypatch.setattr(trace, "recorded", lambda: [r for r in recs if r["name"] != "graph.replay"
                                                    and r["name"] != "graph.eager"])
    assert read({}) is None
    monkeypatch.setattr(trace, "recorded", lambda: [dict(r, device_ms=None) for r in recs])
    assert read({}) is None


# ------------------------------------------------------------ on a card
def _eager(fn, *args, generators=(), **_):
    """A graphed site's eager twin: the function itself."""
    with trace.span("graph.eager"):
        return fn(*generators, *args)


@contextlib.contextmanager
def _eager_sites(env, policy):
    saved = env._graph_a, env._graph_b, policy._act_graph
    env._graph_a = env._graph_b = policy._act_graph = _eager
    try:
        yield
    finally:
        env._graph_a, env._graph_b, policy._act_graph = saved


def _build(dev, task="HideAndSeek", **env_kw):
    env_kw = {"num_envs": 64, "max_episode_length": 6, **env_kw}
    env, pol, _, _ = harness.build(task, env_kw, {"train_every": 8}, device=dev)
    return env, pol, init_carry(env, pol, torch.Generator(device=dev).manual_seed(0))


def _twin_gen(gen: torch.Generator) -> torch.Generator:
    twin = torch.Generator(device=gen.device)
    twin.set_state(gen.get_state())
    return twin


def _twin(carry):
    """The carry's values and generator state, in tensors of its own."""
    return dataclasses.replace(carry, env_state=_clone(carry.env_state), obs=_clone(carry.obs),
                               state=_clone(carry.state), generator=_twin_gen(carry.generator))


def _rollouts(env, pol, carry, steps):
    """(the graphed rollout's outputs, the eager segments') from twins."""
    rollout = make_rollout(env, pol)
    a, b = _twin(carry), _twin(carry)
    out_a = rollout(a, steps=steps)
    with _eager_sites(env, pol):
        out_b = rollout(b, steps=steps)
    return out_a, out_b


@pytest.mark.gpu
def test_a_graphed_rollout_gives_the_eager_segments_bits(cuda):
    """2 x 8 steps at 64 arenas with 6-step episodes (two resets inside):
    every trajectory tensor, the carry and the episode stats are the same
    bits, and the generator is where the eager rollout leaves it."""
    env, pol, carry = _build(cuda)
    (ca, traj_a, st_a), (cb, traj_b, st_b) = _rollouts(env, pol, carry, 16)
    assert _equal(traj_a, traj_b) and _equal(st_a, st_b)
    assert _equal((ca.env_state, ca.obs), (cb.env_state, cb.obs))
    assert torch.equal(ca.generator.get_state(), cb.generator.get_state())
    assert all(len(site.graphs) == 1 for site in (pol._act_graph, env._graph_a, env._graph_b))


@pytest.mark.gpu
def test_replays_read_parameters_changed_in_place_and_replaced(cuda):
    env, pol, carry = _build(cuda)
    ts, obs = carry.ts, carry.obs

    def same():
        ga, gb = _twin_gen(carry.generator), _twin_gen(carry.generator)
        with torch.no_grad():
            graphed = pol.act(ts, obs, ga)
            eager = pol._act(ts, False, gb, obs, None, None)
        return _equal(graphed, eager) and torch.equal(ga.get_state(), gb.get_state())

    assert same() and len(pol._act_graph.graphs) == 1
    with torch.no_grad():
        ts.actor.flat.mul_(0.5)
        ts.log_std.add_(0.25)
    assert same() and len(pol._act_graph.graphs) == 1
    ts.critic.flat = nn.Parameter(ts.critic.flat.detach() * 2.0)
    assert same() and len(pol._act_graph.graphs) == 2


@pytest.mark.gpu
def test_a_state_where_half_the_arenas_end_resets_as_eager_code_does(cuda):
    """The benchmark's check: after an ordinary step, a copy of the state
    in which every other arena ends its episode goes through the copy-in
    path and resets those arenas."""
    env, pol, carry = _build(cuda, max_episode_length=800)
    tp = carry.ts.tp_net
    with torch.no_grad():
        action, _, _ = pol.act(carry.ts, carry.obs, deterministic=True)
    env.step(_clone(carry.env_state), action, _twin_gen(carry.generator), tp)
    state = _clone(carry.env_state)
    state.progress[::2] = env.cfg.max_episode_length - 1
    ga, gb = _twin_gen(carry.generator), _twin_gen(carry.generator)
    graphed = env.step(_clone(state), action, ga, tp)
    with _eager_sites(env, pol):
        eager = env.step(_clone(state), action, gb, tp)
    assert _equal(graphed, eager) and torch.equal(ga.get_state(), gb.get_state())
    assert not graphed[0].progress[::2].any() and bool((graphed[0].progress[1::2] == 1).all())
    assert len(env._graph_a.graphs) == 1 and len(env._graph_b.graphs) == 1


@pytest.mark.gpu
def test_an_aeg_env_steps_through_a_closed_reset(cuda):
    """The AEG env inherits the step: 4 episodes of 8 steps at 1,024
    arenas close an evaluation cycle (3 episodes) in its reset hook; the
    graphed rollout and the eager one agree, the task buffer too."""
    env, pol, carry = _build(cuda, "HideAndSeek_envgen", num_envs=1024, max_episode_length=8,
                             buffer_length=256, use_init_easy_cases=True, r_min=0.0)
    (ca, traj_a, st_a), (cb, traj_b, st_b) = _rollouts(env, pol, carry, 32)
    assert _equal(traj_a, traj_b) and _equal(st_a, st_b)
    assert _equal(ca.env_state, cb.env_state)
    assert torch.equal(ca.generator.get_state(), cb.generator.get_state())
    assert int(ca.env_state.gen.update_iter) < 3  # the cycle closed and restarted


@pytest.mark.gpu
def test_counts_after_replays_are_the_eager_counts(cuda):
    env, pol, carry = _build(cuda)
    rollout = make_rollout(env, pol)
    rollout(_twin(carry), steps=2)  # the captures

    def counted(run):
        before = trace.counts().copy()
        run()
        return {k: v for k, v in (trace.counts() - before).items() if not k.startswith("graph.")}

    graphed = counted(lambda: rollout(_twin(carry), steps=8))
    with _eager_sites(env, pol):
        eager = counted(lambda: rollout(_twin(carry), steps=8))
    assert graphed == eager
    assert graphed["kernel.pair_fwd"] == 8 and graphed["kernel.tp_fwd"] == 8
    assert graphed["env.reset"] == 1
