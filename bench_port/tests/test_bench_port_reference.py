"""The reference against the port at a tiny size on the CPU: its networks
against the port's plain versions, its frozen simulation against the
port's envs step for step."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from bench_port import program
from bench_port.reference import nets
from mupe_tpu_torch.envs import ENV_REGISTRY
from mupe_tpu_torch.learning.modules.networks import FlatHeadNet
from mupe_tpu_torch.ops import fused_encoder, tp_lstm

HNS = ((1, 35), (3, 5), (2, 3))


def _leaves(layout, seed):
    g = torch.Generator().manual_seed(seed)
    return nets.make_leaves(layout, torch.randn(nets.layout_size(layout), generator=g))


@pytest.mark.parametrize("head", [4, 1])
def test_encoder_matches_the_ports_plain_version(head):
    leaves = _leaves(nets.encoder_leaves(HNS, head), head)
    x = torch.randn(64, 56, generator=torch.Generator().manual_seed(7))
    spec = fused_encoder.EncoderSpec(groups=HNS, head_dim=head)
    exact = fused_encoder.reference_apply(spec, leaves, x, bf16=False)
    torch.testing.assert_close(nets.encoder(HNS, leaves, x, nets.exact), exact, rtol=1e-5,
                               atol=1e-5)
    port = fused_encoder.reference_apply(spec, leaves, x)
    gap = (nets.encoder(HNS, leaves, x, nets.bf16) - port).abs().max() / port.abs().max()
    assert gap < 1e-2


def test_tp_matches_the_ports_plain_version():
    leaves = _leaves(nets.tp_leaves(16, 15), 3)
    x = torch.randn(32, 10, 16, generator=torch.Generator().manual_seed(5))
    spec = tp_lstm.TPLSTMSpec(input_dim=16, hidden=64, t_steps=10, out_dim=15)
    torch.testing.assert_close(nets.tp(leaves, x, nets.bf16),
                               tp_lstm.reference_forward(spec, leaves, x), rtol=1e-5, atol=1e-5)


def test_flat_matches_the_ports_network():
    layout = nets.flat_leaves(20, (32, 32), 4)
    leaves = _leaves(layout, 9)
    x = torch.randn(2, 8, 1, 20, generator=torch.Generator().manual_seed(2))
    port = FlatHeadNet(20, (32, 32), 4, torch.bfloat16, leaves)(x)
    gap = (nets.flat((32, 32), leaves, x, nets.bf16) - port).abs().max() / port.abs().max()
    assert gap < 1e-2


def test_fp8_rounds_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    assert (nets.fp8(x) - x).abs().mean() > 4 * (nets.bf16(x) - x).abs().mean() > 0


@pytest.mark.parametrize("task,cfg", [
    ("HideAndSeek", {"num_envs": 8, "max_episode_length": 6}),
    ("HideAndSeek", {"num_envs": 8, "use_eval": True, "use_random_cylinder": False,
                     "scenario_flag": "wall"}),
    ("Hover", {"num_envs": 8, "max_episode_length": 5}),
])
def test_frozen_simulation_steps_as_the_port(task, cfg):
    port_env = ENV_REGISTRY[task](dataclasses.replace(ENV_REGISTRY[task].cfg_cls(), **cfg),
                                  device="cpu")
    ref_env = program.reference_env(task, port_env.cfg, "cpu")
    g1, g2 = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    s1, s2 = port_env.reset(g1), ref_env.reset(g2)
    tp = None
    if getattr(port_env, "provides_tp", False):
        tp_leaves = _leaves(nets.tp_leaves(port_env.cfg.tp_input_dim, 15), 4)
        tp = lambda h: nets.tp(tp_leaves, h, nets.bf16)  # noqa: E731
    args = (tp,) if tp is not None else ()
    actions = torch.randn(8, 8, port_env.num_agents, 4, generator=torch.Generator().manual_seed(3))
    for a in actions:   # past an episode's end: the auto-reset
        s1, t1 = port_env.step(s1, a, g1, *args)
        s2, t2 = ref_env.step(s2, a, g2, *args)
        for k in ("obs", "reward", "done"):
            v1, v2 = getattr(t1, k), getattr(t2, k)
            if isinstance(v1, dict):
                assert all(torch.equal(v1[n], v2[n]) for n in v1)
            else:
                assert torch.equal(v1, v2)
        assert all(torch.equal(t1.stats[n], t2.stats[n]) for n in t1.stats)
