"""Every HideAndSeek configuration inside the stated limits gets kernels.

The card runs the encoder and TP-LSTM kernels or raises; it never falls back
to a plain version.  So every observation and TP shape that an env
configuration can produce must pass the kernels' spec checks
(`fused_encoder.kernel_spec_ok`, `tp_lstm.kernel_spec_ok`), which the
wrappers raise through.  The shapes are derived as the policy derives them
(`MAPPOPolicy.specs` over the env's `obs_groups`; the TP net's input, its
window of `history_step` steps and its 3 * `future_prediction_step`
outputs), over:

* num_agents 2-8, obs_max_cylinder 1-14 with 1 + obs_max_cylinder +
  num_agents - 1 <= 16 tokens (the encoder kernels' limit);
* future_prediction_step 1-21 (the TP kernels' 64 outputs), history_step
  5-32;
* use_obstacles_tp and use_tp_net on and off.

Past 16 tokens the wrappers refuse with a message that names the limit.
And the widest 8-token configuration and a 16-token one train end to end on
the CPU (the plain versions), with the default update and with the agrad
mode of the in-kernel loss.
"""
import itertools

import pytest
import torch

from mupe_tpu_torch import harness
from mupe_tpu_torch.envs import HideAndSeek, HideAndSeekCfg
from mupe_tpu_torch.learning import MAPPOCfg, MAPPOPolicy
from mupe_tpu_torch.ops import fused_encoder as fe
from mupe_tpu_torch.ops import tp_lstm as tl

MAX_TOKENS = 16
PREDICTED = range(1, 22)
HISTORY = range(5, 33)


def _specs(env: HideAndSeek, use_tp_net: bool):
    """The actor's and critic's encoder specs, as the policy derives them."""
    pol = MAPPOPolicy(MAPPOCfg(use_tp_net=use_tp_net), n_agents=env.num_agents, action_dim=4,
                      obs_is_dict=True, tp_input_dim=env.cfg.tp_input_dim, device="cpu")
    _, spec_a, spec_c = pol.specs({k: torch.zeros((1,) + s) for k, s in env.obs_groups().items()})
    return spec_a, spec_c


@pytest.mark.parametrize("num_agents", [2, 3, 4, 5, 6, 7, 8])
def test_every_configuration_inside_the_limits_passes_every_spec_check(num_agents):
    checked = 0
    for n_cyl, use_tp in itertools.product(range(1, 15), (False, True)):
        if 1 + n_cyl + num_agents - 1 > MAX_TOKENS:
            continue
        for fps in PREDICTED if use_tp else (5,):
            env = HideAndSeek(HideAndSeekCfg(num_envs=1, num_agents=num_agents,
                                             obs_max_cylinder=n_cyl, future_prediction_step=fps,
                                             use_tp_net=use_tp), device="cpu")
            for spec in _specs(env, use_tp):
                assert spec.n_tokens <= MAX_TOKENS
                assert fe.kernel_spec_ok(spec), spec
                checked += 1
            for hist, obstacles in itertools.product(HISTORY, (False, True)):
                cfg = HideAndSeekCfg(num_agents=num_agents, future_prediction_step=fps,
                                     history_step=hist, use_obstacles_tp=obstacles)
                tspec = tl.TPLSTMSpec(input_dim=cfg.tp_input_dim, hidden=64, t_steps=hist,
                                      out_dim=3 * fps)
                assert tl.kernel_spec_ok(tspec), tspec
                checked += 1
    assert checked > 0


def test_more_than_eight_tokens_is_refused_naming_the_limit():
    """The limit is 16 tokens: obs_max_cylinder=5 with 4 pursuers (1 + 5 +
    3 = 9 tokens) passes, obs_max_cylinder=11 with 6 pursuers (1 + 11 + 5 =
    17) is refused with a message that names the limit."""
    env = HideAndSeek(HideAndSeekCfg(num_envs=1, num_agents=4, obs_max_cylinder=5), device="cpu")
    spec_a, spec_c = _specs(env, True)
    assert spec_a.n_tokens == 9 and fe.kernel_spec_ok(spec_a) and fe.kernel_spec_ok(spec_c)
    env = HideAndSeek(HideAndSeekCfg(num_envs=1, num_agents=6, obs_max_cylinder=11), device="cpu")
    spec_a, spec_c = _specs(env, True)
    assert spec_a.n_tokens == 17 and not fe.kernel_spec_ok(spec_a)
    with pytest.raises(ValueError, match="at most 16 tokens"):
        fe._check_spec(spec_a)


@pytest.mark.parametrize("field,value", [("input_dim", 65), ("t_steps", 33), ("out_dim", 65),
                                         ("hidden", 32)])
def test_tp_spec_check_names_each_limit(field, value):
    spec = tl.TPLSTMSpec(input_dim=64, hidden=64, t_steps=32, out_dim=64)
    assert tl.kernel_spec_ok(spec)
    bad = tl.TPLSTMSpec(**{**spec.__dict__, field: value})
    assert not tl.kernel_spec_ok(bad)
    with pytest.raises(ValueError, match="at most 64 inputs, 32 steps, 64 outputs"):
        tl._check_spec(bad)


def test_encoder_spec_check_edges():
    assert fe.kernel_spec_ok(fe.EncoderSpec(groups=((1, 128),), head_dim=8))
    assert fe.kernel_spec_ok(fe.EncoderSpec(groups=((1, 50), (4, 5), (3, 3)), head_dim=4))
    assert fe.kernel_spec_ok(fe.EncoderSpec(groups=((2, 16), (2, 16), (2, 16), (2, 16)),
                                            head_dim=1))
    assert fe.kernel_spec_ok(fe.EncoderSpec(groups=((1, 83), (14, 5), (1, 3)), head_dim=4))
    assert fe.kernel_spec_ok(fe.EncoderSpec(groups=((16, 10),), head_dim=1))  # 160 columns
    assert fe.kernel_spec_ok(fe.EncoderSpec(groups=((1, 128), (1, 32)), head_dim=1))
    for spec in (fe.EncoderSpec(groups=((1, 129),), head_dim=1),       # a 129-wide group
                 fe.EncoderSpec(groups=((1, 128), (1, 33)), head_dim=1),  # 161 columns
                 fe.EncoderSpec(groups=((1, 8),) * 5, head_dim=1),     # 5 groups
                 fe.EncoderSpec(groups=((17, 3),), head_dim=1),        # 17 tokens
                 fe.EncoderSpec(groups=((1, 1), (1, 113), (1, 1)), head_dim=1),  # 3 weight slots
                 fe.EncoderSpec(groups=((1, 8),), head_dim=9),         # a head of 9
                 fe.EncoderSpec(groups=((1, 8),), head_dim=1, embed_dim=64)):
        assert not fe.kernel_spec_ok(spec), spec


@pytest.mark.parametrize("extra", [[], ["algo.use_inkernel_loss=true", "algo.direct_mode=agrad"]],
                         ids=["default", "agrad"])
def test_the_widest_configuration_trains_on_the_cpu(tmp_path, extra):
    """8 tokens, state_self 50 wide, TP input 34 over 17 steps, TP output
    30: one training iteration through the entry point, finite metrics."""
    argv = ["env.num_envs=8", "env.num_agents=4", "env.obs_max_cylinder=4",
            "env.future_prediction_step=10", "env.use_obstacles_tp=true", "env.history_step=17",
            "algo.train_every=16", "algo.num_minibatches=2", "algo.ppo_epochs=1", "max_iters=1",
            "log_interval=1", "save_interval=-1", f"run_dir={tmp_path}", "run_name=wide",
            "seed=1", *extra]
    env, policy, env_cfg, _ = harness.build(
        "HideAndSeek", {"num_agents": 4, "obs_max_cylinder": 4, "future_prediction_step": 10,
                        "use_obstacles_tp": True, "history_step": 17}, device="cpu")
    spec_a, _ = _specs(env, True)
    assert spec_a.n_tokens == 8 and spec_a.groups[0] == (1, 50)
    ts = policy.init({k: torch.zeros((1,) + s) for k, s in env.obs_groups().items()},
                     torch.Generator().manual_seed(0))
    assert ts.tp_net.spec == tl.TPLSTMSpec(input_dim=34, hidden=64, t_steps=17, out_dim=30)
    assert env_cfg.tp_input_dim == 34
    metrics = harness.train(argv, default_task="HideAndSeek", device="cpu")
    assert all(torch.isfinite(torch.as_tensor(float(v))) for v in metrics.values())
    assert "TP_loss" in metrics


@pytest.mark.parametrize("extra", [[], ["algo.use_inkernel_loss=true", "algo.direct_mode=agrad"]],
                         ids=["default", "agrad"])
def test_a_sixteen_token_configuration_trains_on_the_cpu(tmp_path, extra):
    """6 pursuers and 10 cylinder tokens (1 + 10 + 5 = 16 tokens, the
    kernels' limit), 21 predicted steps (state_self 83 wide, TP output 63):
    one training iteration through the entry point, finite metrics."""
    env_kw = {"num_agents": 6, "obs_max_cylinder": 10, "future_prediction_step": 21}
    argv = ["env.num_envs=4", "env.num_agents=6", "env.obs_max_cylinder=10",
            "env.future_prediction_step=21", "algo.train_every=24", "algo.num_minibatches=2",
            "algo.ppo_epochs=1", "max_iters=1", "log_interval=1", "save_interval=-1",
            f"run_dir={tmp_path}", "run_name=tok16", "seed=2", *extra]
    env, policy, env_cfg, _ = harness.build("HideAndSeek", env_kw, device="cpu")
    spec_a, spec_c = _specs(env, True)
    assert spec_a.n_tokens == 16 and spec_a.obs_dim > 128 and fe.kernel_spec_ok(spec_a)
    ts = policy.init({k: torch.zeros((1,) + s) for k, s in env.obs_groups().items()},
                     torch.Generator().manual_seed(0))
    assert ts.tp_net.spec.out_dim == 63 and tl.kernel_spec_ok(ts.tp_net.spec)
    metrics = harness.train(argv, default_task="HideAndSeek", device="cpu")
    assert all(torch.isfinite(torch.as_tensor(float(v))) for v in metrics.values())
    assert "TP_loss" in metrics
