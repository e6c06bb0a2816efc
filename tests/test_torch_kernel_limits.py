"""Every HideAndSeek configuration gets kernels.

The card runs the encoder and TP-LSTM kernels or raises; it never falls back
to a plain version.  So every observation and TP shape that an env
configuration can produce must pass the kernels' spec checks
(`fused_encoder.kernel_spec_ok`, `tp_lstm.kernel_spec_ok`), which the
wrappers raise through.  Those keep only the widths the policy fixes: embed
and feed-forward width 128, 1-4 token groups and a head of 1-8 outputs for
the encoder, hidden width 64 for the TP net; any number of tokens, columns,
group width, TP inputs, steps and outputs passes (past the tile instances
the kernels stream the tokens, past the register instances the TP tile
loops its k-tiles and output passes).  The shapes are derived as the policy
derives them (`MAPPOPolicy.specs` over the env's `obs_groups`; the TP net's
input, its window of `history_step` steps and its 3 *
`future_prediction_step` outputs), over:

* num_agents 2-12, obs_max_cylinder 1-24 (up to 36 tokens);
* future_prediction_step 1-45 (`state_self` up to 155 wide, 135 TP
  outputs), history_step 5-48;
* use_obstacles_tp with max_cylinders up to 24 (TP input up to 118), and
  use_tp_net on and off.

A spec of another embed width or a head of 9 is refused with a message that
names the limit.  Every AEG pool (buffer_length + num_envs tasks of
task_dim, downsampled to buffer_length by FPS) passes `fps.kernel_spec_ok`
and runs the FPS instance that PERF.md states.

The widest 8-token configuration, a 16-token one and one
past every limit of the tile instances (28 tokens over 261 columns,
`state_self` 140 wide, TP input 91 over 40 steps, 120 outputs) train end to
end on the CPU (the plain versions), with the default update and with the
agrad mode of the in-kernel loss.
"""
import itertools

import pytest
import torch

from mupe_tpu_torch import harness
from mupe_tpu_torch.envs import HideAndSeek, HideAndSeekCfg
from mupe_tpu_torch.envs.hideandseek_envgen import HideAndSeekEnvgenCfg
from mupe_tpu_torch.learning import MAPPOCfg, MAPPOPolicy
from mupe_tpu_torch.ops import fps
from mupe_tpu_torch.ops import fused_encoder as fe
from mupe_tpu_torch.ops import tp_lstm as tl

PREDICTED = range(1, 46)
HISTORY = range(5, 49)


def _specs(env: HideAndSeek, use_tp_net: bool):
    """The actor's and critic's encoder specs, as the policy derives them."""
    pol = MAPPOPolicy(MAPPOCfg(use_tp_net=use_tp_net), n_agents=env.num_agents, action_dim=4,
                      obs_is_dict=True, tp_input_dim=env.cfg.tp_input_dim, device="cpu")
    _, spec_a, spec_c = pol.specs({k: torch.zeros((1,) + s) for k, s in env.obs_groups().items()})
    return spec_a, spec_c


@pytest.mark.parametrize("num_agents", [2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12])
def test_every_configuration_inside_the_limits_passes_every_spec_check(num_agents):
    checked = 0
    for n_cyl, use_tp in itertools.product(range(1, 25), (False, True)):
        for fps in PREDICTED if use_tp else (5,):
            env = HideAndSeek(HideAndSeekCfg(num_envs=1, num_agents=num_agents,
                                             obs_max_cylinder=n_cyl, max_cylinders=n_cyl,
                                             future_prediction_step=fps, use_tp_net=use_tp),
                              device="cpu")
            for spec in _specs(env, use_tp):
                assert spec.n_tokens == num_agents + n_cyl
                assert fe.kernel_spec_ok(spec), spec
                checked += 1
    for fps, hist, obstacles, n_cyl in itertools.product(PREDICTED, HISTORY, (False, True),
                                                          (5, 24)):
        cfg = HideAndSeekCfg(num_agents=num_agents, future_prediction_step=fps,
                             history_step=hist, use_obstacles_tp=obstacles, max_cylinders=n_cyl)
        tspec = tl.TPLSTMSpec(input_dim=cfg.tp_input_dim, hidden=64, t_steps=hist,
                              out_dim=3 * fps)
        assert tl.kernel_spec_ok(tspec), tspec
        checked += 1
    assert checked > 0


def test_more_than_eight_tokens_is_refused_naming_the_limit():
    """No token or column limit is left: 9 tokens (obs_max_cylinder=5 with 4
    pursuers) and 17 (obs_max_cylinder=11 with 6 pursuers) pass, and so do
    28 tokens, 64 tokens and 300 columns (the last three past the tile
    instances); another embed width or a head of 9 is refused with a message
    that names the limit."""
    env = HideAndSeek(HideAndSeekCfg(num_envs=1, num_agents=4, obs_max_cylinder=5), device="cpu")
    spec_a, spec_c = _specs(env, True)
    assert spec_a.n_tokens == 9 and fe.kernel_spec_ok(spec_a) and fe.kernel_spec_ok(spec_c)
    assert fe.tile_spec_ok(spec_a)
    env = HideAndSeek(HideAndSeekCfg(num_envs=1, num_agents=6, obs_max_cylinder=11), device="cpu")
    spec_a, spec_c = _specs(env, True)
    assert spec_a.n_tokens == 17 and fe.kernel_spec_ok(spec_a) and fe.kernel_spec_ok(spec_c)
    for groups in (((1, 140), (20, 5), (7, 3)), ((1, 35), (48, 5), (15, 3)), ((1, 300),)):
        spec = fe.EncoderSpec(groups=groups, head_dim=4)
        assert fe.kernel_spec_ok(spec) and not fe.tile_spec_ok(spec), spec
        fe._check_spec(spec)
    assert fe.EncoderSpec(groups=((1, 35), (48, 5), (15, 3)), head_dim=4).n_tokens == 64
    for spec in (fe.EncoderSpec(groups=((1, 8),), head_dim=1, embed_dim=64),
                 fe.EncoderSpec(groups=((1, 8),), head_dim=9)):
        assert not fe.kernel_spec_ok(spec)
        with pytest.raises(ValueError, match="embed_dim = ff_dim = 128, 1-4 token groups, a "
                                             "head of 1-8 outputs"):
            fe._check_spec(spec)


@pytest.mark.parametrize("field,value", [("input_dim", 65), ("t_steps", 33), ("out_dim", 65),
                                         ("hidden", 32)])
def test_tp_spec_check_names_each_limit(field, value):
    """Inputs, steps and outputs past the register instances' 64 / 32 / 64
    pass (the generic instance); the hidden width is the one limit, and each
    of the others must be at least 1: refused naming it."""
    spec = tl.TPLSTMSpec(input_dim=64, hidden=64, t_steps=32, out_dim=64)
    assert tl.kernel_spec_ok(spec) and tl.register_spec_ok(spec)
    past = tl.TPLSTMSpec(**{**spec.__dict__, field: value})
    bad = past if field == "hidden" else tl.TPLSTMSpec(**{**spec.__dict__, field: 0})
    if field != "hidden":
        assert tl.kernel_spec_ok(past)
        tl._check_spec(past)
    assert not tl.kernel_spec_ok(bad)
    with pytest.raises(ValueError, match="hidden 64, at least one input, step and output"):
        tl._check_spec(bad)


def test_encoder_spec_check_edges():
    """The tile instances' edges (`tile_spec_ok`) and past them the streamed
    instance (`kernel_spec_ok` only); 5 groups, a head of 9 and another
    embed width are refused."""
    for groups, head in ((((1, 128),), 8), (((1, 50), (4, 5), (3, 3)), 4),
                         (((2, 16), (2, 16), (2, 16), (2, 16)), 1),
                         (((1, 83), (14, 5), (1, 3)), 4),
                         (((16, 10),), 1),  # 160 columns
                         (((1, 128), (1, 32)), 1)):
        spec = fe.EncoderSpec(groups=groups, head_dim=head)
        assert fe.kernel_spec_ok(spec) and fe.tile_spec_ok(spec), spec
    for spec in (fe.EncoderSpec(groups=((1, 129),), head_dim=1),       # a 129-wide group
                 fe.EncoderSpec(groups=((1, 128), (1, 33)), head_dim=1),  # 161 columns
                 fe.EncoderSpec(groups=((17, 3),), head_dim=1),        # 17 tokens
                 fe.EncoderSpec(groups=((1, 1), (1, 113), (1, 1)), head_dim=1)):  # 3 slots
        assert fe.kernel_spec_ok(spec) and not fe.tile_spec_ok(spec), spec
    for spec in (fe.EncoderSpec(groups=((1, 8),) * 5, head_dim=1),     # 5 groups
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


@pytest.mark.parametrize("extra", [[], ["algo.use_inkernel_loss=true", "algo.direct_mode=agrad"]],
                         ids=["default", "agrad"])
def test_a_configuration_past_every_tile_limit_trains_on_the_cpu(tmp_path, extra):
    """chip_smoke.py phase 9's configuration: 8 pursuers, 20 cylinders all
    observed, 40 predicted steps, a 40-step history, the obstacles in the TP
    input (28 tokens over 261 columns, state_self 140 wide; TP input 91, 40
    steps, 120 outputs): one training iteration through the entry point,
    finite metrics."""
    env_kw = {"num_agents": 8, "max_cylinders": 20, "obs_max_cylinder": 20,
              "future_prediction_step": 40, "history_step": 40, "use_obstacles_tp": True}
    argv = ["env.num_envs=2", *(f"env.{k}={str(v).lower()}" for k, v in env_kw.items()),
            "algo.train_every=44", "algo.num_minibatches=2", "algo.ppo_epochs=1", "max_iters=1",
            "log_interval=1", "save_interval=-1", f"run_dir={tmp_path}", "run_name=limit",
            "seed=3", *extra]
    env, policy, env_cfg, _ = harness.build("HideAndSeek", env_kw, device="cpu")
    spec_a, _ = _specs(env, True)
    assert spec_a.groups == ((1, 140), (20, 5), (7, 3)) and spec_a.obs_dim == 261
    assert fe.kernel_spec_ok(spec_a) and not fe.tile_spec_ok(spec_a)
    ts = policy.init({k: torch.zeros((1,) + s) for k, s in env.obs_groups().items()},
                     torch.Generator().manual_seed(0))
    assert ts.tp_net.spec == tl.TPLSTMSpec(input_dim=91, hidden=64, t_steps=40, out_dim=120)
    assert not tl.register_spec_ok(ts.tp_net.spec)
    metrics = harness.train(argv, default_task="HideAndSeek", device="cpu")
    assert all(torch.isfinite(torch.as_tensor(float(v))) for v in metrics.values())
    assert "TP_loss" in metrics


AEG_NUM_ENVS = (1, 2, 1023, 1024, 4096, 45_000, 49_152, 65_535, 65_536)
AEG_BUFFERS = (1, 2, 1000, 4999, 5000, 5001, 19_999, 20_000)


def _fps_instance(n, d, c):
    """The FPS instance as PERF.md states it: a block holds ceil(N / C) rows
    of D padded to float4s (d4), at a stride of d4 (+ 4 where d4 is a
    multiple of 8), each with its running min, beside 4 + 2 C (4 + d4) + d4
    + 128 floats of exchange buffers; "resident" where that fits 232,448
    bytes, "registers" where it fits, D <= 32 and ceil(N / C) <= 1,024,
    else "streamed"."""
    rows, d4 = -(-n // c), -(-d // 4) * 4
    stride = d4 + 4 if d4 % 8 == 0 else d4
    if 4 * (4 + 2 * c * (4 + d4) + d4 + 128 + rows * (stride + 1)) > 232_448:
        return "streamed"
    return "registers" if d <= 32 and rows <= 1024 else "resident"


@pytest.mark.parametrize("num_agents", [2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12])
def test_every_aeg_pool_passes_the_fps_spec_check(num_agents):
    """The AEG downsamples buffer_length + num_envs tasks of task_dim = 3
    num_agents + 3 + 3 max_cylinders (up to 111) to buffer_length
    (`genbuffer.update_history`): num_envs 1-65,536 and buffer_length
    1-20,000 at their edges, max_cylinders 0-24.  Each pool passes the
    kernel's spec check (no row limit below 2^20 any more) and takes the
    instance PERF.md states at either cluster size."""
    checked = 0
    for n_cyl in range(0, 25):
        d = HideAndSeekEnvgenCfg(num_agents=num_agents, max_cylinders=n_cyl).task_dim
        assert d == 3 * num_agents + 3 + 3 * n_cyl
        for e, b in itertools.product(AEG_NUM_ENVS, AEG_BUFFERS):
            assert fps.kernel_spec_ok(b + e, d, b), (b + e, d, b)
            for c in fps.CLUSTERS:
                assert fps.instance(b + e, d, c) == _fps_instance(b + e, d, c), (b + e, d, c)
            checked += 1
    assert checked == 25 * len(AEG_NUM_ENVS) * len(AEG_BUFFERS)


def test_fps_instance_edges_and_limits():
    """The instances' edges at the AEG's task width (D = 27) and phase 9's
    (D = 87); the largest pool of the enumeration; past D = 1,024, K > N or
    N > 2^20 the check refuses, naming the limit."""
    for n, d, c, inst in ((9_096, 27, 16, "registers"), (16_384, 27, 16, "registers"),
                          (16_385, 27, 16, "resident"), (31_408, 27, 16, "resident"),
                          (31_409, 27, 16, "streamed"), (8_192, 27, 8, "registers"),
                          (15_840, 27, 8, "resident"), (15_841, 27, 8, "streamed"),
                          (49_153, 27, 16, "streamed"), (9_096, 87, 16, "resident"),
                          (9_096, 87, 8, "streamed"), (9_096, 33, 16, "resident"),
                          (85_536, 111, 16, "streamed"), (1 << 20, 1024, 16, "streamed")):
        assert fps.instance(n, d, c) == inst == _fps_instance(n, d, c), (n, d, c)
    assert fps.kernel_spec_ok(85_536, 111, 20_000) and fps.kernel_spec_ok(1 << 20, 1024, 1 << 20)
    assert not hasattr(fps, "_KERNEL_MAX_N")
    for n, d, k in ((100, 1025, 10), (100, 27, 101), ((1 << 20) + 1, 27, 10), (100, 27, 0),
                    (100, 0, 10)):
        assert not fps.kernel_spec_ok(n, d, k)
        with pytest.raises(ValueError, match=r"1 <= N <= 1048576, 1 <= D <= 1024 and 1 <= k <= N"):
            fps._check_spec(n, d, k)
