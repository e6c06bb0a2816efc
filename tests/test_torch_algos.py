"""The port's algorithm registry and `harness.train` over every ported
algorithm and MAPPO option, on the CPU (`device="cpu"`): the registry's
names are the JAX package's `ALGOS`; an unknown name raises KeyError, and
`ppo_adapt` / `ppo_vision` build and act on Hover's dict observations (their
training is tests/test_torch_rma.py's and tests/test_torch_vision.py's);
1-2 iterations of each algorithm train with finite metrics (the
port's `train` alone: JAX's `train` of the same algorithms is
tests/test_harness_algos.py's); the recurrent carry (GRU states, `is_init`)
survives `resume_dir` exactly; and, on a card only (marker `gpu`), the
encoder kernels at the options' specs (a per-agent actor's rows, the state
critic's head of n) against their plain versions.
"""
import math

import pytest
import torch

from mupe_tpu.learning.registry import ALGOS as JALGOS
from mupe_tpu_torch import harness
from mupe_tpu_torch.envs import Hover, HoverCfg
from mupe_tpu_torch.learning import init_carry
from mupe_tpu_torch.learning.registry import ALGOS, make_policy
from mupe_tpu_torch.ops import fused_encoder as fe
from mupe_tpu_torch.ops.tolerance import in_f64
from mupe_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)
TINY = ["env.max_episode_length=16", "log_interval=1", "save_interval=-1",
        "algo.train_every=8", "algo.num_minibatches=2"]
HOVER = ["task=Hover", "env.num_envs=8"]
HIDE = ["task=HideAndSeek", "env.num_envs=4"]
CASES = {
    "ppo": HOVER + ["algo=ppo"],
    "ppo_priv": HOVER + ["algo=ppo", "algo.priv_actor=true", "algo.priv_critic=true",
                         "env.dr_mass_scale=[0.8,1.2]", "env.dr_t2w_scale=[0.9,1.1]"],
    "ppo_tconv": HOVER + ["algo=ppo_tconv", "env.obs_history_len=32"],
    "ppo_rnn": HOVER + ["algo=ppo_rnn", "algo.train_seq_len=4"],
    "transformer": HIDE + ["algo=transformer"],
    "share_actor": HIDE + ["algo.share_actor=false"],
    "relation": HIDE + ["algo.attn_encoder=RelationEncoder"],
    "partial_relation": HIDE + ["algo.attn_encoder=PartialRelationEncoder"],
}


def _train(tmp_path, name, *args, max_iters=1):
    return harness.train([*TINY, f"run_dir={tmp_path}", f"run_name={name}",
                          f"max_iters={max_iters}", *args], device="cpu")


def test_registry_names_are_the_jax_packages():
    assert set(ALGOS) == set(JALGOS)
    env = Hover(HoverCfg(num_envs=2), device="cpu")
    with pytest.raises(KeyError):
        make_policy("nope", env)


@pytest.mark.parametrize("algo, env_kw", [
    ("ppo_adapt", dict(dr_mass_scale=(0.8, 1.2), obs_history_len=8)),
    ("ppo_vision", dict(obs_depth=True, depth_width=16, depth_height=12))])
def test_adapt_and_vision_build_on_hover(algo, env_kw):
    """Both build on Hover's dict observations and act; on its flat
    observation each is refused with the JAX package's ValueError."""
    with pytest.raises(ValueError, match="dict observations"):
        make_policy(algo, Hover(HoverCfg(num_envs=2), device="cpu"), device="cpu")
    env = Hover(HoverCfg(num_envs=2, **env_kw), device="cpu")
    policy = make_policy(algo, env, device="cpu")
    carry = init_carry(env, policy, torch.Generator().manual_seed(0))
    action, logp, value = policy.act(carry.ts, carry.obs, carry.generator)
    assert action.shape == (2, 1, 4) and logp.shape == value.shape == (2, 1, 1)


@pytest.mark.parametrize("case", list(CASES))
def test_train_runs_each_algorithm(tmp_path, case):
    m = _train(tmp_path, case, *CASES[case], max_iters=2)
    assert math.isfinite(m["policy_loss"]) and math.isfinite(m["value_loss"])
    assert all(math.isfinite(v) for k, v in m.items() if not k.startswith("stats/"))


def test_state_critic_on_hideandseek_raises(tmp_path):
    with pytest.raises(ValueError, match="state_drones"):
        _train(tmp_path, "state", *HIDE, "algo.critic_input=state")


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_recurrent_carry_resumes_exactly(tmp_path):
    """2 iterations, then 1 more from `resume_dir`, give the same full carry
    (learner, env state, GRU states, is_init, generator) as 3 straight."""
    args = CASES["ppo_rnn"]
    _train(tmp_path, "straight", *args, max_iters=3)
    _train(tmp_path, "first", *args, max_iters=2)
    _train(tmp_path, "resumed", *args, f"resume_dir={tmp_path / 'first' / 'checkpoints' / 'full'}",
           max_iters=1)
    straight = load_checkpoint(tmp_path / "straight" / "checkpoints" / "full")
    resumed = load_checkpoint(tmp_path / "resumed" / "checkpoints" / "full")
    assert {"actor_rnn", "critic_rnn", "is_init"} <= set(straight)
    assert _equal(straight, resumed)
    assert not torch.equal(straight["actor_rnn"], torch.zeros_like(straight["actor_rnn"]))


# ------------------------------------------------------------------ on a card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only on the GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


OPTION_SPECS = {
    # one agent's share of bench.py's 49,152-row minibatch, HideAndSeek's groups
    "per-agent actor": (fe.EncoderSpec(groups=((1, 35), (3, 5), (2, 3)), head_dim=4), 16384),
    # the state critic over bench.py's {state_drones [n, 35], cylinders [k, 5]}, a head of n
    "state critic": (fe.EncoderSpec(groups=((3, 35), (3, 5)), head_dim=3), 16384),
}


@pytest.mark.gpu
@pytest.mark.parametrize("what", list(OPTION_SPECS))
def test_encoder_kernels_at_the_options_specs(cuda, what):
    """Row 2 (the forward) and row 5 (the backward) at the options' specs:
    within `KERNEL_TOL` / `BWD_KERNEL_TOL` of the plain versions, one launch
    each."""
    spec, s = OPTION_SPECS[what]
    g = torch.Generator().manual_seed(s)
    leaves = [(torch.randn(sh, generator=g) / math.sqrt(sh[0]) if len(sh) == 2
               else 0.1 * torch.randn(sh, generator=g)).to(cuda) for sh in fe.leaf_shapes(spec)]
    x = (2.0 * torch.randn((s, spec.obs_dim), generator=g)).to(cuda)
    dout = torch.randn((s, spec.head_dim), generator=g).to(cuda)
    n = (fe.encoder_forward.launches, fe.encoder_backward.launches)
    out = fe.encoder_forward(spec, leaves, x)
    (grads,) = fe.encoder_backward([(spec, leaves)], x, [dout])
    torch.cuda.synchronize()
    assert (fe.encoder_forward.launches, fe.encoder_backward.launches) == (n[0] + 1, n[1] + 1)
    errs = fe.KERNEL_TOL.errors(out, fe.reference_apply(spec, leaves, x),
                                in_f64(fe.reference_apply, spec, leaves, x))
    assert fe.KERNEL_TOL.holds(errs), errs
    errs = fe.BWD_KERNEL_TOL.errors(grads, fe.reference_backward(spec, leaves, x, dout),
                                    in_f64(fe.reference_backward, spec, leaves, x, dout))
    assert fe.BWD_KERNEL_TOL.holds(errs), [(i, errs[i]) for i in fe.BWD_KERNEL_TOL.failing(errs)]
