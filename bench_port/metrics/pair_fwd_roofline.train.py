"""The encoder pair forward (actor and critic in one launch) against its
roofline: the sum of each call's bound over the device time of the encoder
forward kernels launched by the rollout's acts and in the PPO minibatches,
in the traced iterations.  Nothing where no such kernel ran."""
from bench_port import flops, tracing

KERNELS = ("encoder_fwd", "encoder_embed")


def read(record):
    m = record["model"]
    if m["groups"] is None:
        return None
    t_act = tracing.kernel_seconds(record["trace"], KERNELS, "act")
    t_ppo = tracing.kernel_seconds(record["trace"], KERNELS, "ppo")
    if t_act + t_ppo <= 0:
        return None
    k = record["iters_traced"]
    rows_act = m["arenas"] * m["n_agents"]
    bound = k * m["steps"] * flops.pair_forward_bound_s(m["groups"], m["action_dim"], rows_act)
    bound += (k * m["minibatches"] * m["epochs"]
              * flops.pair_forward_bound_s(m["groups"], m["action_dim"], m["mb_rows"]))
    return 100.0 * bound / (t_act + t_ppo)
