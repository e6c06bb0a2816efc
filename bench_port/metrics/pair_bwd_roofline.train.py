"""The encoder pair backward against its roofline: the bound of each
minibatch's backward (both networks; the kernel recomputes the forward)
over the device time of its stage A and stage B (weight products and
their fixed-order sums) launched in the PPO minibatches."""
from bench_port import flops, tracing

KERNELS = ("encoder_bwd", "weight_grad", "sum_segments")


def read(record):
    m = record["model"]
    if m["groups"] is None:
        return None
    t = tracing.kernel_seconds(record["trace"], KERNELS, "ppo")
    if t <= 0:
        return None
    calls = record["iters_traced"] * m["minibatches"] * m["epochs"]
    return 100.0 * calls * flops.pair_backward_bound_s(m["groups"], m["action_dim"],
                                                       m["mb_rows"]) / t
