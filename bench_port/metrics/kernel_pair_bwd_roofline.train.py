"""The encoder pair backward against its roofline, by the program's kernel
spans: each `kernel.pair_bwd` span under `update.ppo` (stage A and its
`kernel.weight_grad` child) bounds a minibatch's backward of both
networks; the sum of the bounds over the sum of their device-stream
milliseconds, in the traced iterations.  Nothing where the program records
no spans on a card."""
from bench_port import flops


def read(record):
    try:
        from mupe_tpu_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    m = record["model"]
    if m["groups"] is None:
        return None
    ms = [r["device_ms"] for r in trace.recorded() if r["name"] == "kernel.pair_bwd"
          and "update.ppo" in r["path"] and r["device_ms"] is not None]
    if not ms or sum(ms) <= 0:
        return None
    bound_s = flops.pair_backward_bound_s(m["groups"], m["action_dim"], m["mb_rows"])
    return 100.0 * len(ms) * bound_s * 1e3 / sum(ms)
