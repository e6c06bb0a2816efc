"""The TP-LSTM kernels of the TP net's step against their roofline: the
operations of each `update.tp` span's forward and backward over its
windows (operations bound those rows, not bytes) at the bf16 peak, over
the device-stream milliseconds of the `kernel.tp_fwd` and `kernel.tp_bwd`
spans (with their stage-B `kernel.tp_weight_grad`) under `update.tp`, in
the traced iterations.  Nothing where the program records no spans on a
card."""
from bench_port import flops


def read(record):
    try:
        from mupe_tpu_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    tp = record["model"]["tp"]
    if tp is None:
        return None
    recs = trace.recorded()
    steps = sum(r["name"] == "update.tp" and r["device_ms"] is not None for r in recs)
    ms = sum(r["device_ms"] for r in recs if r["name"] in ("kernel.tp_fwd", "kernel.tp_bwd")
             and "update.tp" in r["path"] and r["device_ms"] is not None)
    if not steps or ms <= 0:
        return None
    ops = flops.tp_fwd_bwd_flops(tp["in_dim"], tp["steps"], tp["out"], tp["windows"])
    return 100.0 * steps * flops.bound_s(ops, 0) * 1e3 / ms
