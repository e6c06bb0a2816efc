"""Kernels: MobileNetV3-Small's forward and backward in the update against
its roofline.  The bound of both networks' backbone over a minibatch's
frames (`flops/mobilenet.py`: operations at the float32 peak, bytes at the
memory rate, whichever is longer) times the minibatches, over the
device-stream milliseconds of the program's `update.actor` and
`update.critic` spans, whose work is the backbone's but for the MLPs,
the loss and the optimizer: a lower reading of the backbone's share.
Nothing where the program records no such span on a card."""
from bench_port.flops import mobilenet


def read(record):
    try:
        from mupe_tpu_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    recs = [r for r in trace.recorded() if r["name"] in ("update.actor", "update.critic")
            and r["device_ms"] is not None]
    ms = sum(r["device_ms"] for r in recs)
    if not recs or ms <= 0:
        return None
    m = record["model"]
    h, w = m["frame"]
    return 100.0 * len(recs) * mobilenet.fwd_bwd_bound_s(h, w, m["mb_frames"]) * 1e3 / ms
