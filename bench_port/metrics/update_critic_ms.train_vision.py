"""Update: device-stream milliseconds of a minibatch's critic step (the
program's `update.critic` span), the mean over the traced iterations.
Nothing where the program records no such span on a card."""
from statistics import fmean


def read(record):
    try:
        from mupe_tpu_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    ms = [r["device_ms"] for r in trace.recorded()
          if r["name"] == "update.critic" and r["device_ms"] is not None]
    return fmean(ms) if ms else None
