"""Update: device-stream milliseconds of the TP net's supervised step (the
program's `update.tp` span), the mean over the traced iterations.  Nothing
where the program records no spans on a card."""
from statistics import fmean


def read(record):
    try:
        from mupe_tpu_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    ms = [r["device_ms"] for r in trace.recorded()
          if r["name"] == "update.tp" and r["device_ms"] is not None]
    return fmean(ms) if ms else None
