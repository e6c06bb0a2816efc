"""The vision backbone's forward in the update: device-stream milliseconds
of a `vision.backbone` span under `update.ppo` (one network's
MobileNetV3-Small over a minibatch's frames), the mean over the traced
iterations.  Nothing where the program records no such span on a card."""
from statistics import fmean


def read(record):
    try:
        from mupe_tpu_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    ms = [r["device_ms"] for r in trace.recorded() if r["name"] == "vision.backbone"
          and "update.ppo" in r["path"] and r["device_ms"] is not None]
    return fmean(ms) if ms else None
