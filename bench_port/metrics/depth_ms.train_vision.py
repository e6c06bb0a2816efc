"""Env step: device-stream milliseconds of the depth frame's ray cast (the
program's `env.depth` spans under `rollout`) a rollout step: their sum
over the rollout's `env.step` spans, in the traced iterations.  Nothing
where the program records no such span on a card."""


def read(record):
    try:
        from mupe_tpu_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    recs = [r for r in trace.recorded() if "rollout" in r["path"] and r["device_ms"] is not None]
    steps = sum(r["name"] == "env.step" for r in recs)
    ms = [r["device_ms"] for r in recs if r["name"] == "env.depth"]
    return sum(ms) / steps if ms and steps else None
