"""Update: device-stream milliseconds from the `rollout` mark to the `ppo`
mark of an iteration (`train_op`: prep, TP step, PPO minibatches), the mean
over the traced run's window (CUDA events)."""
from statistics import fmean


def read(record):
    ms = record.get("spans", {}).get("update", [])
    return fmean(ms) if ms else None
