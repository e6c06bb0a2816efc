"""Kernels: the share of the PPO minibatches' device time (every device
operation launched while the benchmark's `ppo` annotation was open) spent
in depthwise-convolution backward kernels, by symbol: a name holding
"depthwise" and "backward" or "grad" (ATen's float32 `conv_depthwise2d`
backward kernels, or a library's depthwise gradient kernels)."""


def read(record):
    kernels = [(n, t) for n, t, open_ in record["trace"]["kernels"] if "ppo" in open_]
    total = sum(t for _, t in kernels)
    dw = sum(t for n, t in kernels if "depthwise" in n.lower()
             and ("backward" in n.lower() or "grad" in n.lower()))
    return dw / total if total > 0 else None
