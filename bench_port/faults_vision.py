"""Faults of MobileNetV3-Small's mechanism, planted in the program, which
`hover_vision.train`'s check must catch (each a context manager that
patches mupe_tpu_torch for its duration): `se`, every squeeze-excite gate
dropped (the block's activations pass ungated); `hswish`, hard-swish run
as ReLU; `unchanged`, an optimizer step that leaves the state as it was
(`faults.train_unchanged`).  The CPU tests run the cell under each; the
readings script runs them on the chip."""
from __future__ import annotations

from . import faults


def se_dropped():
    from mupe_tpu_torch.learning.modules import mobilenet

    return faults._patched(mobilenet, "_squeeze_excite",
                           lambda f: lambda p, path, x: x)


def hswish_as_relu():
    import torch.nn.functional as F
    from mupe_tpu_torch.learning.modules import mobilenet

    return faults._patched(mobilenet, "_hard_swish", lambda f: F.relu)


VISION = {"se": se_dropped, "hswish": hswish_as_relu, "unchanged": faults.train_unchanged}
