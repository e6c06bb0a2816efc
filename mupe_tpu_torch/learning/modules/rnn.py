"""Recurrent core with episode-boundary masking
(counterpart of mupe_tpu/learning/modules/rnn.py).

`MaskedGRU` is flax's `GRUCell` (input denses `ir`, `iz`, `in` with biases;
hidden denses `hr`, `hz` without, `hn` with one):

    r = sigmoid(W_ir x + b_ir + W_hr h)
    z = sigmoid(W_iz x + b_iz + W_hz h)
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h

after zeroing the state where `is_init` holds, then `LayerNorm(h' + Dense(x))`
as the output (rnn.py:21-33).  Float32 throughout, as the JAX module has no
dtype.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .networks import Leaf, apply_dense, apply_ln, dense_leaves, ln_leaves

_GATES = ("r", "z", "n")


def masked_gru_leaves(path: str, d_in: int, hidden: int) -> List[Leaf]:
    """The leaves of a `MaskedGRU` under `path` (flax's names)."""
    cell = f"{path}/GRUCell_0"
    leaves = []
    for g in _GATES:
        leaves += dense_leaves(f"{cell}/i{g}", d_in, hidden)
    for g in _GATES:
        leaves += dense_leaves(f"{cell}/h{g}", hidden, hidden, "orthogonal", bias=g == "n")
    return (leaves + dense_leaves(f"{path}/Dense_0", d_in, hidden)
            + ln_leaves(f"{path}/LayerNorm_0", hidden))


def masked_gru(
    p, path: str, x: torch.Tensor, state: Optional[torch.Tensor],
    is_init: Optional[torch.Tensor] = None, hidden: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: x [..., D], state [..., H] (None: zeros of `hidden`),
    is_init [..., 1] → (output [..., H], new state [..., H])."""
    if state is None:
        state = x.new_zeros(x.shape[:-1] + (hidden,))
    if is_init is not None:
        state = torch.where(is_init.to(torch.bool), torch.zeros_like(state), state)
    cell = f"{path}/GRUCell_0"
    r = torch.sigmoid(apply_dense(p, f"{cell}/ir", x) + apply_dense(p, f"{cell}/hr", state))
    z = torch.sigmoid(apply_dense(p, f"{cell}/iz", x) + apply_dense(p, f"{cell}/hz", state))
    n = torch.tanh(apply_dense(p, f"{cell}/in", x) + r * apply_dense(p, f"{cell}/hn", state))
    new_state = (1.0 - z) * n + z * state
    out = apply_ln(p, f"{path}/LayerNorm_0", new_state + apply_dense(p, f"{path}/Dense_0", x))
    return out, new_state
