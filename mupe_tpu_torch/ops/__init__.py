"""Hand-written CUDA kernels with their plain PyTorch versions."""
from .fused_encoder import (
    EncoderSpec,
    encoder_forward,
    encoder_pair_forward,
    leaf_shapes,
    pack_obs,
    reference_apply,
)
from .fps import farthest_point_sampling, reference_fps
from .tp_lstm import TPLSTMSpec, reference_forward, tp_forward

__all__ = [
    "EncoderSpec",
    "encoder_forward",
    "encoder_pair_forward",
    "farthest_point_sampling",
    "leaf_shapes",
    "pack_obs",
    "reference_apply",
    "reference_fps",
    "TPLSTMSpec",
    "reference_forward",
    "tp_forward",
]
