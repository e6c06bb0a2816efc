from .gae import compute_gae
from .mappo import MAPPOCfg, MAPPOPolicy, MAPPOState, PackMeta, compute_pack_meta
from .optim import AdamState
from .rollout import (
    IterCarry,
    RNNIterCarry,
    init_carry,
    init_rnn_carry,
    make_rnn_rollout,
    make_rnn_train_iter,
    make_rollout,
    make_train_iter,
)
from .valuenorm import ValueNorm1, ValueNorm2
from .mybuffer import TrajRingBuffer
from .ppo import PPOAdaptCfg, PPOAdaptivePolicy
from .tp_net import TPNet, denormalize_predictions, normalize_groundtruth

__all__ = [
    "MAPPOCfg",
    "MAPPOPolicy",
    "MAPPOState",
    "PackMeta",
    "compute_pack_meta",
    "compute_gae",
    "AdamState",
    "ValueNorm1",
    "ValueNorm2",
    "IterCarry",
    "RNNIterCarry",
    "init_rnn_carry",
    "make_rnn_rollout",
    "make_rnn_train_iter",
    "init_carry",
    "make_rollout",
    "make_train_iter",
    "TPNet",
    "denormalize_predictions",
    "normalize_groundtruth",
    "TrajRingBuffer",
    "PPOAdaptCfg",
    "PPOAdaptivePolicy",
]
