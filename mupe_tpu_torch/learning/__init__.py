from .gae import compute_gae
from .mappo import MAPPOCfg, MAPPOPolicy, MAPPOState, PackMeta, compute_pack_meta
from .optim import AdamState
from .rollout import IterCarry, init_carry, make_rollout, make_train_iter
from .valuenorm import ValueNorm1, ValueNorm2
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
    "init_carry",
    "make_rollout",
    "make_train_iter",
    "TPNet",
    "denormalize_predictions",
    "normalize_groundtruth",
]
