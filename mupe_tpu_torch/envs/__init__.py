from .base import ENV_REGISTRY, Transition, register_env, tree_to, where_done
from .genbuffer import GenBufferState
from .hideandseek import HideAndSeek, HideAndSeekCfg, HideAndSeekState
from .hideandseek_envgen import HideAndSeekEnvgen, HideAndSeekEnvgenCfg
from .hover import Hover, HoverCfg, HoverState
from .fake import FakeHideAndSeek

__all__ = [
    "ENV_REGISTRY",
    "Transition",
    "register_env",
    "tree_to",
    "where_done",
    "GenBufferState",
    "HideAndSeek",
    "HideAndSeekCfg",
    "HideAndSeekState",
    "HideAndSeekEnvgen",
    "HideAndSeekEnvgenCfg",
    "Hover",
    "HoverCfg",
    "HoverState",
    "FakeHideAndSeek",
]
