from .hideandseek import HideAndSeek, HideAndSeekCfg
from .hover import Hover, HoverCfg

# the benchmark's configurations name their task as the port's registry does
ENVS = {"HideAndSeek": HideAndSeek, "Hover": Hover}

__all__ = ["ENVS", "HideAndSeek", "HideAndSeekCfg", "Hover", "HoverCfg"]
