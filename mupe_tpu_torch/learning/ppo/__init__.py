from .ppo import PPOCfg, PPOPolicy
from .ppo_tconv import PPOTConvPolicy, TConvEncoder
from .ppo_sdf_nav import PPOSDFNavPolicy, PointNetEncoder
from .transformer import TransformerEncoder, TransformerPPOPolicy
from .ppo_rnn import PPORNNCfg, PPORNNPolicy
from .ppo_adapt import AdaptationModule, PPOAdaptCfg, PPOAdaptivePolicy

__all__ = [
    "PPOCfg",
    "PPOPolicy",
    "PPOTConvPolicy",
    "TConvEncoder",
    "PPOSDFNavPolicy",
    "PointNetEncoder",
    "TransformerPPOPolicy",
    "TransformerEncoder",
    "PPORNNPolicy",
    "PPORNNCfg",
    "AdaptationModule",
    "PPOAdaptCfg",
    "PPOAdaptivePolicy",
]
