from .afm import AFM
from .autoint import AutoInt
from .dcn import DCN
from .dcnmix import DCNMix
from .deepfm import DeepFM
from .dien import DIEN
from .difm import DIFM
from .ifm import IFM
from .nfm import NFM
from .wdl import WDL
from .xdeepfm import xDeepFM
from .xdeepfm_attn import xDeepFMAttention, xDeepFMAttentionV2

__all__ = [
    "AFM", "AutoInt", "DCN", "DCNMix", "DeepFM", "DIEN", "DIFM", "IFM", "NFM", "WDL",
    "xDeepFM", "xDeepFMAttention", "xDeepFMAttentionV2",
]
