from .afm import AFM
from .afn import AFN
from .autoint import AutoInt
from .dcn import DCN
from .dcnmix import DCNMix
from .deepfm import DeepFM
from .dien import DIEN
from .difm import DIFM
from .din import DIN
from .ifm import IFM
from .nfm import NFM
from .wdl import WDL
from .xdeepfm import xDeepFM
from .xdeepfm_attn import xDeepFMAttention, xDeepFMAttentionV2

__all__ = [
    "AFM", "AFN", "AutoInt", "DCN", "DCNMix", "DeepFM", "DIEN", "DIFM", "DIN", "IFM", "NFM",
    "WDL", "xDeepFM", "xDeepFMAttention", "xDeepFMAttentionV2",
]
