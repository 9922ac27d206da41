from .afm import AFM
from .afn import AFN
from .autoint import AutoInt
from .ccpm import CCPM
from .dcn import DCN
from .dcnmix import DCNMix
from .deepfm import DeepFM
from .dien import DIEN
from .difm import DIFM
from .din import DIN
from .fibinet import FiBiNET
from .ifm import IFM
from .mlr import MLR
from .nfm import NFM
from .onn import ONN
from .pnn import PNN
from .wdl import WDL
from .xdeepfm import xDeepFM
from .xdeepfm_attn import xDeepFMAttention, xDeepFMAttentionV2

__all__ = [
    "AFM", "AFN", "AutoInt", "CCPM", "DCN", "DCNMix", "DeepFM", "DIEN", "DIFM", "DIN",
    "FiBiNET", "IFM", "MLR", "NFM", "ONN", "PNN", "WDL", "xDeepFM", "xDeepFMAttention",
    "xDeepFMAttentionV2",
]
