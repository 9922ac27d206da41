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
from .multitask import ESMM, MMOE, PLE, SharedBottom
from .nfm import NFM
from .onn import ONN
from .pnn import PNN
from .wdl import WDL
from .xdeepfm import xDeepFM
from .xdeepfm_attn import xDeepFMAttention, xDeepFMAttentionV2

__all__ = [
    "AFM", "AFN", "AutoInt", "CCPM", "DCN", "DCNMix", "DeepFM", "DIEN", "DIFM", "DIN",
    "ESMM", "FiBiNET", "IFM", "MLR", "MMOE", "NFM", "ONN", "PLE", "PNN", "SharedBottom",
    "WDL", "xDeepFM", "xDeepFMAttention", "xDeepFMAttentionV2",
]
