from .autoint import AutoInt
from .dien import DIEN
from .difm import DIFM
from .xdeepfm import xDeepFM
from .xdeepfm_attn import xDeepFMAttention, xDeepFMAttentionV2

__all__ = ["AutoInt", "DIEN", "DIFM", "xDeepFM", "xDeepFMAttention", "xDeepFMAttentionV2"]
