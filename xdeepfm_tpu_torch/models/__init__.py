from .autoint import AutoInt
from .difm import DIFM
from .xdeepfm import xDeepFM
from .xdeepfm_attn import xDeepFMAttention, xDeepFMAttentionV2

__all__ = ["AutoInt", "DIFM", "xDeepFM", "xDeepFMAttention", "xDeepFMAttentionV2"]
