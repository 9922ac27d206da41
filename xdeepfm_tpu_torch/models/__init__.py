from .xdeepfm import xDeepFM
from .xdeepfm_attn import xDeepFMAttention, xDeepFMAttentionV2

__all__ = ["xDeepFM", "xDeepFMAttention", "xDeepFMAttentionV2"]
