from .autodis import AutoDisLayer, DenseFeatureEncoder
from .sfg import LabelAwareAttention, SFGDecoder, SFGLoss, sfg_loss
from .xdeepfm_pro import xDeepFMPro, xDeepFMProLight

__all__ = [
    "xDeepFMPro",
    "xDeepFMProLight",
    "SFGDecoder",
    "SFGLoss",
    "sfg_loss",
    "LabelAwareAttention",
    "AutoDisLayer",
    "DenseFeatureEncoder",
]
