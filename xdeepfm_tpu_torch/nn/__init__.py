from .activations import Dice, PReLU, activation_fn, make_activation
from .core import DNN, BatchNorm, LocalActivationUnit, PredictionLayer, torch_linear_init
from .cin_attention import CINAttention, CINAttentionV2
from .interaction import (
    CIN,
    FM,
    AFMLayer,
    BiInteractionPooling,
    CrossNet,
    CrossNetMix,
    InteractingLayer,
    LogTransformLayer,
)
from .sequence import (
    AGRUCell,
    AUGRUCell,
    AttentionSequencePoolingLayer,
    DynamicGRU,
    GRU,
    SequencePoolingLayer,
    sequence_pool,
)
