from .activations import (
    Dice,
    Identity,
    PReLU,
    activation_fn,
    activation_layer,
    make_activation,
)
from .core import (
    DNN,
    BatchNorm,
    Conv2dSame,
    ConvSame,
    LocalActivationUnit,
    PredictionLayer,
    glorot_uniform_,
    torch_linear_init,
)
from .cin_attention import (
    AttentionPooling,
    CINAttention,
    CINAttentionV2,
    MultiHeadSelfAttention,
)
from .interaction import (
    CIN,
    FM,
    AFMLayer,
    BiInteractionPooling,
    BilinearInteraction,
    ConvLayer,
    CrossNet,
    CrossNetMix,
    InnerProductLayer,
    InteractingLayer,
    LogTransformLayer,
    OutterProductLayer,
    SENETLayer,
)
from .sequence import (
    AGRUCell,
    AUGRUCell,
    AttentionSequencePoolingLayer,
    DynamicGRU,
    GRU,
    KMaxPooling,
    SequencePoolingLayer,
    kmax_lastaxis,
    sequence_pool,
)
