from .activations import PReLU, activation_fn, make_activation
from .core import DNN, PredictionLayer, torch_linear_init
from .cin_attention import CINAttention, CINAttentionV2
from .interaction import CIN, FM, InteractingLayer
