"""xdeepfm_tpu_torch — the PyTorch/CUDA port of ``xdeepfm_tpu``.

Same feature schema, typed batches, models and engine as the JAX package, with
each TPU (Pallas) kernel on the ported path rewritten by hand for NVIDIA
Hopper.  Module names mirror ``xdeepfm_tpu``; the port imports nothing of it.
"""

__version__ = "0.1.0"

from .features import (
    DenseFeat,
    FeatureSchema,
    SparseFeat,
    VarLenSparseFeat,
    build_input_features,
    get_feature_names,
)

__all__ = [
    "DenseFeat",
    "FeatureSchema",
    "SparseFeat",
    "VarLenSparseFeat",
    "build_input_features",
    "get_feature_names",
]
