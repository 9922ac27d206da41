"""PNN (port of ``xdeepfm_tpu/models/pnn.py``; reference
``deepctr/models/pnn.py:17-109``).  No linear term.

A DNN over the product layer: the flattened sparse embeddings (the linear
signal), then their pairwise inner products and kernel-weighted outer
products, where enabled, then the dense values.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..basemodel import BaseModel
from ..embeddings import EmbeddingCollection
from ..features import FeatureSchema, compute_input_dim
from ..nn.core import DNN, PredictionLayer, torch_linear_init
from ..nn.interaction import InnerProductLayer, OutterProductLayer


class PNNModule(nn.Module):
    """Parameters follow the JAX paths: ``embedding_dict``,
    ``outterproduct/kernel`` (a raw parameter, untransposed), ``dnn``,
    ``dnn_linear``, ``out`` (``innerproduct`` has none)."""

    def __init__(
        self,
        dnn_cols: tuple,
        schema: FeatureSchema,
        embedding_size: int,
        num_inputs: int,
        dnn_hidden_units: Sequence[int] = (128, 128),
        dnn_dropout: float = 0.0,
        dnn_activation: str = "relu",
        use_inner: bool = True,
        use_outter: bool = False,
        kernel_type: str = "mat",
        init_std: float = 1e-4,
        seed: int = 1024,
        task: str = "binary",
    ):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dnn_cols = tuple(dnn_cols)
        self.use_inner, self.use_outter = use_inner, use_outter
        self.embedding_dict = EmbeddingCollection(
            self.dnn_cols, schema, init_std=init_std, generator=gen
        )
        num_pairs = num_inputs * (num_inputs - 1) // 2
        product_out_dim = 0
        if use_inner:
            product_out_dim += num_pairs
            self.innerproduct = InnerProductLayer()
        if use_outter:
            product_out_dim += num_pairs
            self.outterproduct = OutterProductLayer(num_inputs, embedding_size, kernel_type,
                                                    generator=gen)
        self.dnn = DNN(
            product_out_dim + compute_input_dim(self.dnn_cols), dnn_hidden_units,
            activation=dnn_activation, dropout_rate=dnn_dropout, init_std=init_std,
            generator=gen,
        )
        self.dnn_linear = nn.Linear(dnn_hidden_units[-1], 1, bias=False)
        torch_linear_init(self.dnn_linear.weight, gen)
        self.out = PredictionLayer(task=task)

    def forward(self, batch, training: bool = False, generator=None):
        """``batch``: typed tensors.  Returns ``{"pred": [B, 1]}``;
        ``generator`` draws the DNN's dropout masks when ``training``."""
        sparse_stack, dense_vals = self.embedding_dict.stacked_inputs(batch, self.dnn_cols)
        parts = [sparse_stack.flatten(1)]
        if self.use_inner:
            inner = self.innerproduct(sparse_stack)
            parts.append(inner.flatten(1))
        if self.use_outter:
            parts.append(self.outterproduct(sparse_stack))
        if dense_vals is not None:
            parts.append(dense_vals)
        dnn_out = self.dnn(torch.cat(parts, dim=-1), training=training, generator=generator)
        return {"pred": self.out(self.dnn_linear(dnn_out))}


class PNN(BaseModel):
    """Drop-in equivalent of the reference PNN class
    (``deepctr/models/pnn.py:17-109``).  ``device=None`` means "cuda"."""

    def __init__(
        self, dnn_feature_columns, dnn_hidden_units=(128, 128),
        l2_reg_embedding=1e-5, l2_reg_dnn=0, init_std=0.0001, seed=1024,
        dnn_dropout=0, dnn_activation="relu", use_inner=True, use_outter=False,
        kernel_type="mat", task="binary", device=None, gpus=None,
    ):
        if kernel_type not in ["mat", "vec", "num"]:
            raise ValueError("kernel_type must be mat,vec or num")
        super().__init__(
            [], dnn_feature_columns, l2_reg_linear=0,
            l2_reg_embedding=l2_reg_embedding, init_std=init_std, seed=seed,
            task=task, device=device, gpus=gpus,
        )
        self.use_inner = use_inner
        self.use_outter = use_outter
        self.kernel_type = kernel_type
        self.dnn_hidden_units = tuple(dnn_hidden_units)
        self.dnn_dropout = dnn_dropout
        self.dnn_activation = dnn_activation
        self.add_regularization_weight(("dnn/", "/kernel"), l2=l2_reg_dnn)
        self.add_regularization_weight(("dnn_linear/",), l2=l2_reg_dnn)
        self._finalize()

    def _build_module(self):
        return PNNModule(
            dnn_cols=self.dnn_feature_columns,
            schema=self.schema,
            embedding_size=self.embedding_size,
            num_inputs=self.compute_input_dim(self.dnn_feature_columns, include_dense=False,
                                              feature_group=True),
            dnn_hidden_units=self.dnn_hidden_units,
            dnn_dropout=self.dnn_dropout,
            dnn_activation=self.dnn_activation,
            use_inner=self.use_inner,
            use_outter=self.use_outter,
            kernel_type=self.kernel_type,
            init_std=self.init_std,
            seed=self.seed,
            task=self.task,
        )
