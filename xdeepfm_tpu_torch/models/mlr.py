"""MLR, the piece-wise linear model (port of ``xdeepfm_tpu/models/mlr.py``;
reference ``deepctr/models/mlr.py:17-100``).

The reference's quirk is kept verbatim: its ``get_learner_score`` reads
``region_linear_model`` for the learner logits too (``mlr.py:84-86``), so
the base models never run and are not allocated.  The region models share
one column-stacked [V, N] table (:class:`~xdeepfm_tpu_torch.embeddings.
MultiLinearModel`).  The prediction is the combined score itself, with no
``PredictionLayer`` on top (``mlr.py:96-99``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..basemodel import BaseModel
from ..embeddings import LinearModel, MultiLinearModel
from ..features import FeatureSchema
from ..nn.core import PredictionLayer


class MLRModule(nn.Module):
    """Parameters follow the JAX paths:
    ``region_linear_model/embedding_dict/table_d{N}``,
    ``region_linear_model/weight`` and, with bias columns,
    ``bias_linear``; ``prediction_layer`` and ``bias_prediction`` have no
    bias."""

    def __init__(
        self,
        region_cols: tuple,
        bias_cols: tuple,
        schema: FeatureSchema,
        region_num: int = 4,
        init_std: float = 1e-4,
        seed: int = 1024,
        task: str = "binary",
    ):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.region_linear_model = MultiLinearModel(region_cols, schema, region_num,
                                                    init_std=init_std, generator=gen)
        self.has_bias = len(bias_cols) > 0
        if self.has_bias:
            self.bias_linear = LinearModel(bias_cols, schema, init_std=init_std, generator=gen)
            self.bias_prediction = PredictionLayer(task="binary", use_bias=False)
        self.prediction_layer = PredictionLayer(task=task, use_bias=False)

    def forward(self, batch, training: bool = False, generator=None):
        """``batch``: typed tensors.  Returns ``{"pred": [B, 1]}``."""
        region_logit = self.region_linear_model(batch)  # [B, N]
        region_score = torch.softmax(region_logit, dim=-1)
        # the learner logits reuse the region models (reference mlr.py:84-86)
        learner_score = self.prediction_layer(region_logit)
        final_logit = (region_score * learner_score).sum(dim=-1, keepdim=True)
        if self.has_bias:
            final_logit = final_logit * self.bias_prediction(self.bias_linear(batch))
        return {"pred": final_logit}


class MLR(BaseModel):
    """Drop-in equivalent of the reference MLR class
    (``deepctr/models/mlr.py:17-100``).  ``device=None`` means "cuda"."""

    def __init__(
        self, region_feature_columns, base_feature_columns=None,
        bias_feature_columns=None, region_num=4, l2_reg_linear=1e-5,
        init_std=0.0001, seed=1024, task="binary", device=None, gpus=None,
    ):
        if region_num <= 1:
            raise ValueError("region_num must > 1")
        super().__init__(
            region_feature_columns, region_feature_columns, task=task,
            device=device, gpus=gpus, init_std=init_std, seed=seed,
            l2_reg_linear=l2_reg_linear,
        )
        self.region_num = region_num
        self.region_feature_columns = tuple(region_feature_columns)
        self.base_feature_columns = tuple(
            base_feature_columns
            if base_feature_columns is not None and len(base_feature_columns) > 0
            else region_feature_columns
        )
        self.bias_feature_columns = tuple(bias_feature_columns or [])
        # the schema spans the region, base and bias columns (mlr.py:58-59)
        self.schema = FeatureSchema.build(
            list(self.region_feature_columns) + list(self.base_feature_columns)
            + list(self.bias_feature_columns)
        )
        self._finalize()

    def _build_module(self):
        return MLRModule(
            region_cols=self.region_feature_columns,
            bias_cols=self.bias_feature_columns,
            schema=self.schema,
            region_num=self.region_num,
            init_std=self.init_std,
            seed=self.seed,
            task=self.task,
        )
