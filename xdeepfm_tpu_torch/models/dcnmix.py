"""DCN-Mix (port of ``xdeepfm_tpu/models/dcnmix.py``; reference
``deepctr/models/dcnmix.py:20-102``).

DCN's towers (:class:`~.dcn.DCNModule`) with the low-rank mixture-of-experts
cross network, ``CrossNetMix``.
"""

from __future__ import annotations

from ..basemodel import BaseModel
from ..nn.interaction import CrossNetMix
from .dcn import DCNModule


class DCNMix(BaseModel):
    """Drop-in equivalent of the reference DCNMix class
    (``deepctr/models/dcnmix.py:20-102``).  ``device=None`` means "cuda".
    ``l2_reg_linear`` goes to ``dnn_linear``; the linear model keeps the
    engine's default, as in the JAX class."""

    def __init__(
        self, linear_feature_columns, dnn_feature_columns, cross_num=2,
        dnn_hidden_units=(128, 128), l2_reg_linear=0.00001,
        l2_reg_embedding=0.00001, l2_reg_cross=0.00001, l2_reg_dnn=0,
        init_std=0.0001, seed=1024, dnn_dropout=0, low_rank=32, num_experts=4,
        dnn_activation="relu", dnn_use_bn=False, task="binary", device=None,
        gpus=None,
    ):
        super().__init__(
            linear_feature_columns, dnn_feature_columns,
            l2_reg_embedding=l2_reg_embedding, init_std=init_std, seed=seed,
            task=task, device=device, gpus=gpus,
        )
        self.cross_num = cross_num
        self.dnn_hidden_units = tuple(dnn_hidden_units)
        self.low_rank = low_rank
        self.num_experts = num_experts
        self.dnn_dropout = dnn_dropout
        self.dnn_activation = dnn_activation
        self.dnn_use_bn = dnn_use_bn
        self.add_regularization_weight(("dnn/", "/kernel"), l2=l2_reg_dnn)
        self.add_regularization_weight(("dnn_linear/",), l2=l2_reg_linear)
        for p in ("U_list", "V_list", "C_list"):
            self.add_regularization_weight(("crossnet/" + p,), l2=l2_reg_cross)
        self._finalize()

    def _build_module(self):
        return DCNModule(
            linear_cols=self.linear_feature_columns,
            dnn_cols=self.dnn_feature_columns,
            schema=self.schema,
            cross_num=self.cross_num,
            dnn_hidden_units=self.dnn_hidden_units,
            dnn_dropout=self.dnn_dropout,
            dnn_activation=self.dnn_activation,
            dnn_use_bn=self.dnn_use_bn,
            init_std=self.init_std,
            seed=self.seed,
            task=self.task,
            cross_factory=lambda d, gen: CrossNetMix(
                d, low_rank=self.low_rank, num_experts=self.num_experts,
                layer_num=self.cross_num, generator=gen),
        )
