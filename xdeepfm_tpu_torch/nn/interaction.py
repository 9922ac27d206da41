"""Feature-interaction layers (port of ``xdeepfm_tpu/nn/interaction.py``;
reference ``deepctr/layers/interaction.py``): the CIN, FM, AutoInt's
``InteractingLayer``, and the FM family's ``BiInteractionPooling``,
``AFMLayer``, ``CrossNet`` and ``CrossNetMix``, and AFN's
``LogTransformLayer``; the rest of the zoo follows.
Parameters that the JAX package creates with ``self.param`` stay raw
``nn.Parameter``s in its names and layouts, so ``weights.py`` carries them
unchanged.

Modules take stacked ``[B, F, E]`` field-embedding tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops import lane_attention as _lane
from ..ops.cin import cin_rows_contract
from .activations import apply_activation, make_activation
from .core import BatchNorm, dropout


def _pair_indices(num_fields: int):
    """(row, col) of every field pair i < j, row-major (``interaction.py:24``)."""
    row, col = [], []
    for i in range(num_fields - 1):
        for j in range(i + 1, num_fields):
            row.append(i)
            col.append(j)
    return row, col


def glorot_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's ``glorot_normal`` on a 2-D ``[in, out]`` parameter, in place:
    a normal truncated at two standard deviations, of variance
    2 / (in + out) after the truncation."""
    fan_in, fan_out = t.shape[-2], t.shape[-1]
    std = math.sqrt(2.0 / (fan_in + fan_out)) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def make_cin_params(module, field_size, layer_size, split_half, generator):
    """Register the per-layer 1x1-conv compression params ``conv_w_{i}``
    [size_i, H_i * M] and ``conv_b_{i}`` [size_i] on ``module``, both
    U(±1/sqrt(H_i * M)) (``interaction.py:167-194``).  Returns (kernels,
    biases) lists."""
    field_nums = [field_size]
    kernels, biases = [], []
    for i, size in enumerate(layer_size):
        in_ch = field_nums[-1] * field_nums[0]
        bound = 1.0 / math.sqrt(in_ch)
        w = nn.Parameter(torch.empty(size, in_ch).uniform_(-bound, bound, generator=generator))
        b = nn.Parameter(torch.empty(size).uniform_(-bound, bound, generator=generator))
        module.register_parameter(f"conv_w_{i}", w)
        module.register_parameter(f"conv_b_{i}", b)
        kernels.append(w)
        biases.append(b)
        if split_half:
            if i != len(layer_size) - 1 and size % 2 > 0:
                raise ValueError(
                    "layer_size must be even number except for the last layer "
                    "when split_half=True"
                )
            field_nums.append(size // 2)
        else:
            field_nums.append(size)
    return kernels, biases


def cin_feature_maps_rows(
    inputs, kernels, biases, act, layer_size, split_half, training=False,
    backend=None,
):
    """Run the CIN cross layers in row-major (b, d) form, returning the
    concatenated direct-connect feature maps as rows [B*D, featuremap_num]
    (reference ``interaction.py:207-245`` before the final sum-pool).
    ``backend`` goes to :func:`cin_rows_contract`."""
    if inputs.ndim != 3:
        raise ValueError(
            "Unexpected inputs dimensions %d, expect to be 3 dimensions"
            % inputs.ndim
        )
    B, m, D = inputs.shape
    x0_rows = inputs.transpose(1, 2).reshape(B * D, m)
    hidden = x0_rows
    final_result = []
    for i, size in enumerate(layer_size):
        x = cin_rows_contract(hidden, x0_rows, kernels[i], biases[i], backend)
        curr_out = apply_activation(act, x, training=training)
        if split_half and i != len(layer_size) - 1:
            # torch.split order (interaction.py:233-234): first half feeds
            # the next layer, second half direct-connects to the output.
            # The first half stays a strided view: the kernel takes its row
            # stride.
            hidden = curr_out[:, : size // 2]
            final_result.append(curr_out[:, size // 2 :])
        else:
            hidden = curr_out
            final_result.append(curr_out)
    return torch.cat(final_result, dim=1)  # [B*D, Fm]


def cin_feature_maps_t(
    inputs, kernels, biases, act, layer_size, split_half, training=False,
    backend=None,
):
    """Transposed feature maps [B, E, featuremap_num] (``interaction.py:249-261``):
    a view of the row-major stack's [B*D, Fm] output, rows (b, d)-major, the
    layout the attention CIN runs in."""
    B, _, D = inputs.shape
    rows = cin_feature_maps_rows(
        inputs, kernels, biases, act, layer_size, split_half, training, backend
    )
    return rows.view(B, D, -1)


def cin_featuremap_num(layer_size, split_half):
    return (
        sum(layer_size[:-1]) // 2 + layer_size[-1]
        if split_half
        else sum(layer_size)
    )


class CIN(nn.Module):
    """Compressed Interaction Network (reference: ``interaction.py:159-248``).

    [B, M, E] -> [B, featuremap_num].  ``backend`` (None: by device, or
    "torch") selects the contraction; see :func:`cin_rows_contract`.
    """

    def __init__(
        self,
        field_size: int,
        layer_size: Sequence[int] = (128, 128),
        activation: str = "relu",
        split_half: bool = True,
        l2_reg: float = 1e-5,
        seed: int = 1024,
        generator: Optional[torch.Generator] = None,
        backend: Optional[str] = None,
    ):
        super().__init__()
        if len(layer_size) == 0:
            raise ValueError(
                "layer_size must be a list(tuple) of length greater than 1"
            )
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        self.layer_size = tuple(layer_size)
        self.split_half = split_half
        self.backend = backend
        make_cin_params(self, field_size, self.layer_size, split_half, generator)
        self.act = make_activation(activation)

    def forward(self, inputs, training: bool = False, generator=None):
        """``generator`` is taken for the attention CIN's signature and unused
        (the CIN draws no random numbers)."""
        B, _, D = inputs.shape
        n = len(self.layer_size)
        rows = cin_feature_maps_rows(
            inputs,
            [getattr(self, f"conv_w_{i}") for i in range(n)],
            [getattr(self, f"conv_b_{i}") for i in range(n)],
            self.act, self.layer_size, self.split_half,
            training=training, backend=self.backend,
        )  # [B*D, Fm]
        # sum over the embedding axis == sum the D rows of each example
        return rows.view(B, D, -1).sum(dim=1)


class FM(nn.Module):
    """Order-2 interactions: 0.5*((sum v)^2 - sum v^2) summed over the
    embedding axis (reference: ``interaction.py:12-34``). [B, F, E] -> [B, 1]."""

    def forward(self, inputs):
        square_of_sum = inputs.sum(dim=1, keepdim=True).square()
        sum_of_square = (inputs * inputs).sum(dim=1, keepdim=True)
        return 0.5 * (square_of_sum - sum_of_square).sum(dim=2)


class InteractingLayer(nn.Module):
    """AutoInt multi-head self-attention over fields with residual
    (reference: ``interaction.py:328-394``). [B, F, E] -> [B, F, E].

    ``W_Query``, ``W_Key``, ``W_Value`` and ``W_Res`` are raw [E, E]
    parameters used as ``x @ W`` (the JAX paths), init normal(0.05) from
    ``generator``.  The projections are ``torch.matmul``; the attention takes
    ``ops.lane_attention.lane_mhsa_packed`` when ``use_lane_attention(F)``
    holds, else the plain head-split einsums.  ``backend`` goes to the lane
    route: None (by device) or "torch" (the plain version on any device)."""

    def __init__(
        self,
        embedding_size: int,
        head_num: int = 2,
        use_res: bool = True,
        scaling: bool = False,
        seed: int = 1024,
        generator: Optional[torch.Generator] = None,
        backend: Optional[str] = None,
    ):
        super().__init__()
        if head_num <= 0:
            raise ValueError("head_num must be a int > 0")
        if embedding_size % head_num != 0:
            raise ValueError("embedding_size is not an integer multiple of head_num!")
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        self.embedding_size = embedding_size
        self.head_num = head_num
        self.use_res = use_res
        self.scale = (embedding_size // head_num) ** -0.5 if scaling else 1.0
        self.backend = backend
        names = ("W_Query", "W_Key", "W_Value") + (("W_Res",) if use_res else ())
        E = embedding_size
        for name in names:
            w = torch.empty(E, E).normal_(0.0, 0.05, generator=generator)
            self.register_parameter(name, nn.Parameter(w))

    def forward(self, inputs, training: bool = False):
        if inputs.ndim != 3:
            raise ValueError(
                "Unexpected inputs dimensions %d, expect to be 3 dimensions" % inputs.ndim
            )
        B, F_, E = inputs.shape
        Q, K, V = (inputs @ w for w in (self.W_Query, self.W_Key, self.W_Value))
        if _lane.use_lane_attention(F_):
            result = _lane.lane_mhsa_packed(Q, K, V, self.scale, self.head_num, self.backend)
        else:
            dh = E // self.head_num
            Qr, Kr, Vr = (x.reshape(B, F_, self.head_num, dh) for x in (Q, K, V))
            scores = torch.softmax(torch.einsum("bihk,bjhk->bhij", Qr, Kr) * self.scale, dim=-1)
            result = torch.einsum("bhij,bjhk->bihk", scores, Vr).reshape(B, F_, E)
        if self.use_res:
            result = result + inputs @ self.W_Res
        return torch.relu(result)


class BiInteractionPooling(nn.Module):
    """NFM's pooling: the FM identity kept per embedding entry
    (reference ``interaction.py:37-61``). [B, F, E] -> [B, 1, E]."""

    def forward(self, inputs):
        square_of_sum = inputs.sum(dim=1, keepdim=True).square()
        sum_of_square = (inputs * inputs).sum(dim=1, keepdim=True)
        return 0.5 * (square_of_sum - sum_of_square)


class AFMLayer(nn.Module):
    """Attention over the pairwise products of the fields (reference
    ``interaction.py:251-325``). [B, F, E] -> [B, 1].

    Raw parameters as in the JAX paths: ``attention_W`` [E, A],
    ``attention_b`` [A] (zeros), ``projection_h`` [A, 1] and
    ``projection_p`` [E, 1], the three matrices drawn by
    :func:`glorot_normal_`.  The pairs follow :func:`_pair_indices` and are
    taken by a one-hot product, as the JAX layer takes them: the backward is
    a product too, not a scatter-add.  The layout is the natural [B, P, E]
    (the JAX layer's [E, P, B] is a TPU lane choice; the math is the same).
    Dropout on the attention output draws its mask from ``generator``."""

    def __init__(
        self,
        in_features: int,
        attention_factor: int = 4,
        l2_reg_w: float = 0.0,
        dropout_rate: float = 0.0,
        seed: int = 1024,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        E, A = in_features, attention_factor
        self.dropout_rate = dropout_rate
        self.attention_W = nn.Parameter(glorot_normal_(torch.empty(E, A), generator))
        self.attention_b = nn.Parameter(torch.zeros(A))
        self.projection_h = nn.Parameter(glorot_normal_(torch.empty(A, 1), generator))
        self.projection_p = nn.Parameter(glorot_normal_(torch.empty(E, 1), generator))
        self._select = {}

    def _pair_select(self, x):
        """([P, F] one-hot of each pair's first field, of its second), made
        once for each field count, device and dtype."""
        num_fields = x.shape[1]
        key = (num_fields, str(x.device), x.dtype)
        if key not in self._select:
            row, col = _pair_indices(num_fields)
            eye = torch.eye(num_fields, device=x.device, dtype=x.dtype)
            self._select[key] = (eye[row], eye[col])
        return self._select[key]

    def forward(self, inputs, training: bool = False, generator=None):
        p_row, p_col = self._pair_select(inputs)
        bi = (torch.einsum("bfe,pf->bpe", inputs, p_row)
              * torch.einsum("bfe,pf->bpe", inputs, p_col))  # [B, P, E]
        attention_temp = torch.relu(bi @ self.attention_W + self.attention_b)  # [B, P, A]
        att_score = torch.softmax((attention_temp @ self.projection_h)[:, :, 0], dim=1)
        attention_output = torch.einsum("bp,bpe->be", att_score, bi)
        if training:
            attention_output = dropout(attention_output, self.dropout_rate, generator)
        return attention_output @ self.projection_p


class CrossNet(nn.Module):
    """DCN's cross layers (reference ``interaction.py:397-453``).
    [B, d] -> [B, d]; "vector": x_{l+1} = x_0 (x_l . w_l) + b_l + x_l,
    "matrix": x_{l+1} = x_0 * (W_l x_l + b_l) + x_l.

    ``kernels`` [L, d, 1] or [L, d, d] (each layer's slice drawn by
    :func:`glorot_normal_`) and ``bias`` [L, d, 1] (zeros) are raw
    parameters in the JAX layout: ``kernels`` is not a flax ``kernel``, so
    ``weights.py`` carries it untransposed."""

    def __init__(
        self,
        in_features: int,
        layer_num: int = 2,
        parameterization: str = "vector",
        seed: int = 1024,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if parameterization == "vector":
            kshape = (in_features, 1)
        elif parameterization == "matrix":
            kshape = (in_features, in_features)
        else:
            raise ValueError("parameterization should be 'vector' or 'matrix'")
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        self.layer_num = layer_num
        self.parameterization = parameterization
        self.kernels = nn.Parameter(torch.stack(
            [glorot_normal_(torch.empty(kshape), generator) for _ in range(layer_num)]))
        self.bias = nn.Parameter(torch.zeros(layer_num, in_features, 1))

    def forward(self, inputs, training: bool = False):
        x_0 = x_l = inputs
        for i in range(self.layer_num):
            b = self.bias[i, :, 0]
            if self.parameterization == "vector":
                x_l = x_0 * (x_l @ self.kernels[i]) + b + x_l
            else:
                x_l = x_0 * (x_l @ self.kernels[i].T + b) + x_l
        return x_l


class CrossNetMix(nn.Module):
    """DCN-Mix's low-rank mixture-of-experts cross layers (reference
    ``interaction.py:456-534``). [B, d] -> [B, d].

    Raw parameters in the JAX layout: ``U_list`` and ``V_list``
    [L, K, d, r], ``C_list`` [L, K, r, r], ``gating`` [K, d, 1] and ``bias``
    [L, d, 1] (zeros).  Each layer's [K, a, b] slice of U, V and C is drawn
    normal with torch ``xavier_normal_``'s 3-D fans, std
    sqrt(2 / (a*b + K*b)), as one tensor and not K per-expert draws
    (``interaction.py:482-490``); each expert's gate like an ``nn.Linear``
    weight, U(+-1/sqrt(d))."""

    def __init__(
        self,
        in_features: int,
        low_rank: int = 32,
        num_experts: int = 4,
        layer_num: int = 2,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(1024)
        d, r, K, L = in_features, low_rank, num_experts, layer_num
        self.layer_num = layer_num

        def layers(a, b):
            std = math.sqrt(2.0 / (a * b + K * b))
            return torch.stack([torch.empty(K, a, b).normal_(0.0, std, generator=generator)
                                for _ in range(L)])

        self.U_list = nn.Parameter(layers(d, r))
        self.V_list = nn.Parameter(layers(d, r))
        self.C_list = nn.Parameter(layers(r, r))
        bound = 1.0 / math.sqrt(d)
        self.gating = nn.Parameter(torch.stack(
            [torch.empty(d, 1).uniform_(-bound, bound, generator=generator) for _ in range(K)]))
        self.bias = nn.Parameter(torch.zeros(L, d, 1))

    def forward(self, inputs, training: bool = False):
        x_0 = x_l = inputs  # [B, d]
        gate_w = self.gating[:, :, 0]  # [K, d]
        for i in range(self.layer_num):
            gate = torch.softmax(x_l @ gate_w.T, dim=1)  # [B, K]
            # each expert: V^T x -> tanh -> C -> tanh -> U
            v_x = torch.tanh(torch.einsum("kdr,bd->bkr", self.V_list[i], x_l))
            v_x = torch.tanh(torch.einsum("krs,bks->bkr", self.C_list[i], v_x))
            uv_x = torch.einsum("kdr,bkr->bkd", self.U_list[i], v_x)
            dot_ = x_0[:, None, :] * (uv_x + self.bias[i, :, 0])  # [B, K, d]
            x_l = torch.einsum("bkd,bk->bd", dot_, gate) + x_l
        return x_l


class LogTransformLayer(nn.Module):
    """AFN's logarithmic neurons (reference ``interaction.py:720-757``;
    ``xdeepfm_tpu/nn/interaction.py:636-672``). [B, F, E] -> [B, E * H].

    log(max(|x|, 1e-7)), ``bn0`` per embedding channel over (B, F), the
    weighted field sum ``ltl_weights`` [F, H] plus ``ltl_biases`` [H], exp,
    ``bn1`` per channel of [B, E, H]'s axis 1, flattened.  ``ltl_weights`` is
    drawn N(0, 0.1), ``ltl_biases`` zeros; both BatchNorms eps 1e-5,
    momentum 0.9 (:class:`~xdeepfm_tpu_torch.nn.core.BatchNorm`)."""

    def __init__(self, field_size: int, embedding_size: int, ltl_hidden_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = torch.empty(field_size, ltl_hidden_size).normal_(0.0, 0.1, generator=generator)
        self.ltl_weights = nn.Parameter(w)
        self.ltl_biases = nn.Parameter(torch.zeros(ltl_hidden_size))
        self.bn0 = BatchNorm(embedding_size, eps=1e-5)
        self.bn1 = BatchNorm(embedding_size, axis=1, eps=1e-5)

    def forward(self, inputs, training: bool = False):
        # jnp.clip's maximum: at a tie the gradient splits, as torch.maximum's
        x = torch.log(torch.maximum(inputs.abs(), inputs.new_tensor(1e-7)))
        x = self.bn0(x, training=training)
        x = torch.exp(torch.einsum("bfe,fh->beh", x, self.ltl_weights) + self.ltl_biases)
        x = self.bn1(x, training=training)
        return x.reshape(x.shape[0], -1)
