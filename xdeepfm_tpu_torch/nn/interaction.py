"""Feature-interaction layers (port of ``xdeepfm_tpu/nn/interaction.py``;
reference ``deepctr/layers/interaction.py``): the CIN, FM, AutoInt's
``InteractingLayer``, the FM family's ``BiInteractionPooling``,
``AFMLayer``, ``CrossNet`` and ``CrossNetMix``, AFN's
``LogTransformLayer``, FiBiNET's ``SENETLayer`` and
``BilinearInteraction``, PNN's ``InnerProductLayer`` and
``OutterProductLayer`` and CCPM's ``ConvLayer``.
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

from ..dispatch import Switch
from ..ops import lane_attention as _lane
from ..ops.cin import cin_rows_contract
from .activations import apply_activation, make_activation
from .core import BatchNorm, ConvSame, dropout, glorot_uniform_, torch_linear_init
from .sequence import KMaxPooling


def _pair_indices(num_fields: int):
    """(row, col) of every field pair i < j, row-major (``interaction.py:24``)."""
    row, col = [], []
    for i in range(num_fields - 1):
        for j in range(i + 1, num_fields):
            row.append(i)
            col.append(j)
    return row, col


_PAIR_SELECT = {}


def _pair_onehots(x: torch.Tensor):
    """([P, F] one-hot of each pair's first field, of its second) for
    [B, F, E] ``x`` in :func:`_pair_indices` order, made once for each field
    count, device and dtype, outside inference mode: a pair made by
    ``predict`` serves a later training step too."""
    num_fields = x.shape[1]
    key = (num_fields, str(x.device), x.dtype)
    if key not in _PAIR_SELECT:
        row, col = _pair_indices(num_fields)
        with torch.inference_mode(False):
            eye = torch.eye(num_fields, device=x.device, dtype=x.dtype)
            _PAIR_SELECT[key] = (eye[row], eye[col])
    return _PAIR_SELECT[key]


def pair_fields(x: torch.Tensor, y: Optional[torch.Tensor] = None):
    """([B, P, E] each pair's first field, taken from ``x``; [B, P, E] its
    second field, taken from ``y``, by default ``x``), pairs in
    :func:`_pair_indices` order.  Taken by one-hot products as the JAX
    layers take them (``interaction.py:146-153``): exact in fp32, and their
    backward is a product too, with no atomic scatter-add."""
    p_row, p_col = _pair_onehots(x)
    return (torch.einsum("bfe,pf->bpe", x, p_row),
            torch.einsum("bfe,pf->bpe", x if y is None else y, p_col))


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


def cin_feature_maps(
    inputs, kernels, biases, act, layer_size, split_half, training=False,
    backend=None,
):
    """[B, featuremap_num, E] feature maps (``interaction.py:238-246``): the
    row-major stack's [B*D, Fm] output seen as [B, Fm, D]."""
    B, _, D = inputs.shape
    rows = cin_feature_maps_rows(
        inputs, kernels, biases, act, layer_size, split_half, training, backend
    )
    return rows.view(B, D, -1).transpose(1, 2)


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
    backend = Switch()

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
    backend = Switch()

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
    :func:`glorot_normal_`.  The pairs are taken by :func:`pair_fields`.
    The layout is the natural [B, P, E]
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

    def forward(self, inputs, training: bool = False, generator=None):
        p, q = pair_fields(inputs)
        bi = p * q  # [B, P, E]
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
        # jnp.clip's maximum: at a tie the gradient splits, as torch.maximum's;
        # the floor is filled on the device (no host copy: a CUDA graph
        # captures this forward)
        floor = torch.full((), 1e-7, dtype=inputs.dtype, device=inputs.device)
        x = torch.log(torch.maximum(inputs.abs(), floor))
        x = self.bn0(x, training=training)
        x = torch.exp(torch.einsum("bfe,fh->beh", x, self.ltl_weights) + self.ltl_biases)
        x = self.bn1(x, training=training)
        return x.reshape(x.shape[0], -1)


class SENETLayer(nn.Module):
    """FiBiNET's squeeze-excitation over the fields (reference
    ``interaction.py:64-101``; ``xdeepfm_tpu/nn/interaction.py:55-79``).
    [B, F, E] -> [B, F, E]: each field scaled by relu(fc2(relu(fc1(mean over
    E)))), ``fc1`` [F -> max(1, F // reduction_ratio)] and ``fc2`` back to F,
    both ``nn.Linear`` without bias, drawn as torch's Linear."""

    def __init__(self, filed_size: int, reduction_ratio: int = 3, seed: int = 1024,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        reduction_size = max(1, filed_size // reduction_ratio)
        self.fc1 = nn.Linear(filed_size, reduction_size, bias=False)
        self.fc2 = nn.Linear(reduction_size, filed_size, bias=False)
        for fc in (self.fc1, self.fc2):
            torch_linear_init(fc.weight, generator)

    def forward(self, inputs, training: bool = False):
        if inputs.dim() != 3:
            raise ValueError(
                "Unexpected inputs dimensions %d, expect to be 3 dimensions" % inputs.dim())
        a = torch.relu(self.fc2(torch.relu(self.fc1(inputs.mean(dim=-1)))))
        return inputs * a[:, :, None]


def _linear_slices(n: int, e: int, generator) -> torch.Tensor:
    """[n, e, e]: n independent draws of a torch-Linear [e, e] weight, as
    the JAX ``_stacked_init(torch_linear_init, n)``."""
    out = torch.empty(n, e, e)
    for w in out:
        torch_linear_init(w, generator)
    return out


class BilinearInteraction(nn.Module):
    """FiBiNET's pairwise (v_i W) * v_j (reference ``interaction.py:104-156``;
    ``xdeepfm_tpu/nn/interaction.py:82-143``). [B, F, E] -> [B, P, E], or
    [B, P * E] in (p, e) order with ``flatten_output``.

    ``bilinear_type``: "all" one ``bilinear_all`` [E, E]; "each" one
    ``bilinear_each`` [F, E, E] slice for each first field; "interaction"
    one ``bilinear_inter`` [P, E, E] slice for each pair.  Raw parameters in
    the JAX layout [in, out] (untransposed), each [E, E] slice drawn as a
    torch Linear.  Pairs in :func:`_pair_indices` order through
    :func:`pair_fields`, in the natural [B, P, E] layout (the JAX layer's
    [E, P, B] is a TPU lane choice)."""

    def __init__(self, filed_size: int, embedding_size: int, bilinear_type: str = "interaction",
                 seed: int = 1024, flatten_output: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        F_, E = filed_size, embedding_size
        self.bilinear_type, self.flatten_output = bilinear_type, flatten_output
        if bilinear_type == "all":
            self.bilinear_all = nn.Parameter(_linear_slices(1, E, generator)[0])
        elif bilinear_type == "each":
            self.bilinear_each = nn.Parameter(_linear_slices(F_, E, generator))
        elif bilinear_type == "interaction":
            self.bilinear_inter = nn.Parameter(
                _linear_slices(F_ * (F_ - 1) // 2, E, generator))
        else:
            raise NotImplementedError

    def forward(self, inputs, training: bool = False):
        if inputs.dim() != 3:
            raise ValueError(
                "Unexpected inputs dimensions %d, expect to be 3 dimensions" % inputs.dim())
        if self.bilinear_type == "each":
            # each field projected once, then the pairs taken
            vi, vj = pair_fields(torch.einsum("bfe,fen->bfn", inputs, self.bilinear_each),
                                 inputs)
            out = vi * vj
        else:
            vi, vj = pair_fields(inputs)
            if self.bilinear_type == "all":
                out = (vi @ self.bilinear_all) * vj
            else:
                out = torch.einsum("bpe,pen->bpn", vi, self.bilinear_inter) * vj
        return out.flatten(1) if self.flatten_output else out


class InnerProductLayer(nn.Module):
    """PNN's pairwise inner products (reference ``interaction.py:537-577``;
    ``xdeepfm_tpu/nn/interaction.py:517-538``). [B, F, E] -> [B, P, 1], or
    the products [B, P, E] without ``reduce_sum``."""

    def __init__(self, reduce_sum: bool = True):
        super().__init__()
        self.reduce_sum = reduce_sum

    def forward(self, inputs):
        p, q = pair_fields(inputs)
        return (p * q).sum(dim=-1, keepdim=True) if self.reduce_sum else p * q


class OutterProductLayer(nn.Module):
    """PNN's kernel-weighted outer products (reference
    ``interaction.py:580-672``; ``xdeepfm_tpu/nn/interaction.py:541-582``).
    [B, F, E] -> [B, P].

    One raw parameter ``kernel`` in the JAX layout, drawn by
    :func:`glorot_uniform_`: "mat" [E, P, E], out[b, p] = sum over e1, e2
    of q[b, p, e1] k[e1, p, e2] p[b, p, e2]; "vec" [P, E]; "num" [P, 1].
    It is no flax ``Dense`` kernel: the weights map carries it untransposed
    under its own name."""

    def __init__(self, field_size: int, embedding_size: int, kernel_type: str = "mat",
                 seed: int = 1024, generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        P, E = field_size * (field_size - 1) // 2, embedding_size
        shapes = {"mat": (E, P, E), "vec": (P, E), "num": (P, 1)}
        if kernel_type not in shapes:
            raise ValueError(kernel_type)
        self.kernel_type = kernel_type
        self.kernel = nn.Parameter(glorot_uniform_(torch.empty(shapes[kernel_type]), generator))

    def forward(self, inputs):
        p, q = pair_fields(inputs)
        if self.kernel_type == "mat":
            # tmp[b, p, e1] = sum_e2 p[b, p, e2] k[e1, p, e2]
            return (torch.einsum("bpe,fpe->bpf", p, self.kernel) * q).sum(dim=-1)
        if self.kernel_type == "vec":
            return (p * q * self.kernel).sum(dim=-1)
        return (p * q).sum(dim=-1) * self.kernel[:, 0]


class ConvLayer(nn.Module):
    """CCPM's convolution stack (reference ``interaction.py:675-717``;
    ``xdeepfm_tpu/nn/interaction.py:585-633``): per layer i a SAME
    (width_i, 1) convolution ``conv_{i}`` (:class:`~.core.ConvSame`), tanh, and
    k-max pooling over the field axis down to
    :meth:`output_field_size`'s schedule.  NHWC [B, F, E, 1] ->
    [B, F', E, filters[-1]], the JAX layout, so a flatten gives the JAX
    (f, e, c) order."""

    def __init__(self, field_size: int, conv_kernel_width: Sequence[int],
                 conv_filters: Sequence[int], generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(1024)
        n, l = field_size, len(conv_filters)
        self.n_layers = l
        filed_shape, in_ch = n, 1
        for i in range(1, l + 1):
            k = max(1, int((1 - pow(i / l, l - i)) * n)) if i < l else 3
            self.add_module(f"conv_{i}", ConvSame(in_ch, conv_filters[i - 1],
                                                  (conv_kernel_width[i - 1], 1),
                                                  generator=generator))
            self.add_module(f"pool_{i}", KMaxPooling(k=min(k, filed_shape), axis=1))
            filed_shape, in_ch = min(k, filed_shape), conv_filters[i - 1]

    @staticmethod
    def output_field_size(field_size: int, n_layers: int) -> int:
        """F' after ``n_layers`` layers (``interaction.py:597-607``)."""
        filed_shape = field_size
        for i in range(1, n_layers + 1):
            k = (max(1, int((1 - pow(i / n_layers, n_layers - i)) * field_size))
                 if i < n_layers else 3)
            filed_shape = min(k, filed_shape)
        return filed_shape

    def forward(self, inputs):
        x = inputs
        for i in range(1, self.n_layers + 1):
            x = getattr(self, f"pool_{i}")(torch.tanh(getattr(self, f"conv_{i}")(x)))
        return x
