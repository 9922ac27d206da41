"""Feature-interaction layers (port of ``xdeepfm_tpu/nn/interaction.py``;
reference ``deepctr/layers/interaction.py``): the CIN, FM and AutoInt's
``InteractingLayer`` so far; the rest of the zoo follows.

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
