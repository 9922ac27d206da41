"""Sequence ops (port of ``xdeepfm_tpu/nn/sequence.py``; reference
``deepctr/layers/sequence.py``): masked pooling, DIN attention pooling,
CCPM's k-max pooling and the GRU / AGRU / AUGRU recurrences over padded
sequences.

The recurrences keep the JAX semantics: the hidden state freezes past each
row's length (packed-sequence behaviour, ``sequence.py:296-320``), the input
projection x_t W_ih^T + b_ih is hoisted out of the loop as one product over
all steps, and the recurrence itself runs in ``ops.gru.gru_scan`` (the
hand-written kernels on a CUDA tensor) where ``ops.gru.use_kernel`` holds,
else in a plain step-by-step scan with autograd's backward, as the JAX
modules take ``lax.scan`` past ``fits_vmem``.  Everything here is
batch-major ([B, T, ...]); the JAX modules' transposed ``call_t`` entries
keep their layouts for the tests that compare the two.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.autograd.function import once_differentiable

from ..ops import gru as gru_ops
from ..ops.gru_cuda import valid_mask
from .core import LocalActivationUnit


def sequence_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """[B, 1] (or [B]) lengths -> bool [B, maxlen] (``sequence.py:38-47``)."""
    return torch.arange(maxlen, device=lengths.device)[None, :] < lengths.reshape(-1, 1)


def sequence_pool(seq_value_len_list, mode="mean", supports_masking=False):
    """Masked sum / mean / max over varlen sequences (``sequence.py:9-77``):
    ``(seq_emb [B, T, E], mask [B, T] bool)`` when ``supports_masking``, else
    ``(seq_emb, length [B, 1])``.  Returns [B, 1, E]."""
    if mode not in ["sum", "mean", "max"]:
        raise ValueError("parameter mode should in [sum, mean, max]")
    seq_emb, other = seq_value_len_list
    if supports_masking:
        mask = other.to(torch.float32)
        length = mask.sum(dim=-1, keepdim=True)
    else:
        length = other
        mask = sequence_mask(length, seq_emb.shape[1]).to(torch.float32)
    mask = mask[:, :, None]
    if mode == "max":
        return (seq_emb - (1 - mask) * 1e9).amax(dim=1, keepdim=True)
    hist = (seq_emb * mask).sum(dim=1)
    if mode == "mean":
        hist = hist / (length.to(torch.float32) + 1e-8)
    return hist[:, None, :]


class SequencePoolingLayer(nn.Module):
    """Module wrapper around :func:`sequence_pool`."""

    def __init__(self, mode: str = "mean", supports_masking: bool = False):
        super().__init__()
        self.mode, self.supports_masking = mode, supports_masking

    def forward(self, seq_value_len_list):
        return sequence_pool(seq_value_len_list, self.mode, self.supports_masking)


_PAD = -(2.0**32) + 1  # the masked score under weight_normalization


class AttentionSequencePoolingLayer(nn.Module):
    """DIN attention pooling (``sequence.py:80-154``): query [B, 1, E], keys
    [B, T, E], keys_length [B, 1] (or mask [B, T]) -> [B, 1, E], or the
    scores [B, 1, T] with ``return_score``.  Parameters: ``local_att``."""

    def __init__(self, att_hidden_units=(80, 40), att_activation="sigmoid",
                 weight_normalization=False, return_score=False, supports_masking=False,
                 embedding_dim=4, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight_normalization = weight_normalization
        self.return_score = return_score
        self.supports_masking = supports_masking
        self.local_att = LocalActivationUnit(
            hidden_units=att_hidden_units, embedding_dim=embedding_dim,
            activation=att_activation, dropout_rate=0.0, use_bn=False, generator=generator,
        )

    def _normalize(self, scores, valid, dim):
        """Masked scores: padding -2^32 + 1 and a softmax over ``dim`` with
        ``weight_normalization`` (a row with no valid step gets a uniform
        softmax), else padding 0."""
        if self.weight_normalization:
            return torch.softmax(scores.masked_fill(~valid, _PAD), dim=dim)
        return scores.masked_fill(~valid, 0.0)

    def forward(self, query, keys, keys_length=None, mask=None, training: bool = False):
        T = keys.shape[1]
        if self.supports_masking:
            if mask is None:
                raise ValueError("When supports_masking=True,input must support masking")
            valid = mask.bool()[:, None, :]
        else:
            valid = sequence_mask(keys_length, T)[:, None, :]
        scores = self.local_att(query, keys, training=training).transpose(1, 2)  # [B, 1, T]
        scores = self._normalize(scores, valid, -1)
        return scores if self.return_score else scores @ keys

    def scores(self, query, keys, lengths, training: bool = False):
        """query [B, E], keys [B, T, E], lengths [B] -> masked (softmax-
        normalised under ``weight_normalization``) scores [B, T]: the JAX
        ``scores_t`` (DIEN's path), batch-major."""
        valid = sequence_mask(lengths, keys.shape[1])
        s = self.local_att(query[:, None, :], keys, training=training)[:, :, 0]
        return self._normalize(s, valid, -1)


class _KMax(torch.autograd.Function):
    """The k largest entries of the last axis, sorted descending; each
    cotangent goes back to its entry's index, written once (the indices of a
    row are distinct), so the backward has no atomics."""

    @staticmethod
    def forward(ctx, x, k):
        # a stable descending sort keeps tied entries in index order: the
        # first occurrence first, as the JAX max-and-mask passes pick it
        idx = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
        ctx.save_for_backward(idx)
        ctx.n = x.shape[-1]
        return x.gather(-1, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return g.new_zeros(*g.shape[:-1], ctx.n).scatter_(-1, idx, g), None


def kmax_lastaxis(x: torch.Tensor, k: int) -> torch.Tensor:
    """The top ``k`` values of the last axis, sorted descending
    (``sequence.py:145-192``).  On a tie the entry of the lower index comes
    first and takes the gradient, as in the JAX function's k max-and-mask
    passes (``torch.topk`` orders ties otherwise).  One path for every k:
    the JAX ``KMaxPooling`` switches to ``lax.top_k`` above k = 32, for the
    TPU's sort; a stable sort serves every k here.  Inputs must be finite,
    as the JAX function requires."""
    return _KMax.apply(x, k)


class KMaxPooling(nn.Module):
    """Top-k along ``axis``, sorted descending (reference
    ``sequence.py:157-189``)."""

    def __init__(self, k: int, axis: int):
        super().__init__()
        self.k, self.axis = k, axis

    def forward(self, inputs):
        if self.axis < 0 or self.axis >= inputs.dim():
            raise ValueError("axis must be 0~%d,now is %d" % (inputs.dim() - 1, self.axis))
        if self.k < 1 or self.k > inputs.shape[self.axis]:
            raise ValueError(
                "k must be in 1 ~ %d,now k is %d" % (inputs.shape[self.axis], self.k))
        top = kmax_lastaxis(inputs.movedim(self.axis, -1), self.k)
        return top.movedim(-1, self.axis)


def _uniform_(t: torch.Tensor, bound: float, generator) -> torch.Tensor:
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def _plain_scan(step, gi, lengths, h, att=None):
    """The recurrence step by step with autograd: ``step(gi_t, h, a_t)`` is
    the new state before masking; the state freezes past each row's length
    (the JAX ``lax.scan`` bodies, ``sequence.py:307-317, 549-553``)."""
    T = gi.shape[1]
    valid = valid_mask(lengths, T, gi.dtype)
    outs = []
    for t in range(T):
        h_new = step(gi[:, t], h, None if att is None else att[:, t : t + 1])
        v = valid[:, t : t + 1]
        h = v * h_new + (1 - v) * h
        outs.append(h)
    return torch.stack(outs, 1)


class GRU(nn.Module):
    """GRU over padded sequences with packed-sequence semantics
    (``sequence.py:250-359``).  Weights normal(init_std), biases
    U(+-1/sqrt(H)).  Parameters ``weight_ih`` [3H, I], ``weight_hh`` [3H, H],
    ``bias_ih``, ``bias_hh`` [3H] (r, z, n).  ``backend``: None (the kernels
    on a CUDA tensor) or "torch" (their plain versions)."""

    def __init__(self, input_size: int, hidden_size: int, init_std: float = 0.001,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        H = self.hidden_size = hidden_size
        bound = 1.0 / math.sqrt(H)
        self.weight_ih = nn.Parameter(torch.empty(3 * H, input_size).normal_(
            0.0, init_std, generator=generator))
        self.weight_hh = nn.Parameter(torch.empty(3 * H, H).normal_(
            0.0, init_std, generator=generator))
        self.bias_ih = nn.Parameter(_uniform_(torch.empty(3 * H), bound, generator))
        self.bias_hh = nn.Parameter(_uniform_(torch.empty(3 * H), bound, generator))
        self.backend = None

    def _step(self, gi_t, h, _a):
        gh = h @ self.weight_hh.T + self.bias_hh
        i_r, i_z, i_n = gi_t.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h

    def run(self, inputs, lengths, h0=None):
        """inputs [B, T, I] -> FROZEN states [B, T, H] (each row's state held
        past its length, so [:, -1] is its last valid state)."""
        B, T, _ = inputs.shape
        H = self.hidden_size
        h = inputs.new_zeros(B, H) if h0 is None else h0
        gi = inputs @ self.weight_ih.T + self.bias_ih  # [B, T, 3H], one product
        if gru_ops.use_kernel(T, H, B):
            return gru_ops.gru_scan("gru", gi.view(B, T, 3, H), self.weight_hh.view(3, H, H),
                                    self.bias_hh.view(3, H), None, lengths, h,
                                    backend=self.backend)
        return _plain_scan(self._step, gi, lengths, h)

    def forward(self, inputs, lengths, h0=None):
        """(outputs [B, T, H] zero past each row's length, h_last [B, H]):
        ``pack_padded_sequence`` + ``pad_packed_sequence(padding_value=0)``."""
        outs = self.run(inputs, lengths, h0)
        valid = valid_mask(lengths, inputs.shape[1], outs.dtype)
        return outs * valid[:, :, None], outs[:, -1]

    def call_t(self, inputs_t, lengths, h0=None):
        """The JAX transposed entry: inputs_t [T, I, B], h0 [H, B] ->
        (frozen outs_t [T, H, B], h_last [H, B])."""
        outs = self.run(inputs_t.permute(2, 0, 1), lengths, None if h0 is None else h0.T)
        outs_t = outs.permute(1, 2, 0)
        return outs_t, outs_t[-1]


class _AttGRUCellBase(nn.Module):
    """Parameters of the AGRU / AUGRU cells (``sequence.py:362-413``):
    weights normal(init_std) when ``init_std`` is set (DIEN's evolution), else
    U(+-1/sqrt(H)); biases zero."""

    def __init__(self, input_size: int, hidden_size: int, use_bias: bool = True,
                 init_std: Optional[float] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        H = self.hidden_size = hidden_size
        self.use_bias = use_bias
        w_ih, w_hh = torch.empty(3 * H, input_size), torch.empty(3 * H, H)
        for t in (w_ih, w_hh):
            if init_std is not None:
                t.normal_(0.0, init_std, generator=generator)
            else:
                _uniform_(t, 1.0 / math.sqrt(H), generator)
        self.weight_ih, self.weight_hh = nn.Parameter(w_ih), nn.Parameter(w_hh)
        if use_bias:
            self.bias_ih = nn.Parameter(torch.zeros(3 * H))
            self.bias_hh = nn.Parameter(torch.zeros(3 * H))

    def project(self, inputs):
        """[..., I] -> hoisted input gates [..., 3H]."""
        gi = inputs @ self.weight_ih.T
        return gi + self.bias_ih if self.use_bias else gi

    def recurrent_bias(self):
        return self.bias_hh if self.use_bias else self.weight_hh.new_zeros(3 * self.hidden_size)

    def _gates(self, gi, hx):
        gh = hx @ self.weight_hh.T + self.recurrent_bias()
        return gi.chunk(3, dim=-1), gh.chunk(3, dim=-1)


class AGRUCell(_AttGRUCellBase):
    """Attention-based GRU: the score replaces the update gate
    (``sequence.py:192-235``)."""

    def step(self, gi_t, h, att_t):
        """gi_t [B, 3H], h [B, H], att_t [B, 1] -> the new h."""
        (i_r, _, i_n), (h_r, _, h_n) = self._gates(gi_t, h)
        r = torch.sigmoid(i_r + h_r)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - att_t) * h + att_t * n

    def forward(self, inputs, hx, att_score):
        return self.step(self.project(inputs), hx, att_score.reshape(-1, 1))


class AUGRUCell(_AttGRUCellBase):
    """GRU with an attentional update gate (``sequence.py:238-282``)."""

    def step(self, gi_t, h, att_t):
        (i_r, i_z, i_n), (h_r, h_z, h_n) = self._gates(gi_t, h)
        r = torch.sigmoid(i_r + h_r)
        z = att_t * torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * h + z * n

    def forward(self, inputs, hx, att_score):
        return self.step(self.project(inputs), hx, att_score.reshape(-1, 1))


class DynamicGRU(nn.Module):
    """AGRU / AUGRU over padded sequences (``sequence.py:455-546``): inputs
    [B, T, I], att_scores [B, T], lengths [B] -> FROZEN states [B, T, H].
    Parameters under ``rnn``.  ``backend`` as :class:`GRU`'s."""

    def __init__(self, input_size: int, hidden_size: int, use_bias: bool = True,
                 gru_type: str = "AGRU", init_std: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cells = {"AGRU": AGRUCell, "AUGRU": AUGRUCell}
        if gru_type not in cells:
            raise NotImplementedError(gru_type)
        self.gru_type, self.hidden_size = gru_type, hidden_size
        self.rnn = cells[gru_type](input_size, hidden_size, use_bias, init_std=init_std,
                                   generator=generator)
        self.backend = None

    def run(self, inputs, att, lengths, h0=None):
        B, T, _ = inputs.shape
        H = self.hidden_size
        h = inputs.new_zeros(B, H) if h0 is None else h0
        gi = self.rnn.project(inputs)  # [B, T, 3H], one product
        if gru_ops.use_kernel(T, H, B):
            return gru_ops.gru_scan(self.gru_type.lower(), gi.view(B, T, 3, H),
                                    self.rnn.weight_hh.view(3, H, H),
                                    self.rnn.recurrent_bias().view(3, H), att, lengths, h,
                                    backend=self.backend)
        return _plain_scan(self.rnn.step, gi, lengths, h, att)

    def forward(self, inputs, att_scores, lengths, hx=None):
        return self.run(inputs, att_scores, lengths, hx)

    def call_t(self, inputs_t, att_t, lengths, hx=None):
        """The JAX transposed entry: inputs_t [T, I, B], att_t [T, 1, B],
        hx [H, B] -> frozen states [T, H, B]."""
        outs = self.run(inputs_t.permute(2, 0, 1), att_t[:, 0, :].T, lengths,
                        None if hx is None else hx.T)
        return outs.permute(1, 2, 0)

