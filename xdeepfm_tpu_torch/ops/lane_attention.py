"""Field-axis attention for small sequence lengths (port of
``xdeepfm_tpu/ops/lane_attention.py``'s public surface).

AutoInt's and DIFM's ``InteractingLayer`` runs multi-head self-attention over
S ~ 26-40 field tokens with head widths of ~5.  :func:`lane_attention` is a
``torch.autograd.Function`` over [H, dh, S, B] operands (the TPU kernel's
layout, the batch last) whose forward and backward dispatch by device: a
CUDA tensor goes to the hand-written Hopper kernels
(``lane_attention_cuda.la_forward`` / ``la_backward``), a CPU tensor to their
plain PyTorch versions; ``backend="torch"`` runs the plain versions on any
device.  As the TPU kernel, it saves only q, k and v; the backward recomputes
the probabilities.

The operands may be strided views sharing one set of dense strides, so
:func:`lane_mhsa_packed` hands the projections' [B, S, E] to the kernels as
[H, dh, S, B] views, with no relayout either way (the JAX entry transposes to
[E, S, B] and back, and pads the batch to its 128-lane block: neither exists
here, a ragged batch is masked in the kernel).

:func:`set_backend` and :func:`use_lane_attention` keep the JAX names and the
``MAX_S`` gate, so that both packages take corresponding routes: "auto"
(default) and "lanes" take :func:`lane_attention` (the kernel on a CUDA
tensor) for S <= MAX_S on any device, "xla" the plain einsum composition with
autograd's backward.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..dispatch import bump
from ._build import fp32_forward
from .lane_attention_cuda import (
    check_la_shape,
    dense_strides,
    la_backward,
    la_backward_reference,
    la_forward,
    la_forward_reference,
)

MAX_S = 64  # the routing gate, as the JAX package's (lane_attention.py:44)


class _LaneAttention(torch.autograd.Function):
    @staticmethod
    @fp32_forward
    def forward(ctx, q, k, v, scale, backend):
        ctx.kernel = backend is None and q.device.type == "cuda"
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        return (la_forward if ctx.kernel else la_forward_reference)(q, k, v, scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        if ctx.kernel:
            if g.stride() != q.stride():  # the kernel takes one stride set
                g = torch.empty_like(q).copy_(g)
            dq, dk, dv = la_backward(g, q, k, v, ctx.scale)
        else:
            dq, dk, dv = la_backward_reference(g, q, k, v, ctx.scale)
        return dq, dk, dv, None, None


def lane_attention(q, k, v, scale, backend=None):
    """softmax(scale * q^T k) v per (head, sample) over [H, dh, S, B]
    operands; returns [H, dh, S, B] fp32 (on the kernel route with q's
    strides), differentiable in q, k and v.  ``backend``: None (by device) or
    "torch" (the plain version).

    The kernels take dh <= 16 and S <= 64; past that it raises, on every
    device, unless ``backend`` is "torch"."""
    if backend not in (None, "torch"):
        raise ValueError(f"unknown lane_attention backend {backend!r}")
    H, dh, S, B = q.shape
    if backend is None:
        check_la_shape(dh, S)
    q, k, v = (t.float() for t in (q, k, v))
    if not (dense_strides(q) and q.stride() == k.stride() == v.stride()):
        q, k, v = (t.contiguous() for t in (q, k, v))
    return _LaneAttention.apply(q, k, v, float(scale), backend)


_BACKEND = "auto"


def set_backend(name: str):
    """'auto' (default) or 'lanes': :func:`lane_attention` for S <= MAX_S,
    the kernel on a CUDA tensor; 'xla': the plain einsum composition."""
    global _BACKEND
    if name not in ("auto", "xla", "lanes"):
        raise ValueError(f"unknown lane-attention backend {name!r}")
    if name != _BACKEND:
        bump()
    _BACKEND = name


def use_lane_attention(S: int) -> bool:
    """Dispatch decision for field-axis MHSA at sequence length S: the lane
    route unless the backend is 'xla' or S exceeds MAX_S."""
    return _BACKEND != "xla" and S <= MAX_S


def lane_mhsa_packed(Q, K, V, scale, heads, backend=None):
    """Attention over [B, S, E] with E = heads * dh packed along the last
    axis (E index h * dh + d); returns [B, S, E].  The operands reach
    :func:`lane_attention` as [H, dh, S, B] views, and its output, of the
    same strides, comes back as a view.  ``backend`` goes to
    :func:`lane_attention`."""
    B, S, E = Q.shape
    dh = E // heads

    def to_lanes(x):
        return x.float().reshape(B, S, heads, dh).permute(2, 3, 1, 0)

    out = lane_attention(to_lanes(Q), to_lanes(K), to_lanes(V), scale, backend)
    return out.permute(3, 2, 0, 1).reshape(B, S, E)
