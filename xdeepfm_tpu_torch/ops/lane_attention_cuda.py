"""Lane attention on Hopper: counterpart of
``xdeepfm_tpu/ops/lane_attention.py``'s kernels.

On operands q, k, v [H, dh, S, B] (H heads of width dh, S <= 64 field
tokens, B samples), per (head, sample): p = softmax_j(scale * q^T k),
o = v p^T.  The operands may be strided views: the kernels take one set of
element strides for every operand of a call, so the projections' [B, S, E]
(E index h * dh + d) viewed as [H, dh, S, B] reach them without a copy.  Each
wrapper takes CUDA fp32 tensors only, launches its hand-written CUDA kernel on
PyTorch's current stream, raises on bad input and on a failed launch, and
counts its launches in ``<wrapper>.launches``:

* :func:`la_forward` — ``csrc/la_fwd.cu`` (replaces ``_la_fwd`` /
  ``_fwd_kernel``): o;
* :func:`la_backward` — ``csrc/la_bwd.cu`` (replaces ``_la_bwd`` /
  ``_bwd_kernel``): (dq, dk, dv), recomputing p from q and k.

As in the TPU kernels, the forward saves nothing but its inputs.  Beside each
is the same function in plain PyTorch (``*_reference``), which materialises
the [H, S, S, B] probabilities; the CPU path and the kernels' checks use
them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LA_MAX_DH = 16  # the kernels' register rows: head widths 1..16
LA_MAX_S = 64  # a warp per (sample, head), a lane per query row: at most two rows a lane
MAX_HEADS = 65535  # the grid's second dimension


def check_la_shape(dh: int, S: int) -> None:
    """The kernels' shape gate; raises ValueError past it (no fallback)."""
    if not 1 <= dh <= LA_MAX_DH:
        raise ValueError(
            f"lane_attention: head width dh = {dh} outside 1..{LA_MAX_DH}; use "
            "backend='torch' or lane_attention.set_backend('xla')"
        )
    if not 1 <= S <= LA_MAX_S:
        raise ValueError(f"lane_attention: S = {S} outside 1..{LA_MAX_S}; use backend='torch'")


def dense_strides(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements tile its storage without gaps or overlaps in
    some order of its dimensions (a permuted contiguous tensor), so that an
    ``empty_like`` output keeps its strides."""
    expected = 1
    for size, stride in sorted(zip(t.shape, t.stride()), key=lambda ss: ss[1]):
        if size == 1:
            continue
        if stride != expected:
            return False
        expected *= size
    return True


def _probs(q, k, scale):
    return torch.softmax(torch.einsum("hdib,hdjb->hijb", q, k) * scale, dim=2)


def la_forward_reference(q, k, v, scale):
    """o [H, dh, S, B] with the [H, S, S, B] probabilities materialised."""
    return torch.einsum("hijb,hdjb->hdib", _probs(q, k, scale), v)


def la_backward_reference(g, q, k, v, scale):
    """(dq, dk, dv) [H, dh, S, B] for the output gradient g: p recomputed,
    then the TPU kernel's steps (``lane_attention.py:93-107``)."""
    p = _probs(q, k, scale)
    dv = torch.einsum("hijb,hdib->hdjb", p, g)
    dp = torch.einsum("hdib,hdjb->hijb", g, v)
    ds = (dp - (dp * p).sum(2, keepdim=True)) * p * scale
    dq = torch.einsum("hijb,hdjb->hdib", ds, k)
    dk = torch.einsum("hijb,hdib->hdjb", ds, q)
    return dq, dk, dv


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "la_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _F, _P],
    "la_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _F, _P],
}
def _launch(name, device, *args):
    """``csrc/<name>.cu``'s launcher ``name`` on ``device``'s current stream."""
    _build.launch(name, name, _SIGNATURES[name], device, *args)


def _check(fn, **named):
    """Shared input checks: CUDA fp32 [H, dh, S, B] tensors of one shape on
    one device, sharing one set of dense strides.  Returns (H, dh, S, B)."""
    first = next(iter(named.values()))
    for name, t in named.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} must be a CUDA tensor")
        if t.device != first.device:
            raise ValueError(f"{fn}: all inputs must be on one device")
        if t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be float32, got {t.dtype}")
        if t.ndim != 4:
            raise ValueError(f"{fn}: expects [H, dh, S, B] operands, got {tuple(t.shape)}")
        if t.shape != first.shape:
            raise ValueError(f"{fn}: {name} must be {tuple(first.shape)}, got {tuple(t.shape)}")
        if t.stride() != first.stride():
            raise ValueError(f"{fn}: every operand must have the strides {first.stride()}, "
                             f"{name} has {t.stride()}")
    if not dense_strides(first):
        raise ValueError(f"{fn}: the operands' strides {first.stride()} leave gaps or overlap")
    H, dh, S, B = first.shape
    if B < 1 or not 1 <= H <= MAX_HEADS:
        raise ValueError(f"{fn}: needs B >= 1 and 1 <= H <= {MAX_HEADS}, got B {B}, H {H}")
    if B > 2**31 - 1:
        raise ValueError(f"{fn}: B = {B} exceeds the grid")
    check_la_shape(dh, S)
    return H, dh, S, B


def la_forward(q, k, v, scale):
    """The forward kernel: same contract as :func:`la_forward_reference`,
    on CUDA fp32 tensors with shared dense strides; o has the same strides."""
    H, dh, S, B = _check("la_forward", q=q, k=k, v=v)
    o = torch.empty_like(q)
    _launch("la_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, S,
            dh, *q.stride(), float(scale))
    la_forward.launches += 1
    return o


def la_backward(g, q, k, v, scale):
    """The backward kernel: same contract as :func:`la_backward_reference`,
    on CUDA fp32 tensors with shared dense strides; the gradients have the
    same strides."""
    H, dh, S, B = _check("la_backward", q=q, k=k, v=v, g=g)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    _launch("la_bwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, S, dh, *q.stride(), float(scale))
    la_backward.launches += 1
    return dq, dk, dv


la_forward.launches = 0
la_backward.launches = 0
