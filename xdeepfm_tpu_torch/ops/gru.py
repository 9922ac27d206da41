"""The GRU / AGRU / AUGRU recurrence with its gradient (port of
``xdeepfm_tpu/ops/gru_pallas.py``'s public surface).

:func:`gru_scan` is a ``torch.autograd.Function`` over the batch-major
operands of ``gru_cuda`` (gi [B, T, 3, H], w [3, H, H], b [3, H], att
[B, T], lengths [B], h0 [B, H] -> outs [B, T, H], frozen past each row's
length).  Its forward and backward dispatch by device: a CUDA tensor goes to
the hand-written Hopper kernels (``gru_cuda.gru_forward`` / ``gru_backward``),
a CPU tensor to their plain PyTorch versions; ``backend="torch"`` runs the
plain versions on any device.  The Function takes int lengths where the JAX
entry takes the float mask valid = t < length, so valid gets no gradient by
construction.  It saves its inputs and outs, from which the backward
recomputes each step (``gru_cuda``'s docstring).

:func:`set_backend` keeps the JAX names: "auto" (default) and "pallas" take
:func:`gru_scan` wherever :func:`fits_kernel` holds, on any device; "xla"
takes the modules' plain step-by-step scan with autograd's backward, the
counterpart of the JAX modules' ``lax.scan``.  Past the shape gate the
modules take that scan too, as the JAX modules do past ``fits_vmem``.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..dispatch import bump
from ._build import fp32_forward
from .gru_cuda import (
    fits_kernel,
    gru_backward,
    gru_backward_reference,
    gru_forward,
    gru_forward_reference,
)

__all__ = ["fits_kernel", "gru_scan", "set_backend", "use_kernel"]


class _GRUScan(torch.autograd.Function):
    @staticmethod
    @fp32_forward
    def forward(ctx, cell, gi, w, b, att, lengths, h0, backend):
        ctx.kernel = backend is None and gi.device.type == "cuda"
        ctx.cell = cell
        outs = (gru_forward if ctx.kernel else gru_forward_reference)(
            cell, gi, w, b, att, lengths, h0)
        ctx.save_for_backward(gi, w, b, att, lengths, h0, outs)
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        gi, w, b, att, lengths, h0, outs = ctx.saved_tensors
        fn = gru_backward if ctx.kernel else gru_backward_reference
        dgi, dw, db, datt, dh0 = fn(ctx.cell, g.contiguous(), gi, w, b, att, lengths, h0, outs)
        return None, dgi, dw, db, None if att is None else datt, None, dh0, None


def gru_scan(cell, gi, w, b, att, lengths, h0, backend=None):
    """The whole recurrence: outs [B, T, H] (frozen past each row's
    length, a length-0 row keeps h0; fp32, float64 for float64 inputs),
    differentiable in gi, w, b, att and h0.  ``cell`` in ("gru", "agru",
    "augru"); ``att`` [B, T] is ignored for "gru" (pass None); ``lengths``
    [B] or [B, 1] ints.  ``backend``: None (by device) or "torch" (the plain
    versions).  On the kernel route the shape
    must pass :func:`fits_kernel`, else it raises."""
    if backend not in (None, "torch"):
        raise ValueError(f"unknown gru_scan backend {backend!r}")
    if cell not in ("gru", "agru", "augru"):
        raise ValueError(f"unknown cell {cell!r}")
    B, T, _, H = gi.shape
    # at least fp32: a bf16 gi (a product under autocast) scans in fp32 and
    # its outs stay fp32, as the TPU kernel keeps its own precision
    out_dt = dt = torch.promote_types(gi.dtype, torch.float32)
    if backend is None and gi.device.type == "cuda":
        if not fits_kernel(T, H, B):
            raise ValueError(f"gru_scan: B {B}, T {T}, H {H} outside the kernels' gate")
        dt = torch.float32  # the kernels compute in fp32, as the TPU kernel
    att = None if cell == "gru" else att.to(dt).contiguous()
    outs = _GRUScan.apply(cell, gi.to(dt).contiguous(), w.to(dt).contiguous(),
                          b.to(dt).contiguous(), att,
                          lengths.reshape(-1).to(torch.int32).contiguous(),
                          h0.to(dt).contiguous(), backend)
    return outs.to(out_dt)


_BACKEND = "auto"


def set_backend(name: str):
    """'auto' (default) or 'pallas': :func:`gru_scan` wherever the shape
    gate holds, the kernels on a CUDA tensor; 'xla': the modules' plain
    scan."""
    global _BACKEND
    if name not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown GRU backend {name!r}")
    if name != _BACKEND:
        bump()
    _BACKEND = name


def use_kernel(T: int, H: int, B: int) -> bool:
    """Dispatch decision of ``GRU`` / ``DynamicGRU``: :func:`gru_scan` unless
    the backend is 'xla' or the shape is past :func:`fits_kernel`."""
    return _BACKEND != "xla" and fits_kernel(T, H, B)
