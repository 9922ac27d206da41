"""The attention CIN's post-CIN block as one kernel (port of
``xdeepfm_tpu/ops/attn_block_pallas.py``'s public surface).

    x -> [ MHSA(Wq, Wk, Wv, Wo) -> +residual -> LayerNorm ] * L
      -> tanh-MLP attention pooling -> pooled [B, E]

:func:`attn_block` is a ``torch.autograd.Function`` over (x, wq, wk, wv, wo,
gamma, beta, w1, b1, w2) whose forward and backward dispatch by device: a
CUDA tensor goes to the hand-written Hopper kernels
(``attn_block_cuda.ab_forward`` / ``ab_backward``), a CPU tensor to their
plain PyTorch versions (the unfused composition and its autograd gradient);
``backend="torch"`` runs the plain versions on any device.

:func:`set_backend` keeps the JAX names: "auto" (default) and "pallas" take
the fused block, the kernel on a CUDA tensor; "xla" never fuses, and the
attention CIN takes its unfused route through ``ops.attention``.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..dispatch import bump
from ._build import fp32_forward
from .attn_block_cuda import (
    BlockCfg,
    ab_backward,
    ab_backward_reference,
    ab_forward,
    ab_forward_reference,
    check_ab_shape,
)

class _AttnBlock(torch.autograd.Function):
    @staticmethod
    @fp32_forward
    def forward(ctx, cfg, backend, save, *inputs):
        ctx.cfg = cfg
        ctx.kernel = backend is None and inputs[0].device.type == "cuda"
        if ctx.kernel:
            pooled, saved = ab_forward(cfg, *inputs, save=save)
            ctx.save_for_backward(*inputs, *(saved or ()))
        else:
            pooled = ab_forward_reference(cfg, *inputs)
            ctx.save_for_backward(*inputs)
        return pooled

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        saved = ctx.saved_tensors
        inputs, stats = saved[:10], saved[10:]
        if ctx.kernel:
            if not stats:
                raise RuntimeError("attn_block: the forward kept no activations for a backward")
            grads = ab_backward(ctx.cfg, g.contiguous(), *inputs, stats)
        else:
            grads = ab_backward_reference(ctx.cfg, g, *inputs)
        return (None, None, None) + tuple(grads)


def attn_block(cfg: BlockCfg, x, wq, wk, wv, wo, gamma, beta, w1, b1, w2, backend=None):
    """Fused [MHSA + residual + LN] * L + attention pooling.

    x [B, E, S] (the transposed CIN output); wq / wk / wv [L*H, E, dh]; wo
    [L*H, dh, E]; gamma / beta [L, E, 1]; w1 [E, E]; b1 / w2 [E, 1].  Returns
    pooled [B, E], differentiable in all ten.  ``backend``: None (by device)
    or "torch".  The kernel holds a whole batch row in shared memory; past
    that it raises (``check_ab_shape``), on every device, unless ``backend``
    is "torch"."""
    if backend not in (None, "torch"):
        raise ValueError(f"unknown attn_block backend {backend!r}")
    inputs = tuple(t.float().contiguous() for t in (x, wq, wk, wv, wo, gamma, beta, w1, b1, w2))
    if backend is None:
        check_ab_shape(x.shape[1], x.shape[2], cfg.heads, cfg.layers)
    # the forward keeps its activations only when a backward can follow
    save = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
    return _AttnBlock.apply(cfg, backend, save, *inputs)


_BACKEND = "auto"


def set_backend(name: str):
    """'auto' (default) or 'pallas': the fused block; 'xla': never fuse."""
    global _BACKEND
    if name not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown attention-block backend {name!r}")
    if name != _BACKEND:
        bump()
    _BACKEND = name


def use_fused_block(seq_len: int | None = None) -> bool:
    """Whether the attention CIN takes the fused block.  The JAX package also
    refused S % 128 != 0 (``attn_block_pallas.py:645``), a Mosaic lane
    alignment rule; the Hopper kernel has none, so ``seq_len`` no longer
    gates (its shared-memory limit raises in :func:`attn_block` instead)."""
    return _BACKEND != "xla"


def pack_projection(weight, heads):
    """An ``nn.Linear`` projection weight [E_out, E_in] (output channel
    h*dh + d) -> per-head [H, E_in, dh]: ``wq[h, e, d] = weight[h*dh + d, e]``."""
    E_out, E_in = weight.shape
    return weight.reshape(heads, E_out // heads, E_in).transpose(1, 2)


def pack_out_projection(weight, heads):
    """W_o's ``nn.Linear`` weight [E_out, E_in] (input channel h*dh + d) ->
    per-head [H, dh, E_out]: ``wo[h, d, f] = weight[f, h*dh + d]``."""
    E_out, E_in = weight.shape
    return weight.t().reshape(heads, E_in // heads, E_out)
