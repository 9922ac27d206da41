"""The attention ablation (TPU kernel row 16): three forwards over the same
operands that split the small-attention forward's time between its two
products and its softmax passes.

:func:`ablate_forward` dispatches by device: a CUDA tensor goes to the
variant's hand-written Hopper kernel (``attn_ablate_cuda.ablate_*``,
``csrc/sa_ablate.cu``), a CPU tensor to its plain PyTorch version.  Nothing
falls back: a CUDA tensor the kernel cannot take raises.
"""

from __future__ import annotations

from .attn_ablate_cuda import KERNELS, REFERENCES, VARIANTS


def ablate_forward(variant: str, q, k, v, scale):
    """``variant`` ("full", "dots" or "soft") over dh-major q, k, v
    [G, dh, S] fp32; returns o [G, dh, S]."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown ablation variant {variant!r}; one of {VARIANTS}")
    fn = KERNELS[variant] if q.device.type == "cuda" else REFERENCES[variant]
    return fn(q, k, v, scale)
