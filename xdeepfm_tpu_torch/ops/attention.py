"""Small-sequence attention for the attention-pooled CIN (port of
``xdeepfm_tpu/ops/attention_pallas.py``'s public surface).

The CIN-attention variants run MHSA over a few hundred feature maps with
head widths of about 5.  :func:`small_attention` is a
``torch.autograd.Function`` over dh-major [G, dh, S] operands whose forward
and backward dispatch by device: a CUDA tensor goes to the hand-written
Hopper kernels (``attention_cuda.sa_forward`` / ``sa_backward``), a CPU
tensor to their plain PyTorch versions; ``backend="torch"`` runs the plain
versions on any device.  Its forward saves (q, k, v, out, m, inv_z), as
``_sa_fwd`` does; the backward recomputes the scores from them.

:func:`mhsa_attention_packed` (batch-major [B, S, E]) and
:func:`mhsa_attention_packed_t` ([B, E, S], the layout the attention CIN runs
in) split E = heads * dh and route per :func:`set_mhsa_backend`: "auto" and
"pallas" take :func:`small_attention` (the kernel route), "xla" the plain
einsum composition that the JAX package's XLA path computes, with autograd's
backward.  The JAX names are kept so that code written against either
package selects the same routes.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ._build import fp32_forward
from .attention_cuda import (
    check_sa_shape,
    sa_backward,
    sa_backward_reference,
    sa_forward,
    sa_forward_reference,
)

# "fp32" (default, exact) or "bf16": every product operand rounded to bf16,
# sums in fp32 (attention_pallas.py:56-67).  Opt-in, as in the JAX package.
_PRECISION = "fp32"


def set_precision(name: str):
    """'fp32' (default) or 'bf16' (bf16 operands, fp32 accumulation)."""
    global _PRECISION
    if name not in ("fp32", "bf16"):
        raise ValueError(f"unknown attention precision {name!r}")
    _PRECISION = name


class _SmallAttention(torch.autograd.Function):
    @staticmethod
    @fp32_forward
    def forward(ctx, q, k, v, scale, backend):
        ctx.kernel = backend is None and q.device.type == "cuda"
        ctx.scale = scale
        ctx.precision = _PRECISION
        fwd = sa_forward if ctx.kernel else sa_forward_reference
        out, m, inv_z = fwd(q, k, v, scale, ctx.precision)
        ctx.save_for_backward(q, k, v, out, m, inv_z)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, out, m, inv_z = ctx.saved_tensors
        bwd = sa_backward if ctx.kernel else sa_backward_reference
        dq, dk, dv = bwd(g.contiguous(), q, k, v, out, m, inv_z, ctx.scale, ctx.precision)
        return dq, dk, dv, None, None


def small_attention(q, k, v, scale, backend=None):
    """softmax(q^T k * scale) applied to v for dh-major [G, dh, S] operands;
    returns [G, dh, S] fp32, differentiable in q, k and v.  ``backend``: None
    (by device) or "torch" (the plain version).

    The kernels hold one pair's operands in shared memory, so dh <= 16 and
    the backward's stage (:func:`attention_cuda.sa_smem_bytes`) within a
    Hopper block's 227 KB (S up to 2422 at dh = 5); past that it raises, on
    every device, unless ``backend`` is "torch"."""
    if backend not in (None, "torch"):
        raise ValueError(f"unknown small_attention backend {backend!r}")
    G, dh, S = q.shape
    if backend is None:
        check_sa_shape(dh, S)
    return _SmallAttention.apply(
        q.float().contiguous(), k.float().contiguous(), v.float().contiguous(), float(scale),
        backend,
    )


_MHSA_BACKEND = "auto"


def set_mhsa_backend(name: str):
    """'auto' (default) or 'pallas': :func:`small_attention`, the kernel on a
    CUDA tensor; 'xla': the plain einsum composition."""
    global _MHSA_BACKEND
    if name not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown MHSA backend {name!r}")
    _MHSA_BACKEND = name


def get_mhsa_backend() -> str:
    return _MHSA_BACKEND


def _route(backend):
    be = _MHSA_BACKEND if backend == "auto" else backend
    if be not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown MHSA backend {be!r}")
    return "xla" if be == "xla" else "pallas"


def mhsa_attention_packed(Q, K, V, scale, heads, backend: str = "auto", kernel_backend=None):
    """Attention over [B, S, E] with E = heads * dh packed along the last
    axis.  ``backend`` routes as :func:`set_mhsa_backend` ("auto": the
    module setting); ``kernel_backend`` goes to :func:`small_attention`."""
    B, S, E = Q.shape
    dh = E // heads
    if _route(backend) == "pallas":
        def perm(x):
            return x.reshape(B, S, heads, dh).permute(0, 2, 3, 1).reshape(B * heads, dh, S)

        out = small_attention(perm(Q), perm(K), perm(V), scale, kernel_backend)
        return out.reshape(B, heads, dh, S).permute(0, 3, 1, 2).reshape(B, S, E)
    Qr, Kr, Vr = (x.reshape(B, S, heads, dh) for x in (Q, K, V))
    probs = torch.softmax(torch.einsum("bshd,bthd->bhst", Qr, Kr) * scale, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs, Vr).reshape(B, S, E)


def mhsa_attention_packed_t(Q, K, V, scale, heads, backend: str = "auto",
                            kernel_backend=None):
    """Attention over transposed packed-head operands [B, E, S]: the head
    split [B, E, S] -> [B * heads, dh, S] is a free reshape into the kernel's
    dh-major contract."""
    B, E, S = Q.shape
    dh = E // heads
    if _route(backend) == "pallas":
        out = small_attention(*(x.reshape(B * heads, dh, S) for x in (Q, K, V)), scale,
                              kernel_backend)
        return out.reshape(B, E, S)
    Qr, Kr, Vr = (x.reshape(B, heads, dh, S) for x in (Q, K, V))
    probs = torch.softmax(torch.einsum("bhds,bhdt->bhst", Qr, Kr) * scale, dim=-1)
    return torch.einsum("bhst,bhdt->bhds", probs, Vr).reshape(B, E, S)
