"""Fused softmax cross-entropy for the vocabulary-sized SFG decoder heads
(port of ``xdeepfm_tpu/ops/ce_pallas.py``'s public surface).

Per row, ``logsumexp(h W^T + b) - (h W^T + b)[target]`` without keeping the
[B, V] logits: at the canonical Pro step (26 heads of vocabulary 10000, batch
4096, hidden 64) they would take 4.3 GB.  :func:`fused_ce_rows` (one head)
and :func:`fused_ce_rows_stacked` (F heads of one shape) are
``torch.autograd.Function``s whose forward and backward dispatch by device: a
CUDA tensor goes to the hand-written Hopper kernels (``ce_cuda.ce_rows_forward``
and ``ce_rows_backward``), a CPU tensor to their plain PyTorch versions.
``backend="torch"`` runs the plain versions on any device.

Heads take the ``nn.Linear`` layout, W [V, K] (stacked [F, V, K]): the JAX
package's kernels are [K, V], its transpose.  Rows at or past ``num_valid``
give 0 and take and give no gradient; callers sort the rows that count to the
front (:func:`sort_rows_by_mask`).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ._build import fp32_forward
from .ce_cuda import (
    CE_MAX_K,
    Rounded,
    ce_round_bf16,
    ce_rows_backward,
    ce_rows_backward_bf16,
    ce_rows_backward_reference,
    ce_rows_forward,
    ce_rows_forward_bf16,
    ce_rows_forward_reference,
)

_NEG = -1e30  # pad-column bias: exp underflows to 0, never the row max

# The JAX package defaults to bf16 operands with fp32 accumulation, which is
# what XLA's default matmul precision does on the TPU.  The port runs every
# product in fp32 with TF32 off, so its default is "fp32"; "bf16" rounds h, W
# (and dS in the backward) to bf16 before the fp32 sums, as JAX does, on the
# card through the bf16 kernels (ops/csrc/ce_bf16.cu).
_PRECISION = "fp32"


def set_precision(name: str):
    """'fp32' (default) or 'bf16' (bf16 operands, fp32 accumulation)."""
    global _PRECISION
    if name not in ("fp32", "bf16"):
        raise ValueError(f"unknown CE precision {name!r}")
    _PRECISION = name


_STACK_HEADS = True


def set_stack_heads(flag: bool):
    """Stacked-heads decoder path: one kernel launch for all heads of one
    128-padded vocabulary (``pro/sfg.py`` buckets them); on by default, as in
    the JAX package."""
    global _STACK_HEADS
    _STACK_HEADS = bool(flag)


def stack_heads_enabled() -> bool:
    return _STACK_HEADS


def fits_kernel(B: int, K: int) -> bool:
    """The kernel route's shape gate, standing for ``fits_vmem``: the kernels
    hold tiles of the whole hidden width K <= 64 in shared memory and
    registers, and index rows with 32-bit offsets.  Callers take the remat
    path when this is False."""
    return 1 <= K <= CE_MAX_K and (B + 128) * K < 2**31


class _CERows(torch.autograd.Function):
    @staticmethod
    @fp32_forward
    def forward(ctx, h, W, b, targets, num_valid, backend):
        ctx.kernel = backend is None and h.device.type == "cuda"
        ctx.precision = _PRECISION
        ctx.num_valid = num_valid
        if ctx.kernel and ctx.precision == "bf16":
            # the operands rounded once, their tiles kept for the backward
            r = ce_round_bf16(h, W, b, num_valid)
            ll, logz = ce_rows_forward_bf16(r, targets, num_valid)
            ctx.shape = r[3:]
            ctx.save_for_backward(r.hb, r.wb, r.bp, targets, logz)
            return ll
        fwd = ce_rows_forward if ctx.kernel else ce_rows_forward_reference
        ll, logz = fwd(h, W, b, targets, num_valid, ctx.precision)
        ctx.save_for_backward(h, W, b, targets, logz)
        return ll

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        if ctx.kernel and ctx.precision == "bf16":
            hb, wb, bp, targets, logz = ctx.saved_tensors
            dh, dW, db = ce_rows_backward_bf16(g.contiguous(), Rounded(hb, wb, bp, *ctx.shape),
                                               targets, logz, ctx.num_valid)
            return dh, dW, db, None, None, None
        h, W, b, targets, logz = ctx.saved_tensors
        bwd = ce_rows_backward if ctx.kernel else ce_rows_backward_reference
        dh, dW, db = bwd(g.contiguous(), h, W, b, targets, logz, ctx.num_valid, ctx.precision)
        return dh, dW, db, None, None, None


def _apply(h, W, b, targets, num_valid, backend):
    if backend not in (None, "torch"):
        raise ValueError(f"unknown CE backend {backend!r}")
    return _CERows.apply(
        h.float().contiguous(), W.float().contiguous(), b.float().contiguous(),
        targets.long().contiguous(), num_valid, backend,
    )


def fused_ce_rows_stacked(h, Ws, bs, targets, num_valid=None, backend=None):
    """Per-row CE for F heads of one shape in one launch.

    h [B, K]; Ws [F, V, K] or a list of F [V, K]; bs [F, V] or a list of F
    [V]; targets [F, B] -> [F, B] fp32.  Callers bucket heads by 128-padded
    vocabulary and pad W with zeros and b with ``_NEG``.  ``num_valid`` (None,
    an int or an integer device scalar): rows at or past it give 0 and take
    and give no gradient.  ``backend``: None (by device) or "torch"."""
    if not isinstance(Ws, torch.Tensor):
        Ws, bs = torch.stack(list(Ws)), torch.stack(list(bs))
    return _apply(h, Ws, bs, targets, num_valid, backend)


def fused_ce_rows(h, W, b, targets, num_valid=None, backend=None):
    """Per-row softmax cross-entropy of one head without keeping its logits:
    h [B, K], W [V, K], b [V], targets [B] -> [B] fp32, differentiable in h,
    W and b.  ``num_valid`` and ``backend``: see
    :func:`fused_ce_rows_stacked`."""
    return _apply(h, W[None], b[None], targets.reshape(1, -1), num_valid, backend)[0]


# ---------------------------------------------------------------------------
# row-permutation helpers for the masked-CE path
# ---------------------------------------------------------------------------


class _PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return x.index_select(0, perm)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return g.index_select(0, inv), None, None


class _UnpermuteCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(perm)
        return x.index_select(1, inv)

    @staticmethod
    def backward(ctx, g):
        (perm,) = ctx.saved_tensors
        return g.index_select(1, perm), None, None


def permute_rows(x, perm, inv):
    """``x[perm]`` along axis 0 whose backward is a gather by the inverse
    permutation ``inv`` instead of a scatter-add (``perm`` must be a
    permutation and ``inv`` its inverse, as :func:`sort_rows_by_mask` gives)."""
    return _PermuteRows.apply(x, perm, inv)


def unpermute_cols(x, perm, inv):
    """``x[:, inv]`` along axis 1 (undo a row sort on per-head [F, B] CE
    values); its backward gathers by ``perm``."""
    return _UnpermuteCols.apply(x, perm, inv)


def sort_rows_by_mask(mask):
    """(perm, inv, num_valid) putting the rows with mask > 0 first, in order
    (stable); ``num_valid`` stays on the device, so no host sync."""
    keep = mask.reshape(-1) > 0
    perm = torch.argsort((~keep).to(torch.int32), stable=True)
    inv = torch.argsort(perm)
    return perm, inv, keep.sum()
