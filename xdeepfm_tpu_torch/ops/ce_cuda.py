"""Softmax cross-entropy of vocabulary-sized heads on Hopper: counterpart of
``xdeepfm_tpu/ops/ce_pallas.py``'s kernels.

For F heads that share the hidden state h [B, K] (``nn.Linear`` layout:
W [F, V, K], b [F, V]; targets [F, B] int64), per row r < num_valid:

    ll[f, r] = logsumexp_v (h W[f]^T + b[f])[r, v] - (h W[f]^T + b[f])[r, t[f, r]]

Rows at or past ``num_valid`` give ll = 0 and take and give no gradient.
Each wrapper takes CUDA tensors only, launches its hand-written CUDA kernel
on PyTorch's current stream, raises on bad input and on a failed launch, and
counts its launches in ``<wrapper>.launches``:

* :func:`ce_rows_forward` — ``csrc/ce_fwd.cu`` (replaces ``_ce_fwd`` /
  ``_fwd_kernel`` and ``_ces_fwd`` / ``_fwd_kernel_stacked``);
* :func:`ce_rows_backward` — ``csrc/ce_bwd.cu`` (replaces ``_ce_bwd`` /
  ``_bwd_kernel`` and ``_ces_bwd`` / ``_bwd_kernel_stacked``).

Beside each is the same function in plain PyTorch (``*_reference``), which
materialises the [F, B, V] logits.  The CPU path and the kernels' checks use
them.  ``precision`` is "fp32" or "bf16" (products of h, W and, in the
backward, dS rounded to bf16, accumulated in fp32).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# the kernels hold h, W and dh/dW tiles of the whole hidden width K in shared
# memory and registers: the shape gate of the kernel route (ops/ce.py)
CE_MAX_K = 64
_ROWS = 128  # rows (and vocabulary columns) of one tile
# Blocks per SM the work is split into where the shapes allow, with every row
# valid: the forward runs 2 blocks per SM and the backward 1, and about a
# third of a Pro batch is valid, so the forward and ce_dh_kernel aim at
# several waves; ce_dw_kernel has heads x tiles blocks already.
_FWD_BLOCKS_PER_SM = 16
_DH_BLOCKS_PER_SM = 16
_DW_BLOCKS_PER_SM = 4
_MAX_PARTIALS = 64


def _valid_mask(num_valid, B, device):
    """[B] float mask of rows below ``num_valid`` (None: all rows)."""
    if num_valid is None:
        return torch.ones(B, device=device)
    nv = torch.as_tensor(num_valid, device=device).reshape(-1)[:1]
    return (torch.arange(B, device=device) < nv).float()


def _bf16(x, precision):
    return x.to(torch.bfloat16).float() if precision == "bf16" else x


def _logits(h, W, b, precision):
    """[F, B, V] logits h W[f]^T + b[f]."""
    return torch.matmul(_bf16(h, precision), _bf16(W, precision).transpose(1, 2)) + b[:, None, :]


def ce_rows_forward_reference(h, W, b, targets, num_valid=None, precision="fp32"):
    """(ll, logz), each [F, B]: the logits materialised, ``logsumexp`` minus
    the target's logit; rows at or past ``num_valid`` give 0."""
    S = _logits(h, W, b, precision)
    logz = torch.logsumexp(S, dim=-1)
    picked = S.gather(-1, targets.long()[..., None])[..., 0]
    keep = _valid_mask(num_valid, h.shape[0], h.device)
    return (logz - picked) * keep, logz * keep


def ce_rows_backward_reference(g, h, W, b, targets, logz, num_valid=None, precision="fp32"):
    """(dh [B, K], dW [F, V, K], db [F, V]) for the output gradient g [F, B]:
    dS = (softmax - onehot) * g on the materialised logits, zero for rows at
    or past ``num_valid``; dh sums over heads."""
    keep = _valid_mask(num_valid, h.shape[0], h.device)
    dS = (_logits(h, W, b, precision) - logz[..., None]).exp_()
    t = targets.long()[..., None]
    dS.scatter_add_(-1, t, torch.full(t.shape, -1.0, device=dS.device))  # P - onehot
    dS.mul_(g[..., None]).masked_fill_(keep[None, :, None] == 0, 0.0)  # logz is 0 there
    dSp = _bf16(dS, precision)
    dh = torch.matmul(dSp, _bf16(W, precision)).sum(0)
    dW = torch.matmul(dSp.transpose(1, 2), _bf16(h, precision))
    return dh, dW, dS.sum(1)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ce_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "ce_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I,
               _I, _I, _I, _I, _I, _P],
}
def _launch(name, device, *args):
    """``csrc/<name>.cu``'s launcher ``name`` on ``device``'s current stream."""
    _build.launch(name, name, _SIGNATURES[name], device, *args)


def _check(fn, h, W, b, targets, num_valid, precision, **extra):
    """Shared input checks.  Returns (B, K, V, F) and the int32 [1] device
    count of valid rows (None: all rows)."""
    named = {"h": h, "W": W, "b": b, "targets": targets, **extra}
    for name, t in named.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} must be a CUDA tensor")
        if t.device != h.device:
            raise ValueError(f"{fn}: all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        want = torch.int64 if name == "targets" else torch.float32
        if t.dtype != want:
            raise ValueError(f"{fn}: {name} must be {want}, got {t.dtype}")
    if precision not in ("fp32", "bf16"):
        raise ValueError(f"{fn}: unknown precision {precision!r}")
    if h.ndim != 2 or W.ndim != 3 or b.ndim != 2 or targets.ndim != 2:
        raise ValueError(f"{fn}: expects h [B, K], W [F, V, K], b [F, V], targets [F, B]")
    B, K = h.shape
    F, V = b.shape
    if W.shape != (F, V, K) or targets.shape != (F, B):
        raise ValueError(
            f"{fn}: shape mismatch h {tuple(h.shape)}, W {tuple(W.shape)}, "
            f"b {tuple(b.shape)}, targets {tuple(targets.shape)}"
        )
    for name, t in extra.items():
        if t.shape != (F, B):
            raise ValueError(f"{fn}: {name} must be [F, B] = {(F, B)}, got {tuple(t.shape)}")
    if not 1 <= K <= CE_MAX_K:
        raise ValueError(f"{fn}: hidden width K = {K} outside 1..{CE_MAX_K}")
    if V < 1 or F > 65535:
        raise ValueError(f"{fn}: needs V >= 1 and at most 65535 heads")
    # the kernels' row offsets are 32-bit, counted to the end of the last tile
    if (B + _ROWS) * K >= 2**31 or F * (V + _ROWS) * K >= 2**31:
        raise ValueError(f"{fn}: operands exceed 32-bit indexing")
    nv = None
    if num_valid is not None:
        nv = torch.as_tensor(num_valid, device=h.device)
        if nv.numel() != 1 or nv.dtype.is_floating_point or nv.device != h.device:
            raise ValueError(f"{fn}: num_valid must be one integer on h's device")
        nv = nv.to(torch.int32).reshape(1)
    return (B, K, V, F), nv


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def forward_split(B, V, F, sms):
    """(ranges, tiles per range) of the forward: its B / 128 row tiles times
    F heads times the ranges of the V / 128 vocabulary tiles, about
    ``_FWD_BLOCKS_PER_SM`` blocks per SM, at least 2 tiles per range."""
    n_vt = -(-V // _ROWS)
    want = -(-(_FWD_BLOCKS_PER_SM * sms) // (-(-B // _ROWS) * F))
    per = min(n_vt, max(2, -(-n_vt // want)))
    return -(-n_vt // per), per


def ce_rows_forward(h, W, b, targets, num_valid=None, precision="fp32"):
    """The forward kernel: same contract as
    :func:`ce_rows_forward_reference`, on CUDA tensors (h, W, b fp32; targets
    int64; ``num_valid`` None, an int or an integer device scalar)."""
    (B, K, V, F), nv = _check("ce_rows_forward", h, W, b, targets, num_valid, precision)
    ll = torch.empty((F, B), device=h.device, dtype=torch.float32)
    logz = torch.empty_like(ll)
    if B == 0 or F == 0:
        return ll, logz
    ranges, per_range = forward_split(B, V, F, _sms(h.device))
    part = torch.empty((3, ranges, F, B), device=h.device, dtype=torch.float32)
    _launch("ce_fwd", h.device, h.data_ptr(), W.data_ptr(), b.data_ptr(), targets.data_ptr(),
            None if nv is None else nv.data_ptr(), ll.data_ptr(), logz.data_ptr(),
            part.data_ptr(), ranges, per_range, B, K, V, F, int(precision == "bf16"))
    ce_rows_forward.launches += 1
    return ll, logz


def backward_split(B, V, F, sms):
    """(splits, pairs per split, slices, rows per slice) of the backward:
    ``ce_dh_kernel``'s B / 128 row tiles times the splits of its F * V / 128
    (head, tile) pairs, about ``_DH_BLOCKS_PER_SM`` blocks per SM, and
    ``ce_dw_kernel``'s F * V / 128 tiles times the row slices, about
    ``_DW_BLOCKS_PER_SM``; at most ``_MAX_PARTIALS`` partials each."""
    row_tiles = -(-B // _ROWS)
    pairs = F * -(-V // _ROWS)
    splits = max(1, min(pairs, _MAX_PARTIALS, -(-(_DH_BLOCKS_PER_SM * sms) // row_tiles)))
    per_split = -(-pairs // splits)
    slices = max(1, min(row_tiles, _MAX_PARTIALS, -(-(_DW_BLOCKS_PER_SM * sms) // pairs)))
    rows = -(-row_tiles // slices) * _ROWS
    return -(-pairs // per_split), per_split, -(-B // rows), rows


def ce_rows_backward(g, h, W, b, targets, logz, num_valid=None, precision="fp32"):
    """The backward kernels: same contract as
    :func:`ce_rows_backward_reference` on CUDA tensors."""
    (B, K, V, F), nv = _check("ce_rows_backward", h, W, b, targets, num_valid, precision,
                              g=g, logz=logz)
    dev = h.device
    dh = torch.empty((B, K), device=dev, dtype=torch.float32)
    dW = torch.empty((F, V, K), device=dev, dtype=torch.float32)
    db = torch.empty((F, V), device=dev, dtype=torch.float32)
    if B == 0 or F == 0:
        return dh.zero_(), dW.zero_(), db.zero_()
    splits, per_split, slices, rows = backward_split(B, V, F, _sms(dev))
    if slices * F * V * K >= 2**31 or splits * B * K >= 2**31:
        raise ValueError("ce_rows_backward: partial sums exceed 32-bit indexing")
    empty = torch.empty(0, device=dev)
    dh_part = torch.empty((splits, B, K), device=dev) if splits > 1 else empty
    dw_part = torch.empty((slices, F, V, K), device=dev) if slices > 1 else empty
    db_part = torch.empty((slices, F, V), device=dev) if slices > 1 else empty
    _launch("ce_bwd", dev, h.data_ptr(), W.data_ptr(), b.data_ptr(), targets.data_ptr(),
            logz.data_ptr(), g.data_ptr(), None if nv is None else nv.data_ptr(),
            dh.data_ptr(), dh_part.data_ptr(), splits, per_split,
            dW.data_ptr(), db.data_ptr(), dw_part.data_ptr(), db_part.data_ptr(), slices, rows,
            B, K, V, F, int(precision == "bf16"))
    ce_rows_backward.launches += 1
    return dh, dW, db


ce_rows_forward.launches = 0
ce_rows_backward.launches = 0
