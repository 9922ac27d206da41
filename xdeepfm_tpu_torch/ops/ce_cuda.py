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

Every product of these runs on the tensor cores in 3xTF32
(``csrc/tc_tf32.cuh``: each fp32 operand split into two TF32 halves and
three products summed, within the plain fp32 version's error of a float64
result).  The forward and the backward's dh kernel compute their logits
through one routine, ``csrc/ce_tc.cuh``'s ``logit_walk``, so the backward's
exp(S - logz) takes the very logits the forward's logz came from.

The bf16 mode (``precision="bf16"``: products of h, W and, in the backward,
dS rounded to bf16, accumulated in fp32, as the JAX package's default) has
kernels of its own in ``csrc/ce_bf16.cu``, on the warpgroup MMA (``wgmma``
m64nNk16 with bf16 operands):

* :func:`ce_round_bf16` — ``ce_round_bf16``: h's valid rows and W rounded to
  bf16 once into the kernels' tiles, the bias padded; the forward makes it
  and the backward reuses it;
* :func:`ce_rows_forward_bf16` — ``ce_fwd_bf16`` (the forward's two TPU
  kernels under their bf16 dots);
* :func:`ce_rows_backward_bf16` — ``ce_bwd_bf16`` (the backward's: its dW
  and dh kernels, both on the rounded tiles).

Beside each is the same function in plain PyTorch (``*_reference``), which
materialises the [F, B, V] logits.  The CPU path and the kernels' checks use
them.  ``precision`` is "fp32" or "bf16"; :func:`ce_rows_forward` and
:func:`ce_rows_backward` take either.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

# the kernels hold h, W and dh/dW tiles of the whole hidden width K in shared
# memory and registers: the shape gate of the kernel route (ops/ce.py)
CE_MAX_K = 64
_ROWS = 128  # rows (and vocabulary columns) of one tile
# The forward and ce_dh_kernel run persistent blocks (2 a SM) that stride
# over items of 64 valid rows x a split of the (head, vocabulary tile) pairs:
# ~32 items a SM with every row valid, ~11 at a third of a Pro batch (the
# training path's share, where 32 beat 16 and 24 and matched 48 on an NVIDIA
# H100 80GB HBM3 at 700.00 W; with every row valid 16 to 48 ran alike).
# ce_dw_kernel has heads x tiles blocks already, cut into row slices to
# about 4 a SM.
_ITEMS_PER_SM = 32
_RESIDENT = 2
_ITEM_ROWS = 64
_DW_BLOCKS_PER_SM = 4
_MAX_PARTIALS = 64


def _valid_mask(num_valid, B, device):
    """[B] float mask of rows below ``num_valid`` (None: all rows)."""
    if num_valid is None:
        return torch.ones(B, device=device)
    nv = torch.as_tensor(num_valid, device=device).reshape(-1)[:1]
    return (torch.arange(B, device=device) < nv).float()


def _bf16(x, precision):
    """x rounded to bf16 under "bf16" (kept in x's dtype), else x."""
    return x.to(torch.bfloat16).to(x.dtype) if precision == "bf16" else x


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
    minus_one = torch.full(t.shape, -1.0, device=dS.device, dtype=dS.dtype)
    dS.scatter_add_(-1, t, minus_one)  # P - onehot
    dS.mul_(g[..., None]).masked_fill_(keep[None, :, None] == 0, 0.0)  # logz is 0 there
    dSp = _bf16(dS, precision)
    dh = torch.matmul(dSp, _bf16(W, precision)).sum(0)
    dW = torch.matmul(dSp.transpose(1, 2), _bf16(h, precision))
    return dh, dW, dS.sum(1)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ce_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "ce_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _I,
               _I, _I, _I, _I, _P],
    "ce_round_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "ce_fwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                    _P],
    "ce_bwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _I,
                    _I, _I, _I, _I, _I, _I, _P],
}


def _launch(name, device, *args):
    """The launcher ``name`` of ``csrc/ce_fwd.cu``, ``ce_bwd.cu`` or (the bf16
    mode's) ``ce_bf16.cu`` on ``device``'s current stream."""
    lib = "ce_bf16" if name.endswith("_bf16") else name
    _build.launch(lib, name, _SIGNATURES[name], device, *args)


def _check(fn, h, W, b, targets, num_valid, precision, **extra):
    """Shared input checks (``targets`` None: not taken).  Returns
    (B, K, V, F) and the int32 [1] device count of valid rows (None: all
    rows)."""
    named = {"h": h, "W": W, "b": b, **({} if targets is None else {"targets": targets}),
             **extra}
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
    given_t = targets is not None
    if h.ndim != 2 or W.ndim != 3 or b.ndim != 2 or (given_t and targets.ndim != 2):
        raise ValueError(f"{fn}: expects h [B, K], W [F, V, K], b [F, V], targets [F, B]")
    B, K = h.shape
    F, V = b.shape
    if W.shape != (F, V, K) or (given_t and targets.shape != (F, B)):
        raise ValueError(
            f"{fn}: shape mismatch h {tuple(h.shape)}, W {tuple(W.shape)}, "
            f"b {tuple(b.shape)}, targets {tuple(targets.shape) if given_t else None}"
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


def _item_split(B, V, F, sms):
    """(splits, pairs per split, persistent blocks) of the item walk that
    the forward and ``ce_dh_kernel`` share: its items are the 64-row tiles
    of the valid rows times the splits of the F * V / 128 (head, tile)
    pairs, about ``_ITEMS_PER_SM`` items per SM with every row valid (at most
    ``_MAX_PARTIALS`` splits), taken by at most ``_RESIDENT`` blocks per SM."""
    row_tiles = -(-B // _ITEM_ROWS)
    pairs = F * -(-V // _ROWS)
    splits = max(1, min(pairs, _MAX_PARTIALS, -(-(_ITEMS_PER_SM * sms) // row_tiles)))
    per_split = -(-pairs // splits)
    splits = -(-pairs // per_split)
    return splits, per_split, min(_RESIDENT * sms, row_tiles * splits)


def forward_split(B, V, F, sms):
    """(splits, pairs per split, blocks, slots) of the forward: the item
    walk of :func:`_item_split`; each split writes two partials (its two
    column warps) of every head it reaches, and at most ceil(tiles / pairs
    per split) + 1 splits reach one head, so ``slots`` partials a head."""
    splits, per_split, blocks = _item_split(B, V, F, sms)
    return splits, per_split, blocks, forward_slots(V, splits, per_split)


def forward_slots(V, splits, per_split):
    """Partials of one head in the forward: two (the column warps) for each
    split that reaches it, at most ceil(V / 128 / per_split) + 1 splits."""
    tiles = -(-V // _ROWS)
    return 2 * min(splits, -(-tiles // per_split) + 1)


def ce_rows_forward(h, W, b, targets, num_valid=None, precision="fp32"):
    """The forward kernel: same contract as
    :func:`ce_rows_forward_reference`, on CUDA tensors (h, W, b fp32; targets
    int64; ``num_valid`` None, an int or an integer device scalar).  "bf16"
    rounds the operands (:func:`ce_round_bf16`) and runs
    :func:`ce_rows_forward_bf16`."""
    (B, K, V, F), nv = _check("ce_rows_forward", h, W, b, targets, num_valid, precision)
    if precision == "bf16":
        return ce_rows_forward_bf16(ce_round_bf16(h, W, b, num_valid), targets, num_valid)
    ll = torch.empty((F, B), device=h.device, dtype=torch.float32)
    logz = torch.empty_like(ll)
    if B == 0 or F == 0:
        return ll, logz
    splits, per_split, blocks, slots = forward_split(B, V, F, _sms(h.device))
    if 3 * slots * F * B >= 2**31:
        raise ValueError("ce_rows_forward: partials exceed 32-bit indexing")
    part = torch.empty((3, slots, F, B), device=h.device, dtype=torch.float32)
    _launch("ce_fwd", h.device, h.data_ptr(), W.data_ptr(), b.data_ptr(), targets.data_ptr(),
            None if nv is None else nv.data_ptr(), ll.data_ptr(), logz.data_ptr(),
            part.data_ptr(), slots, splits, per_split, blocks, B, K, V, F)
    ce_rows_forward.launches += 1
    return ll, logz


def backward_split(B, V, F, sms):
    """(splits, pairs per split, dh blocks, slices, rows per slice) of the
    backward: ``ce_dh_kernel`` walks the items of :func:`_item_split`;
    ``ce_dw_kernel``'s blocks are the F * V / 128 tiles times the row
    slices, about ``_DW_BLOCKS_PER_SM`` per SM, at most ``_MAX_PARTIALS``."""
    splits, per_split, blocks = _item_split(B, V, F, sms)
    pairs = F * -(-V // _ROWS)
    dw_tiles = -(-B // _ROWS)
    slices = max(1, min(dw_tiles, _MAX_PARTIALS, -(-(_DW_BLOCKS_PER_SM * sms) // pairs)))
    rows = -(-dw_tiles // slices) * _ROWS
    return splits, per_split, blocks, -(-B // rows), rows


def ce_rows_backward(g, h, W, b, targets, logz, num_valid=None, precision="fp32"):
    """The backward kernels: same contract as
    :func:`ce_rows_backward_reference` on CUDA tensors, the products in
    3xTF32 on the tensor cores.  "bf16" rounds the operands
    (:func:`ce_round_bf16`) and runs :func:`ce_rows_backward_bf16`."""
    (B, K, V, F), nv = _check("ce_rows_backward", h, W, b, targets, num_valid, precision,
                              g=g, logz=logz)
    if precision == "bf16":
        return ce_rows_backward_bf16(g, ce_round_bf16(h, W, b, num_valid), targets, logz,
                                     num_valid)
    dev = h.device
    dh = torch.empty((B, K), device=dev, dtype=torch.float32)
    dW = torch.empty((F, V, K), device=dev, dtype=torch.float32)
    db = torch.empty((F, V), device=dev, dtype=torch.float32)
    if B == 0 or F == 0:
        return dh.zero_(), dW.zero_(), db.zero_()
    splits, per_split, blocks, slices, rows = backward_split(B, V, F, _sms(dev))
    if slices * F * V * K >= 2**31 or splits * B * K >= 2**31:
        raise ValueError("ce_rows_backward: partial sums exceed 32-bit indexing")
    empty = torch.empty(0, device=dev)
    dh_part = torch.empty((splits, B, K), device=dev)
    dw_part = torch.empty((slices, F, V, K), device=dev) if slices > 1 else empty
    db_part = torch.empty((slices, F, V), device=dev) if slices > 1 else empty
    _launch("ce_bwd", dev, h.data_ptr(), W.data_ptr(), b.data_ptr(), targets.data_ptr(),
            logz.data_ptr(), g.data_ptr(), None if nv is None else nv.data_ptr(),
            dh.data_ptr(), dh_part.data_ptr(), splits, per_split, blocks,
            dW.data_ptr(), db.data_ptr(), dw_part.data_ptr(), db_part.data_ptr(), slices, rows,
            B, K, V, F)
    ce_rows_backward.launches += 1
    return dh, dW, db


# ---------------------------------------------------------------- bf16 mode

# The bf16 kernels' walk (ce_fwd_bf16 and the backward's dh kernel) runs one
# persistent block a SM (a producer warpgroup and two consumers) over items
# of 128 valid rows x a split of the (head, vocabulary tile) pairs, planned
# from B (num_valid stays on the device) for about _BF16_ITEMS_PER_SM items
# a SM with every row valid.
_BF16_ROWS = 128
_BF16_ITEMS_PER_SM = 16


class Rounded(NamedTuple):
    """h, W and b in the bf16 kernels' layout (:func:`ce_round_bf16`): ``hb``
    [Bp * KW] and ``wb`` [F * Vp * KW] bf16 tiles (K zero-padded to KW, a
    multiple of 16; B and V padded to 128), ``bp`` [F, Vp] fp32 (-inf past
    V), and the unpadded shape."""

    hb: torch.Tensor
    wb: torch.Tensor
    bp: torch.Tensor
    B: int
    K: int
    V: int
    F: int

    @property
    def KW(self):
        return -(-self.K // 16) * 16

    @property
    def Vp(self):
        return -(-self.V // _BF16_ROWS) * _BF16_ROWS

    def values(self):
        """(h [B, K], W [F, V, K]) as bf16 and bp: the tiles read back into
        plain layout (tc_tf32.cuh's bf16 tiles: core matrices of 8 rows x 8
        k, row-group major), to hold against :func:`ce_round_bf16_reference`."""
        def untile(flat, rows):
            t = flat.view(rows // 8, self.KW // 8, 8, 8).permute(0, 2, 1, 3)
            return t.reshape(rows, self.KW)

        h = untile(self.hb, self.hb.numel() // self.KW)[: self.B, : self.K]
        W = untile(self.wb, self.F * self.Vp).view(self.F, self.Vp, self.KW)
        return h, W[:, : self.V, : self.K], self.bp


def ce_round_bf16_reference(h, W, b, num_valid=None):
    """The plain version of :func:`ce_round_bf16`, in plain layout: h's rows
    below ``num_valid`` (the rest zero) and W rounded to bf16 (nearest,
    ties to even), b padded with -inf to whole vocabulary tiles."""
    keep = _valid_mask(num_valid, h.shape[0], h.device)
    V = b.shape[1]
    pad = -(-V // _BF16_ROWS) * _BF16_ROWS - V
    return ((h * keep[:, None]).to(torch.bfloat16), W.to(torch.bfloat16),
            torch.nn.functional.pad(b, (0, pad), value=float("-inf")))


def ce_round_bf16(h, W, b, num_valid=None):
    """The ``ce_round_bf16`` kernel: h's rows below ``num_valid`` and W
    rounded to bf16 (nearest, ties to even) once, into the tiles the bf16
    kernels bulk-copy; b padded with -inf to whole vocabulary tiles."""
    (B, K, V, F), nv = _check("ce_round_bf16", h, W, b, None, num_valid, "bf16")
    KW = -(-K // 16) * 16
    Bp = -(-B // _BF16_ROWS) * _BF16_ROWS
    Vp = -(-V // _BF16_ROWS) * _BF16_ROWS
    dev = h.device
    hb = torch.empty(Bp * KW, device=dev, dtype=torch.bfloat16)
    wb = torch.empty(F * Vp * KW, device=dev, dtype=torch.bfloat16)
    bp = torch.empty((F, Vp), device=dev, dtype=torch.float32)
    if B and F:
        _launch("ce_round_bf16", dev, h.data_ptr(), W.data_ptr(), b.data_ptr(),
                None if nv is None else nv.data_ptr(), hb.data_ptr(), wb.data_ptr(),
                bp.data_ptr(), B, K, V, F, KW, Bp, Vp)
        ce_round_bf16.launches += 1
    return Rounded(hb, wb, bp, B, K, V, F)


def bf16_split(B, V, F, sms):
    """(splits, pairs per split, blocks) of the bf16 walk: items of 128 rows
    of B times the splits of the F * V / 128 pairs, about
    ``_BF16_ITEMS_PER_SM`` items a SM (at most ``_MAX_PARTIALS`` splits),
    one persistent block a SM."""
    row_tiles = -(-B // _BF16_ROWS)
    pairs = F * -(-V // _BF16_ROWS)
    splits = max(1, min(pairs, _MAX_PARTIALS, -(-(_BF16_ITEMS_PER_SM * sms) // row_tiles)))
    per = -(-pairs // splits)
    splits = -(-pairs // per)
    return splits, per, min(sms, row_tiles * splits)


def bf16_slots(V, splits, per):
    """Partials of one head in the bf16 forward: one for each split that
    reaches it, at most ceil(V / 128 / per) + 1 splits."""
    tiles = -(-V // _BF16_ROWS)
    return min(splits, -(-tiles // per) + 1)


def _check_rounded(fn, r, targets, num_valid, **extra):
    if not isinstance(r, Rounded):
        raise ValueError(f"{fn}: expects the operands that ce_round_bf16 rounded")
    named = {"targets": targets, **extra}
    for name, t in named.items():
        if not isinstance(t, torch.Tensor) or t.device != r.hb.device or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous tensor on the operands' device")
        want = torch.int64 if name == "targets" else torch.float32
        if t.dtype != want or t.shape != (r.F, r.B):
            raise ValueError(f"{fn}: {name} must be {want} [F, B] = {(r.F, r.B)}")
    if num_valid is None:
        return None
    nv = torch.as_tensor(num_valid, device=r.hb.device)
    if nv.numel() != 1 or nv.dtype.is_floating_point:
        raise ValueError(f"{fn}: num_valid must be one integer on the operands' device")
    return nv.to(torch.int32).reshape(1)


def ce_rows_forward_bf16(r, targets, num_valid=None):
    """The ``ce_fwd_bf16`` kernel on :func:`ce_round_bf16`'s operands: same
    contract as ``ce_rows_forward_reference(..., precision="bf16")``."""
    nv = _check_rounded("ce_rows_forward_bf16", r, targets, num_valid)
    dev = r.hb.device
    ll = torch.empty((r.F, r.B), device=dev, dtype=torch.float32)
    logz = torch.empty_like(ll)
    if r.B == 0 or r.F == 0:
        return ll, logz
    splits, per, blocks = bf16_split(r.B, r.V, r.F, _sms(dev))
    slots = bf16_slots(r.V, splits, per)
    if 3 * slots * r.F * r.B >= 2**31:
        raise ValueError("ce_rows_forward_bf16: partials exceed 32-bit indexing")
    part = torch.empty((3, slots, r.F, r.B), device=dev, dtype=torch.float32)
    _launch("ce_fwd_bf16", dev, r.hb.data_ptr(), r.wb.data_ptr(), r.bp.data_ptr(),
            targets.data_ptr(), None if nv is None else nv.data_ptr(), ll.data_ptr(),
            logz.data_ptr(), part.data_ptr(), slots, splits, per, blocks, r.B, r.K, r.V, r.F,
            r.KW, r.Vp)
    ce_rows_forward_bf16.launches += 1
    return ll, logz


def ce_rows_backward_bf16(g, r, targets, logz, num_valid=None):
    """The ``ce_bwd_bf16`` kernels on :func:`ce_round_bf16`'s operands: same
    contract as ``ce_rows_backward_reference(..., precision="bf16")``."""
    nv = _check_rounded("ce_rows_backward_bf16", r, targets, num_valid, g=g, logz=logz)
    dev = r.hb.device
    B, K, V, F = r.B, r.K, r.V, r.F
    dh = torch.empty((B, K), device=dev, dtype=torch.float32)
    dW = torch.empty((F, V, K), device=dev, dtype=torch.float32)
    db = torch.empty((F, V), device=dev, dtype=torch.float32)
    if B == 0 or F == 0:
        return dh.zero_(), dW.zero_(), db.zero_()
    sms = _sms(dev)
    splits, per, blocks = bf16_split(B, V, F, sms)
    _, _, _, slices, rows = backward_split(B, V, F, sms)
    if slices * F * V * K >= 2**31 or splits * B * K >= 2**31:
        raise ValueError("ce_rows_backward_bf16: partial sums exceed 32-bit indexing")
    empty = torch.empty(0, device=dev)
    dh_part = torch.empty((splits, B, K), device=dev)
    dw_part = torch.empty((slices, F, V, K), device=dev) if slices > 1 else empty
    db_part = torch.empty((slices, F, V), device=dev) if slices > 1 else empty
    _launch("ce_bwd_bf16", dev, r.hb.data_ptr(), r.wb.data_ptr(), r.bp.data_ptr(),
            targets.data_ptr(), logz.data_ptr(), g.data_ptr(),
            None if nv is None else nv.data_ptr(), dh.data_ptr(), dh_part.data_ptr(), splits,
            per, blocks, dW.data_ptr(), db.data_ptr(), dw_part.data_ptr(), db_part.data_ptr(),
            slices, rows, B, K, V, F, r.KW, r.Vp)
    ce_rows_backward_bf16.launches += 1
    return dh, dW, db


ce_rows_forward.launches = 0
ce_rows_backward.launches = 0
ce_round_bf16.launches = 0
ce_rows_forward_bf16.launches = 0
ce_rows_backward_bf16.launches = 0
