"""CIN contraction and its backward on Hopper: counterpart of
``xdeepfm_tpu/ops/cin_pallas.py``.

Each wrapper takes CUDA fp32 tensors only, launches its hand-written CUDA
kernel on PyTorch's current stream, raises on bad input and on a failed
launch, and counts its launches in ``<wrapper>.launches``:

* :func:`cin_rows_forward` — ``csrc/cin_fwd.cu`` (replaces
  ``_fused_contract`` / ``_fwd_kernel``), on the warpgroup MMA (``wgmma``);
* :func:`cin_rows_backward` — ``cin_bwd_dx`` in ``csrc/cin_bwd.cu``, dh and
  dx0 (the dh/dx0 half of ``_bwd_fused_t`` / ``_bwd_kernel``);
* :func:`cin_rows_dw` — ``cin_dw`` in ``csrc/cin_bwd.cu``, dW (replaces
  ``_dw_contract`` / ``_dw_kernel`` and the dW half of ``_bwd_kernel``).

All three kernels run on the tensor cores in 3xTF32
(``csrc/tc_tf32.cuh``): each fp32 operand split into two TF32 halves and
three products summed, within the plain fp32 version's error of a float64
result.

The bf16 mode (``cin_pallas.set_cin_precision("bf16")``) has kernels of
its own, each designed for its precision:

* :func:`cin_rows_forward_bf16` — ``cin_fwd_bf16``: h, x0 and W rounded to
  bf16, z = bf16(h x0) by packed products, one bf16 ``wgmma`` a k16 step,
  sums in fp32;
* :func:`cin_rows_round_g_bf16` — ``cin_round_g_bf16``: g rounded to bf16
  once, as the backward's bf16 tiles and as the fp32 copy ``cin_dw`` takes;
* :func:`cin_rows_backward_bf16` — ``cin_bwd_dx_bf16``: Z = g W on the
  warpgroup MMA, both operands bf16 from shared memory, dh and dx0 from the
  fp32 h, x0.

Its dW is :func:`cin_rows_dw` fed g rounded to bf16 (the fused backward)
or the raw g (the legacy one), as ``ops/cin.py`` arranges.

Beside each is the same function in plain PyTorch (``*_reference``), the
materialised lowering of ``xdeepfm_tpu/ops/cin.py:114-120`` and of its
gradient, and of the bf16 mode's rounding (``*_reference_bf16``).  The CPU
path and the kernels' checks use them.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
from typing import NamedTuple, Optional

import torch

from . import _build

# cin_bwd_dx pads each h group's M columns to a power of two up to this
FUSED_MAX_M = 64
# cin_fwd takes h blocks of up to this many columns a launch; a wider h is
# cut into blocks whose outputs are added in order
FWD_H_BLOCK = 128
_SLOTS_PER_SM = 2  # cin_sum_slices' grid: up to 8 blocks for each of two slots a SM
_DX_SLOTS_PER_SM = 1  # cin_bwd_dx: one block of 8 warps a SM
_MAX_DX_SPLITS = 8
# A cin_bwd_dx block's own cost (x0, the ring's fill, dx0 at its end) in
# 32-channel stages: fitted to the kernel's times under forced splits at
# the train shapes on an NVIDIA H100 80GB HBM3 at 700.00 W.
_DX_BLOCK_STAGES = 2


def cin_rows_reference(h_rows, x0_rows, W, b):
    """h_rows [N, H], x0_rows [N, M], W [O, H*M] (channel = h*M + m), b [O]
    -> [N, O]; materialises z[n, h*M + m] = h[n, h] * x0[n, m]."""
    N, H = h_rows.shape
    M = x0_rows.shape[1]
    z = (h_rows[:, :, None] * x0_rows[:, None, :]).reshape(N, H * M)
    return z @ W.T + b[None, :]


def cin_rows_backward_reference(g, h_rows, x0_rows, W):
    """g [N, O] -> (dh [N, H], dx0 [N, M]); materialises
    Z[n, h, m] = sum_o g[n, o] W[o, h*M + m]."""
    N, H = h_rows.shape
    M = x0_rows.shape[1]
    Z = (g @ W).reshape(N, H, M)
    return (Z * x0_rows[:, None, :]).sum(2), (Z * h_rows[:, :, None]).sum(1)


def bf16_round(t):
    """``t`` rounded to bf16 (nearest, ties to even), in its own dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def cin_rows_reference_bf16(h_rows, x0_rows, W, b):
    """The bf16 mode's forward (``cin_pallas.py:353-366`` and ``_fwd_kernel``):
    h, x0 and W rounded to bf16, each z = h x0 rounded to bf16 once (the
    product of two bf16 values is exact in fp32), z W^T + b summed in the
    inputs' dtype."""
    N, H = h_rows.shape
    M = x0_rows.shape[1]
    z = bf16_round(bf16_round(h_rows)[:, :, None] * bf16_round(x0_rows)[:, None, :])
    return z.reshape(N, H * M) @ bf16_round(W).T + b[None, :]


def cin_rows_backward_reference_bf16(g, h_rows, x0_rows, W):
    """The bf16 mode's fused dh, dx0 (``_bwd_fused_t``, ``cin_pallas.py:226``):
    Z from g and W rounded to bf16, dh and dx0 from the unrounded h, x0."""
    return cin_rows_backward_reference(bf16_round(g), h_rows, x0_rows, bf16_round(W))


def cin_rows_dw_reference(g, h_rows, x0_rows):
    """g [N, O] -> dW [O, H*M]; materialises z as the forward does."""
    N, H = h_rows.shape
    M = x0_rows.shape[1]
    z = (h_rows[:, :, None] * x0_rows[:, None, :]).reshape(N, H * M)
    return g.T @ z


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "cin_fwd": {
        "cin_fwd": [_P, _I, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "cin_fwd_bf16": [_P, _I, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "cin_bwd": {
        "cin_bwd_dx": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "cin_bwd_dx_bf16": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "cin_round_g_bf16": [_P, _I, _I, _P, _P, _P],
        "cin_dw": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "cin_sum_slices": [_P, _I, ctypes.c_longlong, _P, _I, _P],
    },
}
_GEOMETRY = {}  # cin_dw's tile, read once from the built library


def _launch(lib_name, fn_name, device, *args):
    """``csrc/<lib_name>.cu``'s launcher ``fn_name`` on ``device``'s current
    stream."""
    _build.launch(lib_name, fn_name, _SIGNATURES[lib_name][fn_name], device, *args)


def _check(fn, named, h_rows, x0_rows, O):
    """Shared input checks; ``named`` maps name -> tensor, h_rows and x0_rows
    among them.  Returns (N, H, M)."""
    for name, t in named.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} must be a CUDA tensor")
        if t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be float32, got {t.dtype}")
        if t.device != h_rows.device:
            raise ValueError(f"{fn}: all inputs must be on one device")
    if h_rows.ndim != 2 or x0_rows.ndim != 2:
        raise ValueError(f"{fn}: expects h_rows [N, H] and x0_rows [N, M]")
    N, H = h_rows.shape
    M = x0_rows.shape[1]
    if x0_rows.shape[0] != N:
        raise ValueError(f"{fn}: h_rows has {N} rows, x0_rows {x0_rows.shape[0]}")
    if H == 0 or M == 0:
        raise ValueError(f"{fn}: needs H >= 1 and M >= 1")
    # h may be a column slice of a wider activation (split-half): rows need
    # unit column stride only; the kernels take the row stride.
    if (H > 1 and h_rows.stride(1) != 1) or h_rows.stride(0) < H:
        raise ValueError(f"{fn}: h_rows needs unit column stride")
    for name, t in named.items():
        if name != "h_rows" and not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    # the kernels' element offsets are 32-bit, rows counted up to the end of
    # the last 128-row tile
    if (N + 128) * max(h_rows.stride(0), M, O) >= 2**31 or H * M * O >= 2**31:
        raise ValueError(f"{fn}: operands exceed 32-bit indexing")
    return N, H, M


def _forward(wrapper, fn, h_rows, x0_rows, W, b):
    """``csrc/cin_fwd.cu``'s launcher ``fn`` ("cin_fwd" or "cin_fwd_bf16")
    over h blocks of up to ``FWD_H_BLOCK`` columns, counted on ``wrapper``."""
    name = wrapper.__name__
    if W.ndim != 2 or b.ndim != 1:
        raise ValueError(f"{name}: expects W [O, H*M] and b [O]")
    O = W.shape[0]
    named = {"h_rows": h_rows, "x0_rows": x0_rows, "W": W, "b": b}
    N, H, M = _check(name, named, h_rows, x0_rows, O)
    if W.shape[1] != H * M or b.shape[0] != O:
        raise ValueError(
            f"{name}: shape mismatch h {tuple(h_rows.shape)}, "
            f"x0 {tuple(x0_rows.shape)}, W {tuple(W.shape)}, b {tuple(b.shape)}"
        )
    dev = h_rows.device
    out = torch.empty((N, O), device=dev, dtype=torch.float32)
    if N == 0 or O == 0:
        return out
    grid = torch.cuda.get_device_properties(dev).multi_processor_count
    floats = _build.function("cin_fwd", f"{fn}_scratch_floats", [_I] * 5)
    for h0 in range(0, H, FWD_H_BLOCK):
        hb = min(FWD_H_BLOCK, H - h0)
        n = floats(N, hb, M, O, grid)
        if n < 0:
            raise ValueError(f"{name}: M = {M} does not fit the kernel's shared memory")
        # W staged stage by stage, then the split tail tiles' partial sums
        scratch = torch.empty(n, device=dev, dtype=torch.float32)
        _launch("cin_fwd", fn, dev, h_rows.data_ptr() + 4 * h0, h_rows.stride(0),
                x0_rows.data_ptr(), W.data_ptr(), H * M, h0, b.data_ptr(), scratch.data_ptr(),
                out.data_ptr(), N, hb, M, O, int(h0 > 0), grid)
        wrapper.launches += 1
    return out


def cin_rows_forward(h_rows, x0_rows, W, b):
    """The forward kernel: same contract as :func:`cin_rows_reference`, on
    CUDA fp32 tensors, in 3xTF32 on the tensor cores; one launch for each
    h block of up to ``FWD_H_BLOCK`` columns."""
    return _forward(cin_rows_forward, "cin_fwd", h_rows, x0_rows, W, b)


def cin_rows_forward_bf16(h_rows, x0_rows, W, b):
    """The bf16 mode's forward kernel: same contract as
    :func:`cin_rows_reference_bf16` on CUDA fp32 tensors (rounded inside),
    one bf16 ``wgmma`` a k16 step; one launch for each h block of up to
    ``FWD_H_BLOCK`` columns."""
    return _forward(cin_rows_forward_bf16, "cin_fwd_bf16", h_rows, x0_rows, W, b)


def _slots(device):
    return _SLOTS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count


def _sum_slices(part, out):
    n = out.numel()
    _launch("cin_bwd", "cin_sum_slices", out.device, part.data_ptr(), part.shape[0],
            n, out.data_ptr(), max(1, min(-(-n // 256), 8 * _slots(out.device))))


@functools.lru_cache(maxsize=None)
def _dx_split(N, H, M, O, slots):
    """(mp, splits, chunks per split) for cin_bwd_dx: each split of the
    ceil(H / (128 / mp)) chunks gets its own grid row.  The blocks (128-row
    tiles x splits, in launch order) are list-scheduled over ``slots``
    resident blocks, each taking its chunks' 32-channel stages plus
    ``_DX_BLOCK_STAGES`` of its own; the shortest makespan wins, ties to
    fewer splits (each split writes an [N, M] partial)."""
    mp = 8
    while mp < M:
        mp *= 2
    n_chunks = -(-H // (128 // mp))
    row_tiles = -(-N // 128)
    stages = -(-O // 32)
    best = None
    for per in range(n_chunks, 0, -1):
        splits = -(-n_chunks // per)
        if splits > _MAX_DX_SPLITS:
            break
        ends = [0] * min(slots, row_tiles * splits)
        for s in range(splits):
            busy = (min(n_chunks, (s + 1) * per) - s * per) * stages + _DX_BLOCK_STAGES
            for _ in range(row_tiles):
                heapq.heapreplace(ends, ends[0] + busy)
        if best is None or max(ends) < best[0]:
            best = (max(ends), splits, per)
    return mp, best[1], best[2]


# cin_bwd_dx_bf16: a W stage's channels, and an item's own cost (x0, its
# first stages, dx0 at its end) in such stages
_DXB_STAGE = 64
_DXB_ITEM_STAGES = 2


@functools.lru_cache(maxsize=None)
def _dx_bf16_split(N, H, M, O, grid):
    """(mp, splits, chunks per split) for cin_bwd_dx_bf16, whose ``grid``
    persistent blocks take items i = s * row tiles + rt (split s of the
    ceil(H / (128 / mp)) chunks, row tile rt) in strides of the grid: the
    splits (each but the last ``per`` chunks) whose most loaded block takes
    the fewest W stages win, ties to fewer splits (each split writes an
    [N, M] partial)."""
    mp = 8
    while mp < M:
        mp *= 2
    n_chunks = -(-H // (128 // mp))
    row_tiles = -(-N // 128)
    stages = -(-O // _DXB_STAGE)
    best = None
    for splits in range(1, min(n_chunks, _MAX_DX_SPLITS) + 1):
        per = -(-n_chunks // splits)
        if (splits - 1) * per >= n_chunks:
            continue
        load = [0] * min(grid, row_tiles * splits)
        for i in range(row_tiles * splits):
            s = i // row_tiles
            load[i % len(load)] += (min(n_chunks, (s + 1) * per) - s * per) * stages \
                + _DXB_ITEM_STAGES
        if best is None or max(load) < best[0]:
            best = (max(load), splits, per)
    return mp, best[1], best[2]


def _dw_geometry():
    """cin_dw's (tile rows, tile columns, rows a chunk, blocks a SM), read
    from the built kernel."""
    if not _GEOMETRY:
        vals = [ctypes.c_int() for _ in range(4)]
        fn = _build.function("cin_bwd", "cin_dw_geometry", [ctypes.POINTER(ctypes.c_int)] * 4)
        fn(*map(ctypes.byref, vals))
        _GEOMETRY["dw"] = tuple(v.value for v in vals)
    return _GEOMETRY["dw"]


def _dw_slices(N, H, M, O, slots, bm=128, bn=128, kc=32):
    """(slices, rows per slice) for cin_dw: as many row slices as fill one
    wave of ``slots`` blocks with the output's bm x bn tiles, at least 256
    rows each, each a multiple of the kernel's ``kc`` rows a chunk."""
    tiles = -(-(H * M) // bn) * -(-O // bm)
    slices = max(1, min(slots // tiles, -(-N // 256)))
    rows = -(-N // slices)
    rows = -(-rows // kc) * kc
    return -(-N // rows), rows


class RoundedG(NamedTuple):
    """g rounded to bf16 once (:func:`cin_rows_round_g_bf16`): ``tiles``, the
    bf16 row tiles ``cin_bwd_dx_bf16`` copies, and ``rounded``, the same
    values as fp32 [N, O] (``cin_dw``'s operand; None where not asked for)."""

    tiles: torch.Tensor
    rounded: Optional[torch.Tensor]
    shape: tuple


def cin_rows_round_g_bf16(g, rounded=True):
    """The ``cin_round_g_bf16`` kernel: g [N, O] (CUDA fp32, contiguous)
    rounded to bf16 (nearest, ties to even) once, into the bf16 backward's
    row tiles and, with ``rounded``, into an fp32 [N, O] copy for
    ``cin_dw`` (the plain version is :func:`bf16_round`)."""
    name = "cin_rows_round_g_bf16"
    if not isinstance(g, torch.Tensor) or g.device.type != "cuda":
        raise ValueError(f"{name}: g must be a CUDA tensor")
    if g.dtype != torch.float32 or g.ndim != 2 or not g.is_contiguous():
        raise ValueError(f"{name}: g must be a contiguous float32 [N, O], got {g.dtype} "
                         f"{tuple(g.shape)}")
    N, O = g.shape
    n = _build.function("cin_bwd", "cin_bwd_dx_bf16_g_elems", [_I] * 2)(N, O) if N and O else 0
    if n < 0:
        raise ValueError(f"{name}: operands exceed 32-bit indexing")
    tiles = torch.empty(n, device=g.device, dtype=torch.bfloat16)
    out = torch.empty_like(g) if rounded else None
    if n:
        _launch("cin_bwd", "cin_round_g_bf16", g.device, g.data_ptr(), N, O,
                0 if out is None else out.data_ptr(), tiles.data_ptr())
        cin_rows_round_g_bf16.launches += 1
    return RoundedG(tiles, out, (N, O))


def cin_rows_backward(g, h_rows, x0_rows, W):
    """The ``cin_bwd_dx`` kernel: same contract as
    :func:`cin_rows_backward_reference` on CUDA fp32 tensors, in 3xTF32 on
    the tensor cores; ``g`` must be contiguous and M at most
    ``FUSED_MAX_M``."""
    name = "cin_rows_backward"
    if g.ndim != 2 or W.ndim != 2:
        raise ValueError(f"{name}: expects g [N, O] and W [O, H*M]")
    O = W.shape[0]
    named = {"g": g, "h_rows": h_rows, "x0_rows": x0_rows, "W": W}
    N, H, M = _check(name, named, h_rows, x0_rows, O)
    if g.shape != (N, O) or W.shape[1] != H * M:
        raise ValueError(
            f"{name}: shape mismatch g {tuple(g.shape)}, h {tuple(h_rows.shape)}, "
            f"x0 {tuple(x0_rows.shape)}, W {tuple(W.shape)}"
        )
    if M > FUSED_MAX_M:
        raise ValueError(f"{name}: M = {M} > {FUSED_MAX_M}; use the legacy backward")
    dev = h_rows.device
    if N == 0 or O == 0:
        return h_rows.new_zeros((N, H)), h_rows.new_zeros((N, M))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mp, splits, per = _dx_split(N, H, M, O, _DX_SLOTS_PER_SM * sms)
    if splits * N * M >= 2**31 or N * H >= 2**31 or O * H * mp >= 2**31:
        raise ValueError(f"{name}: operands exceed 32-bit indexing")
    dh = torch.empty((N, H), device=dev, dtype=torch.float32)
    dx0 = torch.empty((N, M), device=dev, dtype=torch.float32)
    part = dx0 if splits == 1 else torch.empty((splits, N, M), device=dev, dtype=torch.float32)
    wp = torch.empty((O, H * mp), device=dev, dtype=torch.float32)  # W, groups padded to mp
    _launch("cin_bwd", "cin_bwd_dx", dev, g.data_ptr(), W.data_ptr(), wp.data_ptr(),
            h_rows.data_ptr(), h_rows.stride(0), x0_rows.data_ptr(), dh.data_ptr(),
            part.data_ptr(), N, H, M, O, mp, splits, per)
    if splits > 1:
        _sum_slices(part, dx0)
    cin_rows_backward.launches += 1
    return dh, dx0


def cin_rows_backward_bf16(g, h_rows, x0_rows, W):
    """The bf16 mode's ``cin_bwd_dx_bf16`` kernel: same contract as
    :func:`cin_rows_backward_reference_bf16` on CUDA fp32 tensors, on the
    warpgroup MMA (``wgmma`` m64n128k16 bf16); ``g`` contiguous, or what
    :func:`cin_rows_round_g_bf16` made of it (else that pass runs first), M
    at most ``FUSED_MAX_M``."""
    name = "cin_rows_backward_bf16"
    if W.ndim != 2:
        raise ValueError(f"{name}: expects g [N, O] and W [O, H*M]")
    O = W.shape[0]
    raw = not isinstance(g, RoundedG)
    named = {"h_rows": h_rows, "x0_rows": x0_rows, "W": W, **({"g": g} if raw else {})}
    N, H, M = _check(name, named, h_rows, x0_rows, O)
    shape = tuple(g.shape) if raw else g.shape
    if shape != (N, O) or W.shape[1] != H * M:
        raise ValueError(
            f"{name}: shape mismatch g {shape}, h {tuple(h_rows.shape)}, "
            f"x0 {tuple(x0_rows.shape)}, W {tuple(W.shape)}"
        )
    if M > FUSED_MAX_M:
        raise ValueError(f"{name}: M = {M} > {FUSED_MAX_M}; use the legacy backward")
    dev = h_rows.device
    if N == 0 or O == 0:
        return h_rows.new_zeros((N, H)), h_rows.new_zeros((N, M))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mp, splits, per = _dx_bf16_split(N, H, M, O, sms)
    n = _build.function("cin_bwd", "cin_bwd_dx_bf16_w_elems", [_I] * 3)(H, O, mp)
    if n < 0 or splits * N * M >= 2**31 or N * H >= 2**31:
        raise ValueError(f"{name}: operands exceed 32-bit indexing")
    if raw:
        g = cin_rows_round_g_bf16(g, rounded=False)
    if g.tiles.device != dev:
        raise ValueError(f"{name}: all inputs must be on one device")
    dh = torch.empty((N, H), device=dev, dtype=torch.float32)
    dx0 = torch.empty((N, M), device=dev, dtype=torch.float32)
    part = dx0 if splits == 1 else torch.empty((splits, N, M), device=dev, dtype=torch.float32)
    wt = torch.empty(n, device=dev, dtype=torch.bfloat16)  # W's bf16 stages
    _launch("cin_bwd", "cin_bwd_dx_bf16", dev, g.tiles.data_ptr(), W.data_ptr(), wt.data_ptr(),
            h_rows.data_ptr(), h_rows.stride(0), x0_rows.data_ptr(), dh.data_ptr(),
            part.data_ptr(), N, H, M, O, mp, splits, per)
    if splits > 1:
        _sum_slices(part, dx0)
    cin_rows_backward_bf16.launches += 1
    return dh, dx0


def cin_rows_dw(g, h_rows, x0_rows):
    """The ``cin_dw`` kernel: same contract as :func:`cin_rows_dw_reference`
    on CUDA fp32 tensors, in 3xTF32 on the tensor cores; ``g`` must be
    contiguous."""
    if g.ndim != 2:
        raise ValueError("cin_rows_dw: expects g [N, O]")
    O = g.shape[1]
    named = {"g": g, "h_rows": h_rows, "x0_rows": x0_rows}
    N, H, M = _check("cin_rows_dw", named, h_rows, x0_rows, O)
    if g.shape[0] != N:
        raise ValueError(f"cin_rows_dw: g has {g.shape[0]} rows, h_rows {N}")
    dev = h_rows.device
    if N == 0 or O == 0:
        return h_rows.new_zeros((O, H * M))
    dW = torch.empty((O, H * M), device=dev, dtype=torch.float32)
    bm, bn, kc, per_sm = _dw_geometry()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slices, rows = _dw_slices(N, H, M, O, per_sm * sms, bm, bn, kc)
    if slices * O * H * M >= 2**31:
        raise ValueError("cin_rows_dw: operands exceed 32-bit indexing")
    part = dW if slices == 1 else torch.empty(
        (slices, O, H * M), device=dev, dtype=torch.float32
    )
    _launch("cin_bwd", "cin_dw", dev, g.data_ptr(), h_rows.data_ptr(), h_rows.stride(0),
            x0_rows.data_ptr(), part.data_ptr(), N, H, M, O, slices, rows)
    if slices > 1:
        _sum_slices(part, dW)
    cin_rows_dw.launches += 1
    return dW


cin_rows_forward.launches = 0
cin_rows_forward_bf16.launches = 0
cin_rows_backward.launches = 0
cin_rows_backward_bf16.launches = 0
cin_rows_round_g_bf16.launches = 0
cin_rows_dw.launches = 0
