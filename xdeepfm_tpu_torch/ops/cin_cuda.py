"""CIN contraction and its backward on Hopper: counterpart of
``xdeepfm_tpu/ops/cin_pallas.py``.

Each wrapper takes CUDA fp32 tensors only, launches its hand-written CUDA
kernel on PyTorch's current stream, raises on bad input and on a failed
launch, and counts its launches in ``<wrapper>.launches``:

* :func:`cin_rows_forward` — ``csrc/cin_fwd.cu`` (replaces
  ``_fused_contract`` / ``_fwd_kernel``);
* :func:`cin_rows_backward` — ``cin_bwd_dx`` in ``csrc/cin_bwd.cu``, dh and
  dx0 (the dh/dx0 half of ``_bwd_fused_t`` / ``_bwd_kernel``);
* :func:`cin_rows_dw` — ``cin_dw`` in ``csrc/cin_bwd.cu``, dW (replaces
  ``_dw_contract`` / ``_dw_kernel`` and the dW half of ``_bwd_kernel``).

Both backward kernels run on the tensor cores in 3xTF32
(``csrc/tc_tf32.cuh``): each fp32 operand split into two TF32 halves and
three products summed, within the plain fp32 version's error of a float64
result.

Beside each is the same function in plain PyTorch (``*_reference``), the
materialised lowering of ``xdeepfm_tpu/ops/cin.py:114-120`` and of its
gradient.  The CPU path and the kernels' checks use them.
"""

from __future__ import annotations

import ctypes
import functools
import heapq

import torch

from . import _build

# cin_bwd_dx pads each h group's M columns to a power of two up to this
FUSED_MAX_M = 64
_SLOTS_PER_SM = 2  # resident blocks per SM of cin_fwd (launch bounds)
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


def cin_rows_dw_reference(g, h_rows, x0_rows):
    """g [N, O] -> dW [O, H*M]; materialises z as the forward does."""
    N, H = h_rows.shape
    M = x0_rows.shape[1]
    z = (h_rows[:, :, None] * x0_rows[:, None, :]).reshape(N, H * M)
    return g.T @ z


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "cin_fwd": {"cin_fwd": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P]},
    "cin_bwd": {
        "cin_bwd_dx": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
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


def cin_rows_forward(h_rows, x0_rows, W, b):
    """The forward kernel: same contract as :func:`cin_rows_reference`, on
    CUDA fp32 tensors."""
    if W.ndim != 2 or b.ndim != 1:
        raise ValueError("cin_rows_forward: expects W [O, H*M] and b [O]")
    O = W.shape[0]
    named = {"h_rows": h_rows, "x0_rows": x0_rows, "W": W, "b": b}
    N, H, M = _check("cin_rows_forward", named, h_rows, x0_rows, O)
    if W.shape[1] != H * M or b.shape[0] != O:
        raise ValueError(
            f"cin_rows_forward: shape mismatch h {tuple(h_rows.shape)}, "
            f"x0 {tuple(x0_rows.shape)}, W {tuple(W.shape)}, b {tuple(b.shape)}"
        )
    out = torch.empty((N, O), device=h_rows.device, dtype=torch.float32)
    if N == 0 or O == 0:
        return out
    wt = W.t().contiguous()  # [H*M, O]: coalesced channel loads in the kernel
    _launch("cin_fwd", "cin_fwd", h_rows.device, h_rows.data_ptr(), h_rows.stride(0),
            x0_rows.data_ptr(), wt.data_ptr(), b.data_ptr(), out.data_ptr(), N, H, M, O)
    cin_rows_forward.launches += 1
    return out


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


def cin_rows_backward(g, h_rows, x0_rows, W):
    """The ``cin_bwd_dx`` kernel: same contract as
    :func:`cin_rows_backward_reference` on CUDA fp32 tensors, in 3xTF32 on
    the tensor cores; ``g`` must be contiguous and M at most
    ``FUSED_MAX_M``."""
    if g.ndim != 2 or W.ndim != 2:
        raise ValueError("cin_rows_backward: expects g [N, O] and W [O, H*M]")
    O = W.shape[0]
    named = {"g": g, "h_rows": h_rows, "x0_rows": x0_rows, "W": W}
    N, H, M = _check("cin_rows_backward", named, h_rows, x0_rows, O)
    if g.shape != (N, O) or W.shape[1] != H * M:
        raise ValueError(
            f"cin_rows_backward: shape mismatch g {tuple(g.shape)}, h {tuple(h_rows.shape)}, "
            f"x0 {tuple(x0_rows.shape)}, W {tuple(W.shape)}"
        )
    if M > FUSED_MAX_M:
        raise ValueError(f"cin_rows_backward: M = {M} > {FUSED_MAX_M}; use the legacy backward")
    dev = h_rows.device
    if N == 0 or O == 0:
        return h_rows.new_zeros((N, H)), h_rows.new_zeros((N, M))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mp, splits, per = _dx_split(N, H, M, O, _DX_SLOTS_PER_SM * sms)
    if splits * N * M >= 2**31 or N * H >= 2**31 or O * H * mp >= 2**31:
        raise ValueError("cin_rows_backward: operands exceed 32-bit indexing")
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
cin_rows_backward.launches = 0
cin_rows_dw.launches = 0
