"""The GRU / AGRU / AUGRU recurrence on Hopper: counterpart of
``xdeepfm_tpu/ops/gru_pallas.py``'s kernels.

Operands, batch-major (the port's own layout; the TPU kernel put the batch
on the lanes, [T, 3, H, B]):

  gi      [B, T, 3, H]  hoisted input gates x_t W_ih^T + b_ih (r, z, n)
  w       [3, H, H]     recurrent weights, gate-major
  b       [3, H]        recurrent bias
  att     [B, T]        attention scores (None for cell "gru")
  lengths [B] int32     valid steps per row (the TPU kernel's float valid
                        [T, 1, B] is t < lengths)
  h0      [B, H]
  outs    [B, T, H]     h after each step, FROZEN past each row's length

Per step, r = sigmoid(gi_r + W_r h + b_r), n = tanh(gi_n + r (W_n h + b_n)),
u = 1 - sigmoid(gi_z + W_z h + b_z) (gru), att (agru) or
att sigmoid(gi_z + W_z h + b_z) (augru), and h' = h + valid u (n - h).

Each wrapper takes CUDA fp32 contiguous tensors (int32 lengths), launches
its hand-written CUDA kernel on PyTorch's current stream, raises on bad input
and on a failed launch, and counts its launches in ``<wrapper>.launches``:

* :func:`gru_forward` — ``csrc/gru_fwd.cu`` (replaces ``_gs_fwd`` /
  ``_fwd_kernel``): outs;
* :func:`gru_backward` — ``csrc/gru_bwd.cu`` (replaces ``_gs_bwd`` /
  ``_bwd_kernel``): (dgi, dw, db, datt, dh0) for the cotangent of outs.

The history the backward needs is the forward's own output: h before step t
is outs[:, t - 1] (h0 at t = 0), so the backward takes outs and recomputes
r, z, n and W_n h + b_n from it step by step.  Nothing beyond outs is saved
and no scratch history is written (the TPU kernel re-ran the whole forward
into VMEM).  Beside each kernel is the same function in plain PyTorch
(``*_reference``); the CPU path and the kernels' checks use them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

CELLS = {"gru": 0, "agru": 1, "augru": 2}
GRU_MAX_H = 16  # the widest sample the kernels are built for (a lane a unit)
WARPS = 4  # warps per block of the backward kernel (csrc/gru_bwd.cu)


def lanes_per_sample(H: int) -> int:
    """A sample's lanes in the kernels: exactly one a hidden unit."""
    return H


def samples_per_warp(H: int) -> int:
    """The samples a warp holds: as many H-lane groups as fit 32 lanes."""
    return 32 // lanes_per_sample(H)


def backward_blocks(B: int, H: int) -> int:
    """Blocks of the backward kernel, hence its per-block dW / db partials."""
    per = WARPS * samples_per_warp(H)
    return (B + per - 1) // per


def fits_kernel(T: int, H: int, B: int) -> bool:
    """The kernels' shape gate: a hidden width of 1..16 (one sample's units
    are H lanes of one warp); any T >= 1 and B >= 1."""
    return 1 <= H <= GRU_MAX_H and T >= 1 and B >= 1


def valid_mask(lengths: torch.Tensor, T: int, dtype) -> torch.Tensor:
    """[B] lengths -> [B, T] validity (t < length) as ``dtype``."""
    return (torch.arange(T, device=lengths.device)[None, :] < lengths.reshape(-1, 1)).to(dtype)


def _gates(cell, gi_t, w, b, a, h):
    """(r, zu, n, hn, u) of one step: gi_t [B, 3, H], a [B, 1] or None,
    h [B, H]; zu is None for agru."""
    B, _, H = gi_t.shape
    gh = (h @ w.reshape(3 * H, H).T).reshape(B, 3, H) + b
    r = torch.sigmoid(gi_t[:, 0] + gh[:, 0])
    hn = gh[:, 2]
    n = torch.tanh(gi_t[:, 2] + r * hn)
    if cell == "agru":
        return r, None, n, hn, a
    zu = torch.sigmoid(gi_t[:, 1] + gh[:, 1])
    return r, zu, n, hn, (1.0 - zu) if cell == "gru" else a * zu


def gru_forward_reference(cell, gi, w, b, att, lengths, h0):
    """outs [B, T, H] (frozen past each row's length), in gi's dtype."""
    T = gi.shape[1]
    valid = valid_mask(lengths, T, gi.dtype)
    h, outs = h0, []
    for t in range(T):
        a = None if att is None else att[:, t : t + 1]
        _, _, n, _, u = _gates(cell, gi[:, t], w, b, a, h)
        h = h + (valid[:, t : t + 1] * u) * (n - h)
        outs.append(h)
    return torch.stack(outs, 1)


def gru_backward_reference(cell, g, gi, w, b, att, lengths, h0, outs):
    """(dgi [B, T, 3, H], dw [3, H, H], db [3, H], datt [B, T], dh0 [B, H])
    for the cotangent g [B, T, H] of outs: the TPU kernel's reverse sweep
    (``gru_pallas.py:138-188``) with h before step t read from outs."""
    B, T, _, H = gi.shape
    valid = valid_mask(lengths, T, gi.dtype)
    dgi = torch.zeros_like(gi)
    datt = gi.new_zeros(B, T)
    dw = w.new_zeros(3, H, H)
    db = w.new_zeros(3, H)
    dh = g.new_zeros(B, H)
    zero = g.new_zeros(B, H)
    for t in range(T - 1, -1, -1):
        h_prev = outs[:, t - 1] if t > 0 else h0
        a = None if att is None else att[:, t : t + 1]
        v = valid[:, t : t + 1]
        r, zu, n, hn, u = _gates(cell, gi[:, t], w, b, a, h_prev)
        ua = v * u
        D = g[:, t] + dh
        dn = D * ua
        dh_prev = D * (1.0 - ua)
        du = v * (D * (n - h_prev))
        if cell == "agru":
            datt[:, t] = du.sum(1)
            dzu_pre = zero
        else:
            if cell == "gru":
                dzu = -du
            else:
                datt[:, t] = (du * zu).sum(1)
                dzu = du * a
            dzu_pre = dzu * zu * (1.0 - zu)
        dn_pre = dn * (1.0 - n * n)
        dhn = dn_pre * r
        dr_pre = dn_pre * hn * r * (1.0 - r)
        dgh = torch.stack([dr_pre, dzu_pre, dhn], 1)  # [B, 3, H]: d(W h + b)
        dh = dh_prev + dgh.reshape(B, 3 * H) @ w.reshape(3 * H, H)
        dw += torch.einsum("bgi,bj->gij", dgh, h_prev)
        db += dgh.sum(0)
        dgi[:, t] = torch.stack([dr_pre, dzu_pre, dn_pre], 1)
    return dgi, dw, db, datt, dh


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gru_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "gru_bwd": [_I] + [_P] * 14 + [_I, _I, _I, _I, _P],
}


def _launch(name, device, *args):
    """``csrc/<name>.cu``'s launcher ``name`` on ``device``'s current stream."""
    _build.launch(name, name, _SIGNATURES[name], device, *args)


def _check(fn, cell, gi, w, b, att, lengths, h0, *per_step):
    """Shared input checks (``per_step``: (name, tensor) pairs of more
    [B, T, H] tensors); returns (B, T, H).  The common case, every input
    right, takes one pass of cheap tests; any failure is named by the
    second, detailed pass."""
    if cell not in CELLS:
        raise ValueError(f"{fn}: unknown cell {cell!r}; expected one of {sorted(CELLS)}")
    if not isinstance(gi, torch.Tensor) or gi.ndim != 4 or gi.shape[2] != 3:
        raise ValueError(f"{fn}: gi must be a [B, T, 3, H] tensor")
    B, T, _, H = gi.shape
    if not fits_kernel(T, H, B):
        raise ValueError(f"{fn}: B {B}, T {T}, H {H} outside the kernels' gate "
                         f"(1 <= H <= {GRU_MAX_H}); use backend='torch'")
    if cell != "gru" and att is None:
        raise ValueError(f"{fn}: cell {cell!r} needs att")
    tensors = [("gi", gi, (B, T, 3, H)), ("w", w, (3, H, H)), ("b", b, (3, H)),
               ("h0", h0, (B, H))]
    if cell != "gru":
        tensors.append(("att", att, (B, T)))
    tensors += [(name, t, (B, T, H)) for name, t in per_step]
    dev = gi.get_device() if gi.is_cuda else None
    if dev is not None and all(
            isinstance(t, torch.Tensor) and t.is_cuda and t.get_device() == dev
            and t.dtype == torch.float32 and t.shape == shape and t.is_contiguous()
            for _, t, shape in tensors) and (
            isinstance(lengths, torch.Tensor) and lengths.is_cuda
            and lengths.get_device() == dev and lengths.dtype == torch.int32
            and lengths.shape == (B,) and lengths.is_contiguous()):
        return B, T, H
    for name, t, shape in tensors:
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} must be a CUDA tensor")
        if t.device != gi.device:
            raise ValueError(f"{fn}: all inputs must be on one device")
        if t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be float32, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{fn}: {name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    raise ValueError(f"{fn}: lengths must be a contiguous int32 [B] tensor on gi's device")


def gru_forward(cell, gi, w, b, att, lengths, h0):
    """The forward kernel: same contract as :func:`gru_forward_reference`,
    on CUDA fp32 contiguous tensors and int32 lengths."""
    B, T, H = _check("gru_forward", cell, gi, w, b, att, lengths, h0)
    outs = torch.empty(B, T, H, device=gi.device)
    _launch("gru_fwd", gi.device, CELLS[cell], gi.data_ptr(), w.data_ptr(), b.data_ptr(),
            att.data_ptr() if cell != "gru" else None, lengths.data_ptr(), h0.data_ptr(),
            outs.data_ptr(), B, T, H)
    gru_forward.launches += 1
    return outs


def gru_backward(cell, g, gi, w, b, att, lengths, h0, outs):
    """The backward kernel: same contract as :func:`gru_backward_reference`
    (datt is zero for cell "gru").  dw and db are summed from per-block
    partials in a fixed order, so two calls give bit-equal results.  Every
    output is an allocation of its own (a view of a shared buffer costs the
    host more than an allocation)."""
    B, T, H = _check("gru_backward", cell, gi, w, b, att, lengths, h0, ("outs", outs), ("g", g))
    dev = gi.device
    nblk = backward_blocks(B, H)
    dgi = torch.empty_like(gi)
    datt = torch.empty(B, T, device=dev)
    dh0 = torch.empty(B, H, device=dev)
    part = torch.empty(nblk, 3 * H * (H + 1), device=dev)  # dW [3, H, H], db [3, H] a block
    dw = torch.empty(3, H, H, device=dev)
    db = torch.empty(3, H, device=dev)
    _launch("gru_bwd", dev, CELLS[cell], g.data_ptr(), gi.data_ptr(), w.data_ptr(), b.data_ptr(),
            att.data_ptr() if cell != "gru" else None, lengths.data_ptr(), h0.data_ptr(),
            outs.data_ptr(), dgi.data_ptr(), datt.data_ptr(), dh0.data_ptr(), part.data_ptr(),
            dw.data_ptr(), db.data_ptr(), nblk, B, T, H)
    gru_backward.launches += 1
    return dgi, dw, db, datt, dh0


gru_forward.launches = 0
gru_backward.launches = 0
