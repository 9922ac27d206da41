"""Small-sequence attention on Hopper: counterpart of
``xdeepfm_tpu/ops/attention_pallas.py``'s kernels.

On dh-major operands q, k, v [G, dh, S] (G = batch * heads), per pair:
scores s = q^T k (unscaled), m = their row max, e = exp((s - m) * scale),
inv_z = 1 / sum_j e, o = (v e^T) * inv_z.  Each wrapper takes CUDA fp32
tensors only, launches its hand-written CUDA kernel on PyTorch's current
stream, raises on bad input and on a failed launch, and counts its launches
in ``<wrapper>.launches``:

* :func:`sa_forward` — ``csrc/sa_fwd.cu`` over the forward routine
  ``csrc/attn_fwd_tc.cuh`` (replaces ``_sa_fwd`` / ``_fwd_kernel``):
  (o, m, inv_z).  A warp owns 32 queries (16 above dh 8), a lane 4 of them
  and 2 keys of every 8, register-blocked fp32 FMAs for the scores and for
  o = e v^T, in one pass whose reference max trails the running max (a max
  sweep first under bf16);
* :func:`sa_backward` — ``csrc/sa_bwd.cu`` over the backward routine
  ``csrc/attn_bwd_tc.cuh`` (replaces ``_sa_bwd`` / ``_bwd_kernel``):
  (dq, dk, dv) from the saved m and inv_z;
* :func:`sa_forward_bf16` and :func:`sa_backward_bf16` — the bf16 mode's
  kernels ``sa_fwd_bf16`` and ``sa_bwd_bf16`` in ``csrc/sa_bf16.cu``
  (replace ``_sa_fwd`` / ``_sa_bwd`` under ``set_precision("bf16")``), on
  bf16 ``mma.sync``: a block a pair, a warp 32 rows; the forward takes the
  exact row max in a first pass, then e rounded in registers into the A
  operand of o^T = E V^T; the backward runs a key pass (dk, dv) and a query
  pass (dq) over the pair's one copy in shared memory.
  :func:`sa_forward` and :func:`sa_backward` with ``precision="bf16"`` go
  to them.

Beside each is the same function in plain PyTorch (``*_reference``), which
materialises the [G, S, S] scores.  The CPU path and the kernels' checks use
them.  ``precision`` "bf16" rounds every product operand to bf16 and sums in
fp32, as the TPU kernel's ``set_precision("bf16")``.  The fp32 kernels keep
a bf16 flag of their own (a max sweep, then the fp32 walk on rounded
operands, the backward's 3xTF32 routine with one MMA kept), which no wrapper
sets: ``scripts/bench_attn_bf16.py`` times it as the yardstick that the bf16
kernels replaced.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

SA_MAX_DH = 16  # the kernels are instantiated for head widths 1..16
SMEM_BYTES = 232_448  # shared memory one Hopper block may take
TWO_BLOCK_SMEM_BYTES = 115_712  # the most a block may take for two to share an SM


def routine_pitch(S: int) -> int:
    """Row pitch of the backward's operands (``csrc/attn_bwd_tc.cuh``
    ``pitch``): the least P >= S with P = 2 mod 4."""
    return S + (6 - S % 4) % 4


def routine_scratch_floats(dh: int, warps: int, nbuf: int = 2, ch: int = 1) -> int:
    """Shared scratch of the backward's attention routine
    (``csrc/attn_bwd_tc.cuh``): ``nbuf`` stages of ``ch`` chunks of 16
    queries (the TF32 halves of g inv_z and q at a row pitch of 16 ch + 8,
    three statistics) and ``nbuf`` dQ partial slots per warp."""
    return nbuf * (4 * dh * (16 * ch + 8) + 48 * ch + warps * 16 * ch * dh)


def sa_smem_bytes(dh: int, S: int) -> int:
    """Shared memory of the backward kernel, the larger of the two
    (``csrc/sa_bwd.cu``'s ``bwd_floats``): q, k, v and g [dh, P] at
    :func:`routine_pitch`, three [S] rows (and a float that keeps what
    follows 8-byte aligned) and the routine's scratch for its warps (one per
    16 keys, at most 8), with the most of 8, 4, 2 or 1 chunks of 16 queries
    a step with which two blocks share an SM, else with which one fits."""
    warps = min(8, -(-S // 16))
    for limit in (TWO_BLOCK_SMEM_BYTES, SMEM_BYTES):
        for ch in (8, 4, 2, 1):
            floats = (4 * dh * routine_pitch(S) + 3 * S + S % 2
                      + routine_scratch_floats(dh, warps, 2, ch))
            if 4 * floats <= limit:
                return 4 * floats
    return 4 * floats


def check_sa_shape(dh: int, S: int) -> None:
    """The kernels' shape gate; raises ValueError past it (no fallback).  The
    backward's shared memory is the larger of the two (the forward stages
    2 dh KP floats, KP = S rounded up to 8)."""
    if not 1 <= dh <= SA_MAX_DH:
        raise ValueError(f"small_attention: head width dh = {dh} outside 1..{SA_MAX_DH}")
    if S < 1 or sa_smem_bytes(dh, S) > SMEM_BYTES:
        raise ValueError(
            f"small_attention: S = {S} at dh = {dh} needs {sa_smem_bytes(dh, S)} bytes of "
            f"shared memory per block, above the {SMEM_BYTES} a Hopper block may take "
            "(the backward holds a whole pair's q, k, v and g); use backend='torch'"
        )


def _bf16(x, precision):
    """x rounded to bf16 under "bf16", in x's own dtype (so that a float64
    reference rounds the same operands)."""
    return x.to(torch.bfloat16).to(x.dtype) if precision == "bf16" else x


def sa_forward_reference(q, k, v, scale, precision="fp32"):
    """(o [G, dh, S], m [G, S], inv_z [G, S]) with the [G, S, S] scores
    materialised, in the kernel's order of operations."""
    s = torch.einsum("gds,gdt->gst", _bf16(q, precision), _bf16(k, precision))
    m = s.amax(-1)
    e = torch.exp((s - m[..., None]) * scale)
    inv_z = 1.0 / e.sum(-1)
    o = torch.einsum("gdt,gst->gds", _bf16(v, precision), _bf16(e, precision))
    return o * inv_z[:, None, :], m, inv_z


def sa_backward_reference(g, q, k, v, o, m, inv_z, scale, precision="fp32"):
    """(dq, dk, dv) [G, dh, S] for the output gradient g, the flash
    backward from the saved m and inv_z with the scores materialised."""
    qb, kb, vb = (_bf16(t, precision) for t in (q, k, v))
    s = torch.einsum("gds,gdt->gst", qb, kb)
    e = torch.exp((s - m[..., None]) * scale)
    dv = torch.einsum("gds,gst->gdt", _bf16(g * inv_z[:, None, :], precision),
                      _bf16(e, precision))
    delta = (g * o).sum(1)
    dp = torch.einsum("gds,gdt->gst", _bf16(g, precision), vb)
    ds = _bf16((dp - delta[..., None]) * (inv_z * scale)[..., None] * e, precision)
    dq = torch.einsum("gdt,gst->gds", kb, ds)
    dk = torch.einsum("gds,gst->gdt", qb, ds)
    return dq, dk, dv


def sa_bf16_float64(q, k, v, scale, g=None, o=None, m=None, inv_z=None):
    """The bf16 mode's function in float64 with only its inputs rounded to
    bf16 (q, k, v, and g where it is an operand of dp): the yardstick of the
    float64 gate, against which the kernels' and the plain version's
    roundings of e, g inv_z and ds alike count as error.  Without g: o; with
    g and the forward's o, m and inv_z: (dq, dk, dv)."""
    def rounded(t):
        return t.to(torch.bfloat16).double()

    qb, kb, vb = rounded(q), rounded(k), rounded(v)
    if g is None:
        return sa_forward_reference(qb, kb, vb, scale)[0]
    g, o, m, z = (t.double() for t in (g, o, m, inv_z))
    e = torch.exp((torch.einsum("gds,gdt->gst", qb, kb) - m[..., None]) * scale)
    dv = torch.einsum("gds,gst->gdt", g * z[:, None, :], e)
    dp = torch.einsum("gds,gdt->gst", rounded(g), vb)
    ds = (dp - (g * o).sum(1)[..., None]) * (z * scale)[..., None] * e
    return torch.einsum("gdt,gst->gds", kb, ds), torch.einsum("gds,gst->gdt", qb, ds), dv


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "sa_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "sa_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "sa_fwd_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "sa_bwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
}


def smem_bytes_of_kernel(dh: int, S: int) -> int:
    """The backward kernel's own shared-memory formula (``sa_bwd_smem_bytes``
    in ``csrc/sa_bwd.cu``, built at first use); the card tests hold
    :func:`sa_smem_bytes` against it."""
    return _build.function("sa_bwd", "sa_bwd_smem_bytes", [_I, _I])(dh, S)


def _launch(name, device, *args):
    """The launcher ``name`` of ``csrc/<name>.cu`` (of ``csrc/sa_bf16.cu``
    for the bf16 mode's) on ``device``'s current stream."""
    lib = "sa_bf16" if name.endswith("_bf16") else name
    _build.launch(lib, name, _SIGNATURES[name], device, *args)


def _check(fn, precision, **named):
    """Shared input checks: CUDA fp32 contiguous tensors on one device, the
    [G, dh, S] operands of one shape, [G, S] statistics.  Returns (G, dh, S)."""
    if precision not in ("fp32", "bf16"):
        raise ValueError(f"{fn}: unknown precision {precision!r}")
    first = next(iter(named.values()))
    for name, t in named.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} must be a CUDA tensor")
        if t.device != first.device:
            raise ValueError(f"{fn}: all inputs must be on one device")
        if t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if first.ndim != 3:
        raise ValueError(f"{fn}: expects [G, dh, S] operands, got {tuple(first.shape)}")
    G, dh, S = first.shape
    for name, t in named.items():
        want = (G, S) if name in ("m", "inv_z") else (G, dh, S)
        if tuple(t.shape) != want:
            raise ValueError(f"{fn}: {name} must be {want}, got {tuple(t.shape)}")
    if G < 1:
        raise ValueError(f"{fn}: needs G >= 1")
    check_sa_shape(dh, S)
    if G > 2**31 - 1:
        raise ValueError(f"{fn}: G = {G} exceeds the grid")
    return G, dh, S


def sa_forward(q, k, v, scale, precision="fp32"):
    """The forward kernel: same contract as :func:`sa_forward_reference`,
    on CUDA fp32 contiguous tensors; "bf16" runs :func:`sa_forward_bf16`.
    m is bit-equal to the row max of the scores summed by fmaf over d from
    0, the backward's order; o is held against float64 by
    ``chip_smoke.py``; bit-equal from run to run."""
    if precision == "bf16":
        return sa_forward_bf16(q, k, v, scale)
    G, dh, S = _check("sa_forward", precision, q=q, k=k, v=v)
    o = torch.empty_like(q)
    m = torch.empty((G, S), device=q.device, dtype=torch.float32)
    inv_z = torch.empty_like(m)
    _launch("sa_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr(), inv_z.data_ptr(), G, dh, S, float(scale), 0)
    sa_forward.launches += 1
    return o, m, inv_z


def sa_backward(g, q, k, v, o, m, inv_z, scale, precision="fp32"):
    """The backward kernel: same contract as :func:`sa_backward_reference`,
    on CUDA fp32 contiguous tensors; "bf16" runs :func:`sa_backward_bf16`."""
    if precision == "bf16":
        return sa_backward_bf16(g, q, k, v, o, m, inv_z, scale)
    G, dh, S = _check("sa_backward", precision, q=q, k=k, v=v, g=g, o=o, m=m, inv_z=inv_z)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    _launch("sa_bwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            o.data_ptr(), m.data_ptr(), inv_z.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), G, dh, S, float(scale), 0)
    sa_backward.launches += 1
    return dq, dk, dv


def sa_forward_bf16(q, k, v, scale):
    """``sa_fwd_bf16``: same contract as ``sa_forward_reference(...,
    precision="bf16")`` on CUDA fp32 contiguous tensors, the same shape gate
    as the fp32 kernels.  m is the row max of the scores as the tensor cores
    sum them, the sums that :func:`sa_backward_bf16` recomputes; bit-equal
    from run to run."""
    G, dh, S = _check("sa_forward_bf16", "bf16", q=q, k=k, v=v)
    o = torch.empty_like(q)
    m = torch.empty((G, S), device=q.device, dtype=torch.float32)
    inv_z = torch.empty_like(m)
    _launch("sa_fwd_bf16", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr(), inv_z.data_ptr(), G, dh, S, float(scale))
    sa_forward_bf16.launches += 1
    return o, m, inv_z


def sa_backward_bf16(g, q, k, v, o, m, inv_z, scale):
    """``sa_bwd_bf16``: same contract as ``sa_backward_reference(...,
    precision="bf16")`` on CUDA fp32 contiguous tensors; bit-equal from run
    to run (no atomics)."""
    G, dh, S = _check("sa_backward_bf16", "bf16", q=q, k=k, v=v, g=g, o=o, m=m, inv_z=inv_z)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    _launch("sa_bwd_bf16", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            o.data_ptr(), m.data_ptr(), inv_z.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), G, dh, S, float(scale))
    sa_backward_bf16.launches += 1
    return dq, dk, dv


sa_forward.launches = 0
sa_backward.launches = 0
sa_forward_bf16.launches = 0
sa_backward_bf16.launches = 0
