"""The attention ablation on Hopper: counterpart of
``scripts/bench_attn_ablate.py``'s three Pallas kernels (``build`` :96, the
bodies ``full_kernel`` :51, ``dots_kernel`` :66 and ``soft_kernel`` :78).

Three forwards over the same dh-major operands q, k, v [G, dh, S] (fp32),
with c = scale * log2(e):

* :func:`ablate_full` — the small-attention forward in exp2 form:
  ``o[d, i] = sum_j v[d, j] exp2(s[i, j] c - m[i] c) / z[i]`` with
  ``s = q^T k`` (row 8's function without its saved statistics);
* :func:`ablate_dots` — both products, no softmax:
  ``o[d, i] = sum_j v[d, j] s[i, j]`` (``scale`` is not used);
* :func:`ablate_soft` — the softmax passes over the outer product
  ``s[i, j] = q[0, i] k[0, j]``, then ``o[d, x] = sum_i e[i, x] / z[x]``.

Each wrapper takes CUDA fp32 contiguous tensors only, launches its kernel of
``csrc/sa_ablate.cu`` on PyTorch's current stream, raises on bad input and on
a failed launch, and counts its launches in ``<wrapper>.launches``.  Beside
each is its plain PyTorch version (``*_reference``), which materialises the
[G, S, S] block as the Pallas bodies do.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

LOG2E = math.log2(math.e)
VARIANTS = ("full", "dots", "soft")
MAX_DH = 16  # the kernels are instantiated for head widths 1..16
SMEM_BYTES = 232_448  # shared memory one Hopper block may take


def ablate_full_reference(q, k, v, scale):
    """``full_kernel`` (:51-64): row 8's forward in exp2 form."""
    c = scale * LOG2E
    s = torch.einsum("gds,gdt->gst", q, k)
    m = s.amax(-1, keepdim=True)
    e = torch.exp2(s * c - m * c)
    z = e.sum(-1)
    return torch.einsum("gdt,gst->gds", v, e) * (1.0 / z)[:, None, :]


def ablate_dots_reference(q, k, v, scale=None):
    """``dots_kernel`` (:66-76): the two products, the softmax an identity."""
    return torch.einsum("gdt,gst->gds", v, torch.einsum("gds,gdt->gst", q, k))


def ablate_soft_reference(q, k, v, scale):
    """``soft_kernel`` (:78-91): softmax passes over the outer product of q's
    and k's row 0, then each column's sum of e over the rows, times that
    column index's row normaliser, broadcast over dh."""
    c = scale * LOG2E
    s = q[:, 0, :, None] * k[:, 0, None, :]
    m = s.amax(-1, keepdim=True)
    e = torch.exp2(s * c - m * c)
    z = e.sum(-1)
    out = (1.0 / z) * e.sum(1)
    return out[:, None, :].expand(v.shape).contiguous()


REFERENCES = {"full": ablate_full_reference, "dots": ablate_dots_reference,
              "soft": ablate_soft_reference}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LAUNCH = [_I, _P, _P, _P, _P, _I, _I, _I, _F, _P]
_GEOMETRY = [_I, _I, _I, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)]


def geometry(variant: str, dh: int, S: int):
    """(threads a block, dynamic shared bytes a block) of ``variant``'s launch
    at head width dh and S columns, as ``csrc/sa_ablate.cu`` computes them
    (builds the library at first use)."""
    threads, smem = ctypes.c_int(), ctypes.c_longlong()
    err = _build.function("sa_ablate", "sa_ablate_geometry", _GEOMETRY)(
        VARIANTS.index(variant), dh, S, ctypes.byref(threads), ctypes.byref(smem))
    if err != 0:
        raise ValueError(f"ablate_{variant}: no launch at dh = {dh}, S = {S}")
    return threads.value, smem.value


def _launch(variant, q, k, v, scale):
    fn = f"ablate_{variant}"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} must be a CUDA tensor")
        if t.device != q.device:
            raise ValueError(f"{fn}: all inputs must be on one device")
        if t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        if t.ndim != 3 or t.shape != q.shape:
            raise ValueError(f"{fn}: expects [G, dh, S] operands of one shape, "
                             f"got {tuple(t.shape)}")
    G, dh, S = q.shape
    if G < 1 or S < 1 or not 1 <= dh <= MAX_DH:
        raise ValueError(f"{fn}: needs G >= 1, S >= 1 and dh in 1..{MAX_DH}, "
                         f"got {tuple(q.shape)}")
    if G > 2**31 - 1 or dh * S > 2**31 - 1:
        raise ValueError(f"{fn}: {tuple(q.shape)} exceeds the kernel's 32-bit offsets")
    smem = geometry(variant, dh, S)[1]
    if smem > SMEM_BYTES:
        raise ValueError(f"{fn}: S = {S} at dh = {dh} needs {smem} bytes of shared memory "
                         f"per block, above the {SMEM_BYTES} a Hopper block may take")
    o = torch.empty_like(q)
    _build.launch("sa_ablate", "sa_ablate", _LAUNCH, q.device, VARIANTS.index(variant),
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), G, dh, S,
                  float(scale))
    return o


def ablate_full(q, k, v, scale):
    """The full forward's kernel; same contract as :func:`ablate_full_reference`."""
    o = _launch("full", q, k, v, scale)
    ablate_full.launches += 1
    return o


def ablate_dots(q, k, v, scale=None):
    """The dots-only kernel; same contract as :func:`ablate_dots_reference`."""
    o = _launch("dots", q, k, v, 0.0)
    ablate_dots.launches += 1
    return o


def ablate_soft(q, k, v, scale):
    """The softmax-only kernel; same contract as :func:`ablate_soft_reference`."""
    o = _launch("soft", q, k, v, scale)
    ablate_soft.launches += 1
    return o


ablate_full.launches = 0
ablate_dots.launches = 0
ablate_soft.launches = 0
KERNELS = {"full": ablate_full, "dots": ablate_dots, "soft": ablate_soft}
