"""The attention CIN's fused post-CIN block on Hopper: counterpart of
``xdeepfm_tpu/ops/attn_block_pallas.py``'s kernels.

    x -> [ MHSA(Wq, Wk, Wv, Wo) -> +residual -> LayerNorm ] * L
      -> tanh-MLP attention pooling -> pooled [B, E]

on the transposed CIN output x [B, E, S].  Weights take the JAX package's
packed layouts: wq / wk / wv [L*H, E, dh], wo [L*H, dh, E], gamma / beta
[L, E, 1], w1 [E, E] (h1 = w1^T y + b1), b1 / w2 [E, 1].  Each wrapper takes
CUDA fp32 tensors only, launches its hand-written CUDA kernel on PyTorch's
current stream, raises on bad input and on a failed launch, and counts its
launches in ``<wrapper>.launches``:

* :func:`ab_forward` — ``csrc/ab_fwd.cu`` (replaces ``_ab_fwd`` /
  ``_fwd_kernel``): pooled and, for the backward, the softmax statistics,
  the per-head attention outputs and each layer's output; its attention
  runs through ``csrc/attn_fwd_tc.cuh``, the forward routine of
  ``sa_fwd``;
* :func:`ab_backward` — ``csrc/ab_bwd.cu`` (replaces ``_ab_bwd`` /
  ``_bwd_kernel``): dx and the nine parameter gradients, each summed over
  the batch in a fixed order.

Both share ``csrc/attn_block.cuh``.

Beside them is the same function in plain PyTorch: the unfused composition
(:func:`ab_forward_reference`) and its gradient by autograd
(:func:`ab_backward_reference`).  The CPU path and the kernels' checks use
them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .attention_cuda import SA_MAX_DH, SMEM_BYTES, routine_pitch, routine_scratch_floats


class BlockCfg(NamedTuple):
    layers: int
    heads: int
    scale: float
    use_residual: bool
    use_layer_norm: bool
    eps: float


def _pitch(S):
    return S + 1 if S % 2 == 0 else S


def _bwd_layout(E, S, H):
    """(chunks a step, routine buffers, floats) of ``ab_bwd``'s block, as
    ``BwdLayout`` in ``csrc/ab_bwd.cu`` chooses them: (2, 2) where the block
    fits, else (1, 2), else (1, 1); the routine's scratch borrows the rows
    of X and DY where it fits there."""
    P, warps = routine_pitch(S), min(8, -(-S // 32))
    for ch, nbuf in ((2, 2), (1, 2), (1, 1)):
        scratch = routine_scratch_floats(E // H, warps, nbuf, ch)
        extra = scratch if scratch > 2 * E * P else 0
        floats = 10 * E * P + 3 * H * S + (3 * H * S) % 2 + extra + 4 * E * E + 3 * E + 32
        if 4 * floats <= SMEM_BYTES:
            break
    return ch, nbuf, floats


def ab_smem_bytes(E: int, S: int, H: int, backward: bool = True) -> int:
    """Shared memory of a block of ``ab_fwd`` / ``ab_bwd`` (the formulas of
    ``csrc/attn_block.cuh`` and ``csrc/ab_bwd.cu``).  The forward holds 3
    [E, S] rows at an odd pitch, k and v at S rounded up to 8, the weights
    and an [S] row.  The
    backward holds 10 rows at the attention routine's pitch, three [H, S]
    statistics, the layer weights (the pooling MLP's share their space) and
    the routine's scratch where it does not fit in the rows of X and DY
    (:func:`_bwd_layout`)."""
    if backward:
        return 4 * _bwd_layout(E, S, H)[2]
    return 4 * (2 * E * (-(-S // 8) * 8) + 3 * E * _pitch(S) + 5 * E * E + 4 * E + S + 32)


def num_params(E: int, L: int) -> int:
    """Entries of the flat parameter gradient ``ab_bwd`` reduces."""
    return 4 * L * E * E + 2 * L * E + E * E + 2 * E


def check_ab_shape(E: int, S: int, H: int, L: int) -> None:
    """The kernels' shape gate; raises ValueError past it (no fallback)."""
    if H < 1 or E % H:
        raise ValueError(f"attn_block: E = {E} is not a multiple of heads = {H}")
    if not 1 <= E // H <= SA_MAX_DH:
        raise ValueError(f"attn_block: head width {E // H} outside 1..{SA_MAX_DH}")
    if L < 1 or S < 1:
        raise ValueError(f"attn_block: needs L >= 1 and S >= 1, got L = {L}, S = {S}")
    if ab_smem_bytes(E, S, H) > SMEM_BYTES:
        raise ValueError(
            f"attn_block: E = {E}, S = {S} needs {ab_smem_bytes(E, S, H)} bytes of shared "
            f"memory per block, above the {SMEM_BYTES} a Hopper block may take (the kernel "
            "holds a whole batch row); use the unfused route (set_backend('xla'))"
        )


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def ab_forward_reference(cfg: BlockCfg, x, wq, wk, wv, wo, gamma, beta, w1, b1, w2):
    """pooled [B, E] by the unfused composition, in the kernel's order of
    operations (scores' max unscaled, LayerNorm's fast variance)."""
    B, E, S = x.shape
    H = cfg.heads
    y = x
    for l in range(cfg.layers):
        sl = slice(l * H, (l + 1) * H)
        q, k, v = (torch.einsum("hed,bes->bhds", w[sl], y) for w in (wq, wk, wv))
        s = torch.einsum("bhds,bhdt->bhst", q, k)
        # the row max only shifts the softmax: like the kernel's backward,
        # autograd does not differentiate through it (its gradient, a sum
        # that cancels to 0, would add fp32 noise where the softmax saturates)
        e = torch.exp((s - s.amax(-1, keepdim=True).detach()) * cfg.scale)
        o = torch.einsum("bhdt,bhst->bhds", v, e) * (1.0 / e.sum(-1))[:, :, None, :]
        r = torch.einsum("hdf,bhds->bfs", wo[sl], o)
        if cfg.use_residual:
            r = r + y
        if cfg.use_layer_norm:
            mu = r.mean(1, keepdim=True)
            var = (r * r).mean(1, keepdim=True) - mu * mu
            y = gamma[l][None] * ((r - mu) * torch.rsqrt(var + cfg.eps)) + beta[l][None]
        else:
            y = r
    h1 = torch.tanh(torch.einsum("ef,bes->bfs", w1, y) + b1[None])
    w = torch.softmax(torch.einsum("f,bfs->bs", w2[:, 0], h1), dim=-1)
    return torch.einsum("bs,bes->be", w, y)


def ab_backward_reference(cfg: BlockCfg, g, x, wq, wk, wv, wo, gamma, beta, w1, b1, w2):
    """(dx, dwq, dwk, dwv, dwo, dgamma, dbeta, dw1, db1, dw2) for the
    gradient g of pooled: autograd through :func:`ab_forward_reference`;
    dgamma and dbeta are zero without the LayerNorm."""
    ins = [t.detach().requires_grad_(True) for t in (x, wq, wk, wv, wo, gamma, beta, w1, b1, w2)]
    with torch.enable_grad():
        out = ab_forward_reference(cfg, *ins)
        grads = torch.autograd.grad(out, ins, g, allow_unused=True)
    return tuple(torch.zeros_like(t) if d is None else d for t, d in zip(ins, grads))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C function -> (its source in csrc/, argument types)
_SIGNATURES = {
    "ab_fwd": ("ab_fwd", [_P] * 15 + [_I] * 5 + [_F, _F, _I, _I, _P]),
    "ab_bwd": ("ab_bwd", [_P] * 18 + [_I] * 5 + [_F, _F, _I, _I, _P]),
    "ab_smem_bytes": ("ab_bwd", [_I, _I, _I, _I]),
    "ab_num_params": ("ab_bwd", [_I, _I]),
}


def _fn(name):
    """The C function ``name``, loaded (and built) at first use, never at
    import."""
    lib, argtypes = _SIGNATURES[name]
    return _build.function(lib, name, argtypes)


def _launch(name, device, *args):
    """The launcher ``name`` on ``device``'s current stream."""
    lib, argtypes = _SIGNATURES[name]
    _build.launch(lib, name, argtypes, device, *args)


def _check(fn, cfg, x, weights, **extra):
    """Shared input checks.  Returns (B, E, S, L, H)."""
    named = {"x": x, **dict(zip(("wq", "wk", "wv", "wo", "gamma", "beta", "w1", "b1", "w2"),
                                weights)), **extra}
    for name, t in named.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} must be a CUDA tensor")
        if t.device != x.device:
            raise ValueError(f"{fn}: all inputs must be on one device")
        if t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if x.ndim != 3:
        raise ValueError(f"{fn}: expects x [B, E, S], got {tuple(x.shape)}")
    B, E, S = x.shape
    L, H = cfg.layers, cfg.heads
    check_ab_shape(E, S, H, L)
    dh = E // H
    want = {"wq": (L * H, E, dh), "wk": (L * H, E, dh), "wv": (L * H, E, dh),
            "wo": (L * H, dh, E), "gamma": (L, E, 1), "beta": (L, E, 1), "w1": (E, E),
            "b1": (E, 1), "w2": (E, 1), "g": (B, E)}
    for name, shape in want.items():
        if name in named and tuple(named[name].shape) != shape:
            raise ValueError(f"{fn}: {name} must be {shape}, got {tuple(named[name].shape)}")
    if B < 1 or B > 2**31 - 1 or L * E * S >= 2**31:
        raise ValueError(f"{fn}: B = {B} outside the grid or a row exceeds 32-bit offsets")
    return B, E, S, L, H


def _cfg_args(cfg):
    return (float(cfg.scale), float(cfg.eps), int(bool(cfg.use_residual)),
            int(bool(cfg.use_layer_norm)))


def ab_forward(cfg: BlockCfg, x, wq, wk, wv, wo, gamma, beta, w1, b1, w2, save=True):
    """The forward kernel: (pooled [B, E], saved) on CUDA fp32 contiguous
    tensors; ``saved`` is (m, inv_z [B, L*H, S], osave, ysave [B, L, E, S])
    for :func:`ab_backward`, or None when ``save`` is False (scoring)."""
    weights = (wq, wk, wv, wo, gamma, beta, w1, b1, w2)
    B, E, S, L, H = _check("ab_forward", cfg, x, weights)
    dev = x.device
    pooled = torch.empty((B, E), device=dev, dtype=torch.float32)
    saved = None
    ptrs = [None] * 4
    if save:
        saved = (torch.empty((B, L * H, S), device=dev), torch.empty((B, L * H, S), device=dev),
                 torch.empty((B, L, E, S), device=dev), torch.empty((B, L, E, S), device=dev))
        ptrs = [t.data_ptr() for t in saved]
    _launch("ab_fwd", dev, x.data_ptr(), *(w.data_ptr() for w in weights), pooled.data_ptr(),
            *ptrs, B, E, S, L, H, *_cfg_args(cfg))
    ab_forward.launches += 1
    return pooled, saved


def ab_backward(cfg: BlockCfg, g, x, wq, wk, wv, wo, gamma, beta, w1, b1, w2, saved):
    """The backward kernel: same contract as :func:`ab_backward_reference`
    on CUDA fp32 contiguous tensors, from the forward kernel's ``saved``."""
    weights = (wq, wk, wv, wo, gamma, beta, w1, b1, w2)
    m, z, osave, ysave = saved
    B, E, S, L, H = _check("ab_backward", cfg, x, weights, g=g, m=m, z=z, osave=osave,
                           ysave=ysave)
    if m.shape != (B, L * H, S) or z.shape != m.shape or osave.shape != (B, L, E, S) \
            or ysave.shape != osave.shape:
        raise ValueError("ab_backward: saved tensors do not match x and cfg")
    dev = x.device
    n = num_params(E, L)
    if n * B >= 2**31:
        raise ValueError("ab_backward: per-row partials exceed 32-bit indexing")
    dx = torch.empty_like(x)
    part = torch.empty((n, B), device=dev, dtype=torch.float32)
    flat = torch.empty(n, device=dev, dtype=torch.float32)
    _launch("ab_bwd", dev, x.data_ptr(), *(w.data_ptr() for w in weights), g.data_ptr(),
            m.data_ptr(), z.data_ptr(), osave.data_ptr(), ysave.data_ptr(), dx.data_ptr(),
            part.data_ptr(), flat.data_ptr(), B, E, S, L, H, *_cfg_args(cfg))
    ab_backward.launches += 1
    sizes = [w.numel() for w in weights]
    return (dx,) + tuple(t.view(w.shape) for t, w in zip(flat.split(sizes), weights))


ab_forward.launches = 0
ab_backward.launches = 0
