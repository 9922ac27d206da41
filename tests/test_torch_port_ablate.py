"""The attention ablation (TPU kernel row 16) on the CPU: the port's plain
versions against the Pallas bodies, and its entry point.

``scripts/bench_attn_ablate.py`` builds its three kernels as closures inside
``main()``, which reads its sizes from ``sys.argv`` at import and has no
interpret switch, and ``scripts/`` stays as it is.  So the oracle here is a
transcription of the three bodies in ``jax.numpy``, one pair at a time,
citing the script line by line.  The ``full`` body is also held against the
JAX package's own row-8 kernel (``attention_pallas.small_attention``, in
interpret mode), whose function it computes in another exponent base.

Tolerance: within 1e-6 of the largest |o| (fp32 sums of S terms and exp
against exp2, in another order than XLA's).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xdeepfm_tpu.ops import attention_pallas as ap
from xdeepfm_tpu_torch.ops import attn_ablate_cuda as ab
from xdeepfm_tpu_torch.ops.attn_ablate import ablate_forward
from xdeepfm_tpu_torch.scripts import bench_attn_ablate

_LOG2E = math.log2(math.e)  # bench_attn_ablate.py:45


def _dots(a, b, dims):
    return jax.lax.dot_general(a, b, (dims, ((), ())), preferred_element_type=jnp.float32)


def jax_full(q, k, v, scale):
    """bench_attn_ablate.py:51-64, per pair b."""
    c = scale * _LOG2E  # :52
    s = _dots(q, k, ((0,), (0,)))  # :55-57
    m = jnp.max(s, axis=-1, keepdims=True)  # :58
    e = jnp.exp2(s * c - m * c)  # :59
    z = jnp.sum(e, axis=-1, keepdims=True)  # :60
    o = _dots(v, e, ((1,), (1,)))  # :61-63
    return o * (1.0 / z).reshape(1, -1)  # :64


def jax_dots(q, k, v, scale):
    """bench_attn_ablate.py:66-76: the softmax replaced by the identity."""
    s = _dots(q, k, ((0,), (0,)))  # :70-72
    return _dots(v, s, ((1,), (1,)))  # :73-76


def jax_soft(q, k, v, scale):
    """bench_attn_ablate.py:78-91: softmax passes over the outer product of
    row 0, then the column sums of e times the row normalisers."""
    c = scale * _LOG2E  # :81
    S = q.shape[1]
    s = q[:1].reshape(-1, 1) * k[:1].reshape(1, -1)  # :84
    m = jnp.max(s, axis=-1, keepdims=True)  # :85
    e = jnp.exp2(s * c - m * c)  # :86
    z = jnp.sum(e, axis=-1, keepdims=True)  # :87
    return jnp.broadcast_to(  # :88-90
        (1.0 / z).reshape(1, -1), (v.shape[0], S)
    ) * jnp.sum(e, axis=0).reshape(1, -1)


BODIES = {"full": jax_full, "dots": jax_dots, "soft": jax_soft}


def _operands(G, dh, S, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(G, dh, S)).astype(np.float32) for _ in range(3)]


def _close_to_max(got, want, rel=1e-6):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("variant", ab.VARIANTS)
@pytest.mark.parametrize("G,dh,S", [(3, 5, 19), (2, 1, 7), (2, 16, 33)])
def test_plain_ablation_matches_pallas_bodies(variant, G, dh, S):
    q, k, v = _operands(G, dh, S, seed=G * 100 + dh + S)
    scale = 1.0 / math.sqrt(dh)
    body = jax.jit(jax.vmap(lambda a, b, c: BODIES[variant](a, b, c, scale)))
    want = np.asarray(body(*map(jnp.asarray, (q, k, v))))
    got = ablate_forward(variant, *map(torch.from_numpy, (q, k, v)), scale)
    assert got.shape == (G, dh, S) and got.dtype == torch.float32
    _close_to_max(got.numpy(), want)


def test_plain_full_matches_jax_row8_kernel():
    q, k, v = _operands(8, 5, 16, seed=4)
    scale = 1.0 / math.sqrt(5)
    ap.set_interpret(True)
    try:
        want = np.asarray(ap.small_attention(*map(jnp.asarray, (q, k, v)), scale))
    finally:
        ap.set_interpret(False)
    got = ab.ablate_full_reference(*map(torch.from_numpy, (q, k, v)), scale)
    _close_to_max(got.numpy(), want)


def test_script_main_on_cpu_prints_its_keys(capsys):
    out = bench_attn_ablate.main(["3", "11", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert out["shape"] == "G3 S11 dh2" and out["device"] == "cpu"
    for key in ("full_fwd_ms", "dots_only_fwd_ms", "softmax_only_fwd_ms"):
        assert out[key] > 0
    assert ab.ablate_full.launches == ab.ablate_dots.launches == ab.ablate_soft.launches == 0


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_attn_ablate.main(["2", "5", "1"])
    with pytest.raises(ValueError, match="CUDA tensor"):
        ab.ablate_soft(*(torch.zeros(1, 1, 4) for _ in range(3)), 1.0)
    with pytest.raises(ValueError, match="unknown ablation variant"):
        ablate_forward("exp", *(torch.zeros(1, 1, 4) for _ in range(3)), 1.0)
