"""PyTorch port, attention-CIN slice: ``small_attention``, the
``mhsa_attention_packed`` entry points, ``attn_block`` and CINAttention /
CINAttentionV2 against the JAX package (the models are in
``tests/test_torch_port_attention_models.py``).

Inputs come from a numpy seed and go to both sides; module weights are
carried from the JAX side with ``from_jax_weights``.  Both sides run fp32 on
the CPU (the port's kernels fall back to nothing here: a CPU tensor takes
their plain versions).  The JAX kernels run as ``tests/test_attention_pallas.py``
runs them, in interpret mode (``attention_pallas.set_interpret(True)``;
``attn_block_pallas.set_interpret(True)`` with ``set_backend("pallas")``),
restored in ``finally``.

Tolerances (those of ``tests/test_attention_pallas.py``): forward rtol 1e-4,
atol 1e-5; gradients rtol 1e-3, atol 1e-5.  Under bf16 both sides round the
same operands to bf16, but an fp32 value computed in another order can land
on the other side of a rounding boundary and move by one bf16 step (2^-8):
rtol 1e-2 there, atol 1e-2 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xdeepfm_tpu.nn import cin_attention as jca
from xdeepfm_tpu.ops import attention_pallas as ap
from xdeepfm_tpu.ops import attn_block_pallas as abp
from xdeepfm_tpu_torch.nn import cin_attention as tca
from xdeepfm_tpu_torch.ops import attention as tat
from xdeepfm_tpu_torch.ops import attention_cuda, attn_block_cuda
from xdeepfm_tpu_torch.ops import attn_block as tab
from xdeepfm_tpu_torch.weights import canonical_paths, flatten_tree, from_jax_weights

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_launches_zero():
    for fn in (attention_cuda.sa_forward, attention_cuda.sa_backward,
               attn_block_cuda.ab_forward, attn_block_cuda.ab_backward):
        assert fn.launches == 0


# ------------------------------------------------------------ small_attention


@pytest.mark.parametrize("G,dh,S,precision", [
    (4, 5, 16, "fp32"), (5, 3, 37, "fp32"), (4, 5, 16, "bf16"), (3, 8, 24, "bf16"),
])
def test_small_attention_matches_jax_kernel(G, dh, S, precision):
    rng = np.random.default_rng(G + dh + S)
    q, k, v, g = (rng.normal(size=(G, dh, S)).astype(np.float32) for _ in range(4))
    scale = float(1.0 / np.sqrt(dh))
    ap.set_interpret(True)
    ap.set_precision(precision)
    tat.set_precision(precision)
    try:
        _, res = ap._sa_fwd(*map(jnp.asarray, (q, k, v)), scale)
        want_o, want_m, want_z = res[3], res[4], res[5]
        _, vjp = jax.vjp(lambda a, b, c: ap.small_attention(a, b, c, scale),
                         *map(jnp.asarray, (q, k, v)))
        want_g = vjp(jnp.asarray(g))
        qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        out = tat.small_attention(qt, kt, vt, scale)
        out.backward(torch.from_numpy(g))
        _, m, inv_z = attention_cuda.sa_forward_reference(qt, kt, vt, scale, precision)
    finally:
        ap.set_interpret(False)
        ap.set_precision("fp32")
        tat.set_precision("fp32")
    if precision == "fp32":
        fwd, grad = FWD, GRAD
    else:
        fwd = grad = dict(rtol=1e-2, atol=1e-2 * float(np.abs(want_o).max()))
    np.testing.assert_allclose(_np(out), want_o, **fwd)
    np.testing.assert_allclose(_np(m), want_m, **FWD)
    np.testing.assert_allclose(_np(inv_z), want_z, **FWD)
    for name, got, want in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), want_g):
        tol = grad if precision == "fp32" else dict(
            rtol=1e-2, atol=1e-2 * float(np.abs(want).max()))
        np.testing.assert_allclose(_np(got), np.asarray(want), err_msg=name, **tol)
    _assert_launches_zero()


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("route", ["auto", "xla"])
def test_mhsa_attention_packed_matches_jax(transposed, route):
    rng = np.random.default_rng(7)
    B, S, heads, dh = 3, 12, 2, 5
    shape = (B, heads * dh, S) if transposed else (B, S, heads * dh)
    Q, K, V, g = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    jfn = ap.mhsa_attention_packed_t if transposed else ap.mhsa_attention_packed
    tfn = tat.mhsa_attention_packed_t if transposed else tat.mhsa_attention_packed
    scale = float(1.0 / np.sqrt(dh))
    ap.set_interpret(route == "auto")  # the JAX kernel route in interpret mode
    try:
        want, vjp = jax.vjp(lambda a, b, c: jfn(a, b, c, scale, heads, backend=route),
                            *map(jnp.asarray, (Q, K, V)))
        want_g = vjp(jnp.asarray(g))
    finally:
        ap.set_interpret(False)
    ts = [torch.tensor(a, requires_grad=True) for a in (Q, K, V)]
    got = tfn(*ts, scale, heads, backend=route)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)
    for t, w in zip(ts, want_g):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), **GRAD)


def test_attention_backends_and_limits():
    assert tat.get_mhsa_backend() == "auto"
    with pytest.raises(ValueError):
        tat.set_mhsa_backend("cuda")
    with pytest.raises(ValueError):
        tat.set_precision("fp16")
    q = torch.zeros(2, 5, 8)
    with pytest.raises(ValueError, match="backend"):
        tat.small_attention(q, q, q, 0.5, backend="kernel")
    with pytest.raises(ValueError, match="dh = 17"):
        tat.small_attention(torch.zeros(1, 17, 8), torch.zeros(1, 17, 8), torch.zeros(1, 17, 8), 1.0)
    big = torch.zeros(1, 5, 4000)  # q, k, v, g: 4 * 5 * 4002 * 4 bytes > 227 KB
    with pytest.raises(ValueError, match="shared memory"):
        tat.small_attention(big, big, big, 1.0)
    # the plain version takes any S
    assert tat.small_attention(big, big, big, 1.0, backend="torch").shape == big.shape
    # the kernel wrappers take CUDA tensors only, and check before building
    with pytest.raises(ValueError, match="CUDA"):
        attention_cuda.sa_forward(q, q, q, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        attn_block_cuda.ab_forward(tab.BlockCfg(1, 2, 0.5, True, True, 1e-5),
                                   torch.zeros(2, 10, 8), *[torch.zeros(1)] * 9)


# ------------------------------------------------------------------ attn_block


def _block_case(rng, B, E, S, H, L):
    dh = E // H
    w = lambda *s: (rng.normal(size=s) / np.sqrt(E)).astype(np.float32)  # noqa: E731
    x = rng.normal(size=(B, E, S)).astype(np.float32)
    params = [w(L * H, E, dh), w(L * H, E, dh), w(L * H, E, dh), w(L * H, dh, E),
              (1 + 0.1 * rng.normal(size=(L, E, 1))).astype(np.float32),
              (0.1 * rng.normal(size=(L, E, 1))).astype(np.float32), w(E, E),
              (0.1 * rng.normal(size=(E, 1))).astype(np.float32), w(E, 1)]
    return x, params, rng.normal(size=(B, E)).astype(np.float32)


@pytest.mark.parametrize("L,residual,layer_norm,S", [
    (1, True, True, 16), (2, True, True, 10), (1, False, True, 10), (1, True, False, 10),
])
def test_attn_block_matches_jax_kernel(L, residual, layer_norm, S):
    B, E, H = 4, 10, 2
    rng = np.random.default_rng(L * 10 + S)
    x, params, g = _block_case(rng, B, E, S, H, L)
    scale = float(1.0 / np.sqrt(E // H))
    jcfg = abp.BlockCfg(L, H, scale, residual, layer_norm, 1e-5)
    abp.set_interpret(True)
    try:
        want, vjp = jax.vjp(lambda *a: abp.attn_block(jcfg, *a),
                            *map(jnp.asarray, [x] + params))
        want_g = vjp(jnp.asarray(g))
    finally:
        abp.set_interpret(False)
    ts = [torch.tensor(a, requires_grad=True) for a in [x] + params]
    got = tab.attn_block(tab.BlockCfg(L, H, scale, residual, layer_norm, 1e-5), *ts)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)
    names = ("dx", "dwq", "dwk", "dwv", "dwo", "dgamma", "dbeta", "dw1", "db1", "dw2")
    for name, t, w in zip(names, ts, want_g):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), err_msg=name, **GRAD)
    _assert_launches_zero()


def test_attn_block_gates_and_packing():
    assert tab.use_fused_block(seq_len=37)  # no S % 128 gate on Hopper
    tab.set_backend("xla")
    try:
        assert not tab.use_fused_block(seq_len=256)
    finally:
        tab.set_backend("auto")
    with pytest.raises(ValueError):
        tab.set_backend("cuda")
    with pytest.raises(ValueError, match="multiple"):
        attn_block_cuda.check_ab_shape(10, 16, 3, 1)
    with pytest.raises(ValueError, match="shared memory"):
        attn_block_cuda.check_ab_shape(32, 2000, 2, 1)
    attn_block_cuda.check_ab_shape(10, 256, 2, 1)  # V1's block
    assert attn_block_cuda.ab_smem_bytes(10, 256, 2) == 111_192  # two blocks an SM
    # packing from nn.Linear weights [out, in] equals the JAX packing of the
    # flax kernel [in, out] (its transpose)
    rng = np.random.default_rng(0)
    kern = rng.normal(size=(10, 10)).astype(np.float32)
    weight = torch.from_numpy(np.ascontiguousarray(kern.T))
    for heads in (1, 2, 5):
        np.testing.assert_array_equal(_np(tab.pack_projection(weight, heads)),
                                      np.asarray(abp.pack_projection(jnp.asarray(kern), heads)))
        np.testing.assert_array_equal(
            _np(tab.pack_out_projection(weight, heads)),
            np.asarray(abp.pack_out_projection(jnp.asarray(kern), heads)))


# --------------------------------------------------------------- CIN modules

MODULE_CASES = [
    ("CINAttention", {}),
    ("CINAttention", {"use_residual": False}),
    ("CINAttention", {"use_layer_norm": False}),
    ("CINAttentionV2", {"num_attn_layers": 1}),
    ("CINAttentionV2", {"num_attn_layers": 2}),
    ("CINAttentionV2", {"num_attn_layers": 2, "use_layer_norm": False}),
]


@pytest.mark.parametrize("route", ["fused", "unfused"])
@pytest.mark.parametrize("cls_name,kw", MODULE_CASES)
def test_cin_attention_modules_match_jax(cls_name, kw, route):
    """Output and every gradient (parameters and input) of the port's module
    against the JAX module on the same route: the fused block (JAX: the
    Pallas kernels in interpret mode) or the unfused one (JAX: XLA)."""
    B, m, E = 4, 5, 10
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, m, E)).astype(np.float32)
    jlayer = getattr(jca, cls_name)(field_size=m, embedding_size=E, layer_size=(8, 6),
                                    num_heads=2, **kw)
    variables = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda v: v + 0.05 * jnp.asarray(
        rng.normal(size=np.shape(v)).astype(np.float32)), variables["params"])
    g = rng.normal(size=jlayer.apply({"params": params}, jnp.asarray(x)).shape).astype(np.float32)

    def jloss(p, xin):
        out = jlayer.apply({"params": p}, xin)
        return jnp.sum(out * jnp.asarray(g)), out

    fused = route == "fused"
    abp.set_backend("pallas" if fused else "xla")
    abp.set_interpret(fused)
    ap.set_interpret(fused)
    tab.set_backend("auto" if fused else "xla")
    try:
        (_, want), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            params, jnp.asarray(x))
        tlayer = getattr(tca, cls_name)(m, E, layer_size=(8, 6), num_heads=2, **kw)
        tlayer.load_state_dict(from_jax_weights({"params": params}), strict=True)
        xt = torch.tensor(x, requires_grad=True)
        got = tlayer(xt)
        (got * torch.from_numpy(g)).sum().backward()
    finally:
        abp.set_backend("auto")
        abp.set_interpret(False)
        ap.set_interpret(False)
        tab.set_backend("auto")
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(gx), **GRAD)
    paths = canonical_paths(tlayer)
    want_g = dict(flatten_tree(jax.tree.map(np.asarray, gp)))
    got_g = {}
    for name, p in tlayer.named_parameters():
        gr = _np(p.grad)
        got_g[paths[name]] = gr.T if paths[name].endswith("/kernel") else gr
    assert sorted(got_g) == sorted(want_g)
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], err_msg=k, **GRAD)


def test_mhsa_dropout_branch_takes_no_kernel_and_is_seeded():
    torch.manual_seed(0)
    mhsa = tca.MultiHeadSelfAttention(10, num_heads=2, dropout=0.5,
                                      generator=torch.Generator().manual_seed(1))
    x = torch.randn(3, 10, 12)
    a = mhsa(x, training=True, transposed=True, generator=torch.Generator().manual_seed(5))
    b = mhsa(x, training=True, transposed=True, generator=torch.Generator().manual_seed(5))
    c = mhsa(x, training=False, transposed=True)
    torch.testing.assert_close(a, b)
    assert not torch.allclose(a, c)
    mhsa.dropout = 0.0
    torch.testing.assert_close(mhsa(x, training=True, transposed=True), c)
    assert tca.get_valid_num_heads(10, 4) == 2 and tca.get_valid_num_heads(10, 3) == 2
    assert tca.get_valid_num_heads(7, 4) == 1 and tca.get_valid_num_heads(8, 4) == 4
