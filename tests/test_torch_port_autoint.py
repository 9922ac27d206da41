"""PyTorch port, AutoInt / DIFM slice: the lane attention and the layers
under the models (``InteractingLayer``, ``FM``, the refined ``LinearModel``)
against the JAX package; the models are in
``tests/test_torch_port_autoint_models.py``.

Inputs come from a numpy seed and go to both sides; weights are carried from
the JAX side with ``from_jax_weights`` / ``set_weights``.  Both sides run fp32
on the CPU.  The JAX lane kernel runs as ``tests/test_attention_pallas.py``
runs it, in interpret mode (``lane_attention.set_interpret(True)``, restored
by the fixture), so the JAX ``InteractingLayer`` takes its Pallas route; the
port on a CPU tensor takes the lane route's plain versions.

Tolerances: rtol/atol 2e-5 (those of ``tests/test_attention_pallas.py``'s
lane tests), gradients within 2e-5 of their largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xdeepfm_tpu.features as jf
import xdeepfm_tpu_torch.features as tf
from xdeepfm_tpu.embeddings import LinearModel as JaxLinearModel
from xdeepfm_tpu.nn.interaction import FM as JaxFM
from xdeepfm_tpu.nn.interaction import InteractingLayer as JaxInteractingLayer
from xdeepfm_tpu.ops import lane_attention as jla
from xdeepfm_tpu_torch.embeddings import EmbeddingCollection, LinearModel, fused_gather
from xdeepfm_tpu_torch.nn.interaction import FM, InteractingLayer
from xdeepfm_tpu_torch.ops import lane_attention as tla
from xdeepfm_tpu_torch.ops import lane_attention_cuda as lac
from xdeepfm_tpu_torch.weights import from_jax_weights

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def interpret():
    jla.set_interpret(True)
    try:
        yield
    finally:
        jla.set_interpret(False)
        tla.set_backend("auto")


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close_to_max(got, want, rtol=2e-5, err_msg=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=rtol * np.abs(want).max() + 1e-8,
                               err_msg=err_msg)


def _assert_launches_zero():
    assert lac.la_forward.launches == 0 and lac.la_backward.launches == 0


# ------------------------------------------------------------ lane attention


@pytest.mark.parametrize("B,S,h,dh", [(64, 13, 2, 5), (130, 39, 2, 5), (32, 8, 1, 4)])
def test_lane_mhsa_packed_matches_jax_kernel(interpret, B, S, h, dh):
    """The JAX test's shapes (``tests/test_attention_pallas.py:136``): the
    packed entry's output and the gradients of sum(sin(out))."""
    rng = np.random.default_rng(B + S)
    E = h * dh
    Q, K, V = (rng.normal(size=(B, S, E)).astype(np.float32) for _ in range(3))
    scale = float(1.0 / np.sqrt(dh))
    jfn = lambda q, k, v: jnp.sum(jnp.sin(jla.lane_mhsa_packed(q, k, v, scale, h)))  # noqa: E731
    want_out = jla.lane_mhsa_packed(*map(jnp.asarray, (Q, K, V)), scale, h)
    want_g = jax.grad(jfn, argnums=(0, 1, 2))(*map(jnp.asarray, (Q, K, V)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (Q, K, V))
    out = tla.lane_mhsa_packed(qt, kt, vt, scale, h)
    np.testing.assert_allclose(_np(out), _np(want_out), **TOL)
    torch.sin(out).sum().backward()
    for got, want in zip((qt.grad, kt.grad, vt.grad), want_g):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    _assert_launches_zero()


@pytest.mark.parametrize("scale", [1.0, 5 ** -0.5])
def test_lane_attention_lane_layout_matches_jax_kernel(interpret, scale):
    """[H, dh, S, B] operands straight into both kernels' entry (the JAX one
    takes whole 128-sample lane blocks), forward and gradients."""
    rng = np.random.default_rng(7)
    q, k, v, g = (rng.normal(size=(2, 5, 26, 128)).astype(np.float32) for _ in range(4))
    args = tuple(map(jnp.asarray, (q, k, v)))
    want_out, vjp = jax.vjp(lambda *a: jla.lane_attention(*a, scale), *args)
    want_g = vjp(jnp.asarray(g))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tla.lane_attention(qt, kt, vt, scale)
    np.testing.assert_allclose(_np(out), _np(want_out), **TOL)
    out.backward(torch.from_numpy(g))
    for got, want in zip((qt.grad, kt.grad, vt.grad), want_g):
        _close_to_max(got, want)
    # the plain backward is the exact gradient of the plain forward
    dq, dk, dv = lac.la_backward_reference(torch.from_numpy(g), *(t.detach() for t in (qt, kt, vt)),
                                           scale)
    for got, want in zip((dq, dk, dv), (qt.grad, kt.grad, vt.grad)):
        torch.testing.assert_close(got, want)


def test_lane_attention_plain_backward_is_autograds():
    """float64: the plain backward against autograd through the plain
    forward, at a ragged S and B, and on the [B, S, E] views."""
    gen = torch.Generator().manual_seed(3)
    base = [torch.randn(7, 39, 8, generator=gen, dtype=torch.float64) for _ in range(4)]
    views = [t.reshape(7, 39, 2, 4).permute(2, 3, 1, 0) for t in base]
    q, k, v = (t.clone().requires_grad_(True) for t in views[:3])
    lac.la_forward_reference(q, k, v, 0.5).backward(views[3])
    got = lac.la_backward_reference(views[3], *views[:3], 0.5)
    for a, b in zip(got, (q.grad, k.grad, v.grad)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_lane_routing_and_limits():
    assert tla.MAX_S == jla.MAX_S == 64
    assert tla.use_lane_attention(26) and tla.use_lane_attention(64)
    assert not tla.use_lane_attention(65)
    tla.set_backend("xla")
    try:
        assert not tla.use_lane_attention(26)
    finally:
        tla.set_backend("auto")
    with pytest.raises(ValueError):
        tla.set_backend("pallas")
    x = torch.zeros(1, 17, 8, 4)  # dh = 17: past the kernels' registers
    with pytest.raises(ValueError, match="dh"):
        tla.lane_attention(x, x, x, 1.0)
    y = torch.zeros(1, 4, 65, 4)
    with pytest.raises(ValueError, match="S = 65"):
        tla.lane_attention(y, y, y, 1.0)
    assert tla.lane_attention(y, y, y, 1.0, backend="torch").shape == y.shape
    with pytest.raises(ValueError):
        tla.lane_attention(y, y, y, 1.0, backend="cuda")
    # the packed entry hands the kernels [H, dh, S, B] views of one dense layout
    Q = torch.zeros(3, 26, 10)
    view = Q.reshape(3, 26, 2, 5).permute(2, 3, 1, 0)
    assert lac.dense_strides(view) and not lac.dense_strides(view[:, :, ::2])


def test_bench_lane_runs_the_plain_versions_on_cpu(capsys):
    """``scripts/bench_lane.py`` on the CPU times the plain versions: a line
    for each kernel at each scale, packed at every batch, then lanes."""
    from xdeepfm_tpu_torch.scripts import bench_lane

    outs = bench_lane.main(["--device", "cpu", "--batches", "3", "2", "--repeats", "1"])
    assert [(o["kernel"], o["batch"], o["layout"], o["scale"]) for o in outs] == [
        (k, b, layout, scale) for b, layout in ((3, "packed"), (2, "packed"), (3, "lanes"))
        for scale in (1.0, 5 ** -0.5) for k in ("la_fwd", "la_bwd")]
    for o in outs:
        assert o["device"] == "cpu" and len(o["ms"]) == 1 and "device_ms" not in o
        assert o["max_abs_err_vs_plain"] == 0.0 and (o["H"], o["dh"], o["S"]) == (2, 5, 26)
    assert len(capsys.readouterr().out.splitlines()) == len(outs)


# -------------------------------------------------------------------- layers


@pytest.mark.parametrize("route", ["lanes", "xla"])
@pytest.mark.parametrize("scaling,use_res", [(False, True), (True, True), (True, False)])
def test_interacting_layer_matches_jax(interpret, route, scaling, use_res):
    """Output, input gradient and every parameter's gradient of
    sum(sin(layer(x))); the JAX layer takes the Pallas kernel (interpret) on
    the lane route and its XLA einsums on the other."""
    if route == "xla":
        jla.set_interpret(False)
        tla.set_backend("xla")
    rng = np.random.default_rng(int(scaling) + 2 * int(use_res))
    x = rng.normal(size=(65, 7, 8)).astype(np.float32)
    jl = JaxInteractingLayer(embedding_size=8, head_num=2, use_res=use_res, scaling=scaling)
    variables = jl.init(jax.random.PRNGKey(0), jnp.asarray(x))
    assert jla.use_lane_attention(7) == (route == "lanes")

    def jloss(params, xx):
        return jnp.sum(jnp.sin(jl.apply({"params": params}, xx)))

    want = jl.apply(variables, jnp.asarray(x))
    want_gp, want_gx = jax.grad(jloss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    layer = InteractingLayer(8, head_num=2, use_res=use_res, scaling=scaling)
    layer.load_state_dict(from_jax_weights({"params": variables["params"]}), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = layer(xt)
    np.testing.assert_allclose(_np(out), _np(want), **TOL)
    torch.sin(out).sum().backward()
    _close_to_max(xt.grad, want_gx)
    for name, p in layer.named_parameters():
        _close_to_max(p.grad, want_gp[name], err_msg=name)
    assert sorted(dict(layer.named_parameters())) == sorted(want_gp)
    _assert_launches_zero()


def test_interacting_layer_rejects_bad_heads():
    with pytest.raises(ValueError, match="head_num"):
        InteractingLayer(8, head_num=0)
    with pytest.raises(ValueError, match="multiple"):
        InteractingLayer(10, head_num=4)


def test_fm_matches_jax():
    x = np.random.default_rng(0).normal(size=(9, 6, 5)).astype(np.float32)
    want = JaxFM().apply({}, jnp.asarray(x))
    np.testing.assert_allclose(_np(FM()(torch.from_numpy(x))), _np(want), **TOL)


N_SPARSE, VOCAB, DIM, N_DENSE = 4, 30, 10, 3


def _cols(mod):
    return [mod.SparseFeat(f"C{i}", VOCAB, DIM) for i in range(N_SPARSE)] + [
        mod.DenseFeat(f"I{i}") for i in range(N_DENSE)
    ]


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = {f"C{i}": rng.integers(0, VOCAB, n) for i in range(N_SPARSE)}
    x.update({f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(N_DENSE)})
    return x, (rng.uniform(size=n) < 0.4).astype(np.float32)


@pytest.mark.parametrize("fused_rows", [False, True])
def test_linear_model_refine_weight_matches_jax(fused_rows):
    """The refined first-order term, its table's and refine weight's
    gradients; with ``fused_rows`` its rows come from the fused gather
    through the main and linear tables, as AutoInt's and DIFM's do."""
    schema_j, schema_t = jf.FeatureSchema.build(_cols(jf)), tf.FeatureSchema.build(_cols(tf))
    x, _ = _data(40, seed=5)
    bj = {k: jnp.asarray(v) for k, v in schema_j.pack(x).items()}
    bt = {k: torch.as_tensor(v) for k, v in schema_t.pack(x).items()}
    jm = JaxLinearModel(feature_columns=tuple(_cols(jf)), schema=schema_j)
    variables = jm.init(jax.random.PRNGKey(0), bj)
    rng = np.random.default_rng(6)
    params = jax.tree.map(lambda v: rng.standard_normal(np.shape(v)).astype(np.float32),
                          variables["params"])
    refine = rng.normal(size=(40, N_SPARSE)).astype(np.float32)

    def jloss(p, r):
        return jnp.sum(jnp.sin(jm.apply({"params": p}, bj, sparse_feat_refine_weight=r)))

    want = jm.apply({"params": params}, bj, sparse_feat_refine_weight=jnp.asarray(refine))
    want_gp, want_gr = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(refine))

    lm = LinearModel(_cols(tf), schema_t)
    lm.load_state_dict(from_jax_weights({"params": params}), strict=True)
    rt = torch.from_numpy(refine).requires_grad_(True)
    rows = None
    if fused_rows:
        main = EmbeddingCollection(_cols(tf), schema_t)
        dim, ids = main.sparse_ids(bt, _cols(tf)[:N_SPARSE])
        rows = fused_gather((main.table_d10, lm.embedding_dict.table_d1), ids.reshape(-1))[:, dim:]
    out = lm(bt, sparse_rows=rows, sparse_feat_refine_weight=rt)
    np.testing.assert_allclose(_np(out), _np(want), **TOL)
    torch.sin(out).sum().backward()
    _close_to_max(rt.grad, want_gr)
    _close_to_max(lm.embedding_dict.table_d1.grad, want_gp["embedding_dict"]["table_d1"])
    _close_to_max(lm.weight.grad, want_gp["weight"])
    # without a refine weight the term is the plain sum (xDeepFM's path)
    plain = lm(bt, sparse_rows=rows)
    np.testing.assert_allclose(_np(plain), _np(jm.apply({"params": params}, bj)), **TOL)
