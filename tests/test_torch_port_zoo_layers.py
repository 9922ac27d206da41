"""PyTorch port, the rest of the single-task zoo: the layers of FiBiNET
(``SENETLayer``, ``BilinearInteraction``), PNN (``InnerProductLayer``,
``OutterProductLayer``), CCPM (``kmax_lastaxis``, ``KMaxPooling``,
``Conv2dSame``, ``ConvLayer``), MLR (``MultiLinearModel``) and ONN (its pair
alignment) against the JAX package; the models are in
``tests/test_torch_port_zoo_models.py``.

Inputs are numpy draws from a seed and go to both sides; each JAX layer is
initialised by flax and its parameters carried to the port with
``from_jax_weights(tree, layer)``, which takes a raw ``kernel`` (the outer
product's, a ``Conv2dSame``'s) untransposed.  Both sides run fp32 on the CPU
at B 8, F 5, E 4.

Tolerances (``tests/test_torch_port_fm_layers.py``'s): outputs and the
gradients of sum(sin(out)) with respect to the inputs and every parameter
within rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xdeepfm_tpu.features as jf
import xdeepfm_tpu_torch.features as tf
from xdeepfm_tpu.embeddings import MultiLinearModel as JaxMultiLinearModel
from xdeepfm_tpu.nn import core as jcore
from xdeepfm_tpu.nn import interaction as jint
from xdeepfm_tpu.nn import sequence as jseq
from xdeepfm_tpu_torch.embeddings import MultiLinearModel
from xdeepfm_tpu_torch.models.onn import ONNModule
from xdeepfm_tpu_torch.nn import (
    BilinearInteraction,
    Conv2dSame,
    ConvLayer,
    InnerProductLayer,
    KMaxPooling,
    OutterProductLayer,
    SENETLayer,
    kmax_lastaxis,
)
from xdeepfm_tpu_torch.weights import flatten_tree, from_jax_weights, to_jax_weights

TOL = dict(rtol=1e-5, atol=1e-6)
B, F_, E = 8, 5, 4


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _check_layer(jlayer, layer, x, **call):
    """The JAX layer's flax init carried into ``layer`` through
    ``from_jax_weights(tree, layer)``; then the outputs and the gradients
    of sum(sin(out)) by ``jax.grad`` and by autograd.  Returns the JAX
    parameters."""
    variables = jlayer.init(jax.random.PRNGKey(3), jnp.asarray(x), **call)
    params = variables.get("params", {})
    layer.load_state_dict(from_jax_weights({"params": params}, layer), strict=True)

    def jloss(p, xx):
        return jnp.sum(jnp.sin(jlayer.apply({"params": p}, xx, **call)))

    want = jax.jit(lambda p, xx: jlayer.apply({"params": p}, xx, **call))(params, jnp.asarray(x))
    want_gp, want_gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = layer(xt, **call)
    assert out.shape == want.shape
    np.testing.assert_allclose(_np(out), _np(want), **TOL)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(_np(xt.grad), _np(want_gx), **TOL)
    want_gp = dict(flatten_tree(jax.tree.map(np.asarray, want_gp)))
    paths = {k.replace(".", "/"): p for k, p in layer.named_parameters()}
    got_gp = {k: np.asarray(v) for k, v in flatten_tree(to_jax_weights(layer)["params"])}
    assert sorted(got_gp) == sorted(want_gp)
    for name, g in want_gp.items():
        p = paths.get(name, paths.get(name.rsplit("/", 1)[0] + "/weight"))
        grad = _np(p.grad)
        if name.endswith("/kernel") and name not in paths:  # an nn.Linear weight
            grad = grad.T
        np.testing.assert_allclose(grad, g, err_msg=name, **TOL)
    assert float(np.abs(_np(want)).max()) > 1e-3
    return params


# ------------------------------------------------------------------ FiBiNET


@pytest.mark.parametrize("training", [False, True])
def test_senet_layer_matches_jax(training):
    """``fc1`` [5 -> max(1, 5 // 2) = 2] and ``fc2``, no bias, relu after
    each; the training flag changes nothing."""
    x = _rand(0, B, F_, E)
    _check_layer(jint.SENETLayer(filed_size=F_, reduction_ratio=2),
                 SENETLayer(F_, reduction_ratio=2), x, training=training)


@pytest.mark.parametrize("flatten", [False, True])
@pytest.mark.parametrize("bilinear_type", ["all", "each", "interaction"])
def test_bilinear_interaction_matches_jax(bilinear_type, flatten):
    """Each weight [in, out] untransposed (a non-symmetric [E, E] shows
    it); ``flatten_output`` gives [B, P * E] in (p, e) order."""
    x = _rand(1, B, F_, E)
    params = _check_layer(
        jint.BilinearInteraction(filed_size=F_, embedding_size=E, bilinear_type=bilinear_type,
                                 flatten_output=flatten),
        BilinearInteraction(F_, E, bilinear_type, flatten_output=flatten), x)
    (w,) = jax.tree.leaves(params)
    assert not np.allclose(np.asarray(w), np.swapaxes(np.asarray(w), -1, -2))


def test_fibinet_layers_reject_other_ranks_and_types():
    x = torch.zeros(B, F_ * E)
    for layer in (SENETLayer(F_), BilinearInteraction(F_, E)):
        with pytest.raises(ValueError, match="Unexpected inputs dimensions 2, expect to be 3"):
            layer(x)
    with pytest.raises(NotImplementedError):
        BilinearInteraction(F_, E, "pairwise")


def test_pair_selection_made_by_predict_serves_training():
    """The one-hot pair selections are cached across layers; those first
    made under ``torch.inference_mode`` (a ``predict``) are plain tensors,
    so a training step after it runs."""
    layer = BilinearInteraction(6, E, "all")
    x = torch.from_numpy(_rand(19, B, 6, E))
    with torch.inference_mode():
        layer(x)
    xt = x.clone().requires_grad_(True)
    layer(xt).sum().backward()
    assert xt.grad is not None and layer.bilinear_all.grad is not None


# ---------------------------------------------------------------------- PNN


@pytest.mark.parametrize("reduce_sum", [True, False])
def test_inner_product_layer_matches_jax(reduce_sum):
    x = _rand(2, B, F_, E)
    _check_layer(jint.InnerProductLayer(reduce_sum=reduce_sum), InnerProductLayer(reduce_sum), x)


@pytest.mark.parametrize("kernel_type", ["mat", "vec", "num"])
def test_outter_product_layer_matches_jax(kernel_type):
    """The raw ``kernel`` ([E, P, E], [P, E] or [P, 1]) crosses
    ``from_jax_weights`` under its own name, untransposed."""
    x = _rand(3, B, F_, E)
    layer = OutterProductLayer(F_, E, kernel_type)
    _check_layer(jint.OutterProductLayer(field_size=F_, embedding_size=E,
                                         kernel_type=kernel_type), layer, x)
    assert [k for k, _ in layer.named_parameters()] == ["kernel"]


@pytest.mark.parametrize("kernel_type", ["mat", "vec", "num"])
def test_weights_keep_a_raw_kernel_untransposed(kernel_type):
    """A tree holding the outer product's ``kernel`` loads into the layer
    bit-exactly under ``kernel`` (not renamed to ``weight``, not reversed)
    and ``to_jax_weights`` writes it back as ``kernel``; beside it an
    ``nn.Linear`` still maps its flax kernel transposed."""
    layer = OutterProductLayer(F_, E, kernel_type)
    net = torch.nn.Module()
    net.outterproduct = layer
    net.dnn_linear = torch.nn.Linear(3, 2, bias=False)
    kernel = _rand(4, *layer.kernel.shape)
    dense = _rand(5, 3, 2)
    tree = {"params": {"outterproduct": {"kernel": kernel}, "dnn_linear": {"kernel": dense}}}
    state = from_jax_weights(tree, net)
    assert sorted(state) == ["dnn_linear.weight", "outterproduct.kernel"]
    net.load_state_dict(state, strict=True)
    np.testing.assert_array_equal(_np(layer.kernel), kernel)
    np.testing.assert_array_equal(_np(net.dnn_linear.weight), dense.T)
    back = dict(flatten_tree(to_jax_weights(net)["params"]))
    assert sorted(back) == ["dnn_linear/kernel", "outterproduct/kernel"]
    np.testing.assert_array_equal(back["outterproduct/kernel"], kernel)
    np.testing.assert_array_equal(back["dnn_linear/kernel"], dense)


# --------------------------------------------------------------------- CCPM


@pytest.mark.parametrize("k", [1, 3, 13])
def test_kmax_lastaxis_matches_jax(k):
    """Values sorted descending and each cotangent at its entry, against
    the JAX max-and-mask passes, at k 1, 3 and 13 of 16."""
    x = _rand(6, B, 3, 16)
    w = _rand(7, B, 3, k)
    want = jseq.kmax_lastaxis(jnp.asarray(x), k)
    want_g = jax.grad(lambda xx: jnp.sum(jseq.kmax_lastaxis(xx, k) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = kmax_lastaxis(xt, k)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(xt.grad), _np(want_g))


def test_kmax_lastaxis_ties_send_the_gradient_where_jax_does():
    """A row with three equal maxima: the first occurrences are taken in
    index order and take their cotangents, as in JAX; ``torch.topk`` would
    take index 4 before index 1 here."""
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0], [1.0, 1.0, 1.0, 1.0, 1.0]], np.float32)
    w = np.array([[10.0, 20.0, 30.0], [1.0, 2.0, 3.0]], np.float32)
    want_g = jax.grad(lambda xx: jnp.sum(jseq.kmax_lastaxis(xx, 3) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (kmax_lastaxis(xt, 3) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(_np(xt.grad), _np(want_g))
    np.testing.assert_array_equal(_np(xt.grad)[0], [0.0, 10.0, 20.0, 0.0, 30.0])
    np.testing.assert_array_equal(_np(xt.grad)[1], [1.0, 2.0, 3.0, 0.0, 0.0])


def test_kmax_pooling_axis_1_of_4d_matches_jax():
    """[B, F, E, C] pooled over the fields, the output [B, k, E, C]."""
    x = _rand(8, B, 7, E, 3)
    _check_layer(jseq.KMaxPooling(k=4, axis=1), KMaxPooling(4, 1), x)


@pytest.mark.parametrize("axis,k", [(4, 2), (-1, 2), (1, 0), (1, 8)])
def test_kmax_pooling_errors_match_jax(axis, k):
    x = _rand(9, B, 7, E, 3)
    with pytest.raises(ValueError) as want:
        jseq.KMaxPooling(k=k, axis=axis).apply({}, jnp.asarray(x))
    with pytest.raises(ValueError) as got:
        KMaxPooling(k, axis)(torch.from_numpy(x))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kernel_size,strides", [((6, 1), (1, 1)), ((5, 1), (1, 1)),
                                                 ((2, 3), (2, 1))])
def test_conv2d_same_matches_flax(kernel_size, strides):
    """An even and an odd field width as CCPM runs them, and a 2-D window
    at stride 2: XLA's SAME padding (the extra row after), NHWC in and out,
    the raw ``kernel`` [kh, kw, C, out] carried untransposed.  Inputs at
    scale 0.3, as ``tests/test_torch_port_fm_layers.py``'s CrossNet: at unit
    scale a kernel gradient sums 224 terms up to ~14 in another order than
    XLA's, and a cancelled entry misses rtol 1e-5 by rounding alone."""
    x = _rand(10, B, 7, E, 3, scale=0.3)
    _check_layer(jcore.Conv2dSame(features=2, kernel_size=kernel_size, strides=strides),
                 Conv2dSame(3, 2, kernel_size, strides), x)


@pytest.mark.parametrize("widths,filters", [((6, 5), (4, 4)), ((3, 2), (2, 3))])
def test_conv_layer_matches_jax(widths, filters):
    """CCPM's stack at its default widths (even then odd) and at the zoo
    test's (odd then even) over 7 fields: k-max pooling to 5 then 3 fields;
    the output [B, 3, E, filters[-1]] in the JAX layout."""
    x = _rand(11, B, 7, E, 1)
    layer = ConvLayer(7, widths, filters)
    _check_layer(jint.ConvLayer(field_size=7, conv_kernel_width=widths, conv_filters=filters),
                 layer, x)
    assert ConvLayer.output_field_size(7, 2) == 3 == jint.ConvLayer.output_field_size(7, 2)


def test_conv_layer_is_one_fp32_matmul_per_layer(monkeypatch):
    """No convolution routine runs (so cuDNN's TF32 default cannot reach
    it); each layer's products are one matmul of its windows."""
    calls = []
    for name in ("conv2d", "convolution"):
        monkeypatch.setattr(torch.nn.functional if name == "conv2d" else torch, name,
                            lambda *a, **k: calls.append(a) or None)
    out = ConvLayer(7, (6, 5), (4, 4))(torch.from_numpy(_rand(12, B, 7, E, 1)))
    assert calls == [] and out.shape == (B, 3, E, 4) and out.dtype == torch.float32


def test_zoo_layer_inits_follow_the_jax_distributions():
    """glorot uniform bounds sqrt(6 / (fan_in + fan_out)) with flax's fans
    (the outer product's "mat" kernel: fan_in P * E, fan_out E * E; a conv
    kernel: w * C and w * out); the conv bias U(±1/sqrt(C * w)); each
    bilinear slice and SENET's fc U(±1/sqrt(fan_in))."""
    gen = torch.Generator().manual_seed(0)
    F, Eb = 26, 10
    Pb = F * (F - 1) // 2
    for kind, (fi, fo) in (("mat", (Pb * Eb, Eb * Eb)), ("vec", (Pb, Eb)), ("num", (Pb, 1))):
        k = OutterProductLayer(F, Eb, kind, generator=gen).kernel.detach()
        bound = np.sqrt(6.0 / (fi + fo))
        assert float(k.abs().max()) <= bound
        assert float(k.abs().max()) > 0.95 * bound, kind
    conv = Conv2dSame(4, 4, (5, 1), generator=gen).Conv_0
    bound = np.sqrt(6.0 / (5 * 4 + 5 * 4))
    assert 0.8 * bound < float(conv.kernel.detach().abs().max()) <= bound
    assert float(conv.bias.detach().abs().max()) <= 1 / np.sqrt(20)
    bi = BilinearInteraction(F, Eb, "interaction", generator=gen).bilinear_inter.detach()
    assert tuple(bi.shape) == (Pb, Eb, Eb)
    assert 0.95 / np.sqrt(Eb) < float(bi.abs().max()) <= 1 / np.sqrt(Eb)
    se = SENETLayer(F, 3, generator=gen)
    assert tuple(se.fc1.weight.shape) == (8, F)
    assert float(se.fc1.weight.detach().abs().max()) <= 1 / np.sqrt(F)


# ---------------------------------------------------------------------- MLR


def _mlr_cols(mod):
    return (mod.SparseFeat("a", 9, 4), mod.DenseFeat("d", 2),
            mod.VarLenSparseFeat(mod.SparseFeat("h", 9, 4, embedding_name="a"), maxlen=3),
            mod.VarLenSparseFeat(mod.SparseFeat("g", 7, 4), maxlen=4, combiner="sum",
                                 length_name="g_len"),
            mod.SparseFeat("c", 5, 4))


def test_multi_linear_model_matches_jax():
    """Three outputs over a sparse pair, a varlen field on the first one's
    table, a varlen field of its own (sum, by length) and a dense pair: one
    [rows, 3] table (every dim forced to 3) and ``weight`` [2, 3]; the
    [B, 3] logits and the gradients of every parameter."""
    rng = np.random.default_rng(13)
    batch = {"sparse": rng.integers(0, 5, (B, 2)).astype(np.int32),
             "dense": rng.uniform(0, 1, (B, 2)).astype(np.float32),
             "vl_h": rng.integers(0, 9, (B, 3)).astype(np.int32),
             "vl_g": rng.integers(0, 7, (B, 4)).astype(np.int32),
             "len_g_len": rng.integers(1, 5, (B, 1)).astype(np.int32)}
    jcols, tcols = _mlr_cols(jf), _mlr_cols(tf)
    jm = JaxMultiLinearModel(feature_columns=jcols, schema=jf.FeatureSchema.build(jcols),
                             n_outputs=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jm.init(jax.random.PRNGKey(0), jb)["params"]
    params = jax.tree.map(lambda v: jnp.asarray(_rand(14, *v.shape, scale=0.5)), params)
    tm = MultiLinearModel(tcols, tf.FeatureSchema.build(tcols), 3)
    tm.load_state_dict(from_jax_weights({"params": params}, tm), strict=True)
    assert sorted(k for k, _ in tm.named_parameters()) == ["embedding_dict.table_d3", "weight"]
    w = _rand(15, B, 3)
    want = jm.apply({"params": params}, jb)
    want_g = jax.grad(lambda p: jnp.sum(jnp.sin(jm.apply({"params": p}, jb)) * w))(params)
    got = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    (torch.sin(got) * torch.from_numpy(w)).sum().backward()
    want_g = dict(flatten_tree(jax.tree.map(np.asarray, want_g)))
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p.grad), want_g[k.replace(".", "/")], err_msg=k, **TOL)


# ---------------------------------------------------------------------- ONN


def test_onn_pair_alignment_matches_the_naive_per_pair_product():
    """ONN's second-order block against the per-pair product it stands for
    (``tests/test_layers.py:173`` for the JAX module): pair (i, j) is
    feature i's emb1 block j - i - 1 times feature j's emb2 block i; and
    the gradient of each pair table against autograd through that naive
    product."""
    cols = [tf.SparseFeat(f"C{i}", 12, E) for i in range(F_)] + [tf.DenseFeat("I0")]
    module = ONNModule(cols, cols, tf.FeatureSchema.build(cols), E, dnn_hidden_units=(8,))
    for name, p in module.named_parameters():
        if name.startswith("second_order"):
            with torch.no_grad():
                p.copy_(torch.from_numpy(_rand(16, *p.shape)))
    ids = torch.from_numpy(np.random.default_rng(17).integers(0, 12, (B, F_)))
    got = module.second_order({"sparse": ids})
    want = []
    for i in range(F_ - 1):
        for j in range(i + 1, F_):
            e1 = getattr(module, f"second_order_emb1_f{i}")[ids[:, i]]
            e2 = getattr(module, f"second_order_emb2_f{j}")[ids[:, j]]
            want.append(e1[:, (j - i - 1) * E:(j - i) * E] * e2[:, i * E:(i + 1) * E])
    want = torch.cat(want, dim=1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    w = torch.from_numpy(_rand(18, *got.shape))
    grads = [torch.autograd.grad((t * w).sum(), [p for n, p in module.named_parameters()
                                                 if n.startswith("second_order")])
             for t in (got, want)]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **TOL)
    names = sorted(n for n, _ in module.named_parameters() if n.startswith("second_order"))
    assert names == sorted([f"second_order_emb1_f{k}" for k in range(F_ - 1)]
                           + [f"second_order_emb2_f{k}" for k in range(1, F_)])
