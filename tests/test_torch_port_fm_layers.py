"""PyTorch port, FM-family slice: the layers ``BiInteractionPooling``,
``AFMLayer``, ``CrossNet`` and ``CrossNetMix`` and the mixed-dim input path
(``EmbeddingCollection.embed_inputs`` / ``fast_inputs``) against the JAX
package; the models are in ``tests/test_torch_port_fm_models.py``.

Inputs are numpy draws from a seed and go to both sides; each JAX layer is
initialised by flax and its parameters carried to the port with
``from_jax_weights``.  Both sides run fp32 on the CPU at B 8, F 5, E 4 (AFM
attention factor 4, DCN-Mix low rank 4 with 2 experts).

Tolerances: outputs and the gradients of sum(sin(out)) with respect to the
inputs and every parameter within rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xdeepfm_tpu.features as jf
import xdeepfm_tpu_torch.features as tf
from xdeepfm_tpu.embeddings import EmbeddingCollection as JaxEmbeddingCollection
from xdeepfm_tpu.nn import interaction as jint
from xdeepfm_tpu_torch.embeddings import EmbeddingCollection, MixedEmbeddingDims
from xdeepfm_tpu_torch.nn import AFMLayer, BiInteractionPooling, CrossNet, CrossNetMix
from xdeepfm_tpu_torch.weights import from_jax_weights

TOL = dict(rtol=1e-5, atol=1e-6)
B, F_, E = 8, 5, 4


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _check_layer(jlayer, layer, x, **call):
    """The JAX layer's flax init carried into ``layer``; then the outputs
    and the gradients of sum(sin(out)) by ``jax.grad`` and by autograd."""
    variables = jlayer.init(jax.random.PRNGKey(3), jnp.asarray(x), **call)
    params = variables.get("params", {})
    layer.load_state_dict(from_jax_weights({"params": params}), strict=True)

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
    assert sorted(dict(layer.named_parameters())) == sorted(want_gp)
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(_np(p.grad), _np(want_gp[name]), err_msg=name, **TOL)
    assert float(np.abs(_np(want)).max()) > 1e-3


def test_bi_interaction_pooling_matches_jax():
    x = np.random.default_rng(0).normal(size=(B, F_, E)).astype(np.float32)
    _check_layer(jint.BiInteractionPooling(), BiInteractionPooling(), x)


@pytest.mark.parametrize("training", [False, True])
def test_afm_layer_matches_jax(training):
    """At dropout 0 the training flag changes nothing; the pairs come in
    ``_pair_indices`` order, the softmax runs over them."""
    x = np.random.default_rng(1).normal(size=(B, F_, E)).astype(np.float32)
    _check_layer(jint.AFMLayer(in_features=E, attention_factor=4),
                 AFMLayer(E, attention_factor=4), x, training=training)


def test_afm_layer_dropout_draws_from_the_generator():
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(B, F_, E)).astype(np.float32))
    layer = AFMLayer(E, attention_factor=4, dropout_rate=0.5)
    runs = [layer(x, training=True, generator=torch.Generator().manual_seed(s))
            for s in (7, 7, 8)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])
    torch.testing.assert_close(layer(x), layer(x, training=False))


@pytest.mark.parametrize("parameterization", ["vector", "matrix"])
def test_crossnet_matches_jax(parameterization):
    """``kernels`` [L, d, 1] / [L, d, d] cross ``from_jax_weights``
    untransposed (a non-symmetric [d, d] shows it).  Inputs at scale 0.3:
    at unit scale the outputs reach ~26, where sin's fp32 rounding alone
    puts both sides ~5e-5 off a float64 run."""
    d = F_ * E
    x = (0.3 * np.random.default_rng(3).normal(size=(B, d))).astype(np.float32)
    _check_layer(jint.CrossNet(in_features=d, layer_num=2, parameterization=parameterization),
                 CrossNet(d, layer_num=2, parameterization=parameterization), x)


def test_crossnet_rejects_another_parameterization():
    with pytest.raises(ValueError, match="parameterization should be 'vector' or 'matrix'"):
        CrossNet(8, parameterization="diagonal")


def test_crossnet_mix_matches_jax():
    d = F_ * E
    x = (0.3 * np.random.default_rng(4).normal(size=(B, d))).astype(np.float32)
    _check_layer(jint.CrossNetMix(in_features=d, low_rank=4, num_experts=2, layer_num=2),
                 CrossNetMix(d, low_rank=4, num_experts=2, layer_num=2), x)


def test_init_distributions_match_the_jax_layers():
    """At DCN-Mix's default widths (d = 26 x 10 + 13 = 273, low rank 32, 4
    experts, 2 layers): each [K, a, b] slice of U, V and C within 10% of
    sqrt(2 / (a*b + K*b)) (per-expert glorot would be 4-5.5x that), the gate
    uniform within 1/sqrt(d); CrossNet's and AFM's glorot normals within
    10% of sqrt(2 / (fan_in + fan_out)) and truncated at two of them."""
    d, r, K = 273, 32, 4
    mix = CrossNetMix(d, low_rank=r, num_experts=K, layer_num=2,
                      generator=torch.Generator().manual_seed(0))
    for name, (a, b) in (("U_list", (d, r)), ("V_list", (d, r)), ("C_list", (r, r))):
        p = getattr(mix, name).detach()
        assert tuple(p.shape) == (2, K, a, b)
        want = np.sqrt(2.0 / (a * b + K * b))
        for layer in p:
            assert abs(float(layer.std()) / want - 1) < 0.1, name
    assert tuple(mix.gating.shape) == (K, d, 1)
    assert float(mix.gating.detach().abs().max()) <= 1 / np.sqrt(d)
    assert float(mix.gating.detach().std()) > 0.5 / np.sqrt(3 * d)
    assert not mix.bias.any() and tuple(mix.bias.shape) == (2, d, 1)
    for param in ("vector", "matrix"):
        cn = CrossNet(d, layer_num=2, parameterization=param,
                      generator=torch.Generator().manual_seed(1))
        fan_out = 1 if param == "vector" else d
        std = np.sqrt(2.0 / (d + fan_out))
        assert abs(float(cn.kernels.detach().std()) / std - 1) < 0.1
        assert float(cn.kernels.detach().abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    afm = AFMLayer(10, attention_factor=8, generator=torch.Generator().manual_seed(2))
    big = AFMLayer(300, attention_factor=200, generator=torch.Generator().manual_seed(2))
    assert abs(float(big.attention_W.detach().std()) / np.sqrt(2.0 / 500) - 1) < 0.1
    assert tuple(afm.attention_W.shape) == (10, 8) and not afm.attention_b.any()
    assert tuple(afm.projection_h.shape) == (8, 1) and tuple(afm.projection_p.shape) == (10, 1)


# ----------------------------------------------------------- mixed-dim inputs


def _mixed_cols(mod, varlen_dim=6):
    """Sparse features of dims 4 and 6, a varlen one on a's table (dim 4)
    and one on its own (``varlen_dim``), two dense."""
    return (
        mod.SparseFeat("a", 9, 4),
        mod.SparseFeat("b", 11, 6),
        mod.DenseFeat("d", 2),
        mod.VarLenSparseFeat(mod.SparseFeat("h", 9, 4, embedding_name="a"), maxlen=3),
        mod.VarLenSparseFeat(mod.SparseFeat("g", 7, varlen_dim), maxlen=4, combiner="sum",
                             length_name="g_len"),
        mod.SparseFeat("c", 5, 4),
    )


def _mixed_batch(rng, n=B):
    return {
        "sparse": rng.integers(0, 5, (n, 3)).astype(np.int32),
        "dense": rng.uniform(0, 1, (n, 2)).astype(np.float32),
        "vl_h": rng.integers(0, 9, (n, 3)).astype(np.int32),
        "vl_g": rng.integers(0, 7, (n, 4)).astype(np.int32),
        "len_g_len": rng.integers(1, 5, (n, 1)).astype(np.int32),
    }


def _emb_pair(cols_j, cols_t, batch):
    """(JAX collection, its variables, port collection with its tables)."""
    jemb = JaxEmbeddingCollection(feature_columns=cols_j, schema=jf.FeatureSchema.build(cols_j))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jemb.init(jax.random.PRNGKey(0), jb, method=jemb.embed_inputs)
    temb = EmbeddingCollection(cols_t, tf.FeatureSchema.build(cols_t))
    temb.load_state_dict(from_jax_weights({"params": variables["params"]}), strict=True)
    return jemb, variables, temb


@pytest.mark.parametrize("method", ["embed_inputs", "fast_inputs"])
def test_mixed_dim_inputs_match_jax(method):
    """Mixed dims (sparse 4 and 6, varlen 4 and 6, dense): both methods give
    the JAX lists (sparse in column order, then pooled varlen, then dense),
    and the tables' gradients of a weighted sum of them match ``jax.grad``."""
    rng = np.random.default_rng(5)
    batch = _mixed_batch(rng)
    jemb, variables, temb = _emb_pair(_mixed_cols(jf), _mixed_cols(tf), batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jsl, jdl = jemb.apply(variables, jb, method=getattr(jemb, method))
    tsl, tdl = getattr(temb, method)(tb)
    assert [tuple(t.shape) for t in tsl] == [tuple(j.shape) for j in jsl]
    assert [tuple(t.shape) for t in tsl] == [(B, 1, 4), (B, 1, 6), (B, 1, 4), (B, 1, 4),
                                            (B, 1, 6)]
    for t, j in zip(tsl + tdl, list(jsl) + list(jdl)):
        np.testing.assert_allclose(_np(t), _np(j), **TOL)
    wts = [rng.normal(size=t.shape).astype(np.float32) for t in tsl]

    def jloss(p):
        sl, _ = jemb.apply({"params": p}, jb, method=getattr(jemb, method))
        return sum(jnp.sum(jnp.sin(s * w)) for s, w in zip(sl, wts))

    want = jax.grad(jloss)(variables["params"])
    sum(torch.sin(s * torch.from_numpy(w)).sum() for s, w in zip(tsl, wts)).backward()
    for name, p in temb.named_parameters():
        np.testing.assert_allclose(_np(p.grad), _np(want[name]), err_msg=name, **TOL)


def test_fast_inputs_mixed_dims_falls_back():
    """The counterpart of ``tests/test_embeddings.py:137``: mixed sparse dims
    route through the per-feature lists, entry by entry."""
    rng = np.random.default_rng(4)
    cols = (tf.SparseFeat("a", 9, 4), tf.SparseFeat("b", 11, 6))
    emb = EmbeddingCollection(cols, tf.FeatureSchema.build(cols))
    batch = {"sparse": torch.from_numpy(rng.integers(0, 9, (5, 2)))}
    with pytest.raises(MixedEmbeddingDims):
        emb.stacked_inputs(batch)
    sl, _ = emb.embed_inputs(batch)
    fl, _ = emb.fast_inputs(batch)
    assert len(fl) == len(sl) == 2
    for a, b in zip(fl, sl):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fast_inputs_uniform_dims_stack_into_one_entry():
    """Uniform dims (sparse, varlen and dense): one stacked entry, equal to
    the per-feature lists concatenated."""
    rng = np.random.default_rng(6)
    batch = {k: torch.from_numpy(v) for k, v in _mixed_batch(rng).items()}
    cols = tuple(f for f in _mixed_cols(tf, varlen_dim=4) if f.name != "b")
    emb = EmbeddingCollection(cols, tf.FeatureSchema.build(_mixed_cols(tf, varlen_dim=4)))
    sl, dl = emb.embed_inputs(batch)
    (stack,), (dense,) = emb.fast_inputs(batch)
    torch.testing.assert_close(stack, torch.cat(sl, dim=1), rtol=0, atol=0)
    torch.testing.assert_close(dense, torch.cat(dl, dim=-1), rtol=0, atol=0)


def test_stacked_inputs_checks_the_varlen_dims():
    """Equal sparse dims but a varlen feature of another: the JAX
    ``MixedEmbeddingDims`` (a ``ValueError``), not a failed concatenation;
    ``fast_inputs`` falls back to the lists."""
    rng = np.random.default_rng(7)
    batch = {k: torch.from_numpy(v) for k, v in _mixed_batch(rng).items()}
    all_cols = _mixed_cols(tf)
    cols = tuple(f for f in all_cols if f.name != "b")
    emb = EmbeddingCollection(cols, tf.FeatureSchema.build(all_cols))
    with pytest.raises(MixedEmbeddingDims, match="uniform embedding dim"):
        emb.stacked_inputs(batch)
    assert issubclass(MixedEmbeddingDims, ValueError)
    sl, dl = emb.fast_inputs(batch)
    assert [tuple(t.shape) for t in sl] == [(B, 1, 4), (B, 1, 4), (B, 1, 4), (B, 1, 6)]
    assert len(dl) == 1
    # the JAX collection raises the same for the same features
    jcols = tuple(f for f in _mixed_cols(jf) if f.name != "b")
    jemb = JaxEmbeddingCollection(feature_columns=jcols,
                                  schema=jf.FeatureSchema.build(_mixed_cols(jf)))
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    variables = jemb.init(jax.random.PRNGKey(0), jb, method=jemb.embed_inputs)
    with pytest.raises(ValueError, match="uniform embedding dim"):
        jemb.apply(variables, jb, method=jemb.stacked_inputs)


def test_support_dense_false_rejects_dense_features():
    cols = _mixed_cols(tf)
    emb = EmbeddingCollection(cols, tf.FeatureSchema.build(cols))
    batch = {k: torch.from_numpy(v) for k, v in _mixed_batch(np.random.default_rng(8)).items()}
    for method in (emb.embed_inputs, emb.fast_inputs):
        with pytest.raises(ValueError, match="DenseFeat is not supported"):
            method(batch, support_dense=False)
