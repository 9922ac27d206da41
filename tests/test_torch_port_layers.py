"""PyTorch port: activations, DNN, PredictionLayer, the schema helpers and
the embedding table layout against the JAX package.

Inputs and parameters are seeded numpy arrays handed to both sides; both are
fp32 on the CPU and do the same few operations, hence rtol = atol = 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xdeepfm_tpu.features as jf
import xdeepfm_tpu_torch.features as tf
from xdeepfm_tpu.embeddings import _table_layout as jax_table_layout
from xdeepfm_tpu.nn import activations as ja
from xdeepfm_tpu.nn.core import DNN as JaxDNN
from xdeepfm_tpu.nn.core import PredictionLayer as JaxPredictionLayer
from xdeepfm_tpu_torch.embeddings import _table_layout
from xdeepfm_tpu_torch.nn import activations as ta
from xdeepfm_tpu_torch.nn.core import DNN, PredictionLayer
from xdeepfm_tpu_torch.weights import flatten_tree, from_jax_weights

TOL = dict(rtol=1e-6, atol=1e-6)


def _scaled_like(rng, tree, scale=0.3):
    return jax.tree.map(
        lambda v: (scale * rng.standard_normal(np.shape(v))).astype(np.float32), tree
    )


@pytest.mark.parametrize("name", ["sigmoid", "linear", "relu", "tanh", "leakyrelu", "prelu"])
def test_activation_matches_jax(rng, name):
    x = rng.normal(size=(7, 5)).astype(np.float32)
    jact = ja.make_activation(name, 5)
    if isinstance(jact, ja.PReLU):
        want = jact.apply(jact.init(jax.random.PRNGKey(0), jnp.asarray(x)), jnp.asarray(x))
    else:
        want = jact(jnp.asarray(x))
    got = ta.apply_activation(ta.make_activation(name, 5), torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("activation", ["relu", "prelu"])
def test_dnn_eval_matches_jax(rng, activation):
    x = rng.normal(size=(9, 6)).astype(np.float32)
    jdnn = JaxDNN(6, (8, 4), activation=activation)
    params = _scaled_like(rng, dict(jdnn.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]))
    want = jdnn.apply({"params": params}, jnp.asarray(x))
    port = DNN(6, (8, 4), activation=activation)
    port.load_state_dict(from_jax_weights({"params": params, "batch_stats": {}}))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dnn_train_mode_dropout_draws_from_the_generator(rng):
    x = torch.from_numpy(rng.normal(size=(64, 6)).astype(np.float32))
    port = DNN(6, (32,), dropout_rate=0.5, init_std=0.5)
    with torch.no_grad():
        ref = port(x)
        a = port(x, training=True, generator=torch.Generator().manual_seed(3))
        b = port(x, training=True, generator=torch.Generator().manual_seed(3))
        no_drop = DNN(6, (32,), init_std=0.5)(x, training=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(no_drop, ref, rtol=0, atol=0)  # same seed, rate 0
    kept = a != 0
    torch.testing.assert_close(a[kept], 2 * ref[kept])  # scaled by 1 / (1 - rate)
    live = ref != 0
    dropped = (live & ~kept).sum().item() / live.sum().item()
    assert 0.35 < dropped < 0.65


@pytest.mark.parametrize("activation", ["relu", "dice"])
def test_dnn_use_bn_matches_flax(rng, activation):
    """``DNN(use_bn=True)`` (ROADMAP item 12b; it raised before): ``bn_{i}``
    after each ``linear_{i}``, Dice at dim 2 with its own ``bn``.  Random
    weights and running statistics from the JAX tree; the evaluation
    forward (the running values), then the training forward (the batch
    statistics) and its updated ``batch_stats``, within 1e-5 (sums over the
    batch in two orders)."""
    x = rng.normal(size=(9, 6)).astype(np.float32)
    jdnn = JaxDNN(6, (8, 4), activation=activation, use_bn=True, dice_dim=2)
    variables = jdnn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = _scaled_like(rng, dict(variables["params"]))
    stats = jax.tree.map(lambda v: rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32),
                         dict(variables["batch_stats"]))
    port = DNN(6, (8, 4), activation=activation, use_bn=True, dice_dim=2)
    port.load_state_dict(from_jax_weights({"params": params, "batch_stats": stats}))
    want = jdnn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        got = port(torch.from_numpy(x), training=True)
    want, mutated = jdnn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                               training=True, mutable=["batch_stats"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    buffers = dict(port.named_buffers())
    leaves = list(flatten_tree(jax.tree.map(np.asarray, mutated["batch_stats"])))
    assert sorted(buffers) == sorted(p.replace("/", ".") for p, _ in leaves)
    for path, v in leaves:
        np.testing.assert_allclose(buffers[path.replace("/", ".")].numpy(), v, rtol=1e-5,
                                   atol=1e-5, err_msg=path)


@pytest.mark.parametrize("task", ["binary", "regression"])
def test_prediction_layer_matches_jax(rng, task):
    x = rng.normal(size=(5, 1)).astype(np.float32)
    bias = np.array([0.7], np.float32)
    want = JaxPredictionLayer(task=task).apply(
        {"params": {"global_bias": jnp.asarray(bias)}}, jnp.asarray(x)
    )
    port = PredictionLayer(task=task)
    port.load_state_dict({"global_bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _columns(mod):
    """Shared embedding names, a varlen column with a length name, a dense
    column of width 3 and a repeated feature name."""
    return [
        mod.SparseFeat("a", 20, 4),
        mod.SparseFeat("b", 30, 4, embedding_name="a"),
        mod.SparseFeat("c", 15, 6),
        mod.DenseFeat("d", 3),
        mod.VarLenSparseFeat(
            mod.SparseFeat("seq", 40, 4, embedding_name="s"), maxlen=5, length_name="seq_len"
        ),
        mod.SparseFeat("e", 25, 4),
        mod.SparseFeat("a", 20, 4),
    ]


def test_schema_helpers_match_jax():
    cols_t, cols_j = _columns(tf), _columns(jf)
    assert tf.get_feature_names(cols_t) == jf.get_feature_names(cols_j)
    for kw in ({}, dict(include_sparse=False), dict(include_dense=False), dict(feature_group=True)):
        assert tf.compute_input_dim(cols_t, **kw) == jf.compute_input_dim(cols_j, **kw), kw
    assert [[f.name for f in part] for part in tf.split_columns(cols_t)] == [
        [f.name for f in part] for part in jf.split_columns(cols_j)
    ]
    st, sj = tf.FeatureSchema.build(cols_t), jf.FeatureSchema.build(cols_j)
    assert st.feature_names() == sj.feature_names()
    assert (st.n_sparse, st.dense_dim) == (sj.n_sparse, sj.dense_dim)
    assert [st.sparse_index(f.name) for f in st.sparse] == [sj.sparse_index(f.name) for f in sj.sparse]
    assert st.dense_slice("d") == sj.dense_slice("d")


@pytest.mark.parametrize("linear", [False, True])
def test_table_layout_matches_jax(linear):
    """Offsets follow each embedding name's first appearance; shared names
    share rows."""
    got = _table_layout(_columns(tf), linear)
    assert got == jax_table_layout(_columns(jf), linear)
    offsets, _ = got
    assert "b" not in offsets and offsets["a"][1] == 0
