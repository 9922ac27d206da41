"""PyTorch port, the reference-named API surface: every symbol of
``tests/test_api_surface.py``'s ``REFERENCE_PUBLIC_SYMBOLS`` resolves in the
port's counterpart modules, ``build_input_features`` gives the JAX package's
slice map, and the ``inputs.py``-named lookup wrappers give the JAX
wrappers' values from the same table, from the table and from a lazy split
step's occurrence block alike."""

import importlib
from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_api_surface import MODULES, REFERENCE_PUBLIC_SYMBOLS

import xdeepfm_tpu.embeddings as je
import xdeepfm_tpu.features as jf
import xdeepfm_tpu_torch.embeddings as te
import xdeepfm_tpu_torch.features as tf
import xdeepfm_tpu_torch.nn as tnn

PORT_MODULES = [m.replace("xdeepfm_tpu", "xdeepfm_tpu_torch", 1) for m in MODULES]
B = 6


def test_reference_surface_covered_by_port():
    mods = [importlib.import_module(m) for m in PORT_MODULES]
    missing = [n for n in REFERENCE_PUBLIC_SYMBOLS if not any(hasattr(m, n) for m in mods)]
    assert not missing, f"reference symbols without a counterpart in the port: {missing}"


def test_identity_and_activation_layer():
    x = torch.randn(3, 4)
    assert torch.equal(tnn.Identity()(x), x)
    assert tnn.activation_layer is tnn.make_activation
    assert torch.equal(tnn.activation_layer("relu")(x), torch.relu(x))
    assert isinstance(tnn.activation_layer("dice", hidden_size=4), tnn.Dice)


def _surface_cols(mod):
    """``tests/test_api_surface.py:67-76``'s columns, the duplicate included."""
    return [
        mod.SparseFeat("C0", 10, 4),
        mod.DenseFeat("I0", 2),
        mod.VarLenSparseFeat(mod.SparseFeat("h", 10, 4), maxlen=3, combiner="mean",
                             length_name="hl"),
        mod.SparseFeat("C0", 10, 4),
    ]


def _varlen_no_length(mod):
    """A varlen column without a length column between two others."""
    return [
        mod.DenseFeat("I0", 3),
        mod.VarLenSparseFeat(mod.SparseFeat("s", 7, 4), maxlen=5, combiner="sum"),
        mod.SparseFeat("C1", 9, 4),
        mod.VarLenSparseFeat(mod.SparseFeat("t", 7, 4), maxlen=2, length_name="tl"),
    ]


@pytest.mark.parametrize("cols", [_surface_cols, _varlen_no_length])
def test_build_input_features_matches_jax(cols):
    got = tf.build_input_features(cols(tf))
    want = jf.build_input_features(cols(jf))
    assert list(got.items()) == list(want.items())


def test_build_input_features_rejects_other_columns():
    for mod in (jf, tf):
        with pytest.raises(TypeError, match="Invalid feature column type"):
            mod.build_input_features([mod.SparseFeat("C0", 10, 4), SimpleNamespace(name="C1")])


def _lookup_cols(mod):
    """Two groups of sparse fields (one sharing C0's table), two dense
    fields, a varlen field with a length column and one pooled over its
    nonzero ids."""
    return [
        mod.SparseFeat("C0", 10, 4, group_name="user"),
        mod.SparseFeat("C1", 12, 4),
        mod.SparseFeat("C2", 10, 4, embedding_name="C0", group_name="user"),
        mod.DenseFeat("I0", 2),
        mod.DenseFeat("I1", 1),
        mod.VarLenSparseFeat(mod.SparseFeat("h", 10, 4, embedding_name="C0"), maxlen=3,
                             combiner="mean", length_name="hl"),
        mod.VarLenSparseFeat(mod.SparseFeat("s", 8, 4), maxlen=4, combiner="sum"),
    ]


def _batch(rng):
    return {
        "sparse": rng.integers(0, 10, (B, 3)).astype(np.int32),
        "dense": rng.uniform(0, 1, (B, 3)).astype(np.float32),
        "vl_h": rng.integers(0, 10, (B, 3)).astype(np.int32),
        "len_hl": rng.integers(1, 4, (B, 1)).astype(np.int32),
        "vl_s": (rng.integers(0, 8, (B, 4)) * (rng.uniform(size=(B, 4)) < 0.6)).astype(np.int32),
    }


def _jax_lookups(batch):
    """Every wrapper of the JAX package over its own collection, and the
    collection's table."""
    cols = _lookup_cols(jf)
    sp = [f for f in cols if isinstance(f, jf.SparseFeat)]
    vl = [f for f in cols if isinstance(f, jf.VarLenSparseFeat)]

    class Wrap(fnn.Module):
        def setup(self):
            self.emb = je.create_embedding_matrix(cols)

        def __call__(self, b):
            return dict(
                groups=je.embedding_lookup(b, self.emb, sp),
                listed=je.embedding_lookup(b, self.emb, sp, to_list=True),
                only=je.embedding_lookup(b, self.emb, sp, return_feat_list=("C2", "C1")),
                seq=je.varlen_embedding_lookup(b, self.emb, vl),
                pooled=je.get_varlen_pooling_list(b, self.emb, vl),
            )

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = Wrap().init(jax.random.PRNGKey(0), jbatch)
    out = Wrap().apply(variables, jbatch)
    return jax.tree.map(np.asarray, out), np.asarray(variables["params"]["emb"]["table_d4"])


def _port_lookups(batch, emb):
    cols = _lookup_cols(tf)
    sp = [f for f in cols if isinstance(f, tf.SparseFeat)]
    vl = [f for f in cols if isinstance(f, tf.VarLenSparseFeat)]
    out = dict(
        groups=te.embedding_lookup(batch, emb, sp),
        listed=te.embedding_lookup(batch, emb, sp, to_list=True),
        only=te.embedding_lookup(batch, emb, sp, return_feat_list=("C2", "C1")),
        seq=te.varlen_embedding_lookup(batch, emb, vl),
        pooled=te.get_varlen_pooling_list(batch, emb, vl),
    )
    return jax.tree.map(lambda t: t.detach().numpy(), out)


@pytest.mark.parametrize("source", ["table", "occurrence_block"])
def test_lookup_wrappers_match_jax(source, rng):
    """``embedding_lookup`` as groups, as a list and filtered,
    ``varlen_embedding_lookup`` and ``get_varlen_pooling_list`` (a length
    column and a nonzero-id mask) from the JAX collection's table; the
    occurrence block that a lazy split step hands the collection gives the
    same values."""
    batch = _batch(rng)
    want, table = _jax_lookups(batch)
    emb = te.create_embedding_matrix(_lookup_cols(tf), device="cpu")
    assert sorted(n for n, _ in emb.named_parameters()) == ["table_d4"]
    with torch.no_grad():
        emb.table_d4.copy_(torch.from_numpy(table.copy()))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if source == "occurrence_block":
        emb.path = "embedding_dict"
        (entries,) = te.table_touched_spec(emb.feature_columns, emb.schema, False).values()
        block = emb.table_d4.detach().index_select(0, te.touched_ids(tbatch, entries))
        tbatch["_compact"] = {"embedding_dict/table_d4": block}
    got = _port_lookups(tbatch, emb)
    assert list(got["groups"]) == list(want["groups"]) == ["default_group", "user"]
    assert list(got["seq"]) == ["h", "s"]
    # the list runs over the groups in their first appearance: C0, C2, then C1
    assert len(got["listed"]) == 3 and got["listed"][0].shape == (B, 1, 4)
    np.testing.assert_array_equal(got["listed"][1], got["groups"]["user"][1])
    assert [len(g) for g in got["only"].values()] == [1, 1]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_dense_input_and_maxlen_lookup_match_jax(rng):
    batch = _batch(rng)
    jcols, tcols = _lookup_cols(jf), _lookup_cols(tf)
    want = je.get_dense_input({k: jnp.asarray(v) for k, v in batch.items()},
                              jf.FeatureSchema.build(jcols), jcols)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = te.get_dense_input(tbatch, tf.FeatureSchema.build(tcols), tcols)
    assert [g.shape for g in got] == [(B, 2), (B, 1)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(te.maxlen_lookup(tbatch, ["hl"]).numpy(),
                                  np.asarray(je.maxlen_lookup(batch, ["hl"])))
    for empty in (None, []):
        for mod in (je, te):
            with pytest.raises(ValueError, match="please add max length column"):
                mod.maxlen_lookup(batch, empty)


def test_create_embedding_matrix_linear_and_device():
    """``linear=True`` makes every table dim 1, as the JAX one; the tables
    are built on the card unless the caller asks for the CPU."""
    cols = _lookup_cols(tf)
    emb = te.create_embedding_matrix(cols, init_std=0.5, linear=True, device="cpu")
    assert {n: tuple(p.shape) for n, p in emb.named_parameters()} == {"table_d1": (30, 1)}
    assert 0.3 < float(emb.table_d1.detach().std()) < 0.7
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            te.create_embedding_matrix(cols)
