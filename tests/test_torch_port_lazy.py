"""PyTorch port, the lazy row-sparse embedding optimizer against the JAX
package's (``xdeepfm_tpu/optimizers.py`` and the lazy branches of
``xdeepfm_tpu/basemodel.py``).

The other model families and DIEN are in
``tests/test_torch_port_lazy_models.py``.  Both sides run fp32 on the CPU
on the same seeded numpy inputs.  The JAX model gets seeded weights at
scale 0.1 and is compiled lazy after them, so its tracked L2 value starts
from them; the port receives the same weights through ``set_weights``.
Tolerances, each stated where it is used:

* row math: rtol 1e-6 (the same fp32 expression; the bias corrections' pow
  may differ by an ulp);
* run sums: the port sums each run on its own, the JAX package differences
  an fp32 prefix sum over the whole array; both within the prefix
  differencing's own error of float64 (a few eps times the largest prefix);
* ``fit``: ``tests/test_torch_port_train.py``'s Adam tolerances (rtol 1e-4,
  atol 2e-5 on the weights; histories rtol 1e-4): Adam's first steps move
  every touched entry by about lr whatever its gradient's size, so fp32
  noise in a near-zero gradient moves a weight by up to lr.  The row states
  likewise: m and v, or Adagrad's accumulator, within rtol 1e-3 and an atol
  of 1e-4 of the state's largest entry (v of a near-zero gradient is noise
  squared); a bf16 state within one bf16 step, 2^-7 relative.
"""

import jax
import numpy as np
import pytest
import torch

import xdeepfm_tpu.basemodel as jbm
import xdeepfm_tpu.embeddings as jemb
import xdeepfm_tpu.features as jf
import xdeepfm_tpu.optimizers as jopt
import xdeepfm_tpu_torch.basemodel as tbm
import xdeepfm_tpu_torch.embeddings as temb
import xdeepfm_tpu_torch.features as tf
import xdeepfm_tpu_torch.optimizers as topt
from xdeepfm_tpu.models import xDeepFM as JaxXDeepFM
from xdeepfm_tpu_torch.models import xDeepFM
from xdeepfm_tpu_torch.weights import flatten_tree

N_SPARSE, VOCAB, DIM, N_DENSE = 4, 40, 6, 2
ARCH = dict(dnn_hidden_units=(16,), cin_layer_size=(8, 6))
FIT = dict(batch_size=64, epochs=2, verbose=0, shuffle=False)
W_RTOL, W_ATOL = 1e-4, 2e-5  # OPT_TOL["adam"] of tests/test_torch_port_train.py

# (embedding_gradient, embedding_layout, embedding_state_dtype)
MODES = {
    "split_flat": dict(embedding_gradient="split", embedding_layout="flat"),
    "split_packed": dict(embedding_gradient="split", embedding_layout="packed"),
    "dense_cotangent": dict(embedding_gradient="dense"),
    "packed_bf16": dict(embedding_gradient="split", embedding_state_dtype="bfloat16"),
}


def _cols(mod, extra=()):
    return [mod.SparseFeat(f"C{i}", VOCAB, DIM) for i in range(N_SPARSE)] + [
        mod.DenseFeat(f"I{i}") for i in range(N_DENSE)] + list(extra)


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    # ids from a part of the vocabulary: some rows are never touched
    x = {f"C{i}": rng.integers(0, VOCAB * 3 // 4, n) for i in range(N_SPARSE)}
    x.update({f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(N_DENSE)})
    return x, (rng.uniform(size=n) < 0.4).astype(np.float32)


def _seeded(jm, scale=0.1):
    rng = np.random.default_rng(1)
    w = jm.get_weights()
    w["params"] = jax.tree.map(
        lambda v: (scale * rng.standard_normal(np.shape(v))).astype(np.float32), w["params"])
    return w


def _pair(jax_cls, port_cls, jargs, targs, optimizer, mode, scale=0.1, **model_kw):
    """(JAX model, port model), the same seeded weights, both compiled lazy
    under ``mode``."""
    jm = jax_cls(*jargs, **model_kw)
    jm.compile(optimizer, "binary_crossentropy")
    w = _seeded(jm, scale)
    jm.set_weights(w)
    jm.compile(optimizer, "binary_crossentropy", metrics=["binary_crossentropy"],
               embedding_optimizer="lazy", **MODES[mode])
    pm = port_cls(*targs, device="cpu", **model_kw)
    pm.set_weights(w)
    pm.compile(optimizer, "binary_crossentropy", metrics=["binary_crossentropy"],
               embedding_optimizer="lazy", **MODES[mode])
    return jm, pm


def _xdeepfm_pair(optimizer, mode, **kw):
    return _pair(JaxXDeepFM, xDeepFM, (_cols(jf), _cols(jf)), (_cols(tf), _cols(tf)), optimizer,
                 mode, **ARCH, **kw)


def _assert_weights_close(pm, jm, rtol=W_RTOL, atol=W_ATOL):
    want = dict(flatten_tree(jm.get_weights()["params"]))
    got = dict(flatten_tree(pm.get_weights()["params"]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol, atol=atol, err_msg=k)


def _jax_lazy_state(jm):
    return {k: np.asarray(v) for k, v in jm._canonical_opt_state()["lazy"].items()}


def _assert_states_close(pm, jm, rtol=1e-3):
    want = _jax_lazy_state(jm)
    got = {k: v.numpy() for k, v in pm._lazy_state().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                   atol=1e-4 * np.abs(want[k]).max(), err_msg=k)


# ---------------------------------------------------------------- row math


@pytest.mark.parametrize("kind", ["adam", "adagrad"])
def test_row_math_matches_jax(kind):
    rng = np.random.default_rng(2)
    n, d = 33, 5
    _, k = topt.LAZY_ROW_MATH[kind]
    p, g = (rng.normal(size=(n, d)).astype(np.float32) for _ in range(2))
    st = np.abs(rng.normal(size=(n, k * d))).astype(np.float32)
    for t in (1, 2, 37):
        want = jopt.LAZY_ROW_MATH[kind][0](*map(jax.numpy.asarray, (p, st, g)),
                                           jax.numpy.asarray(t, jax.numpy.int32))
        got = topt.LAZY_ROW_MATH[kind][0](*map(torch.from_numpy, (p, st, g)), t)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    assert topt.LAZY_ROW_MATH[kind][1] == jopt.LAZY_ROW_MATH[kind][1]
    assert topt.LAZY_OPTIMIZERS[kind][2] == jopt.LAZY_OPTIMIZERS[kind][2]


@pytest.mark.parametrize("kind", ["adam", "adagrad"])
def test_lazy_rows_match_jax(kind):
    """``lazy_*_rows`` on a table with duplicate and out-of-range (padding)
    ids: the rows written, the state, the returned rows."""
    rng = np.random.default_rng(3)
    rows, d = 20, 4
    init, update, _ = topt.LAZY_OPTIMIZERS[kind]
    jinit, jupdate, _ = jopt.LAZY_OPTIMIZERS[kind]
    p = rng.normal(size=(rows, d)).astype(np.float32)
    ids = np.array([3, 7, 3, 19, 0, 7, 3, 20], np.int32)  # 20 is padding
    g_occ = rng.normal(size=(len(ids), d)).astype(np.float32)
    # every occurrence carries its id's total, as the contract says
    g = np.stack([g_occ[ids == i].sum(0) for i in ids]).astype(np.float32)
    jp, jst, jrows = jupdate(jax.numpy.asarray(p), jinit(jax.numpy.asarray(p)),
                             jax.numpy.asarray(ids), jax.numpy.asarray(g), jax.numpy.asarray(1))
    tp = torch.from_numpy(p.copy())
    tp_, tst, trows = update(tp, init(tp), torch.from_numpy(ids).long(), torch.from_numpy(g), 1)
    np.testing.assert_allclose(tp_.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), rtol=1e-6, atol=1e-7)
    valid = ids < rows
    np.testing.assert_allclose(trows.numpy()[valid], np.asarray(jrows)[valid], rtol=1e-6)
    untouched = np.setdiff1d(np.arange(rows), ids)
    np.testing.assert_array_equal(tp_.numpy()[untouched], p[untouched])


def test_segment_run_sums_match_jax_and_float64():
    rng = np.random.default_rng(4)
    n, d = 5000, 3
    ids = np.sort(rng.integers(0, 400, n))
    ids[2000:3500] = ids[2000]  # one long run, as a padding id's
    ids = np.sort(ids)
    vals = rng.normal(size=(n, d)).astype(np.float32)
    is_first = np.concatenate([[True], ids[1:] != ids[:-1]])
    want64 = np.stack([vals[ids == i].astype(np.float64).sum(0) for i in ids])
    jax_out = np.asarray(jopt.segment_run_sums(jax.numpy.asarray(vals),
                                               jax.numpy.asarray(is_first)))
    got = topt.segment_run_sums(torch.from_numpy(vals), torch.from_numpy(is_first)).numpy()
    # the JAX package's own error: a few eps of the largest |prefix sum|
    prefix_err = 8 * np.finfo(np.float32).eps * np.abs(np.cumsum(vals, 0, np.float64)).max()
    assert np.abs(jax_out - want64).max() <= prefix_err
    assert np.abs(got - want64).max() <= prefix_err
    np.testing.assert_allclose(got, jax_out, rtol=0, atol=2 * prefix_err)
    # each run summed on its own: within a few eps of its own size
    np.testing.assert_allclose(got, want64, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("width", [6, 7])
def test_bf16_codec_bit_equal_with_jax(width):
    rng = np.random.default_rng(5)
    st = (rng.normal(size=(9, width)) * 10.0 ** rng.integers(-8, 3, (9, width))).astype(np.float32)
    st[0, 0] = 0.0
    assert topt.state_slots(width, "bfloat16") == jopt.state_slots(width, jax.numpy.bfloat16)
    assert topt.state_slots(width, "float32") == jopt.state_slots(width, jax.numpy.float32)
    want = np.asarray(jopt.encode_state(jax.numpy.asarray(st), jax.numpy.bfloat16))
    got = topt.encode_state(torch.from_numpy(st), torch.bfloat16).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    back = topt.decode_state(torch.from_numpy(got), width, "bfloat16").numpy()
    jback = np.asarray(jopt.decode_state(jax.numpy.asarray(want), width, jax.numpy.bfloat16))
    np.testing.assert_array_equal(back, jback)
    # the round trip is bf16 rounding, and encoding it again changes no bit
    np.testing.assert_allclose(back, st, rtol=2 ** -8)
    again = topt.encode_state(torch.from_numpy(back), "bfloat16").numpy()
    np.testing.assert_array_equal(again.view(np.uint32), got.view(np.uint32))


# ------------------------------------------------------- touched rows


def _dien_cols(mod, with_neg=True):
    def hist(name):
        return mod.VarLenSparseFeat(mod.SparseFeat(name, 12, 4, embedding_name="item"),
                                    maxlen=6, length_name="seq_length")

    cols = [mod.SparseFeat("user", 12, 4), mod.SparseFeat("item", 12, 4),
            mod.DenseFeat("score", 1), hist("hist_item")]
    return cols + [hist("neg_hist_item")] if with_neg else cols


def _dien_data(n, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 7, n)
    pad = np.arange(6)[None, :] < lengths[:, None]
    x = {"user": rng.integers(0, 12, n), "item": rng.integers(0, 12, n),
         "score": rng.uniform(0, 1, n).astype(np.float32), "seq_length": lengths,
         "hist_item": rng.integers(1, 12, (n, 6)) * pad,
         "neg_hist_item": rng.integers(1, 12, (n, 6)) * pad}
    return x, (x["item"] % 2).astype(np.float32)


@pytest.mark.parametrize("case", ["xdeepfm", "duplicate", "linear", "dien"])
def test_touched_ids_match_jax(case):
    if case == "dien":
        jcols, tcols = _dien_cols(jf), _dien_cols(tf)
        x, _ = _dien_data(7)
    else:
        dup = case == "duplicate"
        jcols = _cols(jf, [jf.SparseFeat("C0", VOCAB, DIM)] if dup else [])
        tcols = _cols(tf, [tf.SparseFeat("C0", VOCAB, DIM)] if dup else [])
        x, _ = _data(7)
    linear = case == "linear"
    jschema, tschema = jf.FeatureSchema.build(jcols), tf.FeatureSchema.build(tcols)
    want = jemb.table_touched_spec(jcols, jschema, linear)
    got = temb.table_touched_spec(tcols, tschema, linear)
    assert got == {d: list(e) for d, e in want.items()}
    jb, tb = jschema.pack(x), {k: torch.as_tensor(v) for k, v in tschema.pack(x).items()}
    for dim, entries in want.items():
        np.testing.assert_array_equal(temb.touched_ids(tb, got[dim]).numpy(),
                                      np.asarray(jemb.touched_ids(jb, entries)))
    # the occurrence layout the lookups slice: each entry's place in the
    # touched ids, in units of B rows
    coll = temb.EmbeddingCollection(tcols, tschema, linear=linear)
    for dim, entries in got.items():
        lay, unit = coll._occ_layout[dim], 0
        for kind, key, _ in entries:
            if kind == "sparse":
                assert lay["sparse"][key] == unit
                unit += 1
        assert lay["n_sparse"] == unit
        for kind, key, _ in entries:
            if kind == "varlen":
                assert lay["varlen"][key] == unit
                unit += tb[key].shape[1]
        assert unit * 7 == len(temb.touched_ids(tb, entries))


def test_block_subset_keeps_a_non_finite_value_in_its_field():
    """A reordered or repeated lookup through the occurrence block takes
    rows, as the table lookup does: an inf in one field's row stays in that
    field and reaches no other."""
    cols, (x, _) = _cols(tf), _data(7)
    schema = tf.FeatureSchema.build(cols)
    coll = temb.EmbeddingCollection(cols, schema, init_std=0.1,
                                    generator=torch.Generator().manual_seed(0))
    coll.path = "embedding_dict"
    batch = {k: torch.as_tensor(v) for k, v in schema.pack(x).items()}
    ((dim, entries),) = temb.table_touched_spec(cols, schema, False).items()
    block = coll.table(dim).detach()[temb.touched_ids(batch, entries)].clone()
    n = len(entries)
    block[n * 2 + 1] = float("inf")  # sample 2, the second sparse field
    sp, _, _ = tf.split_columns(cols)
    got = coll.stacked_sparse(dict(batch, _compact={f"embedding_dict/table_d{dim}": block}),
                              [sp[1], sp[0], sp[1]])
    bad = ~torch.isfinite(got).all(-1)
    want = torch.zeros_like(bad)
    want[2, [0, 2]] = True
    assert torch.equal(bad, want) and torch.isinf(got[2, 0]).all()


@pytest.mark.parametrize("case", ["xdeepfm", "dien"])
def test_block_lookups_match_table_lookups(case):
    """Every lookup through a per-occurrence block gives the table lookup's
    values, and the block's gradient, summed over each id's occurrences, is
    the table's gradient: the subset, reorder and repeat of
    ``stacked_sparse`` (an index over the field axis), ``lookup_fields``' sparse and
    varlen slices, the pooled varlen fields."""
    if case == "dien":
        cols, (x, _) = _dien_cols(tf), _dien_data(7)
    else:
        cols, (x, _) = _cols(tf), _data(7)
    schema = tf.FeatureSchema.build(cols)
    coll = temb.EmbeddingCollection(cols, schema, init_std=0.1,
                                    generator=torch.Generator().manual_seed(0))
    coll.path = "embedding_dict"
    batch = {k: torch.as_tensor(v) for k, v in schema.pack(x).items()}
    ((dim, entries),) = temb.table_touched_spec(cols, schema, False).items()
    ids = temb.touched_ids(batch, entries)
    table = coll.table(dim)
    block = table.detach()[ids].requires_grad_()
    sp, _, vl = tf.split_columns(cols)
    lookups = [lambda b, f=f: coll.stacked_sparse(b, f)
               for f in (sp, sp[::-1], [sp[1], sp[0], sp[1]])]
    lookups += [lambda b: torch.cat([e.reshape(len(x["item" if vl else "C0"]), -1)
                                     for e in coll.lookup_fields(b, list(sp) + list(vl))], 1)]
    lookups += [lambda b, f=f: coll.lookup_varlen_pooled(b, f) for f in vl]
    lookups += [lambda b: coll.stacked_inputs(b)[0]]
    rng = np.random.default_rng(0)
    for lookup in lookups:
        want = lookup(batch)
        got = lookup(dict(batch, _compact={f"embedding_dict/table_d{dim}": block}))
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-6)
        w = torch.as_tensor(rng.normal(size=tuple(want.shape)).astype(np.float32))
        table.grad = block.grad = None
        (want * w).sum().backward()
        (got * w).sum().backward()
        np.testing.assert_allclose(temb.sorted_segment_sum(block.grad, ids, table.shape[0]).numpy(),
                                   table.grad.numpy(), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------- fit


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("optimizer", ["adam", "adagrad"])
def test_fit_matches_jax(optimizer, mode):
    jm, pm = _xdeepfm_pair(optimizer, mode, l2_reg_embedding=1e-3, l2_reg_linear=1e-3)
    packed = mode in ("split_packed", "packed_bf16")
    # packed: the main and linear tables in one group; else one table a group
    assert bool(pm._lazy["packed"]) == packed
    assert [len(g["members"]) for g in pm._lazy["groups"]] == ([2] if packed else [1, 1])
    x, y = _data(300)  # 4 batches of 64 and a tail of 44
    want = jm.fit(x, y, **FIT).history
    got = pm.fit(x, y, **FIT).history
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    _assert_weights_close(pm, jm)
    # bf16 state: two fp32 values a rounding apart can round to neighbouring
    # bf16 values, one bf16 step (at most 2^-7 relative) apart
    _assert_states_close(pm, jm, rtol=2 ** -7 if mode == "packed_bf16" else 1e-3)


@pytest.mark.parametrize("optimizer", ["adam", "adagrad"])
def test_split_packed_flat_and_dense_cotangent_bit_equal(optimizer):
    """The three fp32 modes run one sort, one fixed-order run sum and the
    same row math on the same values: the same bits after training."""
    x, y = _data(300, seed=17)
    out = {}
    for mode in ("split_packed", "split_flat", "dense_cotangent"):
        _, pm = _xdeepfm_pair(optimizer, mode, l2_reg_embedding=1e-3)
        pm.fit(x, y, **FIT)
        out[mode] = (dict(flatten_tree(pm.get_weights()["params"])), pm._lazy_state())
    for mode in ("split_flat", "dense_cotangent"):
        for k, v in out["split_packed"][0].items():
            np.testing.assert_array_equal(out[mode][0][k], v, err_msg=f"{mode} {k}")
        for k, v in out["split_packed"][1].items():
            assert torch.equal(out[mode][1][k], v), f"{mode} state {k}"


def test_two_fits_restart_the_lazy_step_count_as_jax():
    """The lazy bias correction restarts at t = 1 with each ``fit``
    (the JAX engine's ``global_step``), while dense Adam's count goes on."""
    jm, pm = _xdeepfm_pair("adam", "split_packed")
    x, y = _data(200, seed=6)
    for _ in range(2):
        jm.fit(x, y, **FIT)
        pm.fit(x, y, **FIT)
    assert pm._lazy["t"] == 8  # 4 steps an epoch, 2 epochs, from 0 again
    _assert_weights_close(pm, jm)
    _assert_states_close(pm, jm)


@pytest.mark.parametrize("mode", ["split_packed", "dense_cotangent", "packed_bf16"])
def test_untouched_rows_and_state_frozen(mode):
    _, pm = _xdeepfm_pair("adam", mode)
    before = {k: v.copy() for k, v in flatten_tree(pm.get_weights()["params"])}
    x, y = _data(100, seed=7)  # ids below 3/4 of each field's vocabulary
    pm.fit(x, y, **FIT)
    after = dict(flatten_tree(pm.get_weights()["params"]))
    state = pm._lazy_state()
    sp = np.stack([x[f"C{i}"] + i * VOCAB for i in range(N_SPARSE)], 1)
    touched = np.zeros(N_SPARSE * VOCAB, bool)
    touched[sp.reshape(-1)] = True
    for path in ("embedding_dict/table_d6", "linear_model/embedding_dict/table_d1"):
        np.testing.assert_array_equal(after[path][~touched], before[path][~touched])
        assert (after[path][touched] != before[path][touched]).all(axis=1).all()
        assert not state[path].numpy()[~touched].any()
        assert state[path].numpy()[touched].any(axis=1).all()


def test_tracked_reg_value_matches_full_scan():
    """``test_gradient_split_tracked_reg_value_matches_full_scan``: the split
    step's tracked sum(w^2) against a scan of the trained tables, and the
    logged loss against the dense-cotangent mode's (which scans)."""
    hist = {}
    x, y = _data(300, seed=8)
    for mode in ("dense_cotangent", "split_packed"):
        jm, pm = _xdeepfm_pair("adam", mode, l2_reg_embedding=1e-2)
        hist[mode] = pm.fit(x, y, batch_size=32, epochs=3, verbose=0, shuffle=False).history
        if mode == "split_packed":
            jm.fit(x, y, batch_size=32, epochs=3, verbose=0, shuffle=False)
            w = dict(flatten_tree(pm.get_weights()["params"]))
            assert sorted(pm._lazy["reg"]) == sorted(jm.opt_state["reg"])
            for path, val in pm._lazy["reg"].items():
                np.testing.assert_allclose(float(val), np.square(w[path], dtype=np.float64).sum(),
                                           rtol=1e-5, err_msg=path)
                np.testing.assert_allclose(float(val), float(jm.opt_state["reg"][path]),
                                           rtol=1e-4, err_msg=path)
    np.testing.assert_allclose(hist["split_packed"]["loss"], hist["dense_cotangent"]["loss"],
                               rtol=1e-5)


def test_split_matches_dense_cotangent_with_duplicate_column():
    """``test_duplicate_feature_column_split_parity``: a column listed twice
    maps to one batch column; split and dense cotangent agree, as JAX's."""
    cols = lambda mod: _cols(mod, [mod.SparseFeat("C0", VOCAB, DIM)])  # noqa: E731
    x, y = _data(200, seed=9)
    out = {}
    for mode in ("dense_cotangent", "split_flat"):
        jm, pm = _pair(JaxXDeepFM, xDeepFM, (cols(jf), cols(jf)), (cols(tf), cols(tf)), "adam",
                       mode, **ARCH)
        jm.fit(x, y, batch_size=32, epochs=2, verbose=0, shuffle=False)
        pm.fit(x, y, batch_size=32, epochs=2, verbose=0, shuffle=False)
        _assert_weights_close(pm, jm)
        out[mode] = dict(flatten_tree(pm.get_weights()["params"]))
    for k in out["split_flat"]:
        np.testing.assert_allclose(out["split_flat"][k], out["dense_cotangent"][k],
                                   rtol=W_RTOL, atol=W_ATOL, err_msg=k)


# ------------------------------------------------------------ compile


def test_auto_resolves_as_jax(monkeypatch):
    for mod in (jbm, tbm):
        monkeypatch.setattr(mod, "AUTO_LAZY_MIN_ROWS", N_SPARSE * VOCAB)
    jm, pm = _xdeepfm_pair("adam", "split_packed")
    for opt, lazy in (("adam", True), ("adagrad", True), ("sgd", False)):
        jm.compile(opt, "binary_crossentropy", embedding_optimizer="auto")
        pm.compile(opt, "binary_crossentropy", embedding_optimizer="auto")
        assert bool(jm._lazy_tables) == (pm._lazy is not None) == lazy
        if lazy:  # auto gradient: split, and packed
            assert pm._lazy["split"] and pm._lazy["packed"]
    pm.compile(lambda ps: torch.optim.Adam(ps), "binary_crossentropy",
               embedding_optimizer="auto")
    assert pm._lazy is None  # a non-string optimizer: dense
    for mod in (jbm, tbm):  # a table below the threshold: dense
        monkeypatch.setattr(mod, "AUTO_LAZY_MIN_ROWS", N_SPARSE * VOCAB + 1)
    jm.compile("adam", "binary_crossentropy", embedding_optimizer="auto")
    pm.compile("adam", "binary_crossentropy", embedding_optimizer="auto")
    assert not jm._lazy_tables and pm._lazy is None


@pytest.mark.parametrize("kw", [
    dict(embedding_optimizer="lazy", optimizer="sgd"),
    dict(embedding_layout="packed"),
    dict(embedding_state_dtype="bfloat16"),
    dict(embedding_optimizer="lazy", embedding_gradient="dense", embedding_layout="packed"),
    dict(embedding_optimizer="lazy", embedding_state_dtype="bfloat16", embedding_layout="flat"),
    dict(embedding_optimizer="lazy", embedding_state_dtype="float16"),
])
def test_compile_errors_match_jax(kw):
    kw = dict(kw)
    opt = kw.pop("optimizer", "adam")
    jm, pm = _xdeepfm_pair("adam", "split_packed")
    for m in (jm, pm):
        with pytest.raises(ValueError):
            m.compile(opt, "binary_crossentropy", **kw)


def test_packed_views_alias_the_group_array():
    """A member parameter is a column view of its group's array: a write
    through the array shows in ``get_weights`` and predict, and
    ``set_weights`` writes into the array and keeps the row state."""
    _, pm = _xdeepfm_pair("adam", "split_packed")
    x, y = _data(100, seed=10)
    pm.fit(x, y, **FIT)
    (g,) = pm._lazy["groups"]
    assert [m["path"] for m in g["members"]] == ["embedding_dict/table_d6",
                                                 "linear_model/embedding_dict/table_d1"]
    assert g["array"].shape == (N_SPARSE * VOCAB, 7 + 14)
    state = {k: v.clone() for k, v in pm._lazy_state().items()}
    w = pm.get_weights()
    g["array"][5, 2] = 42.0
    assert pm.get_weights()["params"]["embedding_dict"]["table_d6"][5, 2] == 42.0
    assert pm.module.embedding_dict.table_d6.data_ptr() == g["array"].data_ptr()
    pm.set_weights(w)
    assert g["array"][5, 2] == w["params"]["embedding_dict"]["table_d6"][5, 2]
    for k, v in pm._lazy_state().items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0)
    # a recompile gives each table back its own contiguous parameter
    pm.compile("adam", "binary_crossentropy")
    assert pm._lazy is None and pm.module.embedding_dict.table_d6.is_contiguous()
    np.testing.assert_array_equal(pm.get_weights()["params"]["embedding_dict"]["table_d6"],
                                  w["params"]["embedding_dict"]["table_d6"])


@pytest.mark.parametrize("mode", ["split_flat", "dense_cotangent"])
def test_flat_tables_keep_their_state_in_their_columns(mode):
    """Unpacked, each lazy table is a group of its own under the same
    storage: a [rows, dim + state] array whose first columns are the
    parameter, so a write through the array shows in ``get_weights`` and a
    write to the state columns in the canonical row state."""
    _, pm = _xdeepfm_pair("adam", mode)
    pm.fit(*_data(100, seed=10), **FIT)
    by_path = {g["members"][0]["path"]: g for g in pm._lazy["groups"]}
    assert sorted(by_path) == ["embedding_dict/table_d6", "linear_model/embedding_dict/table_d1"]
    g = by_path["embedding_dict/table_d6"]
    assert g["array"].shape == (N_SPARSE * VOCAB, 6 + 12)
    assert pm.module.embedding_dict.table_d6.data_ptr() == g["array"].data_ptr()
    g["array"][5, 2] = 42.0
    g["array"][5, 6 + 12 - 1] = 7.0  # the last v column
    assert pm.get_weights()["params"]["embedding_dict"]["table_d6"][5, 2] == 42.0
    assert pm._lazy_state()["embedding_dict/table_d6"][5, 11] == 7.0


# -------------------------------------------------------- checkpoints


@pytest.mark.parametrize("src,dst", [("split_packed", "split_flat"), ("split_flat", "split_packed"),
                                     ("packed_bf16", "split_packed"),
                                     ("split_packed", "packed_bf16"),
                                     ("split_flat", "dense_cotangent")])
def test_checkpoint_cross_format(src, dst, tmp_path):
    """``test_packed_checkpoint_cross_format`` and
    ``test_bf16_state_checkpoint_cross_format``: a checkpoint of one layout
    or state dtype loads under another, with the same predictions, and the
    resumed training goes on as the source's does."""
    x, y = _data(200, seed=11)
    _, m1 = _xdeepfm_pair("adam", src)
    _, m2 = _xdeepfm_pair("adam", dst)
    m1.fit(x, y, **FIT)
    path = str(tmp_path / "c.npz")
    m1.save_checkpoint(path, epoch=1)
    with np.load(path) as data:
        assert data["opt_state/lazy/embedding_dict/table_d6"].shape == (N_SPARSE * VOCAB, 2 * DIM)
    assert m2.load_checkpoint(path) == 1
    np.testing.assert_array_equal(m2.predict(x, 64), m1.predict(x, 64))
    for k, v in m1._lazy_state().items():
        # the bf16 state's encoding rounds the moments once
        tol = 2 ** -8 if "packed_bf16" in (src, dst) else 0
        torch.testing.assert_close(m2._lazy_state()[k], v, rtol=tol, atol=0)
    if "split" in dst or "packed" in dst:
        for k, v in m1._lazy["reg"].items():
            np.testing.assert_allclose(float(m2._lazy["reg"][k]), float(v), rtol=1e-6)
    m1.fit(x, y, **FIT)
    m2.fit(x, y, **FIT)
    rtol = 1e-3 if "packed_bf16" in (src, dst) else 1e-5
    np.testing.assert_allclose(m2.predict(x, 64), m1.predict(x, 64), rtol=rtol, atol=1e-6)


def test_checkpoint_of_another_optimizer_mode_is_refused(tmp_path):
    """A lazy model's checkpoint does not load into a dense model, nor a
    dense model's into a lazy one: row states and dense moments of the
    tables never go missing silently."""
    x, y = _data(100, seed=18)
    _, lazy = _xdeepfm_pair("adam", "split_packed")
    dense = xDeepFM(_cols(tf), _cols(tf), device="cpu", **ARCH)
    dense.compile("adam", "binary_crossentropy")
    for m in (lazy, dense):
        m.fit(x, y, **FIT)
    paths = {m: str(tmp_path / f"{i}.npz") for i, m in enumerate((lazy, dense))}
    for m, path in paths.items():
        m.save_checkpoint(path)
    with pytest.raises(ValueError, match="row states"):
        dense.load_checkpoint(paths[lazy])
    with pytest.raises(ValueError, match="trains lazily"):
        lazy.load_checkpoint(paths[dense])


def test_a_lookup_past_the_block_raises(monkeypatch):
    """The split step fails loudly if a lookup reads a lazy table itself
    instead of its occurrence block (the table would get a gradient that
    no optimizer applies)."""
    _, pm = _xdeepfm_pair("adam", "split_packed")
    monkeypatch.setattr(temb.EmbeddingCollection, "_block", lambda self, batch, dim: None)
    x, y = _data(64, seed=19)
    with pytest.raises(RuntimeError, match="bypassed the occurrence block"):
        pm.fit(x, y, **FIT)


def test_checkpoint_holds_the_jax_canonical_state(tmp_path):
    """The port's checkpoint of a packed bf16 model holds the JAX package's
    canonical row state after the same training (decoded, per member)."""
    jm, pm = _xdeepfm_pair("adam", "packed_bf16")
    x, y = _data(200, seed=12)
    jm.fit(x, y, **FIT)
    pm.fit(x, y, **FIT)
    path = str(tmp_path / "c.npz")
    pm.save_checkpoint(path)
    want = _jax_lazy_state(jm)
    with np.load(path) as data:
        for k, v in want.items():
            np.testing.assert_allclose(data[f"opt_state/lazy/{k}"], v, rtol=1e-2,
                                       atol=1e-4 * np.abs(v).max(), err_msg=k)
            np.testing.assert_allclose(data[f"opt_state/reg/{k}"], float(jm.opt_state["reg"][k]),
                                       rtol=1e-4)


def test_start_from_jax_mid_training():
    """``set_weights`` with the JAX model's ``_canonical_opt_state()`` carries
    its row states and tracked values: one more step of both models (one
    batch, so the dense optimizers' differing states cannot reach the
    tables) gives the same tables and states."""
    jm, _ = _xdeepfm_pair("adam", "split_packed")
    x, y = _data(200, seed=13)
    jm.fit(x, y, **FIT)
    pm = xDeepFM(_cols(tf), _cols(tf), device="cpu", **ARCH)
    pm.compile("adam", "binary_crossentropy", embedding_optimizer="lazy",
               embedding_state_dtype="bfloat16")
    w = jm.get_weights()
    w["opt_state"] = jm._canonical_opt_state()
    pm.set_weights(w)
    for k, v in _jax_lazy_state(jm).items():
        np.testing.assert_allclose(pm._lazy_state()[k].numpy(), v, rtol=2 ** -8, err_msg=k)
    xb, yb = _data(64, seed=14)
    jm.fit(xb, yb, batch_size=64, epochs=1, verbose=0, shuffle=False)
    pm.fit(xb, yb, batch_size=64, epochs=1, verbose=0, shuffle=False)
    want = dict(flatten_tree(jm.get_weights()["params"]))
    got = dict(flatten_tree(pm.get_weights()["params"]))
    for k in ("embedding_dict/table_d6", "linear_model/embedding_dict/table_d1"):
        np.testing.assert_allclose(got[k], want[k], rtol=W_RTOL, atol=W_ATOL, err_msg=k)


# ---------------------------------------------------- other entry points


def test_bench_lazy_script_on_cpu(capsys, monkeypatch):
    """``scripts/bench_lazy.py`` runs every mode on the CPU (host clock, no
    profile) and reports each lazy mode's array bytes (at a batch of 32)."""
    from xdeepfm_tpu_torch.scripts import bench_lazy

    monkeypatch.setattr(bench_lazy, "BATCH", 32)
    modes = list(bench_lazy.MODES)
    recs = bench_lazy.main(["50", "adagrad", *modes, "--steps", "1", "--repeats", "2",
                            "--device", "cpu"])
    assert [r["mode"] for r in recs] == modes + modes[::-1]
    for r in recs:
        assert r["clock"] == "host_clock" and r["rows"] == 26 * 50 and r["batch"] == 32
        assert ("lazy_arrays_bytes" in r) == (r["mode"] != "dense")
    # Adagrad packed: [rows, 11 + 11] fp32; flat: [rows, 10 + 10] and
    # [rows, 1 + 1], each table with its state columns
    by_mode = {r["mode"]: r for r in recs}
    assert by_mode["lazy_split"]["lazy_arrays_bytes"] == 26 * 50 * 22 * 4
    assert by_mode["lazy_split_flat"]["lazy_arrays_bytes"] == 26 * 50 * 22 * 4
    assert len(capsys.readouterr().out.strip().splitlines()) == len(recs)


def test_fit_stream_lazy_split_matches_fit():
    """``tests/test_stream.py:307``: ``fit_stream`` composes with the lazy
    split optimizer; over the same batches it trains as ``fit`` does."""
    x, y = _data(256, seed=15)
    _, a = _xdeepfm_pair("adam", "split_packed")
    _, b = _xdeepfm_pair("adam", "split_packed")

    def batches(epoch):
        for i in range(0, 256, 64):
            yield {k: v[i : i + 64] for k, v in x.items()}, y[i : i + 64]

    ha = a.fit(x, y, batch_size=64, epochs=3, verbose=0, shuffle=False).history
    hb = b.fit_stream(batches, epochs=3, verbose=0).history
    assert hb["loss"][-1] < hb["loss"][0] and b._lazy["reg"]
    np.testing.assert_allclose(hb["loss"], ha["loss"], rtol=1e-6)
    np.testing.assert_array_equal(b.predict(x, 64), a.predict(x, 64))
