"""PyTorch port: the JAX package's flax msgpack files (``save_weights``,
``save_checkpoint``, a CLI's ``{model}_best.weights``) read by the port's
``load_weights``, ``load_checkpoint`` and ``load_scorer``, and the port's
own codec (``xdeepfm_tpu_torch/serialization.py``) against
``flax.serialization`` byte for byte.

Predictions after a load are held to ``tests/test_torch_port_xdeepfm.py``'s
``PRED_TOL``; a resumed step to ``tests/test_torch_port_train.py``'s
per-optimizer ``OPT_TOL``.  Both sides are fp32 on the CPU.
"""

import types

import flax.serialization as fs
import jax
import numpy as np
import pytest
import torch

import xdeepfm_tpu.features as jf
import xdeepfm_tpu.models as jmodels
import xdeepfm_tpu.pro as jpro
import xdeepfm_tpu_torch.features as tf
import xdeepfm_tpu_torch.models as tmodels
import xdeepfm_tpu_torch.pro as tpro
from xdeepfm_tpu_torch import serialization
from xdeepfm_tpu_torch.serving import load_scorer
from xdeepfm_tpu_torch.weights import flatten_tree, to_jax_checkpoint

PRED_TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_torch_port_xdeepfm.py:33
# tests/test_torch_port_train.py:78
OPT_TOL = {"sgd": (1e-5, 1e-6), "adam": (1e-4, 2e-5), "adagrad": (1e-4, 2e-5),
           "rmsprop": (1e-4, 2e-5)}
JNS = types.SimpleNamespace(features=jf, models=jmodels, pro=jpro)
TNS = types.SimpleNamespace(features=tf, models=tmodels, pro=tpro)
N, VOCAB, DIM, MAXLEN = 96, 20, 8, 5
LAZY = dict(embedding_optimizer="lazy", embedding_gradient="split")


def _columns(ns, name):
    F = ns.features
    if name in ("dien", "din_dice"):
        def hist(n):
            return F.VarLenSparseFeat(F.SparseFeat(n, VOCAB, embedding_dim=DIM,
                                                   embedding_name="item"),
                                      maxlen=MAXLEN, length_name="seq_length")

        cols = [F.SparseFeat("user", VOCAB, embedding_dim=DIM),
                F.SparseFeat("item", VOCAB, embedding_dim=DIM), F.DenseFeat("score", 1),
                hist("hist_item")]
        return cols + [hist("neg_hist_item")] if name == "dien" else cols
    return ([F.SparseFeat(f"C{i}", VOCAB, embedding_dim=DIM) for i in range(4)]
            + [F.DenseFeat(f"I{i}") for i in range(2)])


def _data(name, n=N, seed=0):
    rng = np.random.default_rng(seed)
    if name in ("dien", "din_dice"):
        lengths = rng.integers(1, MAXLEN + 1, n)
        valid = np.arange(MAXLEN)[None, :] < lengths[:, None]
        x = {"user": rng.integers(0, VOCAB, n), "item": rng.integers(0, VOCAB, n),
             "score": rng.uniform(0, 1, n).astype(np.float32),
             "hist_item": rng.integers(1, VOCAB, (n, MAXLEN)) * valid,
             "neg_hist_item": rng.integers(1, VOCAB, (n, MAXLEN)) * valid,
             "seq_length": lengths}
    else:
        x = {f"C{i}": rng.integers(0, VOCAB, n) for i in range(4)}
        x.update({f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(2)})
    return x, (rng.uniform(size=n) < 0.4).astype(np.float32)


def _build(ns, name, **kw):
    """The model of a case from ``ns`` (the JAX package's modules or the
    port's); ``kw`` reaches the constructor."""
    cols = _columns(ns, name)
    M = ns.models
    if name == "xdeepfm":
        return M.xDeepFM(cols, cols, dnn_hidden_units=(16,), cin_layer_size=(8, 6), **kw)
    if name == "xdeepfm_other":  # another CIN: another architecture
        return M.xDeepFM(cols, cols, dnn_hidden_units=(16,), cin_layer_size=(8, 4), **kw)
    if name in ("pro", "pro_autodis"):
        return ns.pro.xDeepFMPro(cols, cols, dnn_hidden_units=(16,), cin_layer_size=(8, 6),
                                 sfg_hidden_units=(8, 4), use_autodis=name == "pro_autodis",
                                 autodis_buckets=4, **kw)
    if name == "v2":
        return M.xDeepFMAttentionV2(cols, cols, dnn_hidden_units=(16,), cin_layer_size=(8, 6),
                                    cin_num_heads=2, cin_num_attn_layers=2, **kw)
    if name == "dien":
        return M.DIEN(cols, ["item"], gru_type="AUGRU", use_negsampling=True,
                      dnn_hidden_units=(16,), att_hidden_units=(8,), **kw)
    if name == "din_dice":  # Dice attention and a BatchNorm DNN: batch_stats
        return M.DIN(cols, ["item"], dnn_hidden_units=(16,), att_hidden_size=(8,),
                     att_activation="Dice", dnn_use_bn=True, **kw)
    raise KeyError(name)


def _seeded(model, seed=1):
    """``model``'s weights replaced by seeded draws at scale 0.1."""
    rng = np.random.default_rng(seed)
    w = model.get_weights()
    w["params"] = jax.tree.map(
        lambda v: (0.1 * rng.standard_normal(np.shape(v))).astype(np.float32), w["params"])
    model.set_weights(w)
    return model


def _jax(name, optimizer="adam", **compile_kw):
    m = _build(JNS, name)
    m.compile(optimizer, "binary_crossentropy", metrics=[], **compile_kw)
    return _seeded(m)


def _port(name, optimizer="adam", **compile_kw):
    m = _build(TNS, name, device="cpu")
    m.compile(optimizer, "binary_crossentropy", metrics=[], **compile_kw)
    return m


# ------------------------------------------------------------------ the codec


@pytest.mark.parametrize("name,compile_kw", [("xdeepfm", {}), ("pro", LAZY)],
                         ids=["xdeepfm", "pro_lazy"])
def test_to_bytes_is_flax_bytes(name, compile_kw):
    """The port's ``to_bytes`` writes flax's bytes for the JAX model's
    weight tree, and for the port model's own ``get_weights`` after the
    same weights went in."""
    jm_ = _jax(name, **compile_kw)
    tree = jm_.get_weights()
    want = fs.to_bytes(tree)
    assert serialization.to_bytes(tree) == want
    pm = _port(name, **compile_kw)
    pm.set_weights(tree)
    assert serialization.to_bytes(pm.get_weights()) == want


def _same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    else:
        assert type(got) is type(want), (path, type(got), type(want))
        assert np.shape(got) == np.shape(want), path
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


@pytest.mark.parametrize("optimizer,compile_kw", [
    ("adam", {}), ("adagrad", {}), ("adam", LAZY),
    ("adam", dict(LAZY, embedding_state_dtype="bfloat16"))],
    ids=["adam", "adagrad", "lazy_packed", "lazy_bf16"])
def test_msgpack_restore_matches_flax(tmp_path, optimizer, compile_kw):
    """The JAX ``save_checkpoint`` files after a step, restored by both."""
    jm_ = _jax("xdeepfm", optimizer, **compile_kw)
    x, y = _data("xdeepfm")
    jm_.fit(x, y, batch_size=48, epochs=1, verbose=0)
    path = tmp_path / "ckpt"
    jm_.save_checkpoint(str(path), epoch=3)
    data = path.read_bytes()
    _same_tree(serialization.msgpack_restore(data), fs.msgpack_restore(data))
    _same_tree(serialization.restore_file(path), fs.msgpack_restore(data))


def test_chunked_array_round_trip(monkeypatch):
    """An array over MAX_CHUNK_SIZE (lowered on both sides to 4 KB) is
    written in flax's chunks, byte for byte, and joined back."""
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 4096)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
    rng = np.random.default_rng(2)
    tree = {"params": {"embedding_dict": {"table_d10": rng.normal(size=(301, 10)).astype(
        np.float32)}, "bias": rng.normal(size=(7,)).astype(np.float32)}, "epoch": 2}
    data = fs.to_bytes(tree)
    assert serialization.to_bytes(tree) == data
    back = serialization.msgpack_restore(data)
    np.testing.assert_array_equal(back["params"]["embedding_dict"]["table_d10"],
                                  tree["params"]["embedding_dict"]["table_d10"])
    assert back["epoch"] == 2
    _same_tree(back, fs.msgpack_restore(data))
    # a torch table (the port's own leaves) chunks the same way
    t_tree = {"t": torch.from_numpy(tree["params"]["embedding_dict"]["table_d10"])}
    assert serialization.to_bytes(t_tree) == fs.to_bytes(
        {"t": tree["params"]["embedding_dict"]["table_d10"]})


def test_bfloat16_and_rejected_leaves():
    """A bf16 array reads as a ``torch.bfloat16`` tensor and writes back to
    flax's bytes; a complex leaf (ext 2) is refused."""
    import ml_dtypes

    arr = np.arange(6, dtype=np.float32).reshape(2, 3).astype(ml_dtypes.bfloat16)
    data = fs.to_bytes({"w": arr})
    back = serialization.msgpack_restore(data)["w"]
    assert back.dtype == torch.bfloat16 and tuple(back.shape) == (2, 3)
    np.testing.assert_array_equal(back.float().numpy(), arr.astype(np.float32))
    assert serialization.to_bytes({"w": back}) == data
    with pytest.raises(ValueError, match="complex"):
        serialization.msgpack_restore(fs.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(ValueError, match="complex"):
        serialization.to_bytes({"c": 1 + 2j})


# ------------------------------------------------------- JAX files into the port


@pytest.mark.parametrize("name", ["xdeepfm", "pro_autodis", "v2", "dien", "din_dice"])
def test_jax_save_weights_into_port(tmp_path, name):
    """JAX ``save_weights`` -> the port's ``load_weights`` -> ``predict``."""
    jm_ = _jax(name)
    x, y = _data(name)
    if name == "din_dice":  # moved BatchNorm statistics
        jm_.fit(x, y, batch_size=48, epochs=1, verbose=0)
    path = tmp_path / f"{name}.weights"
    jm_.save_weights(str(path))
    pm = _port(name)
    pm.load_weights(str(path))
    np.testing.assert_allclose(pm.predict(x, 32), jm_.predict(x, 32), **PRED_TOL)
    if name == "din_dice":
        assert any(k.startswith("dnn") for k, _ in flatten_tree(pm.get_weights()["batch_stats"]))


@pytest.mark.parametrize("case", ["adam", "adagrad", "rmsprop", "sgd", "lazy_packed",
                                  "lazy_into_flat_bf16"])
def test_jax_checkpoint_resumes_in_port(tmp_path, case):
    """JAX ``fit`` of two steps, ``save_checkpoint``, then one more ``fit``
    step; the port loads the checkpoint and takes that step: the loss and
    every weight at ``OPT_TOL`` (each optax state layout: Adam's count, mu
    and nu, Adagrad's sums, RMSprop's nu, SGD's none).  The lazy case also loads the JAX packed
    checkpoint into a port model of the flat layout and into one with bf16
    row states (the flat case) and checks the row states."""
    optimizer = case if case in OPT_TOL else "adam"
    jax_kw = LAZY if case.startswith("lazy") else {}
    port_kw = dict(LAZY, embedding_layout="flat") if case == "lazy_into_flat_bf16" else jax_kw
    rtol, atol = OPT_TOL[optimizer]
    jm_ = _jax("xdeepfm", optimizer, **jax_kw)
    x, y = _data("xdeepfm")
    jm_.fit({k: v[:64] for k, v in x.items()}, y[:64], batch_size=32, epochs=1, verbose=0,
            shuffle=False)
    path = tmp_path / "ckpt"
    jm_.save_checkpoint(str(path), epoch=1)
    rest = ({k: v[64:96] for k, v in x.items()}, y[64:96])
    want = jm_.fit(*rest, batch_size=32, epochs=1, verbose=0, shuffle=False).history
    pm = _port("xdeepfm", optimizer, **port_kw)
    assert pm.load_checkpoint(str(path)) == 1
    got = pm.fit(*rest, batch_size=32, epochs=1, verbose=0, shuffle=False).history
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=rtol)
    jw = dict(flatten_tree(jm_.get_weights()["params"]))
    pw = dict(flatten_tree(pm.get_weights()["params"]))
    assert sorted(pw) == sorted(jw)
    for k in jw:
        np.testing.assert_allclose(pw[k], np.asarray(jw[k]), rtol=rtol, atol=atol, err_msg=k)
    if jax_kw:
        jl = {k: np.asarray(v) for k, v in jm_._canonical_opt_state()["lazy"].items()}
        pl = {k: v.numpy() for k, v in pm._lazy_state().items()}
        assert sorted(pl) == sorted(jl)
        for k in jl:
            np.testing.assert_allclose(pl[k], jl[k], rtol=rtol, atol=1e-6, err_msg=k)
    if case == "lazy_into_flat_bf16":
        bf = _port("xdeepfm", optimizer, **dict(LAZY, embedding_state_dtype="bfloat16"))
        bf.load_checkpoint(str(path))
        raw = fs.msgpack_restore(path.read_bytes())["opt_state"]["lazy"]
        for k, v in bf._lazy_state().items():  # each moment rounded to bf16
            np.testing.assert_allclose(v.numpy(), np.asarray(dict(flatten_tree(raw))[k]),
                                       rtol=2 ** -8, atol=1e-30, err_msg=k)


def test_load_scorer_on_jax_cli_weights(tmp_path):
    """A JAX CLI run's ``xdeepfm_best.weights`` and ``preprocess.pkl``
    through the port's ``load_scorer``: its scores are the JAX model's."""
    from xdeepfm_tpu.cli import xdftrain as jx
    from xdeepfm_tpu_torch.cli import xdftrain as tx

    rng = np.random.default_rng(0)
    data = tmp_path / "train.txt"
    with open(data, "w") as f:
        for _ in range(300):
            dense = [str(rng.integers(0, 50)) if rng.uniform() > 0.1 else "" for _ in range(13)]
            sparse = [f"c{rng.integers(0, 12):x}" for _ in range(26)]
            f.write("\t".join([str(rng.integers(0, 2))] + dense + sparse) + "\n")
    out = tmp_path / "jax"
    argv = ["--data_path", str(data), "--out_dir", str(out), "--mode", "eval", "--epochs", "1",
            "--batch_size", "64", "--embedding_dim", "4", "--verbose", "0",
            "--use_native_parser"]
    built, build_jax = {}, jx.build_model

    def build(args, lin, dnn, final_mode=False):
        built["model"] = build_jax(args, lin, dnn, final_mode)
        built["cols"] = (lin, dnn)
        return built["model"]

    jx.build_model = build
    try:
        jx.main(argv)
    finally:
        jx.build_model = build_jax
    jm_ = built["model"]
    jm_.load_weights(str(out / "xdeepfm_best.weights"))
    lin, dnn = built["cols"]
    port_cols = [tf.SparseFeat(c.name, c.vocabulary_size, c.embedding_dim)
                 if isinstance(c, jf.SparseFeat) else tf.DenseFeat(c.name, c.dimension)
                 for c in dnn]
    args = tx.parse_args(argv[:-1] + ["--device", "cpu"])
    scorer, pp = load_scorer(lambda: tx.build_model(args, port_cols, port_cols),
                             str(out / "xdeepfm_best.weights"), str(out / "preprocess.pkl"),
                             batch_size=64)
    assert pp is not None and pp.get("native") is True
    x = {c.name: (rng.integers(0, c.vocabulary_size, 100) if isinstance(c, jf.SparseFeat)
                  else rng.uniform(0, 1, 100).astype(np.float32)) for c in dnn}
    np.testing.assert_allclose(scorer.score(x), jm_.predict(x, 64), **PRED_TOL)


# ------------------------------------------------------ port files into JAX


def test_port_files_read_by_jax(tmp_path):
    """A port-trained model's weights through ``serialization.save_file``
    into the JAX ``load_weights``, and its checkpoint through
    ``to_jax_checkpoint`` into the JAX ``load_checkpoint``: the JAX model
    predicts the port's scores, and one more step matches."""
    pm = _port("xdeepfm", "adam", **LAZY)
    pm.set_weights(_jax("xdeepfm", "adam", **LAZY).get_weights())
    x, y = _data("xdeepfm")
    pm.fit({k: v[:64] for k, v in x.items()}, y[:64], batch_size=32, epochs=1, verbose=0)
    wpath, cpath = tmp_path / "port.weights", tmp_path / "port.ckpt"
    serialization.save_file(wpath, pm.get_weights())
    jm_ = _jax("xdeepfm", "adam", **LAZY)
    jm_.load_weights(str(wpath))
    np.testing.assert_allclose(jm_.predict(x, 32), pm.predict(x, 32), **PRED_TOL)
    serialization.save_file(cpath, to_jax_checkpoint(pm, epoch=4))
    jc = _jax("xdeepfm", "adam", **LAZY)
    assert jc.load_checkpoint(str(cpath)) == 4
    rest = ({k: v[64:96] for k, v in x.items()}, y[64:96])
    want = jc.fit(*rest, batch_size=32, epochs=1, verbose=0, shuffle=False).history
    got = pm.fit(*rest, batch_size=32, epochs=1, verbose=0, shuffle=False).history
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=OPT_TOL["adam"][0])
    # and back: the port reads its own JAX-format checkpoint
    back = _port("xdeepfm", "adam", **LAZY)
    assert back.load_checkpoint(str(cpath)) == 4


def test_other_architecture_raises(tmp_path):
    """A file of another architecture raises and names the first path
    whose shape differs, in either format; a weights file given to
    ``load_checkpoint`` and a checkpoint of another optimizer raise."""
    jm_ = _jax("xdeepfm_other")
    path = tmp_path / "other.weights"
    jm_.save_weights(str(path))
    pm = _port("xdeepfm")
    with pytest.raises(ValueError, match=r"params/cin/conv_b_1: expected \(6,\), got \(4,\)"):
        pm.load_weights(str(path))
    npz = tmp_path / "other.npz"
    other = _port("xdeepfm_other")
    other.save_weights(str(npz))
    with pytest.raises(ValueError, match="params/cin/conv_b_1"):
        pm.load_weights(str(npz))
    with pytest.raises(ValueError, match="not a checkpoint"):
        pm.load_checkpoint(str(path))
    ja = _jax("xdeepfm", "adagrad")
    ja.save_checkpoint(str(tmp_path / "adagrad.ckpt"))
    with pytest.raises(ValueError, match="adagrad"):
        pm.load_checkpoint(str(tmp_path / "adagrad.ckpt"))
    (tmp_path / "junk").write_bytes(b"\x00junk")
    with pytest.raises(ValueError, match="neither"):
        pm.load_weights(str(tmp_path / "junk"))
