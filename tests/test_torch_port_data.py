"""The port's data pipeline, native parser, LogWriter and profiling against
the JAX package's, on the CPU.

The fixture is ``tests/test_cli.py``'s 400-row Criteo-like file (a
comma-separated header over tab-separated rows, 10% empty dense fields, 5%
empty categories).  Everything here is numpy and pandas on both sides, so
the model inputs must be bit-equal (``assert_array_equal``), not close.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pytest

import xdeepfm_tpu.callbacks as jcb
import xdeepfm_tpu.data as jd
import xdeepfm_tpu_torch.callbacks as tcb
import xdeepfm_tpu_torch.data as td
from xdeepfm_tpu_torch import native as tnative
from xdeepfm_tpu_torch import profiling

SPARSE, DENSE = td.CRITEO_SPARSE, td.CRITEO_DENSE
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def criteo_file(tmp_path_factory):
    """``tests/test_cli.py:10-34``'s corpus."""
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("criteo")
    path = d / "train.txt"
    cols = (
        ["label"]
        + [f"I{i}" for i in range(1, 14)]
        + [f"C{i}" for i in range(1, 27)]
    )
    with open(path, "w") as f:
        f.write(",".join(cols) + "\n")  # header comma-separated
        for _ in range(400):
            label = rng.integers(0, 2)
            dense = [
                f"{rng.uniform(0, 100):.2f}" if rng.uniform() > 0.1 else ""
                for _ in range(13)
            ]
            sparse = [
                f"cat{rng.integers(0, 15):x}" if rng.uniform() > 0.05 else ""
                for _ in range(26)
            ]
            # data tab-separated (mixed-separator case, xdftrain.py:142-152)
            f.write("\t".join([str(label)] + dense + sparse) + "\n")
    return str(path)


def _equal_inputs(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_bulk_pipeline_is_bit_equal(criteo_file):
    """read_criteo_like -> train_test_split -> prepare_features (fit on
    train) -> build_feature_columns -> build_model_input, both packages."""
    out = {}
    for name, mod in (("jax", jd), ("port", td)):
        df = mod.read_criteo_like(criteo_file)
        df["label"] = pd.to_numeric(df["label"], errors="coerce").fillna(0).astype("float32")
        train, test = mod.train_test_split(df, 0.25, 7, stratify=df["label"])
        test = test.copy()
        test.iloc[0, test.columns.get_loc("C1")] = "never_seen"
        train_p, enc, scaler = mod.prepare_features(train, SPARSE, DENSE, fit_df=train)
        test_p, _, _ = mod.prepare_features(test, SPARSE, DENSE, encoders=enc, scaler=scaler)
        lin, _, names = mod.build_feature_columns(train_p, SPARSE, DENSE, embedding_dim=4)
        out[name] = (mod.build_model_input(train_p, names), mod.build_model_input(test_p, names),
                     [(c.name, getattr(c, "vocabulary_size", None)) for c in lin], scaler)
    for a, b in zip(out["jax"][:2], out["port"][:2]):
        _equal_inputs(a, b)
    assert out["jax"][2] == out["port"][2]
    np.testing.assert_array_equal(out["jax"][3].data_min_, out["port"][3].data_min_)
    np.testing.assert_array_equal(out["jax"][3].data_max_, out["port"][3].data_max_)
    assert out["port"][1]["C1"][0] == 0  # an unseen category -> unknown 0


def test_encoder_and_scaler_match():
    series = pd.Series(["a", "b", "c", "a", None]).fillna("-1")
    je, te = jd.SafeLabelEncoder.fit(series), td.SafeLabelEncoder.fit(series)
    assert te.mapping == je.mapping
    probe = pd.Series(["b", "zzz", "a", "-1"])
    assert te.transform(probe).tolist() == je.transform(probe).tolist() == [2, 0, 1, 4]
    # integral floats encode like ints (a NaN-bearing chunk types a column float)
    ints = pd.Series([3, 5, 3])
    assert td.SafeLabelEncoder.fit(ints).transform(pd.Series([5.0, 3.0, 7.0])).tolist() == [2, 1, 0]
    x = np.array([[1.0, 5.0], [3.0, 5.0], [2.0, 5.0]], np.float32)
    np.testing.assert_array_equal(td.MinMaxScaler().fit_transform(x),
                                  jd.MinMaxScaler().fit_transform(x))


def test_streaming_pipeline_is_bit_equal(criteo_file):
    got, want = ({} for _ in range(2))
    for out, mod in ((want, jd), (got, td)):
        enc, scaler, stats = mod.fit_preprocessors_streaming(criteo_file, SPARSE, DENSE,
                                                             chunksize=100)
        out["stats"] = stats
        out["vocab"] = {k: v.mapping for k, v in enc.items()}
        out["batches"] = list(mod.iter_criteo_batches(criteo_file, SPARSE, DENSE, enc, scaler,
                                                      128, chunksize=100))
        out["cols"] = [(c.name, getattr(c, "vocabulary_size", None))
                       for c in mod.feature_columns_from_encoders(enc, SPARSE, DENSE)[0]]
    assert got["stats"] == want["stats"] and got["vocab"] == want["vocab"]
    assert got["cols"] == want["cols"]
    assert [len(y) for _, y in got["batches"]] == [128, 128, 128, 16]
    for (xa, ya), (xb, yb) in zip(want["batches"], got["batches"]):
        np.testing.assert_array_equal(ya, yb)
        _equal_inputs(xa, xb)


def test_native_parser_matches_jax_and_builds_under_port_build(criteo_file, tmp_path):
    if not tnative.available():
        pytest.skip("needs g++ to build the native parser")
    from xdeepfm_tpu import native as jnative

    tracked = os.path.join(REPO, "native", "libcriteo.so")
    before = os.stat(tracked)
    lib = tnative.library_path()
    assert lib.parent.name == "_build" and lib.parent.parent.name == "xdeepfm_tpu_torch"
    assert lib.exists()
    port = tnative.NativeCriteoParser()
    got = {"fit": port.fit_transform(criteo_file),
           "stream": list(port.stream(criteo_file, 150)),
           "shuffled": list(td.iter_criteo_batches_native(
               criteo_file, port, None, 64, shuffle_buffer=150, seed=3))}
    port.save_vocab(str(tmp_path / "port_vocab.bin"))
    after = os.stat(tracked)
    assert (after.st_mtime_ns, after.st_size) == (before.st_mtime_ns, before.st_size)

    if not jnative.available():
        pytest.skip("the JAX package's native parser did not build")
    ref = jnative.NativeCriteoParser()
    want = {"fit": ref.fit_transform(criteo_file),
            "stream": list(ref.stream(criteo_file, 150)),
            "shuffled": list(jd.iter_criteo_batches_native(
                criteo_file, ref, None, 64, shuffle_buffer=150, seed=3))}
    for a, b in zip(got["fit"], want["fit"]):
        np.testing.assert_array_equal(a, b)
    assert len(got["stream"]) == len(want["stream"]) == 3
    for ga, wa in zip(got["stream"], want["stream"]):
        for a, b in zip(ga, wa):
            np.testing.assert_array_equal(a, b)
    assert len(got["shuffled"]) == len(want["shuffled"])
    for (xa, ya), (xb, yb) in zip(got["shuffled"], want["shuffled"]):
        np.testing.assert_array_equal(ya, yb)
        _equal_inputs(xa, xb)
    np.testing.assert_array_equal(port.vocab_sizes(), ref.vocab_sizes())
    ref.save_vocab(str(tmp_path / "jax_vocab.bin"))
    assert (tmp_path / "port_vocab.bin").read_bytes() == (tmp_path / "jax_vocab.bin").read_bytes()
    # a vocab file loads into a fresh parser and encodes as the fitted one
    fresh = tnative.NativeCriteoParser()
    fresh.load_vocab(str(tmp_path / "jax_vocab.bin"))
    np.testing.assert_array_equal(fresh.transform(criteo_file)[2], got["fit"][2])


# Loads a JAX-written preprocess.pkl through the port's load_scorer, encodes
# the fixture with it, and reports which packages the process imported.
_SUBPROCESS = textwrap.dedent("""
    import json, sys
    import numpy as np
    from xdeepfm_tpu_torch.data import (CRITEO_DENSE, CRITEO_SPARSE, build_model_input,
                                        prepare_features, read_criteo_like)
    from xdeepfm_tpu_torch.models import xDeepFM
    from xdeepfm_tpu_torch.serving import load_scorer
    pkl, data, weights, out = sys.argv[1:]

    def build():
        from xdeepfm_tpu_torch.features import DenseFeat, SparseFeat
        cols = [SparseFeat("C1", 20, 4), DenseFeat("I1")]
        return xDeepFM(cols, cols, dnn_hidden_units=(4,), cin_layer_size=(2,), device="cpu")

    build().save_weights(weights)
    _, pp = load_scorer(build, weights, preprocess_path=pkl, batch_size=16)
    dfp, _, _ = prepare_features(read_criteo_like(data), pp["sparse_features"],
                                 pp["dense_features"], encoders=pp["encoders"],
                                 scaler=pp["scaler"])
    np.savez(out, **build_model_input(dfp, pp["feature_names"]))
    print(json.dumps(sorted({k.split(".")[0] for k in sys.modules
                             if k.split(".")[0] in ("jax", "jaxlib", "xdeepfm_tpu")})))
""")


def test_jax_written_preprocess_loads_without_jax(criteo_file, tmp_path):
    df = jd.read_criteo_like(criteo_file)
    dfp, enc, scaler = jd.prepare_features(df, SPARSE, DENSE, fit_df=df)
    _, _, names = jd.build_feature_columns(dfp, SPARSE, DENSE)
    pkl = tmp_path / "preprocess.pkl"
    with open(pkl, "wb") as f:  # the payload of the JAX CLI's pandas route
        pickle.dump({"encoders": enc, "scaler": scaler, "sparse_features": SPARSE,
                     "dense_features": DENSE, "feature_names": names}, f)
    assert b"xdeepfm_tpu.data" in pkl.read_bytes()
    out = tmp_path / "ids.npz"
    proc = subprocess.run(
        [sys.executable, "-c", _SUBPROCESS, str(pkl), criteo_file, str(tmp_path / "w.npz"),
         str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    with np.load(out) as got:
        _equal_inputs({k: got[k] for k in got.files}, jd.build_model_input(dfp, names))


def test_log_writer_writes_the_jax_lines(tmp_path):
    logs = {"loss": 0.5, "auc": 0.75, "val_auc": 0.7, "sfg_loss": np.float32(1.25)}
    lines = {}
    for name, mod in (("jax", jcb), ("port", tcb)):
        w = mod.LogWriter(str(tmp_path / name), tensorboard=False)
        for epoch in range(2):
            w.on_epoch_end(epoch, logs)
        w.scalar("Eval/AUC", 0.625, 0)
        w.close()
        lines[name] = (tmp_path / name / "scalars.jsonl").read_text()
    assert lines["port"] == lines["jax"]
    assert json.loads(lines["port"].splitlines()[2]) == {
        "tag": "Validation/auc", "value": 0.7, "step": 0}


def test_profiling_trace_writes_a_trace_on_cpu(tmp_path):
    import torch

    with profiling.trace(str(tmp_path)):
        torch.ones(64).cumsum(0)
    files = os.listdir(tmp_path)
    assert files == ["trace_0.json"]
    assert json.loads((tmp_path / files[0]).read_text())["traceEvents"]
    timer = profiling.StepTimer()
    for _ in range(3):
        timer.tick()
    assert timer.summary()["steps"] == 2
