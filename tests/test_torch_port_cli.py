"""The port's training CLIs against the JAX package's, on the CPU.

The fixture is a copy of ``tests/test_cli.py``'s 400-row corpus (a
comma-separated header over tab-separated rows).  Each port CLI runs with
``--device cpu`` and ``test_cli.py``'s arguments (:37-43) and must write the
artifacts that file checks, with ``training_log`` ``data_info`` and
``training_config`` equal to the JAX CLI's on the same file.

End to end, the port's ``xdftrain`` starts from the JAX model's initial
weights (``from_jax_weights``; ``dnn_dropout`` is 0 by default) and must
reproduce the JAX ``xdftrain``'s per-epoch history and eval metrics within
``tests/test_torch_port_train.py``'s Adam tolerance (``OPT_TOL["adam"]``:
rtol 1e-4; fp32 sums in another order, magnified by Adam's division by
small second moments).
"""

import json
import os

import jax
import numpy as np
import pytest

from xdeepfm_tpu.cli import common as jcommon
from xdeepfm_tpu.cli import xdftrain as jx
from xdeepfm_tpu_torch import native
from xdeepfm_tpu_torch.cli import common as tcommon
from xdeepfm_tpu_torch.cli import xdftrain as tx

RTOL = 1e-4  # OPT_TOL["adam"][0] of tests/test_torch_port_train.py


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


def _common_args(criteo_file, out, mode="eval"):
    return [
        "--data_path", criteo_file, "--out_dir", out, "--mode", mode,
        "--epochs", "1", "--batch_size", "128", "--embedding_dim", "4",
        "--verbose", "0",
    ]


# (CLI module, extra arguments, artifacts): tests/test_cli.py's runs
CASES = {
    "eval": ("xdftrain", [], ["history.json", "preprocess.pkl", "training_log.json",
                              "xdeepfm_best.weights", "xdeepfm_weights.bin"]),
    "final": ("xdftrain", ["--mode", "final"], ["xdeepfm_full_weights.bin",
                                                "history_full.json", "training_log_full.json"]),
    "v1": ("xdftrain_v1", ["--test_size", "0.25", "--val_size", "0.25"],
           ["history.json", "preprocess.pkl", "training_log.json", "xdeepfm_v1_weights.bin"]),
    "attn_v2": ("xdftrain_attn", ["--model_version", "v2", "--cin_num_heads", "2"],
                ["history.json", "xdeepfm_attn_v2_weights.bin", "training_log.json"]),
    "pro_sfg": ("xdftrain_pro", ["--use_sfg", "--sfg_weight", "0.1", "--sfg_hidden_units",
                                 "16", "8"],
                ["history.json", "xdeepfm_pro_weights.bin", "training_log.json"]),
}


def _main(package, module):
    import importlib

    return importlib.import_module(f"{package}.cli.{module}").main


@pytest.fixture(scope="module")
def jax_logs(criteo_file, tmp_path_factory):
    """Each JAX CLI run once, on demand; the eval run records the JAX
    model's initial weights for the end-to-end comparison."""
    runs = {}

    def get(case):
        if case not in runs:
            module, extra, _ = CASES[case]
            out = str(tmp_path_factory.mktemp(f"jax_{case}"))
            argv = _common_args(criteo_file, out) + extra
            if case == "eval":
                init = {}

                def build(args, lin, dnn, final_mode=False):
                    model = jx.build_model(args, lin, dnn, final_mode)
                    init["weights"] = jax.tree.map(np.asarray, model.get_weights())
                    return model

                args = jx.parse_args(argv)
                runs[case] = (jcommon.run_eval(args, build, model_name="xdeepfm"), out, init)
            else:
                runs[case] = (_main("xdeepfm_tpu", module)(argv), out, None)
        return runs[case]

    return get


def _read_log(out, mode):
    name = "training_log_full.json" if mode == "final" else "training_log.json"
    with open(os.path.join(out, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_cli_matches_jax_artifacts(case, criteo_file, tmp_path, jax_logs):
    module, extra, artifacts = CASES[case]
    out = str(tmp_path / "out")
    log = _main("xdeepfm_tpu_torch", module)(
        _common_args(criteo_file, out) + extra + ["--device", "cpu"])
    for artifact in artifacts:
        assert os.path.exists(os.path.join(out, artifact)), artifact
    mode = "final" if case == "final" else "eval"
    saved = _read_log(out, mode)
    assert saved["mode"] == mode and saved["model_config"]["device"] == "cpu"
    want = _read_log(jax_logs(case)[1], mode)
    assert saved["data_info"] == want["data_info"]
    assert saved["training_config"] == want["training_config"]
    assert sorted(saved) == sorted(want)
    assert {k: v for k, v in saved["model_config"].items() if k != "device"} == {
        k: v for k, v in want["model_config"].items() if k != "device"}
    if mode == "eval":
        assert sorted(saved["results"]) == sorted(want["results"])
        assert sorted(saved["history"]) == sorted(want["history"])
    if case == "eval":
        assert log["data_info"]["train_samples"] == 360
    elif case == "v1":
        assert log["training_config"]["optimizer"] == "adagrad"
        assert 0.0 <= log["results"]["test_auc"] <= 1.0
    elif case == "pro_sfg":
        assert log["model_config"]["use_sfg"] is True and "sfg_loss" in log["history"]


def test_xdftrain_end_to_end_matches_jax(criteo_file, tmp_path, jax_logs):
    want, jax_out, init = jax_logs("eval")

    def build(args, lin, dnn, final_mode=False):
        model = tx.build_model(args, lin, dnn, final_mode)
        model.set_weights(init["weights"])
        return model

    out = str(tmp_path / "out")
    args = tx.parse_args(_common_args(criteo_file, out) + ["--device", "cpu"])
    got = tcommon.run_eval(args, build, model_name="xdeepfm")
    with open(os.path.join(out, "history.json")) as f, \
            open(os.path.join(jax_out, "history.json")) as g:
        hist, jhist = json.load(f), json.load(g)
    assert sorted(hist) == sorted(jhist)
    for k in jhist:
        np.testing.assert_allclose(hist[k], jhist[k], rtol=RTOL, atol=1e-6, err_msg=k)
    for k in ("eval_auc", "eval_logloss", "best_val_auc"):
        np.testing.assert_allclose(got["results"][k], want["results"][k], rtol=RTOL, err_msg=k)
    assert 0.0 <= got["results"]["eval_auc"] <= 1.0


@pytest.mark.parametrize("streaming", [False, True], ids=["bulk", "streaming"])
def test_native_route_runs_without_pandas_and_scores_back(streaming, criteo_file, tmp_path):
    """--use_native_parser: eval writes native_vocab.bin and a native
    preprocess.pkl; final with --test_path writes test_predictions.csv, which
    load_scorer(preprocess_path=...) reproduces on the same rows."""
    if not native.available():
        pytest.skip("needs g++ to build the native parser")
    from xdeepfm_tpu_torch.data import MinMaxScaler
    from xdeepfm_tpu_torch.native import NativeCriteoParser
    from xdeepfm_tpu_torch.serving import load_scorer

    flags = ["--use_native_parser", "--device", "cpu"] + (["--streaming"] if streaming else [])
    test39 = tmp_path / "test39.txt"
    with open(criteo_file) as f, open(test39, "w") as t:
        t.writelines("\t".join(line.rstrip("\n").split("\t")[1:]) + "\n"
                     for line in f.readlines()[1:101])
    ev = str(tmp_path / "eval")
    tx.main(_common_args(criteo_file, ev) + flags + ["--eval_path", criteo_file])
    out = str(tmp_path / "final")
    log = tx.main(_common_args(criteo_file, out, "final") + flags + ["--test_path", str(test39)])
    assert log["data_info"]["total_samples"] == 400
    for d, names in ((ev, ["native_vocab.bin", "preprocess.pkl", "xdeepfm_weights.bin"]),
                     (out, ["native_vocab.bin", "preprocess.pkl", "test_predictions.csv",
                            "xdeepfm_full_weights.bin", "history_full.json"])):
        for name in names:
            assert os.path.exists(os.path.join(d, name)), name
    with open(os.path.join(out, "test_predictions.csv")) as f:
        lines = f.read().splitlines()
    assert lines[0] == "predicted_ctr" and len(lines) == 101
    written = np.array([float(v) for v in lines[1:]])

    parser = NativeCriteoParser()
    parser.load_vocab(os.path.join(out, "native_vocab.bin"))
    vocab = parser.vocab_sizes()

    def build():
        from xdeepfm_tpu_torch.features import DenseFeat, SparseFeat

        cols = [SparseFeat(f"C{j + 1}", int(vocab[j]), 4) for j in range(26)] + [
            DenseFeat(f"I{j + 1}", 1) for j in range(13)]
        args = tx.parse_args(_common_args(criteo_file, out, "final") + flags)
        return tx.build_model(args, cols, cols, final_mode=True)

    scorer, pp = load_scorer(build, os.path.join(out, "xdeepfm_full_weights.bin"),
                             os.path.join(out, "preprocess.pkl"), batch_size=64)
    assert pp["native"] is True and isinstance(pp["scaler"], MinMaxScaler)
    _, dense, ids = parser.transform(str(test39), with_label=False)
    dense = pp["scaler"].transform(dense)
    x = {f"C{j + 1}": ids[:, j] for j in range(26)}
    x.update({f"I{j + 1}": dense[:, j] for j in range(13)})
    np.testing.assert_allclose(scorer.score(x)[:, 0], written, rtol=0, atol=1e-6)


def test_lazy_embedding_optimizer_raises(criteo_file, tmp_path):
    """Named for what it pinned before the lazy optimizer was ported, a
    raise.  Now: ``xdftrain --embedding_optimizer lazy`` (split gradient,
    packed layout) trains, its ``training_log`` has the JAX CLI's keys and
    configs on the same file, and from the JAX model's initial weights it
    reproduces the JAX CLI's per-epoch history and eval metrics within Adam's
    tolerance (``RTOL``)."""
    # the gradient named: the JAX CLI's "auto" is "split" only on one device
    lazy = ["--embedding_optimizer", "lazy", "--embedding_gradient", "split"]
    init = {}

    def jbuild(args, lin, dnn, final_mode=False):
        model = jx.build_model(args, lin, dnn, final_mode)
        assert model._packed_tables
        init["weights"] = jax.tree.map(np.asarray, model.get_weights())
        return model

    def tbuild(args, lin, dnn, final_mode=False):
        model = tx.build_model(args, lin, dnn, final_mode)
        assert model._lazy["split"] and model._lazy["packed"]
        model.set_weights(init["weights"])
        return model

    outs = [str(tmp_path / "jax"), str(tmp_path / "port")]
    want = jcommon.run_eval(jx.parse_args(_common_args(criteo_file, outs[0]) + lazy), jbuild,
                            model_name="xdeepfm")
    got = tcommon.run_eval(
        tx.parse_args(_common_args(criteo_file, outs[1]) + lazy + ["--device", "cpu"]), tbuild,
        model_name="xdeepfm")
    saved, jsaved = (_read_log(out, "eval") for out in outs[::-1])
    assert sorted(saved) == sorted(jsaved)
    for key in ("data_info", "training_config"):
        assert saved[key] == jsaved[key], key
    assert {k: v for k, v in saved["model_config"].items() if k != "device"} == {
        k: v for k, v in jsaved["model_config"].items() if k != "device"}
    hist, jhist = (json.load(open(os.path.join(out, "history.json"))) for out in outs[::-1])
    assert sorted(hist) == sorted(jhist)
    for k in jhist:
        np.testing.assert_allclose(hist[k], jhist[k], rtol=RTOL, atol=1e-6, err_msg=k)
    for k in ("eval_auc", "eval_logloss", "best_val_auc"):
        np.testing.assert_allclose(got["results"][k], want["results"][k], rtol=RTOL, err_msg=k)


def test_streaming_eval_requires_eval_path(criteo_file, tmp_path):
    with pytest.raises(SystemExit):
        tx.main(_common_args(criteo_file, str(tmp_path / "o")) + ["--device", "cpu",
                                                                 "--streaming"])


def test_pro_headerless_and_39col_test(tmp_path):
    """``tests/test_cli.py:327``: a headerless labeled train file with one
    non-numeric dense cell and a 39-column --test_path file both parse; an
    unlabeled file as --data_path is rejected."""
    from xdeepfm_tpu_torch.cli.xdftrain_pro import main

    rng = np.random.default_rng(3)
    train = tmp_path / "train_headerless.txt"
    with open(train, "w") as f:
        for i in range(300):
            dense = [f"{rng.uniform(0, 10):.2f}" for _ in range(13)]
            if i == 11:
                dense[5] = "n/a"  # pro coerces garbage dense to 0
            sparse = [f"c{rng.integers(0, 12)}" for _ in range(26)]
            label = int(rng.uniform() < 0.4)
            f.write("\t".join([str(label)] + dense + sparse) + "\n")
    test = tmp_path / "test39.txt"
    with open(test, "w") as f:
        for _ in range(40):
            dense = [f"{rng.uniform(0, 10):.2f}" for _ in range(13)]
            sparse = [f"c{rng.integers(0, 12)}" for _ in range(26)]
            f.write("\t".join(dense + sparse) + "\n")

    out = str(tmp_path / "out_pro_headerless")
    log = main(
        [
            "--data_path", str(train), "--test_path", str(test),
            "--out_dir", out, "--mode", "eval", "--epochs", "1",
            "--batch_size", "64", "--embedding_dim", "4", "--verbose", "0",
            "--sfg_hidden_units", "8", "--device", "cpu",
        ]
    )
    assert log["data_info"]["train_samples"] == 270
    with open(os.path.join(out, "test_predictions.csv")) as f:
        lines = f.read().splitlines()
    assert lines[0] == "predicted_ctr" and len(lines) == 41  # header + 40 rows
    assert all(0.0 < float(v) < 1.0 for v in lines[1:])

    with pytest.raises(ValueError):
        main(
            [
                "--data_path", str(test), "--out_dir",
                str(tmp_path / "bad"), "--mode", "eval", "--epochs", "1",
                "--batch_size", "64", "--verbose", "0", "--device", "cpu",
            ]
        )
