"""Shared training flow for the xdftrain CLIs (port of
``xdeepfm_tpu/cli/common.py``).

The reference duplicates ~700 LoC across four scripts (``xdftrain.py``,
``xdftrain_v1.py``, ``xdftrain_attn.py``, ``xdftrain_pro.py``); here the
eval/final flows (``xdftrain.py:302-704``) are implemented once and
parameterized by a model-construction callback.  Flags, defaults and artifacts
are the JAX CLIs': ``preprocess.pkl``, ``native_vocab.bin``,
``{model}_best.weights``, ``{model}_weights.bin``,
``{model}_full_weights.bin``, ``history.json``, ``history_full.json``,
``training_log.json`` (``training_log_full.json`` in final mode),
``test_predictions.csv`` and the ``LogWriter`` directory, with the same
``training_log`` keys.  What differs:

* ``--device`` defaults to ``"cuda"`` and goes to the model, which raises
  where no GPU is present; ``--device cpu`` runs on the CPU;
* the weights files hold the port's ``.npz`` (``BaseModel.save_weights``);
* pandas is imported only on the pandas routes, and ``test_predictions.csv``
  is written without it, so ``--use_native_parser`` runs end to end on a
  machine without pandas;
* final mode honours ``--use_native_parser`` and ``--test_path`` (the JAX
  CLI accepts both there and ignores them): the native route, and
  ``test_predictions.csv`` from the model trained on all the data;
* ``--embedding_optimizer lazy`` (or an ``auto`` that resolves to it) raises
  ``NotImplementedError`` at ``compile``: the row-sparse optimizer is not
  ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import random
import time
from datetime import datetime

import numpy as np

from ..callbacks import EarlyStopping, LogWriter, ModelCheckpoint
from ..data import (
    CRITEO_DENSE,
    CRITEO_SPARSE,
    build_feature_columns,
    build_model_input,
    prepare_features,
    read_criteo_like,
    read_criteo_test,
    train_test_split,
)
from ..features import DenseFeat, SparseFeat, get_feature_names
from ..metrics import log_loss, roc_auc_score


def set_seed(seed: int = 2025):
    random.seed(seed)
    np.random.seed(seed)


def base_arg_parser() -> argparse.ArgumentParser:
    """Flag surface of ``xdftrain.py:707-738``."""
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--eval_path", type=str, default=None)
    p.add_argument("--test_path", type=str, default=None)
    p.add_argument("--out_dir", type=str, default="./outputs_xdeepfm")
    p.add_argument("--mode", type=str, choices=["eval", "final"], default="eval")
    p.add_argument(
        "--device", type=str, default="cuda",
        help="torch device of the model ('cuda' raises where no GPU is present; "
        "'cpu' runs on the CPU)",
    )
    p.add_argument("--seed", type=int, default=2025)
    p.add_argument("--embedding_dim", type=int, default=10)
    p.add_argument("--l2_reg_embedding", type=float, default=1e-5)
    p.add_argument("--l2_reg_dnn", type=float, default=1e-5)
    p.add_argument("--dnn_dropout", type=float, default=0.0)
    p.add_argument("--learning_rate", type=float, default=0.001)
    p.add_argument(
        "--optimizer", type=str, default="adam",
        choices=["adam", "adagrad", "sgd"],
    )
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=4096)
    p.add_argument("--pred_batch_size", type=int, default=8192)
    p.add_argument("--val_size", type=float, default=0.1)
    p.add_argument("--use_early_stopping", action="store_true")
    p.add_argument("--patience", type=int, default=50)
    p.add_argument("--stratify", action="store_true")
    p.add_argument("--verbose", type=int, default=1, choices=[0, 1, 2])
    p.add_argument(
        "--use_native_parser", action="store_true",
        help="use the C++ criteo parser/encoder (native/criteo_parser.cpp, "
        "built with g++ at first use) for single-pass IO instead of pandas",
    )
    p.add_argument(
        "--steps_per_dispatch", type=int, default=8,
        help="accepted for the JAX CLI's flag surface, where it fuses steps "
        "into one XLA dispatch; here every step is its own launch sequence "
        "and the flag changes no result",
    )
    p.add_argument(
        "--embedding_optimizer", type=str, default="dense",
        choices=["dense", "lazy", "auto"],
        help="'lazy' = row-sparse table updates (not ported yet: raises); "
        "'auto' picks by table size (>=6M rows -> lazy)",
    )
    p.add_argument(
        "--embedding_gradient", type=str, default="auto",
        choices=["auto", "dense", "split"],
        help="lazy mode's gradient cut (accepted; the lazy mode is not ported)",
    )
    p.add_argument(
        "--embedding_layout", type=str, default="auto",
        choices=["auto", "packed", "flat"],
        help="lazy mode's table storage (accepted; 'packed' needs the lazy mode)",
    )
    p.add_argument(
        "--embedding_state_dtype", type=str, default="float32",
        choices=["float32", "bfloat16"],
        help="lazy mode's optimizer-state dtype ('bfloat16' needs the lazy mode)",
    )
    p.add_argument(
        "--streaming", action="store_true",
        help="out-of-core training: fit preprocessors in one streaming pass "
        "and train via fit_stream without loading the train file into "
        "memory; combine with --use_native_parser to stream through the "
        "C++ parser (eval mode requires --eval_path; batches stream in file "
        "order instead of shuffling)",
    )
    p.add_argument(
        "--stream_chunksize", type=int, default=200_000,
        help="rows per pandas chunk in --streaming mode",
    )
    p.add_argument(
        "--stream_shuffle_buffer", type=int, default=0,
        help="rows held in a streaming shuffle buffer (native --streaming "
        "mode): batches sample randomly from the buffer, approximating the "
        "in-memory path's global shuffle; 0 = file order",
    )
    return p


def _reader_opts(args):
    """Per-CLI reader variant: the pro CLI (``args.pro_reader``) uses the
    column-count-detecting reader (``xdftrain_pro.py:123-190``) and coerces
    non-numeric dense values to 0 (``xdftrain_pro.py:225-250``); the other
    CLIs keep the base reader.  Returns (require_label, coerce_dense)."""
    pro = bool(getattr(args, "pro_reader", False))
    return (True if pro else None), pro


def _load_labeled(path, name, require_label=None):
    import pandas as pd

    print(f"[INFO] Loading {name} data from: {path}")
    df = read_criteo_like(path, require_label=require_label)
    print(f"[DEBUG] {name} data shape: {df.shape}")
    df["label"] = pd.to_numeric(df["label"], errors="coerce")
    nan_count = int(df["label"].isna().sum())
    if nan_count > 0:
        print(f"[WARN] {nan_count} labels were NaN; treating them as 0")
    df["label"] = df["label"].fillna(0).astype("float32")
    pos_ratio = float((df["label"] == 1).sum() / len(df))
    print(f"[DEBUG] {name} positive ratio: {pos_ratio:.4f}")
    if pos_ratio == 0.0:
        print(
            "[ERROR] No positive labels in this file — training loss will be "
            "degenerate; verify the data format"
        )
    elif pos_ratio == 1.0:
        print("[ERROR] All labels are 1! Check data file format!")
    return df, pos_ratio


def _native_available(args) -> bool:
    """``--use_native_parser`` unless the parser cannot be built, which the
    JAX CLI reports and answers with the pandas route."""
    if not getattr(args, "use_native_parser", False):
        return False
    from .. import native

    if not native.available():
        print("[WARN] native parser unavailable; falling back to pandas")
        return False
    return True


def _native_columns(parser, embedding_dim):
    """Feature columns from the native parser's fitted vocab."""
    vocab = parser.vocab_sizes()
    cols = [
        SparseFeat(CRITEO_SPARSE[j], vocabulary_size=int(vocab[j]),
                   embedding_dim=embedding_dim)
        for j in range(26)
    ] + [DenseFeat(name, 1) for name in CRITEO_DENSE]
    return cols, get_feature_names(cols)


def _native_x(ids, dense):
    x = {CRITEO_SPARSE[j]: ids[:, j] for j in range(26)}
    x.update({CRITEO_DENSE[j]: dense[:, j] for j in range(13)})
    return x


def _native_test_x(parser, scaler, path):
    _, dense, ids = parser.transform(path, with_label=False)
    return _native_x(ids, scaler.transform(dense)), len(ids)


def _native_payload(scaler, feature_names):
    return {
        "native": True,
        "scaler": scaler,
        "sparse_features": list(CRITEO_SPARSE),
        "dense_features": list(CRITEO_DENSE),
        "feature_names": feature_names,
    }


def _pandas_payload(encoders, scaler, feature_names):
    return {
        "encoders": encoders,
        "scaler": scaler,
        "sparse_features": list(CRITEO_SPARSE),
        "dense_features": list(CRITEO_DENSE),
        "feature_names": feature_names,
    }


def _native_load_eval(args):
    """Native-parser fast path: parse+encode train/eval in C++, scale dense in
    numpy.  Encoder semantics identical to the pandas path (fit on train then
    eval extends the vocab == fit on the concatenation, first-appearance
    order), verified by tests."""
    from ..data import MinMaxScaler
    from ..native import NativeCriteoParser

    parser = NativeCriteoParser()
    labels_tr, dense_tr, ids_tr = parser.fit_transform(args.data_path)
    if args.eval_path:
        labels_ev, dense_ev, ids_ev = parser.fit_transform(args.eval_path)
    else:
        n = len(labels_tr)
        rng = np.random.default_rng(args.seed)
        n_test = int(round(n * args.val_size))
        test_idx = rng.permutation(n)[:n_test]
        mask = np.zeros(n, bool)
        mask[test_idx] = True
        labels_ev, dense_ev, ids_ev = labels_tr[mask], dense_tr[mask], ids_tr[mask]
        labels_tr, dense_tr, ids_tr = (
            labels_tr[~mask], dense_tr[~mask], ids_tr[~mask],
        )
    scaler = MinMaxScaler()
    scaler.fit(np.concatenate([dense_tr, dense_ev], axis=0))
    dense_tr = scaler.transform(dense_tr)
    dense_ev = scaler.transform(dense_ev)
    cols, feature_names = _native_columns(parser, args.embedding_dim)
    return (
        parser, scaler, cols, feature_names,
        _native_x(ids_tr, dense_tr), labels_tr[:, None],
        _native_x(ids_ev, dense_ev), labels_ev[:, None],
    )


def _write_predictions(out_dir, pred):
    """``test_predictions.csv``: the header ``predicted_ctr`` and one value a
    row (``repr`` of the float64 score, which reads back exactly)."""
    path = os.path.join(out_dir, "test_predictions.csv")
    with open(path, "w") as f:
        f.write("predicted_ctr\n")
        f.writelines(f"{float(v)!r}\n" for v in np.asarray(pred).reshape(-1))
    print(f"[INFO] Test predictions saved to: {path}")


def _begin(args, announce=True):
    """Seed, the output and LogWriter directories; returns (timestamp, the
    LogWriter directory, the start time)."""
    set_seed(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    tb_log_dir = os.path.join(args.out_dir, f"tensorboard_{timestamp}")
    os.makedirs(tb_log_dir, exist_ok=True)
    if announce:
        print(f"[INFO] TensorBoard logs: {tb_log_dir}")
    return timestamp, tb_log_dir, time.time()


def _model_config(args, extra_config):
    return dict(
        {
            "embedding_dim": args.embedding_dim,
            "l2_reg_embedding": args.l2_reg_embedding,
            "l2_reg_dnn": args.l2_reg_dnn,
            "dnn_dropout": args.dnn_dropout,
            "device": args.device,
        },
        **(extra_config or {}),
    )


def _dump(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, ensure_ascii=False, indent=2)


def run_eval(args, build_model, model_name="xdeepfm", extra_config=None):
    """``xdftrain.py:302-550``: train/validate/(test), best-ckpt reload, exact
    eval metrics, artifact persistence."""
    require_label, coerce_dense = _reader_opts(args)
    timestamp, tb_log_dir, start_time = _begin(args)

    sparse_features = list(CRITEO_SPARSE)
    dense_features = list(CRITEO_DENSE)
    target = "label"

    use_native = _native_available(args)
    streaming = getattr(args, "streaming", False)
    test_x = None
    n_test = 0
    stream_gen = None
    if streaming and not args.eval_path:
        raise SystemExit(
            "--streaming eval mode requires --eval_path (a random "
            "validation split would need the full train set in memory)"
        )
    if streaming and use_native:
        # out-of-core through the C++ parser: one streaming pass fits the
        # vocab + dense min/max; eval (small) parses in bulk and extends
        # both, matching the train+eval combined fit (xdftrain.py:372-383).
        from ..data import (
            extend_scaler,
            fit_preprocessors_streaming_native,
            iter_criteo_batches_native,
        )

        print(f"[INFO] Native streaming preprocessor fit: {args.data_path}")
        parser, scaler, stats = fit_preprocessors_streaming_native(
            args.data_path
        )
        train_pos_ratio = stats["pos_ratio"]
        print(
            f"[DEBUG] Train samples: {stats['n']}, positive ratio: "
            f"{train_pos_ratio:.4f}"
        )
        labels_ev, dense_ev, ids_ev = parser.fit_transform(args.eval_path)
        extend_scaler(scaler, dense_ev)
        cols, feature_names = _native_columns(parser, args.embedding_dim)
        linear_cols = dnn_cols = cols
        eval_x = _native_x(ids_ev, scaler.transform(dense_ev))
        y_eval = labels_ev[:, None]
        n_train = stats["n"]
        if args.test_path:
            test_x, n_test = _native_test_x(parser, scaler, args.test_path)

        def stream_gen(epoch):
            return iter_criteo_batches_native(
                args.data_path, parser, scaler, args.batch_size,
                shuffle_buffer=getattr(args, "stream_shuffle_buffer", 0),
                seed=args.seed + epoch,
            )

        preprocess_payload = _native_payload(scaler, feature_names)
    elif streaming:
        # out-of-core: one streaming pass fits the preprocessors; the eval
        # set (small) loads in memory for exact pooled metrics; train batches
        # stream from disk each epoch (file order, no shuffle).
        import pandas as pd

        from ..data import (
            extend_preprocessors,
            feature_columns_from_encoders,
            fit_preprocessors_streaming,
            iter_criteo_batches,
        )

        print(f"[INFO] Streaming preprocessor fit over: {args.data_path}")
        encoders, scaler, stats = fit_preprocessors_streaming(
            args.data_path, sparse_features, dense_features,
            chunksize=args.stream_chunksize, coerce_dense=coerce_dense,
        )
        if stats["label_nan"] > 0:
            print(
                f"[WARN] {stats['label_nan']} labels were NaN; treating "
                "them as 0"
            )
        train_pos_ratio = stats["pos_ratio"]
        print(
            f"[DEBUG] Train samples: {stats['n']}, positive ratio: "
            f"{train_pos_ratio:.4f}"
        )
        eval_df, _ = _load_labeled(args.eval_path, "Eval",
                                   require_label=require_label)
        if coerce_dense:
            # pro-variant cleaning BEFORE extend_preprocessors' astype —
            # the bulk path coerces inside prepare_features
            for feat in dense_features:
                eval_df[feat] = pd.to_numeric(eval_df[feat], errors="coerce")
        # encoders fit on train+eval combined, as in the bulk path
        # (xdftrain.py:372-383)
        extend_preprocessors(
            encoders, scaler, eval_df, sparse_features, dense_features
        )
        linear_cols, dnn_cols, feature_names = feature_columns_from_encoders(
            encoders, sparse_features, dense_features,
            embedding_dim=args.embedding_dim,
        )
        eval_dfp, _, _ = prepare_features(
            eval_df, sparse_features, dense_features, encoders=encoders,
            scaler=scaler, coerce_dense=coerce_dense,
        )
        eval_x = build_model_input(eval_dfp, feature_names)
        y_eval = eval_dfp[[target]].values
        n_train = stats["n"]
        if args.test_path:
            print(f"[INFO] Loading test data from: {args.test_path}")
            test_df = read_criteo_test(
                args.test_path, sparse_features, dense_features
            )
            test_dfp, _, _ = prepare_features(
                test_df, sparse_features, dense_features, encoders=encoders,
                scaler=scaler, coerce_dense=coerce_dense,
            )
            test_x = build_model_input(test_dfp, feature_names)
            n_test = len(test_dfp)

        def stream_gen(epoch):
            return iter_criteo_batches(
                args.data_path, sparse_features, dense_features, encoders,
                scaler, args.batch_size, chunksize=args.stream_chunksize,
                coerce_dense=coerce_dense,
            )

        preprocess_payload = _pandas_payload(encoders, scaler, feature_names)
    elif use_native:
        print("[INFO] Using native C++ criteo parser")
        (
            parser, scaler, cols, feature_names,
            train_x, y_train, eval_x, y_eval,
        ) = _native_load_eval(args)
        linear_cols = dnn_cols = cols
        train_pos_ratio = float((y_train == 1).mean())
        if args.test_path:
            test_x, n_test = _native_test_x(parser, scaler, args.test_path)
        preprocess_payload = _native_payload(scaler, feature_names)
    else:
        import pandas as pd

        train_df, train_pos_ratio = _load_labeled(
            args.data_path, "Train", require_label=require_label
        )
        if args.eval_path:
            eval_df, _ = _load_labeled(args.eval_path, "Eval",
                                       require_label=require_label)
        else:
            print(
                f"[INFO] No eval_path provided, splitting "
                f"{args.val_size*100:.0f}% from train data for validation"
            )
            train_df, eval_df = train_test_split(
                train_df, test_size=args.val_size, random_state=args.seed,
                stratify=train_df[target] if args.stratify else None,
            )
            print(
                f"[DEBUG] After split - Train: {len(train_df)}, "
                f"Eval: {len(eval_df)}"
            )

        test_df = None
        if args.test_path:
            print(f"[INFO] Loading test data from: {args.test_path}")
            test_df = read_criteo_test(
                args.test_path, sparse_features, dense_features
            )

        # fit encoders on train+eval combined (xdftrain.py:372-383)
        all_labeled_df = pd.concat([train_df, eval_df], axis=0, ignore_index=True)
        all_labeled_df, encoders, scaler = prepare_features(
            all_labeled_df, sparse_features, dense_features,
            fit_df=all_labeled_df, coerce_dense=coerce_dense,
        )
        train_dfp = all_labeled_df.iloc[: len(train_df)].copy()
        eval_dfp = all_labeled_df.iloc[len(train_df) :].copy()
        if test_df is not None:
            test_dfp, _, _ = prepare_features(
                test_df, sparse_features, dense_features, encoders=encoders,
                scaler=scaler, coerce_dense=coerce_dense,
            )

        linear_cols, dnn_cols, feature_names = build_feature_columns(
            all_labeled_df, sparse_features, dense_features,
            embedding_dim=args.embedding_dim,
        )
        train_x = build_model_input(train_dfp, feature_names)
        eval_x = build_model_input(eval_dfp, feature_names)
        y_train = train_dfp[[target]].values
        y_eval = eval_dfp[[target]].values
        if test_df is not None:
            test_x = build_model_input(test_dfp, feature_names)
            n_test = len(test_dfp)
        preprocess_payload = _pandas_payload(encoders, scaler, feature_names)

    model = build_model(args, linear_cols, dnn_cols)

    ckpt_path = os.path.join(args.out_dir, f"{model_name}_best.weights")
    callbacks = [
        LogWriter(log_dir=tb_log_dir),
        ModelCheckpoint(
            filepath=ckpt_path, monitor="val_auc", save_best_only=True,
            save_weights_only=True, mode="max", verbose=1,
        ),
    ]
    if args.use_early_stopping:
        print(f"[INFO] Early stopping enabled with patience={args.patience}")
        callbacks.insert(
            1,
            EarlyStopping(
                monitor="val_auc", patience=args.patience, mode="max", verbose=1
            ),
        )
    else:
        print(
            f"[INFO] Early stopping disabled - will train for full "
            f"{args.epochs} epochs"
        )

    print("\n[INFO] Starting training...")
    if stream_gen is not None:
        history = model.fit_stream(
            stream_gen, epochs=args.epochs, verbose=args.verbose,
            validation_data=(eval_x, y_eval), callbacks=callbacks,
            steps_per_dispatch=getattr(args, "steps_per_dispatch", 1),
        )
    else:
        n_train = len(y_train)
        history = model.fit(
            train_x, y_train, batch_size=args.batch_size, epochs=args.epochs,
            verbose=args.verbose, validation_data=(eval_x, y_eval),
            shuffle=True, callbacks=callbacks,
            steps_per_dispatch=getattr(args, "steps_per_dispatch", 1),
        )

    if os.path.exists(ckpt_path):
        model.load_weights(ckpt_path)

    eval_pred = model.predict(eval_x, batch_size=args.pred_batch_size)
    eval_logloss = log_loss(y_eval, eval_pred)
    eval_auc = roc_auc_score(y_eval, eval_pred)
    training_time = time.time() - start_time
    print(f"\n[Eval] eval LogLoss = {eval_logloss:.6f}")
    print(f"[Eval] eval AUC     = {eval_auc:.6f}")
    print(
        f"[Eval] Training time: {training_time:.2f} seconds "
        f"({training_time/60:.2f} minutes)"
    )

    if test_x is not None:
        print(f"\n[INFO] Running inference on test data ({n_test} samples)...")
        _write_predictions(
            args.out_dir, model.predict(test_x, batch_size=args.pred_batch_size)
        )

    writer = LogWriter(log_dir=tb_log_dir)
    writer.scalar("Eval/LogLoss", eval_logloss, 0)
    writer.scalar("Eval/AUC", eval_auc, 0)
    writer.text("Model/Config", str(vars(args)), 0)
    writer.close()

    with open(os.path.join(args.out_dir, "preprocess.pkl"), "wb") as f:
        pickle.dump(preprocess_payload, f)
    if use_native:
        # the native encoder vocab serializes separately (binary hash->id maps)
        parser.save_vocab(os.path.join(args.out_dir, "native_vocab.bin"))
    model.save_weights(os.path.join(args.out_dir, f"{model_name}_weights.bin"))
    _dump(os.path.join(args.out_dir, "history.json"), history.history)

    training_log = {
        "mode": "eval",
        "timestamp": timestamp,
        "training_time_seconds": training_time,
        "data_info": {
            "train_path": args.data_path,
            "eval_path": args.eval_path,
            "test_path": args.test_path,
            "train_samples": n_train,
            "eval_samples": len(y_eval),
            "test_samples": n_test,
            "train_positive_ratio": train_pos_ratio,
        },
        "model_config": _model_config(args, extra_config),
        "training_config": {
            "epochs": args.epochs,
            "batch_size": args.batch_size,
            "use_early_stopping": args.use_early_stopping,
            "patience": args.patience,
            "seed": args.seed,
            "learning_rate": args.learning_rate,
            "optimizer": args.optimizer,
        },
        "results": {
            "eval_logloss": float(eval_logloss),
            "eval_auc": float(eval_auc),
            "best_val_auc": float(max(history.history.get("val_auc", [0])))
            if history.history
            else None,
        },
        "history": history.history,
        "tensorboard_log_dir": tb_log_dir,
    }
    _dump(os.path.join(args.out_dir, "training_log.json"), training_log)
    print("\n[INFO] training completed! results saved to", args.out_dir)
    return training_log


def run_eval_v1(args, build_model, model_name="xdeepfm_v1", extra_config=None):
    """v1 eval flow (``xdftrain_v1.py:284-447``): in-file 3-way
    train/val/test split of ``--data_path`` (``xdftrain_v1.py:322-330``),
    preprocessors and feature columns fit on the TRAIN split only
    (``xdftrain_v1.py:333-346``), validation drives checkpointing/early
    stopping, and the reported metrics come from the held-out TEST split
    (``xdftrain_v1.py:402-411``).  pandas route only, as in the JAX CLI."""
    require_label, coerce_dense = _reader_opts(args)
    timestamp, tb_log_dir, start_time = _begin(args)

    sparse_features = list(CRITEO_SPARSE)
    dense_features = list(CRITEO_DENSE)
    target = "label"

    df, pos_ratio = _load_labeled(args.data_path, "Full",
                                  require_label=require_label)
    n_total = len(df)
    stratify = df[target] if args.stratify else None
    train_df, test_df = train_test_split(
        df, test_size=args.test_size, random_state=args.seed,
        stratify=stratify,
    )
    train_df, val_df = train_test_split(
        train_df, test_size=args.val_size, random_state=args.seed,
        stratify=train_df[target] if args.stratify else None,
    )
    print(
        f"[DEBUG] 3-way split - Train: {len(train_df)}, Val: {len(val_df)}, "
        f"Test: {len(test_df)}"
    )

    # fit on train only (xdftrain_v1.py:333-342) — unseen val/test ids map
    # to the SafeLabelEncoder's unknown bucket
    train_dfp, encoders, scaler = prepare_features(
        train_df, sparse_features, dense_features, fit_df=train_df,
        coerce_dense=coerce_dense,
    )
    val_dfp, _, _ = prepare_features(
        val_df, sparse_features, dense_features, encoders=encoders,
        scaler=scaler, coerce_dense=coerce_dense,
    )
    test_dfp, _, _ = prepare_features(
        test_df, sparse_features, dense_features, encoders=encoders,
        scaler=scaler, coerce_dense=coerce_dense,
    )

    # vocab from train only (xdftrain_v1.py:345-346)
    linear_cols, dnn_cols, feature_names = build_feature_columns(
        train_dfp, sparse_features, dense_features,
        embedding_dim=args.embedding_dim,
    )

    train_x = build_model_input(train_dfp, feature_names)
    val_x = build_model_input(val_dfp, feature_names)
    test_x = build_model_input(test_dfp, feature_names)
    y_train = train_dfp[[target]].values
    y_val = val_dfp[[target]].values
    y_test = test_dfp[[target]].values

    model = build_model(args, linear_cols, dnn_cols)

    ckpt_path = os.path.join(args.out_dir, f"{model_name}_best.weights")
    # v1 always runs EarlyStopping (xdftrain_v1.py:365-377)
    callbacks = [
        LogWriter(log_dir=tb_log_dir),
        EarlyStopping(
            monitor="val_auc", patience=args.patience, mode="max", verbose=1
        ),
        ModelCheckpoint(
            filepath=ckpt_path, monitor="val_auc", save_best_only=True,
            save_weights_only=True, mode="max", verbose=1,
        ),
    ]

    print("\n[INFO] Starting training...")
    history = model.fit(
        train_x, y_train, batch_size=args.batch_size, epochs=args.epochs,
        verbose=args.verbose, validation_data=(val_x, y_val), shuffle=True,
        callbacks=callbacks,
        steps_per_dispatch=getattr(args, "steps_per_dispatch", 1),
    )

    if os.path.exists(ckpt_path):
        model.load_weights(ckpt_path)

    test_pred = model.predict(test_x, batch_size=args.pred_batch_size)
    test_logloss = log_loss(y_test, test_pred)
    test_auc = roc_auc_score(y_test, test_pred)
    training_time = time.time() - start_time
    print(f"\n[Eval] test LogLoss = {test_logloss:.6f}")
    print(f"[Eval] test AUC     = {test_auc:.6f}")
    print(
        f"[Eval] Training time: {training_time:.2f} seconds "
        f"({training_time/60:.2f} minutes)"
    )

    writer = LogWriter(log_dir=tb_log_dir)
    writer.scalar("Test/LogLoss", test_logloss, 0)
    writer.scalar("Test/AUC", test_auc, 0)
    writer.text("Model/Config", str(vars(args)), 0)
    writer.close()

    with open(os.path.join(args.out_dir, "preprocess.pkl"), "wb") as f:
        pickle.dump(_pandas_payload(encoders, scaler, feature_names), f)
    model.save_weights(os.path.join(args.out_dir, f"{model_name}_weights.bin"))
    _dump(os.path.join(args.out_dir, "history.json"), history.history)

    training_log = {
        "mode": "eval",
        "timestamp": timestamp,
        "training_time_seconds": training_time,
        "data_info": {
            "data_path": args.data_path,
            "total_samples": n_total,
            "train_samples": len(train_dfp),
            "val_samples": len(val_dfp),
            "test_samples": len(test_dfp),
            "positive_ratio": pos_ratio,
        },
        "model_config": _model_config(args, extra_config),
        "training_config": {
            "epochs": args.epochs,
            "batch_size": args.batch_size,
            "test_size": args.test_size,
            "val_size": args.val_size,
            "patience": args.patience,
            "seed": args.seed,
            "learning_rate": args.learning_rate,
            "optimizer": args.optimizer,
        },
        "results": {
            "test_logloss": float(test_logloss),
            "test_auc": float(test_auc),
            "best_val_auc": float(max(history.history.get("val_auc", [0])))
            if history.history
            else None,
        },
        "history": history.history,
        "tensorboard_log_dir": tb_log_dir,
    }
    _dump(os.path.join(args.out_dir, "training_log.json"), training_log)
    print("\n[INFO] training completed! results saved to", args.out_dir)
    return training_log


def run_final(args, build_model, model_name="xdeepfm", extra_config=None):
    """``xdftrain.py:553-704``: fit on 100% of the data, metrics disabled.
    Beyond the JAX CLI, ``--use_native_parser`` takes the native route and
    ``--test_path`` writes ``test_predictions.csv``."""
    require_label, coerce_dense = _reader_opts(args)
    timestamp, tb_log_dir, start_time = _begin(args, announce=False)

    sparse_features = list(CRITEO_SPARSE)
    dense_features = list(CRITEO_DENSE)
    streaming = getattr(args, "streaming", False)
    use_native = _native_available(args)
    test_x = None
    if use_native:
        from ..data import (
            MinMaxScaler,
            fit_preprocessors_streaming_native,
            iter_criteo_batches_native,
        )
        from ..native import NativeCriteoParser

        if streaming:
            print(f"[INFO] Native streaming preprocessor fit: {args.data_path}")
            parser, scaler, stats = fit_preprocessors_streaming_native(args.data_path)
            pos_ratio, n_full = stats["pos_ratio"], stats["n"]

            def stream_gen(epoch):
                return iter_criteo_batches_native(
                    args.data_path, parser, scaler, args.batch_size,
                    shuffle_buffer=getattr(args, "stream_shuffle_buffer", 0),
                    seed=args.seed + epoch,
                )
        else:
            print("[INFO] Using native C++ criteo parser")
            parser = NativeCriteoParser()
            labels, dense, ids = parser.fit_transform(args.data_path)
            scaler = MinMaxScaler().fit(dense)
            x_full = _native_x(ids, scaler.transform(dense))
            y_full = labels[:, None]
            pos_ratio, n_full = float((labels == 1).mean()), len(labels)
        cols, feature_names = _native_columns(parser, args.embedding_dim)
        linear_cols = dnn_cols = cols
        if args.test_path:
            test_x, _ = _native_test_x(parser, scaler, args.test_path)
        preprocess_payload = _native_payload(scaler, feature_names)
    elif streaming:
        from ..data import (
            feature_columns_from_encoders,
            fit_preprocessors_streaming,
            iter_criteo_batches,
        )

        print(f"[INFO] Streaming preprocessor fit over: {args.data_path}")
        encoders, scaler, stats = fit_preprocessors_streaming(
            args.data_path, sparse_features, dense_features,
            chunksize=args.stream_chunksize, coerce_dense=coerce_dense,
        )
        pos_ratio = stats["pos_ratio"]
        n_full = stats["n"]
        linear_cols, dnn_cols, feature_names = feature_columns_from_encoders(
            encoders, sparse_features, dense_features,
            embedding_dim=args.embedding_dim,
        )

        def stream_gen(epoch):
            return iter_criteo_batches(
                args.data_path, sparse_features, dense_features, encoders,
                scaler, args.batch_size, chunksize=args.stream_chunksize,
                coerce_dense=coerce_dense,
            )
    else:
        df, pos_ratio = _load_labeled(args.data_path, "Full",
                                      require_label=require_label)
        df, encoders, scaler = prepare_features(
            df, sparse_features, dense_features, fit_df=df,
            coerce_dense=coerce_dense,
        )
        linear_cols, dnn_cols, feature_names = build_feature_columns(
            df, sparse_features, dense_features,
            embedding_dim=args.embedding_dim,
        )
        x_full = build_model_input(df, feature_names)
        y_full = df[["label"]].values
        n_full = len(df)
    if not use_native:
        if args.test_path:
            print(f"[INFO] Loading test data from: {args.test_path}")
            test_dfp, _, _ = prepare_features(
                read_criteo_test(args.test_path, sparse_features, dense_features),
                sparse_features, dense_features, encoders=encoders,
                scaler=scaler, coerce_dense=coerce_dense,
            )
            test_x = build_model_input(test_dfp, feature_names)
        preprocess_payload = _pandas_payload(encoders, scaler, feature_names)

    # final mode: metrics=[] to dodge single-class batch failures
    # (xdftrain.py:609-623)
    model = build_model(args, linear_cols, dnn_cols, final_mode=True)

    callbacks = [LogWriter(log_dir=tb_log_dir)]
    if streaming:
        history = model.fit_stream(
            stream_gen, epochs=args.epochs, verbose=args.verbose,
            callbacks=callbacks,
            steps_per_dispatch=getattr(args, "steps_per_dispatch", 1),
        )
    else:
        history = model.fit(
            x_full, y_full, batch_size=args.batch_size, epochs=args.epochs,
            verbose=args.verbose, validation_split=0.0, shuffle=True,
            callbacks=callbacks,
            steps_per_dispatch=getattr(args, "steps_per_dispatch", 1),
        )
    training_time = time.time() - start_time
    print(
        f"\n[Final] Training time: {training_time:.2f} seconds "
        f"({training_time/60:.2f} minutes)"
    )
    if test_x is not None:
        _write_predictions(
            args.out_dir, model.predict(test_x, batch_size=args.pred_batch_size)
        )

    with open(os.path.join(args.out_dir, "preprocess.pkl"), "wb") as f:
        pickle.dump(preprocess_payload, f)
    if use_native:
        parser.save_vocab(os.path.join(args.out_dir, "native_vocab.bin"))
    model.save_weights(
        os.path.join(args.out_dir, f"{model_name}_full_weights.bin")
    )
    _dump(os.path.join(args.out_dir, "history_full.json"), history.history)
    training_log = {
        "mode": "final",
        "timestamp": timestamp,
        "training_time_seconds": training_time,
        "data_info": {
            "data_path": args.data_path,
            "total_samples": n_full,
            "positive_ratio": pos_ratio,
        },
        "model_config": _model_config(args, extra_config),
        "training_config": {
            "epochs": args.epochs,
            "batch_size": args.batch_size,
            "seed": args.seed,
            "learning_rate": args.learning_rate,
            "optimizer": args.optimizer,
        },
        "history": history.history,
        "tensorboard_log_dir": tb_log_dir,
    }
    _dump(os.path.join(args.out_dir, "training_log_full.json"), training_log)
    print("\n[INFO] training completed! results saved to", args.out_dir)
    return training_log
