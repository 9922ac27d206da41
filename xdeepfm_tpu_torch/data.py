"""Criteo-style data pipeline (port of ``xdeepfm_tpu/data.py``; reference
``xdftrain.py:100-299``).

The port keeps its own copy of the JAX package's numpy/pandas pipeline, over
its own ``features.py``, so that it imports nothing of ``xdeepfm_tpu``.
Readers sniff mixed header/data separators; SafeLabelEncoder maps known
categories to 1..N and unknown to 0 (fit on train only); MinMaxScaler scales
dense features to [0, 1] natively (numpy), with sklearn's zero-range guard.
pandas is imported inside the functions that need it, so the native C++
parser's route (``native.py``, the ``*_native`` functions) runs without it.
``SafeLabelEncoder`` and ``MinMaxScaler`` keep the JAX classes' attribute
names (``mapping``, ``unk``, ``_index``, ``_int_index``, ``data_min_``,
``data_max_``), so a ``preprocess.pkl`` written by either package loads
into these classes (``serving.load_scorer``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .features import DenseFeat, SparseFeat, get_feature_names

CRITEO_SPARSE = [f"C{i}" for i in range(1, 27)]
CRITEO_DENSE = [f"I{i}" for i in range(1, 14)]
CRITEO_COLUMNS = ["label"] + CRITEO_DENSE + CRITEO_SPARSE


def detect_sep(path: str) -> str:
    """Header and data may use different separators (``xdftrain.py:107-123``)."""
    with open(path, "r", encoding="utf-8", errors="ignore") as f:
        header_line = f.readline()
        data_line = f.readline()
    if data_line:
        if "\t" in data_line:
            return "\t"
        elif "," in data_line:
            return ","
    return "\t" if ("\t" in header_line and "," not in header_line) else ","


def _read_csv_fast(path, sep, names=None, skiprows=0, header="infer"):
    """pd.read_csv preferring the pyarrow engine (faster than the C engine),
    falling back transparently when unavailable or unsupported."""
    import pandas as pd

    kwargs = dict(sep=sep)
    if names is not None:
        kwargs.update(header=None, names=names)
    elif header != "infer":
        kwargs.update(header=header)
    if skiprows:
        kwargs.update(skiprows=skiprows)
    try:
        return pd.read_csv(path, engine="pyarrow", **kwargs)
    except (ImportError, ValueError, TypeError):
        return pd.read_csv(path, **kwargs)


def read_criteo_like(path: str, require_label: Optional[bool] = None):
    """Robust Criteo reader (``xdftrain.py:125-162``): handles tab/comma and
    mixed header/data separators; columns label, I1..I13, C1..C26.

    ``require_label=None`` keeps the base CLI variant above (the file is
    assumed labeled).  Passing True/False selects the pro CLI variant
    (``xdftrain_pro.py:123-190``): the data row's column count decides the
    schema — 40 columns = labeled, 39 = unlabeled (a dummy ``label`` column
    of zeros is injected, or ``ValueError`` when ``require_label=True``);
    any other count falls back to checking the header for ``label``.
    """
    with open(path, "r", encoding="utf-8", errors="ignore") as f:
        header_line = f.readline().strip()
        data_line = f.readline().strip()
    header_sep = "\t" if ("\t" in header_line and "," not in header_line) else ","
    data_sep = "\t" if "\t" in data_line else ","

    has_label = True
    if require_label is not None:
        num_cols = len(data_line.split(data_sep))
        print(f"[DEBUG] {path}: first data row has {num_cols} columns")
        if num_cols == len(CRITEO_COLUMNS):  # 40 = label + 13 dense + 26 sparse
            has_label = True
        elif num_cols == len(CRITEO_COLUMNS) - 1:  # 39 = no label
            has_label = False
            if require_label:
                print(
                    f"[ERROR] {path} has 39 columns (unlabeled); labeled "
                    "data is required here — unlabeled files go through "
                    "--test_path"
                )
                raise ValueError(
                    f"a label column is required here, but {path} carries "
                    "just the 39 feature columns"
                )
        else:
            has_label = "label" in header_line.split(header_sep)
            print(
                f"[WARN] Unexpected column count: {num_cols}, "
                f"has_label={has_label}"
            )
    expected = CRITEO_COLUMNS if has_label else CRITEO_DENSE + CRITEO_SPARSE

    df = None
    if header_sep != data_sep:
        print(
            f"[WARN] separator mismatch: header delimited by {header_sep!r}, "
            f"rows by {data_sep!r} — re-reading with the row separator"
        )
        header_cols = header_line.split(header_sep)
        if all(c in header_cols for c in expected):
            df = _read_csv_fast(path, data_sep, names=expected, skiprows=1)
    if df is None:
        df = _read_csv_fast(path, data_sep)
        if not all(c in df.columns for c in expected):
            # a header that merely MISMATCHES (e.g. 'Label' capitalized, or
            # arbitrary column names) must not be ingested as a data row on
            # the names= re-read: recognize known header tokens under EITHER
            # separator, and otherwise treat a first row whose dense fields
            # all fail numeric parsing as a header
            header_tokens = set(header_line.split(data_sep)) | set(
                header_line.split(header_sep)
            )
            headerish = bool(header_tokens & {"label", "Label", "I1", "C1"})
            if not headerish and header_line:
                def _numericish(tok):
                    if tok == "":
                        return True  # missing dense values are common
                    try:
                        float(tok)
                        return True
                    except ValueError:
                        return False

                first_fields = header_line.split(data_sep)
                probe = first_fields[1:14] if len(first_fields) >= 14 else []
                headerish = bool(probe) and not any(
                    _numericish(t) for t in probe
                )
            df = _read_csv_fast(
                path, data_sep, names=expected,
                skiprows=1 if headerish else 0,
            )
    if not has_label and "label" not in df.columns:
        df.insert(0, "label", 0)
    return df


def read_criteo_test(path: str, sparse_features, dense_features):
    """Unlabeled 39-column test reader (``xdftrain.py:292-299``)."""
    feature_cols = list(dense_features) + list(sparse_features)
    return _read_csv_fast(path, "\t", names=feature_cols)


@dataclasses.dataclass
class SafeLabelEncoder:
    """Fit on train only; unknown -> 0, known -> 1..N (``xdftrain.py:165-185``)."""

    mapping: Dict[str, int]
    unk: int = 0

    @staticmethod
    def _as_str(series):
        """Canonical string form: INTEGRAL floats render without the '.0'
        suffix, so the same raw value encodes identically whether pandas
        typed a chunk int64 or (because a null appeared in it) float64 —
        otherwise a NaN-bearing transform chunk string-izes '123' as
        '123.0' and every known value silently encodes to unknown 0."""
        dt = getattr(series, "dtype", None)
        if dt is not None and dt.kind == "f":
            v = series.to_numpy()
            integral = np.isfinite(v) & (np.floor(v) == v) & (np.abs(v) < 2**62)
            s = series.astype(str).to_numpy(dtype=object)
            if integral.any():
                s[integral] = v[integral].astype(np.int64).astype(str)
            import pandas as pd

            return pd.Series(s, index=series.index)
        return series.astype(str)

    @staticmethod
    def fit(series) -> "SafeLabelEncoder":
        import pandas as pd

        uniq = pd.Series(SafeLabelEncoder._as_str(series).unique())
        mapping = {v: i + 1 for i, v in enumerate(uniq.tolist())}
        return SafeLabelEncoder(mapping=mapping, unk=0)

    def transform(self, series) -> np.ndarray:
        import pandas as pd

        # Categorical codes instead of a per-element dict map (~10x faster on
        # the streaming hot path).  mapping preserves insertion order with
        # values 1..N, so categories sorted by value reproduce it exactly:
        # known -> 1..N, unknown -> code -1 -> +1 -> 0.
        if getattr(self, "_index", None) is None or len(
            self._index
        ) != len(self.mapping):
            cats = [k for k, _ in sorted(self.mapping.items(),
                                         key=lambda kv: kv[1])]
            self._index = pd.Index(cats)
            # integer fast path: when every key is a canonical int string,
            # integer-typed columns can skip the astype(str) pass entirely.
            self._int_index = None
            try:
                icats = [int(k) for k in cats]
                if all(str(i) == k for i, k in zip(icats, cats)):
                    self._int_index = pd.Index(icats)
            except ValueError:
                pass
        if (getattr(series, "dtype", None) is not None
                and series.dtype.kind in "iu"
                and self._int_index is not None):
            codes = self._int_index.get_indexer(series)
        else:
            codes = self._index.get_indexer(self._as_str(series))
        out = codes.astype("int64") + 1
        if self.unk != 0:
            out = np.where(codes < 0, self.unk, out)
        return out


@dataclasses.dataclass
class MinMaxScaler:
    """Native [0,1] min-max scaler with sklearn's zero-range guard."""

    data_min_: Optional[np.ndarray] = None
    data_max_: Optional[np.ndarray] = None

    def fit(self, X):
        X = np.asarray(X, dtype=np.float64)
        self.data_min_ = np.nanmin(X, axis=0)
        self.data_max_ = np.nanmax(X, axis=0)
        return self

    def transform(self, X):
        # float32 math on float32 inputs (the streaming hot path — a float64
        # round-trip on 256k-row blocks cost ~20 ms/batch); float64 inputs
        # keep full precision.  Same result to fp32 rounding either way.
        X = np.asarray(X)
        if X.dtype != np.float32:
            X = X.astype(np.float64)
        rng = self.data_max_ - self.data_min_
        scale = np.where(rng == 0, 1.0, rng)
        lo = self.data_min_.astype(X.dtype)
        return ((X - lo) / scale.astype(X.dtype)).astype(np.float32)

    def fit_transform(self, X):
        return self.fit(X).transform(X)


def prepare_features(
    df,
    sparse_features: List[str],
    dense_features: List[str],
    fit_df=None,
    encoders: Optional[Dict[str, SafeLabelEncoder]] = None,
    scaler: Optional[MinMaxScaler] = None,
    coerce_dense: bool = False,
):
    """fillna + encode + scale (``xdftrain.py:192-237``).  If fit_df is given,
    fit encoders/scaler on it; else use the provided ones.

    ``coerce_dense=True`` is the pro CLI variant
    (``xdftrain_pro.py:225-250``): dense columns are first run through
    ``pd.to_numeric(errors='coerce').fillna(0)`` so non-numeric garbage in a
    numeric field becomes 0 instead of raising on the astype below.
    """
    import pandas as pd

    def _clean_dense(frame):
        for feat in dense_features:
            frame[feat] = pd.to_numeric(frame[feat], errors="coerce").fillna(0)

    df = df.copy()
    df[sparse_features] = df[sparse_features].fillna("-1")
    if coerce_dense:
        _clean_dense(df)
    df[dense_features] = df[dense_features].fillna(0)

    if fit_df is not None:
        fit_df = fit_df.copy()
        fit_df[sparse_features] = fit_df[sparse_features].fillna("-1")
        if coerce_dense:
            _clean_dense(fit_df)
        fit_df[dense_features] = fit_df[dense_features].fillna(0)
        encoders = {
            feat: SafeLabelEncoder.fit(fit_df[feat]) for feat in sparse_features
        }
        scaler = MinMaxScaler()
        scaler.fit(fit_df[dense_features].astype("float32").values)

    assert encoders is not None and scaler is not None
    for feat in sparse_features:
        df[feat] = encoders[feat].transform(df[feat])
    df[dense_features] = scaler.transform(
        df[dense_features].astype("float32").values
    )
    for feat in sparse_features:
        df[feat] = df[feat].astype("int64")
    for feat in dense_features:
        df[feat] = df[feat].astype("float32")
    return df, encoders, scaler


def build_feature_columns(
    df_for_vocab,
    sparse_features: List[str],
    dense_features: List[str],
    embedding_dim: int = 4,
):
    """vocab = max_id + 1 since unknown -> 0 (``xdftrain.py:240-256``)."""
    cols = [
        SparseFeat(
            feat,
            vocabulary_size=int(df_for_vocab[feat].max()) + 1,
            embedding_dim=embedding_dim,
        )
        for feat in sparse_features
    ] + [DenseFeat(feat, 1) for feat in dense_features]
    linear_feature_columns = cols
    dnn_feature_columns = cols
    feature_names = get_feature_names(linear_feature_columns + dnn_feature_columns)
    return linear_feature_columns, dnn_feature_columns, feature_names


def build_model_input(df, feature_names: List[str]) -> Dict[str, np.ndarray]:
    return {name: df[name].values for name in feature_names}


def train_test_split(df, test_size: float, random_state: int, stratify=None):
    """Row split matching sklearn's default shuffle split semantics."""
    rng = np.random.default_rng(random_state)
    n = len(df)
    n_test = int(round(n * test_size)) if test_size < 1 else int(test_size)
    if stratify is not None:
        labels = np.asarray(stratify)
        # absolute counts become a per-class FRACTION (sklearn semantics:
        # an int test_size with stratify still allocates proportionally)
        frac = test_size if test_size < 1 else n_test / max(n, 1)
        test_idx = []
        for v in np.unique(labels):
            idx = np.flatnonzero(labels == v)
            k = int(round(len(idx) * frac))
            test_idx.append(rng.permutation(idx)[:k])
        test_idx = np.concatenate(test_idx)
    else:
        test_idx = rng.permutation(n)[:n_test]
    test_mask = np.zeros(n, dtype=bool)
    test_mask[test_idx] = True
    return df.iloc[~test_mask], df.iloc[test_mask]


def iter_criteo_batches(
    path: str,
    sparse_features: List[str],
    dense_features: List[str],
    encoders: Dict[str, SafeLabelEncoder],
    scaler: MinMaxScaler,
    batch_size: int,
    chunksize: int = 200_000,
    with_label: bool = True,
    coerce_dense: bool = False,
):
    """Stream a criteo-like file as exactly-``batch_size`` ``(x, y)`` batches
    without loading it into memory (out-of-core training via
    ``BaseModel.fit_stream``; the reference reads the whole CSV into pandas,
    ``xdftrain.py:125-162``).

    Encoders/scaler must already be fit (e.g. on a prior pass or a sample);
    preprocessing per chunk is identical to :func:`prepare_features`.  The
    final batch may be shorter.  Separator handling mirrors
    :func:`read_criteo_like`.
    """
    reader = _criteo_chunk_reader(path, chunksize, coerce_dense=coerce_dense)

    feature_names = list(sparse_features) + list(dense_features)
    pend_x = {name: [] for name in feature_names}
    pend_y: List[np.ndarray] = []
    pending = 0

    def drain(final=False):
        nonlocal pending
        while pending >= batch_size or (final and pending):
            take = min(batch_size, pending)
            cat = {k: np.concatenate(v) if len(v) > 1 else v[0]
                   for k, v in pend_x.items()}
            yc = np.concatenate(pend_y) if len(pend_y) > 1 else pend_y[0]
            xb = {k: v[:take] for k, v in cat.items()}
            yb = yc[:take]
            for k in pend_x:
                pend_x[k] = [cat[k][take:]] if pending > take else []
            pend_y[:] = [yc[take:]] if pending > take else []
            pending -= take
            yield xb, yb

    for chunk in reader:
        df, _, _ = prepare_features(
            chunk, sparse_features, dense_features,
            encoders=encoders, scaler=scaler, coerce_dense=coerce_dense,
        )
        for name in feature_names:
            pend_x[name].append(df[name].values)
        if with_label:
            # tolerant conversion (garbage labels -> 0, matching the bulk
            # path); the pyarrow tier delivers label as strings
            import pandas as pd

            pend_y.append(
                pd.to_numeric(df["label"], errors="coerce")
                .fillna(0.0)
                .to_numpy(np.float32)
            )
        else:
            pend_y.append(np.zeros(len(df), np.float32))
        pending += len(df)
        yield from drain()
    yield from drain(final=True)


def fit_preprocessors_streaming_native(path: str, parser=None,
                                       block_rows: int = 262144):
    """One native C++ streaming pass over ``path``: builds the per-column
    vocab (SafeLabelEncoder first-appearance semantics) inside the parser and
    accumulates dense min/max + label stats.  Returns (parser, scaler, stats)
    — the streaming-mode analog of the bulk native fit
    (cli/common._native_load_eval)."""
    from .native import NativeCriteoParser

    if parser is None:
        parser = NativeCriteoParser()
    dmin = np.full(len(CRITEO_DENSE), np.inf)
    dmax = np.full(len(CRITEO_DENSE), -np.inf)
    n = 0
    pos = 0.0
    for labels, dense, _ids in parser.stream(path, block_rows, fit=True):
        dmin = np.minimum(dmin, dense.min(axis=0))
        dmax = np.maximum(dmax, dense.max(axis=0))
        n += len(labels)
        pos += float((labels == 1).sum())
    scaler = MinMaxScaler(
        data_min_=dmin.astype(np.float64), data_max_=dmax.astype(np.float64)
    )
    # native parse fills missing labels with 0, so label_nan is always 0
    stats = {"n": n, "pos_ratio": pos / max(n, 1), "label_nan": 0}
    return parser, scaler, stats


def extend_scaler(scaler: MinMaxScaler, dense: np.ndarray):
    """Extend a fitted MinMaxScaler's range with more data (train+eval
    combined fit semantics, ``xdftrain.py:372-383``)."""
    dense = np.asarray(dense, dtype=np.float64)
    scaler.data_min_ = np.minimum(scaler.data_min_, np.nanmin(dense, axis=0))
    scaler.data_max_ = np.maximum(scaler.data_max_, np.nanmax(dense, axis=0))
    return scaler


def iter_criteo_batches_native(path: str, parser, scaler, batch_size: int,
                               with_label: bool = True,
                               block_rows: int = 262144,
                               shuffle_buffer: int = 0, seed: int = 0):
    """Native-parser counterpart of :func:`iter_criteo_batches`: stream
    ``(x, y)`` batches through the C++ parser, with no pandas.  The parser's
    vocab must already be fit (e.g. via
    :func:`fit_preprocessors_streaming_native`); unknown tokens -> 0.

    ``shuffle_buffer`` > 0 enables a TF-style streaming shuffle: a buffer of
    that many rows is kept in memory; each batch samples random rows from it
    and refills the freed slots from the stream, so every row is yielded
    exactly once in a randomized order (window = buffer size).  The
    in-memory ``fit`` path shuffles globally; this is the out-of-core
    approximation."""
    block = max(batch_size, (block_rows // batch_size) * batch_size)

    def emit(labels, dense, ids, s, e):
        x = {CRITEO_SPARSE[j]: ids[s:e, j] for j in range(26)}
        x.update({CRITEO_DENSE[j]: dense[s:e, j] for j in range(13)})
        return x, labels[s:e]

    if not shuffle_buffer:
        for labels, dense, ids in parser.stream(
            path, block, with_label=with_label, fit=False
        ):
            if scaler is not None:
                dense = scaler.transform(dense)
            for s in range(0, len(labels), batch_size):
                yield emit(labels, dense, ids, s, min(s + batch_size,
                                                      len(labels)))
        return

    rng = np.random.default_rng(seed)
    S = max(int(shuffle_buffer), batch_size)
    buf_l = np.zeros(S, np.float32)
    buf_d = np.zeros((S, len(CRITEO_DENSE)), np.float32)
    buf_i = np.zeros((S, len(CRITEO_SPARSE)), np.int64)
    fill = 0  # rows currently in the buffer (always a prefix)

    def emit_rows(rows_l, rows_d, rows_i):
        x = {CRITEO_SPARSE[j]: rows_i[:, j] for j in range(26)}
        x.update({CRITEO_DENSE[j]: rows_d[:, j] for j in range(13)})
        return x, rows_l

    for labels, dense, ids in parser.stream(
        path, block, with_label=with_label, fit=False
    ):
        if scaler is not None:
            dense = scaler.transform(dense)
        pos = 0
        n = len(labels)
        while pos < n:
            take = min(S - fill, n - pos)
            if take > 0:
                buf_l[fill : fill + take] = labels[pos : pos + take]
                buf_d[fill : fill + take] = dense[pos : pos + take]
                buf_i[fill : fill + take] = ids[pos : pos + take]
                fill += take
                pos += take
            if fill == S:
                sel = rng.choice(S, size=batch_size, replace=False)
                yield emit_rows(buf_l[sel].copy(), buf_d[sel].copy(),
                                buf_i[sel].copy())
                # compact: move the tail into the freed slots
                keep = np.setdiff1d(np.arange(S), sel, assume_unique=True)
                buf_l[: S - batch_size] = buf_l[keep]
                buf_d[: S - batch_size] = buf_d[keep]
                buf_i[: S - batch_size] = buf_i[keep]
                fill = S - batch_size
    # drain: shuffle what's left, emit in batch_size slices
    order = rng.permutation(fill)
    for s in range(0, fill, batch_size):
        sel = order[s : s + batch_size]
        yield emit_rows(buf_l[sel].copy(), buf_d[sel].copy(),
                        buf_i[sel].copy())


def _criteo_chunk_reader(path: str, chunksize: int,
                         coerce_dense: bool = False):
    """Chunked criteo-like reader with :func:`read_criteo_like`'s separator
    handling (mixed header/data separators, headerless files).

    Uses pyarrow's streaming CSV reader when available (faster than pandas'
    C engine), falling back to pandas chunks.  ``coerce_dense`` keeps
    the dense columns as STRINGS at parse time (the pro variant tolerates
    non-numeric garbage there — a float64-pinned parse would abort on it);
    the downstream ``pd.to_numeric(errors='coerce')`` pass converts."""
    import pandas as pd

    with open(path, "r", encoding="utf-8", errors="ignore") as f:
        header_line = f.readline().strip()
        data_line = f.readline().strip()
    header_sep = "\t" if ("\t" in header_line and "," not in header_line) else ","
    data_sep = "\t" if "\t" in data_line else ","
    header_cols = header_line.split(header_sep)
    has_header = all(c in header_cols for c in CRITEO_COLUMNS)
    mixed = has_header and header_sep != data_sep
    if has_header and not mixed:
        names = None
    elif (not has_header
          and len(data_line.split(data_sep)) == len(CRITEO_COLUMNS) - 1):
        # headerless 39-column (unlabeled) file, like read_criteo_like
        names = CRITEO_DENSE + CRITEO_SPARSE
    else:
        names = CRITEO_COLUMNS

    try:
        import pyarrow as pa
        from pyarrow import csv as pacsv

        # ~64 bytes/field is a good row-size estimate for block sizing
        block = max(1 << 20, chunksize * 64 * len(CRITEO_COLUMNS) // 4)
        read_opts = pacsv.ReadOptions(
            block_size=block,
            skip_rows=1 if mixed else 0,
            column_names=list(names) if names else None,
            autogenerate_column_names=False,
        )
        parse_opts = pacsv.ParseOptions(delimiter=data_sep)
        # empty string fields -> null (pandas read_csv semantics: NaN, so the
        # downstream fillna("-1") sees them).  Column types are PINNED:
        # pyarrow otherwise infers from the first block only, so a hex
        # category column whose first block is all-digits gets typed int64
        # and a later alphabetic token aborts the stream mid-epoch (and
        # int64<->float64 flips per block break encoder stringization).
        dense_t = pa.string() if coerce_dense else pa.float64()
        conv_opts = pacsv.ConvertOptions(
            strings_can_be_null=True,
            column_types={
                **{c: pa.string() for c in CRITEO_SPARSE},
                **{c: dense_t for c in CRITEO_DENSE},
                # label stays a string through the arrow layer: a float64 pin
                # would abort the stream mid-epoch on the first garbage label
                # token, while the bulk path and fit_preprocessors_streaming
                # tolerate them (pd.to_numeric errors='coerce' downstream)
                "label": pa.string(),
            },
        )

        def gen():
            with pacsv.open_csv(
                path, read_options=read_opts, parse_options=parse_opts,
                convert_options=conv_opts,
            ) as reader:
                for rb in reader:
                    if rb.num_rows:
                        yield rb.to_pandas()

        return gen()
    except ImportError:
        pass
    if names is None:
        return pd.read_csv(path, sep=data_sep, chunksize=chunksize)
    if mixed:
        return pd.read_csv(
            path, sep=data_sep, skiprows=1, header=None,
            names=names, chunksize=chunksize,
        )
    return pd.read_csv(
        path, sep=data_sep, header=None, names=names,
        chunksize=chunksize,
    )


def fit_preprocessors_streaming(
    path: str,
    sparse_features: List[str],
    dense_features: List[str],
    chunksize: int = 200_000,
    coerce_dense: bool = False,
):
    """One streaming pass fitting the preprocessors without loading the file:
    SafeLabelEncoder vocabularies (first-appearance order — identical to
    fitting on the fully-loaded frame) and MinMaxScaler min/max (after the
    same ``fillna(0)`` the bulk path applies, ``xdftrain.py:192-237``).

    Returns ``(encoders, scaler, stats)`` with
    ``stats = {"n", "pos", "pos_ratio", "label_nan"}``.
    """
    import pandas as pd

    mappings: Dict[str, Dict[str, int]] = {f: {} for f in sparse_features}
    data_min = None
    data_max = None
    n = 0
    pos = 0
    label_nan = 0
    for chunk in _criteo_chunk_reader(path, chunksize,
                                      coerce_dense=coerce_dense):
        chunk[sparse_features] = chunk[sparse_features].fillna("-1")
        if coerce_dense:  # pro-variant cleaning, like prepare_features
            for feat in dense_features:
                chunk[feat] = pd.to_numeric(chunk[feat], errors="coerce")
        chunk[dense_features] = chunk[dense_features].fillna(0)
        for feat in sparse_features:
            m = mappings[feat]
            for v in pd.unique(SafeLabelEncoder._as_str(chunk[feat])):
                if v not in m:
                    m[v] = len(m) + 1
        X = chunk[dense_features].astype("float64").values
        cmin = np.nanmin(X, axis=0)
        cmax = np.nanmax(X, axis=0)
        data_min = cmin if data_min is None else np.minimum(data_min, cmin)
        data_max = cmax if data_max is None else np.maximum(data_max, cmax)
        if "label" in chunk.columns:
            labels = pd.to_numeric(chunk["label"], errors="coerce")
            label_nan += int(labels.isna().sum())
            pos += int((labels.fillna(0) == 1).sum())
        n += len(chunk)
    encoders = {
        feat: SafeLabelEncoder(mapping=mappings[feat])
        for feat in sparse_features
    }
    scaler = MinMaxScaler(data_min_=data_min, data_max_=data_max)
    stats = {
        "n": n,
        "pos": pos,
        "pos_ratio": (pos / n) if n else 0.0,
        "label_nan": label_nan,
    }
    return encoders, scaler, stats


def extend_preprocessors(
    encoders: Dict[str, SafeLabelEncoder],
    scaler: MinMaxScaler,
    df,
    sparse_features: List[str],
    dense_features: List[str],
):
    """Extend fitted preprocessors with another frame, in place — matches
    fitting on the concatenation (the eval CLI fits encoders on train+eval
    combined, ``xdftrain.py:372-383``): unseen categories append in
    first-appearance order; scaler min/max widen elementwise."""
    import pandas as pd

    df = df.copy()
    df[sparse_features] = df[sparse_features].fillna("-1")
    df[dense_features] = df[dense_features].fillna(0)
    for feat in sparse_features:
        m = encoders[feat].mapping
        for v in pd.unique(df[feat].astype(str)):
            if v not in m:
                m[v] = len(m) + 1
    X = df[dense_features].astype("float64").values
    scaler.data_min_ = np.minimum(scaler.data_min_, np.nanmin(X, axis=0))
    scaler.data_max_ = np.maximum(scaler.data_max_, np.nanmax(X, axis=0))
    return encoders, scaler


def feature_columns_from_encoders(
    encoders: Dict[str, SafeLabelEncoder],
    sparse_features: List[str],
    dense_features: List[str],
    embedding_dim: int = 4,
):
    """Feature columns without a materialized frame: vocab = len(mapping)+1
    (ids are 1..N with unknown->0, so max_id + 1 == len + 1; mirrors
    :func:`build_feature_columns` / ``xdftrain.py:240-256``)."""
    cols = [
        SparseFeat(
            feat,
            vocabulary_size=len(encoders[feat].mapping) + 1,
            embedding_dim=embedding_dim,
        )
        for feat in sparse_features
    ] + [DenseFeat(feat, 1) for feat in dense_features]
    feature_names = get_feature_names(cols + cols)
    return cols, cols, feature_names
