"""Feature schema & batch packing (PyTorch port of ``xdeepfm_tpu/features.py``).

The port keeps its own copy of the JAX package's numpy-only schema so that it
imports nothing of ``xdeepfm_tpu``.  Batches stay typed, as there:

* ``sparse``:  int32  ``[B, n_sparse]``   -- one column per SparseFeat,
* ``dense``:   float32 ``[B, sum(dims)]`` -- contiguous slices per DenseFeat,
* ``vl_<name>``: int32 ``[B, maxlen]``    -- per VarLenSparseFeat,
* ``len_<name>``: int32 ``[B, 1]``        -- explicit sequence lengths (optional).

Semantics preserved from the reference (``deepctr/inputs.py:20-123``):
fixed column order = first appearance over the feature-column list, shared
tables via ``embedding_name``, ``embedding_dim="auto"`` -> ``6 * vocab**0.25``.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

DEFAULT_GROUP_NAME = "default_group"


@dataclasses.dataclass(frozen=True)
class SparseFeat:
    """Categorical field spec (reference: ``inputs.py:20-38``)."""

    name: str
    vocabulary_size: int
    embedding_dim: int = 4
    use_hash: bool = False
    dtype: str = "int32"
    embedding_name: Optional[str] = None
    group_name: str = DEFAULT_GROUP_NAME

    def __post_init__(self):
        if self.embedding_name is None:
            object.__setattr__(self, "embedding_name", self.name)
        if self.embedding_dim == "auto":
            object.__setattr__(
                self, "embedding_dim", 6 * int(pow(self.vocabulary_size, 0.25))
            )
        if self.use_hash:
            # Parity with the torch reference (inputs.py:31-33): hashing on
            # the fly is not supported; ids must be pre-encoded.
            print(
                "[NOTICE] use_hash=True is accepted for API compatibility "
                "but on-the-fly feature hashing is not implemented; "
                "pre-encode ids before feeding them in."
            )


@dataclasses.dataclass(frozen=True)
class VarLenSparseFeat:
    """Variable-length categorical sequence spec (reference: ``inputs.py:41-77``)."""

    sparsefeat: SparseFeat
    maxlen: int
    combiner: str = "mean"
    length_name: Optional[str] = None

    @property
    def name(self):
        return self.sparsefeat.name

    @property
    def vocabulary_size(self):
        return self.sparsefeat.vocabulary_size

    @property
    def embedding_dim(self):
        return self.sparsefeat.embedding_dim

    @property
    def use_hash(self):
        return self.sparsefeat.use_hash

    @property
    def dtype(self):
        return self.sparsefeat.dtype

    @property
    def embedding_name(self):
        return self.sparsefeat.embedding_name

    @property
    def group_name(self):
        return self.sparsefeat.group_name


@dataclasses.dataclass(frozen=True)
class DenseFeat:
    """Numeric field spec (reference: ``inputs.py:80-87``)."""

    name: str
    dimension: int = 1
    dtype: str = "float32"


FeatureColumn = Union[SparseFeat, DenseFeat, VarLenSparseFeat]


def get_feature_names(feature_columns: Sequence[FeatureColumn]) -> List[str]:
    """Ordered unique feature names (reference: ``inputs.py:90-92``)."""
    names = []
    for feat in feature_columns:
        if feat.name not in names:
            names.append(feat.name)
        if isinstance(feat, VarLenSparseFeat) and feat.length_name is not None:
            if feat.length_name not in names:
                names.append(feat.length_name)
    return names


@dataclasses.dataclass(frozen=True)
class FeatureSchema:
    """Deduplicated, ordered layout over a feature-column list
    (the reference's ``build_input_features``, ``inputs.py:99-123``, producing
    a typed batch layout instead of flat fp32 column slices)."""

    sparse: Tuple[SparseFeat, ...]
    dense: Tuple[DenseFeat, ...]
    varlen: Tuple[VarLenSparseFeat, ...]

    @staticmethod
    def build(feature_columns: Sequence[FeatureColumn]) -> "FeatureSchema":
        seen = set()
        sparse: List[SparseFeat] = []
        dense: List[DenseFeat] = []
        varlen: List[VarLenSparseFeat] = []
        for feat in feature_columns:
            if feat.name in seen:
                continue
            seen.add(feat.name)
            if isinstance(feat, SparseFeat):
                sparse.append(feat)
            elif isinstance(feat, DenseFeat):
                dense.append(feat)
            elif isinstance(feat, VarLenSparseFeat):
                varlen.append(feat)
            else:
                raise TypeError("Invalid feature column type, got %s" % type(feat))
        return FeatureSchema(tuple(sparse), tuple(dense), tuple(varlen))

    def sparse_index(self, name: str) -> int:
        for i, f in enumerate(self.sparse):
            if f.name == name:
                return i
        raise KeyError(name)

    def dense_slice(self, name: str) -> Tuple[int, int]:
        start = 0
        for f in self.dense:
            if f.name == name:
                return (start, start + f.dimension)
            start += f.dimension
        raise KeyError(name)

    @property
    def dense_dim(self) -> int:
        return sum(f.dimension for f in self.dense)

    @property
    def n_sparse(self) -> int:
        return len(self.sparse)

    def feature_names(self) -> List[str]:
        names = [f.name for f in self.sparse] + [f.name for f in self.dense]
        for f in self.varlen:
            names.append(f.name)
            if f.length_name is not None:
                names.append(f.length_name)
        return names

    def pack(self, x: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Assemble a typed batch dict from a ``{name: array}`` input mapping
        (the concat of ``basemodel.py:191-198``, ids int32 and dense fp32 kept
        in separate arrays)."""
        n = None
        for v in x.values():
            n = len(v)
            break
        if n is None:
            raise ValueError("empty input dict")
        for name in self.feature_names():
            if name in x and len(x[name]) != n:
                raise ValueError(
                    "inconsistent input lengths: feature %r has %d rows, "
                    "expected %d" % (name, len(x[name]), n)
                )
        batch: Dict[str, np.ndarray] = {}
        if self.sparse:
            cols = []
            for f in self.sparse:
                v = np.asarray(x[f.name])
                if v.ndim == 1:
                    v = v[:, None]
                cols.append(v.astype(np.int32))
            batch["sparse"] = np.concatenate(cols, axis=1)
        if self.dense:
            cols = []
            for f in self.dense:
                v = np.asarray(x[f.name])
                if v.ndim == 1:
                    v = v[:, None]
                cols.append(v.astype(np.float32))
            batch["dense"] = np.concatenate(cols, axis=1)
        for f in self.varlen:
            v = np.asarray(x[f.name]).astype(np.int32)
            if v.shape[1] != f.maxlen:
                raise ValueError(
                    "varlen feature %s expects maxlen %d, got %d"
                    % (f.name, f.maxlen, v.shape[1])
                )
            batch["vl_" + f.name] = v
            if f.length_name is not None:
                lv = np.asarray(x[f.length_name]).astype(np.int32)
                if lv.ndim == 1:
                    lv = lv[:, None]
                batch["len_" + f.length_name] = lv
        return batch


def split_columns(
    feature_columns: Sequence[FeatureColumn],
) -> Tuple[List[SparseFeat], List[DenseFeat], List[VarLenSparseFeat]]:
    """Partition a column list by kind, preserving order (reference filter
    idiom, ``basemodel.py:354-363``)."""
    sp = [f for f in feature_columns if isinstance(f, SparseFeat)]
    de = [f for f in feature_columns if isinstance(f, DenseFeat)]
    vl = [f for f in feature_columns if isinstance(f, VarLenSparseFeat)]
    return sp, de, vl


def compute_input_dim(
    feature_columns: Sequence[FeatureColumn],
    include_sparse: bool = True,
    include_dense: bool = True,
    feature_group: bool = False,
) -> int:
    """DNN input width (reference: ``basemodel.py:382-400``)."""
    sp = [f for f in feature_columns if isinstance(f, (SparseFeat, VarLenSparseFeat))]
    de = [f for f in feature_columns if isinstance(f, DenseFeat)]
    dense_dim = sum(f.dimension for f in de)
    sparse_dim = len(sp) if feature_group else sum(f.embedding_dim for f in sp)
    dim = 0
    if include_sparse:
        dim += sparse_dim
    if include_dense:
        dim += dense_dim
    return dim


def build_input_features(feature_columns: Sequence[FeatureColumn]):
    """The reference's column-slice map (``inputs.py:99-123``,
    ``xdeepfm_tpu/features.py:275-306``): an ``OrderedDict {feature_name:
    (start, end)}`` over the reference's flat fp32 input matrix.  A sparse
    feature takes 1 column, a dense one ``dimension``, a varlen one ``maxlen``
    and then 1 for its length column, if it names one; a name seen before is
    skipped.  Batches here are typed (:class:`FeatureSchema`), so nothing of
    the port reads these slices; they serve code carried over from the
    reference, e.g. to slice a legacy ``[B, sum(widths)]`` array before
    :meth:`FeatureSchema.pack`."""
    features = OrderedDict()
    start = 0
    for feat in feature_columns:
        if feat.name in features:
            continue
        if isinstance(feat, SparseFeat):
            features[feat.name] = (start, start + 1)
            start += 1
        elif isinstance(feat, DenseFeat):
            features[feat.name] = (start, start + feat.dimension)
            start += feat.dimension
        elif isinstance(feat, VarLenSparseFeat):
            features[feat.name] = (start, start + feat.maxlen)
            start += feat.maxlen
            if feat.length_name is not None and feat.length_name not in features:
                features[feat.length_name] = (start, start + 1)
                start += 1
        else:
            raise TypeError("Invalid feature column type,got", type(feat))
    return features
