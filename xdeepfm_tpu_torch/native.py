"""ctypes bindings for the native C++ Criteo parser (port of
``xdeepfm_tpu/native.py``; source ``native/criteo_parser.cpp``).

The source lies outside both packages and is read in place.  It is compiled
at first use with ``g++ -O3 -std=c++17 -shared -fPIC`` into
``xdeepfm_tpu_torch/_build/libcriteo-<hash>.so`` (git-ignored; the hash
covers the source and the flags, so an edited parser rebuilds), never next
to the source.  :func:`available` is False where no g++ is installed or the
build fails; callers then use the pandas pipeline (``data.py``).
:func:`build` raises instead, with the compiler's output.  The vocab file
of ``save_vocab`` / ``load_vocab`` is the parser's own binary format, so it
is the same file whichever package wrote it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from .ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "native" / "criteo_parser.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libcriteo-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the parser into ``_build/`` unless its library is there;
    returns the library's path.  Raises RuntimeError without g++ or when the
    compile fails."""
    lib = library_path()
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("the native criteo parser needs g++, which is not on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        path = build()
    except RuntimeError:
        return None
    lib = ctypes.CDLL(str(path))
    lib.criteo_parser_new.restype = ctypes.c_void_p
    lib.criteo_parser_free.argtypes = [ctypes.c_void_p]
    lib.criteo_count_rows.restype = ctypes.c_int64
    lib.criteo_count_rows.argtypes = [ctypes.c_char_p]
    lib.criteo_parse.restype = ctypes.c_int64
    lib.criteo_parse.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.criteo_vocab_sizes.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)
    ]
    lib.criteo_stream_open.restype = ctypes.c_void_p
    lib.criteo_stream_open.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int
    ]
    lib.criteo_stream_next.restype = ctypes.c_int64
    lib.criteo_stream_next.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.criteo_stream_close.argtypes = [ctypes.c_void_p]
    lib.criteo_save_vocab.restype = ctypes.c_int
    lib.criteo_save_vocab.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.criteo_load_vocab.restype = ctypes.c_int
    lib.criteo_load_vocab.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


class NativeCriteoParser:
    """Single-pass Criteo reader + SafeLabelEncoder-semantics categorical
    encoder, backed by C++.

    fit_transform(path) -> (labels [N], dense [N,13] fp32, ids [N,26] int64);
    transform(path, with_label) encodes with the fitted vocab (unknown -> 0).
    """

    N_DENSE = 13
    N_SPARSE = 26

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "native criteo parser unavailable (no g++ / build failed)"
            )
        self._lib = lib
        self._h = lib.criteo_parser_new()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.criteo_parser_free(self._h)
            self._h = None

    def _parse(self, path: str, with_label: bool, fit: bool):
        n = self._lib.criteo_count_rows(path.encode())
        if n < 0:
            raise FileNotFoundError(path)
        labels = np.zeros(n, np.float32)
        dense = np.zeros((n, self.N_DENSE), np.float32)
        ids = np.zeros((n, self.N_SPARSE), np.int64)
        r = self._lib.criteo_parse(
            self._h, path.encode(), int(with_label), int(fit),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            dense.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if r < 0:
            raise IOError(f"parse failed: {path}")
        return labels[:r], dense[:r], ids[:r]

    def fit_transform(self, path: str, with_label: bool = True):
        return self._parse(path, with_label, fit=True)

    def transform(self, path: str, with_label: bool = True):
        return self._parse(path, with_label, fit=False)

    def stream(self, path: str, batch_size: int, with_label: bool = True,
               fit: bool = False):
        """Yield (labels [K], dense [K,13] fp32, ids [K,26] int64) blocks of
        up to ``batch_size`` rows without loading the file (out-of-core
        feeds; pairs with data.iter_criteo_batches(native=...))."""
        h = self._lib.criteo_stream_open(
            self._h, path.encode(), int(with_label), int(fit)
        )
        if not h:
            raise FileNotFoundError(path)
        try:
            while True:
                labels = np.zeros(batch_size, np.float32)
                dense = np.zeros((batch_size, self.N_DENSE), np.float32)
                ids = np.zeros((batch_size, self.N_SPARSE), np.int64)
                r = self._lib.criteo_stream_next(
                    h, batch_size,
                    labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    dense.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                )
                if r < 0:
                    raise IOError(f"stream parse failed: {path}")
                if r == 0:
                    return
                yield labels[:r], dense[:r], ids[:r]
                if r < batch_size:
                    return
        finally:
            self._lib.criteo_stream_close(h)

    def vocab_sizes(self) -> np.ndarray:
        out = np.zeros(self.N_SPARSE, np.int64)
        self._lib.criteo_vocab_sizes(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        )
        return out

    def save_vocab(self, path: str):
        if self._lib.criteo_save_vocab(self._h, path.encode()) != 0:
            raise IOError(path)

    def load_vocab(self, path: str):
        if self._lib.criteo_load_vocab(self._h, path.encode()) != 0:
            raise IOError(path)
