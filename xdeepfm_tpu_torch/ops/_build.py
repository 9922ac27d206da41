"""Build the port's CUDA sources (``ops/csrc/*.cu``) into shared libraries.

Each source has a plain C interface and is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``xdeepfm_tpu_torch/_build/lib<name>-<hash>.so`` at first
use, then loaded with ``ctypes``.  The hash covers the sources and the flags,
so an edited kernel rebuilds and a checkout builds from its own sources alone.
Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills go to the build log
)

_LOADED: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found: put it on PATH or set CUDA_HOME to the CUDA toolkit"
        )
    return str(path)


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile each named source (default: every ``csrc/*.cu``) whose library
    is missing, one ``nvcc`` per source, all started together.  Returns
    ``{name: compiler log}``; raises with the log if a compile fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name in names:
            lib = library_path(name)
            if lib.exists():
                continue
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ),
                tmp,
                lib,
            )
        for name, (proc, tmp, lib) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
            lib.with_suffix(".log").write_text(log)
            os.replace(tmp, lib)
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {
        name: library_path(name).with_suffix(".log").read_text() for name in names
    }


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it if needed."""
    if name not in _LOADED:
        build([name])
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]


def function(lib: str, name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function ``name`` of ``csrc/<lib>.cu``, returning int, with
    ``argtypes`` declared; loaded (and built) at first use."""
    if (lib, name) not in _FNS:
        fn = getattr(load(lib), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[lib, name] = fn
    return _FNS[lib, name]


def launch(lib: str, name: str, argtypes: Sequence, device, *args) -> None:
    """Call the kernel launcher ``name`` of ``csrc/<lib>.cu`` with ``args``
    and, last, ``device``'s current PyTorch stream (``argtypes`` include the
    stream's pointer); raise RuntimeError with the CUDA error's text when it
    returns one."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = function(lib, name, argtypes)(*args, stream)
    if err != 0:
        err_fn = getattr(load(lib), f"{lib}_error_string")
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({err_fn(err).decode()})")
