"""Build the port's CUDA sources (``ops/csrc/*.cu``) into shared libraries.

Each source has a plain C interface and is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``xdeepfm_tpu_torch/_build/lib<name>-<hash>.so`` at first
use, then loaded with ``ctypes``.  The hash covers the sources and the flags,
so an edited kernel rebuilds and a checkout builds from its own sources alone.
Nothing here runs when the package is imported.  :func:`fp32_forward` is the
kernels' precision boundary, which every ``autograd.Function`` of ``ops/``
shares.
"""

from __future__ import annotations

import ctypes
import functools
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

def fp32_forward(forward):
    """Decorate an ``autograd.Function``'s ``forward``: under autocast, on
    the card or on the CPU, its bf16 and fp16 tensor arguments arrive in
    fp32 and it runs with autocast off, as the Pallas kernels keep their own
    precision under the JAX package's bf16 mode.  Outside autocast it
    changes nothing.  (``torch.amp.custom_fwd`` would rebuild a NamedTuple
    argument such as ``attn_block_cuda.BlockCfg`` from a generator.)"""

    @functools.wraps(forward)
    def run(ctx, *args):
        if not (torch.is_autocast_enabled("cuda") or torch.is_autocast_enabled("cpu")):
            return forward(ctx, *args)
        args = [a.float() if torch.is_tensor(a) and a.dtype in (torch.bfloat16, torch.float16)
                else a for a in args]
        with torch.autocast("cuda", enabled=False), torch.autocast("cpu", enabled=False):
            return forward(ctx, *args)

    return run


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


def _stream(index: int) -> int:
    """The cudaStream_t of device ``index``'s current PyTorch stream: by
    ``torch._C._cuda_getCurrentRawStream`` where the build has it (a fraction
    of a microsecond), else by ``torch.cuda.current_stream``."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(index) if raw is not None else torch.cuda.current_stream(index).cuda_stream


def launch(lib: str, name: str, argtypes: Sequence, device, *args) -> None:
    """Call the kernel launcher ``name`` of ``csrc/<lib>.cu`` with ``args``
    and, last, ``device``'s current PyTorch stream (``argtypes`` include the
    stream's pointer), with ``device`` the current CUDA device (switched to
    and back only where it is not); raise RuntimeError with the CUDA error's
    text when it returns one."""
    fn = function(lib, name, argtypes)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*args, _stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _stream(index))
    if err != 0:
        err_fn = getattr(load(lib), f"{lib}_error_string")
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({err_fn(err).decode()})")
