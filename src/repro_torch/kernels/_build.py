"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launch function and compiles
on its own into ``build/kernels/lib<name>-<hash>.so`` under the
repository checkout (the directory is git-ignored). The hash covers the
source text, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header never loads a stale library. Builds run at
first use; :func:`build` starts one ``nvcc`` per missing library, all at
once, and waits for them together.

Nothing here runs at import time: the CPU tests import every module of
the port on a host without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_decode_attn", "sparce_glu_mlp", "sparce_mlp",
           "relu_bitmap", "sparce_gemm", "paged_mla_decode_attn")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# dtype ids the C launch functions take (0 = float32, 1 = bfloat16).
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[tuple, Callable] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled on the machine "
        "with the GPU (CUDA toolkit on PATH or under /usr/local/cuda)")


def library_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every missing library in ``names`` in parallel (one nvcc
    each). Returns {name: path}. Raises with the compiler's output if
    any build fails. The ptxas resource report of each build is kept
    beside its library as ``.log``."""
    names = list(names)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out[n])  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: Sequence) -> Callable:
    """The C launch function ``symbol`` of ``csrc/<name>.cu`` with its
    argument types declared (pointers and the stream as ``c_void_p``)
    and an ``int`` (cudaError_t) result."""
    key = (name, symbol)
    fn = _functions.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return fn


def check_operands(kernel: str, **tensors: torch.Tensor) -> int:
    """Raise unless every tensor lies on the first one's CUDA device,
    shares its dtype (float32 or bfloat16) and is contiguous. Returns
    the dtype id the C launch functions take."""
    name0, t0 = next(iter(tensors.items()))
    if t0.dtype not in DTYPE_IDS:
        raise TypeError(
            f"{kernel}: {name0} must be float32 or bfloat16, got {t0.dtype}")
    for name, t in tensors.items():
        if t.device != t0.device:
            raise ValueError(
                f"{kernel}: {name} on {t.device}, {name0} on {t0.device}")
        if t.dtype != t0.dtype:
            raise TypeError(
                f"{kernel}: {name} is {t.dtype}, {name0} is {t0.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    return DTYPE_IDS[t0.dtype]


def build_log(name: str) -> str:
    """The compiler's resource report of the current build of ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
