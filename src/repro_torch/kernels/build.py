"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
compiler process per source, all started together) and linked into one
shared library with a plain C interface, loaded with :mod:`ctypes`.  The build
runs at the first launch of any kernel, never at import, and lands in
``src/repro_torch/_build/`` under a name keyed by the hash of the sources and
flags, so an edited source is rebuilt on its next use.  The build holds a
file lock in that directory, so processes started together (the ranks of a
distributed run) compile once and load what the first one built.

Each C entry point takes raw device pointers, sizes and the CUDA stream, and
returns ``cudaGetLastError()`` after its launch; :class:`CudaKernel` raises on
a non-zero value and counts the launches that succeeded.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the build this process ran


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built on this host")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _compile(target: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / target.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, target)  # atomic: a reader never sees half a library


def load_library() -> ctypes.CDLL:
    """The kernel library, built first if this source tree has none yet."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f"libocto_kernels_{_digest()}.so"
            if not target.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                with open(BUILD_DIR / ".build.lock", "w") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)  # one compiler run across processes
                    if not target.exists():
                        t0 = time.perf_counter()
                        _compile(target)
                        build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(target))
            lib.octo_error_string.argtypes = [ctypes.c_int]
            lib.octo_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


H100_SMS = 132  # the H100 SXM's streaming multiprocessors: the plans' default


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


class CudaKernel:
    """One C entry point of the kernel library and its launch count.

    ``launches`` is a plain integer that grows by one for every launch the
    CUDA runtime accepted; a refused launch raises and is not counted."""

    def __init__(self, symbol: str, argtypes: Sequence[type]):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, device: torch.device, *args) -> None:
        if self._fn is None:
            fn = getattr(load_library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            err = self._fn(*args)
        if err != 0:
            msg = load_library().octo_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Refuse what the kernels do not take: they read contiguous tensors that
    all live on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel needs contiguous tensors")
