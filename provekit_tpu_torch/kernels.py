"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` into one shared library with a plain C
interface, at first use, into ``build/provekit_tpu_torch/`` at the root of
the checkout; the file name carries a hash of the sources and flags, so an
edited source is rebuilt.  The library is loaded with ``ctypes``: every
pointer and the stream pass as ``c_void_p``, every C entry point returns
``cudaGetLastError()`` after its launch, and :func:`launch` raises when that
is not 0.  Nothing here runs at import time: the CPU tests import every
module of the port on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "provekit_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
# C signatures of the entry points (csrc/*.cu); all return int.
SIGNATURES = {
    "pk_mont_mul": [_P, _I64, _I64, _P, _I64, _I64, _P, _I64, _P],
    "pk_ntt_stage": [_P, _P, _I64, _P, _I64, _I32, _I32, _P],
    "pk_compress": [_P, _I64, _I64, _P, _I64, _I64, _P, _I64, _P],
    "pk_permute": [_P, _I64, _I64, _P, _I64, _I64, _P, _P, _I64, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpk_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is up to date."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``name`` on ``device``'s current stream; raise on a
    launch error.  ``args`` exclude the trailing stream argument."""
    fn = getattr(lib(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check_cuda_int32(name: str, *tensors: torch.Tensor) -> torch.device:
    """Device of the operands of a CUDA kernel; raise on anything else."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: operands must share one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: operands must be int32 digit planes, "
                             f"got {t.dtype}")
        if t.shape[0] != 16:
            raise ValueError(f"{name}: expected (16, ...) planes, "
                             f"got {tuple(t.shape)}")
    return dev
