"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, at first use, into ``build/provekit_tpu_torch/`` at the root of
the checkout; one ``nvcc`` per source, all started together.  A library's
file name carries a hash of its source, the shared header and the flags, so
an edited source is rebuilt.  The libraries are loaded with ``ctypes``:
every pointer and the stream pass as ``c_void_p``, every C entry point
returns ``cudaGetLastError()`` after its launch, and :class:`Entry` raises
when that is not 0.  Nothing here runs at import time: the CPU tests import
every module of the port on a machine with no ``nvcc``.
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
# C signatures of the entry points, by source (csrc/*.cu); all return int
# (a CUDA error, or for pk_segment_max_blocks the segments' grid limit).
SIGNATURES = {
    "mont_mul.cu": {
        "pk_mont_mul": [_P, _I64, _I64, _P, _I64, _I64, _P, _I64, _P]},
    "ntt_stage.cu": {
        "pk_ntt_pass": [_P, _P, _P, _I64, _P, _P, _I64, *[_I32] * 9, _P]},
    "skyscraper.cu": {
        "pk_compress": [_P, _I64, _I64, _P, _I64, _I64, _P, _I64, _P],
        "pk_compress_fold": [_P, _I32, _I64, _I64, _I64, _P, _I64, _P],
        "pk_permute": [_P, _I64, _I64, _P, _I64, _I64, _P, _P, _I64, _P],
        "pk_duplex": [_P, _I64, _I64, _P, _I64, _I64, _I32, _I32, _I32, _P,
                      _I64, _P]},
    "mont_mul_mma.cu": {
        "pk_mont_mul_mma": [_P, _P, _P, _P, _I64, _P]},
    "sumcheck_segment.cu": {
        "pk_whir_segment": [_P, _I64, _I64, _I64, _P, _I64, _I64, _I64, _I32,
                            _P, _P, _P, _I64, _P, _P],
        "pk_spartan_segment": [_P, _I64, _I64, _I64, _P, _I64, _I64, _I32,
                               _P, _P, _I64, _P, _P],
        "pk_segment_max_blocks": []},
}

_lock = threading.Lock()
_lib: dict | None = None


def library_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / source, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"libpk_{Path(source).stem}_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(force: tuple = ()) -> dict[str, str]:
    """Compile every csrc/*.cu that is not up to date, and those named in
    ``force`` in any case, one nvcc per source, all running at once; returns,
    for each source compiled now, what ptxas said of its kernels (registers,
    shared memory, spills)."""
    outs = {src: library_path(src) for src in SIGNATURES}
    jobs = []
    for src, out in outs.items():
        if out.exists() and src not in force:
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        jobs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed, reports = [], {}
    for src, out, tmp, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src} ({proc.returncode}):\n{stdout}\n{stderr}")
        else:
            os.replace(tmp, out)
            reports[src] = stderr
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return reports


def lib() -> dict:
    """Entry point name -> loaded C function (libraries built on first
    call)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            fns = {}
            for src, sigs in SIGNATURES.items():
                handle = ctypes.CDLL(str(library_path(src)))
                for name, argtypes in sigs.items():
                    fn = getattr(handle, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    fns[name] = fn
            _lib = fns
    return _lib


class Entry:
    """One C entry point, resolved at its first launch and kept, so that a
    launch takes no lock and no lookup.  ``entry(device, *args)`` calls it
    on ``device``'s current stream (``args`` exclude the trailing stream
    argument) and raises on a launch error."""

    def __init__(self, name: str):
        self.name = name
        self.fn = None

    def __call__(self, device: torch.device, *args) -> None:
        fn = self.fn
        if fn is None:
            fn = self.fn = lib()[self.name]
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch failed with error {err}")


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
