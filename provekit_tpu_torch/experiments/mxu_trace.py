"""Where the tensor-core Montgomery kernel's (K6's) time goes, on the card.

    python3 -m provekit_tpu_torch.experiments.mxu_trace

Builds, with ``nvcc`` into the port's build directory, the kernel
``csrc/mont_mul_mma.cu`` with ``-DPK_MMA_TRACE``, and its earlier design
``experiments/mont_mul_mma_sync.cu`` (one element a thread, plain loads,
``mma.sync``) as the port builds kernels and with the macro.  A traced
kernel adds, for each warp, the SM clocks of each phase of its work
(``csrc/mma_trace.cuh``).  At n = 2^21 (K1's shape on the poseidon path)
on seeded canonical operands it then holds both designs and both traced
builds to ``mont_mul_mma_plain``, times the kernel, the earlier design and
the CIOS kernel K1 (``fields.vector.mont_mul``) with CUDA events (one
launch a sample, median of 20, in turns; and 20 launches queued back to
back, which leaves out the host's launch work), and splits one traced
launch of each design by phase: each phase's share of the warps' clocks
and its clocks a tile (a warpgroup's 128 elements; the earlier design's
warps count 32 elements).
It prints the card's name and power limit, then one JSON line.
``chip_smoke.py`` phase 4 prints the same summary.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .. import kernels as K
from . import mxu_mont as M

SOURCES = {"wgmma": K.CSRC / "mont_mul_mma.cu",
           "mma_sync": Path(__file__).resolve().parent
           / "mont_mul_mma_sync.cu"}
ENTRIES = {"wgmma": "pk_mont_mul_mma", "mma_sync": "pk_mont_mul_mma_sync"}
# the traced phases (csrc/mma_trace.cuh); the earlier design's phases 0 and
# 1 are its loads and its set-up
PHASES = ("wait_stage", "read_stage", "t_product", "np_product", "p_product",
          "stores", "producer_wait", "producer_fill")
SYNC_PHASES = ("loads", "setup") + PHASES[2:6]
TRACE_N = 9
SEED = 20261019
LOG_N = 21


def _library(design: str, traced: bool) -> Path:
    tag = "_trace" if traced else ""
    return K.BUILD_DIR / f"libpk_mxu_{design}{tag}.so"


def build() -> dict:
    """Compile the three libraries (the traced kernel, the earlier design
    and its traced build), all at once; returns what ptxas said of each."""
    jobs = []
    for design, traced in (("wgmma", True), ("mma_sync", False),
                           ("mma_sync", True)):
        out = _library(design, traced)
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [K._nvcc(), *K.NVCC_FLAGS, "-I", str(K.CSRC),
               *(["-DPK_MMA_TRACE"] if traced else []), "-o", str(out),
               str(SOURCES[design])]
        jobs.append((out.name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    reports, failed = {}, []
    for name, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{stdout}\n{stderr}")
        reports[name] = stderr
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return reports


def _load(design: str, traced: bool):
    lib = ctypes.CDLL(str(_library(design, traced)))
    fn = getattr(lib, ENTRIES[design])
    fn.argtypes = K.SIGNATURES["mont_mul_mma.cu"]["pk_mont_mul_mma"]
    fn.restype = ctypes.c_int
    trace = None
    if traced:
        trace = lib.pk_mont_mul_mma_trace
        trace.argtypes = [ctypes.c_void_p]
        trace.restype = ctypes.c_int
    return fn, trace


def _launcher(fn, a, b):
    """A function that launches ``fn`` on (a, b) and returns the output."""
    dev = a.device
    bands = M._bands(dev)

    def run():
        out = torch.empty_like(a)
        err = fn(a.data_ptr(), b.data_ptr(), bands.data_ptr(), out.data_ptr(),
                 a.shape[1], torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return out
    return run


def _read(trace) -> list:
    host = (ctypes.c_ulonglong * TRACE_N)()
    err = trace(host)
    if err:
        raise RuntimeError(f"reading the trace failed with CUDA error {err}")
    return list(host)


def _split(counts: list, names) -> dict:
    """Each phase's share of the consumer (and the producer) warps' clocks,
    and clocks a tile."""
    tiles = max(counts[8], 1)
    consumer = sum(counts[:6]) or 1
    out = {"tiles": counts[8],
           "share": {k: counts[i] / consumer for i, k in enumerate(names)},
           "clocks_per_tile": {k: counts[i] / tiles
                               for i, k in enumerate(names)}}
    producer = sum(counts[6:8])
    if producer:
        out["producer_share"] = {PHASES[i]: counts[i] / producer
                                 for i in (6, 7)}
    return out


def _median_ms(fns: dict, reps: int = 20) -> dict:
    """Median CUDA-event milliseconds of each function, the functions
    launched in turns, one launch a sample."""
    import statistics
    samples = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            samples[name].append(start.elapsed_time(end))
    return {k: statistics.median(v) for k, v in samples.items()}


def run(device) -> dict:
    """Build, check, time and trace at n = 2^LOG_N on a CUDA ``device``."""
    from ..fields import vector as V
    from ..utils.profiling import back_to_back_ms, cuda_ms
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the trace runs the kernels on a CUDA card")
    reports = build()
    n = 1 << LOG_N
    rng = np.random.default_rng(SEED)
    digits = rng.integers(0, 1 << 16, size=(2, 16, n), dtype=np.int64)
    digits[:, 15] = rng.integers(0, 0x3064, size=(2, n))
    a, b = torch.from_numpy(digits.astype(np.int32)).to(dev)
    want = M.mont_mul_mma_plain(a, b)
    sync_fn, _ = _load("mma_sync", False)
    fns = {"wgmma": lambda: M.mont_mul_mma(a, b),
           "mma_sync": _launcher(sync_fn, a, b),
           "mont_mul": lambda: V.mont_mul(a, b)}
    checks = {k: bool(torch.equal(fn(), want)) for k, fn in fns.items()}
    out = {"n": n, "ms": _median_ms(fns),
           "back_to_back_ms": {k: back_to_back_ms(f) for k, f in fns.items()},
           "checks": checks, "traced": {},
           "ptxas": {name: [line.strip() for line in text.splitlines()
                            if "registers" in line or "spill" in line]
                     for name, text in reports.items()}}
    for design, names in (("wgmma", PHASES[:6]), ("mma_sync", SYNC_PHASES)):
        fn, trace = _load(design, True)
        launch = _launcher(fn, a, b)
        checks[f"{design}_traced"] = bool(torch.equal(launch(), want))
        ms = cuda_ms(launch, 1)
        _read(trace)   # clears what the launches so far added
        launch()
        row = _split(_read(trace), names)
        row["traced_ms"] = ms
        out["traced"][design] = row
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("the trace needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = run(torch.device("cuda", 0))
    print(card)
    print(json.dumps(out))
    return 0 if all(out["checks"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
