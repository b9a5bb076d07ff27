"""Where the fused sumcheck segments' time goes, on the card.

    python3 provekit_tpu_torch/experiments/segment_time.py [--out FILE]

Builds ``csrc/sumcheck_segment.cu`` twice on CUDA card 0: as the port
builds it, and with ``-DPK_SEGMENT_TRACE``, whose kernels write the card's
global timer at each phase of each round (thread 0 of block 0) and time
one more permutation and four chained Montgomery products after each
round's step, in the kernel itself.  Then:
  - ptxas's registers, stack and spills of both builds;
  - at each shape (the one-block design's (2^14, 2) and (2^14, 14), and
    every shape a poseidon2 x1000 or sha256 x100 prove launches), one
    launch of the port's build (CUDA events, median of 10: the control for
    the tracing's own cost), and one traced launch split into its phases, summed over the rounds: the pair passes (round 0's
    sums, then each fold-and-next-sums pass), the block reductions, the
    grid barriers, the scalar steps (of which the permutations, at the
    traced time of one, and the products), and the rest;
  - each kernel at n = 2^14 with 1 .. 14 rounds (the port's build, one
    launch), the time a round adds read off as the slope.
Inputs are seeded; the traced build's outputs are held to the port's.  It
prints the card's name and power limit, then one JSON line, and writes the
per-round traces to ``--out`` (default chiprun_out/segment_time.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SEED = 20261018
ONE_BLOCK_SHAPES = [("whir_segment", 1 << 14, 2),
                    ("spartan_segment", 1 << 14, 14)]
SWEEP_N = 1 << 14
TRACE = 1024  # marks of the traced build (TRACE_MAX)


def build_traced(K) -> tuple:
    """The traced library (built into the port's build directory) and what
    ptxas said of it."""
    out = K.BUILD_DIR / (K.library_path("sumcheck_segment.cu").stem
                         + "_trace.so")
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [K._nvcc(), *K.NVCC_FLAGS, "-DPK_SEGMENT_TRACE", "-o", str(out),
         str(K.CSRC / "sumcheck_segment.cu")],
        capture_output=True, text=True, check=True)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in K.SIGNATURES["sumcheck_segment.cu"].items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.pk_segment_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.pk_segment_trace.restype = ctypes.c_int
    return lib, proc.stderr


def ptxas_lines(report: str) -> list:
    return [line.strip() for line in report.splitlines()
            if "registers" in line or "spill" in line]


def phases(marks: list, rounds: int, kind: str) -> dict:
    """A traced launch's microseconds by phase, summed over its rounds.
    Marks (ns): 0 the start, 1 the end; for round j at 2 + 8 j: the pass
    before it ended, the block sum done (on the grid), the barrier passed
    (on the grid), the round's sums reduced, the step done, then the
    in-kernel time of one permutation and of four products."""
    def at(j, k):
        return marks[2 + 8 * j + k]

    out = dict(passes=0.0, block_sums=0.0, barriers=0.0, reductions=0.0,
               steps=0.0, rounds_on_grid=0)
    prev = marks[0]
    parts = 0.0
    perm, prod = [], []
    for j in range(rounds):
        out["passes"] += (at(j, 0) - prev - parts) / 1e3
        if at(j, 1):  # on the grid
            out["rounds_on_grid"] += 1
            out["block_sums"] += (at(j, 1) - at(j, 0)) / 1e3
            out["barriers"] += (at(j, 2) - at(j, 1)) / 1e3
            out["reductions"] += (at(j, 3) - at(j, 2)) / 1e3
        else:
            out["block_sums"] += (at(j, 3) - at(j, 0)) / 1e3
        out["steps"] += (at(j, 4) - at(j, 3)) / 1e3
        perm.append(at(j, 5) / 1e3)
        prod.append(at(j, 6) / 1e3)
        parts = at(j, 5) + at(j, 6)
        prev = at(j, 4)
    out["passes"] += (marks[1] - prev - parts) / 1e3  # WHIR's last fold
    out["total"] = (marks[1] - marks[0]) / 1e3
    per_round = 3 if kind == "whir_segment" else 4
    out["permutation_us"] = statistics.median(perm) if perm else 0.0
    out["four_products_us"] = statistics.median(prod) if prod else 0.0
    out["permutations_in_steps"] = per_round * rounds * out["permutation_us"]
    out["steps_besides_permutations"] = (out["steps"]
                                         - out["permutations_in_steps"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "segment_time.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import numpy as np
    import torch

    import chip_smoke as C
    from provekit_tpu_torch import kernels as K
    from provekit_tpu_torch.ops import fused
    from provekit_tpu_torch.utils.profiling import cuda_ms

    if not torch.cuda.is_available():
        raise SystemExit("segment_time: needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    reports = K.build(force=("sumcheck_segment.cu",))
    traced, traced_report = build_traced(K)
    out = {"ptxas": ptxas_lines(reports["sumcheck_segment.cu"]),
           "ptxas_traced": ptxas_lines(traced_report)}
    kernel = {"whir_segment": fused.whir_sumcheck_segment,
              "spartan_segment": fused.spartan_sumcheck_fused}
    entry = {"whir_segment": fused._PK_WHIR_SEGMENT,
             "spartan_segment": fused._PK_SPARTAN_SEGMENT}
    rng = np.random.default_rng(SEED)

    def flat(res):
        return torch.cat([t.reshape(16, -1) for t in res], dim=1)

    def traced_run(kind, call):
        """One launch through the traced build; its marks and output."""
        e = entry[kind]
        port_fn = e.fn
        e.fn = getattr(traced, e.name)
        try:
            res = flat(kernel[kind](*call))
        finally:
            e.fn = port_fn
        marks = (ctypes.c_ulonglong * TRACE)()
        if traced.pk_segment_trace(marks, TRACE) != 0:
            raise SystemExit("segment_time: reading the trace failed")
        return list(marks), res

    paths = C.path_segment_shapes()
    shapes = sorted(set(ONE_BLOCK_SHAPES) | set(paths["poseidon2_x1000"])
                    | set(paths["sha256_x100"]))
    rows, traces = [], {}
    for kind, n, r in shapes:
        call = C.segment_args(torch, rng, dev, kind, n, r, False)
        want = flat(kernel[kind](*call))
        ms = cuda_ms(lambda: kernel[kind](*call), 10)
        traced_run(kind, call)  # warm
        marks, got = traced_run(kind, call)
        if not torch.equal(got, want):
            raise SystemExit(f"segment_time: the traced build disagrees at "
                             f"{kind} {n} {r}")
        row = {"kernel": kind, "n": n, "rounds": r, "ms": ms,
               "traced": phases(marks, r, kind)}
        rows.append(row)
        traces[f"{kind} {n} {r}"] = marks[:2 + 8 * r]
        print(json.dumps(row), flush=True)
        del call, want, got
    out["shapes"] = rows
    sweep = []
    for kind in kernel:
        times = []
        for r in range(1, 15):
            call = C.segment_args(torch, rng, dev, kind, SWEEP_N, r, False)
            times.append(cuda_ms(lambda: kernel[kind](*call), 10))
        slope = float(np.polyfit(np.arange(1, 15), times, 1)[0])
        sweep.append({"kernel": kind, "n": SWEEP_N, "ms_by_rounds": times,
                      "ms_a_round": slope})
    out["sweep"] = sweep
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"summary": out, "marks": traces}))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
