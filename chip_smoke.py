#!/usr/bin/env python3
"""Smoke run of the torch port (provekit_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one or more lines each:
  1. card and toolchain (nvidia-smi name, power limit and maximum SM clock,
     torch, CUDA, nvcc, g++);
  2. build of the CUDA kernels from provekit_tpu_torch/csrc (one nvcc per
     source, in parallel), with its time and what ptxas reports of the
     Skyscraper, segment, tensor-core Montgomery and NTT pass kernels
     (registers, spills); it fails if either segment kernel spills.  Beside
     them, g++ builds the port's two host libraries from
     provekit_tpu_torch/native
     (native/build.py: the curve engine, and the host library of the
     witness solve, the host sponge's permutation, Merkle path and PoW
     checks), with their time;
  3. each kernel against its plain torch version on the card at the shapes
     its path gives it: exact equality, both times (CUDA events, median) and
     the kernel's bound.  The NTT's pass kernel (csrc/ntt_stage.cu) runs one
     stage a launch on K3's route at 2^21 and on K2's at the sha256 x100
     path's (16, 2^25) stages; the encodes of every size 2^1 .. 2^22 and
     the inverse transforms, with edge values, against the plain transform;
     then the paths' RS domains 2^21, 2^24 and 2^25: the encode against
     the plain one and through the stage-by-stage path, the launches of one
     encode and the device kernels it runs, and each pass of its plan
     against its plain version (one launch, back to back, its bound), a row
     a pass in the kernel JSON (K3's and K2's rows: their route's first
     pass on poseidon2 x1000's and sha256 x100's path); mont_mul,
     compress and the leaf fold run at the largest leaf shapes of that
     path's commitment; the tensor-core Montgomery product runs at 2^21
     beside the CIOS kernel, and at n = 1, 3, 64 and 4133 and on edge
     values.  The Skyscraper kernels also run at PoW's
     broadcast shape and on edge values (0, 1, P - 1, P - 2, 2^253, inputs
     whose S-box output reaches 4P); the leaf fold at every leaf shape of
     the poseidon2 x1000 prove, beside single-step launches on the host's
     wall clock; the duplex absorbs and squeezes at the transcript's counts
     and in the fused round steps' calls, and the sponge's serial chain runs
     as 200 permute calls beside one 200-output squeeze.  The fused
     sumcheck segments (csrc/sumcheck_segment.cu, cooperative launches over
     the card) run at every (n, rounds) that a prove of each of the four
     paths of phases 6-9 launches (poseidon2 x1000, sha256 x100, the
     passport, the mul_chain inner prove; every sumcheck is one launch),
     held to the plain version up to 2^20 elements and to the same
     per-round loop in plain torch on the card above, with their bound and
     the floor of the sponge's serial chain; at the one-block design's
     shapes (2^14, 14) and (2^14, 2); and at 0, 1 and all rounds on the
     edge values 0, 1 and P - 1; each path's prove is then held to launch
     exactly those shapes.  The host library's permutation and
     compression are held exactly to the Python version and to K5 and K4
     on the card, on every pair of the edge values and on seeded random
     pairs, with the microseconds a call of each on the host;
  4. the tensor-core Montgomery experiment (experiments/mxu_mont.py: K6
     against K1 at 2^18, 2^20 and 2^21), then experiments/mxu_trace.py:
     K6, its earlier design (mma.sync, one element a thread) and K1 timed
     in turns at 2^21, and K6 and the earlier design split by phase from
     traced builds, printed as one JSON line of its own;
  5. the tiny scheme on the card: pinned proof digest, verify, tamper;
  6. poseidon2 x1000 at security 128 through the port's entry points:
     build, from_program, solve_witness (the native solve, the default;
     then once more beside the plain Python solve, use_native=False, whose
     witness must be equal, both timed), a warm-up prove (its segment
     launches held to the shapes phase 3 ran for this path), a timed prove (its five
     spans, each kernel's launch count, the sponge's permutations, the peak
     device memory and the pinned proof digest), one more prove under
     torch.profiler, recording device kernels only (device busy share and
     the share of the kernels that run the Skyscraper ladder; the kernel
     table goes to chiprun_out/chip_smoke_profile_poseidon.txt), then a
     warm-up, a timed and a profiled prove with FUSE_MAX = 0 (every
     sumcheck round one at a time, no segment;
     chip_smoke_profile_poseidon_unfused.txt), verify (the host sponge,
     Merkle path and PoW checks in the host library), verify once more with
     the plain Python hash swapped in (plain_host_hash; both must accept,
     both timed), and a flipped byte rejected;
  7. sha256 x100 (RS domain 2^25) at security 128, the same stages but the
     FUSE_MAX = 0 proves and the plain solve, with a progress line per
     stage;
  8. the front door: each Noir fixture of tests/fixtures through the CLI
     (prepare; prove from a Prover.toml through the ACVM and Brillig VM,
     whose witness values are checked; verify), then the passport circuit
     (passport_test_vector(seed=1) with its ECDSA P-256 signature, 1,590,897
     constraints, RS domain 2^24) at security 128: its circuit and witness
     JSON, the CLI's prepare and prove --verify in this process (each CLI
     span, the launch counts and segment shapes around prove, the peak
     device memory, the proof size, the native solve's time; then the
     native and the plain solve of the same scheme and values, whose
     witnesses must be equal, and its verify with the host library and with
     the plain host hash, all timed), and the verify service as a
     child process on its scheme, which must answer 200, 400, 400 and 404
     (the proof, a flipped byte, a malformed body, a wrong path);
  9. the recursive-verifier path: (a) the gnark export at full width, the
     passport's .nps and .np of phase 8 through `cli generate-gnark-inputs`
     and poseidon2 x1000's scheme and proof of phase 6 through
     `io.gnark.write_gnark_inputs`, each output walked by the port's
     go_parse (the transcript consumed exactly, `prepare` accepting it);
     (b) the Groth16 wrap through the CLI: the mul_chain fixture through
     `prepare` and `prove` at security 30 (the inner prove's launches
     counted, its segment shapes held to phase 3's), `recursive-verify --keys` twice (the setup writes the keys,
     the second run loads them; both print OK), and the same with one
     transcript byte of the proof flipped, which must exit non-zero.  The
     wrap runs on the host (the port's curve engine, built with g++ from
     provekit_tpu_torch/native/curve.cpp) and launches no kernel;
 10. the sharded prover (provekit_tpu_torch.parallel, SPMD over
     torch.distributed): (a) the six sharded functions (Spartan and WHIR
     round sums and folds, the four-step NTT, the Merkle root) on four
     ranks that share the card over gloo, at the poseidon2 x1000 path's
     shapes (Spartan (16, 4, 2^19), WHIR (16, 2, 2^20), the NTT at 2^21,
     leaves (16, 32, 2^17)), each exactly against its single-device
     counterpart on the card, the collectives' calls and bytes against
     their model; then poseidon2 x1000 at security 128 from phase 6's
     scheme, witness and rng state, (b) under make_mesh(1) in this
     process, (c) on one rank over NCCL, (d) on four ranks sharing the card
     over gloo (each with a warm-up prove; every proof to the pinned
     digest, rank 0's verified; each rank's spans, wall, launches, peak
     device memory and collectives by stage, beside phase 6's FUSE_MAX = 0
     prove); (e) the CM31 NTT at 2^20 on the card against the CPU.  The
     ranks load the kernels and host libraries of phase 2.  Budget 240 s.
The line before the last is the kernel JSON, the one before it the card's
name and power limit; the last line is {"ok": true, "device": {...}}.  Any
failure exits non-zero before them.  The script needs a CUDA card and the
repository beside it; it imports no JAX.
"""

import collections
import contextlib
import hashlib
import json
import random
import subprocess
import sys
import time

from provekit_tpu_torch.protocol.examples import build_system as \
    build_tiny_system
from provekit_tpu_torch.protocol.examples import tiny_scheme
from provekit_tpu_torch.utils.counts import (SEGMENT_KERNELS,
                                             kernel_counters, read_counts,
                                             reset_counts)
from provekit_tpu_torch.utils.profiling import back_to_back_ms

TINY_DIGEST = "efa6851f51a1090ab1139f427a9a67daa4b2c16037937f0e853bb8db0c5cbfb0"
# the proofs of phases 6 and 7 (their rng is seeded)
POSEIDON_DIGEST = \
    "dface69169218b929caf687005cc1e38e7bd563507b2a1fa527127f886b98bd7"
SHA256_DIGEST = \
    "0d17f27325b1514308c5cc804346f8b5d6251838ee4cdf7f0dc15881edb8626a"
TPU_KERNELS = "provekit_tpu/ops/pallas_kernels.py"
SEED = 20261016
T0 = time.perf_counter()

# Peak rates of one H100 SXM: HBM bytes/s and int8 tensor-core operations/s
# (NVIDIA's published figures, 700 W); 32-bit integer multiply-adds at 64 a
# clock on each of the 132 SMs (compute capability 9.0, the
# arithmetic-throughput table of the CUDA C++ Programming Guide) at the
# card's maximum SM clock.
HBM_BYTES_S = 3.35e12
INT8_TENSOR_OPS_S = 1979e12
SMS = 132
INT32_MULADDS_PER_SM_CLOCK = 64
# Multiply-adds of the least work on 8 x 32-bit limbs.  A 32 x 32 -> 64-bit
# limb product needs its low and its high word: two.  A reduction factor
# m = u[i] * N' mod 2^32 needs only its low word: one.  A Montgomery product
# (CIOS) takes 64 + 64 limb products and 8 factors, a Montgomery square
# 36 + 64 and 8; a Skyscraper permutation needs 14 squares (its 4 bar steps
# multiply nothing).
MONT_MUL_MULADDS = 2 * (64 + 64) + 8
MONT_SQR_MULADDS = 2 * (36 + 64) + 8
LADDER_SQUARES = 14
PLANE_BYTES = 64  # one field element: 16 digit planes of int32
FUSED_PY = "provekit_tpu/ops/fused.py"
# the kernels every prove of phases 6-9 launches (sha256 x100 adds K2's
# route of the NTT's passes)
ON_PATH = ["mont_mul", "ntt_pass", "ntt_stage", "compress", "compress_fold",
           "duplex", *SEGMENT_KERNELS]
# the RS domain of each path's witness commitment: its passes' rows
NTT_PATHS = {21: "poseidon2_x1000", 24: "passport_cli", 25: "sha256_x100"}
# phase 3 holds the NTT of every size up to 2^this to its plain version
NTT_CHECK_MAX_LOG = 23


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def peak_rates(sm_clock_mhz: float) -> dict:
    """Operations a second by unit, at a maximum SM clock in MHz."""
    return {"int8_tensor": INT8_TENSOR_OPS_S,
            "int32_muladd": SMS * INT32_MULADDS_PER_SM_CLOCK
            * sm_clock_mhz * 1e6}


def mont_mul_ops(n: int) -> dict:
    return {"int32_muladd": MONT_MUL_MULADDS * n}


def ladder_ops(permutations: int) -> dict:
    return {"int32_muladd": MONT_SQR_MULADDS * LADDER_SQUARES * permutations}


def bound(nbytes: float, ops: dict, rates: dict) -> tuple[float, str]:
    """(least ms, what bounds it) for moving ``nbytes`` and doing ``ops``
    (operations by unit) at the peak ``rates`` (:func:`peak_rates`)."""
    times = {"bytes": nbytes / HBM_BYTES_S * 1e3}
    for unit, count in ops.items():
        times[f"operations ({unit})"] = count / rates[unit] * 1e3
    by = max(times, key=times.get)
    return times[by], "bytes" if by == "bytes" else "operations"


def path_counts(counters) -> dict:
    """read_counts, with the NTT passes' launches by geometry
    (``ntt_pass.shapes``)."""
    out = read_counts(counters)
    out["ntt_pass_shapes"] = dict(counters["ntt_pass"].shapes)
    return out


def fixture_cases() -> dict:
    """Noir fixture (tests/fixtures/<name>.json) -> (its Prover.toml inputs
    by ABI name, the ACVM witness values tests/test_acir_fixtures.py
    asserts for them)."""
    from provekit_tpu_torch.fields import bn254 as F
    return {
        "mul_chain": ({"x": 6, "y": 7}, {2: 42, 3: 42 * 42}),
        "rom_reads": ({"x": 11, "y": 13}, {2: 11, 3: 13, 4: 143}),
        "brillig_inverse": ({"x": 12345}, {1: F.inv(12345)}),
        "range_and_xor": ({"a": 0xA5, "b": 0x3C},
                          {2: 0xA5 & 0x3C, 3: 0xA5 ^ 0x3C}),
    }


def prover_toml(inputs: dict) -> str:
    """A Prover.toml of scalar inputs, each a quoted decimal."""
    return "".join(f'{name} = "{value}"\n' for name, value in inputs.items())


def verify_requests(proof: bytes) -> list:
    """(path, body, expected status) of the verify service's checks: the
    proof, the proof with its middle byte flipped, a malformed body, and
    the proof sent to a wrong path."""
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1

    def body(transcript: bytes) -> bytes:
        return json.dumps({"transcript": transcript.hex()}).encode()

    return [("/api/v1/verify", body(proof), 200),
            ("/api/v1/verify", body(bytes(bad)), 400),
            ("/api/v1/verify", b'{"transcript": "not hex', 400),
            ("/api/v1/prove", body(proof), 404)]


def post(port: int, path: str, data: bytes, timeout: float = 600) -> int:
    """HTTP status of a POST of ``data`` to ``path`` on this host (a
    direct connection: no proxy setting applies)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=data,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        return resp.status
    finally:
        conn.close()


def random_planes(torch, rng, n: int, device):
    """(16, n) canonical field elements from a numpy Generator."""
    import numpy as np
    digits = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    digits[15] = rng.integers(0, 0x3064, size=n)  # top digit < P's: value < P
    return torch.from_numpy(digits.astype(np.int32)).to(device)


def max_abs_err(torch, a, b) -> int:
    if a.shape != b.shape:
        fail(f"shapes differ: {tuple(a.shape)} against {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def wall_ms(torch, fn, reps: int = 1) -> float:
    """Median host milliseconds of ``fn()`` from a synchronized card to a
    synchronized card, after one warm-up run: the host's launch work
    counts, as it does in a prove."""
    import statistics
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def fold_by_steps(S, leaves):
    """A (16, leaf_size, n) leaf fold as leaf_size - 1 single-step compress
    launches (what ``merkle.hash_leaves`` ran before the fold kernel)."""
    h = leaves[:, 0, :]
    for i in range(1, leaves.shape[1]):
        h = S.compress_v(h, leaves[:, i, :])
    return h


def timed_once(torch, fn):
    """(result, ms) of one run of a slow plain version, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_toolchain(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rates = peak_rates(float(clock))
    from provekit_tpu_torch import kernels as K
    nvcc = subprocess.run([K._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"[1] {card}")
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} nvcc: {nvcc[-1]}; g++: {gxx}")
    log(f"[1] maximum SM clock {clock} MHz: 32-bit integer multiply-adds at "
        f"{rates['int32_muladd'] / 1e12:.3f} T/s")
    return card, rates


def ptxas_spills(report: str) -> dict:
    """Kernel (mangled name) -> (spill store bytes, spill load bytes), from
    what ``ptxas -v`` printed for one source."""
    import re
    out, name = {}, None
    for line in report.splitlines():
        found = re.search(r"Function properties for (\S+)", line)
        if found:
            name = found.group(1)
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if found and name:
            out[name] = (int(found.group(1)), int(found.group(2)))
            name = None
    return out


def check_segment_spills(report: str) -> None:
    """Fail unless ptxas reported both segment kernels, neither spilling."""
    spills = ptxas_spills(report)
    for kernel in ("whir_segment_kernel", "spartan_segment_kernel"):
        mine = [v for k, v in spills.items() if kernel in k]
        if not mine:
            fail(f"ptxas reported nothing of {kernel}")
        if any(v != (0, 0) for v in mine):
            fail(f"{kernel} spills: {mine} bytes (stores, loads)")
    log("[2] sumcheck_segment.cu: neither segment kernel spills")


def build_host_libraries(out: dict) -> None:
    """Build the port's host libraries with g++ (native/build.py), one
    after the other; ``out`` gets each one's path and seconds, or the
    error."""
    from provekit_tpu_torch.native import build as NB
    try:
        for lib in NB.LIBRARIES:
            t0 = time.perf_counter()
            path = NB.make(lib)
            out[lib.name] = (path.name, time.perf_counter() - t0)
    except RuntimeError as exc:
        out["error"] = str(exc)


def phase_build():
    import threading

    from provekit_tpu_torch import kernels as K
    host = {}
    gxx = threading.Thread(target=build_host_libraries, args=(host,))
    t0 = time.perf_counter()
    gxx.start()
    # the segments are compiled in any case: their spills are checked
    reports = K.build(force=("sumcheck_segment.cu",))
    K.lib()
    log(f"[2] {len(K.SIGNATURES)} kernel libraries built in "
        f"{time.perf_counter() - t0:.3f} s")
    gxx.join()
    if "error" in host:
        fail(f"the host libraries did not build: {host['error']}")
    log("[2] host libraries built with g++ beside them: "
        + ", ".join(f"{name} ({path}) in {sec:.3f} s"
                    for name, (path, sec) in host.items()))
    for src in ("skyscraper.cu", "sumcheck_segment.cu", "mont_mul_mma.cu",
                "ntt_stage.cu"):
        for line in reports.get(src, "").splitlines():
            if "ptxas info" in line or "spill" in line:
                log(f"[2] {src} {line.strip()}")
    check_segment_spills(reports["sumcheck_segment.cu"])


class Rows:
    """The kernel table of phase 3: one row per kernel, checked as added."""

    def __init__(self, torch, rates):
        self.torch = torch
        self.rates = rates
        self.rows = {}

    def check(self, name, shape, got, want, ms=None, plain_ms=None,
              nbytes=None, ops=None, record=True, **row):
        self.torch.cuda.synchronize()
        err = max_abs_err(self.torch, got, want)
        line = f"[3] {name} {shape}: equal={err == 0}"
        if ms is not None:
            line += f" kernel {ms:.4f} ms"
        if plain_ms is not None:
            line += f", plain {plain_ms:.4f} ms"
        if nbytes is not None:
            bound_ms, bound_by = bound(nbytes, ops, self.rates)
            line += f", bound {bound_ms:.4f} ms ({bound_by})"
            row.update(bound_ms=bound_ms, bound_by=bound_by)
        log(line)
        if err:
            fail(f"{name} {shape} disagrees with its plain version")
        if row and record:
            self.rows[name] = dict(row, max_abs_err=err, ms=ms,
                                   plain_ms=plain_ms, shape=shape)
        return err


def phase_kernels(torch, dev, rates):
    """Each kernel against its plain version at the shapes of its path.
    Returns the rows and each path's segment shapes (:func:`phase_segments`)."""
    import numpy as np
    from provekit_tpu_torch.experiments import mxu_mont as M
    from provekit_tpu_torch.fields import vector as V
    from provekit_tpu_torch.hash import skyscraper as S
    from provekit_tpu_torch.ops import ntt
    from provekit_tpu_torch.utils.profiling import cuda_ms

    rng = np.random.default_rng(SEED)
    rows = Rows(torch, rates)

    n = 1 << 21
    a = random_planes(torch, rng, n, dev)
    b = random_planes(torch, rng, n, dev)
    rows.check("mont_mul", "n=2^21", V.mont_mul(a, b), V.mont_mul_plain(a, b),
               cuda_ms(lambda: V.mont_mul(a, b), 20),
               cuda_ms(lambda: V.mont_mul_plain(a, b), 3),
               nbytes=3 * PLANE_BYTES * n,
               ops=mont_mul_ops(n),
               source="mont_mul.cu", replaces=f"{TPU_KERNELS}:74")

    # one stage a launch (the k = 1 pass of ntt_stage, K3's earlier shape)
    stage_ms = {}
    for chunk in (1, 1024, 2048):
        tw = ntt._twiddle_table((n // chunk).bit_length() - 1, False, dev)
        s = 1
        steps = n // (2 * chunk)
        ms = cuda_ms(lambda: ntt.ntt_stage(a, tw, s, chunk), 20)
        if chunk == 1024:
            stage_ms["ntt_stage"] = ms
        rows.check("ntt_stage", f"n=2^21 chunk={chunk} s={s} (k = 1)",
                   ntt.ntt_stage(a, tw, s, chunk),
                   ntt.ntt_stage_plain(a, tw, s, chunk), ms,
                   cuda_ms(lambda: ntt.ntt_stage_plain(a, tw, s, chunk), 3),
                   nbytes=2 * PLANE_BYTES * n
                   + PLANE_BYTES * (((steps - 1) >> s) + 1),
                   ops=mont_mul_ops(n // 2), record=False)

    # the tensor-core Montgomery product at K1's shape, beside K1
    rows.check("mont_mul_mma", "n=2^21 against mont_mul_plain",
               M.mont_mul_mma(a, b), V.mont_mul_plain(a, b))
    got = M.mont_mul_mma(a, b)
    want, plain_ms = timed_once(torch, lambda: M.mont_mul_mma_plain(a, b))
    rows.check("mont_mul_mma", "n=2^21", got, want,
               cuda_ms(lambda: M.mont_mul_mma(a, b), 20), plain_ms,
               nbytes=3 * PLANE_BYTES * n,
               ops={"int8_tensor": n * 2 * (32 + 64) * 32,
                    "int32_muladd": n * 2 * 64},
               source="mont_mul_mma.cu",
               replaces="scripts/mxu_mont_experiment.py:244")
    # one launch a sample includes the host's launch work; back to back
    # leaves it out
    for name, fn in (("mont_mul_mma", lambda: M.mont_mul_mma(a, b)),
                     ("mont_mul", lambda: V.mont_mul(a, b))):
        rows.rows[name]["back_to_back_ms"] = back_to_back_ms(fn)
    k6, k1 = rows.rows["mont_mul_mma"], rows.rows["mont_mul"]
    log(f"[3] mont_mul_mma beside mont_mul at n=2^21: {k6['ms']:.4f} ms "
        f"against {k1['ms']:.4f} ms, back to back "
        f"{k6['back_to_back_ms']:.4f} against {k1['back_to_back_ms']:.4f} "
        f"ms (bound {k6['bound_ms']:.4f} ms)")
    # tails (n % 4 != 0 takes the kernel's plain fill) and edge values
    for m in (1, 3, 64, 4096 + 37):
        x, y = a[:, :m].contiguous(), b[:, :m].contiguous()
        rows.check("mont_mul_mma", f"n={m}", M.mont_mul_mma(x, y),
                   M.mont_mul_mma_plain(x, y))
    x, y = M.edge_operands(dev)
    rows.check("mont_mul_mma", f"edge values, {x.shape[1]} pairs",
               M.mont_mul_mma(x, y), M.mont_mul_mma_plain(x, y))

    phase_skyscraper(torch, rows, dev, a, b)
    phase_host_hash(torch, dev)
    segments = phase_segments(torch, rng, rows, dev)
    phase_poseidon_leaves(torch, rng, rows, dev)
    del a, b

    # one stage a launch at the sha256 x100 path's phase-2 stages (16, 2^25),
    # chunk 8192 (n1 = 2^13), half 2^24, on K2's route; and on K3's
    n = 1 << 25
    chunk = 1 << 13
    x = random_planes(torch, rng, n, dev)
    tw = ntt._twiddle_table(12, False, dev)
    steps = n // 2 // chunk
    for s in (0, 11):
        want, plain_ms = timed_once(
            torch, lambda: ntt.ntt_stage_plain(x, tw, s, chunk))
        ms = cuda_ms(lambda: ntt.butterfly(x, tw, s, chunk), 10)
        if s == 0:
            stage_ms["butterfly"] = ms
        rows.check("butterfly", f"n=2^25 chunk=8192 s={s} (k = 1)",
                   ntt.butterfly(x, tw, s, chunk), want, ms, plain_ms,
                   nbytes=2 * PLANE_BYTES * n
                   + PLANE_BYTES * (((steps - 1) >> s) + 1),
                   ops=mont_mul_ops(n // 2), record=False)
        del want
        rows.check("ntt_stage", f"n=2^25 chunk=8192 s={s} (k = 1)",
                   ntt.ntt_stage(x, tw, s, chunk),
                   ntt.butterfly(x, tw, s, chunk))
    del x
    phase_leaves(torch, rng, rows, dev)
    phase_ntt(torch, rng, rows, dev, stage_ms)
    return rows.rows, segments


def phase_ntt(torch, rng, rows, dev, stage_ms) -> None:
    """The NTT on the pass kernel: every size 2^1 .. 2^22 forward (on half
    as many coefficients: the zero padding) and inverse, and the edge
    values, against the plain transform; then the paths' RS domains 2^21,
    2^24 and 2^25: the encode against the plain one, each pass against its
    plain version (one launch, back to back, its bound), the launches of
    one encode and the device kernels the profiler sees it run.  Records a
    row a pass and the K3 and K2 rows (their route's main-path pass, with
    the one-stage times of ``stage_ms``)."""
    from provekit_tpu_torch.fields import bn254 as F
    from provekit_tpu_torch.fields import vector as V
    from provekit_tpu_torch.ops import ntt
    from provekit_tpu_torch.utils.profiling import cuda_ms, device_kernels

    for log_n in range(1, NTT_CHECK_MAX_LOG + 1):
        n = 1 << log_n
        x = random_planes(torch, rng, n, dev)
        if log_n in (2, 13, 21):
            x[:, :3 * (n // 4)] = V.pack([0, 1, F.P - 1], dev).repeat(
                1, n)[:, :3 * (n // 4)]
        half = x[:, :max(1, n // 2)].contiguous()
        for what, got, want in (
                ("rs_encode", lambda: ntt.rs_encode(half, log_n),
                 lambda: ntt.rs_encode(half, log_n, plain=True)),
                ("intt", lambda: ntt.intt(x),
                 lambda: ntt._ntt_core(x, log_n, True, plain=True))):
            err = max_abs_err(torch, got(), want())
            if err:
                fail(f"{what} at 2^{log_n} differs from its plain version")
    log(f"[3] rs_encode (2^(k-1) -> 2^k) and intt at 2^1 .. "
        f"2^{NTT_CHECK_MAX_LOG} equal their plain versions (edge values 0, "
        f"1, P - 1 at 2^2, 2^13, 2^21)")

    for log_n, path in NTT_PATHS.items():
        n = 1 << log_n
        coeffs = random_planes(torch, rng, n // 2, dev)
        want, plain_ms = timed_once(
            torch, lambda: ntt.rs_encode(coeffs, log_n, plain=True))
        passes = ntt.plan(log_n)
        tables = ntt.scale_tables(log_n, False, dev)
        products = sum(ntt.pass_work(p, n // 2)[1] for p in passes)
        before = ntt.ntt_pass.launches
        got = ntt.rs_encode(coeffs, log_n)
        launches = ntt.ntt_pass.launches - before
        ms = cuda_ms(lambda: ntt.rs_encode(coeffs, log_n), 10)
        b2b = back_to_back_ms(lambda: ntt.rs_encode(coeffs, log_n))
        rows.check("rs_encode", f"2^{log_n - 1} -> 2^{log_n}", got, want, ms,
                   plain_ms, nbytes=PLANE_BYTES * (n // 2 + n),
                   ops=mont_mul_ops(products), record=False)
        bound_ms, bound_by = bound(PLANE_BYTES * (n // 2 + n),
                                   mont_mul_ops(products), rows.rates)
        # the profiler's record of one encode: every kernel a pass, every
        # route of the plan seen, no more records than passes (in this
        # process it has lost one of the 2^25 encode's phase-1 records in
        # every window, PERF.md section 7; the launch count is the wrapper's)
        kernels = device_kernels(lambda: ntt.rs_encode(coeffs, log_n))
        seen = collections.Counter(kernels)
        routes = {f"ntt_pass_kernel<{ntt.ROUTES.index(p.route)},"
                  for p in passes}
        log(f"[3] rs_encode 2^{log_n - 1} -> 2^{log_n}: {launches} launches "
            f"of pk_ntt_pass ({', '.join(str(p.k) for p in passes)} stages),"
            f" {ms:.4f} ms, back to back {b2b:.4f} ms; the transform's bound "
            f"{bound_ms:.4f} ms ({bound_by}; {products} products); device "
            f"kernels of one encode: {dict(seen)}")
        if launches != len(passes) or len(kernels) > len(passes) or any(
                "ntt_pass_kernel" not in k for k in kernels) or {
                r for r in routes if not any(r in k for k in kernels)}:
            fail(f"rs_encode at 2^{log_n}: {launches} launches, kernels "
                 f"{dict(seen)}, for a plan of {len(passes)} passes")
        del got, want
        xin, in_len = coeffs, n // 2
        for i, p in enumerate(passes):
            tw = ntt.pass_twiddles(p, False, dev)
            out = ntt._launch(p, xin, tw, tables)
            want, pass_plain_ms = timed_once(
                torch, lambda: ntt.pass_plain(p, xin, tw, tables))
            nbytes, count = ntt.pass_work(p, in_len)
            key = f"ntt_pass 2^{log_n} {i + 1}/{len(passes)}"
            rows.check(key, p.key, out, want,
                       cuda_ms(lambda: ntt._launch(p, xin, tw, tables), 10),
                       pass_plain_ms, nbytes=nbytes, ops=mont_mul_ops(count),
                       kernel="ntt_pass", geometry=p.key, path=path,
                       route_of=p.route, source="ntt_stage.cu",
                       replaces=f"{TPU_KERNELS}:"
                       + ("113" if p.route == "butterfly" else "174"),
                       back_to_back_ms=back_to_back_ms(
                           lambda: ntt._launch(p, xin, tw, tables)),
                       transform_ms=ms, transform_back_to_back_ms=b2b,
                       transform_bound_ms=bound_ms, transform_plain_ms=plain_ms)
            del want
            xin, in_len = out, p.n
        del xin, out, coeffs
        torch.cuda.empty_cache()
    # the K3 and K2 rows: the first pass of each route on its path, beside
    # the one-stage launch of that route (k = 1)
    for name, path in (("ntt_stage", "poseidon2_x1000"),
                       ("butterfly", "sha256_x100")):
        key = next(k for k, r in rows.rows.items()
                   if r.get("path") == path and r.get("route_of") == name)
        row = dict(rows.rows[key], stage_ms=stage_ms[name])
        for k in ("kernel", "geometry", "path"):
            row.pop(k)
        rows.rows[name] = row
    # the plain transform's cached tables (2 GiB of cross twiddles at
    # 2^25), so that the paths' peak memory counts only what each prove
    # holds
    for cached in (ntt._twiddle_table, ntt._twiddle_packed,
                   ntt._cross_twiddles, ntt.scale_tables, ntt._bitrev_index):
        cached.cache_clear()
    torch.cuda.empty_cache()


def phase_skyscraper(torch, rows, dev, a, b):
    """K4 and K5 (csrc/skyscraper.cu) against their plain versions: compress
    at 2^17 and 2^20, at PoW's broadcast shape and on edge values; the leaf
    fold and permute on edge values, permute at n = 1 and 2^17; the duplex
    at the transcript's absorb and squeeze counts and from edge states; the
    sponge's serial chain as 200 permute calls and as one squeeze."""
    from provekit_tpu_torch.fields import vector as V
    from provekit_tpu_torch.hash import skyscraper as S
    from provekit_tpu_torch.utils.profiling import cuda_ms

    for logn in (17, 20):
        m = 1 << logn
        l, r = a[:, :m], b[:, :m]
        extra = {}
        if logn == 20:
            extra = dict(nbytes=3 * PLANE_BYTES * m, ops=ladder_ops(m),
                         source="skyscraper.cu",
                         replaces=f"{TPU_KERNELS}:233")
        rows.check("compress", f"n=2^{logn}", S.compress_v(l, r),
                   S.compress_plain(l, r),
                   cuda_ms(lambda: S.compress_v(l, r), 20),
                   cuda_ms(lambda: S.compress_plain(l, r), 3), **extra)
    log(f"[3] 20 launches back to back, per launch: compress n=2^20 "
        f"{back_to_back_ms(lambda: S.compress_v(l, r)):.4f} ms, "
        f"mont_mul n=2^21 "
        f"{back_to_back_ms(lambda: V.mont_mul(a, b)):.4f} ms")
    # PoW (ops/pow.py): one challenge at column stride 0 against a block of
    # 32-bit nonces
    nonces = torch.zeros((16, 1 << 16), dtype=torch.int32, device=dev)
    nonces[0] = torch.arange(1 << 16, dtype=torch.int32, device=dev) & 0xFFFF
    nonces[1] = 0x1234
    ch = a[:, :1]
    rows.check("compress", "PoW: (16, 1) challenge against 2^16 nonces",
               S.compress_v(ch, nonces), S.compress_plain(ch, nonces))

    edge = V.pack(S.edge_values(SEED), dev)
    e = edge.shape[1]
    el, er = edge.repeat_interleave(e, dim=1), edge.repeat(1, e)
    rows.check("compress", f"edge values, {e * e} pairs",
               S.compress_v(el, er), S.compress_plain(el, er))
    rows.check("permute", f"edge values, {e * e} pairs",
               torch.cat(S.permute_v(el, er), 1),
               torch.cat(S.permute_plain(el, er), 1))
    leaves = torch.stack([el, er, el.flip(1)], dim=1)
    rows.check("compress_fold", f"edge values, (16, 3, {e * e})",
               S.compress_fold_v(leaves), S.compress_fold_plain(leaves))
    for m in (1, 1 << 17):
        l, r = a[:, :m], b[:, :m]
        rows.check("permute", f"n={m}", torch.cat(S.permute_v(l, r), 1),
                   torch.cat(S.permute_plain(l, r), 1),
                   cuda_ms(lambda: S.permute_v(l, r), 10))

    # the duplex at the transcript's counts: absorbs of 1 unit (a root, a
    # PoW nonce), 4 and 8 from either position, squeezes of 1, 3 and a STIR
    # query draw of 100; then one absorb-and-squeeze from each edge state
    state = torch.cat([edge[:, 3:4], a[:, :1]], dim=1)
    units = torch.cat([edge, a[:, :8]], dim=1)
    for k in (1, 4, 8):
        for start in (0, 1):
            arr = units[:, :k]
            rows.check("duplex", f"absorb k={k} from position {start}",
                       torch.cat(S.duplex_v(state, arr, start, 0), 1),
                       torch.cat(S.duplex_plain(state, arr, start, 0), 1))
    # the fused round steps: absorb a round's 3 (WHIR) or 4 (Spartan)
    # messages from position 0 and squeeze its challenge, in one launch
    for k in (3, 4):
        arr = units[:, :k]
        rows.check("duplex", f"absorb k={k} from position 0, squeeze 1",
                   torch.cat(S.duplex_v(state, arr, 0, 1), 1),
                   torch.cat(S.duplex_plain(state, arr, 0, 1), 1))
    for n in (1, 3, 100):
        rows.check("duplex", f"squeeze n={n}",
                   torch.cat(S.duplex_v(state, None, 0, n), 1),
                   torch.cat(S.duplex_plain(state, None, 0, n), 1))
    bad = []
    for i in range(e):
        st = torch.cat([edge[:, i:i + 1], edge[:, e - 1 - i:e - i]], dim=1)
        got = torch.cat(S.duplex_v(st, edge[:, :2], 1, 2), 1)
        if max_abs_err(torch, got, torch.cat(
                S.duplex_plain(st, edge[:, :2], 1, 2), 1)):
            bad.append(i)
    if bad:
        fail(f"duplex disagrees with its plain version from edge states {bad}")
    log(f"[3] duplex from {e} edge states, absorb 2 then squeeze 2: "
        f"equal=True")

    # the sponge's serial chain: 200 dependent permutations as n = 1 calls
    # of permute, and as one squeeze of the duplex
    calls = 200
    l0, r0 = a[:, :1], b[:, :1]

    def chain(fn):
        l, r = l0, r0
        for _ in range(calls):
            l, r = fn(l, r)
        return torch.cat([l, r], dim=1)

    # the plain squeeze is the same 200 permute_plain calls, and its final
    # state the chain's
    state = torch.cat([l0, r0], dim=1)
    (st_want, out_want), plain_ms = timed_once(
        torch, lambda: S.duplex_plain(state, None, 0, calls))
    rows.check("permute", f"{calls} sequential n=1 calls, per call",
               chain(S.permute_v), st_want,
               cuda_ms(lambda: chain(S.permute_v), 3) / calls,
               plain_ms / calls, nbytes=4 * PLANE_BYTES, ops=ladder_ops(1),
               source="skyscraper.cu", replaces=f"{TPU_KERNELS}:297")
    got_state, got_out = S.duplex_v(state, None, 0, calls)
    rows.check("duplex", f"one squeeze of {calls}, per permutation",
               torch.cat([got_state, got_out], 1),
               torch.cat([st_want, out_want], 1),
               cuda_ms(lambda: S.duplex_v(state, None, 0, calls), 5) / calls,
               plain_ms / calls, nbytes=4 * PLANE_BYTES, ops=ladder_ops(1),
               source="skyscraper.cu", replaces=f"{TPU_KERNELS}:297")
    rows.check("duplex", f"squeeze of {calls} against {calls} permute calls",
               got_state, chain(S.permute_v))
    chain_ms = wall_ms(torch, lambda: chain(S.permute_v))
    squeeze_ms = wall_ms(torch, lambda: S.duplex_v(state, None, 0, calls))
    log(f"[3] serial chain of {calls} permutations, host wall clock per "
        f"permutation: permute calls {chain_ms / calls:.4f} ms, one duplex "
        f"squeeze {squeeze_ms / calls:.4f} ms")


def host_hash_pairs(seed: int, count: int) -> list:
    """(l, r) canonical pairs for the host library's hash: every pair of
    the edge values (``skyscraper.edge_values``), then ``count`` pairs drawn
    from ``seed``."""
    import numpy as np

    from provekit_tpu_torch.fields import bn254 as F
    from provekit_tpu_torch.hash import skyscraper as S
    edge = S.edge_values(seed)
    pairs = [(l, r) for l in edge for r in edge]
    rng = np.random.default_rng(seed)
    draw = [int.from_bytes(rng.bytes(32), "little") % F.P
            for _ in range(2 * count)]
    return pairs + list(zip(draw[0::2], draw[1::2]))


def per_call_us(fn, pairs) -> tuple[list, float]:
    """(results, host microseconds a call) of ``fn(l, r)`` over ``pairs``."""
    t0 = time.perf_counter()
    out = [fn(l, r) for l, r in pairs]
    return out, (time.perf_counter() - t0) / len(pairs) * 1e6


def phase_host_hash(torch, dev):
    """The host library's permute and compress (native/solver.cpp) against
    the Python version (hash/skyscraper.py) and against K5 and K4 on the
    card, exactly, on :func:`host_hash_pairs`; the host's microseconds a
    call of each."""
    from provekit_tpu_torch import native
    from provekit_tpu_torch.fields import vector as V
    from provekit_tpu_torch.hash import skyscraper as S

    pairs = host_hash_pairs(SEED, 1000)
    perm, perm_us = per_call_us(native.permute, pairs)
    comp, comp_us = per_call_us(native.compress, pairs)
    plain_perm, plain_perm_us = per_call_us(S.permute, pairs)
    plain_comp, plain_comp_us = per_call_us(S.compress, pairs)
    ls = V.pack([l for l, _ in pairs], dev)
    rs = V.pack([r for _, r in pairs], dev)
    kl, kr = S.permute_v(ls, rs)
    k5 = list(zip(V.unpack(kl), V.unpack(kr)))
    k4 = V.unpack(S.compress_v(ls, rs))
    for name, got, want in (("permute", perm, plain_perm),
                            ("permute (K5)", perm, k5),
                            ("compress", comp, plain_comp),
                            ("compress (K4)", comp, k4)):
        bad = [i for i, (x, y) in enumerate(zip(got, want)) if x != y]
        if bad or len(got) != len(want):
            fail(f"host library {name} disagrees on pairs {bad[:5]}")
    log(f"[3] host library permute and compress equal the Python version "
        f"and K5 and K4 on {len(pairs)} pairs ({len(pairs) - 1000} of edge "
        f"values); host us a call: permute {perm_us:.2f} (Python "
        f"{plain_perm_us:.2f}), compress {comp_us:.2f} (Python "
        f"{plain_comp_us:.2f})")


def segment_args(torch, rng, dev, kind: str, n: int, rounds: int,
                 edge: bool) -> tuple:
    """Arguments of a segment wrapper: random canonical planes, drawn on the
    card from a seed of ``rng`` (a 2^24 WHIR call takes 2^25 elements), or
    the edge values 0, 1 and P - 1 in a seeded order."""
    from provekit_tpu_torch.fields import bn254 as F
    from provekit_tpu_torch.fields import vector as V
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 62)))

    def planes(k):
        if edge:
            return V.pack([int(v) for v in rng.choice([0, 1, F.P - 1],
                                                       size=k)], dev)
        digits = torch.randint(0, 1 << 16, (16, k), generator=gen,
                               device=dev, dtype=torch.int32)
        # top digit below P's: every value below P
        digits[15] = torch.randint(0, 0x3064, (k,), generator=gen,
                                   device=dev, dtype=torch.int32)
        return digits

    if kind == "whir_segment":
        return planes(2 * n).reshape(16, 2, n), planes(2), rounds
    abce, c = planes(4 * n).reshape(16, 4, n), planes(5 + 7 * rounds)
    r = rounds
    return (abce, c[:, :2], c[:, 2:3], c[:, 3:4],
            c[:, 5 + 3 * r:].reshape(16, r, 4), c[:, 5:5 + r],
            c[:, 5 + r:5 + 2 * r], c[:, 5 + 2 * r:5 + 3 * r], c[:, 4:5], r)


def segment_per_round(kind: str, args: tuple) -> tuple:
    """A segment wrapper's outputs from ``fused.whir_rounds`` /
    ``fused.spartan_rounds``, the rounds one at a time on the operands'
    device in plain torch alone: while the loop runs, ``V.mont_mul`` is
    ``V.mont_mul_plain`` and ``S.duplex_v`` is ``S.duplex_plain``, so no
    kernel of the port takes part (the segments run the duplex's
    permutation, which must not check itself).  Fails if a kernel
    launched all the same."""
    from provekit_tpu_torch.fields import vector as V
    from provekit_tpu_torch.hash import skyscraper as S
    from provekit_tpu_torch.ops import fused
    kernels = (V.mont_mul, S.duplex_v)
    before = [fn.launches for fn in kernels]
    V.mont_mul, S.duplex_v = V.mont_mul_plain, S.duplex_plain
    try:
        if kind == "whir_segment":
            out = fused.whir_rounds(*args)
        else:
            abce, state, claim, rho, g, pms, sms, sfx, prefix, m = args
            _, state, coeffs, alphas, _, _ = fused.spartan_rounds(
                abce, state, claim, prefix, rho, g, pms, sms, sfx, m)
            out = state, coeffs, alphas
    finally:
        V.mont_mul, S.duplex_v = kernels
    if [fn.launches for fn in kernels] != before:
        fail(f"{kind}: a kernel launched in the plain per-round reference")
    return out


def path_segment_shapes() -> dict:
    """Path -> the (kernel, n, rounds) of every segment launch of one of its
    proves (:func:`segment_shapes`), from the schemes phases 6-9 build:
    poseidon2 x1000, sha256 x100 and the passport at security 128 from
    their R1CS counts, the mul_chain fixture compiled here on the CPU at
    phase 9's security."""
    from pathlib import Path

    from provekit_tpu_torch import cli
    from provekit_tpu_torch.compiler import NoirProofScheme
    program, abi = cli._load_circuit_program(
        Path(__file__).resolve().parent / "tests" / "fixtures"
        / "mul_chain.json")
    mul_chain = NoirProofScheme.from_program(
        program, security_level=RECURSION_SECURITY,
        max_pow_bits=RECURSION_MAX_POW, abi=abi, device="cpu")
    return {"poseidon2_x1000": segment_shapes(scheme_for(515_003, 515_005)),
            "sha256_x100": segment_shapes(scheme_for(3_138_745, 4_630_312)),
            "passport_cli": segment_shapes(scheme_for(PASSPORT_CONSTRAINTS,
                                                      PASSPORT_WITNESSES)),
            "recursion_cli": segment_shapes(mul_chain.whir_for_witness)}


# Phase 3 holds a segment launch on at most this many elements to the plain
# version (the per-round loop on CPU copies); a longer one (2^21 - 2^24, the
# passport's and sha256 x100's) to the same loop in plain torch on the
# card's tensors (segment_per_round): on the CPU it would take minutes.
SEGMENT_PLAIN_MAX = 1 << 20
# the largest shapes of the earlier design, whose segments ran on one block
# and took at most 2^14 elements (no path launches them now that every
# sumcheck is one launch), timed to compare the two designs
ONE_BLOCK_SEGMENT_SHAPES = [("whir_segment", 1 << 14, 2),
                            ("spartan_segment", 1 << 14, 14)]


def phase_segments(torch, rng, rows, dev) -> dict:
    """The fused sumcheck segments (csrc/sumcheck_segment.cu) against their
    references at every (n, rounds) that a prove of one of the four paths
    launches (:func:`path_segment_shapes`) and at the one-block design's
    shapes, on random
    inputs: the plain version up to SEGMENT_PLAIN_MAX elements, the same
    per-round loop in plain torch on the card above; with the kernel's time, the
    reference's, the bound and the sponge chain's floor (the segment's
    permutations at this run's duplex time a permutation); then at 0 rounds,
    1 and full depth on the edge values 0, 1 and P - 1, also on a grid of
    every SM.  The row of each kernel is its largest path shape.  Returns the paths' shapes, which their proves must
    launch."""
    from provekit_tpu_torch.ops import fused
    from provekit_tpu_torch.utils.profiling import cuda_ms
    kernel = {"whir_segment": fused.whir_sumcheck_segment,
              "spartan_segment": fused.spartan_sumcheck_fused}
    plain = {"whir_segment": fused.whir_sumcheck_segment_plain,
             "spartan_segment": fused.spartan_sumcheck_fused_plain}
    replaces = {"whir_segment": f"{FUSED_PY}:160",
                "spartan_segment": f"{FUSED_PY}:204"}
    per_perm_ms = rows.rows["duplex"]["ms"]

    def flat(out):
        return torch.cat([t.reshape(16, -1) for t in out], dim=1)

    paths = path_segment_shapes()
    log(f"[3] segment launches (kernel, n, rounds) of one prove: {paths}")
    on_path = {c for calls in paths.values() for c in calls}
    # ascending, so that each kernel's row (its last recorded) is its
    # largest path shape
    measured = {}
    for kind, n, r in sorted(on_path | set(ONE_BLOCK_SEGMENT_SHAPES)):
        args = segment_args(torch, rng, dev, kind, n, r, False)
        if n <= SEGMENT_PLAIN_MAX:
            ref = "plain version (CPU copies)"
            want, plain_ms = timed_once(torch, lambda: plain[kind](*args))
        else:
            ref = "plain per-round loop on the card"
            want, plain_ms = timed_once(
                torch, lambda: segment_per_round(kind, args))
        ms = cuda_ms(lambda: kernel[kind](*args), 10)
        nbytes, ops, perms = segment_work(kind, n, r)
        chain_ms = perms * per_perm_ms
        tag = "" if (kind, n, r) in on_path else ", one-block design's shape"
        rows.check(kind, f"n={n} rounds={r} against the {ref}{tag}",
                   flat(kernel[kind](*args)), flat(want), ms, plain_ms,
                   nbytes=nbytes, ops=ops,
                   record=(kind, n, r) in on_path,
                   source="sumcheck_segment.cu", replaces=replaces[kind],
                   chain_floor_ms=chain_ms)
        del want
        log(f"[3] {kind} n={n} rounds={r}: {perms} permutations, the "
            f"sponge chain's floor {chain_ms:.4f} ms at {per_perm_ms:.5f} ms "
            f"a permutation; 20 launches back to back, per launch "
            f"{back_to_back_ms(lambda: kernel[kind](*args)):.4f} ms")
        measured[kind, n, r] = (ms, bound(nbytes, ops, rows.rates)[0],
                                chain_ms)
        del args
    torch.cuda.empty_cache()
    for path, calls in paths.items():
        for kind in SEGMENT_KERNELS:
            mine = [measured[c] for c in calls if c[0] == kind]
            log(f"[3] {kind}: a {path} prove launches it {len(mine)} "
                f"times: {sum(m[0] for m in mine):.4f} ms of kernel time, "
                f"bound {sum(m[1] for m in mine):.4f} ms, the sponge "
                f"chain's floor {sum(m[2] for m in mine):.4f} ms")
    for kind, cases in (("whir_segment", [(8, 0), (8, 1), (8, 3),
                                          (1 << 10, 10), (1 << 17, 17)]),
                        ("spartan_segment", [(1, 0), (2, 1), (8, 3),
                                             (1 << 10, 10), (1 << 17, 17)])):
        for n, r in cases:
            args = segment_args(torch, rng, dev, kind, n, r, True)
            rows.check(kind, f"edge values, n={n} rounds={r}",
                       flat(kernel[kind](*args)), flat(plain[kind](*args)))
    return paths


def poseidon_leaf_shapes() -> list:
    """(leaf_size, n_leaves) of every Merkle commitment of a poseidon2
    x1000 prove: the witness (m = 20) and the blinding (m = 8) WHIR
    configurations, each a batch of two, and their rounds."""
    from provekit_tpu_torch.whir.parameters import WhirConfig
    shapes = []
    for m in (20, 8):
        cfg = WhirConfig(num_variables=m, batch_size=2, security_level=128)
        fold = 1 << cfg.initial_folding_factor
        shapes.append((2 * fold, (1 << cfg.starting_log_domain) // fold))
        for r, rc in enumerate(cfg.rounds):
            rfold = 1 << rc.folding_factor
            shapes.append((rfold, (1 << (cfg.starting_log_domain - r - 1))
                           // rfold))
    return shapes


def phase_poseidon_leaves(torch, rng, rows, dev):
    """The leaf fold at every leaf shape of the poseidon2 x1000 prove (the
    witness commitment's 32-element leaves, the rounds' 16-element ones),
    exact against its plain version and against single-step launches; and
    the host wall clock of each, since on these shapes the launches, not
    the ladder, can take the time."""
    from provekit_tpu_torch.hash import skyscraper as S
    fold_ms = steps_ms = 0.0
    steps = 0
    for size, n in poseidon_leaf_shapes():
        leaves = random_planes(torch, rng, size * n, dev).reshape(16, size, n)
        shape = f"(16, {size}, {n})"
        got = S.compress_fold_v(leaves)
        rows.check("compress_fold", f"{shape} poseidon leaves", got,
                   S.compress_fold_plain(leaves))
        rows.check("compress_fold", f"{shape} against {size - 1} "
                   "single-step launches", got, fold_by_steps(S, leaves))
        f_ms = wall_ms(torch, lambda: S.compress_fold_v(leaves), 5)
        s_ms = wall_ms(torch, lambda: fold_by_steps(S, leaves), 5)
        log(f"[3] leaf hash of {shape}, host wall clock: one fold launch "
            f"{f_ms:.4f} ms, {size - 1} single-step launches {s_ms:.4f} ms")
        fold_ms += f_ms
        steps_ms += s_ms
        steps += size - 1
    log(f"[3] the poseidon2 x1000 prove's leaf hashing, host wall clock: "
        f"{len(poseidon_leaf_shapes())} fold launches {fold_ms:.4f} ms, "
        f"{steps} single-step launches {steps_ms:.4f} ms")


def phase_leaves(torch, rng, rows, dev):
    """mont_mul, the leaf fold and compress at the largest shapes of the
    sha256 x100 path: its first commitment's ``from_mont`` of the
    (16, 2 * 16, 2^21) leaves (2^26 elements times a broadcast constant),
    ``merkle.hash_leaves`` on them (one fold launch; against its plain
    version and against the 31 single-step launches it replaces), compress
    on two strided leaf rows, and the tree's first level on column-strided
    halves."""
    from provekit_tpu_torch.fields import vector as V
    from provekit_tpu_torch.hash import skyscraper as S
    from provekit_tpu_torch.utils.profiling import cuda_ms
    from provekit_tpu_torch.whir.parameters import WhirConfig
    # the witness commitment of sha256 x100: m = 24, two polynomials
    cfg = WhirConfig(num_variables=24, batch_size=2, security_level=128)
    batch, fold = 2, 1 << cfg.initial_folding_factor
    n_leaves = (1 << cfg.starting_log_domain) // fold
    cols = batch * fold * n_leaves
    shape = f"(16, {batch * fold}, 2^{n_leaves.bit_length() - 1})"
    enc = random_planes(torch, rng, cols, dev).reshape(16, batch * fold,
                                                       n_leaves)
    one = V.const(1, dev)
    got = V.from_mont(enc)
    piece = 1 << 21
    flat = enc.reshape(16, cols)
    want = torch.cat([V.mont_mul_plain(flat[:, i:i + piece], one)
                      for i in range(0, cols, piece)], dim=1)
    rows.check("mont_mul", f"from_mont of {shape} leaves",
               got.reshape(16, cols), want,
               cuda_ms(lambda: V.from_mont(enc), 3), None)
    del enc, flat, want
    leaves = got
    size, n = leaves.shape[1], leaves.shape[2]
    fold = S.compress_fold_v(leaves)
    want, plain_ms = timed_once(torch, lambda: S.compress_fold_plain(leaves))
    rows.check("compress_fold", f"{shape} sha256 leaves", fold, want,
               cuda_ms(lambda: S.compress_fold_v(leaves), 5), plain_ms,
               nbytes=(size + 1) * PLANE_BYTES * n,
               ops=ladder_ops((size - 1) * n), source="skyscraper.cu",
               replaces=f"{TPU_KERNELS}:233")
    del want

    def single_steps():
        return fold_by_steps(S, leaves)

    rows.check("compress_fold",
               f"{shape} against {size - 1} single-step launches", fold,
               single_steps())
    log(f"[3] sha256 leaf hash of {shape}: one fold launch "
        f"{rows.rows['compress_fold']['ms']:.4f} ms, {size - 1} single-step "
        f"launches {cuda_ms(single_steps, 5):.4f} ms")
    del fold
    l, r = leaves[:, 0, :], leaves[:, 1, :]
    rows.check("compress", f"hash_leaves fold, {shape} rows 0 and 1",
               S.compress_v(l, r), S.compress_plain(l, r),
               cuda_ms(lambda: S.compress_v(l, r), 3), None)
    level = S.compress_v(l, r)
    del leaves, got, l, r
    l, r = level[:, 0::2], level[:, 1::2]
    rows.check("compress", f"tree level, (16, 2^{n_leaves.bit_length() - 1})"
               "[:, 0::2] and [:, 1::2]",
               S.compress_v(l, r), S.compress_plain(l, r),
               cuda_ms(lambda: S.compress_v(l, r), 3), None)


def phase_mxu(torch, dev):
    """experiments/mxu_mont.py: exactness and K6's and K1's times at 2^18,
    2^20 and 2^21; then experiments/mxu_trace.py at 2^21: K6 and its
    earlier design timed in turns beside K1, and each split by phase from
    a traced build.  Returns K6's launches in the experiment."""
    from provekit_tpu_torch.experiments import mxu_mont as M
    from provekit_tpu_torch.experiments import mxu_trace
    M.mont_mul_mma.launches = 0
    out = M.run(dev)
    launches = M.mont_mul_mma.launches
    log(f"[4] mxu_mont experiment: {json.dumps(out)}")
    if not all(out["checks"].values()):
        fail(f"tensor-core experiment checks failed: {out['checks']}")
    for log_n in M.LOG_NS:
        mma, cios = out["ms"][f"mma_2^{log_n}"], out["ms"][f"cios_2^{log_n}"]
        log(f"[4] n=2^{log_n}: mont_mul_mma {mma:.4f} ms, mont_mul "
            f"{cios:.4f} ms (ratio {mma / cios:.3f})")
    t0 = time.perf_counter()
    trace = mxu_trace.run(dev)
    log(f"[4] mont_mul_mma traced at n=2^21, this design and the earlier "
        f"one ({time.perf_counter() - t0:.1f} s with their builds): "
        f"{json.dumps(trace)}")
    if not all(trace["checks"].values()):
        fail(f"traced tensor-core kernels disagree: {trace['checks']}")
    return launches


def expect_rejected(scheme, r1cs, proof: bytes, positions) -> None:
    from provekit_tpu_torch.whir.verifier import WhirError
    for pos in positions:
        bad = bytearray(proof)
        bad[pos] ^= 1
        try:
            scheme.verify(r1cs, bytes(bad))
        except (WhirError, ValueError):
            continue
        fail(f"proof with byte {pos} flipped was accepted")


def phase_tiny(dev):
    r1cs, witness = build_tiny_system(seed=3, n_mults=1)
    scheme = tiny_scheme(r1cs, dev)
    t0 = time.perf_counter()
    proof = scheme.prove(r1cs, witness, rng=random.Random(11))
    prove_s = time.perf_counter() - t0
    digest = hashlib.sha256(proof).hexdigest()
    if digest != TINY_DIGEST:
        fail(f"tiny proof digest {digest} != {TINY_DIGEST}")
    scheme.verify(r1cs, proof)
    expect_rejected(scheme, r1cs, proof,
                    [8, len(proof) // 2, len(proof) - 33])
    log(f"[5] tiny scheme on {dev}: digest {digest[:16]}... matches, "
        f"verify ok, 3 flipped bytes rejected (prove {prove_s:.3f} s)")


SKYSCRAPER_KERNELS = ("compress_kernel", "compress_fold_kernel",
                      "permute_kernel", "duplex_kernel",
                      "whir_segment_kernel", "spartan_segment_kernel")


def profile_prove(torch, whir, r1cs, witness, path, tag) -> dict:
    """One more prove under torch.profiler, recording the device's kernels
    only (the host's operators of a per-round prove take minutes to
    aggregate, and every profiled prove bears the same load): kernel table,
    device busy share (summed kernel time over the prove's wall time) and
    the device time of the kernels that run the Skyscraper ladder (the
    duplex's per permutation) written to ``path``.  Returns the wall
    seconds, the busy seconds and the number of device kernels."""
    from torch.profiler import ProfilerActivity, profile

    from provekit_tpu_torch.hash import skyscraper as S
    perms = S.duplex_v.permutations
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        whir.prove(r1cs, witness, rng=random.Random(2))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    perms = S.duplex_v.permutations - perms
    events = prof.key_averages()
    cuda = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in cuda)
    launches = sum(e.count for e in cuda)
    sky = {}
    for name in SKYSCRAPER_KERNELS:
        hits = [e for e in cuda if f"::{name}(" in e.key
                or e.key.startswith(f"{name}(")]
        sky[name] = (sum(e.self_device_time_total for e in hits),
                     sum(e.count for e in hits))
    sky_us = sum(us for us, _ in sky.values())
    duplex_us = sky["duplex_kernel"][0]
    ntt_routes = {}
    for route, mark in (("K3", "ntt_pass_kernel<0"),
                        ("K2", "ntt_pass_kernel<1")):
        hits = [e for e in cuda if mark in e.key]
        ntt_routes[route] = (sum(e.self_device_time_total for e in hits),
                             sum(e.count for e in hits))
    summary = (f"profiled prove: wall {wall:.3f} s, device busy "
               f"{busy_us / 1e6:.3f} s ({100 * busy_us / 1e6 / wall:.1f}%), "
               f"{launches} device kernels; Skyscraper ladder kernels "
               f"{sky_us / 1e3:.3f} ms ({100 * sky_us / max(busy_us, 1):.1f}% "
               f"of device time): "
               + ", ".join(f"{k} {us / 1e3:.3f} ms in {c}"
                           for k, (us, c) in sky.items())
               + f"; duplex {perms} permutations, "
               f"{duplex_us / max(perms, 1):.2f} us of device time each; "
               f"NTT passes "
               f"{sum(us for us, _ in ntt_routes.values()) / 1e3:.3f} ms: "
               + ", ".join(f"{r}'s route {us / 1e3:.3f} ms in {c}"
                           for r, (us, c) in ntt_routes.items()))
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(summary + "\n\n" + events.table(
        sort_by="self_cuda_time_total", row_limit=40))
    log(f"{tag} {summary} -> {path}")
    return {"wall_s": wall, "busy_s": busy_us / 1e6, "kernels": launches}


def scheme_for(constraints: int, witnesses: int):
    """The WhirR1CSScheme that ``new_for_r1cs`` builds at security 128 (as
    ``prepare`` does by default) for an R1CS of these counts (its shape
    alone; on the CPU)."""
    import types

    from provekit_tpu_torch.protocol import WhirR1CSScheme
    r1cs = types.SimpleNamespace(num_constraints=constraints,
                                 num_witnesses=witnesses,
                                 a=types.SimpleNamespace(nnz=1))
    return WhirR1CSScheme.new_for_r1cs(r1cs, 128, device="cpu")


def segment_shapes(scheme) -> list:
    """(kernel, n, rounds) of every fused segment launch of one prove of
    ``scheme``, in launch order: the Spartan tail, then the sumcheck calls
    of the blinding polynomial's WHIR opening and of the witness's, each
    past its leading rounds (``fused.lead_rounds``)."""
    from provekit_tpu_torch.ops.fused import lead_rounds

    def tail(kind, n, rounds):
        lead = lead_rounds(n, rounds)
        return [(kind, n >> lead, rounds - lead)] if lead < rounds else []

    def whir(cfg):
        k = cfg.num_variables
        calls = tail("whir_segment", 1 << k, cfg.initial_folding_factor)
        k -= cfg.initial_folding_factor
        for rc in cfg.rounds:
            calls += tail("whir_segment", 1 << k, rc.folding_factor)
            k -= rc.folding_factor
        return calls + tail("whir_segment", 1 << k,
                            cfg.final_sumcheck_rounds)

    return (tail("spartan_segment", 1 << scheme.m_0, scheme.m_0)
            + whir(scheme.whir_for_hiding_spartan) + whir(scheme.whir_witness))


def segment_work(kind: str, n: int, rounds: int) -> tuple:
    """(bytes, operations, permutations) of one segment launch on n
    elements: each input and output element once (planes of 64 bytes an
    element); the Montgomery products of the pair sums (4 a WHIR pair, 6 a
    Spartan pair), the folds (2 a WHIR pair, 4 a Spartan pair but in the
    last round) and the rounds' scalar steps (4 for WHIR, 21 for Spartan);
    and the ladders of the sponge's 3 (WHIR) or 4 (Spartan) permutations a
    round."""
    pairs = sum(n >> (j + 1) for j in range(rounds))
    if kind == "whir_segment":
        elements = 2 * n + 2 + 2 * (n >> rounds) + 2 + 4 * rounds
        muls = 6 * pairs + 4 * rounds
        perms = 3 * rounds
    else:
        elements = 4 * n + 5 + 7 * rounds + 2 + 5 * rounds
        last = n >> rounds if rounds else 0
        muls = 10 * pairs - 4 * last + 21 * rounds
        perms = 4 * rounds
    ops = mont_mul_ops(muls)
    ops["int32_muladd"] += ladder_ops(perms)["int32_muladd"]
    return PLANE_BYTES * elements, ops, perms


def check_segments(name: str, calls: list, expect: list) -> None:
    """Fail unless a prove's recorded segment launches are the shapes that
    phase 3 held against the plain version for its path."""
    if calls != expect:
        fail(f"{name}: segment launches {calls}, phase 3 ran {expect}")
    log(f"{name}: segment launches (kernel, n, rounds) as phase 3 ran them: "
        f"{calls}")


@contextlib.contextmanager
def recorded_segments():
    """Record (kernel, n, rounds) of every segment wrapper call inside.
    The wrappers count their launches under their module names, which the
    recorders hold inside; on the way out those counts are added to the
    wrappers' own, so that a count read after the block holds them."""
    from provekit_tpu_torch.ops import fused
    calls = []
    whir, spartan = fused.whir_sumcheck_segment, fused.spartan_sumcheck_fused

    def whir_rec(fw, state, count):
        calls.append(("whir_segment", fw.shape[2], count))
        return whir(fw, state, count)

    def spartan_rec(abce, *args):
        calls.append(("spartan_segment", abce.shape[2], args[-1]))
        return spartan(abce, *args)

    for rec in (whir_rec, spartan_rec):
        rec.launches = rec.permutations = 0
    fused.whir_sumcheck_segment = whir_rec
    fused.spartan_sumcheck_fused = spartan_rec
    try:
        yield calls
    finally:
        fused.whir_sumcheck_segment = whir
        fused.spartan_sumcheck_fused = spartan
        for fn, rec in ((whir, whir_rec), (spartan, spartan_rec)):
            fn.launches += rec.launches
            fn.permutations += rec.permutations


def prove_path(torch, dev, tag, name, build, counters, expect, segments,
               digest, profile_to, unfused_profile_to=None,
               plain_solve=False):
    """One circuit through the port's entry points: build, from_program,
    solve_witness, a warm-up prove (its segment launches must be
    ``segments``, the shapes phase 3 ran for this path), a timed prove with
    the launch counts of ``counters`` (each name in ``expect`` must launch)
    and the pinned proof ``digest``, a profiled prove
    (:func:`profile_prove`), verify and a flipped byte.  With
    ``unfused_profile_to``, then a warm-up, a timed and a profiled prove
    with FUSE_MAX = 0 (every sumcheck round one at a time, no segment).
    Each verify runs twice: with the host library, then with the plain
    host hash (:func:`plain_host_hash`).  With ``plain_solve``, the plain
    solve runs beside the native one (:func:`compare_solves`).  Returns the
    timed prove's launch counts, and the scheme, R1CS, proof, witness, the
    timed prove's ``rng`` state and each timed prove's wall seconds, spans
    and peak device memory (by label)."""
    from provekit_tpu_torch.compiler import NoirProofScheme
    from provekit_tpu_torch.ops import fused as fused_ops
    from provekit_tpu_torch.utils import profiling

    stages = {}

    def stage(label, fn):
        log(f"{tag} {name}: {label} ...")
        t0 = time.perf_counter()
        out = fn()
        stages[label] = time.perf_counter() - t0
        log(f"{tag} {name}: {label} done in {stages[label]:.3f} s")
        return out

    program, acir_values, _ = stage("circuit_build", build)
    scheme = stage("from_program", lambda: NoirProofScheme.from_program(
        program, security_level=128, device=dev))
    r1cs = scheme.r1cs
    whir = scheme.whir_for_witness
    log(f"{tag} {name}: {r1cs.num_constraints} constraints, "
        f"{r1cs.num_witnesses} witnesses, m={whir.m} m_0={whir.m_0}, "
        f"RS domain 2^{whir.whir_witness.starting_log_domain}")
    rng = random.Random(1)
    witness = stage("solve_witness",
                    lambda: scheme.solve_witness(acir_values, rng=rng))
    if plain_solve:
        native_s, plain_s = compare_solves(scheme, acir_values)
        log(f"{tag} {name}: native and plain solves equal, "
            f"{native_s:.3f} s against {plain_s:.3f} s")

    def prove():
        proof = whir.prove(r1cs, witness, rng=rng)
        torch.cuda.synchronize()
        return proof

    with recorded_segments() as calls:
        stage("warmup_prove", prove)
    check_segments(f"{tag} {name}", calls, segments)

    def timed(label):
        profiling.GLOBAL.sync = torch.cuda.synchronize
        mark = len(profiling.GLOBAL.root.children)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts(counters)
        proof = stage(label, prove)
        launches = path_counts(counters)
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        spans = {s.name: s.elapsed
                 for s in profiling.GLOBAL.root.children[mark:]}
        profiling.GLOBAL.sync = None
        for span_name, sec in spans.items():
            log(f"{tag} {name}: {label} span {span_name}: {sec:.3f} s")
        got = hashlib.sha256(proof).hexdigest()
        log(f"{tag} {name}: {label}: proof {len(proof)} bytes, sha256 {got}; "
            f"launches: {launches}; peak device memory {peak_gib:.3f} GiB")
        if got != digest:
            fail(f"{name}: {label} proof digest {got} != {digest}")
        records[label] = {"wall_s": stages[label], "spans": spans,
                          "peak_gib": peak_gib}
        return proof, launches

    records = {}
    rng_state = rng.getstate()
    proof, launches = timed("prove")
    fused = profile_prove(torch, whir, r1cs, witness, profile_to, tag)
    if unfused_profile_to is not None:
        saved, fused_ops.FUSE_MAX = fused_ops.FUSE_MAX, 0
        try:
            stage("warmup_prove_unfused", prove)
            rng.setstate(rng_state)  # the timed prove's draws: its digest
            _, unfused_launches = timed("prove_unfused")
            unfused = profile_prove(torch, whir, r1cs, witness,
                                    unfused_profile_to, tag)
        finally:
            fused_ops.FUSE_MAX = saved
        if any(unfused_launches[k] for k in SEGMENT_KERNELS):
            fail(f"{name}: a segment launched with FUSE_MAX = 0")
        log(f"{tag} {name}: profiled prove with the segments / with FUSE_MAX"
            f" = 0: {fused['kernels']} / {unfused['kernels']} device "
            f"kernels, busy {fused['busy_s']:.3f} / {unfused['busy_s']:.3f}"
            f" s of {fused['wall_s']:.3f} / {unfused['wall_s']:.3f} s")
    stage("verify", lambda: whir.verify(r1cs, proof))
    with plain_host_hash():
        stage("verify_plain_host_hash", lambda: whir.verify(r1cs, proof))
    expect_rejected(whir, r1cs, proof, [len(proof) // 2])
    log(f"{tag} {name}: verify ok, flipped byte rejected; stages "
        + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()))
    missing = [k for k in expect if launches[k] <= 0]
    if missing:
        fail(f"kernels not launched by the {name} path: {missing}")
    return launches, {"whir": whir, "r1cs": r1cs, "proof": proof,
                      "witness": witness, "rng_state": rng_state,
                      "records": records}


def compare_solves(scheme, acir_values) -> tuple[float, float]:
    """Solve the witness natively (the default) and with the plain Python
    solve (``use_native=False``), both under ``random.Random(1)``; fail
    unless the two witness lists are equal.  Returns both times (s)."""
    times, witnesses = [], []
    for use_native in (True, False):
        t0 = time.perf_counter()
        witnesses.append(scheme.solve_witness(
            acir_values, rng=random.Random(1), use_native=use_native))
        times.append(time.perf_counter() - t0)
    native_w, plain_w = witnesses
    if native_w != plain_w:
        bad = sum(x != y for x, y in zip(native_w, plain_w))
        fail(f"the native and plain solves differ: {len(native_w)} and "
             f"{len(plain_w)} witnesses, {bad} of the first unequal")
    return times[0], times[1]


@contextlib.contextmanager
def recorded_solves():
    """Record (scheme, acir_values, seconds) of every
    ``NoirProofScheme.solve_witness`` call inside (the CLI's prove solves
    through it)."""
    from provekit_tpu_torch.compiler import NoirProofScheme
    calls = []
    solve = NoirProofScheme.solve_witness

    def solve_rec(self, acir_values, *args, **kwargs):
        t0 = time.perf_counter()
        out = solve(self, acir_values, *args, **kwargs)
        calls.append((self, acir_values, time.perf_counter() - t0))
        return out

    NoirProofScheme.solve_witness = solve_rec
    try:
        yield calls
    finally:
        NoirProofScheme.solve_witness = solve


@contextlib.contextmanager
def plain_host_hash():
    """Inside, the host sponge, Merkle path checks and PoW checks run the
    plain Python hash (``hash/skyscraper.py``, ``merkle.verify_path_plain``)
    instead of the host library, as phase 3 swaps plain versions in for
    kernels."""
    from provekit_tpu_torch import native
    from provekit_tpu_torch.hash import skyscraper as S
    from provekit_tpu_torch.ops import merkle

    def merkle_verify(leaf_values, path, index, root):
        return merkle.verify_path_plain(root, leaf_values, index, path)

    saved = native.permute, native.compress, native.merkle_verify
    native.permute, native.compress = S.permute, S.compress
    native.merkle_verify = merkle_verify
    try:
        yield
    finally:
        native.permute, native.compress, native.merkle_verify = saved


# the passport circuit of passport_test_vector(seed=1) with its signature
PASSPORT_CONSTRAINTS = 1_590_897
PASSPORT_WITNESSES = 2_261_537


def run_cli(argv, out_path):
    """``cli.main(argv)`` in this process with its standard output written
    to ``out_path``; returns its spans as (path, seconds) pairs, parents
    first (the span tree starts empty for each call)."""
    import contextlib
    import io

    from provekit_tpu_torch import cli
    from provekit_tpu_torch.utils import profiling
    profiling.GLOBAL.root.children.clear()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
    finally:
        out_path.write_text(buf.getvalue())
    spans = []

    def walk(span, prefix):
        for child in span.children:
            spans.append((prefix + child.name, child.elapsed))
            walk(child, prefix + child.name + "/")

    walk(profiling.GLOBAL.root, "")
    return spans


def scheme_shape(constraints: int, witnesses: int) -> dict:
    """m, m_0 and the witness RS domain's log size of the scheme that
    ``prepare`` builds at security 128 (``WhirR1CSScheme.new_for_r1cs``)."""
    from provekit_tpu_torch.protocol.scheme import next_power_of_two_log
    from provekit_tpu_torch.whir.parameters import WhirConfig
    m = next_power_of_two_log(witnesses) + 1
    cfg = WhirConfig(num_variables=m, batch_size=2, security_level=128)
    return {"m": m, "m_0": max(1, next_power_of_two_log(constraints)),
            "rs_domain_log": cfg.starting_log_domain}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_server(root, nps, port, log_path):
    """The verify service on ``nps`` as a child process, its output going
    to ``log_path``."""
    log = open(log_path, "w")
    return subprocess.Popen(
        [sys.executable, "-m", "provekit_tpu_torch.server", "--scheme",
         str(nps), "--port", str(port)], cwd=root, stdout=log,
        stderr=subprocess.STDOUT), log


def wait_for_banner(proc, log_path, timeout: float) -> None:
    deadline = time.perf_counter() + timeout
    while "verify server on" not in log_path.read_text():
        if proc.poll() is not None:
            fail(f"the verify service exited with {proc.returncode}: "
                 f"{log_path.read_text()[-2000:]}")
        if time.perf_counter() > deadline:
            fail(f"the verify service did not come up in {timeout} s")
        time.sleep(0.5)


def phase_front_door(torch, dev, counters, segments, out_dir):
    """[8] The port's front door: the Noir fixtures through the CLI
    (prepare, prove from Prover.toml through the ACVM and Brillig VM,
    verify), then the passport circuit at full width (prepare and prove
    --verify through the CLI, in this process, the launches counted and the
    segment launches recorded around prove: they must be ``segments``),
    then the verify service as a child process on the passport's
    scheme.  Returns the passport prove's launch counts and the passport's
    .nps and .np (phase 9 exports them, then deletes the .nps)."""
    from pathlib import Path

    from provekit_tpu_torch.circuits import passport
    from provekit_tpu_torch.io import files
    from provekit_tpu_torch.utils import profiling

    root = Path(__file__).resolve().parent
    work = out_dir / "front_door"
    work.mkdir(parents=True, exist_ok=True)
    profiling.GLOBAL.sync = torch.cuda.synchronize

    def cli_step(tag, argv, name):
        t0 = time.perf_counter()
        spans = run_cli(argv, work / f"{name}.txt")
        log(f"[8] {tag}: {argv[0]} done in {time.perf_counter() - t0:.3f} s; "
            + ", ".join(f"{p} {s:.3f} s" for p, s in spans))
        return spans

    for name, (inputs, expected) in fixture_cases().items():
        toml = work / f"{name}.Prover.toml"
        toml.write_text(prover_toml(inputs))
        nps, np_ = work / f"{name}.nps", work / f"{name}.np"
        cli_step(name, ["prepare", str(root / "tests" / "fixtures"
                                       / f"{name}.json"), "-o", str(nps)],
                 f"{name}_prepare")
        wmap = files.read(nps, device=dev).generate_witness(toml.read_text())
        got = {k: wmap.get(k) for k in expected}
        if got != expected:
            fail(f"{name}: ACVM witness values {got} != {expected}")
        cli_step(name, ["prove", str(nps), str(toml), "-o", str(np_),
                        "--verify"], f"{name}_prove")
        cli_step(name, ["verify", str(nps), str(np_)], f"{name}_verify")
        log(f"[8] {name}: Prover.toml {inputs} -> witness {got} as "
            f"expected; proof {np_.stat().st_size} bytes, verified")

    t0 = time.perf_counter()
    dg1, sod, off, date, age, sig = passport.passport_test_vector(seed=1)
    program, values = passport.passport_circuit(dg1, sod, off, date, age,
                                                signature=sig)
    circuit, witness = work / "passport_circuit.json", \
        work / "passport_witness.json"
    circuit.write_text(json.dumps({"program": files._enc(program)}))
    witness.write_text(json.dumps({str(k): hex(v) for k, v in values.items()}))
    log(f"[8] passport: circuit build and JSON in "
        f"{time.perf_counter() - t0:.3f} s: {len(values)} ACIR witnesses, "
        f"circuit {circuit.stat().st_size} bytes, witness "
        f"{witness.stat().st_size} bytes")
    del program, values

    nps, np_ = work / "passport.nps", work / "passport.np"
    cli_step("passport", ["prepare", str(circuit), "-o", str(nps)],
             "passport_prepare")
    stats = (work / "passport_prepare.txt").read_text()
    if (f"R1CS: {PASSPORT_CONSTRAINTS} constraints, {PASSPORT_WITNESSES} "
            "witnesses") not in stats:
        fail(f"passport: unexpected R1CS size: {stats[-300:]}")
    shape = scheme_shape(PASSPORT_CONSTRAINTS, PASSPORT_WITNESSES)
    log(f"[8] passport: {PASSPORT_CONSTRAINTS} constraints, "
        f"{PASSPORT_WITNESSES} witnesses, m={shape['m']} m_0={shape['m_0']}, "
        f"RS domain 2^{shape['rs_domain_log']}; .nps {nps.stat().st_size} "
        f"bytes")

    # the service reads the scheme while this process proves
    port = free_port()
    server, server_log = start_server(root, nps, port,
                                      work / "server_log.txt")
    t_server = time.perf_counter()
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts(counters)
        with recorded_segments() as calls, recorded_solves() as solves:
            cli_step("passport", ["prove", str(nps), str(witness), "-o",
                                  str(np_), "--verify"], "passport_prove")
        launches = path_counts(counters)
        check_segments("[8] passport", calls, segments)
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        if "self-verify: OK" not in (work / "passport_prove.txt").read_text():
            fail("passport: the CLI's self-verify did not pass")
        proof = files.read(np_).transcript
        log(f"[8] passport: proof {len(proof)} bytes (.np "
            f"{np_.stat().st_size}), self-verified; launches during the CLI "
            f"prove: {launches}; butterfly launched: "
            f"{launches['butterfly'] > 0}; peak device memory "
            f"{peak_gib:.3f} GiB")

        if len(solves) != 1:
            fail(f"passport: the CLI prove solved {len(solves)} times")
        scheme, acir_values, solve_s = solves.pop()
        native_s, plain_s = compare_solves(scheme, acir_values)
        verify_s = []
        for hashing in (contextlib.nullcontext, plain_host_hash):
            t0 = time.perf_counter()
            with hashing():
                scheme.verify(files.read(np_))
            verify_s.append(time.perf_counter() - t0)
        del scheme, acir_values
        log(f"[8] passport: the CLI prove's native solve {solve_s:.3f} s; "
            f"native and plain solves equal, {native_s:.3f} s against "
            f"{plain_s:.3f} s; verify (with the .np read) {verify_s[0]:.3f} "
            f"s, with the plain host hash {verify_s[1]:.3f} s")

        wait_for_banner(server, work / "server_log.txt", 900)
        log(f"[8] verify service up on port {port}, "
            f"{time.perf_counter() - t_server:.3f} s after its start")
        for i, (path, data, code) in enumerate(verify_requests(proof)):
            t0 = time.perf_counter()
            got = post(port, path, data)
            log(f"[8] POST {path} ({len(data)} bytes): {got} in "
                f"{time.perf_counter() - t0:.3f} s (expected {code}"
                + ("; the service's first verify)" if i == 0 else ")"))
            if got != code:
                fail(f"verify service answered {got} for {path}, "
                     f"expected {code}")
    finally:
        server.terminate()
        try:
            server.wait(timeout=30)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()
        server_log.close()
        profiling.GLOBAL.sync = None
    # the large inputs stay out of what the run brings back
    for path in (circuit, witness):
        path.unlink()
    missing = [k for k in ON_PATH if launches[k] <= 0]
    if missing:
        fail(f"kernels not launched by the passport CLI prove: {missing}")
    return launches, nps, np_


# [9] the recursive-verifier path
RECURSION_SECURITY = 30  # tests/test_recursion.py's compiled circuit
RECURSION_MAX_POW = 6
PHASE9_BUDGET_S = 300
RECURSION_SPANS = ("groth16_setup", "load_keys", "groth16_prove",
                   "groth16_verify")


def flip_byte(src, dst, pos: int = 0) -> None:
    """Write to ``dst`` the .np proof of ``src`` with byte ``pos`` of its
    transcript flipped (byte 0: the first committed root)."""
    from provekit_tpu_torch.io import files
    proof = files.read(src)
    bad = bytearray(proof.transcript)
    bad[pos] ^= 1
    proof.transcript = bytes(bad)
    files.write(dst, proof)


def recursion_spans(spans) -> dict:
    """The seconds of ``recursive-verify``'s spans (:func:`run_cli`'s
    pairs), by name; a run has either ``groth16_setup`` or ``load_keys``,
    and always ``groth16_prove`` and ``groth16_verify``."""
    got = {name: sec for name, sec in spans if name in RECURSION_SPANS}
    if ("groth16_setup" in got) == ("load_keys" in got) or not all(
            k in got for k in ("groth16_prove", "groth16_verify")):
        fail(f"recursive-verify spans: {spans}")
    return got


def wrapper_counts(text: str) -> dict:
    """Constraints, wires and public inputs of the wrapper from
    ``recursive-verify``'s output; fails unless it printed OK."""
    import re
    m = re.search(r"recursive verification: OK \((\d+) wrapper constraints, "
                  r"(\d+) wires, (\d+) public inputs\)", text)
    if m is None:
        fail(f"recursive-verify did not print OK: {text[-500:]}")
    return dict(zip(("constraints", "wires", "public_inputs"),
                    map(int, m.groups())))


def budget_line(label: str, seconds: float, budget: float) -> str:
    """A log line for a phase's time against its budget in seconds."""
    verdict = "within" if seconds <= budget else "OVER"
    return (f"{label} took {seconds:.3f} s, {verdict} its budget of "
            f"{budget} s")


def check_export(params_path, r1cs_path, transcript: bytes) -> dict:
    """Walk one export with the port's go_parse (the Go verifier's parse):
    the transcript it holds is ``transcript``, the walk consumes it exactly
    and ``prepare`` accepts the pair; returns what the walk found."""
    from provekit_tpu_torch.io import go_parse
    config = json.loads(params_path.read_text())
    r1cs_doc = json.loads(r1cs_path.read_text())
    if bytes(config["transcript"]) != transcript:
        fail(f"{params_path}: the exported transcript is not the proof's")
    out = go_parse.prepare(config, r1cs_doc)
    parsed = out["parsed"]
    return {"merkle_paths": len(parsed.merkle_paths),
            "stir_answers": len(parsed.stir_answers),
            "truncated_bytes": len(parsed.truncated),
            "interner": len(out["interner"]),
            "params_bytes": params_path.stat().st_size,
            "r1cs_json_bytes": r1cs_path.stat().st_size}


def phase_gnark_export(passport_nps, passport_np, poseidon, work) -> None:
    """[9a] The gnark export at full width: the passport through the CLI,
    poseidon2 x1000 through the library; both walked by go_parse."""
    from provekit_tpu_torch.io import files
    from provekit_tpu_torch.io.gnark import write_gnark_inputs
    out = work / "passport_gnark"
    t0 = time.perf_counter()
    spans = run_cli(["generate-gnark-inputs", str(passport_nps),
                     str(passport_np), "-o", str(out)],
                    work / "passport_gnark.txt")
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    walk = check_export(out / "params_for_recursive_verifier",
                        out / "r1cs.json",
                        files.read(passport_np).transcript)
    log(f"[9] passport: generate-gnark-inputs in {export_s:.3f} s ("
        + ", ".join(f"{p} {s:.3f} s" for p, s in spans)
        + f"), go_parse walk in {time.perf_counter() - t0:.3f} s: {walk}")

    whir, r1cs, proof = poseidon["whir"], poseidon["r1cs"], poseidon["proof"]
    out = work / "poseidon_gnark"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    write_gnark_inputs(whir, r1cs, proof,
                       whir.create_io_pattern().as_bytes(),
                       out / "params_for_recursive_verifier",
                       out / "r1cs.json")
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    walk = check_export(out / "params_for_recursive_verifier",
                        out / "r1cs.json", proof)
    log(f"[9] poseidon2 x1000: write_gnark_inputs in {export_s:.3f} s, "
        f"go_parse walk in {time.perf_counter() - t0:.3f} s: {walk}")
    # the matrix dumps stay out of what the run brings back
    for name in ("passport_gnark", "poseidon_gnark"):
        (work / name / "r1cs.json").unlink()


def phase_recursion(counters, segments, work) -> dict:
    """[9b] The Groth16 wrap through the CLI on a small inner proof (the
    mul_chain fixture at security 30, proved on the card; its segment
    launches must be ``segments``): setup and cached-key runs, then a
    flipped byte.  Returns the inner prove's launch counts."""
    from pathlib import Path

    from provekit_tpu_torch.native import build as NB
    root = Path(__file__).resolve().parent
    log(f"[9] curve engine {NB.make(NB.CURVE).name} (built in phase 2)")
    inputs, _ = fixture_cases()["mul_chain"]
    toml = work / "mul_chain.Prover.toml"
    toml.write_text(prover_toml(inputs))
    nps, np_ = work / "mul_chain.nps", work / "mul_chain.np"
    t0 = time.perf_counter()
    run_cli(["prepare", str(root / "tests" / "fixtures" / "mul_chain.json"),
             "-o", str(nps), "--security", str(RECURSION_SECURITY),
             "--max-pow-bits", str(RECURSION_MAX_POW)],
            work / "mul_chain_prepare.txt")
    reset_counts(counters)
    with recorded_segments() as calls:
        run_cli(["prove", str(nps), str(toml), "-o", str(np_)],
                work / "mul_chain_prove.txt")
    launches = path_counts(counters)
    check_segments("[9] mul_chain", calls, segments)
    log(f"[9] mul_chain at security {RECURSION_SECURITY}: prepare and "
        f"prove through the CLI in {time.perf_counter() - t0:.3f} s; "
        f"launches during the prove: {launches}")
    missing = [k for k in ON_PATH if launches[k] <= 0]
    if missing:
        fail(f"kernels not launched by the inner prove: {missing}")

    keys = work / "mul_chain_keys.pkl"
    for run in ("setup", "cached keys"):
        t0 = time.perf_counter()
        out = work / f"recursive_verify_{run.split()[0]}.txt"
        spans = recursion_spans(run_cli(
            ["recursive-verify", str(nps), str(np_), "--keys", str(keys)],
            out))
        counts = wrapper_counts(out.read_text())
        log(f"[9] recursive-verify ({run}) OK in "
            f"{time.perf_counter() - t0:.3f} s: wrapper {counts}; spans "
            + ", ".join(f"{k} {v:.3f} s" for k, v in spans.items())
            + f"; keys {keys.stat().st_size} bytes")

    bad = work / "mul_chain_flipped.np"
    flip_byte(np_, bad)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "provekit_tpu_torch.cli", "recursive-verify",
         str(nps), str(bad), "--keys", str(keys)], cwd=root,
        capture_output=True, text=True, timeout=900)
    if proc.returncode == 0:
        fail(f"recursive-verify accepted a flipped byte: {proc.stdout}")
    log(f"[9] recursive-verify with transcript byte 0 flipped exited "
        f"{proc.returncode} in {time.perf_counter() - t0:.3f} s: "
        f"{(proc.stderr.strip().splitlines() or ['?'])[-1]}")
    keys.unlink()
    return launches


# phase 10: the sharded prover, four ranks sharing the card over gloo
MESH_WORLD = 4
PHASE10_BUDGET_S = 240
POSEIDON_COUNTS = (515_003, 515_005)  # constraints, witnesses


def mesh_shapes() -> dict:
    """The sharded functions' shapes on the poseidon2 x1000 path (the
    shapes of ``parallel.dryrun.check_sharded``): Spartan abce (16, 4,
    2^m_0), WHIR fw (16, 2, 2^m), the RS encoding's NTT (2^21) and the
    largest Merkle leaves of the prove."""
    shape = scheme_shape(*POSEIDON_COUNTS)
    return {"spartan": 1 << shape["m_0"], "whir": 1 << shape["m"],
            "ntt_log": shape["rs_domain_log"],
            "leaf": max(poseidon_leaf_shapes(), key=lambda s: s[0] * s[1])}


def step_collectives(shapes: dict, world: int, host_copies: bool) -> list:
    """The collectives of ``parallel.dryrun.check_sharded`` on ``world``
    ranks, as ``dryrun.comm_rows`` lists them: [stage, collective, calls,
    bytes, host bytes].  The round sums are one int64 (16, 3) all_reduce,
    the NTT two all_to_alls of the rank's (16, n / S) int32 row, the root
    one all_gather of a (16,) int32 digest; over gloo on CUDA tensors
    (``host_copies``) each is copied to the host and its result back."""
    row = 64 * (1 << shapes["ntt_log"]) // world
    rows = [["spartan_round_sharded", "psum_mod", 1, 384, 768],
            ["whir_round_sharded", "psum_mod", 1, 384, 768],
            ["ntt_sharded", "all_to_all", 2, 2 * row, 4 * row],
            ["merkle_root_sharded", "all_gather", 1, 64, 64 + 64 * world]]
    if not host_copies:
        for r in rows:
            r[4] = 0
    return sorted(rows)


def prove_collectives(scheme, world: int) -> list:
    """The collectives of one prove of ``scheme`` on ``world`` ranks, from
    its shape alone, as [stage, collective, calls] rows sorted like
    ``parallel.dryrun.comm_rows``.  An array or a tree of n elements is
    sharded where n / S is a whole number of at least 2.  A sumcheck of r
    rounds on n elements takes min(r, log2(n / S)) psum_mods and one
    all_gather when it shards; a sharded tree takes one all_gather of the
    subtree roots when it is built and one owner_sum of the auth paths each
    time it is opened.  The witness is committed in ``commit_witness`` and
    opened in ``whir_open_witness``; the Spartan rounds, the blinding
    polynomial's commit and its opening run in ``zk_spartan_sumcheck``."""
    calls = {}

    def add(stage, op, k=1):
        if k:
            calls[stage, op] = calls.get((stage, op), 0) + k

    def per_rank(log_n):
        n = 1 << log_n
        return n // world if n % world == 0 and n // world >= 2 else 0

    def tree(stage, log_leaves):
        sharded = per_rank(log_leaves) > 0
        add(stage, "all_gather", sharded)
        return sharded

    def sumcheck(stage, log_n, rounds):
        per = per_rank(log_n)
        k = min(rounds, per.bit_length() - 1) if per else 0
        add(stage, "psum_mod", k)
        add(stage, "all_gather", k > 0)

    def commit(stage, cfg):
        return tree(stage, cfg.starting_log_domain
                    - cfg.initial_folding_factor)

    def open_whir(stage, cfg, sharded):
        log_n = cfg.num_variables
        sumcheck(stage, log_n, cfg.initial_folding_factor)
        log_n -= cfg.initial_folding_factor
        for r, rc in enumerate(cfg.rounds):
            next_sharded = tree(stage, cfg.starting_log_domain - (r + 1)
                                - rc.folding_factor)
            add(stage, "owner_sum", sharded)
            sumcheck(stage, log_n, rc.folding_factor)
            log_n -= rc.folding_factor
            sharded = next_sharded
        add(stage, "owner_sum", sharded)
        sumcheck(stage, log_n, cfg.final_sumcheck_rounds)

    witness = commit("commit_witness", scheme.whir_witness)
    spartan = "zk_spartan_sumcheck"
    sumcheck(spartan, scheme.m_0, scheme.m_0)
    hiding = scheme.whir_for_hiding_spartan
    open_whir(spartan, hiding, commit(spartan, hiding))
    open_whir("whir_open_witness", scheme.whir_witness, witness)
    return sorted([stage, op, k] for (stage, op), k in calls.items())


def mesh_prove_faults(recs: list, scheme, world: int) -> list:
    """What is wrong with the records (``parallel.dryrun.prove_timed``) of
    one prove of ``scheme`` by each of ``world`` ranks: a rank whose
    collectives differ from rank 0's, collective calls other than
    :func:`prove_collectives`'s, or a sumcheck segment launched (under a
    mesh every round runs one at a time)."""
    faults = []
    want = prove_collectives(scheme, world)
    for rank, rec in enumerate(recs):
        got = [row[:3] for row in rec["collectives"]]
        if rec["collectives"] != recs[0]["collectives"]:
            faults.append(f"rank {rank}'s collectives differ from rank 0's")
        if got != want:
            faults.append(f"rank {rank}'s collective calls {got} != {want}")
        for seg in ("whir_segment", "spartan_segment"):
            if rec["launches"].get(seg, 0):
                faults.append(f"rank {rank} launched {seg} "
                              f"{rec['launches'][seg]} times")
    return faults


def log_prove_record(tag: str, label: str, rec: dict) -> None:
    """A line for one of ``parallel.dryrun.prove_timed``'s records."""
    peak = rec["peak_gib"]
    log(f"{tag} {label}: proof sha256 {rec['sha256']}, wall "
        f"{rec['wall_s']:.3f} s; spans "
        + ", ".join(f"{k} {v:.3f} s" for k, v in rec["spans"].items())
        + "; peak device memory "
        + ("not measured" if peak is None else f"{peak:.3f} GiB")
        + f"; launches {rec['launches']}")


def phase_mesh(torch, dev, poseidon) -> dict:
    """[10] The sharded prover (provekit_tpu_torch.parallel): (a) the six
    sharded functions on four ranks sharing the card over gloo, at the
    poseidon2 x1000 path's shapes, each exactly against its single-device
    counterpart on the card, with the collectives' counts against their
    model; then poseidon2 x1000 at security 128 (phase 6's scheme, witness
    and rng state) (b) under ``make_mesh(1)`` in this process, (c) on one
    rank over NCCL, (d) on four ranks sharing the card over gloo, each
    proof to the pinned digest, (d)'s verified, no segment launched, and
    (c)'s and every (d) rank's collective calls those of
    :func:`prove_collectives` (the digest alone cannot tell whether the
    prove sharded anything); (e) the CM31 NTT at 2^20 on
    the card against the CPU.  Ranks load the kernels and host libraries
    phase 2 built.  Returns rank 0's launch counts of (d)."""
    import gc
    import pickle

    from provekit_tpu_torch.fields import m31
    from provekit_tpu_torch.parallel import dryrun as D
    from provekit_tpu_torch.parallel import launch, make_mesh
    t10 = time.perf_counter()
    # the ranks are processes of their own: hand them the memory this
    # process's allocator keeps cached from phases 6-9
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        log(f"[10] this process keeps "
            f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB allocated "
            f"({torch.cuda.memory_reserved(dev) / 2**30:.3f} GiB reserved) "
            "on the card beside the ranks")
    shapes = mesh_shapes()
    t0 = time.perf_counter()
    ranks = launch(D.check_sharded, MESH_WORLD, "gloo", device="cuda",
                   share_device=True, args=(SEED, shapes))
    for rank, res in enumerate(ranks):
        log(f"[10] (a) rank {rank}: " + ", ".join(
            f"{k} {tuple(v['shape'])} err {v['max_abs_err']} {v['ms']:.3f} ms"
            for k, v in res["functions"].items()))
        bad = {k: v["max_abs_err"] for k, v in res["functions"].items()
               if v["max_abs_err"]}
        if bad:
            fail(f"sharded functions differ on rank {rank}: {bad}")
        want = step_collectives(shapes, MESH_WORLD,
                                host_copies=dev.type == "cuda")
        if res["collectives"] != want:
            fail(f"rank {rank}'s collectives {res['collectives']} != {want}")
    log(f"[10] (a) the six sharded functions on {MESH_WORLD} gloo ranks "
        f"sharing the card at {shapes}: exact on every rank in "
        f"{time.perf_counter() - t0:.3f} s with the spawn; rank 0's "
        f"collectives:\n{D.comm_table(ranks[0]['collectives'])}")

    whir, r1cs = poseidon["whir"], poseidon["r1cs"]
    witness, state = poseidon["witness"], poseidon["rng_state"]
    mesh1 = make_mesh(1, device=dev)
    rec = D.prove_timed(mesh1, whir, r1cs, witness, state)
    log_prove_record("[10] (b)", "poseidon2 x1000 under make_mesh(1)", rec)
    if rec["sha256"] != POSEIDON_DIGEST:
        fail(f"make_mesh(1) prove digest {rec['sha256']}")
    # one rank in-process has no group: no collective, and no segment
    segs = {k: rec["launches"][k] for k in ("whir_segment",
                                             "spartan_segment")}
    if rec["collectives"] or any(segs.values()):
        fail(f"make_mesh(1) prove: collectives {rec['collectives']}, "
             f"segment launches {segs}")

    blob = pickle.dumps((whir, r1cs, witness))
    t0 = time.perf_counter()
    [rec] = launch(D.prove_blob, 1, "nccl", device="cuda", args=(blob, state))
    log_prove_record("[10] (c)", "one NCCL rank", rec)
    log(f"[10] (c) one NCCL rank's collectives "
        f"({time.perf_counter() - t0:.3f} s with the spawn and a warm-up "
        f"prove):\n{D.comm_table(rec['collectives'])}")
    if rec["sha256"] != POSEIDON_DIGEST:
        fail(f"one NCCL rank's prove digest {rec['sha256']}")
    if not rec["collectives"]:
        fail("one NCCL rank's prove counted no collective")
    faults = mesh_prove_faults([rec], whir, 1)
    if faults:
        fail(f"one NCCL rank's prove: {faults}")

    t0 = time.perf_counter()
    recs = launch(D.prove_blob, MESH_WORLD, "gloo", device="cuda",
                  share_device=True, args=(blob, state))
    spawn_s = time.perf_counter() - t0
    unfused = poseidon["records"]["prove_unfused"]
    log(f"[10] (d) phase 6's FUSE_MAX = 0 prove, one process alone on the "
        f"card: wall {unfused['wall_s']:.3f} s; spans "
        + ", ".join(f"{k} {v:.3f} s" for k, v in unfused["spans"].items())
        + f"; peak {unfused['peak_gib']:.3f} GiB")
    for rank, r in enumerate(recs):
        log_prove_record("[10] (d)", f"rank {rank} of {MESH_WORLD} gloo "
                         "ranks sharing the card", r)
        if r["sha256"] != POSEIDON_DIGEST:
            fail(f"rank {rank}'s prove digest {r['sha256']}")
    faults = mesh_prove_faults(recs, whir, MESH_WORLD)
    if faults:
        fail(f"{MESH_WORLD} gloo ranks' prove: {faults}")
    whir.verify(r1cs, recs[0]["proof"])
    log(f"[10] (d) {MESH_WORLD} ranks: every proof {POSEIDON_DIGEST[:16]}..."
        f", rank 0's verifies; every rank's collectives equal rank 0's and "
        f"prove_collectives' calls, no rank launched a segment; peak device "
        f"memory of the ranks together "
        f"{sum(r['peak_gib'] or 0 for r in recs):.3f} GiB (each rank's CUDA "
        f"context besides); {spawn_s:.3f} s with the spawn and a warm-up "
        f"prove; rank 0's collectives:\n"
        f"{D.comm_table(recs[0]['collectives'])}")

    gen = torch.Generator().manual_seed(SEED)
    xr, xi = (torch.randint(0, m31.P31, (1 << 20,), generator=gen,
                            dtype=torch.int64) for _ in range(2))
    t0 = time.perf_counter()
    want = m31.cm31_ntt(xr, xi)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = m31.cm31_ntt(xr.to(dev), xi.to(dev))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    err = max(max_abs_err(torch, g.cpu(), w) for g, w in zip(got, want))
    back = m31.cm31_intt(*got)
    if err or not (torch.equal(back[0].cpu(), xr)
                   and torch.equal(back[1].cpu(), xi)):
        fail(f"the CM31 NTT at 2^20 differs on the card (max abs err {err})")
    log(f"[10] (e) CM31 NTT at 2^20: the card equals the CPU (max abs err 0)"
        f" and inverts; first call on the card {card_s:.3f} s, on the CPU "
        f"{cpu_s:.3f} s")
    log("[10] " + budget_line("phase 10", time.perf_counter() - t10,
                              PHASE10_BUDGET_S))
    return recs[0]["launches"]


def kernel_rows(rows: dict, by_path: dict, mxu_launches: int) -> list:
    """The kernel JSON's rows: phase 3's rows with each kernel's launches
    on each path (``by_path``: a path's counts), the launches of its
    main path in ``launches``."""
    kernels = []
    for key, row in rows.items():
        name = row.get("kernel", key)
        if name == "mont_mul_mma":
            launches, per_path = mxu_launches, {"mxu_mont": mxu_launches}
        elif "geometry" in row:  # a pass of the NTT: its geometry's launches
            per_path = {p: c.get("ntt_pass_shapes", {}).get(
                row["geometry"], 0) for p, c in by_path.items()}
            launches = per_path[row["path"]]
        else:
            per_path = {p: c[name] for p, c in by_path.items()}
            path = "sha256_x100" if name == "butterfly" else "poseidon2_x1000"
            launches = per_path[path]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"provekit_tpu_torch/csrc/{row['source']}",
            "replaces": row["replaces"], "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "shape": row["shape"], "launches_by_path": per_path})
        if name == "duplex" or name in SEGMENT_KERNELS:
            kernels[-1]["permutations_by_path"] = {
                p: c[f"{name}_permutations"] for p, c in by_path.items()}
        if name in SEGMENT_KERNELS:
            kernels[-1]["chain_floor_ms"] = row["chain_floor_ms"]
        for extra in ("back_to_back_ms", "stage_ms", "transform_ms",
                      "transform_back_to_back_ms",
                      "transform_bound_ms",
                      "transform_plain_ms"):
            if extra in row:
                kernels[-1][extra] = row[extra]
    return kernels


def main() -> int:
    from pathlib import Path
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke run needs a "
             "CUDA card")
    from provekit_tpu_torch.circuits import poseidon, sha256

    dev = torch.device("cuda", 0)
    counters = kernel_counters()
    card, rates = phase_toolchain(torch)
    phase_build()
    rows, segments = phase_kernels(torch, dev, rates)
    mxu_launches = phase_mxu(torch, dev)
    phase_tiny(dev)
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    by_path = {}
    by_path["poseidon2_x1000"], poseidon_export = prove_path(
        torch, dev, "[6]", "poseidon2 x1000",
        lambda: poseidon.hash_chain_circuit(1000), counters, ON_PATH,
        segments["poseidon2_x1000"], POSEIDON_DIGEST,
        out_dir / "chip_smoke_profile_poseidon.txt",
        out_dir / "chip_smoke_profile_poseidon_unfused.txt", plain_solve=True)
    by_path["sha256_x100"], _ = prove_path(
        torch, dev, "[7]", "sha256 x100",
        lambda: sha256.chain_circuit(100), counters,
        ON_PATH + ["butterfly"], segments["sha256_x100"], SHA256_DIGEST,
        out_dir / "chip_smoke_profile_sha256.txt")
    by_path["passport_cli"], passport_nps, passport_np = phase_front_door(
        torch, dev, counters, segments["passport_cli"], out_dir)

    t9 = time.perf_counter()
    work = out_dir / "recursion"
    work.mkdir(parents=True, exist_ok=True)
    phase_gnark_export(passport_nps, passport_np, poseidon_export, work)
    passport_nps.unlink()
    by_path["recursion_cli"] = phase_recursion(
        counters, segments["recursion_cli"], work)
    log("[9] " + budget_line("phase 9", time.perf_counter() - t9,
                             PHASE9_BUDGET_S))
    by_path["mesh4_rank"] = phase_mesh(torch, dev, poseidon_export)
    del poseidon_export
    log(f"total {time.perf_counter() - T0:.3f} s")

    kernels = kernel_rows(rows, by_path, mxu_launches)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
