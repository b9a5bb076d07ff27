#!/usr/bin/env python3
"""Smoke run of the torch port (provekit_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one or more lines each:
  1. card and toolchain (nvidia-smi name and power limit, torch, CUDA, nvcc);
  2. build of the CUDA kernels from provekit_tpu_torch/csrc, with its time;
  3. each kernel against its plain torch version on the card at the main
     path's shapes: exact equality, and both times (CUDA events, median);
  4. the tiny scheme on the card: pinned proof digest, verify, tamper;
  5. the main path, poseidon2 x1000 at security 128, through the port's
     entry points: build, from_program, solve_witness, a warm-up prove, a
     timed prove (its five spans, each kernel's launch count and the peak
     device memory), one more prove under torch.profiler (device busy
     share; the kernel table goes to chiprun_out/chip_smoke_profile.txt),
     verify, and a flipped byte rejected.
The line before the last is the kernel JSON; the last line is
{"ok": true, "device": {...}}.  Any failure exits non-zero before it.  The
script needs a CUDA card and the repository beside it; it imports no JAX.
"""

import hashlib
import json
import random
import statistics
import subprocess
import sys
import time

TINY_DIGEST = "efa6851f51a1090ab1139f427a9a67daa4b2c16037937f0e853bb8db0c5cbfb0"
TPU_KERNEL = "provekit_tpu/ops/pallas_kernels.py"
SEED = 20261016


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def cuda_ms(torch, fn, reps: int) -> float:
    """Median milliseconds of fn() over reps runs, timed with CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_planes(torch, rng, n: int, device):
    """(16, n) canonical field elements from a numpy Generator."""
    import numpy as np
    digits = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    digits[15] = rng.integers(0, 0x3064, size=n)  # top digit < P's: value < P
    return torch.from_numpy(digits.astype(np.int32)).to(device)


def max_abs_err(torch, a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def phase_toolchain(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    from provekit_tpu_torch import kernels as K
    nvcc = subprocess.run([K._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"[1] {card}")
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} nvcc: {nvcc[-1]}")
    return card


def phase_build():
    from provekit_tpu_torch import kernels as K
    t0 = time.perf_counter()
    path = K.build()
    K.lib()
    log(f"[2] kernels built in {time.perf_counter() - t0:.3f} s -> "
        f"{path.name}")


def phase_kernels(torch, dev):
    """Each kernel against its plain version at the main path's shapes."""
    import numpy as np
    from provekit_tpu_torch.fields import vector as V
    from provekit_tpu_torch.hash import skyscraper as S
    from provekit_tpu_torch.ops import ntt

    rng = np.random.default_rng(SEED)
    rows = {}

    def check(name, shape, got, want, ms, plain_ms):
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        log(f"[3] {name} {shape}: equal={err == 0} kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
        if err:
            fail(f"{name} {shape} disagrees with its plain version")
        return err

    n = 1 << 21
    a = random_planes(torch, rng, n, dev)
    b = random_planes(torch, rng, n, dev)
    err = check("mont_mul", f"n=2^21", V.mont_mul(a, b),
                V.mont_mul_plain(a, b),
                ms := cuda_ms(torch, lambda: V.mont_mul(a, b), 20),
                pms := cuda_ms(torch, lambda: V.mont_mul_plain(a, b), 3))
    rows["mont_mul"] = ("mont_mul.cu", 74, err, ms, pms, "n=2^21")

    for chunk in (1, 1024, 2048):
        tw = ntt._twiddle_table((n // chunk).bit_length() - 1, False, dev)
        s = 1
        err = check("ntt_stage", f"n=2^21 chunk={chunk} s={s}",
                    ntt.ntt_stage(a, tw, s, chunk),
                    ntt.ntt_stage_plain(a, tw, s, chunk),
                    ms := cuda_ms(torch,
                                  lambda: ntt.ntt_stage(a, tw, s, chunk), 20),
                    pms := cuda_ms(torch, lambda: ntt.ntt_stage_plain(
                        a, tw, s, chunk), 3))
        if chunk == 1024:
            rows["ntt_stage"] = ("ntt_stage.cu", 174, err, ms, pms,
                                 f"n=2^21 chunk={chunk}")
    coeffs = a[:, :n // 2].contiguous()
    check("rs_encode", "2^20 -> 2^21", ntt.rs_encode(coeffs, 21),
          ntt.rs_encode(coeffs, 21, plain=True),
          cuda_ms(torch, lambda: ntt.rs_encode(coeffs, 21), 10),
          cuda_ms(torch, lambda: ntt.rs_encode(coeffs, 21, plain=True), 3))

    for logn in (17, 20):
        l, r = a[:, :1 << logn], b[:, :1 << logn]
        err = check("compress", f"n=2^{logn}", S.compress_v(l, r),
                    S.compress_plain(l, r),
                    ms := cuda_ms(torch, lambda: S.compress_v(l, r), 10),
                    pms := cuda_ms(torch, lambda: S.compress_plain(l, r), 3))
        if logn == 20:
            rows["compress"] = ("skyscraper.cu", 233, err, ms, pms,
                                f"n=2^{logn}")

    # the sponge's serial chain: 1,000 dependent n = 1 permutations
    calls = 1000

    def chain(fn):
        l, r = a[:, :1], b[:, :1]
        for _ in range(calls):
            l, r = fn(l, r)
        return torch.cat([l, r], dim=1)

    err = check("permute", f"{calls} sequential n=1 calls",
                chain(S.permute_v), chain(S.permute_plain),
                ms := cuda_ms(torch, lambda: chain(S.permute_v), 3) / calls,
                pms := cuda_ms(torch, lambda: chain(S.permute_plain), 1)
                / calls)
    rows["permute"] = ("skyscraper.cu", 297, err, ms, pms, "n=1, per call")
    return rows


def build_tiny_system(seed: int, n_mults: int):
    """z_{i+1} = z_i * z_i + z_i: the JAX package's tests/test_e2e.py
    build_system, on the port's R1CS."""
    from provekit_tpu_torch.fields import bn254 as F
    from provekit_tpu_torch.r1cs import R1CS
    rng = random.Random(seed)
    r = R1CS()
    x0 = r.new_witness()
    vals = {0: 1, x0: rng.randrange(F.P)}
    prev = x0
    for _ in range(n_mults):
        sq = r.new_witness()
        r.add_constraint([(1, prev)], [(1, prev)], [(1, sq)])
        vals[sq] = vals[prev] * vals[prev] % F.P
        nxt = r.new_witness()
        r.add_constraint([(1, sq), (1, prev)], [(1, 0)], [(1, nxt)])
        vals[nxt] = (vals[sq] + vals[prev]) % F.P
        prev = nxt
    return r, [vals[i] for i in range(r.num_witnesses)]


def tiny_scheme(r1cs, device, security=3, folding=2, max_pow=2):
    """The JAX package's tests/test_verifier_circuit.py tiny_scheme."""
    from provekit_tpu_torch.protocol import WhirR1CSScheme
    from provekit_tpu_torch.protocol.scheme import next_power_of_two_log
    from provekit_tpu_torch.whir.parameters import WhirConfig
    m = next_power_of_two_log(r1cs.num_witnesses) + 1
    m_0 = max(1, next_power_of_two_log(r1cs.num_constraints))
    bv = next_power_of_two_log(4 * m_0) + 1
    cfg = dict(batch_size=2, security_level=security, max_pow_bits=max_pow,
               folding_factor=folding)
    return WhirR1CSScheme(
        m=m, m_0=m_0, a_num_terms=next_power_of_two_log(max(1, r1cs.a.nnz)),
        whir_witness=WhirConfig(num_variables=m, **cfg),
        whir_for_hiding_spartan=WhirConfig(num_variables=bv, **cfg),
        security_level=security, max_pow_bits=max_pow, device=device)


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
    log(f"[4] tiny scheme on {dev}: digest {digest[:16]}... matches, "
        f"verify ok, 3 flipped bytes rejected (prove {prove_s:.3f} s)")


def reset_counts(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def profile_prove(torch, whir, r1cs, witness, path) -> None:
    """One more prove under torch.profiler: kernel table + device busy share
    (summed kernel time over the prove's wall time) written to ``path``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        whir.prove(r1cs, witness, rng=random.Random(2))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    launches = sum(e.count for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    summary = (f"profiled prove: wall {wall:.3f} s, device busy "
               f"{busy_us / 1e6:.3f} s ({100 * busy_us / 1e6 / wall:.1f}%), "
               f"{launches} device kernels")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(summary + "\n\n" + events.table(
        sort_by="self_cuda_time_total", row_limit=40) + "\n\n" + events.table(
        sort_by="self_cpu_time_total", row_limit=25))
    log(f"[5] {summary} -> {path}")


def phase_main(torch, dev, counters, profile_to):
    from provekit_tpu_torch.circuits import poseidon
    from provekit_tpu_torch.compiler import NoirProofScheme
    from provekit_tpu_torch.utils import profiling

    stages = {}
    t0 = time.perf_counter()
    program, acir_values, _ = poseidon.hash_chain_circuit(1000)
    stages["circuit_build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scheme = NoirProofScheme.from_program(program, security_level=128,
                                          device=dev)
    stages["from_program"] = time.perf_counter() - t0
    r1cs = scheme.r1cs
    rng = random.Random(1)
    t0 = time.perf_counter()
    witness = scheme.solve_witness(acir_values, rng=rng)
    stages["solve_witness"] = time.perf_counter() - t0
    whir = scheme.whir_for_witness
    log(f"[5] poseidon2 x1000: {r1cs.num_constraints} constraints, "
        f"{r1cs.num_witnesses} witnesses, m={whir.m} m_0={whir.m_0}")

    t0 = time.perf_counter()
    whir.prove(r1cs, witness, rng=rng)
    torch.cuda.synchronize()
    stages["warmup_prove"] = time.perf_counter() - t0

    profiling.GLOBAL.sync = torch.cuda.synchronize
    mark = len(profiling.GLOBAL.root.children)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(counters)
    t0 = time.perf_counter()
    proof = whir.prove(r1cs, witness, rng=rng)
    torch.cuda.synchronize()
    stages["prove"] = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    spans = {s.name: s.elapsed for s in profiling.GLOBAL.root.children[mark:]}
    profiling.GLOBAL.sync = None

    profile_prove(torch, whir, r1cs, witness, profile_to)

    t0 = time.perf_counter()
    whir.verify(r1cs, proof)
    stages["verify"] = time.perf_counter() - t0
    expect_rejected(whir, r1cs, proof, [len(proof) // 2])

    for name, sec in stages.items():
        log(f"[5] stage {name}: {sec:.3f} s")
    for name, sec in spans.items():
        log(f"[5] prove span {name}: {sec:.3f} s")
    log(f"[5] proof {len(proof)} bytes, sha256 "
        f"{hashlib.sha256(proof).hexdigest()}, verify ok, flipped byte "
        f"rejected; launches during the timed prove: {launches}; peak "
        f"device memory {peak_gib:.3f} GiB")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        fail(f"kernels not launched by the main path: {missing}")
    return launches


def main() -> int:
    from pathlib import Path
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke run needs a "
             "CUDA card")
    from provekit_tpu_torch.fields import vector as V
    from provekit_tpu_torch.hash import skyscraper as S
    from provekit_tpu_torch.ops import ntt

    dev = torch.device("cuda", 0)
    counters = {"mont_mul": V.mont_mul, "ntt_stage": ntt.ntt_stage,
                "compress": S.compress_v, "permute": S.permute_v}
    card = phase_toolchain(torch)
    phase_build()
    rows = phase_kernels(torch, dev)
    phase_tiny(dev)
    profile_to = (Path(__file__).resolve().parent / "chiprun_out"
                  / "chip_smoke_profile.txt")
    launches = phase_main(torch, dev, counters, profile_to)

    kernels = []
    for name, (src, line, err, ms, pms, shape) in rows.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"provekit_tpu_torch/csrc/{src}",
            "replaces": f"{TPU_KERNEL}:{line}", "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": pms, "shape": shape})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
