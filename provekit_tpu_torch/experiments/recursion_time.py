"""Time each stage of the full-width Groth16 wrap, its inner proof made on
the card.

    python3 provekit_tpu_torch/experiments/recursion_time.py [--hashes 4]
        [--security 100] [--circuit poseidon|passport] [--synthesis-only]
        [--device cuda] [--out chiprun_out/recursion_time.json]

The configuration of ``RECURSION_r05.json`` (the JAX package's
``scripts/recursion_scale.py``): a Poseidon2 chain of ``--hashes`` hashes
at security ``--security``, its witness solved and its proof made with one
``random.Random(7)``, as that script does.  Stages, each timed on the
host's clock: the inner prove (after a warm-up prove, ended by a CUDA
synchronize) and its verify, ``build_verifier_circuit`` (synthesis),
``builder.build()`` (the wrapper R1CS), ``groth16.setup``, ``wrap.prove``
(two syntheses and the Groth16 prove) and ``wrap.verify``.  The wrap is
host code (the curve engine of ``native/curve.cpp``); it launches no
kernel.  ``--circuit passport`` wraps the passport circuit of
``passport_test_vector(seed=1)`` with its signature instead (the
configuration users would wrap, at ``--security 128``), and
``--synthesis-only`` stops after the synthesis: its counts and seconds.

It prints a progress line to stderr after each stage and rewrites
``--out`` with what it has so far, so a run cut by its time limit still
shows the stages it reached; the last line of stdout is one JSON object:
the seconds of each stage, the wrapper's counts beside
``RECURSION_r05.json``'s, the host's peak RSS, and the card's name and power
limit.  Needs a CUDA card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import random
import resource
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# RECURSION_r05.json: the JAX package's wrapper of poseidon2 x4 at security
# 100; these counts do not depend on the device.
REFERENCE = {"wrapper_constraints": 2_618_494, "wrapper_wires": 4_043_978,
             "wrapper_public_inputs": 137, "committed_wires": 1_789_190,
             "proof_bytes": 154_572, "inner_constraints": 2063}


def card() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def peak_rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hashes", type=int, default=4)
    ap.add_argument("--security", type=int, default=100)
    ap.add_argument("--circuit", choices=("poseidon", "passport"),
                    default="poseidon")
    ap.add_argument("--synthesis-only", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "recursion_time.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from provekit_tpu_torch import kernels as K
    from provekit_tpu_torch.circuits import passport, poseidon
    from provekit_tpu_torch.compiler import NoirProofScheme
    from provekit_tpu_torch.io import files
    from provekit_tpu_torch.native import build as NB
    from provekit_tpu_torch.recursion import groth16, wrap

    dev = files.require_device(args.device)
    inner = (f"poseidon2-chain x{args.hashes}" if args.circuit == "poseidon"
             else "passport_test_vector(seed=1) with its signature")
    doc = {"inner": inner,
           "security_level": args.security, "device": str(dev),
           "card": card() if dev.type == "cuda" else None,
           "stages_s": {}}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        doc["stages_s"][name] = time.perf_counter() - t0
        doc["peak_rss_gib"] = peak_rss_gib()
        args.out.write_text(json.dumps(doc, indent=1))
        print(f"[{time.perf_counter() - t_start:8.1f} s] {name}: "
              f"{doc['stages_s'][name]:.3f} s, peak RSS "
              f"{doc['peak_rss_gib']:.3f} GiB", file=sys.stderr, flush=True)
        return out

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        stage("kernel_build", K.build)
    stage("curve_engine_build", lambda: NB.make(NB.CURVE))
    if args.circuit == "poseidon":
        program, values, _ = poseidon.hash_chain_circuit(args.hashes)
    else:
        def build_passport():
            dg1, sod, off, date, age, sig = passport.passport_test_vector(1)
            return passport.passport_circuit(dg1, sod, off, date, age,
                                             signature=sig)
        program, values = stage("circuit_build", build_passport)
    scheme = stage("from_program", lambda: NoirProofScheme.from_program(
        program, security_level=args.security, device=dev))
    r1cs, whir = scheme.r1cs, scheme.whir_for_witness
    doc.update(inner_constraints=r1cs.num_constraints,
               inner_witnesses=r1cs.num_witnesses, m=whir.m, m_0=whir.m_0)
    rng = random.Random(7)
    witness = stage("solve_witness",
                    lambda: scheme.solve_witness(values, rng=rng))

    def prove(prove_rng):
        proof = whir.prove(r1cs, witness, rng=prove_rng)
        sync()
        return proof

    stage("inner_warmup_prove", lambda: prove(random.Random(1)))
    proof = stage("inner_prove", lambda: prove(rng))
    stage("inner_verify", lambda: whir.verify(r1cs, proof))
    doc["proof_bytes"] = len(proof)
    doc["proof_sha256"] = hashlib.sha256(proof).hexdigest()

    builder = stage("synthesis", lambda: wrap.build_verifier_circuit(
        whir, r1cs, proof))
    doc.update(wrapper_constraints=builder.num_constraints,
               wrapper_wires=builder.num_wires,
               wrapper_public_inputs=builder.num_public,
               committed_wires=len(builder.lookups.committed))
    if args.synthesis_only:
        doc["total_s"] = time.perf_counter() - t_start
        args.out.write_text(json.dumps(doc, indent=1))
        print(json.dumps(doc))
        return 0
    wrapper, _ = stage("r1cs_build", builder.build)
    committed = builder.lookups.committed
    del builder, _
    keys = stage("groth16_setup", lambda: groth16.setup(
        wrapper, rng=random.Random(99), committed=committed))
    rk = wrap.RecursiveKeys(keys, wrapper)
    g16, publics = stage("wrap_prove", lambda: wrap.prove(
        rk, whir, r1cs, proof, rng=random.Random(100)))
    ok = stage("wrap_verify", lambda: wrap.verify(rk, g16, publics))
    doc["verified"] = bool(ok)
    if (args.circuit, args.hashes, args.security) == ("poseidon", 4, 100):
        doc["reference"] = REFERENCE
        doc["counts_equal_reference"] = all(
            doc[k] == v for k, v in REFERENCE.items())
    doc["total_s"] = time.perf_counter() - t_start
    args.out.write_text(json.dumps(doc, indent=1))
    print(json.dumps(doc))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
