"""Time poseidon2 x1000 proves of one checkout of the port on the card.

    python3 provekit_tpu_torch/experiments/prove_time.py [--root DIR] [--proves N]
        [--fuse-max N]

Imports ``provekit_tpu_torch`` from the checkout at ``--root`` (by default
the one holding this file), builds poseidon2 x1000 at security 128 on CUDA
card 0, solves its witness, makes one warm-up prove, then times ``--proves``
proves and one verify, each ended by a CUDA synchronize.  It prints one JSON
line: the set-up and prove and verify seconds, the proof's length and
SHA-256, the launch counts of the timed proves and their peak device
memory (and the sponge's permutations, where the checkout counts them).
It calls only entry points that every slice of the port has, so two
checkouts (a parent commit unpacked beside this one) can be run in turn in
one call on one card, each in a fresh process.  ``--fuse-max`` sets
``ops.fused.FUSE_MAX`` in a checkout that has the fused sumcheck segments
(0: every round one at a time, as before them).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import random
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--proves", type=int, default=3)
    ap.add_argument("--fuse-max", type=int, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))

    import torch

    import provekit_tpu_torch
    from provekit_tpu_torch.circuits import poseidon
    from provekit_tpu_torch.compiler import NoirProofScheme
    from provekit_tpu_torch.fields import vector as V
    from provekit_tpu_torch.hash import skyscraper as S
    from provekit_tpu_torch.ops import fused, ntt

    if not torch.cuda.is_available():
        raise SystemExit("prove_time: needs a CUDA card")
    dev = torch.device("cuda", 0)
    counters = {"mont_mul": V.mont_mul, "ntt_stage": ntt.ntt_stage,
                "compress": S.compress_v, "permute": S.permute_v}
    for mod, name in ((ntt, "butterfly"), (S, "compress_fold_v"),
                      (S, "duplex_v")):
        if hasattr(mod, name):
            counters[name.removesuffix("_v")] = getattr(mod, name)
    for name in ("whir_sumcheck_segment", "spartan_sumcheck_fused"):
        if hasattr(fused, name):
            counters[name] = getattr(fused, name)

    out = {"package": str(Path(provekit_tpu_torch.__file__).parent)}
    if args.fuse_max is not None:
        if not hasattr(fused, "FUSE_MAX"):
            raise SystemExit("prove_time: this checkout has no FUSE_MAX")
        fused.FUSE_MAX = out["fuse_max"] = args.fuse_max
    t0 = time.perf_counter()
    program, values, _ = poseidon.hash_chain_circuit(1000)
    scheme = NoirProofScheme.from_program(program, security_level=128,
                                          device=dev)
    rng = random.Random(1)
    witness = scheme.solve_witness(values, rng=rng)
    out["setup_s"] = time.perf_counter() - t0
    whir, r1cs = scheme.whir_for_witness, scheme.r1cs

    def prove() -> tuple[bytes, float]:
        t = time.perf_counter()
        proof = whir.prove(r1cs, witness, rng=rng)
        torch.cuda.synchronize()
        return proof, time.perf_counter() - t

    _, out["warmup_prove_s"] = prove()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    if "duplex" in counters:
        S.duplex_v.permutations = 0
    proofs, out["prove_s"] = [], []
    for _ in range(args.proves):
        proof, sec = prove()
        proofs.append(proof)
        out["prove_s"].append(sec)
    out["launches_per_prove"] = {k: fn.launches / args.proves
                                 for k, fn in counters.items()}
    if "duplex" in counters:
        out["permutations_per_prove"] = S.duplex_v.permutations / args.proves
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    t = time.perf_counter()
    whir.verify(r1cs, proofs[0])
    out["verify_s"] = time.perf_counter() - t
    out["proof_bytes"] = len(proofs[0])
    out["proof_sha256"] = hashlib.sha256(proofs[0]).hexdigest()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
