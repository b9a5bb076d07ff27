"""Time poseidon2 x1000 proves of one checkout of the port on the card.

    python3 provekit_tpu_torch/experiments/prove_time.py [--root DIR] [--proves N]
        [--fuse-max N] [--mesh WORLD]

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
(0: every round one at a time, as before them).  ``--mesh 1`` proves
under ``parallel.make_mesh(1)`` in this process, ``--mesh W`` with W > 1 on
W gloo ranks sharing the card (``parallel.launch``; each rank a warm-up
and one timed prove), as ``chip_smoke.py`` phase 10 (b) and (d) do, after
the warm-up prove alone; the line then holds each prove's seconds and
digest.
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
    ap.add_argument("--mesh", type=int, default=None,
                    help="prove on a mesh of this many ranks")
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
    for mod, name in ((ntt, "butterfly"), (ntt, "ntt_pass"),
                      (S, "compress_fold_v"), (S, "duplex_v")):
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
    if args.mesh is not None:
        out.update(mesh_proves(args.mesh, args.proves, whir, r1cs, witness,
                               rng.getstate(), dev))
        print(json.dumps(out), flush=True)
        return 0
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


def mesh_proves(world: int, proves: int, whir, r1cs, witness, rng_state,
                dev) -> dict:
    """Proves on a mesh of ``world`` ranks from ``rng_state``: in this
    process under ``make_mesh(1)`` (a warm-up, then ``proves``), or on
    ``world`` gloo ranks sharing the card (one timed prove a rank)."""
    import pickle

    from provekit_tpu_torch.parallel import dryrun as D
    from provekit_tpu_torch.parallel import launch, make_mesh
    if world == 1:
        mesh = make_mesh(1, device=dev)
        D.prove_timed(mesh, whir, r1cs, witness, rng_state)
        recs = [D.prove_timed(mesh, whir, r1cs, witness, rng_state)
                for _ in range(proves)]
    else:
        recs = launch(D.prove_blob, world, "gloo", device="cuda",
                      share_device=True,
                      args=(pickle.dumps((whir, r1cs, witness)), rng_state))
    return {"mesh": world, "prove_s": [r["wall_s"] for r in recs],
            "proof_sha256": sorted({r["sha256"] for r in recs}),
            "peak_gib": [r["peak_gib"] for r in recs],
            "launches_per_prove": recs[0]["launches"]}


if __name__ == "__main__":
    sys.exit(main())
