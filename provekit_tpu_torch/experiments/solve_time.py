"""Time the Python witness solve with two field inversions, in turns.

    python3 provekit_tpu_torch/experiments/solve_time.py [--blocks N] [--rounds R]

Builds the sha256 chain of ``--blocks`` blocks, compiles it for the CPU (the
solve runs on the host either way), then solves its witness ``2 * R``
times under ``random.Random(5)``: with ``fields.bn254.inv`` as
``pow(a, P - 2, P)`` (what the port computed before) and as
``pow(a, -1, P)`` (what it computes now), in the order old, new, new, old,
...  Every solve must give the same witness.  It prints one JSON line: the
circuit's sizes, the count of inverse builders, and the seconds of each
solve by kind.  It needs no card.
"""

from __future__ import annotations

import argparse
import collections
import json
import random
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

    from provekit_tpu_torch.circuits import sha256
    from provekit_tpu_torch.compiler import NoirProofScheme
    from provekit_tpu_torch.fields import bn254 as F

    program, values, _ = sha256.chain_circuit(args.blocks)
    scheme = NoirProofScheme.from_program(program, device="cpu")
    kinds = collections.Counter(type(b).__name__
                                for b in scheme.witness_builders)
    new_inv = F.inv

    def old_inv(a: int) -> int:
        if a == 0:
            raise ZeroDivisionError("inverse of zero in Fr")
        return pow(a, F.P - 2, F.P)

    times = {"old": [], "new": []}
    witness = None
    for kind in ["old", "new", "new", "old"] * args.rounds:
        F.inv = old_inv if kind == "old" else new_inv
        t0 = time.perf_counter()
        got = scheme.solve_witness(values, rng=random.Random(5))
        times[kind].append(time.perf_counter() - t0)
        if witness is not None and got != witness:
            raise SystemExit("the two inversions solved different witnesses")
        witness = got
    F.inv = new_inv
    print(json.dumps({
        "blocks": args.blocks,
        "constraints": scheme.r1cs.num_constraints,
        "witnesses": scheme.r1cs.num_witnesses,
        "inverse_builders": kinds["Inverse"],
        "solve_s": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
