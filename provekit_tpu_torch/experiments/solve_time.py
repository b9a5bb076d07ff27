"""Time the native witness solve against the plain Python solve, in turns.

    python3 provekit_tpu_torch/experiments/solve_time.py [--blocks N] [--rounds R]

Builds the sha256 chain of ``--blocks`` blocks, compiles it for the CPU (the
solve runs on the host either way), then solves its witness ``2 * R``
times under ``random.Random(5)``: with the port's native library (the
default of ``solve_witness``) and with the Python ``witness_builder.solve``
(``use_native=False``), in the order native, plain, plain, native, ...
Every solve must give the same witness.  It also times the program's
encoding alone (``native/encode.py``), which each native solve includes.
It prints one JSON line: the circuit's sizes, the count of inverse
builders, the encoding's seconds and the seconds of each solve by kind.
It needs no card.
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
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

    from provekit_tpu_torch.circuits import sha256
    from provekit_tpu_torch.compiler import NoirProofScheme
    from provekit_tpu_torch.native.encode import encode_program

    program, values, _ = sha256.chain_circuit(args.blocks)
    scheme = NoirProofScheme.from_program(program, device="cpu")
    kinds = collections.Counter(type(b).__name__
                                for b in scheme.witness_builders)
    t0 = time.perf_counter()
    encode_program(scheme.witness_builders)
    encode_s = time.perf_counter() - t0

    times = {"native": [], "plain": []}
    witness = None
    for kind in ["native", "plain", "plain", "native"] * args.rounds:
        t0 = time.perf_counter()
        got = scheme.solve_witness(values, rng=random.Random(5),
                                   use_native=kind == "native")
        times[kind].append(time.perf_counter() - t0)
        if witness is not None and got != witness:
            raise SystemExit("the native and plain solves differ")
        witness = got
    print(json.dumps({
        "blocks": args.blocks,
        "constraints": scheme.r1cs.num_constraints,
        "witnesses": scheme.r1cs.num_witnesses,
        "builders": len(scheme.witness_builders),
        "inverse_builders": kinds["Inverse"],
        "encode_s": encode_s,
        "solve_s": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
