"""Time the host library's primitives against their plain versions.

    python3 provekit_tpu_torch/experiments/host_time.py [--calls N]

On the host CPU, no card: the field inverse of ``native/field256.hpp``
(batched divsteps) against Fermat's ``a^(P-2)`` in C
(``experiments/inverse_time.cpp``, built with g++ into ``build/``) and
against CPython's ``pow(a, -1, P)``; ``native.permute`` and
``native.compress`` through ``ctypes`` against ``hash/skyscraper.py``'s
Python versions, microseconds a call over ``--calls`` seeded pairs.  It
prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def per_call_us(fn, args: list) -> float:
    t0 = time.perf_counter()
    for a in args:
        fn(*a)
    return (time.perf_counter() - t0) / len(args) * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    from provekit_tpu_torch import native
    from provekit_tpu_torch.fields import bn254 as F
    from provekit_tpu_torch.hash import skyscraper as S
    from provekit_tpu_torch.native import build as NB

    exe = NB.BUILD_DIR / "inverse_time"
    exe.parent.mkdir(parents=True, exist_ok=True)
    src = Path(__file__).resolve().parent / "inverse_time.cpp"
    subprocess.run([shutil.which("g++") or "g++", "-O3", "-march=native",
                    "-std=c++17", "-o", str(exe), str(src)], check=True)
    out = json.loads(subprocess.run([str(exe)], capture_output=True,
                                    text=True, check=True).stdout)

    import random
    rng = random.Random(20261016)
    pairs = [(rng.randrange(F.P), rng.randrange(F.P))
             for _ in range(args.calls)]
    out["cpython_pow_inverse_us"] = per_call_us(
        lambda a: pow(a, -1, F.P), [(l or 1,) for l, _ in pairs])
    native.load()
    for name in ("permute", "compress"):
        out[f"native_{name}_us"] = per_call_us(getattr(native, name), pairs)
        out[f"python_{name}_us"] = per_call_us(getattr(S, name), pairs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
