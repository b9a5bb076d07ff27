"""Time the Skyscraper kernels of one checkout of the port on the card.

    python3 provekit_tpu_torch/experiments/skyscraper_time.py [--root DIR]

Imports ``provekit_tpu_torch`` from the checkout at ``--root`` (by default
the one holding this file), builds its kernels, and on CUDA card 0 times
with CUDA events (median):
  - compress at n = 2^20 (K4);
  - the sha256 x100 leaf hash of (16, 32, 2^21) leaves through
    ``merkle.hash_leaves`` (one fold launch, or 31 compress launches in a
    checkout without the fold);
  - the sponge's serial chain of 200 dependent permutations as n = 1
    ``permute_v`` calls, and as one ``duplex_v`` squeeze where the checkout
    has it; each also on the host clock;
  - mont_mul at n = 2^21, a kernel neither design changes, as the control.
It counts the SASS instructions of the checkout's Skyscraper and segment
kernels (``cuobjdump -sass``) and prints ptxas's registers and spills of
``sumcheck_segment.cu``; ``chip_smoke.py`` (phase 3) times the segments and
``segment_time.py`` breaks their time down.  The inputs come from one numpy seed, and each
result's SHA-256 is printed, so two checkouts (a parent commit unpacked
beside this one) can be run in turn in one call and held to the same
answers.  It prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

SEED = 20261017
CHAIN = 200


def sass_counts(library: Path) -> dict:
    """Kernel name -> {"instructions": n, "top": {mnemonic: n}} for the
    Skyscraper kernels in ``library``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    out, name, ops = {}, None, None
    for line in text.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            found = re.search(r"(compress_fold_kernel|compress_kernel|"
                              r"permute_kernel|duplex_kernel|"
                              r"whir_segment_kernel|spartan_segment_kernel)",
                              mangled)
            name = found.group(1) if found else None
            if name:
                ops = out.setdefault(name, collections.Counter())
            continue
        m = re.match(
            r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if name and m:
            ops[m.group(2)] += 1
    return {k: {"instructions": sum(c.values()), "top": dict(c.most_common(8))}
            for k, c in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))

    import numpy as np
    import torch

    import provekit_tpu_torch
    from provekit_tpu_torch import kernels as K
    from provekit_tpu_torch.fields import vector as V
    from provekit_tpu_torch.hash import skyscraper as S
    from provekit_tpu_torch.ops import merkle
    from provekit_tpu_torch.utils.profiling import cuda_ms

    if not torch.cuda.is_available():
        raise SystemExit("skyscraper_time: needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    reports = K.build()
    out = {"package": str(Path(provekit_tpu_torch.__file__).parent),
           "sass": sass_counts(K.library_path("skyscraper.cu"))}
    segments = "sumcheck_segment.cu" in K.SIGNATURES
    if segments:
        out["sass"].update(sass_counts(K.library_path("sumcheck_segment.cu")))
        out["segment_ptxas"] = [  # empty where the library was built before
            line.strip() for line in
            reports.get("sumcheck_segment.cu", "").splitlines()
            if "registers" in line or "spill" in line]

    rng = np.random.default_rng(SEED)

    def planes(*shape):
        d = rng.integers(0, 1 << 16, size=(16, *shape), dtype=np.int64)
        d[15] = rng.integers(0, 0x3064, size=shape)
        return torch.from_numpy(d.astype(np.int32)).to(dev)

    def digest(t) -> str:
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    def wall_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    a, b = planes(1 << 21), planes(1 << 21)
    out["mont_mul_2^21_ms"] = cuda_ms(lambda: V.mont_mul(a, b), 20)
    l, r = a[:, :1 << 20], b[:, :1 << 20]
    out["compress_2^20_ms"] = cuda_ms(lambda: S.compress_v(l, r), 20)
    out["compress_2^20_sha256"] = digest(S.compress_v(l, r))

    l0, r0 = a[:, :1], b[:, :1]

    def chain():
        x, y = l0, r0
        for _ in range(CHAIN):
            x, y = S.permute_v(x, y)
        return torch.cat([x, y], dim=1)

    out["permute_chain_ms_per_call"] = cuda_ms(chain, 5) / CHAIN
    out["permute_chain_wall_ms_per_call"] = wall_ms(chain) / CHAIN
    out["chain_state_sha256"] = digest(chain())
    if hasattr(S, "duplex_v"):
        state = torch.cat([l0, r0], dim=1)
        squeeze = lambda: S.duplex_v(state, None, 0, CHAIN)  # noqa: E731
        out["duplex_squeeze_ms_per_permutation"] = cuda_ms(squeeze, 5) / CHAIN
        out["duplex_squeeze_wall_ms_per_permutation"] = (
            wall_ms(squeeze) / CHAIN)
        out["duplex_state_sha256"] = digest(squeeze()[0])
    del a, b, l, r

    leaves = planes(32, 1 << 21)
    fold = getattr(S, "compress_fold_v", None)

    def launches() -> int:
        return S.compress_v.launches + (fold.launches if fold else 0)

    before = launches()
    out["leaf_hash_sha256"] = digest(merkle.hash_leaves(leaves))
    out["leaf_hash_launches"] = launches() - before
    out["leaf_hash_ms"] = cuda_ms(lambda: merkle.hash_leaves(leaves), 5)
    del leaves
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
