"""Time the RS encodings of one checkout of the port on the card.

    python3 provekit_tpu_torch/experiments/ntt_time.py [--root DIR]
        [--sizes 21 24 25] [--reps 10]

Imports ``provekit_tpu_torch`` from the checkout at ``--root`` (by default
the one holding this file) and, on CUDA card 0, encodes 2^(k-1) seeded
coefficients to 2^k for each k of ``--sizes`` with ``rs_encode`` as the
checkout runs it: the device memory its first encode leaves in cached
tables, one encode between CUDA events (median of ``--reps``), ``--reps``
back to back, the peak device memory of one encode beyond what it held
before, and the device kernels that torch.profiler records in one
encode (three windows, each with the card idle 50 ms at both ends: each
window's count, and the kernels of the longest by name).  Each
encode is checked against the plain transform.  It calls only entry points
that every slice of the port has, so a parent commit unpacked beside this
checkout and this one run in turn in one call compare on one card.  Prints
the card's name and power limit, then one JSON line a size.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--sizes", type=int, nargs="+", default=[21, 24, 25])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from provekit_tpu_torch.ops import ntt

    if not torch.cuda.is_available():
        raise SystemExit("ntt_time: needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)

    def ms(fn, reps):
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
        return float(np.median(times))

    def back_to_back(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def windows(fn, count=3):
        """The device kernels torch.profiler records in ``count`` windows
        of one ``fn()`` each (50 ms idle before and after it), as names
        without namespace and arguments, in the order they started."""
        out = []
        for _ in range(count):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(0.05)
                fn()
                torch.cuda.synchronize()
                time.sleep(0.05)
            events = sorted(
                (e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
            out.append([re.sub(r"^(void )?(\(anonymous namespace\)::)?|\(.*$",
                               "", e.name) for e in events])
        return out

    rng = np.random.default_rng(12)
    for log_n in args.sizes:
        n = 1 << log_n
        d = rng.integers(0, 1 << 16, size=(16, n // 2), dtype=np.int64)
        d[15] = rng.integers(0, 0x3064, size=n // 2)
        coeffs = torch.from_numpy(d.astype(np.int32)).to(dev)

        def encode():
            return ntt.rs_encode(coeffs, log_n)

        row = {"root": str(args.root), "log_n": log_n}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        out = encode()
        torch.cuda.synchronize()
        row["tables_gib"] = (torch.cuda.memory_allocated(dev) - base
                             - out.numel() * 4) / 2**30
        del out
        row["encode_ms"] = ms(encode, args.reps)
        row["encode_back_to_back_ms"] = back_to_back(encode, args.reps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = encode()
        torch.cuda.synchronize()
        row["encode_peak_gib"] = (torch.cuda.max_memory_allocated(dev)
                                  - base) / 2**30
        del out
        seen = windows(encode)
        row["profiler_windows"] = [len(w) for w in seen]
        row["device_kernels"] = dict(collections.Counter(max(seen, key=len)))
        row["equal"] = bool(torch.equal(
            encode(), ntt.rs_encode(coeffs, log_n, plain=True)))
        print(json.dumps(row), flush=True)
        del coeffs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
