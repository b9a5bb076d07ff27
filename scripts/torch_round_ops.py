"""Count the torch operations one sumcheck round dispatches when it runs
one at a time (``ops/fused.py:whir_rounds`` and ``spartan_rounds``).

    python3 scripts/torch_round_ops.py

Runs on the CPU.  Each call of a kernel's wrapper (``V.mont_mul``,
``S.duplex_v``) counts as one operation, as it is one launch on the card;
every other torch operation counts as one, except views (``view``,
``slice``, ``select``, ``expand`` and their kin), which launch nothing.
The shapes are the rounds a poseidon2 x1000 prove runs inside its fused
segments: WHIR (2^14, 2), (4096, 4), (256, 4), (16, 4) and Spartan
(2^14, 14).  Prints one JSON line: the operations of each shape and per
round.
"""

from __future__ import annotations

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

SHAPES = [("whir", 1 << 14, 2), ("whir", 4096, 4), ("whir", 256, 4),
          ("whir", 16, 4), ("spartan", 1 << 14, 14)]


def main() -> int:
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from provekit_tpu_torch.fields import vector as V
    from provekit_tpu_torch.hash import skyscraper as S
    from provekit_tpu_torch.ops import fused

    torch.set_num_threads(1)
    aten = torch.ops.aten
    views = {aten.view.default, aten.slice.Tensor, aten.select.int,
             aten._unsafe_view.default, aten.alias.default,
             aten.expand.default, aten.detach.default, aten.t.default,
             aten.unsqueeze.default, aten.squeeze.dim,
             aten.as_strided.default, aten.unbind.int, aten.split.Tensor}
    count = {"ops": 0, "inside": 0}

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not count["inside"] and func not in views:
                count["ops"] += 1
            return func(*args, **(kwargs or {}))

    def one_op(fn):
        def wrapper(*args, **kwargs):
            count["ops"] += 1
            count["inside"] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                count["inside"] -= 1
        return wrapper

    V.mont_mul = one_op(V.mont_mul_plain)
    S.duplex_v = one_op(S.duplex_plain)
    rng = np.random.default_rng(1)

    def planes(*shape):
        d = rng.integers(0, 1 << 16, size=(16, *shape), dtype=np.int64)
        d[15] = rng.integers(0, 0x3064, size=shape)
        return torch.from_numpy(d.astype(np.int32))

    out = []
    state = planes(2)
    for kind, n, rounds in SHAPES:
        count["ops"] = 0
        with Counter():
            if kind == "whir":
                fused.whir_rounds(planes(2, n), state, rounds)
            else:
                m = rounds
                fused.spartan_rounds(planes(4, n), state, planes(1),
                                     planes(1), planes(1), planes(m, 4),
                                     planes(m), planes(m), planes(m), m)
        out.append({"kind": kind, "n": n, "rounds": rounds,
                    "ops": count["ops"],
                    "ops_per_round": count["ops"] / rounds})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
