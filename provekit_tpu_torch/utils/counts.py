"""The kernel wrappers' launch counters, read and reset together.

Each wrapper of a CUDA kernel adds one to its ``.launches`` where it
launches its kernel (and the sponge's wrappers count their permutations in
``.permutations``); these functions collect them for the smoke run and for
the ranks of the sharded prover, which run in processes of their own.
"""

from __future__ import annotations

# the fused sumcheck segments (csrc/sumcheck_segment.cu)
SEGMENT_KERNELS = ["whir_segment", "spartan_segment"]


def kernel_counters() -> dict:
    """Kernel name -> its wrapper, every kernel of ``csrc/`` but the
    tensor-core experiment's."""
    from ..fields import vector as V
    from ..hash import skyscraper as S
    from ..ops import fused, ntt
    return {"mont_mul": V.mont_mul, "ntt_stage": ntt.ntt_stage,
            "butterfly": ntt.butterfly, "compress": S.compress_v,
            "compress_fold": S.compress_fold_v, "permute": S.permute_v,
            "duplex": S.duplex_v,
            "whir_segment": fused.whir_sumcheck_segment,
            "spartan_segment": fused.spartan_sumcheck_fused}


def reset_counts(counters: dict) -> None:
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "permutations"):
            fn.permutations = 0


def read_counts(counters: dict) -> dict:
    """Each counter's launches, and the sponge's permutations: in duplex
    launches, in the segment kernels, in all."""
    out = {k: fn.launches for k, fn in counters.items()}
    out["duplex_permutations"] = counters["duplex"].permutations
    for k in SEGMENT_KERNELS:
        out[f"{k}_permutations"] = counters[k].permutations
    out["segment_permutations"] = sum(counters[k].permutations
                                      for k in SEGMENT_KERNELS)
    out["sponge_permutations"] = (out["duplex_permutations"]
                                  + out["segment_permutations"])
    return out
