"""Wide-accumulator helpers: modular reductions of multi-term digit sums.

Port of ``provekit_tpu/fields/wide.py``.  Segment sums accumulate digit
planes in ``int64``: a segment of k terms sums to below k * 2^16 per plane,
so no segment of any circuit that fits in memory can overflow.  The JAX
package's segment splitting (``split_oversized_segments``) guards a
``uint32`` accumulator that overflows past 2^16 terms; the port has no such
accumulator and needs no split.
"""

from __future__ import annotations

import torch

from . import vector as V
from .bn254 import NLIMBS

reduce_wide = V.reduce_wide


def segment_sum_mod(products: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Modular segment sum: (16, nnz) products -> (16, num_segments)."""
    acc = torch.zeros((NLIMBS, num_segments), dtype=torch.int64,
                      device=products.device)
    acc.index_add_(1, segment_ids.to(torch.int64), products.to(torch.int64))
    return reduce_wide(acc)
