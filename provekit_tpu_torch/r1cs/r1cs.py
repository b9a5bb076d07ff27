"""R1CS constraint system: interner, host COO matrices, device matvecs.

Port of ``provekit_tpu/r1cs/r1cs.py`` (reference ``provekit/common/src/
r1cs.rs``): three sparse matrices A, B, C over Fr with interned coefficient
values, satisfying ``(A z) o (B z) == C z``; witness index 0 is the constant
one.  A matrix freezes to device COO tensors (rows, cols, Montgomery value
planes) per device; a matvec is a gather, a batched Montgomery product and a
modular segment sum.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields import bn254 as F
from ..fields import vector as V
from ..fields.wide import segment_sum_mod


class Interner:
    """Deduplicates field constants (reference: O(n) scan; here a dict)."""

    def __init__(self):
        self.values: list[int] = []
        self._index: dict[int, int] = {}

    def intern(self, value: int) -> int:
        value %= F.P
        idx = self._index.get(value)
        if idx is None:
            idx = len(self.values)
            self.values.append(value)
            self._index[value] = idx
        return idx

    def get(self, idx: int) -> int:
        return self.values[idx]

    def __len__(self) -> int:
        return len(self.values)


class SparseMatrix:
    """COO sparse matrix over Fr with interned values (build on host)."""

    def __init__(self, num_rows: int, num_cols: int, interner: Interner):
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.interner = interner
        self.rows: list[int] = []
        self.cols: list[int] = []
        self.value_ids: list[int] = []
        self._frozen = None

    def set(self, row: int, col: int, value: int) -> None:
        assert 0 <= row and 0 <= col < self.num_cols
        self.num_rows = max(self.num_rows, row + 1)
        self.rows.append(row)
        self.cols.append(col)
        self.value_ids.append(self.interner.intern(value))
        self._frozen = None

    def grow(self, num_rows: int, num_cols: int) -> None:
        self.num_rows = max(self.num_rows, num_rows)
        self.num_cols = max(self.num_cols, num_cols)
        self._frozen = None

    @property
    def nnz(self) -> int:
        return len(self.rows)

    def iter_entries(self):
        for r, c, vid in zip(self.rows, self.cols, self.value_ids):
            yield r, c, self.interner.get(vid)

    # -- device side -------------------------------------------------------

    def __getstate__(self):
        """The host matrix; its device copy is a cache, left behind."""
        return {**self.__dict__, "_frozen": None}

    def frozen(self, device) -> "FrozenMatrix":
        device = torch.device(device)
        if self._frozen is None or self._frozen.rows.device != device:
            table = V.pack([F.to_mont(v) for v in self.interner.values],
                           device)
            vids = torch.from_numpy(
                np.asarray(self.value_ids, dtype=np.int64)).to(device)
            vals = table[:, vids] if self.nnz else V.zeros((0,), device)
            self._frozen = FrozenMatrix(
                torch.from_numpy(np.asarray(self.rows, dtype=np.int64)).to(
                    device),
                torch.from_numpy(np.asarray(self.cols, dtype=np.int64)).to(
                    device),
                vals, self.num_rows, self.num_cols)
        return self._frozen

    def mul_right(self, z: torch.Tensor) -> torch.Tensor:
        """M @ z: z is (16, num_cols) Montgomery -> (16, num_rows)."""
        return self.frozen(z.device).mul_right(z)

    def mul_left(self, e: torch.Tensor) -> torch.Tensor:
        """e^T @ M: e is (16, num_rows) Montgomery -> (16, num_cols)."""
        return self.frozen(e.device).mul_left(e)


@dataclass
class FrozenMatrix:
    rows: torch.Tensor  # (nnz,) int64
    cols: torch.Tensor  # (nnz,) int64
    vals: torch.Tensor  # (16, nnz) Montgomery
    num_rows: int
    num_cols: int

    def mul_right(self, z: torch.Tensor) -> torch.Tensor:
        prods = V.mont_mul(self.vals, z[:, self.cols])
        return segment_sum_mod(prods, self.rows, self.num_rows)

    def mul_left(self, e: torch.Tensor) -> torch.Tensor:
        prods = V.mont_mul(self.vals, e[:, self.rows])
        return segment_sum_mod(prods, self.cols, self.num_cols)


class R1CS:
    """The constraint system (reference ``r1cs.rs``): A z o B z = C z."""

    def __init__(self):
        self.interner = Interner()
        self.a = SparseMatrix(0, 1, self.interner)
        self.b = SparseMatrix(0, 1, self.interner)
        self.c = SparseMatrix(0, 1, self.interner)
        self.num_public_inputs = 0
        self.num_witnesses = 1  # index 0 is the constant 1

    @property
    def num_constraints(self) -> int:
        return self.a.num_rows

    def new_witness(self) -> int:
        return self.new_witnesses(1)

    def new_witnesses(self, n: int) -> int:
        # hot path (one call per witness builder): direct attribute stores
        # instead of per-matrix grow() calls with max()
        first = self.num_witnesses
        nw = first + n
        self.num_witnesses = nw
        a, b, c = self.a, self.b, self.c
        a.num_cols = b.num_cols = c.num_cols = nw
        a._frozen = b._frozen = c._frozen = None
        return first

    def add_constraint(self, a_terms, b_terms, c_terms) -> None:
        """Each *_terms: iterable of (coeff:int, witness_index:int)."""
        # hot path (one call per constraint): inlined SparseMatrix.set
        row = self.a.num_rows
        new_rows = row + 1
        p = F.P
        for m, terms in ((self.a, a_terms), (self.b, b_terms),
                         (self.c, c_terms)):
            m.num_rows = new_rows
            m._frozen = None
            rows_app = m.rows.append
            cols_app = m.cols.append
            vids_app = m.value_ids.append
            intern = m.interner.intern
            for coeff, widx in terms:
                coeff %= p
                if coeff:
                    rows_app(row)
                    cols_app(widx)
                    vids_app(intern(coeff))

    # -- evaluation --------------------------------------------------------

    def witness_bounds(self, z: torch.Tensor):
        """(A z, B z, (A z) o (B z)) padded to a power of two.

        c is derived elementwise from a o b, not C z (reference
        calculate_witness_bounds)."""
        az = self.a.mul_right(z)
        bz = self.b.mul_right(z)
        cz = V.mont_mul(az, bz)
        n = self.num_constraints
        m = 1 << max(1, (n - 1).bit_length()) if n > 1 else 1
        pad = (0, m - n)
        return tuple(torch.nn.functional.pad(x, pad) for x in (az, bz, cz))

    def is_satisfied(self, z: torch.Tensor) -> bool:
        az = self.a.mul_right(z)
        bz = self.b.mul_right(z)
        cz = self.c.mul_right(z)
        return bool(V.eq_mask(V.mont_mul(az, bz), cz).all())

    def check_z0(self, z: torch.Tensor) -> bool:
        one = V.pack([F.to_mont(1)], z.device)
        return bool(V.eq_mask(z[:, :1], one).all())
