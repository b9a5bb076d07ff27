"""LogUp lookup tables for the recursion circuit (gnark logderivlookup
equivalent).

Port of ``provekit_tpu/recursion/lookup.py``.

The reference's gnark circuit verifies Skyscraper in-circuit through
``gnark-skyscraper`` (recursive-verifier/go.mod:8-10), which constrains the
bar's byte S-box with gnark's log-derivative lookup argument rather than
bit decomposition.  This module is that layer for the in-tree stack: an
8-bit (in, out) S-box table, a 16-bit range table, and borrow-chain
comparison gadgets built on them.  Replacing the 254-bit boolean bar
decomposition (recursion/gadgets.py:41-60) with byte lookups takes one
in-circuit compress from 5,078 constraints to ~500 (RECURSION_r04's named
fix) and the production wrapper from 23.9M wires into Groth16 range.

Soundness model (identical to gnark's): the lookup argument

    sum_j 1/(beta - in_j - theta*out_j)  ==  sum_t m_t/(beta - t - theta*S(t))

is sound only if (beta, theta) are sampled AFTER the prover fixed every
looked-up value and multiplicity.  In a non-interactive Groth16 wrapper
that is done with a Pedersen commitment over exactly those wires
(recursion/groth16.py commitment extension, mirroring gnark's
``api.Compiler().Commit``): the proof carries D = sum z_i * K_i over the
committed wires plus a proof of knowledge, and beta/theta are derived by
hashing D (wrap.py::lookup_challenges).  Every wire whose value enters a
lookup row MUST therefore be allocated through this class (it records the
committed-wire indices), and the challenge wires are public inputs whose
values the wrapper verifier recomputes from D.

Constraint accounting per use:
  * sbox byte lookup:   2 rows (q = theta*out product, denominator inverse)
  * 16-bit range check: 1 row  (denominator inverse; denominator is linear)
  * limbs <= constant:  3 rows/limb (linear borrow relation, borrow bool,
                        range check of the difference limb)
  * tables (finalize):  1 row/table row (multiplicity-weighted inverse)
                        + 2 sum equalities
"""

from __future__ import annotations

from ..fields import bn254 as F
from ..hash.skyscraper import sbox
from .builder import LC, ONE, ZERO, CircuitBuilder

P = F.P

SBOX_TABLE = [sbox(v) for v in range(256)]

# Placeholder challenge values for shape-only synthesis (pass 1, before the
# commitment exists).  Arbitrary non-small constants so no pass-1 denominator
# is zero by accident; the real values come from hashing the commitment.
PLACEHOLDER_BETA = int.from_bytes(b"provekit-tpu-logup-placeholder-b", "big") % P
PLACEHOLDER_THETA = int.from_bytes(b"provekit-tpu-logup-placeholder-t", "big") % P


class Lookups:
    """Deferred logUp accumulator attached to one CircuitBuilder.

    Gadget methods allocate COMMITTED wires (recorded in
    ``self.committed``) and record lookup rows; :meth:`finalize` emits the
    table-side constraints and the two logUp sum equalities against the
    challenge wires.
    """

    def __init__(self, b: CircuitBuilder):
        self.b = b
        self.sbox_rows: list = []      # (in_lc, out_lc)
        self.r16_rows: list = []       # lc
        self.sbox_mult = [0] * 256
        self.r16_mult = [0] * 65536
        self.committed: list[int] = []  # wire indices, allocation order
        self.finalized = False

    # -- committed allocation ------------------------------------------------

    def _alloc_committed(self, value: int) -> LC:
        lc = self.b.alloc(value)
        (wire,) = lc.terms
        self.committed.append(wire)
        return lc

    # -- primitive lookups ---------------------------------------------------

    def sbox_byte(self, v: int) -> tuple[LC, LC]:
        """Allocate committed wires (v, S(v)) and record the table row."""
        assert 0 <= v < 256
        in_lc = self._alloc_committed(v)
        out_lc = self._alloc_committed(SBOX_TABLE[v])
        self.sbox_rows.append((in_lc, out_lc))
        self.sbox_mult[v] += 1
        return in_lc, out_lc

    def limb16(self, v: int) -> LC:
        """Allocate a committed 16-bit limb, range-pinned by lookup."""
        assert 0 <= v < 65536
        lc = self._alloc_committed(v)
        self.r16_rows.append(lc)
        self.r16_mult[v] += 1
        return lc

    def range16(self, lc: LC) -> None:
        """Record a range lookup of an existing LC.  The LC's value must be
        determined by committed/public wires (soundness precondition)."""
        v = self.b.value(lc)
        assert v < 65536
        self.r16_rows.append(lc)
        self.r16_mult[v] += 1

    # -- comparison / decomposition gadgets ----------------------------------

    def assert_limbs_le_constant(self, limbs: list, c: int) -> None:
        """Enforce sum(limbs[i] 2^16i) <= c as INTEGERS.

        Precondition: every limb's value is already pinned to [0, 2^16)
        (by range lookup or booleanity).  Limbwise borrow subtraction of
        X from c: each relation holds over small integers (all quantities
        < 2^17 << p), so the final zero borrow proves X <= c exactly.
        3 constraints per limb.
        """
        b = self.b
        n = len(limbs)
        assert c < 1 << (16 * n)
        borrow_in = ZERO
        xv = sum(b.value(l) << (16 * i) for i, l in enumerate(limbs))
        assert xv <= c, "honest value exceeds bound"
        bi_val = 0
        for i in range(n):
            ci = (c >> (16 * i)) & 0xFFFF
            xi = b.value(limbs[i])
            raw = ci - xi - bi_val
            bo_val = 1 if raw < 0 else 0
            e_val = raw + (bo_val << 16)
            assert 0 <= e_val < 65536
            if i + 1 < n:
                borrow_out = b.alloc(bo_val)
                b.assert_bool(borrow_out)
            else:
                borrow_out = ZERO  # top borrow forced to 0: X <= c
                assert bo_val == 0
            e = self.limb16(e_val)
            b.assert_zero(borrow_out.scale(1 << 16) - borrow_in
                          - limbs[i] - e + ci)
            borrow_in = borrow_out
            bi_val = bo_val

    def canonical_limbs(self, x: LC, low_bits: int = 0):
        """Decompose x into 16 16-bit limbs of its CANONICAL representative
        (integer value pinned <= p-1), recomposition enforced.

        With ``low_bits`` > 0 the lowest ceil(low_bits/16) limbs are built
        from boolean wires instead of range lookups and the bit list is
        returned alongside: (limbs, bits).  Used for STIR query indices
        where the low bits drive Merkle path directions.
        """
        b = self.b
        xv = b.value(x)
        n_bit_limbs = (low_bits + 15) // 16
        bits: list = []
        limbs: list = []
        for j in range(16):
            lv = (xv >> (16 * j)) & 0xFFFF
            if j < n_bit_limbs:
                limb = LC()
                for k in range(16):
                    bit = b.alloc((lv >> k) & 1)
                    b.assert_bool(bit)
                    bits.append(bit)
                    limb = limb + bit.scale(1 << k)
                limbs.append(limb)
            else:
                limbs.append(self.limb16(lv))
        acc = LC()
        for j, limb in enumerate(limbs):
            acc = acc + limb.scale(1 << (16 * j))
        b.assert_eq(acc, x)
        self.assert_limbs_le_constant(limbs, P - 1)
        if low_bits:
            return limbs, bits
        return limbs

    def uint_limbs(self, x: LC, nbits: int) -> list:
        """Decompose x into nbits/16 range-checked limbs, pinning x < 2^nbits
        (e.g. the 64-bit PoW nonce).  nbits must be a multiple of 16."""
        assert nbits % 16 == 0
        b = self.b
        xv = b.value(x)
        assert xv < 1 << nbits
        limbs = [self.limb16((xv >> (16 * j)) & 0xFFFF)
                 for j in range(nbits // 16)]
        acc = LC()
        for j, limb in enumerate(limbs):
            acc = acc + limb.scale(1 << (16 * j))
        b.assert_eq(acc, x)
        return limbs

    # -- finalization --------------------------------------------------------

    def finalize(self, beta: LC, theta: LC) -> None:
        """Emit table-side rows and the logUp sum equalities.

        ``beta``/``theta`` are the challenge wires (public inputs whose
        values the wrapper verifier recomputes from the commitment).
        Multiplicity wires are committed; each table row costs ONE
        constraint (w_t * (beta - t - theta*S(t)) == m_t, summing w_t).
        """
        assert not self.finalized
        self.finalized = True
        b = self.b
        beta_v = b.value(beta)
        theta_v = b.value(theta)

        def unit_sum(lcs):
            # sum of single-wire unit LCs without O(n^2) dict copies
            terms: dict = {}
            for lc in lcs:
                ((w, c),) = lc.terms.items()
                nc = (terms.get(w, 0) + c) % P
                if nc:
                    terms[w] = nc
                else:
                    terms.pop(w, None)
            return LC(terms)

        # sbox table side
        table_ws = []
        for t, out in enumerate(SBOX_TABLE):
            m = self.sbox_mult[t]
            if m == 0:
                continue
            m_lc = self._alloc_committed(m)
            denom = beta - theta.scale(out) - t
            dv = (beta_v - theta_v * out - t) % P
            w = b.alloc(m * pow(dv, P - 2, P) % P if dv else 0)
            b.assert_mul(w, denom, m_lc)
            table_ws.append(w)
        # lookup side
        look_ws = []
        for in_lc, out_lc in self.sbox_rows:
            q = b.mul(theta, out_lc)
            denom = beta - in_lc - q
            look_ws.append(b.inverse(denom))
        b.assert_eq(unit_sum(look_ws), unit_sum(table_ws))

        # 16-bit range table side (single column, linear denominators);
        # only rows with nonzero multiplicity are materialized — absent rows
        # contribute zero to the table sum, so a lookup can never land on
        # them, and the table stays proportional to the used value set.
        table_ws = []
        for t in range(65536):
            m = self.r16_mult[t]
            if m == 0:
                continue
            m_lc = self._alloc_committed(m)
            denom = beta - t
            dv = (beta_v - t) % P
            w = b.alloc(m * pow(dv, P - 2, P) % P if dv else 0)
            b.assert_mul(w, denom, m_lc)
            table_ws.append(w)
        look_ws = [b.inverse(beta - lc) for lc in self.r16_rows]
        b.assert_eq(unit_sum(look_ws), unit_sum(table_ws))
