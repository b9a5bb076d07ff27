"""Poseidon2 hash-chain circuits: the flagship benchmark workload.

The reference's headline benchmark is ``prove_poseidon_1000`` — a Noir
program hashing with Poseidon2 1000 times (``noir-examples/poseidon-rounds/
src/main.nr``: ``hash_2(plains)`` then 1000 x ``hash_1``;
``tooling/provekit-bench/benches/bench.rs:17-34``).  This module builds the
equivalent ACIR circuit programmatically: a t=3 Poseidon2 permutation
(x^5 S-box, 8 external + 56 internal rounds) iterated N times, together
with the full ACIR witness assignment.

Round constants are generated with the OFFICIAL Grain-LFSR procedure from
the Poseidon/Poseidon2 reference parameter scripts
(``generate_parameters_grain_deterministic.sage``: 80-bit LFSR seeded with
(field=1, sbox=0, n=254, t, R_F, R_P), 160 warm-up rounds, pair-filtered
bit stream, rejection-sampled 254-bit field elements), with the Poseidon2
round-constant layout: t constants per external round, ONE per internal
round.  Matrices are the Poseidon2 t=3 instances: external
M_E = circ(2,1,1), internal M_I = M_E + diag(0,0,1).  The upstream Noir
dependency (TaceoLabs/noir-poseidon) is a git dep of the reference and not
vendored, so byte-level interop with its exact table cannot be checked
offline; the generation procedure is the published one.
"""

from __future__ import annotations

from ..acir import model as acir
from ..fields import bn254 as F

T = 3
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 56
N_BITS = 254


class _Grain:
    """The Poseidon parameter-generation LFSR (80-bit Grain)."""

    def __init__(self, field: int, sbox: int, n: int, t: int,
                 r_f: int, r_p: int):
        bits = []
        for val, width in ((field, 2), (sbox, 4), (n, 12), (t, 12),
                           (r_f, 10), (r_p, 10)):
            bits += [int(b) for b in bin(val)[2:].zfill(width)]
        bits += [1] * 30
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._next_bit()

    def _next_bit(self) -> int:
        s = self.state
        b = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        self.state = s[1:] + [b]
        return b

    def _filtered_bit(self) -> int:
        while True:
            b1 = self._next_bit()
            b2 = self._next_bit()
            if b1:
                return b2

    def field_element(self) -> int:
        while True:
            v = 0
            for _ in range(N_BITS):
                v = (v << 1) | self._filtered_bit()
            if v < F.P:
                return v


def _official_constants() -> list[list[int]]:
    """Per-round constant vectors: t per external round, 1 per internal."""
    g = _Grain(field=1, sbox=0, n=N_BITS, t=T, r_f=FULL_ROUNDS,
               r_p=PARTIAL_ROUNDS)
    rounds = []
    half = FULL_ROUNDS // 2
    for _ in range(half):
        rounds.append([g.field_element() for _ in range(T)])
    for _ in range(PARTIAL_ROUNDS):
        rounds.append([g.field_element()])
    for _ in range(half):
        rounds.append([g.field_element() for _ in range(T)])
    return rounds


_RC = _official_constants()
# Poseidon2 t=3 matrices: external circ(2,1,1); internal adds 1 to the last
# diagonal entry (M_I = [[2,1,1],[1,2,1],[1,1,3]]).
_M_EXT = [[2, 1, 1], [1, 2, 1], [1, 1, 2]]
_M_INT = [[2, 1, 1], [1, 2, 1], [1, 1, 3]]


class _CircuitBuilder:
    """Builds AssertZero-only ACIR + the matching witness assignment."""

    def __init__(self):
        self.opcodes: list = []
        self.values: dict[int, int] = {}
        self.next_witness = 0

    def new_witness(self, value: int) -> acir.Witness:
        w = acir.Witness(self.next_witness)
        self.values[self.next_witness] = value % F.P
        self.next_witness += 1
        return w

    def mul(self, a: acir.Witness, b: acir.Witness) -> acir.Witness:
        out = self.new_witness(self.values[a.index] * self.values[b.index])
        self.opcodes.append(acir.AssertZero(acir.Expression(
            mul_terms=[(1, a, b)],
            linear_combinations=[(F.P - 1, out)])))
        return out

    def linear(self, terms, const: int = 0) -> acir.Witness:
        """New witness = sum coeff*w + const, with one AssertZero."""
        val = const
        for coeff, w in terms:
            val += coeff * self.values[w.index]
        out = self.new_witness(val)
        lc = [(c % F.P, w) for c, w in terms] + [(F.P - 1, out)]
        self.opcodes.append(acir.AssertZero(acir.Expression(
            linear_combinations=lc, q_c=const % F.P)))
        return out


def _sbox(b: _CircuitBuilder, x: acir.Witness) -> acir.Witness:
    x2 = b.mul(x, x)
    x4 = b.mul(x2, x2)
    return b.mul(x4, x)


def _matmul(b: _CircuitBuilder, mat, state: list) -> list:
    return [b.linear([(m, s) for m, s in zip(row, state)]) for row in mat]


def _permutation(b: _CircuitBuilder, state: list) -> list:
    """Poseidon2: M_E pre-layer, external/internal/external rounds."""
    half = FULL_ROUNDS // 2
    state = _matmul(b, _M_EXT, state)
    rcs = iter(_RC)
    for _ in range(half):
        rc = next(rcs)
        state = [b.linear([(1, s)], rc[i]) for i, s in enumerate(state)]
        state = [_sbox(b, s) for s in state]
        state = _matmul(b, _M_EXT, state)
    for _ in range(PARTIAL_ROUNDS):
        rc = next(rcs)
        s0 = _sbox(b, b.linear([(1, state[0])], rc[0]))
        state = _matmul(b, _M_INT, [s0] + state[1:])
    for _ in range(half):
        rc = next(rcs)
        state = [b.linear([(1, s)], rc[i]) for i, s in enumerate(state)]
        state = [_sbox(b, s) for s in state]
        state = _matmul(b, _M_EXT, state)
    return state


def hash_chain_circuit(n_hashes: int, seed: int = 1):
    """Returns (acir.Program, witness values dict, final hash value).

    Mirrors poseidon-rounds/src/main.nr: start from an input, apply the
    hash (permutation with capacity IV + feed-forward) n times, expose the
    result.
    """
    b = _CircuitBuilder()
    x = b.new_witness(seed)
    cur = x
    zero_pad = [b.new_witness(0), b.new_witness(1)]
    for w in zero_pad:
        # constrain the pad witnesses to their constants
        b.opcodes.append(acir.AssertZero(acir.Expression(
            linear_combinations=[(1, w)], q_c=F.neg(b.values[w.index]))))
    for _ in range(n_hashes):
        state = _permutation(b, [cur, zero_pad[0], zero_pad[1]])
        cur = state[0]
    out = b.linear([(1, cur)])
    circuit = acir.Circuit(
        opcodes=b.opcodes,
        private_parameters=[x.index],
        return_values=[out.index],
        current_witness_index=b.next_witness)
    program = acir.Program(functions=[circuit])
    return program, dict(b.values), b.values[out.index]
