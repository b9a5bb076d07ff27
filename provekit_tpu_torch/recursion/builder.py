"""R1CS constraint-synthesis frontend (gnark-frontend equivalent).

Port of ``provekit_tpu/recursion/builder.py``.

The reference expresses its recursive verifier as a gnark circuit
(``recursive-verifier/app/circuit/circuit.go:19-82``) whose ``Define``
method synthesizes constraints through gnark's frontend API.  This module
is the same layer for the in-tree stack: circuit code manipulates
:class:`LC` values (linear combinations over witness wires — linear
algebra is free, each multiplication is one R1CS row) and the builder
emits a :class:`provekit_tpu_torch.r1cs.R1CS` plus the full witness assignment.

Wire 0 is the constant-1 wire; public-input wires must be allocated
before any private wire (Groth16 statement layout, recursion/groth16.py).
"""

from __future__ import annotations

from ..fields import bn254 as F

P = F.P


class LC:
    """Immutable linear combination sum(coeff * wire) + const over Fr."""

    __slots__ = ("terms", "const")

    def __init__(self, terms=None, const: int = 0):
        self.terms = terms or {}
        self.const = const % P

    # -- algebra (free: no constraints) -------------------------------------

    def __add__(self, other) -> "LC":
        if isinstance(other, int):
            return LC(self.terms, self.const + other)
        t = dict(self.terms)
        for w, c in other.terms.items():
            nc = (t.get(w, 0) + c) % P
            if nc:
                t[w] = nc
            else:
                t.pop(w, None)
        return LC(t, self.const + other.const)

    __radd__ = __add__

    def __sub__(self, other) -> "LC":
        if isinstance(other, int):
            return LC(self.terms, self.const - other)
        return self + other.scale(P - 1)

    def __rsub__(self, other) -> "LC":
        return self.scale(P - 1) + other

    def scale(self, k: int) -> "LC":
        k %= P
        if k == 0:
            return LC()
        if k == 1:
            return self
        return LC({w: c * k % P for w, c in self.terms.items()},
                  self.const * k)

    def __mul__(self, k: int) -> "LC":
        assert isinstance(k, int)
        return self.scale(k)

    __rmul__ = __mul__

    def is_constant(self) -> bool:
        return not self.terms

    def as_terms(self) -> list:
        """[(coeff, wire)] list including the constant on wire 0."""
        out = [(c, w) for w, c in self.terms.items()]
        if self.const:
            out.append((self.const, 0))
        return out


ZERO = LC()
ONE = LC(const=1)


class CircuitBuilder:
    """Accumulates R1CS constraints and the witness assignment together."""

    def __init__(self, debug_assert: bool = False):
        self.values: list[int] = [1]  # wire 0 == 1
        self.constraints: list = []   # (a_terms, b_terms, c_terms) LC-terms
        self.num_public = 0
        self._private_started = False
        # debug_assert: evaluate every enforce() on the host assignment at
        # synthesis time and raise on the first violated row — pinpoints a
        # failing gadget without solving the full system
        self.debug_assert = debug_assert

    # -- wires ---------------------------------------------------------------

    def public_input(self, value: int) -> LC:
        assert not self._private_started, \
            "public inputs must be allocated before private wires"
        w = len(self.values)
        self.values.append(value % P)
        self.num_public += 1
        return LC({w: 1})

    def alloc(self, value: int) -> LC:
        self._private_started = True
        w = len(self.values)
        self.values.append(value % P)
        return LC({w: 1})

    def constant(self, c: int) -> LC:
        return LC(const=c)

    # -- evaluation ------------------------------------------------------------

    def value(self, lc: LC) -> int:
        acc = lc.const
        for w, c in lc.terms.items():
            acc += c * self.values[w]
        return acc % P

    # -- constraints -----------------------------------------------------------

    def enforce(self, a: LC, b: LC, c: LC) -> None:
        """Add the row  <a, z> * <b, z> == <c, z>."""
        if self.debug_assert:
            av, bv, cv = self.value(a), self.value(b), self.value(c)
            if av * bv % P != cv:
                raise AssertionError(
                    f"constraint {len(self.constraints)} violated: "
                    f"{av} * {bv} != {cv}")
        self.constraints.append((a.as_terms(), b.as_terms(), c.as_terms()))

    def assert_zero(self, lc: LC) -> None:
        if lc.is_constant():
            assert lc.const == 0, "constant-false constraint"
            return
        self.enforce(lc, ONE, ZERO)

    def assert_eq(self, x: LC, y: LC) -> None:
        self.assert_zero(x - y)

    def assert_mul(self, x: LC, y: LC, z: LC) -> None:
        self.enforce(x, y, z)

    def assert_bool(self, x: LC) -> None:
        self.enforce(x, x - 1, ZERO)

    # -- derived ops (allocate + constrain) -------------------------------------

    def mul(self, x: LC, y: LC) -> LC:
        if x.is_constant():
            return y.scale(x.const)
        if y.is_constant():
            return x.scale(y.const)
        out = self.alloc(self.value(x) * self.value(y))
        self.enforce(x, y, out)
        return out

    def square(self, x: LC) -> LC:
        return self.mul(x, x)

    def inverse(self, x: LC) -> LC:
        """1/x; unsatisfiable when x == 0."""
        xv = self.value(x)
        out = self.alloc(pow(xv, P - 2, P) if xv else 0)
        self.enforce(x, out, ONE)
        return out

    def div(self, x: LC, y: LC) -> LC:
        return self.mul(x, self.inverse(y))

    def select(self, bit: LC, x: LC, y: LC) -> LC:
        """bit ? x : y  (bit must already be boolean-constrained)."""
        return y + self.mul(bit, x - y)

    def xor(self, x: LC, y: LC) -> LC:
        """Boolean XOR: x + y - 2xy."""
        return x + y - self.mul(x, y).scale(2)

    def and_(self, x: LC, y: LC) -> LC:
        return self.mul(x, y)

    def not_(self, x: LC) -> LC:
        return ONE - x

    # -- bit decomposition -------------------------------------------------------

    def to_bits(self, x: LC, n: int, assert_canonical: bool = False) -> list:
        """Decompose x into n boolean wires, LSB first.

        Enforces x == sum(b_i 2^i).  With ``assert_canonical`` the integer
        value of the bits is additionally constrained < p, pinning the
        decomposition of a field element to its canonical representative
        (needed whenever bits feed byte-level logic, e.g. the bar gadget).
        Without it, n < 254 alone bounds the value below 2^n.
        """
        xv = self.value(x)
        assert xv < (1 << n) or assert_canonical, (xv, n)
        bits = []
        for i in range(n):
            b = self.alloc((xv >> i) & 1)
            self.assert_bool(b)
            bits.append(b)
        acc = LC()
        for i, b in enumerate(bits):
            acc = acc + b.scale(1 << i)
        self.assert_eq(acc, x)
        if assert_canonical:
            self.assert_bits_le_constant(bits, P - 1)
        return bits

    def assert_bits_le_constant(self, bits: list, c: int) -> None:
        """Enforce int(bits) <= c for a compile-time constant c.

        MSB-to-LSB scan keeping an "equal so far" flag: where c's bit is 1
        the flag absorbs the value bit; where it is 0 the value bit must be
        0 while the flag is set.  One constraint per bit.
        """
        assert c >= 0
        eq = ONE
        for i in reversed(range(len(bits))):
            if (c >> i) & 1:
                eq = self.mul(eq, bits[i])
            else:
                self.enforce(eq, bits[i], ZERO)

    def from_bits(self, bits: list) -> LC:
        acc = LC()
        for i, b in enumerate(bits):
            acc = acc + b.scale(1 << i)
        return acc

    # -- emission -----------------------------------------------------------------

    def build(self):
        """Emit (R1CS, witness values).  The R1CS layout matches the in-tree
        convention (wire 0 constant; publics first), directly consumable by
        recursion/groth16.py and protocol/scheme.py."""
        from ..r1cs import R1CS
        r1cs = R1CS()
        r1cs.num_public_inputs = self.num_public
        r1cs.new_witnesses(len(self.values) - 1)
        for a, b, c in self.constraints:
            r1cs.add_constraint(a, b, c)
        return r1cs, list(self.values)

    @property
    def num_constraints(self) -> int:
        return len(self.constraints)

    @property
    def num_wires(self) -> int:
        return len(self.values)
