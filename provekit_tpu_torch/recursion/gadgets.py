"""In-circuit Skyscraper hash + duplex sponge (gnark-skyscraper equivalent).

Port of ``provekit_tpu/recursion/gadgets.py``.

The reference verifies its transcripts inside gnark with an external
in-circuit Skyscraper (``recursive-verifier/go.mod:8-10`` gnark-skyscraper,
gnark-nimue).  Here the same gadgets are synthesized through the in-tree
:class:`CircuitBuilder`, mirroring the host implementation bit for bit
(``hash/skyscraper.py``, reference spec
``skyscraper/core/src/reference.rs:49-128``):

* square step: one multiplication (x^2 * SIGMA_INV is a linear scale of x^2);
* bar: canonical 254-bit decomposition (pinned < p), 16-byte rotation as a
  free wire shuffle, bitwise S-box (3 multiplications per bit);
* duplex sponge: same absorb/squeeze state machine as fs/sponge.py, with LC
  state elements.
"""

from __future__ import annotations

from ..fields import bn254 as F
from ..hash.skyscraper import BAR_STEPS, ROUND_CONSTANTS, SIGMA_INV
from .builder import LC, ONE, CircuitBuilder

NBITS = 254  # p < 2^254: canonical values fit in 254 bits


def sbox_bits(b: CircuitBuilder, v: list) -> list:
    """8-bit S-box on one byte of boolean wires, LSB first.

    y = rotl1(v ^ (rotl1(~v) & rotl2(v) & rotl3(v)))  (bar.rs:39-41), where
    rotl shifts towards the MSB: rotl(v,k)[j] = v[(j-k) % 8].
    """
    assert len(v) == 8
    t = []
    for j in range(8):
        u = b.mul(ONE - v[(j - 1) % 8], v[(j - 2) % 8])
        w = b.mul(u, v[(j - 3) % 8])
        t.append(b.xor(v[j], w))
    return [t[(j - 1) % 8] for j in range(8)]


def bar(b: CircuitBuilder, x: LC) -> LC:
    """bar: rotate the canonical little-endian bytes by 16, S-box each byte.

    The output is the recomposed integer reduced mod p — in-circuit the
    recomposition LC *is* that reduction (field arithmetic), so no second
    decomposition is needed.

    With lookups enabled on the builder (``b.lookups``, recursion/lookup.py)
    the byte decomposition + S-box run through the 8-bit logUp table
    (~115 constraints/bar) instead of boolean decomposition (~1,270):
    the route the reference's gnark-skyscraper takes.
    """
    lk = getattr(b, "lookups", None)
    if lk is not None:
        return _bar_lookup(b, lk, x)
    bits = b.to_bits(x, NBITS, assert_canonical=True)
    bits = bits + [b.constant(0)] * (256 - NBITS)
    out = LC()
    for byte_i in range(32):
        src = (byte_i + 16) % 32
        sbits = sbox_bits(b, bits[src * 8:(src + 1) * 8])
        for k, bit in enumerate(sbits):
            out = out + bit.scale(1 << (8 * byte_i + k))
    # collapse the 256-term recomposition to one wire so downstream rows
    # referencing the bar output stay sparse
    out_w = b.alloc(b.value(out))
    b.assert_eq(out, out_w)
    return out_w


def _bar_lookup(b: CircuitBuilder, lk, x: LC) -> LC:
    """Lookup-table bar: 32 S-box byte lookups + 16-limb canonicality.

    The canonical byte decomposition is pinned by (a) each byte's range via
    its S-box lookup row, (b) the recomposition equality, and (c) a
    borrow-chain comparison of the 16-bit limbs against p-1
    (lookup.py::assert_limbs_le_constant — exact over the integers).
    """
    xv = b.value(x)
    assert xv < F.P
    ins, outs = [], []
    for i in range(32):
        in_lc, out_lc = lk.sbox_byte((xv >> (8 * i)) & 0xFF)
        ins.append(in_lc)
        outs.append(out_lc)
    acc = LC()
    for i, lc in enumerate(ins):
        acc = acc + lc.scale(1 << (8 * i))
    b.assert_eq(acc, x)
    limbs = [ins[2 * j] + ins[2 * j + 1].scale(256) for j in range(16)]
    lk.assert_limbs_le_constant(limbs, F.P - 1)
    out = LC()
    for i in range(32):
        out = out + outs[(i + 16) % 32].scale(1 << (8 * i))
    out_w = b.alloc(b.value(out))
    b.assert_eq(out, out_w)
    return out_w


def square_sigma(b: CircuitBuilder, x: LC) -> LC:
    """x^2 * SIGMA_INV (one Montgomery square of the canonical value)."""
    return b.square(x).scale(SIGMA_INV)


def permute(b: CircuitBuilder, l: LC, r: LC) -> tuple:
    """18-step Skyscraper2 permutation ladder (generic.rs:77-102)."""
    for k in range(18):
        f = bar(b, l) if k in BAR_STEPS else square_sigma(b, l)
        l, r = r + f + b.constant(ROUND_CONSTANTS[k]), l
    return l, r


def compress(b: CircuitBuilder, l: LC, r: LC) -> LC:
    """2-to-1 compression: permute(l, r).left + l (reference.rs:41-46)."""
    out, _ = permute(b, l, r)
    return out + l


class SpongeGadget:
    """Duplex sponge replay with LC state (fs/sponge.py semantics, N=2 R=1)."""

    def __init__(self, b: CircuitBuilder, iv: bytes):
        assert len(iv) == 32
        self.b = b
        self.state = [b.constant(0),
                      b.constant(int.from_bytes(iv, "little") % F.P)]
        self.absorb_pos = 0
        self.squeeze_pos = 1  # RATE

    def _permute(self) -> None:
        l, r = permute(self.b, self.state[0], self.state[1])
        self.state = [l, r]

    def absorb(self, units: list) -> None:
        for u in units:
            if self.absorb_pos == 1:
                self._permute()
                self.absorb_pos = 0
            self.state[self.absorb_pos] = u
            self.absorb_pos += 1
        self.squeeze_pos = 1

    def squeeze(self, n: int) -> list:
        out = []
        for _ in range(n):
            if self.squeeze_pos == 1:
                self._permute()
                self.squeeze_pos = 0
                self.absorb_pos = 0
            out.append(self.state[self.squeeze_pos])
            self.squeeze_pos += 1
        return out


class TranscriptGadget:
    """In-circuit deterministic transcript replay (VerifierState equivalent).

    The proof's absorbed scalars arrive as circuit variables (public inputs
    of the recursion circuit, mirroring gnark's ``Transcript`` public input,
    circuit.go:24-41); challenges are squeezed from the in-circuit sponge so
    every Fiat-Shamir draw is constrained.  Hints are NOT part of the scalar
    stream — the caller supplies them as private witnesses.
    """

    def __init__(self, b: CircuitBuilder, domsep, scalars: list,
                 hints: list[bytes]):
        self.b = b
        self.sponge = SpongeGadget(b, domsep.iv())
        self.scalars = scalars
        self.pos = 0
        self.hints = hints
        self.hint_pos = 0

    def next_scalars(self, n: int) -> list:
        out = self.scalars[self.pos:self.pos + n]
        assert len(out) == n, "transcript scalar stream exhausted"
        self.pos += n
        self.sponge.absorb(out)
        return out

    def challenge_scalars(self, n: int) -> list:
        return self.sponge.squeeze(n)

    def hint_bytes(self) -> bytes:
        out = self.hints[self.hint_pos]
        self.hint_pos += 1
        return out

    def finish(self) -> None:
        assert self.pos == len(self.scalars), "unread transcript scalars"
        assert self.hint_pos == len(self.hints), "unread hints"


def split_transcript(domsep, proof: bytes) -> tuple[list[int], list[bytes]]:
    """Split a NARG proof string into (absorbed scalars, hint blobs).

    Walks the declared IO pattern exactly like VerifierState but without a
    sponge — the recursion wrapper uses this to lay the proof out as circuit
    inputs.
    """
    scalars: list[int] = []
    hints: list[bytes] = []
    pos = 0
    for op in domsep.ops:
        if op.kind == "A" and op.label == "pow-nonce":
            # spongefish-pow framing: 8 wire bytes (big-endian u64), one
            # sponge unit (common.go:93-96 size-bytes branch)
            scalars.append(int.from_bytes(proof[pos:pos + 8], "big"))
            pos += 8
        elif op.kind == "A":
            for _ in range(op.count):
                v = int.from_bytes(proof[pos:pos + 32], "little")
                if v >= F.P:
                    raise ValueError("non-canonical scalar in transcript")
                scalars.append(v)
                pos += 32
        elif op.kind == "H":
            n = int.from_bytes(proof[pos:pos + 4], "little")
            pos += 4
            hints.append(proof[pos:pos + n])
            pos += n
    if pos != len(proof):
        raise ValueError("trailing transcript bytes")
    return scalars, hints
