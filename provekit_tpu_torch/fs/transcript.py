"""Fiat-Shamir transcript engine (spongefish-equivalent).

Three pieces, mirroring the reference's usage surface
(``provekit/common/src/whir_r1cs.rs:15`` ``IOPattern``,
``spongefish::{ProverState, VerifierState}``):

* :class:`DomainSeparator` — declarative IO pattern (absorb/squeeze/hint ops
  with labels).  Its byte serialization seeds the sponge IV, binding the
  whole protocol shape into the transcript (``create_io_pattern``,
  ``common/src/whir_r1cs.rs:28-39`` is built on top of this).
* :class:`ProverState` — absorbs prover scalars into the sponge while
  appending their canonical 32-byte little-endian encoding to the NARG
  string; squeezes verifier challenges; records hints (serialized but NOT
  absorbed).
* :class:`VerifierState` — deterministic replay: reads scalars from the NARG
  string and absorbs them, re-derives identical challenges.

The proof is the NARG byte string alone (``NoirProof.whir_r1cs_proof``,
``common/src/noir_proof_scheme.rs:26-28``).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..fields import bn254 as F
from .sponge import SkyscraperSponge

SCALAR_BYTES = 32
SEP = b"\x00"


@dataclass(frozen=True)
class Op:
    kind: str  # "A" absorb (prover->verifier), "S" squeeze (challenge), "H" hint
    count: int
    label: str


class DomainSeparator:
    """IO-pattern builder; order of ops is normative for the transcript."""

    def __init__(self, protocol_label: str):
        self.protocol_label = protocol_label
        self.ops: list[Op] = []

    def absorb(self, count: int, label: str) -> "DomainSeparator":
        assert count > 0
        self.ops.append(Op("A", count, label))
        return self

    def squeeze(self, count: int, label: str) -> "DomainSeparator":
        assert count > 0
        self.ops.append(Op("S", count, label))
        return self

    def hint(self, label: str) -> "DomainSeparator":
        self.ops.append(Op("H", 0, label))
        return self

    def as_bytes(self) -> bytes:
        parts = [self.protocol_label.encode()]
        for op in self.ops:
            if op.kind == "H":
                parts.append(f"H{op.label}".encode())
            else:
                parts.append(f"{op.kind}{op.count}{op.label}".encode())
        return SEP.join(parts)

    def iv(self) -> bytes:
        return hashlib.sha3_256(self.as_bytes()).digest()

    def to_prover_state(self) -> "ProverState":
        return ProverState(self)

    def to_verifier_state(self, transcript: bytes) -> "VerifierState":
        return VerifierState(self, transcript)


class _OpChecker:
    """Validates the runtime op sequence against the declared pattern."""

    def __init__(self, ops: list[Op]):
        self.ops = ops
        self.idx = 0

    def expect(self, kind: str, count: int) -> None:
        if self.idx >= len(self.ops):
            raise ValueError(f"transcript op overflow: {kind}{count}")
        op = self.ops[self.idx]
        if op.kind != kind or (kind != "H" and op.count != count):
            raise ValueError(
                f"transcript op mismatch at {self.idx}: declared "
                f"{op.kind}{op.count}:{op.label!r}, executed {kind}{count}")
        self.idx += 1

    def finish(self) -> None:
        if self.idx != len(self.ops):
            op = self.ops[self.idx]
            raise ValueError(
                f"transcript incomplete: next declared op {op.kind}{op.count}:{op.label!r}")


class ProverState:
    def __init__(self, domsep: DomainSeparator):
        self.sponge = SkyscraperSponge(domsep.iv())
        self.narg = bytearray()
        self.checker = _OpChecker(domsep.ops)

    def add_scalars(self, values: list[int]) -> None:
        self.checker.expect("A", len(values))
        for v in values:
            v %= F.P
            self.narg += F.to_bytes_le(v)
        self.sponge.absorb([v % F.P for v in values])

    def challenge_scalars(self, n: int) -> list[int]:
        self.checker.expect("S", n)
        return self.sponge.squeeze(n)

    def add_pow_nonce(self, nonce: int) -> None:
        """Absorb a grinding nonce: 8 bytes big-endian on the wire
        (spongefish-pow framing, verified against the reference's own
        poseidon-1000.np transcript; the Go parse takes the size-bytes
        branch for the ``pow-nonce`` label, common.go:93-96), one field
        unit (the nonce value) into the sponge."""
        self.checker.expect("A", 8)
        assert 0 <= nonce < 1 << 64
        self.narg += nonce.to_bytes(8, "big")
        self.sponge.absorb([nonce])

    def hint_bytes(self, data: bytes) -> None:
        self.checker.expect("H", 0)
        self.narg += len(data).to_bytes(4, "little")
        self.narg += data

    def narg_string(self) -> bytes:
        self.checker.finish()
        return bytes(self.narg)

    def sponge_state_array(self, device):
        """Current sponge state as a (16, 2) canonical tensor on ``device``.

        Only valid right after a squeeze (absorb_pos == 0), which is where
        every device sumcheck round starts; the device sponge continues the
        duplex pattern from here (see ops/fused.py).
        """
        assert self.sponge.absorb_pos == 0 and self.sponge.squeeze_pos == 1, (
            self.sponge.absorb_pos, self.sponge.squeeze_pos)
        from ..fields import vector as V
        return V.pack(self.sponge.state, device).reshape(16, 2)


class VerifierState:
    def __init__(self, domsep: DomainSeparator, transcript: bytes):
        self.sponge = SkyscraperSponge(domsep.iv())
        self.transcript = transcript
        self.pos = 0
        self.checker = _OpChecker(domsep.ops)

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.transcript):
            raise ValueError("transcript too short")
        out = self.transcript[self.pos:self.pos + n]
        self.pos += n
        return out

    def next_scalars(self, n: int) -> list[int]:
        self.checker.expect("A", n)
        vals = []
        for _ in range(n):
            v = int.from_bytes(self._take(SCALAR_BYTES), "little")
            if v >= F.P:
                raise ValueError("non-canonical scalar in transcript")
            vals.append(v)
        self.sponge.absorb(vals)
        return vals

    def challenge_scalars(self, n: int) -> list[int]:
        self.checker.expect("S", n)
        return self.sponge.squeeze(n)

    def next_pow_nonce(self) -> int:
        """Read an 8-byte big-endian grinding nonce (< 2^64 by width)."""
        self.checker.expect("A", 8)
        nonce = int.from_bytes(self._take(8), "big")
        self.sponge.absorb([nonce])
        return nonce

    def hint_bytes(self) -> bytes:
        self.checker.expect("H", 0)
        n = int.from_bytes(self._take(4), "little")
        return bytes(self._take(n))

    def finish(self) -> None:
        self.checker.finish()
        if self.pos != len(self.transcript):
            raise ValueError(f"{len(self.transcript) - self.pos} trailing transcript bytes")
