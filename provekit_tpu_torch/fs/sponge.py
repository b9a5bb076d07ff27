"""Duplex sponge over the Skyscraper permutation (spongefish-equivalent).

The reference wires ``skyscraper::reference::permute`` into spongefish's
``DuplexSponge`` with field-element units, state width N=2, rate R=1
(``provekit/common/src/skyscraper/sponge.rs:42-60``).  The Fiat-Shamir sponge
is inherently sequential and tiny; this host version (Python ints, each
permutation in the port's native library, ``native.permute``) serves the
verifier and the Python witness solve, while the prover advances the same
sponge on the device (``fs.device``).  ``hash.skyscraper.permute`` is the
permutation's plain version.

Duplex semantics (spongefish ``DuplexSponge``):
* ``new(iv)``: state = [0, iv mod p]  (rate element is index 0)
* absorb: write units into the rate portion, permuting when full; any absorb
  resets ``squeeze_pos`` so the next squeeze permutes first.
* squeeze: permute when the rate is exhausted, then read rate units.
"""

from __future__ import annotations

from .. import native
from ..fields import bn254 as F

RATE = 1
WIDTH = 2


class SkyscraperSponge:
    __slots__ = ("state", "absorb_pos", "squeeze_pos")

    def __init__(self, iv: bytes):
        assert len(iv) == 32
        self.state = [0, int.from_bytes(iv, "little") % F.P]
        self.absorb_pos = 0
        self.squeeze_pos = RATE

    def _permute(self) -> None:
        self.state = list(native.permute(self.state[0], self.state[1]))

    def absorb(self, units) -> None:
        for u in units:
            if self.absorb_pos == RATE:
                self._permute()
                self.absorb_pos = 0
            self.state[self.absorb_pos] = u % F.P
            self.absorb_pos += 1
        self.squeeze_pos = RATE

    def squeeze(self, n: int) -> list[int]:
        out = []
        for _ in range(n):
            if self.squeeze_pos == RATE:
                self._permute()
                self.squeeze_pos = 0
                self.absorb_pos = 0
            out.append(self.state[self.squeeze_pos])
            self.squeeze_pos += 1
        return out
