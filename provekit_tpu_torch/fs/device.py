"""Device-resident Fiat-Shamir: sponge, transcript buffers, scalar algebra.

Port of ``provekit_tpu/fs/device.py``.  The prover keeps its whole
transcript on the device: the duplex sponge state (16, 2) advances through
the ``duplex_v`` kernel, one launch per absorb or squeeze; absorbed scalars
and hint payloads are recorded as device tensors, and ``narg_string()``
fetches them in ONE device-to-host copy and assembles exactly the bytes
of the host ``ProverState``.  The verifier replays the transcript with the
host sponge.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import bn254 as F
from ..fields import vector as V
from ..hash import skyscraper as S
from .transcript import DomainSeparator, _OpChecker


# ---------------------------------------------------------------------------
# device scalar algebra ((16, k) int32 planes)


def to_mont(a: torch.Tensor) -> torch.Tensor:
    return V.to_mont(a)


def from_mont(a: torch.Tensor) -> torch.Tensor:
    return V.from_mont(a)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product, broadcasting (16,1) against (16,k)."""
    return V.mont_mul(a, b)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return V.add_mod(a, b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return V.sub_mod(a, b)


def one_m(device, k: int = 1) -> torch.Tensor:
    """(16, k) Montgomery ones."""
    return V.const(F.to_mont(1), device, k)


def const_m(x: int, device, k: int = 1) -> torch.Tensor:
    return V.const(F.to_mont(x % F.P), device, k)


def powers(g_m: torch.Tensor, k: int) -> torch.Tensor:
    """[1, g, g^2, ..., g^(k-1)] as (16, k) Montgomery (log-doubling)."""
    out = one_m(g_m.device)
    g_pow = g_m  # g^(2^s)
    while out.shape[1] < k:
        out = torch.cat([out, mul(out, g_pow)], dim=1)
        g_pow = mul(g_pow, g_pow)
    return out[:, :k]


def univ_to_ml(z_m: torch.Tensor, m: int) -> torch.Tensor:
    """(16, p) Montgomery points -> (16, m, p) MSB-first multilinear coords:
    coords[k] = z^(2^(m-1-k))."""
    rows = [None] * m
    acc = z_m
    for k in range(m - 1, -1, -1):
        rows[k] = acc
        acc = mul(acc, acc)
    if m == 0:
        return z_m.new_zeros((16, 0, z_m.shape[1]))
    return torch.stack(rows, dim=1)


def eq_table_dev(r_m: torch.Tensor, m: int) -> torch.Tensor:
    """eq(r, x) over the hypercube from device Montgomery coords (16, m)."""
    from ..ops.sumcheck import eq_table_m
    assert r_m.shape[1] == m
    return eq_table_m(r_m)


def pow_base(base: int, exps: torch.Tensor, log_bits: int) -> torch.Tensor:
    """base^exps as (16, q) Montgomery scalars for (q,) int64 exponents
    below 2^log_bits (square-and-multiply over the bit width)."""
    q = exps.shape[0]
    acc = one_m(exps.device, q)
    for b in range(log_bits):
        c = const_m(pow(base, 1 << b, F.P), exps.device)
        bit = ((exps >> b) & 1).bool()
        acc = torch.where(bit[None, :], mul(acc, c), acc)
    return acc


def scalar_index_u32(canon: torch.Tensor, mask: int) -> torch.Tensor:
    """Low bits of (16, q) canonical scalars as a (q,) int64 vector.

    ``mask + 1`` must be a power of two <= 2^32 (s % 2^k == low bits)."""
    c = canon.to(torch.int64)
    return (c[0] | (c[1] << 16)) & mask


# ---------------------------------------------------------------------------
# packing helpers for the single final fetch


def _flatten_u32(arr: torch.Tensor):
    """Any integer tensor -> ((16, w) int32 block, restore-metadata).

    Digit planes (int32) restore as numpy uint32, index vectors (int64,
    values below 2^32) as int64."""
    dtype = "uint32" if arr.dtype == torch.int32 else "int64"
    flat = arr.reshape(-1)
    if flat.dtype != torch.int32:
        flat = (flat & 0xFFFFFFFF).to(torch.int32)
    pad = (-flat.shape[0]) % 16
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(16, -1), (tuple(arr.shape), dtype, pad)


def _restore(block: np.ndarray, meta):
    shape, dtype, pad = meta
    flat = block.reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.astype(dtype).reshape(shape)


class DeviceProverState:
    """Prover transcript with a device-resident sponge and buffers.

    Scalars enter and leave as (16, k) canonical device tensors; nothing is
    fetched until ``narg_string()``.
    """

    def __init__(self, domsep: DomainSeparator, device):
        self.device = torch.device(device)
        iv_int = int.from_bytes(domsep.iv(), "little") % F.P
        self.state = V.pack([0, iv_int], self.device).reshape(16, 2)
        self.absorb_pos = 0
        self.checker = _OpChecker(domsep.ops)
        # ("A", chunk) | ("P", nonce) | ("H", builder, [(block, meta)...])
        # | ("HB", bytes)
        self._order: list = []

    # -- core ops ------------------------------------------------------------

    def add_scalars_dev(self, arr: torch.Tensor) -> None:
        """Absorb (16, k) CANONICAL device scalars."""
        k = arr.shape[1]
        self.checker.expect("A", k)
        self.state = S.duplex_v(self.state, arr, self.absorb_pos, 0)[0]
        self.absorb_pos = 1
        self._order.append(("A", arr))

    def add_scalars(self, values: list[int]) -> None:
        self.add_scalars_dev(V.pack([v % F.P for v in values], self.device))

    def challenge_scalars_dev(self, n: int) -> torch.Tensor:
        """Squeeze n challenges as (16, n) canonical device scalars."""
        self.checker.expect("S", n)
        self.state, out = S.duplex_v(self.state, None, 0, n)
        self.absorb_pos = 0
        return out

    def add_pow_nonce_dev(self, arr: torch.Tensor) -> None:
        """Absorb a grinding nonce held as a (16, 1) canonical device
        scalar; the wire carries 8 big-endian bytes (spongefish-pow
        framing), the sponge one unit (the nonce value)."""
        self.checker.expect("A", 8)
        self.state = S.duplex_v(self.state, arr, self.absorb_pos, 0)[0]
        self.absorb_pos = 1
        self._order.append(("P", arr))

    def hint_arrays(self, builder, arrays: list) -> None:
        """Deferred hint: ``builder(*numpy_arrays) -> bytes`` at finalize."""
        self.checker.expect("H", 0)
        self._order.append(("H", builder, [_flatten_u32(a) for a in arrays]))

    def hint_bytes(self, data: bytes) -> None:
        self.checker.expect("H", 0)
        self._order.append(("HB", data))

    def replay_fused(self, new_state: torch.Tensor, absorbed_chunks: list,
                     pattern: list) -> None:
        """Adopt the result of a device round that advanced the sponge.
        ``pattern`` is its op list [("A", k) | ("S", n)]; ``absorbed_chunks``
        are its absorbed (16, k) canonical tensors in order.  Rounds must
        end right after a squeeze."""
        ai = 0
        for kind, cnt in pattern:
            self.checker.expect(kind, cnt)
            if kind == "A":
                self._order.append(("A", absorbed_chunks[ai]))
                ai += 1
        assert ai == len(absorbed_chunks)
        assert pattern[-1][0] == "S", "device rounds must end on a squeeze"
        self.state = new_state
        self.absorb_pos = 0

    # -- finalize ------------------------------------------------------------

    def narg_string(self) -> bytes:
        self.checker.finish()
        blocks = []
        for entry in self._order:
            if entry[0] in ("A", "P"):
                blocks.append(entry[1])
            elif entry[0] == "H":
                blocks.extend(b for b, _ in entry[2])
        widths = [b.shape[1] for b in blocks]
        fetched = (V.to_numpy_u32(torch.cat(blocks, dim=1)) if blocks
                   else np.zeros((16, 0), dtype=np.uint32))
        offs = np.cumsum([0] + widths)
        bi = 0

        def next_block():
            nonlocal bi
            out = fetched[:, offs[bi]:offs[bi + 1]]
            bi += 1
            return out

        narg = bytearray()
        for entry in self._order:
            if entry[0] == "A":
                narg += V.to_bytes_le_block(next_block(),
                                            check_canonical=True)
            elif entry[0] == "P":
                block = next_block()
                nonce = 0
                for l in range(16):
                    nonce |= int(block[l, 0]) << (16 * l)
                assert 0 <= nonce < 1 << 64, "pow nonce exceeds u64"
                narg += nonce.to_bytes(8, "big")
            elif entry[0] == "HB":
                narg += len(entry[1]).to_bytes(4, "little")
                narg += entry[1]
            else:
                _, builder, metas = entry
                args = [_restore(next_block(), meta) for _, meta in metas]
                data = builder(*args)
                narg += len(data).to_bytes(4, "little")
                narg += data
        return bytes(narg)
