"""The port's tensor-core Montgomery experiment against the JAX package's.

``mont_mul_mma_plain`` (what the kernel wrapper runs on the CPU) is held,
exactly, to ``mont_mul_mxu_f32`` of ``scripts/mxu_mont_experiment.py``
(imported by path), to ``mont_mul_plain`` and to the field formula; the
band matrices equal the script's.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``); here a host model of its schedule
(``csrc/mont_mul_mma.cu``, its constants read from the source) walks the
persistent grid's tiles and the stage ring, puts the digits into the
wgmma operands' core-matrix layout, spreads each product over the
accumulator registers as wgmma does, stores the column pairs to the
staging tile and runs each thread's carry chain, and is held to
``mont_mul_mma_plain`` on tails and edge values.
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from provekit_tpu_torch import convert
from provekit_tpu_torch.experiments import mxu_mont as M
from provekit_tpu_torch.fields import bn254 as F
from provekit_tpu_torch.fields import vector as V

# The suite runs in parallel workers: the port's small CPU limb ops only
# lose to intra-op threads competing for the same cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "mxu_mont_experiment.py"
KERNEL = ROOT / "provekit_tpu_torch" / "csrc" / "mont_mul_mma.cu"


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("mxu_mont_experiment",
                                                  SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(1)
    a_vals, b_vals = M.random_values(rng, 256), M.random_values(rng, 256)
    # edge values: 0, 1, P - 1 and R against P - 1
    a_vals[:4] = [0, 1, F.P - 1, F.R % F.P]
    b_vals[:4] = [F.P - 1] * 4
    return a_vals, b_vals


def test_band_matrices_match_script(script):
    assert np.array_equal(M.BAND_NP, np.asarray(script.BT_NP_F32))
    assert np.array_equal(M.BAND_P, np.asarray(script.BT_P_F32))


def test_plain_matches_script_and_formula(script, operands):
    a_vals, b_vals = operands
    a, b = V.pack(a_vals, CPU), V.pack(b_vals, CPU)
    got = M.mont_mul_mma_plain(a, b)
    want = script.mont_mul_mxu_f32(jnp.asarray(convert.planes_to_numpy(a)),
                                   jnp.asarray(convert.planes_to_numpy(b)))
    assert np.array_equal(convert.planes_to_numpy(got), np.asarray(want))
    assert torch.equal(got, V.mont_mul_plain(a, b))
    assert M.check(got, a_vals, b_vals)


def test_wrapper_takes_plain_on_cpu(operands):
    a_vals, b_vals = operands
    a, b = V.pack(a_vals, CPU), V.pack(b_vals, CPU)
    before = M.mont_mul_mma.launches
    assert torch.equal(M.mont_mul_mma(a, b), M.mont_mul_mma_plain(a, b))
    assert M.mont_mul_mma.launches == before


def test_experiment_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        M.run(CPU)


# -- a host model of csrc/mont_mul_mma.cu -------------------------------------


def kernel_constant(name: str) -> int:
    found = re.search(rf"constexpr int {name} = (\d+);", KERNEL.read_text())
    return int(found.group(1))


TILE = kernel_constant("kTile")
GROUPS = kernel_constant("kConsumers")
STAGES = kernel_constant("kStages")
ROW = kernel_constant("kRowWords")
H100_SMS = 132
LBO, SBO = 128, 256  # the descriptors' K-half and 8-row strides, bytes
MASK32 = (1 << 32) - 1


def grid_size(n: int, sms: int = H100_SMS) -> int:
    return min(-(-n // TILE), sms)


def producer_tiles(cta: int, grid: int, tiles: int) -> list:
    """(j, tile) in the producer warp's order."""
    return list(enumerate(range(cta, tiles, grid)))


def consumer_tiles(cta: int, group: int, grid: int, tiles: int) -> list:
    """(j, tile) in consumer warpgroup ``group``'s loop."""
    out, j, tile = [], group, cta + group * grid
    while tile < tiles:
        out.append((j, tile))
        tile += GROUPS * grid
        j += GROUPS
    return out


def fill(n: int, tile: int, aligned: bool = True) -> tuple:
    """(TMA boxes?, elements of the tile below n) of a tile's fill; a TMA
    box is TILE x 16 words of one operand, zeros past n."""
    return aligned and n % 4 == 0, min(TILE, n - tile * TILE)


def core_offset(r, k):
    """Byte k of row r of a K-major operand, as the kernel writes it."""
    return (r >> 3) * 256 + (k >> 4) * 128 + (r & 7) * 16 + (k & 15)


def descriptor_rows(smem: np.ndarray, start: int, rows: int) -> np.ndarray:
    """The (rows, 32) byte matrix a no-swizzle K-major descriptor with
    LBO and SBO names at ``start``."""
    r, k = np.meshgrid(np.arange(rows), np.arange(32), indexing="ij")
    return smem[start + (r // 8) * SBO + (k // 16) * LBO + (r % 8) * 16
                + k % 16].astype(np.int64)


def accumulator_map(cols: int) -> tuple:
    """(row, column) of the 64 x cols product held by (warp, lane,
    register) of a warpgroup after wgmma.m64n<cols>k32: two (4, 32,
    cols / 2) arrays."""
    w, lane, r = np.meshgrid(np.arange(4), np.arange(32),
                             np.arange(cols // 2), indexing="ij")
    row = 16 * w + lane // 4 + 8 * ((r // 2) % 2)
    col = 8 * (r // 4) + 2 * (lane % 4) + r % 2
    return row, col


def staging_stores(cols: int, h: int) -> tuple:
    """(word address, register of the pair's low column) of each store a
    thread makes after the product of rows 64h .. 64h + 63: two (4, 32,
    cols / 8, 2) arrays over (warp, lane, i, row g or g + 8); the stored
    value is d[reg] + (d[reg + 1] << 8)."""
    w, lane, i, half = np.meshgrid(np.arange(4), np.arange(32),
                                   np.arange(cols // 8), np.arange(2),
                                   indexing="ij")
    row = 64 * h + 16 * w + lane // 4 + 8 * half
    return row * ROW + 4 * i + lane % 4, 4 * i + 2 * half


def band_smem() -> np.ndarray:
    """The CTA's band matrices in shared memory: BNP at 0, BP at 1024."""
    smem = np.zeros(3072, dtype=np.uint8)
    r, k = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    smem[core_offset(r, k)] = M.BAND_NP
    r, k = np.meshgrid(np.arange(64), np.arange(32), indexing="ij")
    smem[1024 + core_offset(r, k)] = M.BAND_P
    return smem


def band_product(a_smem, bands, b_start, cols) -> np.ndarray:
    """The staging tile (128 x ROW words) after one band product of a
    warpgroup's tile: both wgmma halves, through the registers."""
    staging = np.zeros(TILE * ROW, dtype=np.int64)
    b = descriptor_rows(bands, b_start, cols)
    row, col = accumulator_map(cols)
    for h in range(2):
        d = descriptor_rows(a_smem, 2048 * h, 64) @ b.T
        assert d.max() < 1 << 21
        regs = d[row, col]                       # (4, 32, cols / 2)
        addr, reg = staging_stores(cols, h)
        lo = np.take_along_axis(regs, reg.reshape(4, 32, -1), 2)
        hi = np.take_along_axis(regs, reg.reshape(4, 32, -1) + 1, 2)
        value = (lo + (hi << 8)).reshape(addr.shape)
        assert value.max() < 1 << 30            # fits the staging word
        staging[addr] = value
    return staging


def carry(u, limbs: int, add=None) -> tuple:
    """A thread's carry chain over its row's 16-bit-weight sums: (limbs,
    carry out), each step a 64-bit sum as in the kernel."""
    out, c = [], 0
    for k in range(limbs):
        v = c + (add[k] if add else 0) + int(u[2 * k]) + (int(u[2 * k + 1])
                                                          << 16)
        assert v < 1 << 64
        out.append(v & MASK32)
        c = v >> 32
    return out, c


def model(a: torch.Tensor, b: torch.Tensor, sms: int = H100_SMS):
    """The kernel's output for (16, n) planes, computed along its
    schedule: each CTA's consumer warpgroups, tile by tile."""
    n = a.shape[1]
    x_digits, y_digits = a.numpy().astype(np.int64), b.numpy().astype(np.int64)
    out = np.zeros((16, n), dtype=np.int64)
    bands = band_smem()
    grid, tiles = grid_size(n, sms), -(-n // TILE)
    for cta in range(grid):
        for group in range(GROUPS):
            for j, tile in consumer_tiles(cta, group, grid, tiles):
                _, count = fill(n, tile)
                e0 = tile * TILE
                stage = np.zeros((32, TILE), dtype=np.int64)  # zeros past n
                stage[:16, :count] = x_digits[:, e0:e0 + count]
                stage[16:, :count] = y_digits[:, e0:e0 + count]
                ts = []
                a_smem = np.zeros(2 * 2048, dtype=np.uint8)
                for t in range(TILE):
                    x = sum(int(stage[k, t]) << (16 * k) for k in range(16))
                    y = sum(int(stage[16 + k, t]) << (16 * k)
                            for k in range(16))
                    ts.append(x * y)
                    lo = (x * y) & ((1 << 256) - 1)
                    for k, byte in enumerate(lo.to_bytes(32, "little")):
                        a_smem[2048 * (t >> 6) + core_offset(t & 63, k)] = byte
                staging = band_product(a_smem, bands, 0, 32)
                ms = []
                for t in range(TILE):
                    m, _ = carry(staging[t * ROW:t * ROW + 16], 8)
                    m_int = sum(v << (32 * k) for k, v in enumerate(m))
                    ms.append(m_int)
                    for k, byte in enumerate(m_int.to_bytes(32, "little")):
                        a_smem[2048 * (t >> 6) + core_offset(t & 63, k)] = byte
                staging = band_product(a_smem, bands, 1024, 64)
                for t in range(count):
                    t_limbs = [(ts[t] >> (32 * k)) & MASK32 for k in range(16)]
                    s, top = carry(staging[t * ROW:t * ROW + 32], 16, t_limbs)
                    r = sum(v << (32 * k) for k, v in enumerate(s[8:]))
                    if top or r >= F.P:
                        r = (r - F.P) % (1 << 256)
                    out[:, e0 + t] = [(r >> (16 * k)) & 0xFFFF
                                      for k in range(16)]
    return torch.from_numpy(out.astype(np.int32))


@pytest.mark.parametrize("n", [1, 3, 64, 4096 + 37, 1 << 16])
@pytest.mark.parametrize("sms", [1, 3, H100_SMS])
def test_schedule_covers_every_tile_once(n, sms):
    tiles, grid = -(-n // TILE), grid_size(n, sms)
    seen = []
    for cta in range(grid):
        produced = producer_tiles(cta, grid, tiles)
        consumed = sorted(jt for g in range(GROUPS)
                          for jt in consumer_tiles(cta, g, grid, tiles))
        assert consumed == produced
        for j, tile in produced:
            # a stage serves one warpgroup; its uses alternate parity
            assert (j % STAGES) % GROUPS == j % GROUPS
            tma, count = fill(n, tile)
            assert 0 < count <= TILE
            if tma:   # the tensor map's row stride and box rows: 16 bytes
                assert (4 * n) % 16 == 0 and (4 * TILE) % 16 == 0
                assert tile * TILE < 1 << 31   # a 32-bit box coordinate
            else:
                assert n % 4
        seen += [tile for _, tile in produced]
    assert sorted(seen) == list(range(tiles))
    assert fill(n, tiles - 1)[1] == n - (tiles - 1) * TILE
    assert fill(n, 0, aligned=False)[0] is False


@pytest.mark.parametrize("cols", [32, 64])
def test_accumulator_layout_and_staging_banks(cols):
    row, col = accumulator_map(cols)
    cells = set(zip(row.ravel().tolist(), col.ravel().tolist()))
    assert len(cells) == 64 * cols == row.size
    # an element's columns lie in the four lanes of one quad
    for w in range(4):
        for g in range(8):
            quad = slice(4 * g, 4 * g + 4)
            assert set(row[w, quad].ravel().tolist()) == {16 * w + g,
                                                          16 * w + g + 8}
    for h in range(2):
        addr, reg = staging_stores(cols, h)
        assert len(set(addr.ravel().tolist())) == addr.size
        # one store instruction: the 32 lanes of a warp on 32 banks
        for w in range(4):
            for i in range(cols // 8):
                for half in range(2):
                    assert len(set((addr[w, :, i, half] % 32).tolist())) == 32
                    lanes = np.arange(32)
                    assert np.array_equal(
                        (64 * h + 16 * w + lanes // 4 + 8 * half) * ROW
                        + 4 * i + lanes % 4, addr[w, :, i, half])
    # each thread's 16-byte row loads: 8 threads of a quarter warp on the
    # eight 16-byte bank groups
    for t0 in range(0, TILE, 8):
        for j in range(cols // 8):
            groups = {((t * ROW * 4 + 16 * j) // 16) % 8
                      for t in range(t0, t0 + 8)}
            assert len(groups) == 8
    assert (ROW * 4) % 16 == 0 and ROW >= 32


def test_operand_layout_matches_descriptor():
    bands = band_smem()
    assert np.array_equal(descriptor_rows(bands, 0, 32), M.BAND_NP)
    assert np.array_equal(descriptor_rows(bands, 1024, 64), M.BAND_P)
    rows = np.random.default_rng(3).integers(0, 256, (TILE, 32))
    a_smem = np.zeros(2 * 2048, dtype=np.uint8)
    for t in range(TILE):
        for k in range(32):
            a_smem[2048 * (t >> 6) + core_offset(t & 63, k)] = rows[t, k]
    for h in range(2):
        assert np.array_equal(descriptor_rows(a_smem, 2048 * h, 64),
                              rows[64 * h:64 * h + 64])


@pytest.mark.parametrize("n,sms", [(1, H100_SMS), (3, H100_SMS),
                                   (64, H100_SMS), (4096 + 37, H100_SMS),
                                   (4096 + 37, 3)])
def test_model_matches_plain(n, sms):
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.integers(0, 1 << 16, (16, n)).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 1 << 16, (16, n)).astype(np.int32))
    a[15] %= 0x3064
    b[15] %= 0x3064
    assert torch.equal(model(a, b, sms), M.mont_mul_mma_plain(a, b))


def test_model_on_edge_values():
    a, b = M.edge_operands(CPU)
    got = model(a, b)
    assert torch.equal(got, M.mont_mul_mma_plain(a, b))
    assert torch.equal(got, V.mont_mul_plain(a, b))
