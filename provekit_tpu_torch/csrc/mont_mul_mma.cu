// Batched BN254-Fr Montgomery product with the two constant-operand digit
// convolutions on the tensor cores (Hopper: TMA, mbarriers, wgmma).
//
// Replaces the TPU kernel scripts/mxu_mont_experiment.py:mont_mul_mxu_pallas
// (body _mont_mul_mxu_kernel, variant D of docs/MXU_MONT.md): the same
// function as mont_mul.cu, a * b * 2^-256 mod P, computed as
//   T = a * b                          (512 bits, on the CUDA cores)
//   m = T_lo * N' mod 2^256            (N' = -P^-1 mod 2^256)
//   r = (T + m * P) >> 256, minus P once if r >= P.
// A digit convolution with a constant is a product with a band matrix
// B[k][i] = digit_{k-i}(c), so over 8-bit digits the two constant products
// are exact integer matrix products: m's 32 columns = the 32 digits of T_lo
// times BNP^T (32 x 32), and m * P's 64 columns = the 32 digits of m times
// BP^T (32 x 64).  Each column sum is below 32 * 255^2 < 2^21.
//
// What bounds it on the H100: memory, as for mont_mul.cu (2 x 64 bytes in,
// 64 bytes out per element).  The tensor-core work is (32 + 64) x 32 u8
// multiply-adds per element, 12.9 G operations at 2^21 elements: 6.5 us at
// the card's 1,979 TOP/s for int8.  So the design is about keeping enough
// bytes in flight:
//
// * A persistent grid: one CTA per SM walks tiles of kTile elements
//   (tile = blockIdx.x + j * gridDim.x).  The band matrices go to shared
//   memory once per CTA.
// * A producer warp fills a ring of kStages stages in shared memory, each
//   one tile of the 16 digit planes of a and of b, with one TMA copy of a
//   (kTile x 16)-word box of each operand (cp.async.bulk.tensor.2d over
//   the (16, n) planes; the box past n is filled with zeros) completing on
//   the stage's "full" mbarrier.  A tensor map needs a row stride and a
//   base aligned to 16 bytes: when n % 4 != 0 or an operand is not
//   16-byte aligned, the same warp fills every stage with plain coalesced
//   loads instead (and arrives on the same barrier), so the consumers never
//   see the difference.  One stage a warpgroup: the producer refills a
//   stage while its warpgroup computes on the digits it took from it.
//   (One 1-D cp.async.bulk per 512-byte plane segment, 32 a tile, kept the
//   producer issuing 96 % of its time on the H100: TMA takes few large
//   copies.)
// * kConsumers consumer warpgroups take the tiles in turn (tile j goes to
//   warpgroup j % kConsumers, stage j % kStages).  Thread t of a warpgroup
//   owns element t of its tile: it reads its digits from the stage,
//   releases the stage ("empty" mbarrier), computes T = a * b, and writes
//   T_lo's 32 bytes as row t of the A operand (128 x 32 bytes).  Lanes past
//   n work on zeros.
// * Band products on wgmma.m64nNk32.s32.u8.u8, elements on M: two
//   instructions (rows 0-63, 64-127) per product, N = 32 for N' and 64 for
//   P; A (the digits) and B (the band matrix) both K-major in shared memory
//   with no swizzle: 8-row x 16-byte core matrices, LBO 128 bytes (the two
//   K halves), SBO 256 bytes (the next 8 rows).
// * Carry chains from a staging tile.  wgmma leaves an element's columns in
//   the four lanes of a quad (lane q: columns 8i + 2q, 8i + 2q + 1).  Each
//   lane joins its column pairs into 16-bit-weight sums (< 2^30) and stores
//   them at [row][4i + q] of a 128 x 36-word tile; every thread then reads
//   its own element's row with 16-byte loads and runs the carry chain
//   alone.  A row stride of 36 words keeps both sides free of bank
//   conflicts (the stores hit banks 4g + q, the 16-byte loads of 8 threads
//   cover 128 bytes 144 bytes apart).  Chosen over shuffles across the
//   quad: the element must end in one thread anyway (T is added in, the
//   next product's A row and the output are per element), and a quad
//   transpose would pick registers by a runtime lane index.
// * Outputs: each thread writes its element's 16 digits into the staging
//   tile (free again after the last carry) as a (16 x kTile)-word box, and
//   one thread stores the box with TMA (clipped at n), waiting for that
//   store to have read the tile before the next tile's products use it.
//   Without TMA, each thread stores its digits to the planes.
//
// With -DPK_MMA_TRACE each warp adds the SM clocks of its phases to a
// device array (mma_trace.cuh, experiments/mxu_trace.py).
#include <cuda.h>
#include <cuda_runtime.h>

#include "field.cuh"
#include "mma_trace.cuh"

namespace {

constexpr int kTile = 128;       // elements a stage (one warpgroup's tile)
constexpr int kConsumers = 3;    // consumer warpgroups
constexpr int kStages = 3;       // a multiple of kConsumers
constexpr int kThreads = 128 * kConsumers + 32;
constexpr int kPlanes = 32;      // 16 digit planes of a, then 16 of b
constexpr int kStageBytes = kPlanes * kTile * 4;
constexpr int kRowWords = 36;    // staging row: 32 sums + 4 of padding
constexpr int kBandBytes = 96 * 32;
constexpr int kABytes = kTile * 32;
constexpr int kStagingBytes = kTile * kRowWords * 4;
constexpr int kGroupBytes = kABytes + kStagingBytes;
constexpr int kBandOff = kStages * kStageBytes;
constexpr int kGroupOff = kBandOff + kBandBytes;
constexpr int kBarOff = kGroupOff + kConsumers * kGroupBytes;
constexpr int kSmemBytes = kBarOff + 2 * kStages * 8 + 1024;  // + alignment
static_assert(kStages % kConsumers == 0, "a stage serves one warpgroup");
static_assert(kBandOff % 1024 == 0 && kGroupOff % 1024 == 0 &&
              kGroupBytes % 1024 == 0, "operand tiles 1024-byte aligned");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// Wait until the barrier's phase with this parity has completed.  A phase
// that never completes is a fault: trap after 2^36 clocks (about 35 s)
// rather than hold the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.b32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1LL << 36)) __trap();
  } while (!done);
}

// The (kTile x 16)-word box of ``map`` at element e0 to shared memory,
// completing on barrier ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int e0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(e0), "r"(0), "r"(bar)
      : "memory");
}

// The (kTile x 16)-word box at shared address src to ``map`` at element e0
// (clipped at n), as one bulk group of this thread.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int e0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], "
      "[%3];" ::"l"(reinterpret_cast<uint64_t>(map)), "r"(e0), "r"(0),
      "r"(src) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Named barrier of one warpgroup (ids 1 .. kConsumers; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 128;" ::"r"(group + 1) : "memory");
}

// Shared-memory writes of this thread become visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Offset of byte k of row r in a K-major, 32-byte deep operand without
// swizzle: core matrices of 8 rows x 16 bytes (128 contiguous bytes), the
// two K halves 128 bytes apart (LBO), groups of 8 rows 256 bytes apart (SBO).
__device__ __forceinline__ int core_offset(int r, int k) {
  return (r >> 3) * 256 + (k >> 4) * 128 + (r & 7) * 16 + (k & 15);
}

__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// D (64 x 32, s32) = A (64 x 32 u8) * B (32 x 32 u8), both from shared
// memory.  Thread (warp w, lane 4g + q) gets rows 16w + g (d[4i], d[4i+1])
// and 16w + g + 8 (d[4i+2], d[4i+3]), columns 8i + 2q and 8i + 2q + 1.
__device__ __forceinline__ void wgmma_n32(uint32_t (&d)[16], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(a), "l"(b), "r"(0));
}

// The same with N = 64 (d[0 .. 31], columns 8i + 2q (+1) for i < 8).
__device__ __forceinline__ void wgmma_n64(uint32_t (&d)[32], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(0));
}

// Keep the compiler from moving accumulator reads across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// One band product of a warpgroup's 128 elements: A rows (the digits) at
// a_s, B (the band, kN rows) at b_s; the column pairs, as 16-bit-weight
// sums, into the staging tile at [row][4i + q].
template <int kN>
__device__ __forceinline__ void band_product(uint32_t a_s, uint32_t b_s,
                                             uint32_t* staging, int warp,
                                             int lane) {
  const int g = lane >> 2, q = lane & 3;
  uint32_t d[kN / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) d[i] = 0;
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    fence_regs(d);
    if constexpr (kN == 32) {
      wgmma_n32(d, desc(a_s + h * 2048), desc(b_s));
    } else {
      wgmma_n64(d, desc(a_s + h * 2048), desc(b_s));
    }
    wgmma_wait();
    fence_regs(d);
    uint32_t* row0 = staging + (64 * h + 16 * warp + g) * kRowWords + q;
#pragma unroll
    for (int i = 0; i < kN / 8; ++i) {
      row0[4 * i] = d[4 * i] + (d[4 * i + 1] << 8);
      row0[8 * kRowWords + 4 * i] = d[4 * i + 2] + (d[4 * i + 3] << 8);
    }
  }
}

// Row ``row`` of the staging tile, positions 0 .. kPos - 1.
template <int kPos>
__device__ __forceinline__ void read_row(const uint32_t* staging, int row,
                                         uint32_t (&u)[kPos]) {
  const uint4* p = reinterpret_cast<const uint4*>(staging + row * kRowWords);
#pragma unroll
  for (int j = 0; j < kPos / 4; ++j) {
    uint4 v = p[j];
    u[4 * j] = v.x;
    u[4 * j + 1] = v.y;
    u[4 * j + 2] = v.z;
    u[4 * j + 3] = v.w;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
mont_mul_mma_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const __grid_constant__ CUtensorMap map_out,
                    const uint32_t* __restrict__ a_planes,
                    const uint32_t* __restrict__ b_planes,
                    const uint32_t* __restrict__ bands,
                    uint32_t* __restrict__ out, int64_t n, int tma) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* band_s = smem + kBandOff;
  const uint32_t full0 = smem_addr(smem + kBarOff);
  const uint32_t empty0 = full0 + kStages * 8;
  const int64_t tiles = (n + kTile - 1) / kTile;

  // bands: BNP (32 rows) then BP (64 rows) of 32 bytes, to the core-matrix
  // layout, once per CTA
  for (int i = threadIdx.x; i < 96 * 2; i += kThreads) {
    int row = i >> 1, half = i & 1;
    int base = row < 32 ? 0 : 1024;
    int r = row < 32 ? row : row - 32;
    *reinterpret_cast<uint4*>(band_s + base + core_offset(r, 16 * half)) =
        reinterpret_cast<const uint4*>(bands)[i];
  }
  fence_async_smem();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 32);
      mbar_init(empty0 + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp_all = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  TRACE_DECL

  if (warp_all == 4 * kConsumers) {
    // producer warp: one TMA box of each operand a stage, or plain loads
    int j = 0;
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      mbar_wait(empty0 + 8 * s, parity ^ 1);
      TRACE_MARK(6)
      const int64_t e0 = tile * kTile;
      const int cnt = n - e0 < kTile ? (int)(n - e0) : kTile;
      uint8_t* stage = smem + s * kStageBytes;
      const uint32_t full = full0 + 8 * s;
      if (tma) {
        if (lane == 0) {
          mbar_arrive_tx(full, kStageBytes);
          tma_load(smem_addr(stage), &map_a, (int)e0, full);
          tma_load(smem_addr(stage + kStageBytes / 2), &map_b, (int)e0, full);
        } else {
          mbar_arrive(full);
        }
      } else {
        uint32_t* dst = reinterpret_cast<uint32_t*>(stage);
#pragma unroll 8
        for (int p = 0; p < kPlanes; ++p) {
          const uint32_t* src =
              (p < 16 ? a_planes + p * n : b_planes + (p - 16) * n) + e0;
#pragma unroll
          for (int k = 0; k < kTile / 32; ++k) {
            int e = 32 * k + lane;
            if (e < cnt) dst[p * kTile + e] = src[e];
          }
        }
        mbar_arrive(full);
      }
      TRACE_MARK(7)
    }
  } else {
    // consumer warpgroup ``group``; thread t owns element t of its tiles
    const int group = warp_all >> 2;
    const int warp = warp_all & 3;
    const int t = threadIdx.x & 127;
    uint8_t* gbase = smem + kGroupOff + group * kGroupBytes;
    const uint32_t a_s = smem_addr(gbase);
    uint32_t* staging = reinterpret_cast<uint32_t*>(gbase + kABytes);
    const uint32_t bnp_s = smem_addr(band_s), bp_s = bnp_s + 1024;
    uint4* a_row0 = reinterpret_cast<uint4*>(
        gbase + (t >> 6) * 2048 + core_offset(t & 63, 0));
    uint4* a_row1 = reinterpret_cast<uint4*>(
        gbase + (t >> 6) * 2048 + core_offset(t & 63, 16));

    int j = group;
    for (int64_t tile = blockIdx.x + (int64_t)group * gridDim.x;
         tile < tiles; tile += (int64_t)kConsumers * gridDim.x,
                 j += kConsumers) {
      const int s = j % kStages;
      const int64_t e = tile * kTile + t;
      const bool live = e < n;
      TRACE_MARK(5)
      mbar_wait(full0 + 8 * s, (j / kStages) & 1);
      TRACE_MARK(0)
      pk::Fe x{}, y{};
      if (live) {
        const uint32_t* st =
            reinterpret_cast<const uint32_t*>(smem + s * kStageBytes) + t;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          x.v[k] = (st[(2 * k) * kTile] & 0xFFFFu) |
                   (st[(2 * k + 1) * kTile] << 16);
          y.v[k] = (st[(16 + 2 * k) * kTile] & 0xFFFFu) |
                   (st[(17 + 2 * k) * kTile] << 16);
        }
      }
      mbar_arrive(empty0 + 8 * s);
      TRACE_MARK(1)

      // T = x * y on the CUDA cores (16 x 32-bit limbs)
      uint32_t tt[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) tt[k] = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          uint64_t v = (uint64_t)x.v[k] * y.v[i] + tt[i + k] + c;
          tt[i + k] = (uint32_t)v;
          c = v >> 32;
        }
        tt[i + 8] = (uint32_t)c;
      }
      TRACE_MARK(2)

      // m = T_lo * N' mod 2^256: 16 columns of 16-bit weight
      *a_row0 = make_uint4(tt[0], tt[1], tt[2], tt[3]);
      *a_row1 = make_uint4(tt[4], tt[5], tt[6], tt[7]);
      fence_async_smem();
      if (t == 0) tma_store_wait_read();  // the last tile's output left
      group_sync(group);
      band_product<32>(a_s, bnp_s, staging, warp, lane);
      group_sync(group);
      uint32_t m[8];
      {
        uint32_t u[16];
        read_row(staging, t, u);
        uint64_t c = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          uint64_t v = c + u[2 * k] + ((uint64_t)u[2 * k + 1] << 16);
          m[k] = (uint32_t)v;
          c = v >> 32;
        }
      }
      TRACE_MARK(3)

      // T + m * P: 32 columns of 16-bit weight, added to T
      *a_row0 = make_uint4(m[0], m[1], m[2], m[3]);
      *a_row1 = make_uint4(m[4], m[5], m[6], m[7]);
      fence_async_smem();
      group_sync(group);
      band_product<64>(a_s, bp_s, staging, warp, lane);
      group_sync(group);
      pk::Fe r;
      uint32_t top;
      {
        uint32_t u[32];
        read_row(staging, t, u);
        uint64_t c = 0;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          uint64_t v = c + tt[k] + u[2 * k] + ((uint64_t)u[2 * k + 1] << 16);
          if (k >= 8) r.v[k - 8] = (uint32_t)v;
          c = v >> 32;
        }
        top = (uint32_t)c;
      }
      TRACE_MARK(4)
      // (T + m P) / 2^256 < 2P: one conditional subtract
      const pk::Fe res = (top || pk::geq_p(r)) ? pk::sub_p(r) : r;
      if (tma) {
        // the tile's 16 output planes to the staging tile, then one TMA
        // store of the box (clipped at n)
        group_sync(group);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          staging[(2 * k) * kTile + t] = res.v[k] & 0xFFFFu;
          staging[(2 * k + 1) * kTile + t] = res.v[k] >> 16;
        }
        fence_async_smem();
        group_sync(group);
        if (t == 0) tma_store(&map_out, smem_addr(staging), (int)(e - t));
      } else if (live) {
        pk::store(out, n, e, res);
      }
      TRACE_COUNT
    }
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    TRACE_MARK(5)
  }
  TRACE_FLUSH
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no
// -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tensor map of contiguous (16, n) uint32 planes in (kTile x 16) boxes.
bool plane_map(CUtensorMap* map, const uint32_t* base, int64_t n) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)n, 16};
  cuuint64_t strides[1] = {(cuuint64_t)n * 4};
  cuuint32_t box[2] = {kTile, 16};
  cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2,
                const_cast<uint32_t*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// a, b, out: contiguous (16, n) planes; bands: the 96 x 32-byte band
// matrices on the device.  One CTA per SM, at most one a tile.
extern "C" int pk_mont_mul_mma(const uint32_t* a, const uint32_t* b,
                               const uint32_t* bands, uint32_t* out,
                               int64_t n, void* stream) {
  constexpr int kMaxDevices = 64;
  static int sms[kMaxDevices];  // SM count, once the kernel's attribute is set
  if (n <= 0) return (int)cudaGetLastError();
  if (n >= (int64_t{1} << 31)) return (int)cudaErrorInvalidValue;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int count;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mont_mul_mma_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    sms[dev] = count;
  }
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int grid = (int)(tiles < sms[dev] ? tiles : sms[dev]);
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int tma = n % 4 == 0 && aligned(a) && aligned(b) && aligned(out);
  CUtensorMap map_a{}, map_b{}, map_out{};
  if (tma && !(plane_map(&map_a, a, n) && plane_map(&map_b, b, n) &&
               plane_map(&map_out, out, n)))
    return (int)cudaErrorInvalidValue;
  mont_mul_mma_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      map_a, map_b, map_out, a, b, bands, out, n, tma);
  return (int)cudaGetLastError();
}
