// Fused sumcheck segments on Hopper: every round of a WHIR or a ZK-Spartan
// sumcheck, with the Fiat-Shamir sponge's steps between them, in one
// cooperative launch over the card.
//
// Replaces provekit_tpu/ops/fused.py:whir_sumcheck_segment (:160) and
// spartan_sumcheck_fused (:204): jitted JAX functions, all rounds unrolled
// into one dispatch, whose TPU lowering runs the permutation kernel
// pallas_kernels.py:permute_pallas (K5) for the sponge and the Montgomery
// product of mont_mul_pallas (K1) for the round sums and the folds.
//
// What bounds it on the H100: two things, by n.  The sponge's serial chain:
// a round's challenge depends on its messages and the next round's sums on
// the challenge, so the 3 (WHIR) or 4 (Spartan) permutations of every round
// run one after another on one thread, at about 8.4 us each (pk_duplex's per
// permutation time).  And the bytes of the first rounds: a WHIR call on
// (2^24, 4) streams 2 GiB in its first pass, a Spartan call on 2^22 1 GiB.
//
// Design (sumcheck_round.cuh holds the arithmetic and the schedule):
// - One cooperative launch (cudaLaunchCooperativeKernel) of as many blocks
//   as the card holds at once (the occupancy API times the SM count, cached
//   per device), fewer when round 0's pairs need fewer; THREADS threads a
//   block under __launch_bounds__(THREADS, 1), so the permutation and the
//   pair loops get 255 registers and nothing spills.
// - A round over the grid: each thread sums the products of its pairs in
//   registers; the block reduces them (warp shuffles, then shared memory);
//   block b writes its three sums to partials[j & 1][b]; one grid barrier;
//   then EVERY block reduces all blocks' partials and its thread 0 runs the
//   same scalar step (messages, absorb, squeeze, and for Spartan the ZK
//   combination, claim and prefix) on its own copy of the sponge state in
//   shared memory.  All blocks compute the same challenge from the same
//   partials, which saves a second barrier to publish it; block 0 alone
//   writes the outputs.  The partials alternate between two slots by round,
//   so that round j + 1's writes never meet a slow block's reads of round j
//   (round j + 2 writes that slot again only after the next barrier).
// - Fold and next sums in one pass: each thread takes units of four
//   elements, folds them at round j's challenge into round j + 1's pair and
//   adds that pair's products, so a round reads its arrays once and writes
//   half.  WHIR folds into a ping-pong scratch (A, B, the last round into
//   the compact output); Spartan folds in place in its scratch.  Scratch
//   written by other blocks is read through L2 (ld.global.cg), after the
//   grid barrier that orders it.
// - Tail on one block: from the first pass whose items fit one block, block
//   0 runs the remaining rounds alone with block barriers and the other
//   blocks return, so the small shapes pay no grid barrier.
// - Scalars in shared memory: Spartan's scalar block ((16, 5 + 7 m) planes)
//   and the sponge state are copied to shared memory as limbs at the start,
//   so that thread 0's chain reads no global planes.
// - Field operations on PTX carry chains (sumcheck_round.cuh): the serial
//   parts (thread 0's step, a tail pass of one unit a thread) wait on each
//   product's latency, which the chains halve against field.cuh's.
//   pk_whir_segment     count rounds of fw (16, 2, n) [f; w];
//   pk_spartan_segment  m rounds of abce (16, 4, n) [a; b; c; eq].
// Both write one (16, 2 + (K + 1) count) block: the new state in columns
// 0-1, the K = 3 or 4 canonical messages of round j in 2 + K j ..., the
// canonical challenges after them.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sumcheck_round.cuh"

namespace {

namespace cg = cooperative_groups;
using pk::Fe;
using seg::THREADS;

constexpr int WARPS = THREADS / 32;
constexpr int MAX_DEVICES = 64;

// Phase timings for experiments/segment_time.py, which builds this file
// with -DPK_SEGMENT_TRACE: thread 0 of block 0 writes the card's global
// timer (ns) at each mark, and after each round's step it times one more
// permutation and four chained Montgomery products on copies.  Without the
// macro every mark is empty.
#ifdef PK_SEGMENT_TRACE
constexpr int TRACE_MAX = 1024;
__device__ unsigned long long seg_trace[TRACE_MAX];

__device__ __forceinline__ unsigned long long now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mark(int i) {
  if (blockIdx.x == 0 && threadIdx.x == 0 && i < TRACE_MAX)
    seg_trace[i] = now();
}

// marks 2 + 8 j + 5 .. 7: a permutation and four products after round j
__device__ __noinline__ void time_parts(int j, const Fe& l, const Fe& r) {
  if (blockIdx.x != 0 || 10 + 8 * j >= TRACE_MAX) return;
  Fe a = l, b = r;
  const unsigned long long t0 = now();
  sk::permute(a, b);
  const unsigned long long t1 = now();
  Fe c = seg::mul(a, b);
  c = seg::mul(c, a);
  c = seg::mul(c, b);
  c = seg::mul(c, a);
  const unsigned long long t2 = now();
  seg_trace[2 + 8 * j + 5] = t1 - t0;
  seg_trace[2 + 8 * j + 6] = t2 - t1;
  seg_trace[2 + 8 * j + 7] = c.v[0];  // keeps the products
}
#else
__device__ __forceinline__ void mark(int) {}
__device__ __forceinline__ void time_parts(int, const Fe&, const Fe&) {}
#endif

// Element e of polynomial k: digit d at base[d * rs + k * ks + e * cs],
// read through L2 (the scratch may have been written by another SM).
struct Polys {
  const uint32_t* base;
  int64_t rs, ks, cs;

  __device__ __forceinline__ Fe get(int k, int64_t e) const {
    const uint32_t* p = base + k * ks + e * cs;
    Fe r;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      r.v[i] = (__ldcg(p + 2 * i * rs) & 0xFFFFu) |
               (__ldcg(p + (2 * i + 1) * rs) << 16);
    return r;
  }

  // elements e .. e + C - 1 (C = 2 or 4): one vector load a digit plane
  // where they are contiguous and aligned
  template <int C>
  __device__ __forceinline__ void run(int k, int64_t e, Fe x[C]) const {
    const uint32_t* p = base + k * ks + e;
    if (cs == 1 && rs % C == 0 &&
        reinterpret_cast<uintptr_t>(p) % (4 * C) == 0) {
#pragma unroll
      for (int d = 0; d < 16; ++d) {
        uint32_t w[C];
        if constexpr (C == 4) {
          const uint4 v = __ldcg(reinterpret_cast<const uint4*>(p + d * rs));
          w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
        } else {
          const uint2 v = __ldcg(reinterpret_cast<const uint2*>(p + d * rs));
          w[0] = v.x, w[1] = v.y;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (d & 1)
            x[c].v[d >> 1] |= w[c] << 16;
          else
            x[c].v[d >> 1] = w[c] & 0xFFFFu;
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = get(k, e + c);
    }
  }
};

// A contiguous (16, K, cap) buffer.
struct Buffer {
  uint32_t* base;
  int64_t cap;
  int polys;

  __device__ __forceinline__ void put(int k, int64_t e, const Fe& a) const {
    pk::store(base + k * cap, polys * cap, e, a);
  }

  template <int C>
  __device__ __forceinline__ void put_run(int k, int64_t e,
                                          const Fe y[C]) const {
    static_assert(C == 2, "pairs only");
    uint32_t* p = base + k * cap + e;
    const int64_t rs = polys * cap;
    if (rs % 2 == 0 && reinterpret_cast<uintptr_t>(p) % 8 == 0) {
#pragma unroll
      for (int d = 0; d < 16; ++d) {
        const int i = d >> 1;
        const uint32_t a = d & 1 ? y[0].v[i] >> 16 : y[0].v[i] & 0xFFFFu;
        const uint32_t b = d & 1 ? y[1].v[i] >> 16 : y[1].v[i] & 0xFFFFu;
        *reinterpret_cast<uint2*>(p + d * rs) = make_uint2(a, b);
      }
    } else {
      put(k, e, y[0]);
      put(k, e + 1, y[1]);
    }
  }

  __device__ __forceinline__ Polys view() const {
    return Polys{base, polys * cap, cap, 1};
  }
};

__device__ __forceinline__ Fe shfl_down(const Fe& a, int offset) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    r.v[k] = __shfl_down_sync(0xffffffffu, a.v[k], offset);
  return r;
}

__device__ __forceinline__ void warp_sum(Fe acc[3]) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      acc[j] = seg::add(acc[j], shfl_down(acc[j], offset));
  }
}

// The block's sums of acc[0..2]; thread 0 holds them on return.  The
// shared array is rewritten only after the next barrier of the caller.
__device__ __forceinline__ void block_sum(Fe acc[3], Fe (*red)[3]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_sum(acc);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) red[warp][j] = acc[j];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      acc[j] = lane < WARPS ? red[lane][j] : seg::zero();
    warp_sum(acc);
  }
}

// The round's sums: over the block, or (on the grid) over every block
// through partials[slot] ((blocks, 3) limb vectors) and one grid barrier.
// Thread 0 of every block holds them on return.
__device__ __forceinline__ void round_sums(Fe acc[3], Fe (*red)[3],
                                           bool grid, Fe* partials,
                                           int slot, int mark_round) {
  block_sum(acc, red);
  if (!grid) return;
  mark(2 + 8 * mark_round + 1);
  Fe* part = partials + (int64_t)slot * gridDim.x * 3;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) part[3 * blockIdx.x + j] = acc[j];
  }
  cg::this_grid().sync();  // orders every block's partials and fold writes
  mark(2 + 8 * mark_round + 2);
#pragma unroll
  for (int j = 0; j < 3; ++j) acc[j] = seg::zero();
  for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(part + 3 * b + j);
      Fe x;
#pragma unroll
      for (int k = 0; k < 8; ++k) x.v[k] = __ldcg(w + k);
      acc[j] = seg::add(acc[j], x);
    }
  }
  block_sum(acc, red);
}

__global__ void __launch_bounds__(THREADS, 1)
whir_segment_kernel(Polys fw, pk::PlaneView st, int64_t n, int count,
                    uint32_t* scratch, uint32_t* folded, uint32_t* out,
                    int64_t out_rs, Fe* partials) {
  __shared__ Fe red[WARPS][3];
  __shared__ Fe sponge[2], alpha_s;
  const int t = threadIdx.x;
  const int64_t blocks = gridDim.x, b = blockIdx.x;
  const bool writer = b == 0 && t == 0;
  mark(0);
  if (t == 0) {
    sponge[0] = pk::load(st, 0);
    sponge[1] = pk::load(st, 1);
  }
  bool grid = seg::on_grid(true, n >> 1, blocks);
  if (count == 0 || (!grid && b != 0)) {
    if (writer) {
      pk::store(out, out_rs, 0, sponge[0]);
      pk::store(out, out_rs, 1, sponge[1]);
    }
    return;
  }
  // ping-pong: seg::whir_fold_dst(j, count) picks A (16, 2, n/2), B
  // (16, 2, n/4) or the output (16, 2, n >> count)
  const Buffer a{scratch, n >> 1, 2}, bb{scratch + 32 * (n >> 1), n >> 2, 2},
      o{folded, n >> count, 2};
  Polys src = fw;
  Fe acc[3] = {seg::zero(), seg::zero(), seg::zero()};
  {
    const seg::Sweep s = seg::sweep(grid, blocks, b, t);
#pragma unroll 1
    for (int64_t i = s.first; i < (n >> 1); i += s.stride)
      seg::whir_first(src, i, acc);
  }
#pragma unroll 1
  for (int j = 0; j < count; ++j) {
    mark(2 + 8 * j);
    round_sums(acc, red, grid, partials, j & 1, j);
    mark(2 + 8 * j + 3);
    if (t == 0) {
      Fe l = sponge[0], r = sponge[1], msgs[3];
      const Fe alpha = seg::whir_step(l, r, acc, msgs);
      sponge[0] = l;
      sponge[1] = r;
      if (b == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
          pk::store(out, out_rs, 2 + 3 * j + k, msgs[k]);
        pk::store(out, out_rs, 2 + 3 * count + j, alpha);
      }
      alpha_s = seg::to_mont(alpha);
      mark(2 + 8 * j + 4);
      time_parts(j, l, r);
    }
    __syncthreads();
    const Fe alpha = alpha_s;
    const int d = seg::whir_fold_dst(j, count);
    const Buffer dst = d == 0 ? a : d == 1 ? bb : o;
    // the last round folds into the output; every other round folds and
    // sums the next round's pairs, n >> (j + 2) units
    const int64_t work = j == count - 1 ? n >> count : n >> (j + 2);
    grid = seg::on_grid(grid, work, blocks);
    if (!grid && b != 0) return;
    const seg::Sweep s = seg::sweep(grid, blocks, b, t);
    if (j == count - 1) {
#pragma unroll 1
      for (int64_t i = s.first; i < work; i += s.stride)
        seg::whir_fold_last(src, dst, i, alpha);
      break;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[k] = seg::zero();
#pragma unroll 1
    for (int64_t u = s.first; u < work; u += s.stride)
      seg::whir_fold_next(src, dst, u, alpha, acc);
    src = dst.view();
  }
  mark(1);
  if (writer) {
    pk::store(out, out_rs, 0, sponge[0]);
    pk::store(out, out_rs, 1, sponge[1]);
  }
}

// scal: (16, 5 + 7 m) columns: the state (0, 1), claim0, rho, prefix0 (2-4),
// then pms, sms and suffix (m each), then the blinding cubics, round-major.
__global__ void __launch_bounds__(THREADS, 1)
spartan_segment_kernel(Polys abce, pk::PlaneView scal, int64_t n, int m,
                       uint32_t* scratch, uint32_t* out, int64_t out_rs,
                       Fe* partials) {
  __shared__ Fe red[WARPS][3];
  __shared__ Fe sc[5 + 7 * seg::MAX_ROUNDS];  // scal, as limbs
  __shared__ Fe run[2], alpha_s;              // the claim, the prefix
  const int t = threadIdx.x;
  const int64_t blocks = gridDim.x, b = blockIdx.x;
  const bool writer = b == 0 && t == 0;
  mark(0);
  bool grid = seg::on_grid(true, n >> 1, blocks);
  if (!grid && b != 0) return;
  for (int i = t; i < 5 + 7 * m; i += THREADS) sc[i] = pk::load(scal, i);
  __syncthreads();
  if (t == 0) {
    run[0] = sc[2];
    run[1] = sc[4];
  }
  Fe* const sponge = sc;  // columns 0-1, advanced in place
  // round 0 reads abce; every later round folds in place into the scratch
  // (16, 4, n/2)
  const Buffer dst{scratch, n >> 1, 4};
  Polys src = abce;
  Fe acc[3] = {seg::zero(), seg::zero(), seg::zero()};
  if (m > 0) {
    const seg::Sweep s = seg::sweep(grid, blocks, b, t);
#pragma unroll 1
    for (int64_t i = s.first; i < (n >> 1); i += s.stride)
      seg::spartan_first(src, i, n, acc);
  }
#pragma unroll 1
  for (int j = 0; j < m; ++j) {
    mark(2 + 8 * j);
    round_sums(acc, red, grid, partials, j & 1, j);
    mark(2 + 8 * j + 3);
    if (t == 0) {
      Fe l = sponge[0], r = sponge[1], claim = run[0], prefix = run[1];
      Fe cs[4];
      const Fe alpha = seg::spartan_step(
          l, r, acc, claim, prefix, sc[3], &sc[5 + 3 * m + 4 * j], sc[5 + j],
          sc[5 + m + j], sc[5 + 2 * m + j], cs);
      sponge[0] = l;
      sponge[1] = r;
      run[0] = claim;
      run[1] = prefix;
      if (b == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          pk::store(out, out_rs, 2 + 4 * j + k, cs[k]);
        pk::store(out, out_rs, 2 + 4 * m + j, alpha);
      }
      alpha_s = seg::to_mont(alpha);
      mark(2 + 8 * j + 4);
      time_parts(j, l, r);
    }
    __syncthreads();
    if (j == m - 1) break;  // the last fold is never read
    const Fe alpha = alpha_s;
    const int64_t len = n >> j, work = n >> (j + 2);
    grid = seg::on_grid(grid, work, blocks);
    if (!grid && b != 0) return;
    const seg::Sweep s = seg::sweep(grid, blocks, b, t);
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[k] = seg::zero();
#pragma unroll 1
    for (int64_t u = s.first; u < work; u += s.stride)
      seg::spartan_fold_next(src, dst, u, len, alpha, acc);
    src = dst.view();
  }
  mark(1);
  if (writer) {
    pk::store(out, out_rs, 0, sponge[0]);
    pk::store(out, out_rs, 1, sponge[1]);
  }
}

// Blocks of `kernel` that the current device holds at once (cached per
// device), or a negative CUDA error: the card must take cooperative
// launches.
int resident_blocks(const void* kernel, int (&cache)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev < MAX_DEVICES && cache[dev] > 0) return cache[dev];
  int coop = 0, sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                  dev)) != cudaSuccess)
    return -(int)e;
  if (!coop) return -(int)cudaErrorNotSupported;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         THREADS, 0)) !=
          cudaSuccess)
    return -(int)e;
  // 0 resident blocks: the launch below reports why
  const int blocks = per_sm * sms > 0 ? per_sm * sms : 1;
  if (dev < MAX_DEVICES) cache[dev] = blocks;
  return blocks;
}

int whir_resident[MAX_DEVICES], spartan_resident[MAX_DEVICES];

int launch(const void* kernel, int resident, int64_t n, int rounds,
           void** args, void* stream) {
  if (resident < 0) return -resident;
  const int64_t blocks = rounds == 0 ? 1 : seg::grid_blocks(
      n, resident < seg::MAX_BLOCKS ? resident : seg::MAX_BLOCKS);
  const cudaError_t e = cudaLaunchCooperativeKernel(
      kernel, dim3((unsigned)blocks), dim3(THREADS), args, 0,
      (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// fw[d * rs + k * ks + e * cs] (16, 2, n), n a power of two, count <= log2 n;
// the state (16, 2) as a strided view; scratch of 16 * 2 * (n/2 + n/4)
// words when count >= 2; folded (16, 2, n >> count) contiguous; out
// (16, 2 + 4 count) of row stride out_rs; partials of 2 * 3 * 8 words for
// each of seg::MAX_BLOCKS blocks (pk_segment_max_blocks).  A launch the card
// refuses returns its error (there is no other way to run the segment).
extern "C" int pk_whir_segment(const uint32_t* fw, int64_t rs, int64_t ks,
                               int64_t cs, const uint32_t* state, int64_t s_rs,
                               int64_t s_cs, int64_t n, int count,
                               uint32_t* scratch, uint32_t* folded,
                               uint32_t* out, int64_t out_rs,
                               uint32_t* partials, void* stream) {
  Polys src{fw, rs, ks, cs};
  pk::PlaneView st{state, s_rs, s_cs};
  Fe* part = reinterpret_cast<Fe*>(partials);
  void* args[] = {&src, &st, &n, &count, &scratch, &folded, &out, &out_rs,
                  &part};
  const void* kernel = reinterpret_cast<const void*>(whir_segment_kernel);
  return launch(kernel, resident_blocks(kernel, whir_resident), n, count,
                args, stream);
}

// abce[d * rs + k * ks + e * cs] (16, 4, n), n = 2^m, m <= 32; scal
// (16, 5 + 7 m) as above, contiguous; scratch of 16 * 4 * (n/2) words when
// m >= 2; out (16, 2 + 5 m) of row stride out_rs; partials as above.
extern "C" int pk_spartan_segment(const uint32_t* abce, int64_t rs,
                                  int64_t ks, int64_t cs,
                                  const uint32_t* scal, int64_t scal_rs,
                                  int64_t n, int m, uint32_t* scratch,
                                  uint32_t* out, int64_t out_rs,
                                  uint32_t* partials, void* stream) {
  if (m > seg::MAX_ROUNDS) return (int)cudaErrorInvalidValue;
  Polys src{abce, rs, ks, cs};
  pk::PlaneView sv{scal, scal_rs, 1};
  Fe* part = reinterpret_cast<Fe*>(partials);
  void* args[] = {&src, &sv, &n, &m, &scratch, &out, &out_rs, &part};
  const void* kernel = reinterpret_cast<const void*>(spartan_segment_kernel);
  return launch(kernel, resident_blocks(kernel, spartan_resident), n, m,
                args, stream);
}

// The blocks whose round sums the partials buffer must hold.
extern "C" int pk_segment_max_blocks() { return seg::MAX_BLOCKS; }

#ifdef PK_SEGMENT_TRACE
// The marks of the last launch (n of them) into host memory, then zeros.
extern "C" int pk_segment_trace(unsigned long long* host, int n) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(host, seg_trace, n * sizeof(unsigned long long));
  static const unsigned long long zeros[TRACE_MAX] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(seg_trace, zeros, sizeof zeros);
  return (int)e;
}
#endif
