// Fused sumcheck segments on Hopper: the remaining rounds of a WHIR or a
// ZK-Spartan sumcheck, with the Fiat-Shamir sponge's steps between them, in
// one launch.
//
// Replaces provekit_tpu/ops/fused.py:whir_sumcheck_segment (:160) and
// spartan_sumcheck_fused (:204): jitted JAX functions, all rounds unrolled
// into one dispatch, whose TPU lowering runs the permutation kernel
// pallas_kernels.py:permute_pallas (K5) for the sponge and the Montgomery
// product of mont_mul_pallas (K1) for the round sums and the folds.
//
// Each round (sumcheck_round.cuh): every thread sums the products of its
// pairs in registers (field.cuh's mont_mul, add_mod, sub_mod); a block
// reduction (warp shuffles, then shared memory) gives the round's three sums;
// thread 0 turns them into the round's messages, absorbs them into the
// sponge from absorb position 0 and squeezes the challenge
// (skyscraper_sponge.cuh's permutation, the duplex kernel's), and writes the
// messages and the challenge; after a barrier every thread folds its pairs
// at the challenge.  WHIR pairs x[2i] with x[2i + 1] and folds into a
// ping-pong scratch buffer (the last round into the compact output);
// Spartan pairs x[i] with x[i + n/2] and folds in place in its scratch.
//
// What bounds it on the H100: the sponge's serial chain.  A round's
// challenge depends on its messages and the next round's sums on the
// challenge, so the 3 (WHIR) or 4 (Spartan) permutations of every round run
// one after another on one thread, at about 8.3 us each (pk_duplex's
// per-permutation time): a 14-round Spartan tail cannot take less than about
// 0.47 ms.  The pair arithmetic halves every round, so a segment does about
// twice its first round's work: at n = 2^14, 6 x 2^13 Montgomery products a
// round (WHIR) or 10 x 2^13 (Spartan) on one SM.
// Design: one block of THREADS threads runs the whole segment; the arrays
// (at most 2^14 elements x 4 polynomials x 64 bytes of digit planes, 4 MiB)
// stay in the 50 MB L2 between rounds; one block reduction a round, so no
// second launch and no atomics; the sponge state (and Spartan's claim and
// prefix) waits in shared memory between thread 0's steps, so that no
// register is held through the pair loops.
//   pk_whir_segment     count rounds of fw (16, 2, n) [f; w];
//   pk_spartan_segment  m rounds of abce (16, 4, n) [a; b; c; eq].
// Both write one (16, 2 + (K + 1) count) block: the new state in columns
// 0-1, the K = 3 or 4 canonical messages of round j in 2 + K j ..., the
// canonical challenges after them.
#include <cuda_runtime.h>

#include "sumcheck_round.cuh"

namespace {

using pk::Fe;

constexpr int THREADS = 512;  // at most 128 registers a thread
constexpr int WARPS = THREADS / 32;

// Element e of polynomial k: digit d at base[d * rs + k * ks + e * cs].
struct Polys {
  const uint32_t* base;
  int64_t rs, ks, cs;
  __device__ __forceinline__ Fe get(int k, int64_t e) const {
    return pk::load(pk::PlaneView{base + k * ks, rs, cs}, e);
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
    for (int j = 0; j < 3; ++j) acc[j] = lane < WARPS ? red[lane][j] : seg::zero();
    warp_sum(acc);
  }
}

__global__ void __launch_bounds__(THREADS)
whir_segment_kernel(Polys fw, pk::PlaneView st, int64_t n, int count,
                    uint32_t* scratch, uint32_t* folded, uint32_t* out,
                    int64_t out_rs) {
  __shared__ Fe red[WARPS][3];
  __shared__ Fe sponge[2], alpha_s;
  if (threadIdx.x == 0) {
    sponge[0] = pk::load(st, 0);
    sponge[1] = pk::load(st, 1);
  }
  // ping-pong: round j writes A (16, 2, n/2) for even j, B (16, 2, n/4) for
  // odd j, and the last round the output (16, 2, n >> count)
  const Buffer a{scratch, n >> 1, 2}, b{scratch + 32 * (n >> 1), n >> 2, 2};
  Polys src = fw;
#pragma unroll 1
  for (int j = 0; j < count; ++j) {
    const int64_t h = n >> (j + 1);
    Fe acc[3] = {seg::zero(), seg::zero(), seg::zero()};
#pragma unroll 1
    for (int64_t i = threadIdx.x; i < h; i += THREADS)
      seg::whir_pair(src.get(0, 2 * i), src.get(0, 2 * i + 1),
                     src.get(1, 2 * i), src.get(1, 2 * i + 1), acc);
    block_sum(acc, red);
    if (threadIdx.x == 0) {
      Fe l = sponge[0], r = sponge[1], msgs[3];
      const Fe alpha = seg::whir_step(l, r, acc, msgs);
      sponge[0] = l;
      sponge[1] = r;
#pragma unroll
      for (int k = 0; k < 3; ++k) pk::store(out, out_rs, 2 + 3 * j + k, msgs[k]);
      pk::store(out, out_rs, 2 + 3 * count + j, alpha);
      alpha_s = seg::to_mont(alpha);
    }
    __syncthreads();
    const Fe alpha = alpha_s;
    const Buffer dst = j == count - 1 ? Buffer{folded, h, 2} : (j & 1 ? b : a);
#pragma unroll 1
    for (int64_t i = threadIdx.x; i < h; i += THREADS) {
#pragma unroll 1
      for (int k = 0; k < 2; ++k)
        dst.put(k, i, seg::fold(src.get(k, 2 * i), src.get(k, 2 * i + 1),
                                alpha));
    }
    __syncthreads();
    src = dst.view();
  }
  if (threadIdx.x == 0) {
    pk::store(out, out_rs, 0, sponge[0]);
    pk::store(out, out_rs, 1, sponge[1]);
  }
}

// scal: (16, 5 + 7 m) columns: the state (0, 1), claim0, rho, prefix0 (2-4),
// then pms, sms and suffix (m each), then the blinding cubics, round-major.
__global__ void __launch_bounds__(THREADS)
spartan_segment_kernel(Polys abce, pk::PlaneView scal, int64_t n, int m,
                       uint32_t* scratch, uint32_t* out, int64_t out_rs) {
  __shared__ Fe red[WARPS][3];
  __shared__ Fe sponge[2], run[2], alpha_s;  // run: the claim, the prefix
  if (threadIdx.x == 0) {
    sponge[0] = pk::load(scal, 0);
    sponge[1] = pk::load(scal, 1);
    run[0] = pk::load(scal, 2);
    run[1] = pk::load(scal, 4);
  }
  // round 0 reads abce, every round folds in place into the scratch
  // (16, 4, n/2): element i reads i and i + h and writes i, which no other
  // element reads
  const Buffer dst{scratch, n >> 1, 4};
  Polys src = abce;
#pragma unroll 1
  for (int j = 0; j < m; ++j) {
    const int64_t h = n >> (j + 1);
    Fe acc[3] = {seg::zero(), seg::zero(), seg::zero()};
#pragma unroll 1
    for (int64_t i = threadIdx.x; i < h; i += THREADS) {
      Fe lo[4], hi[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        lo[k] = src.get(k, i);
        hi[k] = src.get(k, i + h);
      }
      seg::spartan_pair(lo, hi, acc);
    }
    block_sum(acc, red);
    if (threadIdx.x == 0) {
      Fe l = sponge[0], r = sponge[1], claim = run[0], prefix = run[1];
      Fe g[4], cs[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) g[k] = pk::load(scal, 5 + 3 * m + 4 * j + k);
      const Fe alpha = seg::spartan_step(
          l, r, acc, claim, prefix, pk::load(scal, 3), g,
          pk::load(scal, 5 + j), pk::load(scal, 5 + m + j),
          pk::load(scal, 5 + 2 * m + j), cs);
      sponge[0] = l;
      sponge[1] = r;
      run[0] = claim;
      run[1] = prefix;
#pragma unroll
      for (int k = 0; k < 4; ++k) pk::store(out, out_rs, 2 + 4 * j + k, cs[k]);
      pk::store(out, out_rs, 2 + 4 * m + j, alpha);
      alpha_s = seg::to_mont(alpha);
    }
    __syncthreads();
    if (j == m - 1) break;  // the last fold is never read
    const Fe alpha = alpha_s;
#pragma unroll 1
    for (int64_t i = threadIdx.x; i < h; i += THREADS) {
#pragma unroll 1
      for (int k = 0; k < 4; ++k)
        dst.put(k, i, seg::fold(src.get(k, i), src.get(k, i + h), alpha));
    }
    __syncthreads();
    src = dst.view();
  }
  if (threadIdx.x == 0) {
    pk::store(out, out_rs, 0, sponge[0]);
    pk::store(out, out_rs, 1, sponge[1]);
  }
}

}  // namespace

// fw[d * rs + k * ks + e * cs] (16, 2, n), n a power of two, count <= log2 n;
// the state (16, 2) as a strided view; scratch of 16 * 2 * (n/2 + n/4)
// words when count >= 2; folded (16, 2, n >> count) contiguous; out
// (16, 2 + 4 count) of row stride out_rs.
extern "C" int pk_whir_segment(const uint32_t* fw, int64_t rs, int64_t ks,
                               int64_t cs, const uint32_t* state, int64_t s_rs,
                               int64_t s_cs, int64_t n, int count,
                               uint32_t* scratch, uint32_t* folded,
                               uint32_t* out, int64_t out_rs, void* stream) {
  whir_segment_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      Polys{fw, rs, ks, cs}, pk::PlaneView{state, s_rs, s_cs}, n, count,
      scratch, folded, out, out_rs);
  return (int)cudaGetLastError();
}

// abce[d * rs + k * ks + e * cs] (16, 4, n), n = 2^m; scal (16, 5 + 7 m) as
// above, contiguous; scratch of 16 * 4 * (n/2) words when m >= 2; out
// (16, 2 + 5 m) of row stride out_rs.
extern "C" int pk_spartan_segment(const uint32_t* abce, int64_t rs,
                                  int64_t ks, int64_t cs,
                                  const uint32_t* scal, int64_t scal_rs,
                                  int64_t n, int m, uint32_t* scratch,
                                  uint32_t* out, int64_t out_rs,
                                  void* stream) {
  spartan_segment_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      Polys{abce, rs, ks, cs}, pk::PlaneView{scal, scal_rs, 1}, n, m, scratch,
      out, out_rs);
  return (int)cudaGetLastError();
}
