// Skyscraper2 over BN254-Fr on Hopper: the 2-to-1 compression, its Merkle
// leaf fold, the batched permutation and the sponge's duplex.
//
// Replaces the TPU kernels provekit_tpu/ops/pallas_kernels.py:compress_pallas
// (K4) and permute_pallas (K5) (bodies _compress_kernel / _permute_kernel ->
// hash/skyscraper.py:_permute_core).  All share one 18-step ladder
// (skyscraper_field.cuh):
//   step k: (l, r) <- (r + f_k(l) + RC[k], l)
// with f_k a Montgomery square of the canonical value for k not in
// {6, 7, 10, 11}, and `bar` on those steps: rotate the 32-byte little-endian
// string by 16 bytes, apply the 8-bit S-box to every byte, reduce mod P.
// compress(l, r) = permute(l, r).left + l.
//
// What bounds it on the H100: 32-bit integer multiply-adds.  One compress
// needs at least 14 Montgomery squares, each 100 limb products (two
// multiply-adds each: low and high word) and 8 reduction factors (low word
// only: one each), 208 multiply-adds, against 192 bytes of plane traffic,
// so compress and the fold are bound by operations; the duplex runs
// one thread on the sponge's serial chain and is bound by the latency of the
// ladder's dependent instructions.
// Design: one thread per element (per leaf for the fold), the whole ladder
// in registers on PTX carry chains, a dedicated Montgomery square, one
// branch-free reduction per step; the round constants in __constant__
// memory (every thread reads the same word, which the constant cache
// broadcasts); the S-box SWAR on 32-bit limbs.
//   pk_compress       one compress per element, strided operand views
//                     (column stride 0 broadcasts, as PoW's challenge does);
//   pk_compress_fold  a leaf's elements folded left to right in registers:
//                     each leaf element read once, one digest written (the
//                     JAX package's _hash_leaves_jit as one launch);
//   pk_permute        one permutation per (16, n) pair;
//   pk_duplex         one thread: absorb k units of a (16, k) array from
//                     absorb position start_pos (rate 1: permute before a
//                     unit whenever the position is full), then squeeze n
//                     outputs, keeping the (16, 2) state in registers; it
//                     writes the new state and the outputs to one (16, 2 + n)
//                     block.  One launch per transcript operation.
#include <cuda_runtime.h>

#include "skyscraper_field.cuh"

namespace {

__device__ __constant__ uint32_t RC[18][8] = {
    {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
    {0x270bd744u, 0x903c4324u, 0x08a7d269u, 0x873125f7u, 0x06c83855u, 0x081dd279u, 0xea6d7667u, 0x276b1823u},
    {0x4b378d71u, 0x7ac8edbbu, 0xd99e2cb7u, 0xe29d79f3u, 0x4c1a5a18u, 0x75141791u, 0x58a484a6u, 0x0cf02bd7u},
    {0x69e5bc36u, 0xfa7adc67u, 0x7cca387du, 0x1c3f8e29u, 0x63481db0u, 0x0eb7730du, 0x18ede544u, 0x25b0e03fu},
    {0x2f03cfb7u, 0x57847e65u, 0x68873404u, 0x33440b96u, 0x49af80bcu, 0x955a32e8u, 0xbe14ae70u, 0x002882fcu},
    {0x6257d4d7u, 0x97923139u, 0x1b37d3c1u, 0x29989c3eu, 0x7f1277bau, 0x12ef02b4u, 0x1e2b7a9cu, 0x039ad857u},
    {0xabbb7887u, 0xb5b48465u, 0xe6ba2d2bu, 0xa72a6bc5u, 0x712f7b29u, 0x4cd48043u, 0x0fc1fc1au, 0x1142d541u},
    {0x059075d3u, 0x7ab2c156u, 0x047999b2u, 0x17cb3594u, 0x98f289f7u, 0x44f2c935u, 0x69bc0becu, 0x1d78439fu},
    {0x138b8edbu, 0x05d7a965u, 0xd55c48b1u, 0x36ef35a3u, 0xac6f1628u, 0x8ddfb8a1u, 0x08f4ff82u, 0x258588a5u},
    {0xfccb49e9u, 0x1596fb9au, 0x9a09a95bu, 0x9a7367d6u, 0x84e4c157u, 0x9bc43f69u, 0xd2f514feu, 0x13087879u},
    {0x3b4109fau, 0x295ccd23u, 0xed868012u, 0xe1d72f89u, 0x4bc88a8eu, 0x2e9e1eeau, 0x98c45232u, 0x17dadee8u},
    {0xaa1f486fu, 0x9a8590b4u, 0x30e9130eu, 0xb75834b4u, 0x34d5de31u, 0xb8e90b10u, 0x46e7f4a6u, 0x295c6d15u},
    {0x4c6eb892u, 0x850adcb7u, 0x05b92fc3u, 0x07699ef3u, 0xa1720f2du, 0x4ef96a2bu, 0x1d3ed446u, 0x1288ca0eu},
    {0x49d1b5eeu, 0x01960f93u, 0x69371c69u, 0x8ccad307u, 0x91c98662u, 0xe5c81e89u, 0x1ae023f3u, 0x17563b4du},
    {0x76b32917u, 0x6ba01e94u, 0xdd977bc9u, 0xa1cb0a3au, 0x5815f030u, 0x86815a94u, 0xe91a1eeau, 0x2869043bu},
    {0x5511d976u, 0x81776c88u, 0x47f414e7u, 0x7475d34fu, 0x095d96cfu, 0x5d090056u, 0xff59e79au, 0x14941f0au},
    {0x8fc8c034u, 0xbc40b4fdu, 0xcce4fd48u, 0xbb7142c3u, 0x8a39005au, 0x31835675u, 0x90f4379fu, 0x1ce337a1u},
    {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
};

struct RcConst {
  SK_DEV uint32_t operator()(int k, int i) const { return RC[k][i]; }
};

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
compress_kernel(pk::PlaneView l, pk::PlaneView r, uint32_t* out, int64_t n) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  pk::store(out, n, e, sk::compress(pk::load(l, e), pk::load(r, e),
                                    RcConst{}));
}

__global__ void __launch_bounds__(THREADS)
compress_fold_kernel(const uint32_t* leaves, int leaf_size, int64_t rs,
                     int64_t is, int64_t cs, uint32_t* out, int64_t n) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  sk::Fe h = pk::load(pk::PlaneView{leaves, rs, cs}, e);
#pragma unroll 1
  for (int i = 1; i < leaf_size; ++i)
    h = sk::compress(h, pk::load(pk::PlaneView{leaves + i * is, rs, cs}, e),
                     RcConst{});
  pk::store(out, n, e, h);
}

__global__ void __launch_bounds__(THREADS)
permute_kernel(pk::PlaneView l, pk::PlaneView r, uint32_t* lo, uint32_t* ro,
               int64_t n) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  sk::Fe a = pk::load(l, e);
  sk::Fe b = pk::load(r, e);
  sk::ladder(a, b, RcConst{});
  pk::store(lo, n, e, a);
  pk::store(ro, n, e, b);
}

__global__ void __launch_bounds__(1)
duplex_kernel(pk::PlaneView s, pk::PlaneView a, int k, int start_pos, int n,
              uint32_t* out, int64_t out_rs) {
  sk::Fe l = pk::load(s, 0);
  sk::Fe r = pk::load(s, 1);
  int pos = start_pos;
#pragma unroll 1
  for (int i = 0; i < k; ++i) {
    if (pos == 1) sk::ladder(l, r, RcConst{});
    l = pk::load(a, i);
    pos = 1;
  }
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    sk::ladder(l, r, RcConst{});
    pk::store(out + 2, out_rs, i, l);
  }
  pk::store(out, out_rs, 0, l);
  pk::store(out, out_rs, 1, r);
}

unsigned blocks(int64_t n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" int pk_compress(const uint32_t* l, int64_t l_rs, int64_t l_cs,
                           const uint32_t* r, int64_t r_rs, int64_t r_cs,
                           uint32_t* out, int64_t n, void* stream) {
  if (n > 0)
    compress_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
        pk::PlaneView{l, l_rs, l_cs}, pk::PlaneView{r, r_rs, r_cs}, out, n);
  return (int)cudaGetLastError();
}

// leaves[d * rs + i * is + e * cs]: digit d of element i of leaf e.
extern "C" int pk_compress_fold(const uint32_t* leaves, int leaf_size,
                                int64_t rs, int64_t is, int64_t cs,
                                uint32_t* out, int64_t n, void* stream) {
  if (n > 0)
    compress_fold_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
        leaves, leaf_size, rs, is, cs, out, n);
  return (int)cudaGetLastError();
}

extern "C" int pk_permute(const uint32_t* l, int64_t l_rs, int64_t l_cs,
                          const uint32_t* r, int64_t r_rs, int64_t r_cs,
                          uint32_t* lo, uint32_t* ro, int64_t n,
                          void* stream) {
  if (n > 0)
    permute_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
        pk::PlaneView{l, l_rs, l_cs}, pk::PlaneView{r, r_rs, r_cs}, lo, ro,
        n);
  return (int)cudaGetLastError();
}

// state (16, 2) and absorbed units (16, k) as strided views; out is a
// (16, 2 + n) block of row stride out_rs: the new state in columns 0-1,
// the squeezed outputs after it.
extern "C" int pk_duplex(const uint32_t* s, int64_t s_rs, int64_t s_cs,
                         const uint32_t* a, int64_t a_rs, int64_t a_cs,
                         int k, int start_pos, int n, uint32_t* out,
                         int64_t out_rs, void* stream) {
  duplex_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      pk::PlaneView{s, s_rs, s_cs}, pk::PlaneView{a, a_rs, a_cs}, k,
      start_pos, n, out, out_rs);
  return (int)cudaGetLastError();
}
