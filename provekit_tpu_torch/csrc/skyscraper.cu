// Skyscraper2 over BN254-Fr: the 2-to-1 compression and the permutation.
//
// Replaces the TPU kernels provekit_tpu/ops/pallas_kernels.py:compress_pallas
// and permute_pallas (bodies _compress_kernel / _permute_kernel ->
// hash/skyscraper.py:_permute_core).  Both share one 18-step ladder:
//   step k: (l, r) <- (r + f_k(l) + RC[k], l)
// with f_k a Montgomery square of the canonical value for k not in
// {6, 7, 10, 11}, and `bar` on those steps: rotate the 32-byte little-endian
// string by 16 bytes, apply the 8-bit S-box to every byte, reduce mod P.
// compress(l, r) = permute(l, r).left + l.
//
// What bounds it on the H100: integer arithmetic.  One element costs 14
// Montgomery squares (~1,000 32-bit multiply-adds) against 192 bytes of
// plane traffic, so the compress kernel is compute-bound; `permute` runs at
// n = 1 on the sponge's serial chain and is bound by launch latency.
// Design: one thread per element, the whole ladder in registers, the round
// constants in __constant__ memory (every thread reads the same word, which
// the constant cache broadcasts), the S-box computed SWAR on 32-bit limbs
// (four bytes per word operation) instead of a table lookup.
#include <cuda_runtime.h>

#include "field.cuh"

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

// Rotate each of the four bytes of w left by k bits.
__device__ __forceinline__ uint32_t rotl_bytes(uint32_t w, int k) {
  uint32_t low = ((1u << k) - 1u) * 0x01010101u;
  return ((w << k) & ~low) | ((w >> (8 - k)) & low);
}

// The Skyscraper S-box on four bytes at once:
// sbox(v) = rotl1(v ^ (rotl1(~v) & rotl2(v) & rotl3(v))).
__device__ __forceinline__ uint32_t sbox4(uint32_t v) {
  uint32_t t = v ^ (rotl_bytes(~v, 1) & rotl_bytes(v, 2) & rotl_bytes(v, 3));
  return rotl_bytes(t, 1);
}

__device__ __forceinline__ pk::Fe bar(const pk::Fe& x) {
  pk::Fe y;
#pragma unroll
  for (int k = 0; k < 8; ++k) y.v[k] = sbox4(x.v[(k + 4) & 7]);
  return pk::reduce_full(y);
}

__device__ __forceinline__ void ladder(pk::Fe& l, pk::Fe& r) {
#pragma unroll 1
  for (int k = 0; k < 18; ++k) {
    bool is_bar = (k == 6) | (k == 7) | (k == 10) | (k == 11);
    pk::Fe f = is_bar ? bar(l) : pk::mont_mul(l, l);
    pk::Fe rc;
#pragma unroll
    for (int i = 0; i < 8; ++i) rc.v[i] = RC[k][i];
    pk::Fe nl = pk::add_mod(pk::add_mod(r, f), rc);
    r = l;
    l = nl;
  }
}

__global__ void compress_kernel(pk::PlaneView l, pk::PlaneView r,
                                uint32_t* out, int64_t n) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  pk::Fe l0 = pk::load(l, e);
  pk::Fe a = l0;
  pk::Fe b = pk::load(r, e);
  ladder(a, b);
  pk::store(out, n, e, pk::add_mod(a, l0));
}

__global__ void permute_kernel(pk::PlaneView l, pk::PlaneView r,
                               uint32_t* lo, uint32_t* ro, int64_t n) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  pk::Fe a = pk::load(l, e);
  pk::Fe b = pk::load(r, e);
  ladder(a, b);
  pk::store(lo, n, e, a);
  pk::store(ro, n, e, b);
}

}  // namespace

extern "C" int pk_compress(const uint32_t* l, int64_t l_rs, int64_t l_cs,
                           const uint32_t* r, int64_t r_rs, int64_t r_cs,
                           uint32_t* out, int64_t n, void* stream) {
  if (n > 0) {
    const int threads = 128;
    int64_t blocks = (n + threads - 1) / threads;
    compress_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        pk::PlaneView{l, l_rs, l_cs}, pk::PlaneView{r, r_rs, r_cs}, out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int pk_permute(const uint32_t* l, int64_t l_rs, int64_t l_cs,
                          const uint32_t* r, int64_t r_rs, int64_t r_cs,
                          uint32_t* lo, uint32_t* ro, int64_t n,
                          void* stream) {
  if (n > 0) {
    const int threads = 32;
    int64_t blocks = (n + threads - 1) / threads;
    permute_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        pk::PlaneView{l, l_rs, l_cs}, pk::PlaneView{r, r_rs, r_cs}, lo, ro,
        n);
  }
  return (int)cudaGetLastError();
}
