// Skyscraper2 over BN254-Fr on Hopper: the 2-to-1 compression, its Merkle
// leaf fold, the batched permutation and the sponge's duplex.
//
// Replaces the TPU kernels provekit_tpu/ops/pallas_kernels.py:compress_pallas
// (K4) and permute_pallas (K5) (bodies _compress_kernel / _permute_kernel ->
// hash/skyscraper.py:_permute_core).  All share one 18-step ladder
// (skyscraper_field.cuh; the round constants in skyscraper_sponge.cuh):
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

#include "skyscraper_sponge.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
compress_kernel(pk::PlaneView l, pk::PlaneView r, uint32_t* out, int64_t n) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  pk::store(out, n, e, sk::compress(pk::load(l, e), pk::load(r, e),
                                    sk::RcConst{}));
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
                     sk::RcConst{});
  pk::store(out, n, e, h);
}

__global__ void __launch_bounds__(THREADS)
permute_kernel(pk::PlaneView l, pk::PlaneView r, uint32_t* lo, uint32_t* ro,
               int64_t n) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  sk::Fe a = pk::load(l, e);
  sk::Fe b = pk::load(r, e);
  sk::permute(a, b);
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
    if (pos == 1) sk::permute(l, r);
    l = pk::load(a, i);
    pos = 1;
  }
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    sk::permute(l, r);
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
