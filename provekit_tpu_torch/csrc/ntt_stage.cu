// One constant-geometry (Pease) DIF radix-2 NTT stage with chunk interleave,
// as two kernels that share one body.
//
// ntt_stage_kernel replaces the TPU kernel
// provekit_tpu/ops/pallas_kernels.py:ntt_stage_pallas (body _ntt_stage_kernel):
// for step j (0 <= j < n / (2 c)),
//   a_j = x[j c : j c + c],  b_j = x[n/2 + j c : ...]
//   out[2 j c : 2 j c + c]     = a_j + b_j
//   out[2 j c + c : 2 j c + 2c] = (a_j - b_j) * tw[(j >> s) << s]
// with tw the undecimated (16, m/2) table of w_m^k in Montgomery form, so
// the stride-2^s decimated slice of the TPU path is never built.
//
// butterfly_kernel replaces the TPU kernel pallas_kernels.py:butterfly_pallas
// (body _butterfly_kernel), which returns (a + b, (a - b) * tw) for (16, half)
// planes a, b and tw.  Its JAX caller (provekit_tpu/ops/ntt.py:_pease_flat)
// sends it the stages whose chunk lies outside 256..4096: it materialises tw
// as the stage twiddle broadcast over each chunk (1 GiB per stage at 2^25)
// and interleaves u and t at chunk granularity in a second pass.  Here the
// twiddle is read from the undecimated table and u and t are written to
// their interleaved positions, so the butterfly and its caller's two passes
// become the stage above.  It stays a kernel of its own so that launch
// counts and profiles show the stages the JAX package gives its butterfly.
//
// What bounds both on the H100: memory.  Each pair reads 2 x 64 bytes,
// writes 2 x 64 bytes and reads one 64-byte twiddle (shared by the c pairs
// of a chunk, so mostly an L1/L2 hit) against one Montgomery product.
// Design: one thread per (a, b) pair for any chunk from 1 to n/2; loads are
// coalesced within a chunk and across chunks for c == 1.  Stages run one
// launch each; fusing several in shared memory is later work.  All offsets
// are 64-bit: a (16, 2^25) array has 2^29 words.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

__device__ __forceinline__ void stage_pair(const uint32_t* x, uint32_t* out,
                                           int64_t n, const uint32_t* tw,
                                           int64_t tw_len, int s,
                                           int log_chunk) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t half = n >> 1;
  if (t >= half) return;
  int64_t j = t >> log_chunk;
  int64_t e = t - (j << log_chunk);
  int64_t c = (int64_t)1 << log_chunk;
  pk::PlaneView xv{x, n, 1};
  pk::Fe a = pk::load(xv, t);
  pk::Fe b = pk::load(xv, half + t);
  pk::Fe w = pk::load(pk::PlaneView{tw, tw_len, 1}, (j >> s) << s);
  int64_t base = 2 * j * c + e;
  pk::store(out, n, base, pk::add_mod(a, b));
  pk::store(out, n, base + c, pk::mont_mul(pk::sub_mod(a, b), w));
}

__global__ void ntt_stage_kernel(const uint32_t* x, uint32_t* out, int64_t n,
                                 const uint32_t* tw, int64_t tw_len, int s,
                                 int log_chunk) {
  stage_pair(x, out, n, tw, tw_len, s, log_chunk);
}

__global__ void butterfly_kernel(const uint32_t* x, uint32_t* out, int64_t n,
                                 const uint32_t* tw, int64_t tw_len, int s,
                                 int log_chunk) {
  stage_pair(x, out, n, tw, tw_len, s, log_chunk);
}

using StageKernel = void (*)(const uint32_t*, uint32_t*, int64_t,
                             const uint32_t*, int64_t, int, int);

int launch_stage(StageKernel kernel, const uint32_t* x, uint32_t* out,
                 int64_t n, const uint32_t* tw, int64_t tw_len, int s,
                 int log_chunk, void* stream) {
  int64_t half = n >> 1;
  if (half > 0) {
    const int threads = 256;
    int64_t blocks = (half + threads - 1) / threads;
    kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        x, out, n, tw, tw_len, s, log_chunk);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pk_ntt_stage(const uint32_t* x, uint32_t* out, int64_t n,
                            const uint32_t* tw, int64_t tw_len, int s,
                            int log_chunk, void* stream) {
  return launch_stage(ntt_stage_kernel, x, out, n, tw, tw_len, s, log_chunk,
                      stream);
}

extern "C" int pk_butterfly(const uint32_t* x, uint32_t* out, int64_t n,
                            const uint32_t* tw, int64_t tw_len, int s,
                            int log_chunk, void* stream) {
  return launch_stage(butterfly_kernel, x, out, n, tw, tw_len, s, log_chunk,
                      stream);
}
