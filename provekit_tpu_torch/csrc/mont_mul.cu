// Batched BN254-Fr Montgomery product on limb planes.
//
// Replaces the TPU kernel provekit_tpu/ops/pallas_kernels.py:mont_mul_pallas
// (body _mont_mul_kernel -> fields/vector.py:mont_mul_core, an SOS product
// over 16-bit digits kept in VMEM tiles).
//
// What bounds it on the H100: memory.  Each element reads 2 x 64 bytes of
// digit planes and writes 64 bytes against ~150 32-bit multiply-adds, far
// under the card's integer rate per byte of HBM traffic.  Design: one thread
// per element, CIOS on 8 x 32-bit limbs held in registers (digit pairs are
// packed on load), plane loads coalesced across the warp.  A column stride
// of 0 broadcasts a (16, 1) operand without materialising it.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

__global__ void mont_mul_kernel(pk::PlaneView a, pk::PlaneView b,
                                uint32_t* out, int64_t n) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  pk::store(out, n, e, pk::mont_mul(pk::load(a, e), pk::load(b, e)));
}

}  // namespace

extern "C" int pk_mont_mul(const uint32_t* a, int64_t a_rs, int64_t a_cs,
                           const uint32_t* b, int64_t b_rs, int64_t b_cs,
                           uint32_t* out, int64_t n, void* stream) {
  if (n > 0) {
    const int threads = 256;
    int64_t blocks = (n + threads - 1) / threads;
    mont_mul_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        pk::PlaneView{a, a_rs, a_cs}, pk::PlaneView{b, b_rs, b_cs}, out, n);
  }
  return (int)cudaGetLastError();
}
