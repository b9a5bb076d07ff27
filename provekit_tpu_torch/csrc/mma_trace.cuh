// Phase clocks of the tensor-core Montgomery kernels, for
// experiments/mxu_trace.py.  With -DPK_MMA_TRACE, TRACE_MARK(k) adds the SM
// clocks since the last mark to phase k of the calling thread, and
// TRACE_FLUSH adds lane 0's sums of each warp to the device array
// mma_trace, which pk_mont_mul_mma_trace copies out and clears.  Phases:
// 0 waiting for a stage (in the earlier design: the loads), 1 reading it
// (the earlier design: copying the bands, building its fragments), 2 T,
// 3 the N' product and its carry, 4 the P product and its carry, 5 the
// stores, 6 the producer waiting for a free stage, 7 the producer filling
// it; 8 counts tiles (a warp's lane 0 counts each of its warpgroup's
// tiles, the earlier design each of its warp's 32 elements).  Without the
// macro every mark is empty.
#pragma once
#include <cuda_runtime.h>

#ifdef PK_MMA_TRACE
constexpr int TRACE_N = 9;
static __device__ unsigned long long mma_trace[TRACE_N];
#define TRACE_DECL \
  unsigned long long tr_acc[TRACE_N] = {}, tr_t = clock64();
#define TRACE_MARK(k)                          \
  {                                            \
    unsigned long long tr_now = clock64();     \
    tr_acc[k] += tr_now - tr_t;                \
    tr_t = tr_now;                             \
  }
#define TRACE_COUNT ++tr_acc[8];
#define TRACE_FLUSH                                     \
  if ((threadIdx.x & 31) == 0) {                        \
    for (int k = 0; k < TRACE_N; ++k)                   \
      atomicAdd(&mma_trace[k], tr_acc[k]);              \
  }

// The counters of the launches since the last call into host memory, then
// zeros.
extern "C" int pk_mont_mul_mma_trace(unsigned long long* host) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(host, mma_trace, sizeof(mma_trace));
  static const unsigned long long zeros[TRACE_N] = {};
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(mma_trace, zeros, sizeof(zeros));
  return (int)e;
}
#else
#define TRACE_DECL
#define TRACE_MARK(k)
#define TRACE_COUNT
#define TRACE_FLUSH
#endif
