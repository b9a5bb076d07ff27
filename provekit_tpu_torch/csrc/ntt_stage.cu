// k consecutive constant-geometry (Pease) DIF radix-2 NTT stages in one
// launch, through shared memory, with the four-step NTT's gathers, cross
// twiddles and transpose folded into the loads and stores.
//
// Replaces two TPU kernels, which run one stage a call:
// provekit_tpu/ops/pallas_kernels.py:ntt_stage_pallas (body
// _ntt_stage_kernel) and pallas_kernels.py:butterfly_pallas (body
// _butterfly_kernel, the stages whose chunk lies outside 256..4096).  Stage s
// of a size-m transform batched over `chunk` minor columns maps (16, m chunk)
// to (16, m chunk): for step j < m / 2, with a_j = row j and b_j = row
// m/2 + j of the (m, chunk) view,
//   out row 2j     = a_j + b_j
//   out row 2j + 1 = (a_j - b_j) * w^((j >> s) << s)
// (w of order m, tw the undecimated (16, m/2) table of w^e in Montgomery
// form).  Row i goes to row rotl(i) (log m bits), so k stages s0 .. s0+k-1
// mix exactly the 2^k rows h 2^(L-k) + low, h < 2^k, that share their low
// L - k bits (L = log m), and leave row h 2^(L-k) + low at row low 2^k + h.
// Stage s0 + t is then a butterfly on bit k-1-t of h, whose twiddle exponent
// is ((h mod 2^(k-1-t)) << (L-k+t)) + (((low >> s0) << s0) << t): the bits
// of h above bit k-1-t leave j, and the low bits of j stay below 2^s.
//
// One CTA takes a tile of 2^k rows h, 2^log_g consecutive values of low and
// 2^log_c consecutive columns.  It reads each element once into dynamic
// shared memory as 8 x 32-bit limbs (32 bytes an element, half the 64-byte
// plane layout; limb-major, so neighbouring threads hit neighbouring banks),
// runs the k butterfly levels there, and writes each element once, to the
// row the k stages give it.  A thread takes two levels a round trip through
// shared memory (the four elements of two adjacent bits of h, in registers;
// one __syncthreads a pair of levels), and an odd k's last level alone.  A twiddle of exponent 0 is the Montgomery one and its product is
// skipped.
//
// Loads and stores (flags):
// * planes in: the port's (16, in_len) digit planes, row-major (m, chunk),
//   read as zero at flat index >= in_len (rs_encode's padding);
// * packed in/out: (n, 8) limbs an element (32 bytes, one sector), the
//   layout between the passes of one transform;
// * transposed in: element (row, col) read at col m + row (phase 2 of the
//   four-step reads phase 1's (n1, n2) output as its (n2, n1) view);
// * bitrev out: row q is stored at row bitrev_L(q) (the last pass of a
//   phase: the gather of the DIF order);
// * packed twiddles: tw as (tw_len, 8) limbs, one 32-byte load a twiddle
//   (the passes of a transform; ntt_stage's one-stage launches read the
//   (16, m/2) planes);
// * cross: the stored element (row, col) is multiplied by w_n^(row col),
//   w_n^e = hi[e >> a] lo[e mod 2^a] from two packed tables of about
//   sqrt(n) entries (the last pass of phase 1; the inverse's 1/n is folded
//   into hi, and a single-phase inverse has hi = [1/n], lo = [1]).
//
// What bounds it on the H100: the 32-bit multiply-adds of the products (264
// a Montgomery product, k/2 products an element, and 2 for the cross
// twiddle) against 64 to 128 bytes an element of HBM traffic: above k = 2
// the products take longer than the bytes.  The products run on PTX carry
// chains (sumcheck_round.cuh's seg::mul, skyscraper_field.cuh's adds).  All
// global offsets are 64-bit: a (16, 2^25) array has 2^29 words.
#include <cuda_runtime.h>

#include "field.cuh"
#include "sumcheck_round.cuh"

namespace {

using pk::Fe;

constexpr int kInPacked = 1;
constexpr int kInTransposed = 2;
constexpr int kOutPacked = 4;
constexpr int kOutBitrev = 8;
constexpr int kCross = 16;
constexpr int kTwPacked = 32;

constexpr int kMaxTileLog = 12;  // 4096 elements, 128 KiB of shared memory
constexpr int kTiledThreads = 256;
constexpr int kTiledMinBlocks = 3;
constexpr int kSingleThreads = 512;

struct PassArgs {
  const uint32_t* in;
  uint32_t* out;
  const uint32_t* tw;  // (16, tw_len) planes, or (tw_len, 8) packed
  int64_t tw_len;
  const uint32_t* cross_hi;  // (., 8) packed
  const uint32_t* cross_lo;  // (2^cross_log_lo, 8) packed
  int64_t in_len;
  int log_m, log_chunk, s0, k, log_g, log_c, flags, cross_log_lo;
};

__device__ __forceinline__ Fe load_packed(const uint32_t* base, int64_t e) {
  const uint4* p = reinterpret_cast<const uint4*>(base + 8 * e);
  const uint4 lo = __ldg(p);
  const uint4 hi = __ldg(p + 1);
  return Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

__device__ __forceinline__ void store_packed(uint32_t* base, int64_t e,
                                             const Fe& v) {
  uint4* p = reinterpret_cast<uint4*>(base + 8 * e);
  p[0] = make_uint4(v.v[0], v.v[1], v.v[2], v.v[3]);
  p[1] = make_uint4(v.v[4], v.v[5], v.v[6], v.v[7]);
}

__device__ __forceinline__ Fe load_planes(const uint32_t* base,
                                          int64_t stride, int64_t e) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t lo = __ldg(base + (2 * k) * stride + e);
    const uint32_t hi = __ldg(base + (2 * k + 1) * stride + e);
    r.v[k] = (lo & 0xFFFFu) | (hi << 16);
  }
  return r;
}

__device__ __forceinline__ Fe load_tile(const uint32_t* sm, int tile, int i) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = sm[k * tile + i];
  return r;
}

__device__ __forceinline__ void store_tile(uint32_t* sm, int tile, int i,
                                           const Fe& v) {
#pragma unroll
  for (int k = 0; k < 8; ++k) sm[k * tile + i] = v.v[k];
}

__device__ __forceinline__ Fe load_twiddle(const PassArgs& a, int64_t e) {
  return (a.flags & kTwPacked) ? load_packed(a.tw, e)
                               : load_planes(a.tw, a.tw_len, e);
}

// (x, y) <- (x + y, (x - y) w^e); w^0 is the Montgomery one
__device__ __forceinline__ void butterfly(const PassArgs& a, Fe& x, Fe& y,
                                          int64_t e) {
  const Fe u = seg::add(x, y);
  y = seg::sub(x, y);
  if (e != 0) y = seg::mul(y, load_twiddle(a, e));
  x = u;
}

template <int kThreads>
__device__ __forceinline__ void pass_body(const PassArgs& a) {
  extern __shared__ uint32_t sm[];
  const int L = a.log_m, k = a.k, lg = a.log_g, lc = a.log_c;
  const int lgc = lg + lc;
  const int tile = 1 << (k + lgc);
  const int gmask = (1 << lg) - 1, cmask = (1 << lc) - 1;
  const int64_t col_groups = (int64_t)1 << (a.log_chunk - lc);
  const int64_t cg = (int64_t)blockIdx.x & (col_groups - 1);
  const int64_t low0 = ((int64_t)blockIdx.x >> (a.log_chunk - lc)) << lg;
  const int64_t col0 = cg << lc;

  // load: neighbouring threads take neighbouring addresses (columns, or
  // rows for a transposed load)
  for (int i = threadIdx.x; i < tile; i += kThreads) {
    int h, g, c;
    if (a.flags & kInTransposed) {
      g = i & gmask;
      c = (i >> lg) & cmask;
    } else {
      c = i & cmask;
      g = (i >> lc) & gmask;
    }
    h = i >> lgc;
    const int64_t row = ((int64_t)h << (L - k)) | (low0 + g);
    const int64_t col = col0 + c;
    Fe v;
    if (a.flags & kInPacked) {
      v = load_packed(a.in, (a.flags & kInTransposed)
                                ? (col << L) | row
                                : (row << a.log_chunk) | col);
    } else {
      const int64_t e = (row << a.log_chunk) | col;
      if (e < a.in_len) {
        v = load_planes(a.in, a.in_len, e);
      } else {
#pragma unroll
        for (int w = 0; w < 8; ++w) v.v[w] = 0;
      }
    }
    store_tile(sm, tile, (h << lgc) | (g << lc) | c, v);
  }
  __syncthreads();

  // k butterfly levels; level t is stage s0 + t, a butterfly on bit k-1-t
  // of h with twiddle exponent ((h mod 2^(k-1-t)) << (L-k+t)) +
  // (((low >> s0) << s0) << t)
  // Levels t and t+1 (bits b + 1 and b of h) run on the four elements
  // h = base | j << b, j < 4, of a thread: level t pairs (0, 2) and (1, 3),
  // level t+1 pairs (0, 1) and (2, 3), whose exponents share h mod 2^b.
  int t = 0;
  for (; t + 1 < k; t += 2) {
    const int b = k - 2 - t;
    for (int q = threadIdx.x; q < tile / 4; q += kThreads) {
      const int gc = q & ((1 << lgc) - 1);
      const int hq = q >> lgc;
      const int hm = hq & ((1 << b) - 1);
      const int base = ((hq >> b) << (b + 2)) | hm;
      const int64_t lterm = ((low0 + (gc >> lc)) >> a.s0) << a.s0;
      const int64_t e0 = ((int64_t)hm << (L - k + t)) | (lterm << t);
      const int64_t e1 = ((int64_t)(hm | (1 << b)) << (L - k + t))
                         | (lterm << t);
      const int64_t e2 = ((int64_t)hm << (L - k + t + 1)) | (lterm << (t + 1));
      Fe x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = load_tile(sm, tile, ((base | (j << b)) << lgc) | gc);
      }
      butterfly(a, x[0], x[2], e0);
      butterfly(a, x[1], x[3], e1);
      butterfly(a, x[0], x[1], e2);
      butterfly(a, x[2], x[3], e2);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        store_tile(sm, tile, ((base | (j << b)) << lgc) | gc, x[j]);
      }
    }
    __syncthreads();
  }
  // an odd k's last level alone
  for (; t < k; ++t) {
    const int bit = k - 1 - t;
    for (int q = threadIdx.x; q < tile / 2; q += kThreads) {
      const int gc = q & ((1 << lgc) - 1);
      const int hb = q >> lgc;
      const int hm = hb & ((1 << bit) - 1);
      const int ha = ((hb >> bit) << (bit + 1)) | hm;
      const int ia = (ha << lgc) | gc;
      const int ib = ((ha | (1 << bit)) << lgc) | gc;
      const int64_t lterm = ((low0 + (gc >> lc)) >> a.s0) << a.s0;
      Fe x = load_tile(sm, tile, ia);
      Fe y = load_tile(sm, tile, ib);
      butterfly(a, x, y, ((int64_t)hm << (L - k + t)) | (lterm << t));
      store_tile(sm, tile, ia, x);
      store_tile(sm, tile, ib, y);
    }
    __syncthreads();
  }

  // store: element (h, g, c) is at row q = low 2^k + h
  const int64_t n = (int64_t)1 << (L + a.log_chunk);
  for (int i = threadIdx.x; i < tile; i += kThreads) {
    const int c = i & cmask;
    const int h = (i >> lc) & ((1 << k) - 1);
    const int g = i >> (lc + k);
    Fe v = load_tile(sm, tile, (h << lgc) | (g << lc) | c);
    const int64_t q = ((low0 + g) << k) | h;
    const int64_t row = (a.flags & kOutBitrev)
        ? (int64_t)(__brev((uint32_t)q) >> (32 - L)) : q;
    const int64_t col = col0 + c;
    if (a.flags & kCross) {
      const int64_t e = row * col;
      const Fe f = seg::mul(load_packed(a.cross_hi, e >> a.cross_log_lo),
                            load_packed(a.cross_lo,
                                        e & ((1ll << a.cross_log_lo) - 1)));
      v = seg::mul(v, f);
    }
    const int64_t o = (row << a.log_chunk) | col;
    if (a.flags & kOutPacked) {
      store_packed(a.out, o, v);
    } else {
      pk::store(a.out, n, o, v);
    }
  }
}

// kRoute 0 is K3's (ntt_stage_pallas), 1 K2's (butterfly_pallas): the same
// body, two names in a profile.  Tiled passes run kTiledThreads threads (at
// least kTiledMinBlocks CTAs an SM by registers; a 2^11-element tile's 64
// KiB of shared memory allows three); a transform of at most 2^12
// elements, one tile, runs kSingleThreads.
template <int kRoute, int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ntt_pass_kernel(PassArgs a) {
  pass_body<kThreads>(a);
}

template <int kRoute, int kThreads, int kMinBlocks>
int launch(const PassArgs& a, int64_t grid, int tile, cudaStream_t stream) {
  // the shared-memory opt-in holds for the current device only: set once a
  // device (a race sets it twice, which is harmless)
  constexpr int kMaxDevices = 64;
  static bool opted_in[kMaxDevices];
  auto kernel = ntt_pass_kernel<kRoute, kThreads, kMinBlocks>;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               32 << kMaxTileLog);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    }
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  kernel<<<(unsigned)grid, kThreads, (size_t)tile * 32, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int kRoute>
int launch_route(const PassArgs& a, int64_t grid, int tile,
                 cudaStream_t stream) {
  if (grid == 1) {
    return launch<kRoute, kSingleThreads, 1>(a, grid, tile, stream);
  }
  return launch<kRoute, kTiledThreads, kTiledMinBlocks>(a, grid, tile,
                                                       stream);
}

}  // namespace

// One pass: stages s0 .. s0+k-1 of a size-2^log_m transform batched over
// 2^log_chunk columns, tiles of 2^(k + log_g + log_c) elements; route 0
// (K3's) or 1 (K2's).  Returns a CUDA error (cudaErrorInvalidValue for a
// geometry the kernel does not take).
extern "C" int pk_ntt_pass(const uint32_t* in, uint32_t* out,
                           const uint32_t* tw, int64_t tw_len,
                           const uint32_t* cross_hi, const uint32_t* cross_lo,
                           int64_t in_len, int log_m, int log_chunk, int s0,
                           int k, int log_g, int log_c, int flags,
                           int cross_log_lo, int route, void* stream) {
  const int log_tile = k + log_g + log_c;
  if (k < 1 || s0 < 0 || s0 + k > log_m || log_g < 0 || log_c < 0
      || log_g > log_m - k || log_c > log_chunk || log_tile > kMaxTileLog
      || log_m + log_chunk > 40 || (route != 0 && route != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const PassArgs a{in, out, tw, tw_len, cross_hi, cross_lo, in_len,
                   log_m, log_chunk, s0, k, log_g, log_c, flags, cross_log_lo};
  const int64_t grid = (int64_t)1 << (log_m + log_chunk - log_tile);
  const int tile = 1 << log_tile;
  cudaStream_t s = (cudaStream_t)stream;
  return route == 0 ? launch_route<0>(a, grid, tile, s)
                    : launch_route<1>(a, grid, tile, s);
}
