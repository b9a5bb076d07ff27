// The earlier design of csrc/mont_mul_mma.cu (K6), kept as the yardstick
// of experiments/mxu_trace.py, which builds it (with and without
// -DPK_MMA_TRACE) beside the kernel and times and traces both in one run.
// Nothing else builds or calls it.
//
// Batched BN254-Fr Montgomery product with the two constant-operand digit
// convolutions on the tensor cores.
//
// Replaced the TPU kernel scripts/mxu_mont_experiment.py:mont_mul_mxu_pallas
// (body _mont_mul_mxu_kernel, variant D of docs/MXU_MONT.md): the same
// function as mont_mul.cu, a * b * 2^-256 mod P, computed as
//   T = a * b                          (512 bits, on the CUDA cores)
//   m = T_lo * N' mod 2^256            (N' = -P^-1 mod 2^256)
//   r = (T + m * P) >> 256, minus P once if r >= P.
// A digit convolution with a constant is a product with a band matrix
// B[k][i] = digit_{k-i}(c), so over 8-bit digits the two constant products
// are exact integer matrix products: m's 32 columns = BNP (32 x 32) times
// the 32 digits of T_lo, and m * P's 64 columns = BP (64 x 32) times the 32
// digits of m.  Each column sum is below 32 * 255^2 < 2^21.
//
// Tensor cores: mma.sync m16n8k32 with u8 inputs and s32 sums, written in
// the kernel as PTX.  The band matrix is operand A (16 columns of the
// convolution by 32 input digits per instruction) and eight elements'
// digits are operand B (32 digits by 8 elements), so a warp of 32 elements
// runs 8 instructions for m and 16 for m * P.  The band matrices are built
// on the host from the field constants (experiments/mxu_mont.py), copied to
// shared memory once per block, and each thread keeps its A fragments in
// registers.  Digits go to the tensor-core layout and column sums come back
// through a per-warp staging area in shared memory; each thread then runs
// the carry chains of its own element on the CUDA cores.
//
// What bounds it on the H100: memory, as for mont_mul.cu (2 x 64 bytes in,
// 64 bytes out per element).  The tensor-core work is (32 + 64) x 32 u8
// multiply-adds per element, 12.9 G operations at 2^21 elements: 6.5 us at
// the card's 1,979 TOP/s for int8.
#include <cuda_runtime.h>

#include "field.cuh"
#include "mma_trace.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kDigitWords = 9;   // 8 words of digits + 1 of padding
constexpr int kColStride = 65;   // 64 column sums + 1 of padding

// D = A (16 x 32, u8, row-major) * B (32 x 8, u8, column-major), s32 sums.
__device__ __forceinline__ void mma_u8(const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1, int (&d)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0), "r"(0), "r"(0), "r"(0));
}

// A fragment of rows [row0, row0 + 16) of a band matrix stored row-major as
// 32 bytes (8 words) a row: lane (g, q) = (lane / 4, lane % 4) holds bytes
// 4q..4q+3 and 16+4q..16+4q+3 of rows row0+g and row0+g+8.
__device__ __forceinline__ void load_a(const uint32_t* band, int row0, int g,
                                       int q, uint32_t (&a)[4]) {
  a[0] = band[(row0 + g) * 8 + q];
  a[1] = band[(row0 + g + 8) * 8 + q];
  a[2] = band[(row0 + g) * 8 + 4 + q];
  a[3] = band[(row0 + g + 8) * 8 + 4 + q];
}

// Column sums of one band product for the warp's 32 elements.  digits: 32
// rows of kDigitWords words (the 32 bytes of each element); cols: 32 rows
// of kColStride ints, row = element, column = convolution column.
template <int kTiles>
__device__ __forceinline__ void band_product(const uint32_t (&a)[kTiles][4],
                                             const uint32_t* digits,
                                             int* cols, int g, int q) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    int e = nt * 8 + g;
    uint32_t b0 = digits[e * kDigitWords + q];
    uint32_t b1 = digits[e * kDigitWords + 4 + q];
#pragma unroll
    for (int mt = 0; mt < kTiles; ++mt) {
      int d[4];
      mma_u8(a[mt], b0, b1, d);
      // d: rows mt*16 + g (+8) = columns, cols nt*8 + 2q (+1) = elements
      int col = mt * 16 + g;
      int el = nt * 8 + 2 * q;
      cols[el * kColStride + col] = d[0];
      cols[(el + 1) * kColStride + col] = d[1];
      cols[el * kColStride + col + 8] = d[2];
      cols[(el + 1) * kColStride + col + 8] = d[3];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mont_mul_mma_kernel(const uint32_t* a_planes, const uint32_t* b_planes,
                    const uint32_t* bands, uint32_t* out, int64_t n) {
  TRACE_DECL
  // bands: BNP (32 rows) then BP (64 rows), 8 words a row
  __shared__ uint32_t band_s[96 * 8];
  __shared__ uint32_t digit_s[kWarps][32 * kDigitWords];
  __shared__ int col_s[kWarps][32 * kColStride];
  for (int i = threadIdx.x; i < 96 * 8; i += kThreads) band_s[i] = bands[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  uint32_t a_np[2][4], a_p[4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) load_a(band_s, mt * 16, g, q, a_np[mt]);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) load_a(band_s + 32 * 8, mt * 16, g, q,
                                        a_p[mt]);

  TRACE_MARK(1)
  // every lane takes part in mma.sync: lanes past n work on zeros
  int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = e < n;
  pk::Fe x{}, y{};
  if (live) {
    x = pk::load(pk::PlaneView{a_planes, n, 1}, e);
    y = pk::load(pk::PlaneView{b_planes, n, 1}, e);
  }
#ifdef PK_MMA_TRACE
  {  // wait for the loads before the mark
    uint32_t dep = 0;
    for (int k = 0; k < 8; ++k) dep ^= x.v[k] ^ y.v[k];
    asm volatile("mov.b32 %0, %0;" : "+r"(dep));
  }
#endif
  TRACE_MARK(0)

  // T = x * y on the CUDA cores (16 x 32-bit limbs)
  uint32_t t[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)x.v[j] * y.v[i] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  TRACE_MARK(2)

  uint32_t* digits = digit_s[warp];
  int* cols = col_s[warp];

  // m = T_lo * N' mod 2^256: 32 columns of 8-bit weight
#pragma unroll
  for (int k = 0; k < 8; ++k) digits[lane * kDigitWords + k] = t[k];
  __syncwarp();
  band_product<2>(a_np, digits, cols, g, q);
  __syncwarp();
  uint32_t m[8];
  {
    uint64_t carry = 0;
    const int* c = cols + lane * kColStride;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint64_t acc = carry + (uint64_t)c[4 * k] +
                     ((uint64_t)c[4 * k + 1] << 8) +
                     ((uint64_t)c[4 * k + 2] << 16) +
                     ((uint64_t)c[4 * k + 3] << 24);
      m[k] = (uint32_t)acc;
      carry = acc >> 32;
    }
  }
  TRACE_MARK(3)
  __syncwarp();

  // m * P: 64 columns of 8-bit weight, added to T
#pragma unroll
  for (int k = 0; k < 8; ++k) digits[lane * kDigitWords + k] = m[k];
  __syncwarp();
  band_product<4>(a_p, digits, cols, g, q);
  __syncwarp();
  pk::Fe r;
  uint32_t top;
  {
    uint64_t carry = 0;
    const int* c = cols + lane * kColStride;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      uint64_t acc = carry + t[k] + (uint64_t)c[4 * k] +
                     ((uint64_t)c[4 * k + 1] << 8) +
                     ((uint64_t)c[4 * k + 2] << 16) +
                     ((uint64_t)c[4 * k + 3] << 24);
      if (k >= 8) r.v[k - 8] = (uint32_t)acc;
      carry = acc >> 32;
    }
    top = (uint32_t)carry;
  }
  TRACE_MARK(4)
  // (T + m P) / 2^256 < 2P: one conditional subtract
  if (live) pk::store(out, n, e, (top || pk::geq_p(r)) ? pk::sub_p(r) : r);
  TRACE_MARK(5)
  TRACE_COUNT
  TRACE_FLUSH
}

}  // namespace

// a, b, out: contiguous (16, n) planes; bands: the 96 x 32-byte band
// matrices on the device.
extern "C" int pk_mont_mul_mma_sync(const uint32_t* a, const uint32_t* b,
                                    const uint32_t* bands, uint32_t* out,
                                    int64_t n, void* stream) {
  if (n > 0) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    mont_mul_mma_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(a, b, bands, out, n);
  }
  return (int)cudaGetLastError();
}
