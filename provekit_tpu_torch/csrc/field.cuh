// BN254-Fr arithmetic shared by every kernel of provekit_tpu_torch.
//
// Storage layout (the port's public layout, inherited from the JAX package):
// a batch of field elements is 16 planes of 16-bit digits, plane i holding
// digit i of every element, each digit in its own 32-bit word.  A kernel
// reads digit pairs (2k, 2k+1) and packs them into one 32-bit limb in
// registers, so all arithmetic below runs on 8 x 32-bit little-endian limbs.
//
// A plane view is addressed as base[digit * row_stride + elem * col_stride]
// (strides in elements): neighbouring threads take neighbouring elements, so
// every plane load and store is coalesced when col_stride == 1, and a
// col_stride of 0 broadcasts one element to the whole batch.
//
// Constants: P and -P^-1 mod 2^32 (the low limb of -P^-1 mod 2^256) are the
// values of provekit_tpu/fields/vector.py (P_LIMBS, NPRIME256_LIMBS).
#pragma once
#include <cstdint>

namespace pk {

struct Fe {
  uint32_t v[8];
};

// static: every translation unit keeps its own copy (no -rdc linking).
static __constant__ uint32_t P[8] = {
    0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
// -P^-1 mod 2^32: the CIOS per-limb Montgomery factor.
constexpr uint32_t NPRIME0 = 0xefffffffu;

struct PlaneView {
  const uint32_t* base;
  int64_t row_stride;
  int64_t col_stride;
};

__device__ __forceinline__ Fe load(const PlaneView& x, int64_t e) {
  Fe r;
  const uint32_t* p = x.base + e * x.col_stride;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t lo = p[(2 * k) * x.row_stride];
    uint32_t hi = p[(2 * k + 1) * x.row_stride];
    r.v[k] = (lo & 0xFFFFu) | (hi << 16);
  }
  return r;
}

// Contiguous (16, n) output planes.
__device__ __forceinline__ void store(uint32_t* out, int64_t n, int64_t e,
                                      const Fe& a) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    out[(2 * k) * n + e] = a.v[k] & 0xFFFFu;
    out[(2 * k + 1) * n + e] = a.v[k] >> 16;
  }
}

// a >= P ?
__device__ __forceinline__ bool geq_p(const Fe& a) {
#pragma unroll
  for (int k = 7; k >= 0; --k) {
    if (a.v[k] != P[k]) return a.v[k] > P[k];
  }
  return true;
}

// a - P (mod 2^256).
__device__ __forceinline__ Fe sub_p(const Fe& a) {
  Fe r;
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint64_t d = (uint64_t)a.v[k] - P[k] - borrow;
    r.v[k] = (uint32_t)d;
    borrow = (d >> 63) & 1u;
  }
  return r;
}

// (a + b) mod P for canonical a, b.
__device__ __forceinline__ Fe add_mod(const Fe& a, const Fe& b) {
  Fe s;
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint64_t t = (uint64_t)a.v[k] + b.v[k] + carry;
    s.v[k] = (uint32_t)t;
    carry = t >> 32;
  }
  // a + b < 2P < 2^256: the carry out is always 0.
  return geq_p(s) ? sub_p(s) : s;
}

// (a - b) mod P for canonical a, b.
__device__ __forceinline__ Fe sub_mod(const Fe& a, const Fe& b) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint64_t t = (uint64_t)a.v[k] - b.v[k] - borrow;
    d.v[k] = (uint32_t)t;
    borrow = (t >> 63) & 1u;
  }
  if (borrow) {
    uint64_t carry = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint64_t t = (uint64_t)d.v[k] + P[k] + carry;
      d.v[k] = (uint32_t)t;
      carry = t >> 32;
    }
  }
  return d;
}

// Full reduction of any 256-bit value mod P.  P < 2^254, so the top two
// bits give q with q*P <= a; a - q*P < 2.3 P, and two conditional
// subtracts finish.  (Skyscraper's S-box output can be up to ~5P, so one
// conditional subtract would be wrong.)
__device__ __forceinline__ Fe reduce_full(const Fe& a) {
  uint32_t q = a.v[7] >> 30;
  Fe r;
  uint64_t carry = 0, borrow = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint64_t qp = (uint64_t)q * P[k] + carry;
    carry = qp >> 32;
    uint64_t t = (uint64_t)a.v[k] - (uint32_t)qp - borrow;
    r.v[k] = (uint32_t)t;
    borrow = (t >> 63) & 1u;
  }
  if (geq_p(r)) r = sub_p(r);
  if (geq_p(r)) r = sub_p(r);
  return r;
}

// Montgomery product a*b*2^-256 mod P (CIOS, 8 x 32-bit limbs).  Canonical
// output whenever a*b < 2^256 * P (any a < 2^256 against a canonical b).
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b) {
  uint32_t t[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);

    uint32_t m = t[0] * NPRIME0;
    c = ((uint64_t)m * P[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      uint64_t u = (uint64_t)m * P[j] + t[j] + c;
      t[j - 1] = (uint32_t)u;
      c = u >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = t[k];
  // result < 2P < 2^255, so t[8] == 0 and one conditional subtract suffices
  return (t[8] || geq_p(r)) ? sub_p(r) : r;
}

}  // namespace pk
