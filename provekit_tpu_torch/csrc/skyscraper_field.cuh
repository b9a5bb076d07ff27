// Skyscraper's BN254-Fr ladder for Hopper (included by skyscraper.cu only).
//
// Values are 8 x 32-bit little-endian limbs in registers (pk::Fe).  Every
// multi-word add, subtract and multiply-add is a PTX carry chain in inline
// asm (add.cc/addc, sub.cc/subc, mad.lo.cc/madc.hi.cc), and every reduction
// is branch-free: the borrow of x - kP, spread to a mask, chooses between x
// and x - kP, so no compare exits early on the data and warps never diverge.
//
// Montgomery square (the 14 square steps of the ladder): the 28 cross
// products a_i a_j (i < j) once, doubled by a funnel shift, plus the 8
// diagonal products a_i^2: 36 limb products for T = a^2.  Each cross row
// runs as two carry chains over disjoint word pairs (the products of a_i
// with every other a_j), the chain ending at a_6 before the one ending at
// a_7, so each chain's carry lands in a word that holds at most a carry.
// The reduction works on the low half only:
//   T = T_hi 2^256 + T_lo,  REDC(T) = T_hi + (T_lo + m P) / 2^256,
// and (T_lo + m P) / 2^256 <= P since T_lo, m < 2^256.  Its 8 rows (64
// products with P, two chains a row, even then odd limbs of P) work on a
// window above which every word is still zero, so again no carry runs past
// the chain that made it.  For a < P, T_hi < P and the square is below 2P.
//
// Lazy reduction, one per step: the square stays below 2P (not reduced), so
// r + f + RC[k] < P + 2P + P = 4P < 2^256 (P < 2^254) and the step reduces
// its sum once, by 2P and then by P, each a conditional subtract.  Every
// value between steps (l, r), every input and output of `bar` and every
// kernel output is canonical.  `bar` keeps the SWAR S-box and reduce_full's
// two conditional subtracts (its S-box output reaches ~5P).
//
// Built without CUDA (a host C++ compiler, for the CPU tests of this
// arithmetic), the carry-chain helpers run in C on an emulated carry flag
// and count every carry that a chain's last instruction would drop, which
// the proofs above say never happens.
#pragma once
#include <cstdint>

#include "field.cuh"

#define SK_DEV __device__ __forceinline__

namespace sk {

using pk::Fe;

// -P^-1 mod 2^32
constexpr uint32_t NP0 = 0xefffffffu;

// limb k of M * P, M in {1, 2}
SK_DEV constexpr uint32_t mp_limb(int m, int k) {
  return m == 1 ? (k == 0 ? 0xf0000001u : k == 1 ? 0x43e1f593u
                   : k == 2 ? 0x79b97091u : k == 3 ? 0x2833e848u
                   : k == 4 ? 0x8181585du : k == 5 ? 0xb85045b6u
                   : k == 6 ? 0xe131a029u : 0x30644e72u)
                : (k == 0 ? 0xe0000002u : k == 1 ? 0x87c3eb27u
                   : k == 2 ? 0xf372e122u : k == 3 ? 0x5067d090u
                   : k == 4 ? 0x0302b0bau : k == 5 ? 0x70a08b6du
                   : k == 6 ? 0xc2634053u : 0x60c89ce5u);
}

#if defined(__CUDACC__)

SK_DEV uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
SK_DEV uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
SK_DEV uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
SK_DEV uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
SK_DEV uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
SK_DEV uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// all ones if the chain before it borrowed, else 0
SK_DEV uint32_t borrow_mask() {
  uint32_t r;
  asm volatile("subc.u32 %0, 0, 0;" : "=r"(r));
  return r;
}
SK_DEV uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
SK_DEV uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
SK_DEV uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
SK_DEV uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
SK_DEV uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
SK_DEV uint32_t mul_hi(uint32_t a, uint32_t b) { return __umulhi(a, b); }
// (hi:lo) << 1, high word
SK_DEV uint32_t shl1(uint32_t lo, uint32_t hi) {
  return __funnelshift_l(lo, hi, 1);
}

#else  // host build: the same chains on an emulated carry flag

inline uint32_t cf = 0;    // CC.CF: the carry of an add, the borrow of a sub
inline uint64_t lost = 0;  // carries and borrows a chain's end dropped

inline uint32_t set_cf(uint64_t s) {
  cf = (uint32_t)(s >> 32) & 1u;
  return (uint32_t)s;
}
inline uint32_t end_add(uint64_t s) {
  lost += s >> 32;
  return (uint32_t)s;
}
inline uint32_t add_cc(uint32_t a, uint32_t b) { return set_cf((uint64_t)a + b); }
inline uint32_t addc_cc(uint32_t a, uint32_t b) {
  return set_cf((uint64_t)a + b + cf);
}
inline uint32_t addc(uint32_t a, uint32_t b) {
  return end_add((uint64_t)a + b + cf);
}
inline uint32_t sub_cc(uint32_t a, uint32_t b) { return set_cf((uint64_t)a - b); }
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
  return set_cf((uint64_t)a - b - cf);
}
inline uint32_t subc(uint32_t a, uint32_t b) {
  uint64_t d = (uint64_t)a - b - cf;
  lost += (d >> 32) & 1u;
  return (uint32_t)d;
}
inline uint32_t borrow_mask() { return 0u - cf; }
inline uint32_t mul_hi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return set_cf((uint64_t)(a * b) + c);
}
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return set_cf((uint64_t)(a * b) + c + cf);
}
inline uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return set_cf((uint64_t)mul_hi(a, b) + c);
}
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return set_cf((uint64_t)mul_hi(a, b) + c + cf);
}
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  return end_add((uint64_t)mul_hi(a, b) + c + cf);
}
inline uint32_t shl1(uint32_t lo, uint32_t hi) {
  return (hi << 1) | (lo >> 31);
}

#endif

// s <- s - M P if s >= M P (branch-free).
template <int M>
SK_DEV void csub(uint32_t s[8]) {
  uint32_t d[8];
  d[0] = sub_cc(s[0], mp_limb(M, 0));
#pragma unroll
  for (int k = 1; k < 8; ++k) d[k] = subc_cc(s[k], mp_limb(M, k));
  const uint32_t keep = borrow_mask();  // s < M P
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = (s[k] & keep) | (d[k] & ~keep);
}

// (a + b) mod P for canonical a, b.
SK_DEV Fe add_mod(const Fe& a, const Fe& b) {
  Fe s;
  s.v[0] = add_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int k = 1; k < 7; ++k) s.v[k] = addc_cc(a.v[k], b.v[k]);
  s.v[7] = addc(a.v[7], b.v[7]);  // a + b < 2P < 2^256
  csub<1>(s.v);
  return s;
}

// a^2 / 2^256 mod P, below 2P, for a < P.
SK_DEV Fe sqr_lazy(const Fe& x) {
  const uint32_t* a = x.v;
  // cross products: c = sum_{i<j} a_i a_j 2^(32(i+j)), c[0] = 0
  uint32_t c[16];
#pragma unroll
  for (int w = 0; w < 16; ++w) c[w] = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
#pragma unroll
    for (int last = 6; last <= 7; ++last) {
      const int j0 = ((last - i - 1) & 1) ? i + 2 : i + 1;
      if (j0 > last) continue;
#pragma unroll
      for (int j = j0; j <= last; j += 2) {
        c[i + j] = j == j0 ? mad_lo_cc(a[i], a[j], c[i + j])
                           : madc_lo_cc(a[i], a[j], c[i + j]);
        c[i + j + 1] = madc_hi_cc(a[i], a[j], c[i + j + 1]);
      }
      c[i + last + 2] = addc(c[i + last + 2], 0);
    }
  }
  // t = 2c + sum a_i^2 2^(64 i)
  uint32_t t[16];
  t[0] = a[0] * a[0];
  t[1] = mad_hi_cc(a[0], a[0], c[1] << 1);
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    t[2 * i] = madc_lo_cc(a[i], a[i], shl1(c[2 * i - 1], c[2 * i]));
    t[2 * i + 1] = i < 7
        ? madc_hi_cc(a[i], a[i], shl1(c[2 * i], c[2 * i + 1]))
        : madc_hi(a[i], a[i], shl1(c[2 * i], c[2 * i + 1]));
  }
  // u = (t_lo + m P) / 2^256 <= P, rows on the window u[i .. i+9]
  uint32_t u[16];
#pragma unroll
  for (int w = 0; w < 16; ++w) u[w] = w < 8 ? t[w] : 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t m = u[i] * NP0;
    u[i] = mad_lo_cc(m, mp_limb(1, 0), u[i]);  // 0, and its carry
    u[i + 1] = madc_hi_cc(m, mp_limb(1, 0), u[i + 1]);
#pragma unroll
    for (int j = 2; j < 8; j += 2) {
      u[i + j] = madc_lo_cc(m, mp_limb(1, j), u[i + j]);
      u[i + j + 1] = madc_hi_cc(m, mp_limb(1, j), u[i + j + 1]);
    }
    u[i + 8] = addc(u[i + 8], 0);
    u[i + 1] = mad_lo_cc(m, mp_limb(1, 1), u[i + 1]);
    u[i + 2] = madc_hi_cc(m, mp_limb(1, 1), u[i + 2]);
#pragma unroll
    for (int j = 3; j < 7; j += 2) {
      u[i + j] = madc_lo_cc(m, mp_limb(1, j), u[i + j]);
      u[i + j + 1] = madc_hi_cc(m, mp_limb(1, j), u[i + j + 1]);
    }
    u[i + 7] = madc_lo_cc(m, mp_limb(1, 7), u[i + 7]);
    if (i < 7) {
      u[i + 8] = madc_hi_cc(m, mp_limb(1, 7), u[i + 8]);
      u[i + 9] = addc(u[i + 9], 0);
    } else {
      u[15] = madc_hi(m, mp_limb(1, 7), u[15]);  // (t_lo + m P)/2^256 <= P
    }
  }
  // + t_hi: below P + P
  Fe s;
  s.v[0] = add_cc(u[8], t[8]);
#pragma unroll
  for (int k = 1; k < 7; ++k) s.v[k] = addc_cc(u[8 + k], t[8 + k]);
  s.v[7] = addc(u[15], t[15]);
  return s;
}

// Rotate each of the four bytes of w left by k bits.
SK_DEV uint32_t rotl_bytes(uint32_t w, int k) {
  uint32_t low = ((1u << k) - 1u) * 0x01010101u;
  return ((w << k) & ~low) | ((w >> (8 - k)) & low);
}

// The Skyscraper S-box on four bytes at once:
// sbox(v) = rotl1(v ^ (rotl1(~v) & rotl2(v) & rotl3(v))).
SK_DEV uint32_t sbox4(uint32_t v) {
  uint32_t t = v ^ (rotl_bytes(~v, 1) & rotl_bytes(v, 2) & rotl_bytes(v, 3));
  return rotl_bytes(t, 1);
}

// bar: rotate the 32 bytes by 16, S-box every byte, reduce mod P (canonical).
SK_DEV Fe bar(const Fe& x) {
  Fe y;
#pragma unroll
  for (int k = 0; k < 8; ++k) y.v[k] = sbox4(x.v[(k + 4) & 7]);
  // y - q P with q = top two bits (q P <= y), then below 2.3 P
  const uint32_t q = y.v[7] >> 30;
  y.v[0] = sub_cc(y.v[0], q * mp_limb(1, 0));
#pragma unroll
  for (int k = 1; k < 7; ++k) y.v[k] = subc_cc(y.v[k], q * mp_limb(1, k));
  y.v[7] = subc(y.v[7], q * mp_limb(1, 7));
  // the high words of q P_k (q P_7 < 2^32)
  y.v[1] = sub_cc(y.v[1], mul_hi(q, mp_limb(1, 0)));
#pragma unroll
  for (int k = 2; k < 7; ++k) y.v[k] = subc_cc(y.v[k], mul_hi(q, mp_limb(1, k - 1)));
  y.v[7] = subc(y.v[7], mul_hi(q, mp_limb(1, 6)));
  csub<1>(y.v);
  csub<1>(y.v);
  return y;
}

// Step k of the ladder, (l, r) <- (r + f_k(l) + RC[k], l), written as
// acc <- acc + f_k(x) + RC[k] with acc holding r and x holding l: f_k is a
// Montgomery square, or `bar` on steps 6, 7, 10 and 11.  `rc(k, i)` gives
// limb i of round constant k.
template <class RC>
SK_DEV void step(int k, Fe& acc, const Fe& x, const RC& rc) {
  const bool is_bar = (k == 6) | (k == 7) | (k == 10) | (k == 11);
  const Fe f = is_bar ? bar(x) : sqr_lazy(x);
  uint32_t s[8];
  s[0] = add_cc(f.v[0], acc.v[0]);
#pragma unroll
  for (int i = 1; i < 7; ++i) s[i] = addc_cc(f.v[i], acc.v[i]);
  s[7] = addc(f.v[7], acc.v[7]);
  s[0] = add_cc(s[0], rc(k, 0));
#pragma unroll
  for (int i = 1; i < 7; ++i) s[i] = addc_cc(s[i], rc(k, i));
  s[7] = addc(s[7], rc(k, 7));  // below 4P < 2^256
  csub<2>(s);
  csub<1>(s);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc.v[i] = s[i];
}

// The 18-step ladder, two steps an iteration: the new l of an even step
// lands in r's registers and the next step's back in l's, so no step moves
// a value between registers.
template <class RC>
SK_DEV void ladder(Fe& l, Fe& r, const RC& rc) {
#pragma unroll 1
  for (int k = 0; k < 18; k += 2) {
    step(k, r, l, rc);
    step(k + 1, l, r, rc);
  }
}

// compress(l, r) = permute(l, r).left + l
template <class RC>
SK_DEV Fe compress(const Fe& l, const Fe& r, const RC& rc) {
  Fe a = l, b = r;
  ladder(a, b, rc);
  return sk::add_mod(a, l);
}

}  // namespace sk
