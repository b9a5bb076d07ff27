// BN254 scalar-field arithmetic and the Skyscraper2 hash, host-native.
//
// The port's copy of the JAX package's native header: 4x64-limb Montgomery
// CIOS with __uint128, used by the witness solver and the host-side
// Fiat-Shamir sponge, Merkle path and proof-of-work checks (solver.cpp).  It
// differs from that header in one place: the inverse is batched divsteps on
// the limbs (a binary extended Euclid) instead of Fermat's a^(P-2); both
// give the same value.
#pragma once

#include <cstdint>
#include <cstring>

namespace pk {

using u64 = std::uint64_t;
using u128 = unsigned __int128;

struct Fe {  // little-endian 4x64 limbs, canonical (< P) unless noted
  u64 l[4];
  bool operator==(const Fe& o) const {
    return l[0] == o.l[0] && l[1] == o.l[1] && l[2] == o.l[2] && l[3] == o.l[3];
  }
};

// BN254 Fr modulus.
inline constexpr Fe P = {{0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
                          0xb85045b68181585dULL, 0x30644e72e131a029ULL}};
// -P^-1 mod 2^64
inline constexpr u64 NP0 = 0xc2e1f593efffffffULL;
// R^2 mod P (R = 2^256)
inline constexpr Fe R2 = {{0x1bb8e645ae216da7ULL, 0x53fe3ab1e35c59e3ULL,
                           0x8c49833d53bb8085ULL, 0x0216d0b17f4e44a5ULL}};
inline constexpr Fe ZERO = {{0, 0, 0, 0}};
inline constexpr Fe ONE = {{1, 0, 0, 0}};

inline bool geq(const Fe& a, const Fe& b) {
  for (int i = 3; i >= 0; --i) {
    if (a.l[i] != b.l[i]) return a.l[i] > b.l[i];
  }
  return true;
}

inline void sub_nob(Fe& a, const Fe& b) {  // a -= b, no borrow out
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.l[i] - b.l[i] - borrow;
    a.l[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

inline Fe add(const Fe& a, const Fe& b) {
  Fe r;
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.l[i] + b.l[i] + carry;
    r.l[i] = (u64)s;
    carry = s >> 64;
  }
  if (carry || geq(r, P)) sub_nob(r, P);
  return r;
}

inline Fe sub(const Fe& a, const Fe& b) {
  Fe r = a;
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.l[i] - b.l[i] - borrow;
    r.l[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  if (borrow) {
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
      u128 s = (u128)r.l[i] + P.l[i] + carry;
      r.l[i] = (u64)s;
      carry = s >> 64;
    }
  }
  return r;
}

inline Fe neg(const Fe& a) {
  if (a == ZERO) return a;
  Fe r = P;
  sub_nob(r, a);
  return r;
}

// Montgomery product: a * b * R^-1 mod P (CIOS).
inline Fe mont_mul(const Fe& a, const Fe& b) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)t[j] + (u128)a.l[i] * b.l[j] + carry;
      t[j] = (u64)s;
      carry = s >> 64;
    }
    u128 s = (u128)t[4] + carry;
    t[4] = (u64)s;
    t[5] = (u64)(s >> 64);

    u64 m = t[0] * NP0;
    carry = ((u128)t[0] + (u128)m * P.l[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 s2 = (u128)t[j] + (u128)m * P.l[j] + carry;
      t[j - 1] = (u64)s2;
      carry = s2 >> 64;
    }
    s = (u128)t[4] + carry;
    t[3] = (u64)s;
    t[4] = t[5] + (u64)(s >> 64);
    t[5] = 0;
  }
  Fe r = {{t[0], t[1], t[2], t[3]}};
  if (t[4] || geq(r, P)) sub_nob(r, P);
  return r;
}

// canonical x canonical -> canonical
inline Fe mul(const Fe& a, const Fe& b) { return mont_mul(mont_mul(a, b), R2); }
inline Fe sqr(const Fe& a) { return mul(a, a); }

// ---------------------------------------------------------------------------
// Inverse by batched divsteps (Bernstein-Yang safegcd, variable time).
//
// f = P, g = a, d = 0, e = 1 keep d * a == f and e * a == g (mod P).  A
// divstep halves g after making it even (g - f with f and g swapped when
// delta > 0, or g + f); 62 divsteps depend only on the low 62 bits of f
// and g, so each batch runs them on one 64-bit word each and collects the
// 2x2 matrix [u v; q r] with 2^62 (f', g') = (u f + v g, q f + r g), then
// applies it to the full f, g (signed, 256-bit two's complement: both stay
// within +-P) and to d, e mod P.  When g reaches 0, f = +-1 and
// a^-1 = +-d.

using i64 = std::int64_t;
using i128 = __int128;

// (u x + v y) / 2^62 for signed 256-bit x, y (two's complement), when the
// division is exact and the result fits.
inline Fe lin_shr62(i64 u, const Fe& x, i64 v, const Fe& y) {
  u64 t[5];
  i128 acc = 0;
  for (int i = 0; i < 4; ++i) {
    acc += (i128)u * (i128)x.l[i] + (i128)v * (i128)y.l[i];
    t[i] = (u64)acc;
    acc >>= 64;  // arithmetic: the signed carry
  }
  // the sign limbs of x and y weigh -2^256 each
  acc -= (i128)u * (i64)(x.l[3] >> 63) + (i128)v * (i64)(y.l[3] >> 63);
  t[4] = (u64)(i64)acc;
  Fe r;
  for (int i = 0; i < 4; ++i) r.l[i] = (t[i] >> 62) | (t[i + 1] << 2);
  return r;
}

// (u d + v e) / 2^62 mod P for canonical d, e and |u| + |v| <= 2^62.
inline Fe lin_div62_mod(i64 u, const Fe& d, i64 v, const Fe& e) {
  u64 t[5];
  i128 acc = 0;
  for (int i = 0; i < 4; ++i) {
    acc += (i128)u * (i128)d.l[i] + (i128)v * (i128)e.l[i];
    t[i] = (u64)acc;
    acc >>= 64;
  }
  i64 top = (i64)acc;  // |u d + v e| <= 2^62 P: it fits 5 limbs
  // add m P (m < 2^62) to clear the low 62 bits: the sum lies in
  // (-2^62 P, 2^63 P), the shifted result in (-P, 2P)
  u64 m = (t[0] * NP0) & ((1ULL << 62) - 1);
  u128 c = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)t[i] + (u128)m * P.l[i] + c;
    t[i] = (u64)s;
    c = s >> 64;
  }
  t[4] = (u64)(top + (i64)c);
  Fe r;
  for (int i = 0; i < 4; ++i) r.l[i] = (t[i] >> 62) | (t[i + 1] << 2);
  if (r.l[3] >> 63) {  // negative: add P
    u128 cc = 0;
    for (int i = 0; i < 4; ++i) {
      u128 s = (u128)r.l[i] + P.l[i] + cc;
      r.l[i] = (u64)s;
      cc = s >> 64;
    }
  } else if (geq(r, P)) {
    sub_nob(r, P);
  }
  return r;
}

// a^-1 mod P for canonical nonzero a: the same value as a^(P-2).  Zero has
// no inverse: it returns zero, and the solver refuses it before (code 5).
inline Fe inv(const Fe& a) {
  if (a == ZERO) return ZERO;
  Fe f = P, g = a, d = ZERO, e = ONE;
  i64 delta = 1;
  while (!(g == ZERO)) {
    u64 fw = f.l[0], gw = g.l[0];
    i64 u = 1, v = 0, q = 0, r = 1;
    for (int left = 62;;) {
      // the even steps at once: (f, g) <- (f, g / 2^z)
      int z = __builtin_ctzll(gw | (1ULL << left));
      gw >>= z;
      u = (i64)((u64)u << z);
      v = (i64)((u64)v << z);
      delta += z;
      left -= z;
      if (left == 0) break;
      if (delta > 0) {  // swap: (f, g) <- (g, (g - f) / 2)
        delta = 1 - delta;
        u64 fo = fw;
        fw = gw;
        gw = (gw - fo) >> 1;
        i64 nu = 2 * q, nv = 2 * r;
        q -= u;
        r -= v;
        u = nu;
        v = nv;
      } else {  // (f, g) <- (f, (g + f) / 2)
        delta = 1 + delta;
        gw = (gw + fw) >> 1;
        q += u;
        r += v;
        u *= 2;
        v *= 2;
      }
      --left;
    }
    Fe nf = lin_shr62(u, f, v, g), ng = lin_shr62(q, f, r, g);
    Fe nd = lin_div62_mod(u, d, v, e), ne = lin_div62_mod(q, d, r, e);
    f = nf;
    g = ng;
    d = nd;
    e = ne;
  }
  return (f == ONE) ? d : neg(d);  // f = -1 otherwise
}

inline Fe from_u64(u64 v) { return Fe{{v, 0, 0, 0}}; }

inline void to_bytes(const Fe& a, std::uint8_t out[32]) {
  std::memcpy(out, a.l, 32);  // little-endian host assumed
}

inline Fe from_bytes(const std::uint8_t in[32]) {
  Fe r;
  std::memcpy(r.l, in, 32);
  return r;
}

// ---------------------------------------------------------------------------
// Skyscraper2 (reference skyscraper/core/src/reference.rs:49-98)

inline constexpr u64 RC_U64[18][4] = {
    {0, 0, 0, 0},
    {0x903c4324270bd744ULL, 0x873125f708a7d269ULL, 0x081dd27906c83855ULL, 0x276b1823ea6d7667ULL},
    {0x7ac8edbb4b378d71ULL, 0xe29d79f3d99e2cb7ULL, 0x751417914c1a5a18ULL, 0x0cf02bd758a484a6ULL},
    {0xfa7adc6769e5bc36ULL, 0x1c3f8e297cca387dULL, 0x0eb7730d63481db0ULL, 0x25b0e03f18ede544ULL},
    {0x57847e652f03cfb7ULL, 0x33440b9668873404ULL, 0x955a32e849af80bcULL, 0x002882fcbe14ae70ULL},
    {0x979231396257d4d7ULL, 0x29989c3e1b37d3c1ULL, 0x12ef02b47f1277baULL, 0x039ad8571e2b7a9cULL},
    {0xb5b48465abbb7887ULL, 0xa72a6bc5e6ba2d2bULL, 0x4cd48043712f7b29ULL, 0x1142d5410fc1fc1aULL},
    {0x7ab2c156059075d3ULL, 0x17cb3594047999b2ULL, 0x44f2c93598f289f7ULL, 0x1d78439f69bc0becULL},
    {0x05d7a965138b8edbULL, 0x36ef35a3d55c48b1ULL, 0x8ddfb8a1ac6f1628ULL, 0x258588a508f4ff82ULL},
    {0x1596fb9afccb49e9ULL, 0x9a7367d69a09a95bULL, 0x9bc43f6984e4c157ULL, 0x13087879d2f514feULL},
    {0x295ccd233b4109faULL, 0xe1d72f89ed868012ULL, 0x2e9e1eea4bc88a8eULL, 0x17dadee898c45232ULL},
    {0x9a8590b4aa1f486fULL, 0xb75834b430e9130eULL, 0xb8e90b1034d5de31ULL, 0x295c6d1546e7f4a6ULL},
    {0x850adcb74c6eb892ULL, 0x07699ef305b92fc3ULL, 0x4ef96a2ba1720f2dULL, 0x1288ca0e1d3ed446ULL},
    {0x01960f9349d1b5eeULL, 0x8ccad30769371c69ULL, 0xe5c81e8991c98662ULL, 0x17563b4d1ae023f3ULL},
    {0x6ba01e9476b32917ULL, 0xa1cb0a3add977bc9ULL, 0x86815a945815f030ULL, 0x2869043be91a1eeaULL},
    {0x81776c885511d976ULL, 0x7475d34f47f414e7ULL, 0x5d090056095d96cfULL, 0x14941f0aff59e79aULL},
    {0xbc40b4fd8fc8c034ULL, 0xbb7142c3cce4fd48ULL, 0x318356758a39005aULL, 0x1ce337a190f4379fULL},
    {0, 0, 0, 0},
};

inline std::uint8_t sbox8(std::uint8_t v) {
  auto rotl = [](std::uint8_t b, int k) -> std::uint8_t {
    return (std::uint8_t)((b << k) | (b >> (8 - k)));
  };
  return rotl((std::uint8_t)(v ^ (rotl((std::uint8_t)~v, 1) & rotl(v, 2) & rotl(v, 3))), 1);
}

// Reduce an arbitrary 256-bit value mod P (quotient estimate from top bits).
inline Fe reduce256(const Fe& a) {
  Fe r = a;
  for (int i = 0; i < 6; ++i) {  // 2^256 < 5.3 * P: at most 5 subtracts
    if (!geq(r, P)) break;
    sub_nob(r, P);
  }
  return r;
}

inline Fe bar(const Fe& x) {
  std::uint8_t b[32];
  to_bytes(x, b);
  std::uint8_t rot[32];
  for (int i = 0; i < 32; ++i) rot[i] = b[(i + 16) & 31];
  for (int i = 0; i < 32; ++i) rot[i] = sbox8(rot[i]);
  return reduce256(from_bytes(rot));
}

inline void permute(Fe& l, Fe& r) {
  for (int k = 0; k < 18; ++k) {
    Fe f;
    if (k == 6 || k == 7 || k == 10 || k == 11) {
      f = bar(l);
    } else {
      f = mont_mul(l, l);  // x^2 * sigma^-1 with sigma = 2^256
    }
    Fe nl = add(r, f);
    Fe rc = {{RC_U64[k][0], RC_U64[k][1], RC_U64[k][2], RC_U64[k][3]}};
    if (!(rc == ZERO)) nl = add(nl, rc);
    r = l;
    l = nl;
  }
}

inline Fe compress(const Fe& l0, const Fe& r0) {
  Fe l = l0, r = r0;
  permute(l, r);
  return add(l, l0);
}

// Duplex sponge, N=2, R=1 (common/src/skyscraper/sponge.rs semantics).
struct Sponge {
  Fe state[2];
  int absorb_pos = 0;
  int squeeze_pos = 1;  // == RATE: next squeeze permutes

  void init(const std::uint8_t iv[32]) {
    state[0] = ZERO;
    Fe v = from_bytes(iv);
    state[1] = reduce256(v);
    absorb_pos = 0;
    squeeze_pos = 1;
  }
  void absorb(const Fe& u) {
    if (absorb_pos == 1) {
      permute(state[0], state[1]);
      absorb_pos = 0;
    }
    state[absorb_pos] = u;
    absorb_pos += 1;
    squeeze_pos = 1;
  }
  Fe squeeze() {
    if (squeeze_pos == 1) {
      permute(state[0], state[1]);
      squeeze_pos = 0;
      absorb_pos = 0;
    }
    return state[squeeze_pos++];
  }
};

}  // namespace pk
