// BN254 curve arithmetic: G1/G2 fixed-base batches, Pippenger MSM, Fr NTT.
//
// The port's own copy of the JAX package's native/curve.cpp, built at first
// use by native/curve.py (g++, into build/provekit_tpu_torch/).
//
// Native engine behind recursion/groth16.py — the counterpart of the
// reference's gnark-crypto dependency (recursive-verifier/go.mod): the
// Groth16 trusted setup is a few million fixed-base scalar mults and the
// prover is three multi-scalar mults, which are hopeless in host Python at
// recursion-circuit sizes (~10^6 wires).  C ABI, loaded via ctypes.
//
// Conventions: scalars and field elements are 32-byte little-endian
// canonical; G1 affine = x||y (64 B), G2 affine = x.c0||x.c1||y.c0||y.c1
// (128 B); the point at infinity is all-zero (x=y=0 is never on either
// curve since b != 0).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

using u64 = std::uint64_t;
using u128 = unsigned __int128;
using u8 = std::uint8_t;

struct U256 {
  u64 l[4];
  bool operator==(const U256& o) const {
    return l[0] == o.l[0] && l[1] == o.l[1] && l[2] == o.l[2] && l[3] == o.l[3];
  }
  bool is_zero() const { return !(l[0] | l[1] | l[2] | l[3]); }
};

inline bool geq(const U256& a, const U256& b) {
  for (int i = 3; i >= 0; --i)
    if (a.l[i] != b.l[i]) return a.l[i] > b.l[i];
  return true;
}

// Montgomery field over a compile-time modulus.
template <const U256& MOD, u64 NP0, const U256& R2V, const U256& RONE>
struct Fp {
  U256 v;  // Montgomery form

  static Fp zero() { return Fp{{{0, 0, 0, 0}}}; }
  static Fp one() { return Fp{RONE}; }
  bool is_zero() const { return v.is_zero(); }
  bool operator==(const Fp& o) const { return v == o.v; }

  static void add_raw(U256& a, const U256& b) {
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
      u128 s = (u128)a.l[i] + b.l[i] + carry;
      a.l[i] = (u64)s;
      carry = s >> 64;
    }
    if (carry || geq(a, MOD)) sub_raw(a, MOD);
  }
  static void sub_raw(U256& a, const U256& b) {  // no borrow out
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
      u128 d = (u128)a.l[i] - b.l[i] - borrow;
      a.l[i] = (u64)d;
      borrow = (d >> 64) ? 1 : 0;
    }
  }

  Fp operator+(const Fp& o) const {
    Fp r = *this;
    add_raw(r.v, o.v);
    return r;
  }
  Fp operator-(const Fp& o) const {
    Fp r = *this;
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
      u128 d = (u128)r.v.l[i] - o.v.l[i] - borrow;
      r.v.l[i] = (u64)d;
      borrow = (d >> 64) ? 1 : 0;
    }
    if (borrow) {
      u128 carry = 0;
      for (int i = 0; i < 4; ++i) {
        u128 s = (u128)r.v.l[i] + MOD.l[i] + carry;
        r.v.l[i] = (u64)s;
        carry = s >> 64;
      }
    }
    return r;
  }
  Fp neg() const {
    if (is_zero()) return *this;
    Fp r{MOD};
    sub_raw(r.v, v);
    return r;
  }
  Fp dbl() const { return *this + *this; }

  Fp operator*(const Fp& o) const {  // CIOS Montgomery product
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
      u128 carry = 0;
      for (int j = 0; j < 4; ++j) {
        u128 s = (u128)t[j] + (u128)v.l[i] * o.v.l[j] + carry;
        t[j] = (u64)s;
        carry = s >> 64;
      }
      u128 s = (u128)t[4] + carry;
      t[4] = (u64)s;
      t[5] = (u64)(s >> 64);
      u64 m = t[0] * NP0;
      carry = ((u128)t[0] + (u128)m * MOD.l[0]) >> 64;
      for (int j = 1; j < 4; ++j) {
        u128 s2 = (u128)t[j] + (u128)m * MOD.l[j] + carry;
        t[j - 1] = (u64)s2;
        carry = s2 >> 64;
      }
      s = (u128)t[4] + carry;
      t[3] = (u64)s;
      t[4] = t[5] + (u64)(s >> 64);
      t[5] = 0;
    }
    Fp r{{{t[0], t[1], t[2], t[3]}}};
    if (t[4] || geq(r.v, MOD)) sub_raw(r.v, MOD);
    return r;
  }
  Fp sqr() const { return *this * *this; }

  Fp pow(const U256& e) const {
    Fp acc = one();
    Fp base = *this;
    for (int i = 0; i < 4; ++i) {
      u64 w = e.l[i];
      for (int bit = 0; bit < 64; ++bit) {
        if ((w >> bit) & 1) acc = acc * base;
        base = base.sqr();
      }
    }
    return acc;
  }
  Fp inv() const {  // Fermat
    U256 e = MOD;
    e.l[0] -= 2;  // odd modulus, no borrow
    return pow(e);
  }

  static Fp from_canonical(const U256& c) { return Fp{c} * Fp{R2V}; }
  U256 to_canonical() const {
    Fp r = *this * Fp{{{1, 0, 0, 0}}};
    return r.v;
  }
};

// --- BN254 constants --------------------------------------------------------

// base field q
constexpr U256 Q_MOD = {{0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
                         0xb85045b68181585dULL, 0x30644e72e131a029ULL}};
constexpr u64 Q_NP0 = 0x87d20782e4866389ULL;
constexpr U256 Q_R2 = {{0xf32cfc5b538afa89ULL, 0xb5e71911d44501fbULL,
                        0x47ab1eff0a417ff6ULL, 0x06d89f71cab8351fULL}};
// R mod q (Montgomery one)
constexpr U256 Q_RONE = {{0xd35d438dc58f0d9dULL, 0x0a78eb28f5c70b3dULL,
                          0x666ea36f7879462cULL, 0x0e0a77c19a07df2fULL}};

// scalar field r
constexpr U256 R_MOD = {{0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
                         0xb85045b68181585dULL, 0x30644e72e131a029ULL}};
constexpr u64 R_NP0 = 0xc2e1f593efffffffULL;
constexpr U256 R_R2 = {{0x1bb8e645ae216da7ULL, 0x53fe3ab1e35c59e3ULL,
                        0x8c49833d53bb8085ULL, 0x0216d0b17f4e44a5ULL}};
// R mod r
constexpr U256 R_RONE = {{0xac96341c4ffffffbULL, 0x36fc76959f60cd29ULL,
                          0x666ea36f7879462eULL, 0x0e0a77c19a07df2fULL}};

using Fq = Fp<Q_MOD, Q_NP0, Q_R2, Q_RONE>;
using Fr = Fp<R_MOD, R_NP0, R_R2, R_RONE>;

// --- Fq2 = Fq[i]/(i^2+1) -----------------------------------------------------

struct Fq2 {
  Fq c0, c1;
  static Fq2 zero() { return {Fq::zero(), Fq::zero()}; }
  static Fq2 one() { return {Fq::one(), Fq::zero()}; }
  bool is_zero() const { return c0.is_zero() && c1.is_zero(); }
  bool operator==(const Fq2& o) const { return c0 == o.c0 && c1 == o.c1; }
  Fq2 operator+(const Fq2& o) const { return {c0 + o.c0, c1 + o.c1}; }
  Fq2 operator-(const Fq2& o) const { return {c0 - o.c0, c1 - o.c1}; }
  Fq2 neg() const { return {c0.neg(), c1.neg()}; }
  Fq2 dbl() const { return {c0.dbl(), c1.dbl()}; }
  Fq2 operator*(const Fq2& o) const {  // Karatsuba
    Fq a = c0 * o.c0;
    Fq b = c1 * o.c1;
    Fq s = (c0 + c1) * (o.c0 + o.c1);
    return {a - b, s - a - b};
  }
  Fq2 sqr() const {
    Fq a = c0 + c1;
    Fq b = c0 - c1;
    Fq c = c0 * c1;
    return {a * b, c.dbl()};
  }
  Fq2 inv() const {
    Fq norm = c0.sqr() + c1.sqr();
    Fq ni = norm.inv();
    return {c0 * ni, (c1 * ni).neg()};
  }
};

// --- Jacobian point ops, generic over the coordinate field -------------------

template <class F>
struct Jac {
  F x, y, z;  // z == 0 -> infinity
  static Jac infinity() { return {F::zero(), F::one(), F::zero()}; }
  bool is_inf() const { return z.is_zero(); }
};

template <class F>
Jac<F> jac_dbl(const Jac<F>& p) {
  if (p.is_inf()) return p;
  F a = p.x.sqr();
  F b = p.y.sqr();
  F c = b.sqr();
  F t = (p.x + b).sqr() - a - c;
  F d = t.dbl();
  F e = a.dbl() + a;
  F f = e.sqr();
  Jac<F> r;
  r.x = f - d.dbl();
  r.y = e * (d - r.x) - c.dbl().dbl().dbl();
  r.z = (p.y * p.z).dbl();
  return r;
}

template <class F>
Jac<F> jac_add(const Jac<F>& p, const Jac<F>& q) {
  if (p.is_inf()) return q;
  if (q.is_inf()) return p;
  F z1z1 = p.z.sqr();
  F z2z2 = q.z.sqr();
  F u1 = p.x * z2z2;
  F u2 = q.x * z1z1;
  F s1 = p.y * q.z * z2z2;
  F s2 = q.y * p.z * z1z1;
  F h = u2 - u1;
  F rr = (s2 - s1).dbl();
  if (h.is_zero()) {
    if (rr.is_zero()) return jac_dbl(p);
    return Jac<F>::infinity();
  }
  F i = h.dbl().sqr();
  F j = h * i;
  F v = u1 * i;
  Jac<F> r;
  r.x = rr.sqr() - j - v.dbl();
  r.y = rr * (v - r.x) - (s1 * j).dbl();
  r.z = ((p.z + q.z).sqr() - z1z1 - z2z2) * h;
  return r;
}

// mixed add: q affine (z=1); (ax, ay) must not be infinity
template <class F>
Jac<F> jac_madd(const Jac<F>& p, const F& ax, const F& ay) {
  if (p.is_inf()) return {ax, ay, F::one()};
  F z1z1 = p.z.sqr();
  F u2 = ax * z1z1;
  F s2 = ay * p.z * z1z1;
  F h = u2 - p.x;
  F rr = (s2 - p.y).dbl();
  if (h.is_zero()) {
    if (rr.is_zero()) return jac_dbl(p);
    return Jac<F>::infinity();
  }
  F hh = h.sqr();
  F i = hh.dbl().dbl();
  F j = h * i;
  F v = p.x * i;
  Jac<F> r;
  r.x = rr.sqr() - j - v.dbl();
  r.y = rr * (v - r.x) - (p.y * j).dbl();
  r.z = (p.z + h).sqr() - z1z1 - hh;
  return r;
}

// batch-normalize jacobian -> affine (Montgomery batch inversion)
template <class F>
void jac_normalize(const std::vector<Jac<F>>& pts, std::vector<F>& xs,
                   std::vector<F>& ys, std::vector<bool>& inf) {
  size_t n = pts.size();
  xs.resize(n);
  ys.resize(n);
  inf.resize(n);
  std::vector<F> prefix(n);
  F acc = F::one();
  for (size_t i = 0; i < n; ++i) {
    prefix[i] = acc;
    if (!pts[i].is_inf()) acc = acc * pts[i].z;
  }
  F ainv = acc.inv();
  for (size_t i = n; i-- > 0;) {
    inf[i] = pts[i].is_inf();
    if (inf[i]) {
      xs[i] = F::zero();
      ys[i] = F::zero();
      continue;
    }
    F zinv = ainv * prefix[i];
    ainv = ainv * pts[i].z;
    F zi2 = zinv.sqr();
    xs[i] = pts[i].x * zi2;
    ys[i] = pts[i].y * zi2 * zinv;
  }
}

// --- marshalling --------------------------------------------------------------

inline U256 read_u256(const u8* p) {
  U256 v;
  std::memcpy(v.l, p, 32);
  return v;
}
inline void write_u256(u8* p, const U256& v) { std::memcpy(p, v.l, 32); }

inline Fq read_fq(const u8* p) { return Fq::from_canonical(read_u256(p)); }
inline void write_fq(u8* p, const Fq& v) { write_u256(p, v.to_canonical()); }
inline Fq2 read_fq2(const u8* p) { return {read_fq(p), read_fq(p + 32)}; }
inline void write_fq2(u8* p, const Fq2& v) {
  write_fq(p, v.c0);
  write_fq(p + 32, v.c1);
}

struct G1Codec {
  using F = Fq;
  static constexpr size_t SIZE = 64;
  static Jac<Fq> read(const u8* p) {
    U256 x = read_u256(p), y = read_u256(p + 32);
    if (x.is_zero() && y.is_zero()) return Jac<Fq>::infinity();
    return {Fq::from_canonical(x), Fq::from_canonical(y), Fq::one()};
  }
  static void write(u8* p, const Fq& x, const Fq& y, bool inf) {
    if (inf) {
      std::memset(p, 0, SIZE);
      return;
    }
    write_fq(p, x);
    write_fq(p + 32, y);
  }
};

struct G2Codec {
  using F = Fq2;
  static constexpr size_t SIZE = 128;
  static Jac<Fq2> read(const u8* p) {
    bool inf = true;
    for (size_t i = 0; i < SIZE; ++i)
      if (p[i]) {
        inf = false;
        break;
      }
    if (inf) return Jac<Fq2>::infinity();
    return {read_fq2(p), read_fq2(p + 64), Fq2::one()};
  }
  static void write(u8* p, const Fq2& x, const Fq2& y, bool inf) {
    if (inf) {
      std::memset(p, 0, SIZE);
      return;
    }
    write_fq2(p, x);
    write_fq2(p + 64, y);
  }
};

inline unsigned nthreads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? n : 4;
}

// --- fixed-base batch multiplication -------------------------------------------
//
// 8-bit windows over the 256-bit scalar: 32 tables of 255 affine points
// (table[w][d] = d * 2^(8w) * B), built once per call with one batch
// normalization; each scalar then costs <= 32 mixed additions.

template <class Codec>
int mul_base_batch(const u8* base, const u8* scalars, size_t n, u8* out) {
  using F = typename Codec::F;
  Jac<F> b = Codec::read(base);
  if (b.is_inf()) {
    for (size_t i = 0; i < n; ++i) Codec::write(out + i * Codec::SIZE, F::zero(), F::zero(), true);
    return 0;
  }
  constexpr int W = 8, WINDOWS = 32, TSIZE = 255;
  std::vector<Jac<F>> table((size_t)WINDOWS * TSIZE);
  Jac<F> wbase = b;
  for (int w = 0; w < WINDOWS; ++w) {
    Jac<F> acc = wbase;
    for (int d = 1; d <= TSIZE; ++d) {
      table[(size_t)w * TSIZE + (d - 1)] = acc;
      if (d < TSIZE) acc = jac_add(acc, wbase);
    }
    if (w + 1 < WINDOWS) {
      // wbase <- 2^8 * wbase: reuse acc = 255*wbase, +1 more
      wbase = jac_add(acc, wbase);
    }
  }
  std::vector<F> txs, tys;
  std::vector<bool> tinf;
  jac_normalize(table, txs, tys, tinf);

  unsigned nt = nthreads();
  std::vector<std::thread> threads;
  size_t chunk = (n + nt - 1) / nt;
  for (unsigned t = 0; t < nt; ++t) {
    size_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back([&, lo, hi]() {
      std::vector<Jac<F>> res(hi - lo);
      for (size_t i = lo; i < hi; ++i) {
        const u8* s = scalars + i * 32;
        Jac<F> acc = Jac<F>::infinity();
        for (int w = 0; w < WINDOWS; ++w) {
          unsigned d = s[w];
          if (!d) continue;
          size_t idx = (size_t)w * TSIZE + (d - 1);
          if (tinf[idx]) continue;
          acc = jac_madd(acc, txs[idx], tys[idx]);
        }
        res[i - lo] = acc;
      }
      std::vector<F> xs, ys;
      std::vector<bool> inf;
      jac_normalize(res, xs, ys, inf);
      for (size_t i = lo; i < hi; ++i)
        Codec::write(out + i * Codec::SIZE, xs[i - lo], ys[i - lo], inf[i - lo]);
    });
  }
  for (auto& th : threads) th.join();
  return 0;
}

// --- Pippenger MSM ----------------------------------------------------------------

template <class Codec>
int msm(const u8* points, const u8* scalars, size_t n, u8* out) {
  using F = typename Codec::F;
  if (n == 0) {
    Codec::write(out, F::zero(), F::zero(), true);
    return 0;
  }
  int c = 4;
  size_t nn = n;
  while (nn > 32 && c < 16) {
    nn >>= 2;
    c += 1;
  }
  int windows = (254 + c - 1) / c;
  // read all points once (affine coords in Montgomery form)
  std::vector<F> pxs(n), pys(n);
  std::vector<bool> pinf(n);
  for (size_t i = 0; i < n; ++i) {
    Jac<F> p = Codec::read(points + i * Codec::SIZE);
    pinf[i] = p.is_inf();
    pxs[i] = p.x;
    pys[i] = p.y;
  }

  std::vector<Jac<F>> window_sums(windows, Jac<F>::infinity());
  unsigned nt = nthreads();
  if ((unsigned)windows < nt) nt = windows;
  std::vector<std::thread> threads;
  // static partition of windows across threads
  for (unsigned t = 0; t < nt; ++t) {
    threads.emplace_back([&, t]() {
      std::vector<Jac<F>> buckets((size_t)1 << c);
      for (int w = t; w < windows; w += (int)nt) {
        for (auto& bkt : buckets) bkt = Jac<F>::infinity();
        int shift = w * c;
        for (size_t i = 0; i < n; ++i) {
          if (pinf[i]) continue;
          const u8* s = scalars + i * 32;
          // extract c bits at `shift`
          int byte = shift >> 3, bit = shift & 7;
          unsigned v = 0;
          for (int k = 0; k < 4 && byte + k < 32; ++k)
            v |= (unsigned)s[byte + k] << (8 * k);
          unsigned d = (v >> bit) & (((unsigned)1 << c) - 1);
          if (!d) continue;
          buckets[d] = jac_madd(buckets[d], pxs[i], pys[i]);
        }
        Jac<F> running = Jac<F>::infinity();
        Jac<F> acc = Jac<F>::infinity();
        for (size_t d = ((size_t)1 << c) - 1; d >= 1; --d) {
          running = jac_add(running, buckets[d]);
          acc = jac_add(acc, running);
        }
        window_sums[w] = acc;
      }
    });
  }
  for (auto& th : threads) th.join();

  Jac<F> result = Jac<F>::infinity();
  for (int w = windows - 1; w >= 0; --w) {
    for (int k = 0; k < c && !result.is_inf(); ++k) result = jac_dbl(result);
    result = jac_add(result, window_sums[w]);
  }
  std::vector<Jac<F>> rv{result};
  std::vector<F> xs, ys;
  std::vector<bool> inf;
  jac_normalize(rv, xs, ys, inf);
  Codec::write(out, xs[0], ys[0], inf[0]);
  return 0;
}

// --- Fr NTT -------------------------------------------------------------------------

void fr_ntt_inplace(Fr* a, size_t n, const Fr& omega) {
  // bit-reverse permutation
  size_t j = 0;
  for (size_t i = 1; i < n; ++i) {
    size_t bit = n >> 1;
    while (j & bit) {
      j ^= bit;
      bit >>= 1;
    }
    j |= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    // w_len = omega^(n/len)
    Fr w_len = omega;
    for (size_t m = n; m > len; m >>= 1) w_len = w_len.sqr();
    size_t half = len >> 1;
    unsigned nt = nthreads();
    size_t blocks = n / len;
    if (blocks >= nt * 2) {
      std::vector<std::thread> ths;
      size_t chunk = (blocks + nt - 1) / nt;
      for (unsigned t = 0; t < nt; ++t) {
        size_t lo = t * chunk, hi = lo + chunk < blocks ? lo + chunk : blocks;
        if (lo >= hi) break;
        ths.emplace_back([&, lo, hi]() {
          for (size_t bI = lo; bI < hi; ++bI) {
            size_t start = bI * len;
            Fr w = Fr::one();
            for (size_t k = start; k < start + half; ++k) {
              Fr u = a[k];
              Fr v = a[k + half] * w;
              a[k] = u + v;
              a[k + half] = u - v;
              w = w * w_len;
            }
          }
        });
      }
      for (auto& th : ths) th.join();
    } else {
      for (size_t start = 0; start < n; start += len) {
        Fr w = Fr::one();
        for (size_t k = start; k < start + half; ++k) {
          Fr u = a[k];
          Fr v = a[k + half] * w;
          a[k] = u + v;
          a[k + half] = u - v;
          w = w * w_len;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

int pk_g1_mul_base_batch(const u8* base, const u8* scalars, size_t n, u8* out) {
  return mul_base_batch<G1Codec>(base, scalars, n, out);
}
int pk_g2_mul_base_batch(const u8* base, const u8* scalars, size_t n, u8* out) {
  return mul_base_batch<G2Codec>(base, scalars, n, out);
}
int pk_g1_msm(const u8* points, const u8* scalars, size_t n, u8* out) {
  return msm<G1Codec>(points, scalars, n, out);
}
int pk_g2_msm(const u8* points, const u8* scalars, size_t n, u8* out) {
  return msm<G2Codec>(points, scalars, n, out);
}

// In-place radix-2 NTT over Fr; vals = n 32-byte canonical scalars, n = 2^k.
// omega: primitive n-th root of unity.  invert != 0 runs the inverse
// transform including the 1/n scale.
int pk_fr_ntt(u8* vals, size_t n, const u8* omega_bytes, int invert) {
  if (n == 0 || (n & (n - 1))) return 1;
  std::vector<Fr> a(n);
  for (size_t i = 0; i < n; ++i) a[i] = Fr::from_canonical(read_u256(vals + 32 * i));
  Fr omega = Fr::from_canonical(read_u256(omega_bytes));
  if (invert) {
    U256 e = R_MOD;
    e.l[0] -= 2;
    omega = omega.pow(e);
  }
  fr_ntt_inplace(a.data(), n, omega);
  if (invert) {
    U256 ne = {{(u64)n, 0, 0, 0}};
    Fr nf = Fr::from_canonical(ne);
    U256 e = R_MOD;
    e.l[0] -= 2;
    Fr ninv = nf.pow(e);
    for (size_t i = 0; i < n; ++i) a[i] = a[i] * ninv;
  }
  for (size_t i = 0; i < n; ++i) write_u256(vals + 32 * i, a[i].to_canonical());
  return 0;
}

}  // extern "C"
