// One round of the fused sumcheck segments: the sums of one pair, the fold
// of one element, the fused step that folds one round and sums the next, the
// round's scalar step (messages, sponge, challenge), and the grid's schedule:
// which thread of which block takes which pairs and elements in each pass.
//
// sumcheck_segment.cu runs these on the card, the pairs spread over the grid
// and the scalar step on thread 0; tests/segment_host.cpp builds them for the
// host and runs the kernels' schedule block by block and thread by thread,
// so that the CPU tests hold this arithmetic (and the constants below) to the
// plain version and the schedule to covering every pair and element exactly
// once.  Every value is a canonical BN254-Fr element; the round sums and the
// fold are in Montgomery form, the messages, the sponge state and the
// challenges canonical, as in ops/fused.py.
#pragma once
#include <cstdint>

#include "field.cuh"
#include "skyscraper_sponge.cuh"

namespace seg {

using pk::Fe;

// R^2 mod P (to Montgomery form) and 1/2 in Montgomery form, R = 2^256.
static __device__ __constant__ uint32_t R2[8] = {
    0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u,
    0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u};
static __device__ __constant__ uint32_t HALF_M[8] = {
    0x1ffffffeu, 0x783c14d8u, 0x0c8d1eddu, 0xaf982f6fu,
    0xfcfd4f45u, 0x8f5f7492u, 0x3d9cbfacu, 0x1f37631au};

SK_DEV Fe constant(const uint32_t c[8]) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = c[k];
  return r;
}

SK_DEV Fe zero() {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = 0;
  return r;
}

// The field's operations on PTX carry chains (skyscraper_field.cuh's
// helpers, branch-free), canonical in and out.  A segment's serial parts
// (thread 0's scalar step, the block reductions, a tail round's one unit a
// thread) wait on each result, and field.cuh's 64-bit C product takes about
// 1.7 us on one thread of the H100 (segment_time.py).
SK_DEV Fe add(const Fe& a, const Fe& b) { return sk::add_mod(a, b); }

// a + (P - b), below 2P (P - b <= P: no borrow), reduced once
SK_DEV Fe sub(const Fe& a, const Fe& b) {
  Fe n;
  n.v[0] = sk::sub_cc(sk::mp_limb(1, 0), b.v[0]);
#pragma unroll
  for (int k = 1; k < 7; ++k) n.v[k] = sk::subc_cc(sk::mp_limb(1, k), b.v[k]);
  n.v[7] = sk::subc(sk::mp_limb(1, 7), b.v[7]);
  return sk::add_mod(a, n);
}

// a b / 2^256 mod P for a, b < P (Montgomery, R = 2^256).  The product
// t = a b in rows: row i adds a_i b_j for even j on words i .. i + 7 and for
// odd j on words i + 1 .. i + 8, one carry chain each; words above a row's
// window hold at most a carry, so no chain's end drops one.  Then as
// sk::sqr_lazy: u = (t_lo + m P) / 2^256 <= P, plus t_hi < P, below 2P,
// and one conditional subtract of P.
SK_DEV Fe mul(const Fe& x, const Fe& y) {
  const uint32_t* a = x.v;
  const uint32_t* b = y.v;
  uint32_t t[16];
#pragma unroll
  for (int w = 0; w < 16; ++w) t[w] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    t[i] = sk::mad_lo_cc(a[i], b[0], t[i]);
    t[i + 1] = sk::madc_hi_cc(a[i], b[0], t[i + 1]);
#pragma unroll
    for (int j = 2; j < 8; j += 2) {
      t[i + j] = sk::madc_lo_cc(a[i], b[j], t[i + j]);
      t[i + j + 1] = sk::madc_hi_cc(a[i], b[j], t[i + j + 1]);
    }
    t[i + 8] = sk::addc(t[i + 8], 0);
    t[i + 1] = sk::mad_lo_cc(a[i], b[1], t[i + 1]);
    t[i + 2] = sk::madc_hi_cc(a[i], b[1], t[i + 2]);
#pragma unroll
    for (int j = 3; j < 8; j += 2) {
      t[i + j] = sk::madc_lo_cc(a[i], b[j], t[i + j]);
      if (i + j == 14)  // a b < 2^512: no carry above word 15
        t[15] = sk::madc_hi(a[i], b[j], t[15]);
      else
        t[i + j + 1] = sk::madc_hi_cc(a[i], b[j], t[i + j + 1]);
    }
    if (i < 7) t[i + 9] = sk::addc(t[i + 9], 0);
  }
  uint32_t u[16];
#pragma unroll
  for (int w = 0; w < 16; ++w) u[w] = w < 8 ? t[w] : 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t m = u[i] * sk::NP0;
    u[i] = sk::mad_lo_cc(m, sk::mp_limb(1, 0), u[i]);  // 0, and its carry
    u[i + 1] = sk::madc_hi_cc(m, sk::mp_limb(1, 0), u[i + 1]);
#pragma unroll
    for (int j = 2; j < 8; j += 2) {
      u[i + j] = sk::madc_lo_cc(m, sk::mp_limb(1, j), u[i + j]);
      u[i + j + 1] = sk::madc_hi_cc(m, sk::mp_limb(1, j), u[i + j + 1]);
    }
    u[i + 8] = sk::addc(u[i + 8], 0);
    u[i + 1] = sk::mad_lo_cc(m, sk::mp_limb(1, 1), u[i + 1]);
    u[i + 2] = sk::madc_hi_cc(m, sk::mp_limb(1, 1), u[i + 2]);
#pragma unroll
    for (int j = 3; j < 7; j += 2) {
      u[i + j] = sk::madc_lo_cc(m, sk::mp_limb(1, j), u[i + j]);
      u[i + j + 1] = sk::madc_hi_cc(m, sk::mp_limb(1, j), u[i + j + 1]);
    }
    u[i + 7] = sk::madc_lo_cc(m, sk::mp_limb(1, 7), u[i + 7]);
    if (i < 7) {
      u[i + 8] = sk::madc_hi_cc(m, sk::mp_limb(1, 7), u[i + 8]);
      u[i + 9] = sk::addc(u[i + 9], 0);
    } else {
      u[15] = sk::madc_hi(m, sk::mp_limb(1, 7), u[15]);  // <= P
    }
  }
  Fe s;
  s.v[0] = sk::add_cc(u[8], t[8]);
#pragma unroll
  for (int k = 1; k < 7; ++k) s.v[k] = sk::addc_cc(u[8 + k], t[8 + k]);
  s.v[7] = sk::addc(u[15], t[15]);  // below 2P < 2^256
  sk::csub<1>(s.v);
  return s;
}

SK_DEV Fe from_mont(const Fe& x) {
  Fe one = zero();
  one.v[0] = 1;
  return mul(x, one);
}

SK_DEV Fe to_mont(const Fe& x) { return mul(x, constant(R2)); }

// a + alpha (b - a): the fold of the pair (a, b) at the challenge
SK_DEV Fe fold(const Fe& a, const Fe& b, const Fe& alpha) {
  return add(a, mul(alpha, sub(b, a)));
}

// Absorb the k canonical units u from absorb position 0 (rate 1: the first
// overwrites l, each later one permutes first), then squeeze one output:
// k permutations on the sponge state (l, r).
SK_DEV Fe absorb_squeeze(Fe& l, Fe& r, const Fe* u, int k) {
  l = u[0];
#pragma unroll 1
  for (int i = 1; i < k; ++i) {
    sk::permute(l, r);
    l = u[i];
  }
  sk::permute(l, r);
  return l;
}

// WHIR, LSB pairing: h(X) = sum f(x, X) w(x, X) over the pairs
// (f0, f1), (w0, w1): acc += [f0 w0, f0 dw + w0 df, df dw].
SK_DEV void whir_pair(const Fe& f0, const Fe& f1, const Fe& w0, const Fe& w1,
                      Fe acc[3]) {
  const Fe df = sub(f1, f0), dw = sub(w1, w0);
  acc[0] = add(acc[0], mul(f0, w0));
  acc[1] = add(acc[1], add(mul(f0, dw), mul(w0, df)));
  acc[2] = add(acc[2], mul(df, dw));
}

// The round's messages [h(0), h(1), h(2)] out of Montgomery form into msgs,
// absorbed; returns the squeezed challenge (canonical).  3 permutations.
SK_DEV Fe whir_step(Fe& l, Fe& r, const Fe h[3], Fe msgs[3]) {
  const Fe e1 = add(add(h[0], h[1]), h[2]);
  const Fe e2 = add(e1, add(h[1], add(h[2], add(h[2], h[2]))));
  msgs[0] = from_mont(h[0]);
  msgs[1] = from_mont(e1);
  msgs[2] = from_mont(e2);
  return absorb_squeeze(l, r, msgs, 3);
}

// 2 x0 - x1: the line through (x0, x1) at X = -1
SK_DEV Fe dbl_sub(const Fe& x0, const Fe& x1) { return sub(add(x0, x0), x1); }

// ZK-Spartan, MSB pairing, F(x) = eq(x) (a(x) b(x) - c(x)) on [a; b; c; eq]:
// acc += [F at X = 0, F at X = -1, the X^3 coefficient] of one pair.
SK_DEV void spartan_pair(const Fe lo[4], const Fe hi[4], Fe acc[3]) {
  acc[0] = add(acc[0], mul(lo[3], sub(mul(lo[0], lo[1]), lo[2])));
  acc[1] = add(acc[1],
               mul(dbl_sub(lo[3], hi[3]),
                   sub(mul(dbl_sub(lo[0], hi[0]), dbl_sub(lo[1], hi[1])),
                       dbl_sub(lo[2], hi[2]))));
  acc[2] = add(acc[2], mul(sub(hi[3], lo[3]),
                           mul(sub(hi[0], lo[0]), sub(hi[1], lo[1]))));
}

// c3 x^3 + c2 x^2 + c1 x + c0 (Horner)
SK_DEV Fe eval_cubic(const Fe c[4], const Fe& x) {
  Fe acc = c[3];
  for (int k = 2; k >= 0; --k) acc = add(mul(acc, x), c[k]);
  return acc;
}

// One ZK-Spartan round's scalar step (ops/fused.py:spartan_round_coeffs,
// then spartan_scalar_step): the ZK-combined cubic from the round sums f,
// the running claim and prefix, the round's blinding cubic g and its
// factors pm, sm, sfx, and rho; its coefficients out of Montgomery form
// into cs, absorbed; the squeezed challenge returned (canonical), claim and
// prefix advanced to it.  4 permutations.
SK_DEV Fe spartan_step(Fe& l, Fe& r, const Fe f[3], Fe& claim, Fe& prefix,
                       const Fe& rho, const Fe g[4], const Fe& pm,
                       const Fe& sm, const Fe& sfx, Fe cs[4]) {
  const Fe gp0 = add(mul(pm, g[0]), add(mul(pm, prefix), mul(sm, sfx)));
  const Fe gp1 = mul(pm, g[1]), gp2 = mul(pm, g[2]), gp3 = mul(pm, g[3]);
  Fe c[4];
  c[0] = add(f[0], mul(rho, gp0));
  const Fe comb_m1 = add(f[1], mul(rho, sub(add(gp0, gp2), add(gp1, gp3))));
  const Fe three_c0 = add(add(c[0], c[0]), c[0]);
  c[2] = mul(constant(HALF_M), sub(add(claim, comb_m1), three_c0));
  c[3] = add(f[2], mul(rho, gp3));
  c[1] = sub(sub(claim, add(c[0], c[0])), add(c[3], c[2]));
#pragma unroll
  for (int k = 0; k < 4; ++k) cs[k] = from_mont(c[k]);
  const Fe alpha = absorb_squeeze(l, r, cs, 4);
  const Fe alpha_m = to_mont(alpha);
  claim = eval_cubic(c, alpha_m);
  prefix = add(prefix, eval_cubic(g, alpha_m));
  return alpha;
}

// ---- the grid's schedule -------------------------------------------------
//
// A segment runs in passes over the grid.  The first pass sums round 0's
// pairs; pass j + 1 folds round j at its challenge and sums round j + 1's
// pairs in the same sweep (a unit: the four elements that fold into one pair
// of round j + 1); WHIR's last pass folds its last round into the output.
// A pass's items are spread over the grid as a grid-stride loop while they
// outnumber one block's threads; from the first pass whose items fit one
// block, block 0 runs the rest of the segment alone and the other blocks
// return (no grid barrier is left to wait for them).

constexpr int THREADS = 256;    // a block; 255 registers a thread, no spill
constexpr int MAX_ROUNDS = 32;  // Spartan's scalars, in shared memory
// A grid's blocks at most (the card holds fewer at once): the room of the
// partials buffer, two slots of three round sums for each block.
constexpr int MAX_BLOCKS = 1024;

// the schedule's functions also run on the host: the launch sizes its grid
#if defined(__CUDACC__)
#define SEG_HD __host__ __device__ __forceinline__
#else
#define SEG_HD inline
#endif

// Blocks of a launch on n elements: one for every THREADS pairs of round 0,
// at least 1, at most `resident` (all co-resident: a cooperative launch).
SEG_HD int64_t grid_blocks(int64_t n, int64_t resident) {
  const int64_t want = ((n >> 1) + THREADS - 1) / THREADS;
  return want < 1 ? 1 : want < resident ? want : resident;
}

// Whether a pass of `work` items runs over the grid (else on block 0 alone);
// `grid` is false once any earlier pass ran on block 0 alone.
SEG_HD bool on_grid(bool grid, int64_t work, int64_t blocks) {
  return grid && blocks > 1 && work > THREADS;
}

// The items of a pass that a thread takes: first, first + stride, ... below
// the pass's work; off the grid only block 0's threads take any.
struct Sweep {
  int64_t first, stride;
};

SEG_HD Sweep sweep(bool grid, int64_t blocks, int64_t block, int thread) {
  if (grid) return Sweep{block * THREADS + thread, blocks * THREADS};
  return Sweep{block == 0 ? thread : INT64_MAX, THREADS};
}

// WHIR, LSB pairing (pairs 2i, 2i + 1).  Unit u of a fold pass reads
// elements 4u + q (q = 0 .. 3) of round j's array and writes elements
// 2u + q (q = 0, 1) of round j + 1's, which are round j + 1's pair u.
SEG_HD int64_t whir_in(int64_t u, int q) { return 4 * u + q; }
SEG_HD int64_t whir_out(int64_t u, int q) { return 2 * u + q; }

// Where WHIR's fold of round j goes, ping-pong: 0 the scratch A, 1 the
// scratch B, 2 the output (the last round's fold).
SEG_HD int whir_fold_dst(int j, int count) {
  return j == count - 1 ? 2 : (j & 1);
}

// Spartan, MSB pairing (pairs i, i + len/2 on round j's array of len
// elements).  Unit u < len/4 reads elements u + q len/4 (q = 0 .. 3) and
// writes u + q len/4 (q = 0, 1) of round j + 1's array, in place: pair u of
// round j + 1.  No other unit of the pass reads what unit u writes.
SEG_HD int64_t spartan_in(int64_t u, int q, int64_t len) {
  return u + q * (len >> 2);
}
SEG_HD int64_t spartan_out(int64_t u, int q, int64_t len) {
  return u + q * (len >> 2);
}

// ---- one item of a pass ---------------------------------------------------
//
// Src: Fe get(k, e) and void run<C>(k, e, Fe x[C]), elements e .. e + C - 1
// of polynomial k; Dst: put(k, e, a) and put_run<C>(k, e, y).

// WHIR round 0, pair i.
template <class Src>
SK_DEV void whir_first(const Src& src, int64_t i, Fe acc[3]) {
  Fe f[2], w[2];
  src.template run<2>(0, 2 * i, f);
  src.template run<2>(1, 2 * i, w);
  whir_pair(f[0], f[1], w[0], w[1], acc);
}

// WHIR's fused step: unit u of round j folded at alpha (Montgomery), then
// round j + 1's pair u added to acc.
template <class Src, class Dst>
SK_DEV void whir_fold_next(const Src& src, const Dst& dst, int64_t u,
                           const Fe& alpha, Fe acc[3]) {
  Fe y[2][2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    Fe x[4];
    src.template run<4>(k, whir_in(u, 0), x);
    y[k][0] = fold(x[0], x[1], alpha);
    y[k][1] = fold(x[2], x[3], alpha);
    dst.template put_run<2>(k, whir_out(u, 0), y[k]);
  }
  whir_pair(y[0][0], y[0][1], y[1][0], y[1][1], acc);
}

// WHIR's last fold: pair i into element i of the output.
template <class Src, class Dst>
SK_DEV void whir_fold_last(const Src& src, const Dst& dst, int64_t i,
                           const Fe& alpha) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    Fe x[2];
    src.template run<2>(k, 2 * i, x);
    dst.put(k, i, fold(x[0], x[1], alpha));
  }
}

// Spartan round 0 on len elements, pair i.
template <class Src>
SK_DEV void spartan_first(const Src& src, int64_t i, int64_t len,
                          Fe acc[3]) {
  Fe lo[4], hi[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    lo[k] = src.get(k, i);
    hi[k] = src.get(k, i + (len >> 1));
  }
  spartan_pair(lo, hi, acc);
}

// Spartan's fused step: unit u of round j (len elements) folded at alpha,
// then round j + 1's pair u added to acc.  Each polynomial's four elements
// are read before its two are written, so src and dst may be one array.
template <class Src, class Dst>
SK_DEV void spartan_fold_next(const Src& src, const Dst& dst, int64_t u,
                              int64_t len, const Fe& alpha, Fe acc[3]) {
  Fe lo[4], hi[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    Fe x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = src.get(k, spartan_in(u, q, len));
    lo[k] = fold(x[0], x[2], alpha);
    hi[k] = fold(x[1], x[3], alpha);
    dst.put(k, spartan_out(u, 0, len), lo[k]);
    dst.put(k, spartan_out(u, 1, len), hi[k]);
  }
  spartan_pair(lo, hi, acc);
}

}  // namespace seg
