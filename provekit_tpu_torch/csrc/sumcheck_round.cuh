// One round of the fused sumcheck segments: the sums of one pair, the fold
// of one element, and the round's scalar step (messages, sponge, challenge).
//
// sumcheck_segment.cu runs these on the card, the pairs spread over a block
// and the scalar step on thread 0; tests/segment_host.cpp builds them for the
// host, one pair after another, so that the CPU tests hold this arithmetic
// (and the constants below) to the plain version.  Every value is a canonical
// BN254-Fr element; the round sums and the fold are in Montgomery form, the
// messages, the sponge state and the challenges canonical, as in
// ops/fused.py.
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

SK_DEV Fe add(const Fe& a, const Fe& b) { return pk::add_mod(a, b); }
SK_DEV Fe sub(const Fe& a, const Fe& b) { return pk::sub_mod(a, b); }
SK_DEV Fe mul(const Fe& a, const Fe& b) { return pk::mont_mul(a, b); }

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

}  // namespace seg
