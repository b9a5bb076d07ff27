// Host build of provekit_tpu_torch/csrc/sumcheck_round.cuh, for the CPU
// tests (tests/test_torch_fused.py): the fused sumcheck segments' pair sums,
// folds and scalar steps, with the segment kernels' constants and the
// sponge's permutation, run one pair after another on the host.  What only
// the card runs (the block reduction, the buffers) is left to the card's
// tests.
//
//   g++ -std=c++17 -O2 -shared -fPIC -I provekit_tpu_torch/csrc
//       -o libseg_host.so tests/segment_host.cpp
//
// Operands and outputs are contiguous digit planes, as the wrappers of
// ops/fused.py lay them out.
#define __device__
#define __forceinline__ inline
#define __constant__
#include <algorithm>
#include <vector>

#include "sumcheck_round.cuh"

namespace {

using pk::Fe;

Fe get(const uint32_t* x, int64_t rs, int64_t e) {
  return pk::load(pk::PlaneView{x, rs, 1}, e);
}

}  // namespace

extern "C" {

uint64_t seg_lost() { return sk::lost; }

// fw (16, 2, n), state (16, 2) -> folded (16, 2, n >> count), out
// (16, 2 + 4 count): the state, the messages, the challenges.
void seg_whir(const uint32_t* fw, int64_t n, int count,
              const uint32_t* state, uint32_t* folded, uint32_t* out) {
  std::vector<uint32_t> cur(fw, fw + 32 * n);
  const int64_t w = 2 + 4 * count;
  Fe l = get(state, 2, 0), r = get(state, 2, 1);
  for (int j = 0; j < count; ++j) {
    const int64_t len = n >> j, h = len >> 1;
    const uint32_t* f = cur.data();
    const uint32_t* g = cur.data() + len;
    Fe acc[3] = {seg::zero(), seg::zero(), seg::zero()};
    for (int64_t i = 0; i < h; ++i)
      seg::whir_pair(get(f, 2 * len, 2 * i), get(f, 2 * len, 2 * i + 1),
                     get(g, 2 * len, 2 * i), get(g, 2 * len, 2 * i + 1), acc);
    Fe msgs[3];
    const Fe alpha = seg::whir_step(l, r, acc, msgs);
    for (int k = 0; k < 3; ++k) pk::store(out, w, 2 + 3 * j + k, msgs[k]);
    pk::store(out, w, 2 + 3 * count + j, alpha);
    const Fe alpha_m = seg::to_mont(alpha);
    std::vector<uint32_t> next(32 * h);
    for (int k = 0; k < 2; ++k) {
      const uint32_t* src = cur.data() + k * len;
      for (int64_t i = 0; i < h; ++i)
        pk::store(next.data() + k * h, 2 * h, i,
                  seg::fold(get(src, 2 * len, 2 * i),
                            get(src, 2 * len, 2 * i + 1), alpha_m));
    }
    cur.swap(next);
  }
  std::copy(cur.begin(), cur.end(), folded);
  pk::store(out, w, 0, l);
  pk::store(out, w, 1, r);
}

// abce (16, 4, n); scal (16, 5 + 7 m) as pk_spartan_segment takes it -> out
// (16, 2 + 5 m): the state, the coefficients, the challenges.
void seg_spartan(const uint32_t* abce, int64_t n, int m,
                 const uint32_t* scal, uint32_t* out) {
  std::vector<uint32_t> cur(abce, abce + 64 * n);
  const int64_t sw = 5 + 7 * m, w = 2 + 5 * m;
  Fe l = get(scal, sw, 0), r = get(scal, sw, 1), claim = get(scal, sw, 2),
     rho = get(scal, sw, 3), prefix = get(scal, sw, 4);
  for (int j = 0; j < m; ++j) {
    const int64_t len = n >> j, h = len >> 1;
    auto at = [&](int k, int64_t e) {
      return get(cur.data() + k * len, 4 * len, e);
    };
    Fe acc[3] = {seg::zero(), seg::zero(), seg::zero()};
    for (int64_t i = 0; i < h; ++i) {
      Fe lo[4], hi[4];
      for (int k = 0; k < 4; ++k) {
        lo[k] = at(k, i);
        hi[k] = at(k, i + h);
      }
      seg::spartan_pair(lo, hi, acc);
    }
    Fe g[4], cs[4];
    for (int k = 0; k < 4; ++k) g[k] = get(scal, sw, 5 + 3 * m + 4 * j + k);
    const Fe alpha = seg::spartan_step(
        l, r, acc, claim, prefix, rho, g, get(scal, sw, 5 + j),
        get(scal, sw, 5 + m + j), get(scal, sw, 5 + 2 * m + j), cs);
    for (int k = 0; k < 4; ++k) pk::store(out, w, 2 + 4 * j + k, cs[k]);
    pk::store(out, w, 2 + 4 * m + j, alpha);
    const Fe alpha_m = seg::to_mont(alpha);
    std::vector<uint32_t> next(64 * h);
    for (int k = 0; k < 4; ++k)
      for (int64_t i = 0; i < h; ++i)
        pk::store(next.data() + k * h, 4 * h, i,
                  seg::fold(at(k, i), at(k, i + h), alpha_m));
    cur.swap(next);
  }
  pk::store(out, w, 0, l);
  pk::store(out, w, 1, r);
}

}  // extern "C"
