// Host build of provekit_tpu_torch/csrc/skyscraper_field.cuh, for the CPU
// tests (tests/test_torch_skyscraper.py): the kernels' carry chains run on
// an emulated carry flag, and every carry a chain's last instruction drops
// is counted (sk_lost), which must stay 0.
//
//   g++ -std=c++17 -O2 -shared -fPIC -I provekit_tpu_torch/csrc
//       -o libsk_host.so tests/skyscraper_host.cpp
//
// Operands are contiguous (16, n) uint32 digit planes, as the kernels take.
#define __device__
#define __forceinline__ inline
#define __constant__
#include "skyscraper_field.cuh"

namespace {

uint32_t g_rc[18][8];

struct RcHost {
  uint32_t operator()(int k, int i) const { return g_rc[k][i]; }
};

pk::Fe get(const uint32_t* x, int64_t n, int64_t e) {
  return pk::load(pk::PlaneView{x, n, 1}, e);
}

}  // namespace

extern "C" {

void sk_set_rc(const uint32_t* rc) {
  for (int k = 0; k < 18; ++k)
    for (int i = 0; i < 8; ++i) g_rc[k][i] = rc[8 * k + i];
}

uint64_t sk_lost() { return sk::lost; }

// the Montgomery square before its reduction: below 2P for a < P
void sk_sqr_lazy(const uint32_t* a, uint32_t* out, int64_t n) {
  for (int64_t e = 0; e < n; ++e) pk::store(out, n, e, sk::sqr_lazy(get(a, n, e)));
}

void sk_bar(const uint32_t* a, uint32_t* out, int64_t n) {
  for (int64_t e = 0; e < n; ++e) pk::store(out, n, e, sk::bar(get(a, n, e)));
}

void sk_permute(const uint32_t* l, const uint32_t* r, uint32_t* lo,
                uint32_t* ro, int64_t n) {
  for (int64_t e = 0; e < n; ++e) {
    pk::Fe a = get(l, n, e), b = get(r, n, e);
    sk::ladder(a, b, RcHost{});
    pk::store(lo, n, e, a);
    pk::store(ro, n, e, b);
  }
}

void sk_compress(const uint32_t* l, const uint32_t* r, uint32_t* out,
                 int64_t n) {
  for (int64_t e = 0; e < n; ++e)
    pk::store(out, n, e, sk::compress(get(l, n, e), get(r, n, e), RcHost{}));
}

}  // extern "C"
