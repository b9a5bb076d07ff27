// The host library's field inverse (batched divsteps, field256.hpp)
// against Fermat's a^(P-2) on the same Montgomery product, on the host.
// Built and run by experiments/host_time.py; prints one JSON line.
#include <chrono>
#include <cstdio>

#include "../native/field256.hpp"

using namespace pk;

static Fe fermat(const Fe& a) {
  Fe e = P;
  e.l[0] -= 2;  // P is odd: no borrow
  Fe base = mont_mul(a, R2), acc = mont_mul(ONE, R2);
  for (int i = 3; i >= 0; --i)
    for (int bit = 63; bit >= 0; --bit) {
      acc = mont_mul(acc, acc);
      if ((e.l[i] >> bit) & 1) acc = mont_mul(acc, base);
    }
  return mont_mul(acc, ONE);
}

int main() {
  const int n = 100000;
  static Fe xs[n];
  u64 s = 88172645463325252ULL;  // xorshift64, canonical values below 2^252
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < 4; ++j) {
      s ^= s << 13;
      s ^= s >> 7;
      s ^= s << 17;
      xs[i].l[j] = s;
    }
    xs[i].l[3] &= 0x0fffffffffffffffULL;
  }
  u64 sink = 0;
  int mismatches = 0;
  auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < n; ++i) sink ^= inv(xs[i]).l[0];
  auto t1 = std::chrono::steady_clock::now();
  for (int i = 0; i < n; ++i) sink ^= fermat(xs[i]).l[0];
  auto t2 = std::chrono::steady_clock::now();
  for (int i = 0; i < 1000; ++i) mismatches += !(inv(xs[i]) == fermat(xs[i]));
  std::printf(
      "{\"inverses\": %d, \"divsteps_us\": %.4f, \"fermat_us\": %.4f, "
      "\"mismatches\": %d, \"sink\": %llu}\n",
      n, std::chrono::duration<double>(t1 - t0).count() * 1e6 / n,
      std::chrono::duration<double>(t2 - t1).count() * 1e6 / n, mismatches,
      (unsigned long long)(sink & 1));
  return mismatches != 0;
}
