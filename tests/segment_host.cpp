// Host build of provekit_tpu_torch/csrc/sumcheck_round.cuh, for the CPU
// tests (tests/test_torch_fused.py): the fused sumcheck segments' pair sums,
// folds, fused fold-and-next-pair steps and scalar steps, with the segment
// kernels' constants and the sponge's permutation, run on the host in the
// kernels' own schedule: every pass block by block and thread by thread, as
// seg::sweep hands out its items, each block's sums kept apart and added up
// as the grid's reduction adds them.  What only the card does (the barriers,
// the shared memory, the vector loads) is left to the card's tests.
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
#include <array>
#include <vector>

#include "sumcheck_round.cuh"

namespace {

using pk::Fe;

Fe get(const uint32_t* x, int64_t rs, int64_t e) {
  return pk::load(pk::PlaneView{x, rs, 1}, e);
}

// Element e of polynomial k: digit d at base[d * rs + k * ks + e].
struct Polys {
  const uint32_t* base;
  int64_t rs, ks;
  Fe get(int k, int64_t e) const { return ::get(base + k * ks, rs, e); }
  template <int C>
  void run(int k, int64_t e, Fe x[C]) const {
    for (int c = 0; c < C; ++c) x[c] = get(k, e + c);
  }
};

// A contiguous (16, polys, cap) buffer.
struct Buffer {
  uint32_t* base;
  int64_t cap;
  int polys;
  void put(int k, int64_t e, const Fe& a) const {
    pk::store(base + k * cap, polys * cap, e, a);
  }
  template <int C>
  void put_run(int k, int64_t e, const Fe y[C]) const {
    for (int c = 0; c < C; ++c) put(k, e + c, y[c]);
  }
  Polys view() const { return Polys{base, polys * cap, cap}; }
};

using Sums = std::array<Fe, 3>;

// One pass of `work` items over a launch of `blocks` blocks: every thread
// of every block takes its items (seg::sweep), item(u, acc) adding into its
// block's sums.  Returns the round's sums as the kernels reduce them: over
// every block on the grid, block 0's alone off it.
template <class Item>
Sums run_pass(bool grid, int64_t blocks, int64_t work, Item item) {
  std::vector<Sums> acc(blocks, Sums{seg::zero(), seg::zero(), seg::zero()});
  for (int64_t b = 0; b < blocks; ++b)
    for (int t = 0; t < seg::THREADS; ++t) {
      const seg::Sweep s = seg::sweep(grid, blocks, b, t);
      for (int64_t u = s.first; u < work; u += s.stride)
        item(u, acc[b].data());
    }
  Sums total = acc[0];
  for (int64_t b = 1; grid && b < blocks; ++b)
    for (int j = 0; j < 3; ++j) total[j] = seg::add(total[j], acc[b][j]);
  return total;
}

// -- the ownership map, checked ----------------------------------------------

struct Tally {
  std::vector<int> n;
  int64_t bad = 0;
  explicit Tally(int64_t len) : n(len, 0) {}
  void hit(int64_t e) {
    if (e < 0 || e >= (int64_t)n.size())
      ++bad;
    else
      ++n[e];
  }
  int64_t off() const {  // elements not hit exactly once
    int64_t k = bad;
    for (int c : n) k += c != 1;
    return k;
  }
};

}  // namespace

extern "C" {

uint64_t seg_lost() { return sk::lost; }

int seg_threads() { return seg::THREADS; }

// out = a + b, a - b or a b / 2^256 (op 0, 1, 2) mod P of (16, n) planes,
// with the segments' carry-chain operations.
void seg_field(int op, const uint32_t* a, const uint32_t* b, uint32_t* out,
               int64_t n) {
  for (int64_t e = 0; e < n; ++e) {
    const Fe x = get(a, n, e), y = get(b, n, e);
    pk::store(out, n, e, op == 0 ? seg::add(x, y)
                         : op == 1 ? seg::sub(x, y) : seg::mul(x, y));
  }
}

int64_t seg_grid_blocks(int64_t n, int64_t resident) {
  return seg::grid_blocks(n, resident);
}

// The kernels' schedule for kind 0 (WHIR) or 1 (Spartan) on n elements,
// count rounds, at most `resident` blocks at once: how many times a pass
// misses or repeats a pair of its round, an element it reads or an element
// it writes, writes what another unit of the pass reads (Spartan folds in
// place), folds into the array it reads (WHIR's ping-pong), or gives a block
// other than 0 an item once the segment left the grid.
int64_t seg_check_schedule(int kind, int64_t n, int count, int64_t resident) {
  const int64_t blocks = seg::grid_blocks(n, resident);
  int64_t bad = blocks < 1 || blocks > std::max<int64_t>(resident, 1);
  bool grid = seg::on_grid(true, n >> 1, blocks);
  bool left = !grid;  // the segment runs on block 0 alone
  // every thread's items of one pass, with its block
  auto items = [&](int64_t work, auto visit) {
    for (int64_t b = 0; b < blocks; ++b)
      for (int t = 0; t < seg::THREADS; ++t) {
        const seg::Sweep s = seg::sweep(grid, blocks, b, t);
        for (int64_t u = s.first; u < work; u += s.stride) {
          bad += left && b != 0;
          visit(u);
        }
      }
  };
  if (count == 0) return bad;
  {  // round 0's sums: pair i
    Tally pairs(n >> 1), reads(n);
    items(n >> 1, [&](int64_t i) {
      pairs.hit(i);
      reads.hit(kind == 0 ? 2 * i : i);
      reads.hit(kind == 0 ? 2 * i + 1 : i + (n >> 1));
    });
    bad += pairs.off() + reads.off();
  }
  for (int j = 0; j < count; ++j) {
    const int64_t len = n >> j;
    if (j == count - 1) {
      if (kind == 1) break;  // Spartan's last fold is never read
      grid = seg::on_grid(grid, n >> count, blocks);
      left = left || !grid;
      Tally reads(len), writes(n >> count);
      items(n >> count, [&](int64_t i) {
        reads.hit(2 * i);
        reads.hit(2 * i + 1);
        writes.hit(i);
      });
      bad += reads.off() + writes.off();
      bad += j > 0 && seg::whir_fold_dst(j - 1, count) == 2;
      break;
    }
    const int64_t work = n >> (j + 2);
    grid = seg::on_grid(grid, work, blocks);
    left = left || !grid;
    Tally reads(len), writes(len >> 1), pairs(len >> 2);
    std::vector<int64_t> reader(len, -1);
    std::vector<std::array<int64_t, 2>> written;
    items(work, [&](int64_t u) {
      for (int q = 0; q < 4; ++q) {
        const int64_t e = kind == 0 ? seg::whir_in(u, q)
                                    : seg::spartan_in(u, q, len);
        reads.hit(e);
        if (e >= 0 && e < len) reader[e] = u;
      }
      int64_t o[2];
      for (int q = 0; q < 2; ++q) {
        o[q] = kind == 0 ? seg::whir_out(u, q) : seg::spartan_out(u, q, len);
        writes.hit(o[q]);
        written.push_back({o[q], u});
      }
      // the written pair is a pair of round j + 1 (on len / 2 elements)
      const int64_t half = len >> 2;
      if (kind == 0)
        bad += o[0] % 2 != 0 || o[1] != o[0] + 1;
      else
        bad += o[0] >= half || o[1] != o[0] + half;
      pairs.hit(kind == 0 ? o[0] / 2 : o[0]);
    });
    bad += reads.off() + writes.off() + pairs.off();
    if (kind == 1) {  // in place: what unit u writes, no other unit reads
      for (const auto& w : written)
        bad += w[0] >= 0 && w[0] < len && reader[w[0]] != -1 &&
               reader[w[0]] != w[1];
    } else {  // ping-pong: the fold never writes the array it reads
      const int dst = seg::whir_fold_dst(j, count);
      bad += dst == 2 || (j > 0 && seg::whir_fold_dst(j - 1, count) == dst);
    }
  }
  return bad;
}

// seg_check_schedule for both kinds, every n = 2^0 .. 2^log_n, every count
// <= log2 n and every resident = 1 .. max_resident (each grid size once:
// resident counts that give one grid give one schedule); the cases checked
// go to *cases.
int64_t seg_check_schedules(int log_n, int64_t max_resident, int64_t* cases) {
  int64_t bad = 0;
  *cases = 0;
  for (int kind = 0; kind < 2; ++kind)
    for (int lg = 0; lg <= log_n; ++lg) {
      const int64_t n = int64_t{1} << lg;
      int64_t last = -1;
      for (int64_t res = 1; res <= max_resident; ++res) {
        const int64_t blocks = seg::grid_blocks(n, res);
        if (blocks == last) continue;
        last = blocks;
        for (int count = 0; count <= lg; ++count) {
          bad += seg_check_schedule(kind, n, count, res);
          ++*cases;
        }
      }
    }
  return bad;
}

// x (16, 2, 4 units) at alpha (Montgomery) -> y (16, 2, 2 units), the fold,
// and acc (16, 3), the next round's sums: seg::whir_fold_next, unit by unit.
void seg_whir_fold_next(const uint32_t* x, int64_t units,
                        const uint32_t* alpha, uint32_t* y, uint32_t* acc) {
  const Polys src{x, 8 * units, 4 * units};
  const Buffer dst{y, 2 * units, 2};
  Fe a[3] = {seg::zero(), seg::zero(), seg::zero()};
  const Fe am = get(alpha, 1, 0);
  for (int64_t u = 0; u < units; ++u) seg::whir_fold_next(src, dst, u, am, a);
  for (int j = 0; j < 3; ++j) pk::store(acc, 3, j, a[j]);
}

// x (16, 4, len) at alpha -> y (16, 4, len / 2) and acc (16, 3):
// seg::spartan_fold_next, unit by unit.
void seg_spartan_fold_next(const uint32_t* x, int64_t len,
                           const uint32_t* alpha, uint32_t* y,
                           uint32_t* acc) {
  const Polys src{x, 4 * len, len};
  const Buffer dst{y, len >> 1, 4};
  Fe a[3] = {seg::zero(), seg::zero(), seg::zero()};
  const Fe am = get(alpha, 1, 0);
  for (int64_t u = 0; u < (len >> 2); ++u)
    seg::spartan_fold_next(src, dst, u, len, am, a);
  for (int j = 0; j < 3; ++j) pk::store(acc, 3, j, a[j]);
}

// fw (16, 2, n), state (16, 2) -> folded (16, 2, n >> count), out
// (16, 2 + 4 count): the state, the messages, the challenges; as
// pk_whir_segment runs it with `resident` blocks at most.
void seg_whir(const uint32_t* fw, int64_t n, int count, const uint32_t* state,
              uint32_t* folded, uint32_t* out, int64_t resident) {
  const int64_t w = 2 + 4 * count;
  Fe l = get(state, 2, 0), r = get(state, 2, 1);
  const int64_t blocks = count == 0 ? 1 : seg::grid_blocks(n, resident);
  std::vector<uint32_t> scratch(count >= 2 ? 32 * ((n >> 1) + (n >> 2)) : 0);
  const Buffer dsts[3] = {Buffer{scratch.data(), n >> 1, 2},
                          Buffer{scratch.data() + 32 * (n >> 1), n >> 2, 2},
                          Buffer{folded, n >> count, 2}};
  Polys src{fw, 2 * n, n};
  bool grid = seg::on_grid(true, n >> 1, blocks);
  Sums h{};
  if (count > 0)
    h = run_pass(grid, blocks, n >> 1, [&](int64_t i, Fe* acc) {
      seg::whir_first(src, i, acc);
    });
  for (int j = 0; j < count; ++j) {
    Fe msgs[3];
    const Fe alpha = seg::whir_step(l, r, h.data(), msgs);
    for (int k = 0; k < 3; ++k) pk::store(out, w, 2 + 3 * j + k, msgs[k]);
    pk::store(out, w, 2 + 3 * count + j, alpha);
    const Fe am = seg::to_mont(alpha);
    const Buffer& dst = dsts[seg::whir_fold_dst(j, count)];
    const int64_t work = j == count - 1 ? n >> count : n >> (j + 2);
    grid = seg::on_grid(grid, work, blocks);
    if (j == count - 1) {
      run_pass(grid, blocks, work, [&](int64_t i, Fe*) {
        seg::whir_fold_last(src, dst, i, am);
      });
      break;
    }
    h = run_pass(grid, blocks, work, [&](int64_t u, Fe* acc) {
      seg::whir_fold_next(src, dst, u, am, acc);
    });
    src = dst.view();
  }
  if (count == 0) std::copy(fw, fw + 32 * n, folded);
  pk::store(out, w, 0, l);
  pk::store(out, w, 1, r);
}

// abce (16, 4, n); scal (16, 5 + 7 m) as pk_spartan_segment takes it -> out
// (16, 2 + 5 m): the state, the coefficients, the challenges; as
// pk_spartan_segment runs it with `resident` blocks at most.
void seg_spartan(const uint32_t* abce, int64_t n, int m, const uint32_t* scal,
                 uint32_t* out, int64_t resident) {
  const int64_t sw = 5 + 7 * m, w = 2 + 5 * m;
  Fe l = get(scal, sw, 0), r = get(scal, sw, 1), claim = get(scal, sw, 2),
     rho = get(scal, sw, 3), prefix = get(scal, sw, 4);
  const int64_t blocks = m == 0 ? 1 : seg::grid_blocks(n, resident);
  std::vector<uint32_t> scratch(m >= 2 ? 64 * (n >> 1) : 0);
  const Buffer dst{scratch.data(), n >> 1, 4};
  Polys src{abce, 4 * n, n};
  bool grid = seg::on_grid(true, n >> 1, blocks);
  Sums f{};
  if (m > 0)
    f = run_pass(grid, blocks, n >> 1, [&](int64_t i, Fe* acc) {
      seg::spartan_first(src, i, n, acc);
    });
  for (int j = 0; j < m; ++j) {
    Fe g[4], cs[4];
    for (int k = 0; k < 4; ++k) g[k] = get(scal, sw, 5 + 3 * m + 4 * j + k);
    const Fe alpha = seg::spartan_step(
        l, r, f.data(), claim, prefix, rho, g, get(scal, sw, 5 + j),
        get(scal, sw, 5 + m + j), get(scal, sw, 5 + 2 * m + j), cs);
    for (int k = 0; k < 4; ++k) pk::store(out, w, 2 + 4 * j + k, cs[k]);
    pk::store(out, w, 2 + 4 * m + j, alpha);
    if (j == m - 1) break;
    const Fe am = seg::to_mont(alpha);
    const int64_t len = n >> j, work = n >> (j + 2);
    grid = seg::on_grid(grid, work, blocks);
    f = run_pass(grid, blocks, work, [&](int64_t u, Fe* acc) {
      seg::spartan_fold_next(src, dst, u, len, am, acc);
    });
    src = dst.view();
  }
  pk::store(out, w, 0, l);
  pk::store(out, w, 1, r);
}

}  // extern "C"
