// The port's host library: the witness-program interpreter (the
// WitnessBuilder IR of r1cs/witness_builder.py run natively), and the
// Skyscraper permutation, compression and Merkle path check that the host
// sponge, the verifier and proof-of-work checks call.
//
// A C-ABI shared library, built by native/build.py and loaded with ctypes
// by native/__init__.py; the host-sequential analogue of the reference's
// provekit-prover witness solving (prover/src/witness/witness_builder.rs).
// The program encoding, the opcodes and the error codes are those of the
// JAX package's native solver, byte for byte, so either package's encoder
// feeds either library.
//
// Program encoding (little-endian; fe = 32-byte canonical field element):
//   u8 opcode, payload:
//    0 Constant:      u32 widx, fe value
//    1 Acir:          u32 widx, u32 acir_idx
//    2 Sum:           u32 widx, u32 n, n x (u8 has_coeff, [fe], u32 idx)
//    3 Product:       u32 widx, u32 a, u32 b
//    4 MultRange:     u32 start, u32 range_size, u32 n, n x u32
//    5 Challenge:     u32 widx
//    6 IndexedLogUp:  u32 widx, u32 sz, fe icoeff, u32 index, u32 rs, u32 val
//    7 Inverse:       u32 widx, u32 operand
//    8 ProdLinear:    u32 widx, u32 x, fe a, fe b, u32 y, fe c, fe d
//    9 LogUpDenom:    u32 widx, u32 sz, fe coeff, u32 value
//   10 DigitalDecomp: u32 first, u32 nb, nb x u8, u32 n, n x u32
//   11 Spice:         u32 memlen, u32 init_start, u32 rv_start, u32 rt_start,
//                     u32 nops, ops x (u8 kind(0 load/1 store), u32 addr,
//                     u32 v1, [u32 v2], u32 rt)
//   12 SpiceFactor:   u32 widx, u32 sz, u32 rs, fe addr, u32 addr_w,
//                     u32 value, fe timer, u32 timer_w
//   13 BinOpDenom:    u32 widx, u32 sz, u32 rs, u32 rs2, 3 x operand
//   14 MultBinOp:     u32 widx, u32 n, n x (operand, operand)
//   operand: u8 kind (0 const / 1 witness), fe or u32.
//
// Error codes of pk_solve_witness (0: solved):
//   1 unknown opcode              6 value does not fit its digits
//   2 witness index out of range  7 memory address out of range
//   3 ACIR witness missing        8 binary-op operand out of range
//   4 range value out of range    9 truncated program
//   5 inverse of zero

#include <cstdint>
#include <cstring>
#include <vector>

#include "field256.hpp"

using namespace pk;

namespace {

struct Reader {
  const std::uint8_t* p;
  const std::uint8_t* end;
  bool ok = true;

  bool need(size_t n) {
    if ((size_t)(end - p) < n) { ok = false; return false; }
    return true;
  }
  std::uint8_t u8() {
    if (!need(1)) return 0;
    return *p++;
  }
  std::uint32_t u32() {
    if (!need(4)) return 0;
    std::uint32_t v;
    std::memcpy(&v, p, 4);
    p += 4;
    return v;
  }
  Fe fe() {
    if (!need(32)) return ZERO;
    Fe v = from_bytes(p);
    p += 32;
    return v;
  }
};

struct Operand {
  bool is_const;
  Fe cval;
  std::uint32_t widx;
};

Operand read_operand(Reader& r) {
  Operand o;
  o.is_const = r.u8() == 0;
  if (o.is_const) {
    o.cval = r.fe();
    o.widx = 0;
  } else {
    o.widx = r.u32();
  }
  return o;
}

inline Fe op_value(const Operand& o, const std::vector<Fe>& w) {
  return o.is_const ? o.cval : w[o.widx];
}

}  // namespace

extern "C" {

// Returns 0 on success, else an error code (above) with the index of the
// builder that failed in *out_builder.
int pk_solve_witness(const std::uint8_t* prog, size_t prog_len,
                     const std::uint32_t* acir_indices,
                     const std::uint8_t* acir_values, size_t n_acir,
                     std::uint32_t num_witnesses,
                     const std::uint8_t iv[32],
                     const std::uint8_t* seed_scalars, size_t n_seeds,
                     std::uint8_t* out_witness, std::uint8_t* out_mask,
                     std::uint64_t* out_builder) {
  std::vector<Fe> w(num_witnesses, ZERO);
  std::vector<std::uint8_t> solved(num_witnesses, 0);

  // ACIR witness values: n_acir indices (in any order) and as many fe
  // values
  std::uint32_t max_acir = 0;
  for (size_t i = 0; i < n_acir; ++i)
    if (acir_indices[i] > max_acir) max_acir = acir_indices[i];
  std::vector<std::int64_t> acir_map(max_acir + 1, -1);
  for (size_t i = 0; i < n_acir; ++i)
    acir_map[acir_indices[i]] = (std::int64_t)i;

  Sponge sponge;
  sponge.init(iv);
  for (size_t i = 0; i < n_seeds; ++i)
    sponge.absorb(from_bytes(seed_scalars + 32 * i));

  auto set = [&](std::uint32_t idx, const Fe& v) -> bool {
    if (idx >= num_witnesses) return false;
    w[idx] = v;
    solved[idx] = 1;
    return true;
  };

  Reader r{prog, prog + prog_len};
  *out_builder = 0;
  for (; r.p < r.end && r.ok; ++*out_builder) {
    std::uint8_t op = r.u8();
    switch (op) {
      case 0: {  // Constant
        std::uint32_t idx = r.u32();
        Fe v = r.fe();
        if (!set(idx, v)) return 2;
        break;
      }
      case 1: {  // Acir
        std::uint32_t idx = r.u32(), aidx = r.u32();
        if (aidx >= acir_map.size() || acir_map[aidx] < 0) return 3;
        if (!set(idx, from_bytes(acir_values + 32 * acir_map[aidx])))
          return 2;
        break;
      }
      case 2: {  // Sum
        std::uint32_t idx = r.u32(), n = r.u32();
        Fe acc = ZERO;
        for (std::uint32_t i = 0; i < n && r.ok; ++i) {
          bool has_coeff = r.u8() != 0;
          Fe coeff = has_coeff ? r.fe() : ONE;
          std::uint32_t t = r.u32();
          if (t >= num_witnesses) return 2;
          acc = add(acc, has_coeff ? mul(coeff, w[t]) : w[t]);
        }
        if (!set(idx, acc)) return 2;
        break;
      }
      case 3: {  // Product
        std::uint32_t idx = r.u32(), a = r.u32(), b = r.u32();
        if (a >= num_witnesses || b >= num_witnesses) return 2;
        if (!set(idx, mul(w[a], w[b]))) return 2;
        break;
      }
      case 4: {  // MultiplicitiesForRange
        std::uint32_t start = r.u32(), range = r.u32(), n = r.u32();
        std::vector<std::uint64_t> counts(range, 0);
        for (std::uint32_t i = 0; i < n && r.ok; ++i) {
          std::uint32_t t = r.u32();
          if (t >= num_witnesses) return 2;
          const Fe& v = w[t];
          if (v.l[1] || v.l[2] || v.l[3] || v.l[0] >= range) return 4;
          counts[v.l[0]] += 1;
        }
        for (std::uint32_t i = 0; i < range; ++i)
          if (!set(start + i, from_u64(counts[i]))) return 2;
        break;
      }
      case 5: {  // Challenge
        std::uint32_t idx = r.u32();
        if (!set(idx, sponge.squeeze())) return 2;
        break;
      }
      case 6: {  // IndexedLogUpDenominator
        std::uint32_t idx = r.u32(), sz = r.u32();
        Fe icoeff = r.fe();
        std::uint32_t index = r.u32(), rs = r.u32(), val = r.u32();
        Fe t = add(mul(icoeff, w[index]), mul(w[rs], w[val]));
        if (!set(idx, sub(w[sz], t))) return 2;
        break;
      }
      case 7: {  // Inverse
        std::uint32_t idx = r.u32(), a = r.u32();
        if (a >= num_witnesses) return 2;
        if (w[a] == ZERO) return 5;
        if (!set(idx, inv(w[a]))) return 2;
        break;
      }
      case 8: {  // ProductLinearOperation
        std::uint32_t idx = r.u32(), x = r.u32();
        Fe a = r.fe(), b = r.fe();
        std::uint32_t y = r.u32();
        Fe c = r.fe(), d = r.fe();
        Fe lhs = add(mul(a, w[x]), b);
        Fe rhs = add(mul(c, w[y]), d);
        if (!set(idx, mul(lhs, rhs))) return 2;
        break;
      }
      case 9: {  // LogUpDenominator
        std::uint32_t idx = r.u32(), sz = r.u32();
        Fe coeff = r.fe();
        std::uint32_t val = r.u32();
        if (!set(idx, sub(w[sz], mul(coeff, w[val])))) return 2;
        break;
      }
      case 10: {  // DigitalDecomposition
        std::uint32_t first = r.u32(), nb = r.u32();
        std::vector<std::uint8_t> log_bases(nb);
        for (std::uint32_t i = 0; i < nb; ++i) log_bases[i] = r.u8();
        std::uint32_t n = r.u32();
        for (std::uint32_t i = 0; i < n && r.ok; ++i) {
          std::uint32_t t = r.u32();
          if (t >= num_witnesses) return 2;
          Fe v = w[t];
          // extract digits little-endian over the 256-bit value
          int bitpos = 0;
          for (std::uint32_t place = 0; place < nb; ++place) {
            int lb = log_bases[place];
            std::uint64_t digit = 0;
            for (int k = 0; k < lb; ++k, ++bitpos) {
              int limb = bitpos >> 6, off = bitpos & 63;
              digit |= ((v.l[limb] >> off) & 1ULL) << k;
            }
            if (!set(first + place * n + i, from_u64(digit))) return 2;
          }
          // remaining bits must be zero
          for (; bitpos < 256; ++bitpos) {
            int limb = bitpos >> 6, off = bitpos & 63;
            if ((v.l[limb] >> off) & 1ULL) return 6;
          }
        }
        break;
      }
      case 11: {  // SpiceWitnesses
        std::uint32_t memlen = r.u32(), init_start = r.u32();
        std::uint32_t rv_start = r.u32(), rt_start = r.u32();
        std::uint32_t nops = r.u32();
        std::vector<Fe> rv(memlen);
        std::vector<std::uint64_t> rt(memlen, 0);
        for (std::uint32_t i = 0; i < memlen; ++i) rv[i] = w[init_start + i];
        for (std::uint32_t i = 0; i < nops && r.ok; ++i) {
          std::uint8_t kind = r.u8();
          std::uint32_t addr_w = r.u32();
          const Fe& av = w[addr_w];
          if (av.l[1] || av.l[2] || av.l[3] || av.l[0] >= memlen) return 7;
          std::uint64_t addr = av.l[0];
          if (kind == 0) {  // load: v1 = value, rt
            std::uint32_t value = r.u32(), rtw = r.u32();
            if (!set(rtw, from_u64(rt[addr]))) return 2;
            rv[addr] = w[value];
            rt[addr] = i + 1;
          } else {  // store: v1 = old, v2 = new, rt
            std::uint32_t oldv = r.u32(), newv = r.u32(), rtw = r.u32();
            if (!set(oldv, rv[addr])) return 2;
            if (!set(rtw, from_u64(rt[addr]))) return 2;
            rv[addr] = w[newv];
            rt[addr] = i + 1;
          }
        }
        for (std::uint32_t i = 0; i < memlen; ++i) {
          if (!set(rv_start + i, rv[i])) return 2;
          if (!set(rt_start + i, from_u64(rt[i]))) return 2;
        }
        break;
      }
      case 12: {  // SpiceMultisetFactor
        std::uint32_t idx = r.u32(), sz = r.u32(), rs = r.u32();
        Fe addr = r.fe();
        std::uint32_t addr_w = r.u32(), value = r.u32();
        Fe timer = r.fe();
        std::uint32_t timer_w = r.u32();
        Fe rsv = w[rs];
        Fe t = add(mul(addr, w[addr_w]), mul(rsv, w[value]));
        t = add(t, mul(mul(mul(rsv, rsv), timer), w[timer_w]));
        if (!set(idx, sub(w[sz], t))) return 2;
        break;
      }
      case 13: {  // BinOpLookupDenominator
        std::uint32_t idx = r.u32(), sz = r.u32(), rs = r.u32(), rs2 = r.u32();
        Operand lhs = read_operand(r), rhs = read_operand(r),
                out = read_operand(r);
        Fe t = add(op_value(lhs, w), mul(w[rs], op_value(rhs, w)));
        t = add(t, mul(w[rs2], op_value(out, w)));
        if (!set(idx, sub(w[sz], t))) return 2;
        break;
      }
      case 14: {  // MultiplicitiesForBinOp
        std::uint32_t idx = r.u32(), n = r.u32();
        const std::uint32_t table = 1u << 16;
        std::vector<std::uint64_t> counts(table, 0);
        for (std::uint32_t i = 0; i < n && r.ok; ++i) {
          Operand lhs = read_operand(r), rhs = read_operand(r);
          Fe lv = op_value(lhs, w), rv2 = op_value(rhs, w);
          if (lv.l[1] | lv.l[2] | lv.l[3] | rv2.l[1] | rv2.l[2] | rv2.l[3])
            return 8;
          std::uint64_t key = (lv.l[0] << 8) + rv2.l[0];
          if (key >= table) return 8;
          counts[key] += 1;
        }
        for (std::uint32_t i = 0; i < table; ++i)
          if (!set(idx + i, from_u64(counts[i]))) return 2;
        break;
      }
      default:
        return 1;
    }
  }
  if (!r.ok) {  // the builder the program ended in
    --*out_builder;
    return 9;
  }

  for (std::uint32_t i = 0; i < num_witnesses; ++i) {
    to_bytes(w[i], out_witness + 32 * i);
    out_mask[i] = solved[i];
  }
  return 0;
}

void pk_compress(const std::uint8_t l[32], const std::uint8_t r[32],
                 std::uint8_t out[32]) {
  to_bytes(compress(from_bytes(l), from_bytes(r)), out);
}

// The permutation of a sponge state (l || r, canonical), in place.
void pk_permute(std::uint8_t state[64]) {
  Fe lf = from_bytes(state), rf = from_bytes(state + 32);
  permute(lf, rf);
  to_bytes(lf, state);
  to_bytes(rf, state + 32);
}

// Verify a Merkle path: leaf values folded, then climbed with siblings.
int pk_merkle_verify(const std::uint8_t* leaf_values, std::uint32_t n_values,
                     const std::uint8_t* path, std::uint32_t depth,
                     std::uint64_t index, const std::uint8_t root[32]) {
  if (n_values == 0) return 0;
  Fe h = from_bytes(leaf_values);
  for (std::uint32_t i = 1; i < n_values; ++i)
    h = compress(h, from_bytes(leaf_values + 32 * i));
  for (std::uint32_t d = 0; d < depth; ++d) {
    Fe sib = from_bytes(path + 32 * d);
    h = (index & 1) ? compress(sib, h) : compress(h, sib);
    index >>= 1;
  }
  return h == from_bytes(root) ? 1 : 0;
}

}  // extern "C"
