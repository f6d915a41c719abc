// K2's per-row arithmetic on ge25519_x4.cuh's four lanes: the hot-signer
// verify of one row. Everything here also compiles as host C++ (FE_FN /
// FE_CALL set to plain functions, the four lanes run in turn), which is
// how the CPU tests run it.
//
// Bounds (ge25519_x4.cuh:42-56 states the three-unit bound of a round's
// uncarried products; a unit is a carried limb's bound, 2^25 + 20 even,
// 2^24 + 2^15 odd). An addition's round 1 multiplies this lane's operand
// component by a gathered value of at most two units (Y1 - X1 or Y1 + X1,
// each the sum of two carried coordinates) or one (Z1, T1). The operand
// comes from two places:
// * an entry of the row's table: twenty canonical 13-bit limbs of a value
//   below p, which fe_from_limbs13 packs exactly into limbs of [0, 2^26)
//   (even) and [0, 2^25) (odd), two units; lane 3's negation for a
//   negative digit has the same magnitudes;
// * an entry of the B-table: the canonical limbs of hot_kernel_consts
//   (stellar_tpu_torch/state.py), two units; the identity's and lane 2's
//   constants, 0, 1 and 2.
// So both factors of every product stay within two units, inside the three
// the header allows. tests/test_torch_hot.py holds the add of an operand
// entry, at the canonical extremes too, against ref10's ge_madd.
#pragma once
#include <string.h>

#include "ge25519_x4.cuh"

constexpr int kHotEntries = 128;          // multiples 1..128 in a table
constexpr int kEntryLimbs = 3 * 20;       // (y+x, y-x, 2dxy), 13-bit limbs
constexpr int kTableLimbs = kHotEntries * kEntryLimbs;
// the staged B-table: entries 0 (the identity) to 128, four components each
constexpr int kHotTableFe = 4 * (kHotEntries + 1);

struct verify_hot_consts {
  fe d, d2;
  ge_precomp base[kHotEntries];  // v*B for v = 1..128
};

// Signed radix-256 recode: the bytes are the windows. 32 digits, least
// significant first, in [-128, 128) except the top one, which keeps the
// last carry unsigned and lies in [0, 256]. The carry into window i + 1 is
// set when byte i plus the carry into it reaches 128.
FE_FN void recode256(int16_t d[32], const uint8_t s[32]) {
  int carry = 0;
  for (int i = 0; i < 32; ++i) {
    int e = s[i] + carry;
    carry = 0;
    if (i < 31 && e >= 128) {
      e -= 256;
      carry = 1;
    }
    d[i] = (int16_t)e;
  }
}

// A digit with a top value above 128 saturated at 128, as the reference's
// select tree does: the entry a table of multiples 0..128 is read at.
FE_FN int hot_saturate(int digit) {
  return digit > kHotEntries ? kHotEntries : digit;
}

// One coordinate: twenty canonical 13-bit limbs, packed four to a 64-bit
// word, to ref10's ten limbs of 26 and 25 bits. Exact for values below
// 2^255, which canonical ones are.
FE_FN void fe_from_limbs13(fe& h, const uint64_t w[5]) {
  uint64_t acc = 0;
  int have = 0, j = 0;
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    acc |= ((w[i >> 2] >> (16 * (i & 3))) & 0x1fff) << have;
    have += 13;
    const int width = (j & 1) ? 25 : 26;
    if (j < 10 && have >= width) {
      h.v[j] = (int32_t)(acc & ((uint64_t(1) << width) - 1));
      acc >>= width;
      have -= width;
      ++j;
    }
  }
}

// This lane's 40 bytes of the row's table for ``digit``, as five 8-byte
// words: the component of entry |digit| (saturated) that the lane's cached
// component comes from. The table's order is (Y + X, Y - X, 2dT) and -P
// swaps the first two: lane 0 (Y2 - X2) reads component 1, or 0 for a
// negative digit; lane 1 (Y2 + X2) component 0, or 1; lane 3 component 2.
// Lane 2 (2 Z2 = 2) and a zero digit read nothing. The table and each
// entry's 120 bytes are 8-byte aligned.
FE_FN void hot_load(uint64_t w[5], const int16_t* atab, int lane,
                    int digit) {
  const int neg = digit < 0;
  const int m = hot_saturate(neg ? -digit : digit);
  const int comp = lane == 3 ? 2 : ((lane == 0) != neg);
#pragma unroll
  for (int k = 0; k < 5; ++k) w[k] = 0;
  if (lane == 2 || m == 0) return;
  const uint64_t* src = reinterpret_cast<const uint64_t*>(
      atab + (m - 1) * kEntryLimbs + comp * 20);
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int k = 0; k < 5; ++k)
    w[k] = __ldg(reinterpret_cast<const unsigned long long*>(src) + k);
#else
  memcpy(w, src, 5 * sizeof(uint64_t));
#endif
}

// This lane's cached component of -A's entry for ``digit`` from the words
// hot_load read: lane 3 negates for a negative digit; lane 2 and a zero
// digit take the identity's (selects, not branches).
FE_FN void hot_entry_lane(fe& out, int lane, const uint64_t w[5],
                          int digit) {
  fe v, minus, id;
  fe_from_limbs13(v, w);
  fe_neg(minus, v);
  x4_identity_cached(id, lane);
  if (lane == 3 && digit < 0) v = minus;
  if (lane == 2 || digit == 0) v = id;
  out = v;
}

// The device bit for one hot row, encode(s*B + h*(-A)) == R, on ``L``
// lanes starting at ``lane0`` (the card: L = 1, this thread's lane; the
// host build: L = 4, the group's lanes in turn). ``atab`` is the row's
// table of -A (kTableLimbs int16, canonical), ``btab`` the staged B-table
// (kHotTableFe elements). There is no decompression: cache membership is
// its proof.
template <int L>
FE_FN int verify_hot_row_lanes(int lane0, const int16_t* atab,
                               const uint8_t r[32], const uint8_t s[32],
                               const uint8_t h[32], const fe* btab) {
  int16_t sd[32], hd[32];
  recode256(sd, s);
  recode256(hd, h);

  // Strauss-Shamir over both scalars, most significant window first, from
  // the identity (0, 1, 1, 0): 31 windows of 8 doublings, and every
  // window adds an entry of B and one of -A (a zero digit adds the
  // identity)
  fe own[L], q[L], op[L], g[4];
  uint64_t w[L][5];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int lane = lane0 + j;
    fe_0(own[j]);
    own[j].v[0] = lane == 1 || lane == 2;
  }
  for (int win = 31; win >= 0; --win) {
    const int sdig = sd[win], hdig = hd[win];
    // the -A entry's loads first: their latency hides behind the doublings
#pragma unroll
    for (int j = 0; j < L; ++j) hot_load(w[j], atab, lane0 + j, hdig);
    const int doublings = win == 31 ? 0 : 8;
    for (int i = 0; i < doublings; ++i) {
      x4_gather_xy<L>(g, own);
#pragma unroll
      for (int j = 0; j < L; ++j) x4_dbl_r1(q[j], lane0 + j, g);
      x4_gather<L>(g, q);
#pragma unroll
      for (int j = 0; j < L; ++j) x4_dbl_r2(own[j], lane0 + j, g);
    }
    for (int t = 0; t < 2; ++t) {
      x4_gather_xy<L>(g, own);
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int lane = lane0 + j;
        if (t)
          hot_entry_lane(op[j], lane, w[j], hdig);
        else
          x4_entry(op[j], lane, btab, hot_saturate(sdig));
        x4_add_r1(q[j], lane, g, op[j]);
      }
      x4_gather<L>(g, q);
#pragma unroll
      for (int j = 0; j < L; ++j) x4_add_r2(own[j], lane0 + j, g);
    }
  }

  x4_gather<L>(g, own);
  const ge_p3 acc = {g[0], g[1], g[2], g[3]};
  return ge_p3_encodes_to(acc, r);
}

#ifndef __CUDACC__
// The kernel's bit for one row, its four lanes run in turn on the host.
inline int verify_hot_row_x4(const int16_t* atab, const uint8_t r[32],
                             const uint8_t s[32], const uint8_t h[32],
                             const verify_hot_consts& K) {
  fe btab[kHotTableFe];
  for (int i = 0; i < kHotTableFe; ++i) x4_stage_affine(btab, K.base, i);
  return verify_hot_row_lanes<4>(0, atab, r, s, h, btab);
}
#endif
