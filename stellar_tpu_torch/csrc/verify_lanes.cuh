// The cold verify of one row on four lanes (ge25519_x4.cuh), shared by K1
// (csrc/verify_cold.cu, signed radix 32) and K5 (csrc/verify_r16.cu,
// signed radix 16): the window width is a template parameter, and the
// two kernels differ in nothing else.
//
// For a row (A, R, s, h) it returns
//     decompress_ok(A) AND encode(s*B + h*(-A)) == R   (bytewise).
//
// * Decompress and the final encode (one square-root chain, one
//   inversion) are one chain each; all four lanes compute them, in the
//   time one would.
// * The table of -A holds the multiples 0..M (M = 2^(bits - 1)) in
//   projective cached form (Y - X, Y + X, 2Z, 2dT), built by one doubling
//   and M - 2 additions in four-lane rounds: no inversion. It is laid out
//   [entry][component], each lane writing and reading its own component;
//   a negative digit swaps components 0 and 1 and negates 3, so no lane
//   needs a shuffle to read it. The caller stages B's affine table in
//   the same layout, 2Z = 2.
// * Strauss-Shamir over the signed digits, most significant window first,
//   and every window runs its s-add and h-add: a zero digit adds entry 0,
//   the identity (1, 1, 2, 0). The formulas are complete, so that is
//   exact, and no lane of a warp branches around a shuffle.
// * Where the top digit can exceed M (radix 16: up to 16 for a scalar
//   from 0x8777...78 on), both tables end with a zero entry, all four
//   components 0, and such a digit selects it, as the reference's one-hot
//   select does. Adding it gives A = B = C = D = 0 in round 1, so the
//   accumulator becomes (0, 0, 0, 0) and stays there: every later round
//   multiplies a zero. It encodes to 32 zero bytes (the inverse of 0 is
//   0), so the row's bit is decompress_ok(A) AND R == 0, the plain
//   version's bit. The top digit is never negative, so the zero entry is
//   never negated.
//
// Tables are indexed directly by |digit|: verification data is public,
// and libsodium's verify is itself variable-time.
#pragma once
#include <stdint.h>

#include "ge25519_x4.cuh"

// The window scheme of ``Bits`` bits a window.
template <int Bits>
struct ladder {
  static constexpr int windows = (256 + Bits - 1) / Bits;
  static constexpr int multiples = 1 << (Bits - 1);
  // the top window holds the scalar's last bits and the last carry
  static constexpr int top_max = 1 << (256 - Bits * (windows - 1));
  static constexpr bool zero_entry = top_max > multiples;
  static constexpr int entries = multiples + 1 + zero_entry;
  static constexpr int table_fe = 4 * entries;
};

// Signed radix-32 recode: 52 digits, least significant first, in [-16, 16)
// except the top one, which keeps the last carry and is at most 2 for any
// 256-bit scalar (window 51 holds only bit 255). So |digit| <= 16 always.
FE_FN void recode32(int8_t d[52], const uint8_t s[32]) {
  int carry = 0;
  for (int i = 0; i < 52; ++i) {
    const int bit = 5 * i;
    const int byte = bit >> 3;
    int v = s[byte];
    if (byte + 1 < 32) v |= s[byte + 1] << 8;
    int e = ((v >> (bit & 7)) & 31) + carry;
    carry = 0;
    if (i < 51 && e >= 16) {
      e -= 32;
      carry = 1;
    }
    d[i] = (int8_t)e;
  }
}

// Signed radix-16 recode: 64 digits, least significant first, in [-8, 8)
// except the top one, which keeps the last carry unsigned and lies in
// [0, 16].
FE_FN void recode16(int8_t d[64], const uint8_t s[32]) {
  int carry = 0;
  for (int i = 0; i < 64; ++i) {
    int e = ((s[i >> 1] >> (4 * (i & 1))) & 15) + carry;
    carry = 0;
    if (i < 63 && e >= 8) {
      e -= 16;
      carry = 1;
    }
    d[i] = (int8_t)e;
  }
}

// The device bit for one row, on ``L`` lanes starting at ``lane0`` (the
// card: L = 1, this thread's lane; the host build: L = 4, the group's
// lanes in turn), with windows of ``Bits`` bits (5 or 4). ``btab`` is the
// staged B-table, ``atab`` this row's space for the table of -A,
// ladder<Bits>::table_fe elements each.
template <int L, int Bits>
FE_FN int verify_row_lanes(int lane0, const uint8_t a[32],
                           const uint8_t r[32], const uint8_t s[32],
                           const uint8_t h[32], const ge_consts& c,
                           const fe* btab, fe* atab) {
  using R = ladder<Bits>;
  static_assert(Bits == 5 || Bits == 4, "radix 32 or 16");
  ge_p3 nega;
  const int ok = ge_frombytes_negate(nega, a, c);
  int8_t sd[R::windows], hd[R::windows];
  if constexpr (Bits == 5) {
    recode32(sd, s);
    recode32(hd, h);
  } else {
    recode16(sd, s);
    recode16(hd, h);
  }

  fe own[L], q[L], op[L], p1[L], g[4];
  // the table of -A: entries 0 (identity) and 1, then 2 by a doubling and
  // 3..M by adding entry 1
#pragma unroll
  for (int j = 0; j < L; ++j)
    fe_pick4(own[j], lane0 + j, nega.X, nega.Y, nega.Z, nega.T);
  x4_gather_xy<L>(g, own);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int lane = lane0 + j;
    x4_identity_cached(op[j], lane);
    atab[lane] = op[j];
    x4_to_cached(p1[j], lane, g, c.d2);
    atab[4 + lane] = p1[j];
    x4_dbl_r1(q[j], lane, g);
  }
  x4_gather<L>(g, q);
#pragma unroll
  for (int j = 0; j < L; ++j) x4_dbl_r2(own[j], lane0 + j, g);
  for (int k = 2; k <= R::multiples; ++k) {
    if (k > 2) {
#pragma unroll
      for (int j = 0; j < L; ++j) x4_add_r1(q[j], lane0 + j, g, p1[j]);
      x4_gather<L>(g, q);
#pragma unroll
      for (int j = 0; j < L; ++j) x4_add_r2(own[j], lane0 + j, g);
    }
    x4_gather_xy<L>(g, own);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      x4_to_cached(op[j], lane0 + j, g, c.d2);
      atab[4 * k + lane0 + j] = op[j];
    }
  }
  if constexpr (R::zero_entry) {
#pragma unroll
    for (int j = 0; j < L; ++j)
      fe_0(atab[4 * (R::multiples + 1) + lane0 + j]);
  }
  x4_sync();

  // Strauss-Shamir over both scalars, most significant window first,
  // from the identity (0, 1, 1, 0)
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int lane = lane0 + j;
    fe_0(own[j]);
    own[j].v[0] = lane == 1 || lane == 2;
  }
  for (int w = R::windows - 1; w >= 0; --w) {
    const int doublings = w == R::windows - 1 ? 0 : Bits;
    for (int i = 0; i < doublings; ++i) {
      x4_gather_xy<L>(g, own);
#pragma unroll
      for (int j = 0; j < L; ++j) x4_dbl_r1(q[j], lane0 + j, g);
      x4_gather<L>(g, q);
#pragma unroll
      for (int j = 0; j < L; ++j) x4_dbl_r2(own[j], lane0 + j, g);
    }
    // s*B, then h*(-A); a zero digit adds the identity
    for (int t = 0; t < 2; ++t) {
      const fe* tab = t ? atab : btab;
      int digit = t ? hd[w] : sd[w];
      if constexpr (R::zero_entry) {
        if (digit > R::multiples) digit = R::multiples + 1;
      }
      x4_gather_xy<L>(g, own);
#pragma unroll
      for (int j = 0; j < L; ++j) {
        x4_entry(op[j], lane0 + j, tab, digit);
        x4_add_r1(q[j], lane0 + j, g, op[j]);
      }
      x4_gather<L>(g, q);
#pragma unroll
      for (int j = 0; j < L; ++j) x4_add_r2(own[j], lane0 + j, g);
    }
  }

  x4_gather<L>(g, own);
  const ge_p3 acc = {g[0], g[1], g[2], g[3]};
  return ok & ge_p3_encodes_to(acc, r);
}
