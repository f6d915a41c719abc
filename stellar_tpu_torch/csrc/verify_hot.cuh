// K2's per-row arithmetic: the hot-signer verify of one row, for one CUDA
// thread. Everything here also compiles as host C++ (FE_FN / FE_CALL set
// to plain functions), which is how the CPU tests run it.
#pragma once
#include <string.h>

#include "ge25519.cuh"

constexpr int kHotEntries = 128;          // multiples 1..128 in a table
constexpr int kEntryLimbs = 3 * 20;       // (y+x, y-x, 2dxy), 13-bit limbs
constexpr int kTableLimbs = kHotEntries * kEntryLimbs;

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

// Index of entry min(|digit|, 128) in a table of multiples 1..128. A top
// digit above 128 saturates at the last entry, as the reference's select
// tree does. digit != 0.
FE_FN int hot_entry(int digit) {
  const int m = digit < 0 ? -digit : digit;
  return (m > kHotEntries ? kHotEntries : m) - 1;
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

// Entry `index` of the row's int16 table, read as fifteen 8-byte words
// (the table and each entry's 120 bytes are 8-byte aligned).
FE_FN void load_hot_entry(ge_precomp& q, const int16_t* table, int index) {
  const uint64_t* src =
      reinterpret_cast<const uint64_t*>(table + index * kEntryLimbs);
  uint64_t w[15];
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int k = 0; k < 15; ++k)
    w[k] = __ldg(reinterpret_cast<const unsigned long long*>(src) + k);
#else
  memcpy(w, src, sizeof(w));
#endif
  fe_from_limbs13(q.yplusx, w);
  fe_from_limbs13(q.yminusx, w + 5);
  fe_from_limbs13(q.xy2d, w + 10);
}

// The device bit for one hot row: encode(s*B + h*(-A)) == R, with -A's
// multiples from the row's cached table (kTableLimbs int16, canonical).
// There is no decompression: cache membership is its proof.
FE_FN int verify_hot_row(const int16_t* atab, const uint8_t r[32],
                         const uint8_t s[32], const uint8_t h[32],
                         const verify_hot_consts& K) {
  int16_t sd[32], hd[32];
  recode256(sd, s);
  recode256(hd, h);

  // Strauss-Shamir over both scalars, most significant window first: 31
  // windows of 8 doublings, an add for each nonzero digit.
  ge_p3 acc;
  ge_p3_0(acc);
  ge_p1p1 t;
  ge_precomp e;
  for (int w = 31; w >= 0; --w) {
    if (w != 31) {
      ge_p2 q = {acc.X, acc.Y, acc.Z};
      for (int k = 0; k < 7; ++k) {
        ge_p2_dbl(t, q);
        ge_p1p1_to_p2(q, t);
      }
      ge_p2_dbl(t, q);
      ge_p1p1_to_p3(acc, t);
    }
    if (sd[w]) {
      e = K.base[hot_entry(sd[w])];
      if (sd[w] < 0) ge_precomp_neg(e);
      ge_madd(t, acc, e);
      ge_p1p1_to_p3(acc, t);
    }
    if (hd[w]) {
      load_hot_entry(e, atab, hot_entry(hd[w]));
      if (hd[w] < 0) ge_precomp_neg(e);
      ge_madd(t, acc, e);
      ge_p1p1_to_p3(acc, t);
    }
  }
  return ge_p3_encodes_to(acc, r);
}
