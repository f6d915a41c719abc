// GF(2^255-19) arithmetic for one CUDA thread: ref10's representation,
// ten signed int32 limbs in radix 2^25.5 (limb i has weight 2^ceil(25.5*i):
// 26 bits for even i, 25 for odd i), products in 64 bits.
//
// Replaces the field layer of stellar_tpu/ops/field25519.py. That layer uses
// 20 x 13-bit limbs so that a product fits int32 on the TPU's vector unit;
// Hopper multiplies 32x32->64 natively (one IMAD.WIDE), so ten limbs take
// 100 multiply-adds per product instead of 400.
//
// Bounds. Every function here returns limbs of magnitude below about 2^25
// (fe_carry's chain), and fe_mul / fe_sq accept inputs whose limbs are below
// 2^26: the largest product term, 2*f * 19*g, is below 2^32 * 2^31 and a sum
// of ten stays below 2^63. Because fe_add and fe_sub also carry, any chain
// of these functions stays in bounds without further bookkeeping.
#pragma once
#include <stdint.h>

// FE_FN functions are inlined; FE_CALL marks the few large ones (point
// operations, exponent chains) kept out of line so that the kernel's code
// stays small enough for the instruction cache and for a quick build.
#ifndef FE_FN
#define FE_FN __device__ __forceinline__
#endif
#ifndef FE_CALL
#define FE_CALL __device__ __noinline__
#endif

struct fe {
  int32_t v[10];
};

// An empty asm that the compiler must treat as changing ``x``, a 32-bit
// register. fe_mul and fe_sq pass every input limb through it, so that
// each 32x32->64 product compiles to one signed IMAD.WIDE. Without it the
// exponent chains' products (fe_pow22501) compiled as 64-bit ones: the
// limbs' sign words (SHF.R.S32.HI), IMAD.WIDE.U32 and two fix-up IMADs,
// 353 instructions a squaring on sm_90a against 159 with the barrier, and
// K1's registers went from 128 to 254. The host build needs none of it.
#ifdef __CUDA_ARCH__
#define FE_OPAQUE(x) asm("" : "+r"(x))
#else
#define FE_OPAQUE(x) (void)0
#endif

// Carry a wide accumulator into limb range: ref10's interleaved chain
// (fe_mul's tail). Input limbs up to about 2^62 in magnitude.
FE_FN void fe_carry_wide(fe& out, int64_t h[10]) {
  int64_t c;
  c = (h[0] + (int64_t(1) << 25)) >> 26; h[1] += c; h[0] -= c * (int64_t(1) << 26);
  c = (h[4] + (int64_t(1) << 25)) >> 26; h[5] += c; h[4] -= c * (int64_t(1) << 26);
  c = (h[1] + (int64_t(1) << 24)) >> 25; h[2] += c; h[1] -= c * (int64_t(1) << 25);
  c = (h[5] + (int64_t(1) << 24)) >> 25; h[6] += c; h[5] -= c * (int64_t(1) << 25);
  c = (h[2] + (int64_t(1) << 25)) >> 26; h[3] += c; h[2] -= c * (int64_t(1) << 26);
  c = (h[6] + (int64_t(1) << 25)) >> 26; h[7] += c; h[6] -= c * (int64_t(1) << 26);
  c = (h[3] + (int64_t(1) << 24)) >> 25; h[4] += c; h[3] -= c * (int64_t(1) << 25);
  c = (h[7] + (int64_t(1) << 24)) >> 25; h[8] += c; h[7] -= c * (int64_t(1) << 25);
  c = (h[4] + (int64_t(1) << 25)) >> 26; h[5] += c; h[4] -= c * (int64_t(1) << 26);
  c = (h[8] + (int64_t(1) << 25)) >> 26; h[9] += c; h[8] -= c * (int64_t(1) << 26);
  c = (h[9] + (int64_t(1) << 24)) >> 25; h[0] += c * 19; h[9] -= c * (int64_t(1) << 25);
  c = (h[0] + (int64_t(1) << 25)) >> 26; h[1] += c; h[0] -= c * (int64_t(1) << 26);
#pragma unroll
  for (int i = 0; i < 10; ++i) out.v[i] = (int32_t)h[i];
}

// Carry limbs of magnitude below 2^30 (sums and differences) in 32 bits.
FE_FN void fe_carry(fe& h) {
  int32_t c;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int bits = (i & 1) ? 25 : 26;
    c = (h.v[i] + (1 << (bits - 1))) >> bits;
    h.v[i + 1] += c;
    h.v[i] -= c * (1 << bits);
  }
  c = (h.v[9] + (1 << 24)) >> 25;
  h.v[9] -= c * (1 << 25);
  h.v[0] += c * 19;
  c = (h.v[0] + (1 << 25)) >> 26;
  h.v[0] -= c * (1 << 26);
  h.v[1] += c;
}

FE_FN void fe_0(fe& h) {
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = 0;
}

FE_FN void fe_1(fe& h) {
  fe_0(h);
  h.v[0] = 1;
}

FE_FN void fe_add(fe& h, const fe& f, const fe& g) {
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = f.v[i] + g.v[i];
  fe_carry(h);
}

FE_FN void fe_sub(fe& h, const fe& f, const fe& g) {
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = f.v[i] - g.v[i];
  fe_carry(h);
}

FE_FN void fe_neg(fe& h, const fe& f) {
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = -f.v[i];
}

// h = f * g: 100 products. Limb i times limb j lands on limb i+j; when both
// i and j are odd the weights add to one more than limb i+j's, so f is
// doubled; past limb 9 the product wraps by 2^255 == 19, so g is times 19.
FE_FN void fe_mul(fe& h, const fe& f_in, const fe& g_in) {
  fe f = f_in, g = g_in;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    FE_OPAQUE(f.v[i]);
    FE_OPAQUE(g.v[i]);
  }
  int32_t f2[10], g19[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    f2[i] = 2 * f.v[i];
    g19[i] = 19 * g.v[i];
  }
  int64_t acc[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) acc[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      const int32_t a = (i & j & 1) ? f2[i] : f.v[i];
      const int32_t b = (i + j >= 10) ? g19[j] : g.v[j];
      acc[(i + j) % 10] += (int64_t)a * b;
    }
  }
  fe_carry_wide(h, acc);
}

// h = f^2: 55 products, the cross terms doubled once.
FE_FN void fe_sq(fe& h, const fe& f_in) {
  fe f = f_in;
#pragma unroll
  for (int i = 0; i < 10; ++i) FE_OPAQUE(f.v[i]);
  int32_t f2[10], f4[10], f19[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    f2[i] = 2 * f.v[i];
    f4[i] = 4 * f.v[i];
    f19[i] = 19 * f.v[i];
  }
  int64_t acc[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) acc[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = i; j < 10; ++j) {
      // multiplier 2 for a cross term, 2 more when both limbs are odd
      const int twos = (i != j) + (i & j & 1);
      const int32_t a = twos == 2 ? f4[i] : (twos == 1 ? f2[i] : f.v[i]);
      const int32_t b = (i + j >= 10) ? f19[j] : f.v[j];
      acc[(i + j) % 10] += (int64_t)a * b;
    }
  }
  fe_carry_wide(h, acc);
}

// f^(2^n) by n squarings, one a pass of a loop the compiler keeps.
FE_FN void fe_sqn(fe& h, const fe& f, int n) {
  fe x = f;
#pragma unroll 1
  for (int i = 0; i < n; ++i) fe_sq(x, x);
  h = x;
}

// Shared ref10 addition chain: t1 = z^(2^250-1), z11 = z^11.
// 249 squarings, 11 multiplies.
FE_CALL void fe_pow22501(fe& t1, fe& z11, const fe& z) {
  fe t0, t2, t3;
  fe_sq(t0, z);            // z^2
  fe_sqn(t1, t0, 2);       // z^8
  fe_mul(t1, z, t1);       // z^9
  fe_mul(z11, t0, t1);     // z^11
  fe_sq(t2, z11);          // z^22
  fe_mul(t1, t1, t2);      // z^(2^5-1)
  fe_sqn(t2, t1, 5);
  fe_mul(t1, t2, t1);      // z^(2^10-1)
  fe_sqn(t2, t1, 10);
  fe_mul(t2, t2, t1);      // z^(2^20-1)
  fe_sqn(t3, t2, 20);
  fe_mul(t2, t3, t2);      // z^(2^40-1)
  fe_sqn(t2, t2, 10);
  fe_mul(t1, t2, t1);      // z^(2^50-1)
  fe_sqn(t2, t1, 50);
  fe_mul(t2, t2, t1);      // z^(2^100-1)
  fe_sqn(t3, t2, 100);
  fe_mul(t2, t3, t2);      // z^(2^200-1)
  fe_sqn(t2, t2, 50);
  fe_mul(t1, t2, t1);      // z^(2^250-1)
}

// z^(p-2) = z^(2^255-21), the inverse (0 maps to 0). 254 sq, 11 mul.
FE_FN void fe_invert(fe& out, const fe& z) {
  fe t1, z11;
  fe_pow22501(t1, z11, z);
  fe_sqn(t1, t1, 5);
  fe_mul(out, t1, z11);
}

// z^((p-5)/8) = z^(2^252-3), the square-root exponent. 251 sq, 11 mul.
FE_FN void fe_pow22523(fe& out, const fe& z) {
  fe t1, z11;
  fe_pow22501(t1, z11, z);
  fe_sqn(t1, t1, 2);
  fe_mul(out, t1, z);
}

// Little-endian bytes, low 255 bits (bit 255 ignored); the value may be
// >= p, as ge25519_frombytes allows.
FE_FN void fe_frombytes(fe& h, const uint8_t s[32]) {
  int64_t w[10];
  // limb i starts at bit ceil(25.5*i)
  const int start[10] = {0, 26, 51, 77, 102, 128, 153, 179, 204, 230};
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int bits = (i & 1) ? 25 : 26;
    const int lo = start[i];
    uint64_t x = 0;
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      const int byte = (lo >> 3) + b;
      if (byte < 32) x |= (uint64_t)s[byte] << (8 * b);
    }
    // limb 9 holds bits 230..254, so bit 255 drops out here
    w[i] = (int64_t)((x >> (lo & 7)) & ((uint64_t(1) << bits) - 1));
  }
  fe_carry_wide(h, w);
}

// Canonical little-endian encoding of h (value mod p, in [0, p)).
FE_FN void fe_tobytes(uint8_t s[32], const fe& f) {
  int32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = f.v[i];
  // q = floor(h / p) in {0, 1} for |h| in fe_carry's range (ref10)
  int32_t q = (19 * h[9] + (1 << 24)) >> 25;
#pragma unroll
  for (int i = 0; i < 10; ++i) q = (h[i] + q) >> ((i & 1) ? 25 : 26);
  h[0] += 19 * q;
  // h - q*p, carried exactly; the carry off limb 9 is the dropped 2^255*q
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int bits = (i & 1) ? 25 : 26;
    const int32_t c = h[i] >> bits;
    h[i + 1] += c;
    h[i] -= c * (1 << bits);
  }
  h[9] &= (1 << 25) - 1;
  // pack the 255 bits
  const int start[10] = {0, 26, 51, 77, 102, 128, 153, 179, 204, 230};
#pragma unroll
  for (int b = 0; b < 32; ++b) s[b] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint64_t x = (uint64_t)(uint32_t)h[i] << (start[i] & 7);
    const int byte = start[i] >> 3;
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      if (byte + b < 32) s[byte + b] |= (uint8_t)(x >> (8 * b));
    }
  }
}

FE_FN int fe_isnegative(const fe& f) {
  uint8_t s[32];
  fe_tobytes(s, f);
  return s[0] & 1;
}

FE_FN int fe_iszero(const fe& f) {
  uint8_t s[32];
  fe_tobytes(s, f);
  uint8_t acc = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) acc |= s[b];
  return acc == 0;
}
