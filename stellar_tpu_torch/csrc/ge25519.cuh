// ed25519 group operations for one CUDA thread, in ref10's point forms:
//   ge_p2      projective (X : Y : Z)
//   ge_p3      extended   (X : Y : Z : T), x = X/Z, y = Y/Z, xy = T/Z
//   ge_p1p1    completed  ((X : Z), (Y : T))
//   ge_precomp affine cached (y + x, y - x, 2d*x*y), Z == 1
//   ge_cached  projective cached (Y + X, Y - X, Z, 2d*T)
//
// Replaces the group layer of stellar_tpu/ops/edwards.py (point_double,
// point_add_cached with its affine and projective forms, to_cached,
// decompress, compress_equals).
// The formulas are the complete unified ones for a = -1, so they hold for
// every pair of curve points, small-order and identity included.
#pragma once
#include "fe25519.cuh"

struct ge_p2 {
  fe X, Y, Z;
};
struct ge_p3 {
  fe X, Y, Z, T;
};
struct ge_p1p1 {
  fe X, Y, Z, T;
};
struct ge_precomp {
  fe yplusx, yminusx, xy2d;
};
struct ge_cached {
  fe YplusX, YminusX, Z, T2d;
};

// Curve constants, canonical limbs: d, 2d, sqrt(-1).
struct ge_consts {
  fe d, d2, sqrtm1;
};

FE_FN void ge_p3_0(ge_p3& h) {
  fe_0(h.X);
  fe_1(h.Y);
  fe_1(h.Z);
  fe_0(h.T);
}

// 4 multiplies
FE_CALL void ge_p1p1_to_p3(ge_p3& r, const ge_p1p1& p) {
  fe_mul(r.X, p.X, p.T);
  fe_mul(r.Y, p.Y, p.Z);
  fe_mul(r.Z, p.Z, p.T);
  fe_mul(r.T, p.X, p.Y);
}

// r = 2p: 4 squarings (ref10 ge_p2_dbl)
FE_CALL void ge_p2_dbl(ge_p1p1& r, const ge_p2& p) {
  fe t0;
  fe_sq(r.X, p.X);
  fe_sq(r.Z, p.Y);
  fe_sq(r.T, p.Z);
  fe_add(r.T, r.T, r.T);
  fe_add(r.Y, p.X, p.Y);
  fe_sq(t0, r.Y);
  fe_add(r.Y, r.Z, r.X);
  fe_sub(r.Z, r.Z, r.X);
  fe_sub(r.X, t0, r.Y);
  fe_sub(r.T, r.T, r.Z);
}

// cached form of p: 1 multiply (ref10 ge_p3_to_cached)
FE_CALL void ge_p3_to_cached(ge_cached& r, const ge_p3& p, const fe& d2) {
  fe_add(r.YplusX, p.Y, p.X);
  fe_sub(r.YminusX, p.Y, p.X);
  r.Z = p.Z;
  fe_mul(r.T2d, p.T, d2);
}

// r = p + q with q projective cached: 4 multiplies (ref10 ge_add)
FE_CALL void ge_add(ge_p1p1& r, const ge_p3& p, const ge_cached& q) {
  fe t0;
  fe_add(r.X, p.Y, p.X);
  fe_sub(r.Y, p.Y, p.X);
  fe_mul(r.Z, r.X, q.YplusX);
  fe_mul(r.Y, r.Y, q.YminusX);
  fe_mul(r.T, q.T2d, p.T);
  fe_mul(r.X, p.Z, q.Z);
  fe_add(t0, r.X, r.X);
  fe_sub(r.X, r.Z, r.Y);
  fe_add(r.Y, r.Z, r.Y);
  fe_add(r.Z, t0, r.T);
  fe_sub(r.T, t0, r.T);
}

// r = p - q with q projective cached: 4 multiplies (ref10 ge_sub)
FE_CALL void ge_sub(ge_p1p1& r, const ge_p3& p, const ge_cached& q) {
  fe t0;
  fe_add(r.X, p.Y, p.X);
  fe_sub(r.Y, p.Y, p.X);
  fe_mul(r.Z, r.X, q.YminusX);
  fe_mul(r.Y, r.Y, q.YplusX);
  fe_mul(r.T, q.T2d, p.T);
  fe_mul(r.X, p.Z, q.Z);
  fe_add(t0, r.X, r.X);
  fe_sub(r.X, r.Z, r.Y);
  fe_add(r.Y, r.Z, r.Y);
  fe_sub(r.Z, t0, r.T);
  fe_add(r.T, t0, r.T);
}

// r = p + q with q affine: 3 multiplies (ref10 ge_madd)
FE_CALL void ge_madd(ge_p1p1& r, const ge_p3& p, const ge_precomp& q) {
  fe t0;
  fe_add(r.X, p.Y, p.X);
  fe_sub(r.Y, p.Y, p.X);
  fe_mul(r.Z, r.X, q.yplusx);
  fe_mul(r.Y, r.Y, q.yminusx);
  fe_mul(r.T, q.xy2d, p.T);
  fe_add(t0, p.Z, p.Z);
  fe_sub(r.X, r.Z, r.Y);
  fe_add(r.Y, r.Z, r.Y);
  fe_add(r.Z, t0, r.T);
  fe_sub(r.T, t0, r.T);
}

// -q for an affine cached entry: swap y+x and y-x, negate 2dxy.
FE_FN void ge_precomp_neg(ge_precomp& q) {
  const fe t = q.yplusx;
  q.yplusx = q.yminusx;
  q.yminusx = t;
  fe_neg(q.xy2d, q.xy2d);
}

// -A from its 32-byte encoding (libsodium ge25519_frombytes, negated):
// y is taken mod p, the root comes from the (p-5)/8 exponent and is fixed
// by sqrt(-1) when v*x^2 == -u. Returns 0 when there is no root, or when
// x == 0 with the sign bit set ("negative zero"). 4 sq + 9 mul around one
// fe_pow22523; the sqrt(-1) product is always taken, then selected.
FE_CALL int ge_frombytes_negate(ge_p3& h, const uint8_t s[32],
                              const ge_consts& c) {
  fe u, v, v3, vxx, check, xs;
  fe_frombytes(h.Y, s);
  fe_1(h.Z);
  fe_sq(u, h.Y);
  fe_mul(v, u, c.d);
  fe_sub(u, u, h.Z);      // u = y^2 - 1
  fe_add(v, v, h.Z);      // v = d*y^2 + 1
  fe_sq(v3, v);
  fe_mul(v3, v3, v);      // v^3
  fe_sq(h.X, v3);
  fe_mul(h.X, h.X, v);
  fe_mul(h.X, h.X, u);    // u*v^7
  fe_pow22523(h.X, h.X);  // (u*v^7)^((p-5)/8)
  fe_mul(h.X, h.X, v3);
  fe_mul(h.X, h.X, u);    // candidate root u*v^3*(u*v^7)^((p-5)/8)
  fe_sq(vxx, h.X);
  fe_mul(vxx, vxx, v);    // v*x^2
  fe_sub(check, vxx, u);
  const int direct = fe_iszero(check);
  fe_add(check, vxx, u);
  const int twist = fe_iszero(check);
  fe_mul(xs, h.X, c.sqrtm1);
  if (!direct) h.X = xs;  // when both hold, u == 0 and x == 0 either way
  const int sign = s[31] >> 7;
  const int ok = (direct | twist) & !(fe_iszero(h.X) & sign);
  // x takes the encoded sign; -A then negates it
  if (fe_isnegative(h.X) == sign) fe_neg(h.X, h.X);
  fe_mul(h.T, h.X, h.Y);
  return ok;
}

// encode(p) == r bytewise: one inversion, two multiplies.
FE_CALL int ge_p3_encodes_to(const ge_p3& p, const uint8_t r[32]) {
  fe zinv, x, y;
  fe_invert(zinv, p.Z);
  fe_mul(x, p.X, zinv);
  fe_mul(y, p.Y, zinv);
  uint8_t enc[32];
  fe_tobytes(enc, y);
  enc[31] ^= (uint8_t)(fe_isnegative(x) << 7);
  int eq = 1;
  for (int b = 0; b < 32; ++b) eq &= enc[b] == r[b];
  return eq;
}
