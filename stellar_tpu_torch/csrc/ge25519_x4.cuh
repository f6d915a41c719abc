// ed25519 group operations spread over four lanes: the parallel extended
// formulas of Hisil, Wong, Carter and Dawson ("Twisted Edwards Curves
// Revisited", ASIACRYPT 2008) for a = -1.
//
// Lane j of a group of four owns coordinate j of an extended point:
// 0 = X, 1 = Y, 2 = Z, 3 = T. A doubling or an addition is two rounds of
// four independent field products, one a lane:
//
//   doubling (dbl-2008-hwcd), 4S + 4M
//     round 1   A = X^2, B = Y^2, C = 2 Z^2, D = (X + Y)^2
//               E = D - (A + B), G = B - A, F = C - G, H = A + B
//   addition of a cached entry (Y2 - X2, Y2 + X2, 2 Z2, 2d T2), 8M
//     round 1   A = (Y1 - X1)(Y2 - X2), B = (Y1 + X1)(Y2 + X2),
//               D = Z1 * 2 Z2, C = T1 * 2d T2
//               E = B - A, F = D - C, G = D + C, H = B + A
//   round 2 of both:  X3 = E F, Y3 = G H, Z3 = F G, T3 = E H
//
// F and H carry the opposite sign of the paper's (F = C - G where it has
// G - C, H = A + B where it has -A - B): both flip, so the point is the
// same, and the four coordinates are then ref10's ge_p2_dbl / ge_add /
// ge_madd followed by ge_p1p1_to_p3 (ge25519.cuh) value for value, which
// is what the host tests compare. An affine entry of the base table is
// the cached entry with Z2 = 1 (2 Z2 = 2): lane 2 multiplies by the
// constant 2, which costs it no time while its three neighbours multiply,
// and the formulas' work stays ref10's 7M for ge_madd.
//
// Every round is a pure function of (lane, the values gathered from the
// four lanes, this lane's operand) that returns this lane's value. The
// gather is apart: on the card __shfl_sync over the group's four lanes;
// in the host build (tests/test_torch_verify.py) an array, the four lanes
// run in turn. Round 1 of either formula reads g[0] (X), g[1] (Y) and
// g[lane] only, so the card gathers X and Y (2 x 10 shuffles) and passes
// its own coordinate in g[2] and g[3]; round 2 reads all four (4 x 10).
//
// The formulas are complete for a = -1, so they hold for every pair of
// curve points, the identity and the small-order points included. Every
// lane runs the same instructions (its operands are picked by selects,
// not branches), so no shuffle sits in a divergent branch.
#pragma once
#include "ge25519.cuh"

// Bounds. Every value a lane keeps between rounds (its coordinate, a
// gathered value, a table component) comes out of fe_mul, fe_sq or a
// carried function of fe25519.cuh, or is the sum or difference of two
// such (a table's Y - X, Y + X, 2Z), or is a constant's canonical limbs
// (below 2^26, two units). Call one unit the bound of the
// former: limbs below 2^25 + 20 (even) and 2^24 + 2^15 (odd; fe_mul's
// limbs 1 and 5 keep a last carry). The sums and differences inside a
// round are not carried: fe_mul(f, g) and fe_sq(f) stay exact while
// 2|f_i|, 4|f_i| and 19|g_j| fit int32 and each of their ten 64-bit sums
// stays below 2^63, which holds for limbs of three units (19 * 3 *
// (2^25 + 20) < 2^31; ten terms below 2 * 3 * 2^25.1 * 19 * 3 * 2^25.1 <
// 2^61). C = 2 Z^2 is carried, so E = D - (A + B) and F = C - G are
// three units and every other sum at most two, and no sum is added to
// again before its product. tests/test_torch_verify.py holds fe_mul and
// fe_sq to their exact values at those bounds.
FE_FN void fe_add_raw(fe& h, const fe& f, const fe& g) {
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = f.v[i] + g.v[i];
}

FE_FN void fe_sub_raw(fe& h, const fe& f, const fe& g) {
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = f.v[i] - g.v[i];
}

// The lane's own value among four: a select, no indexed load.
FE_FN void fe_pick4(fe& out, int lane, const fe& a0, const fe& a1,
                    const fe& a2, const fe& a3) {
#pragma unroll
  for (int i = 0; i < 10; ++i)
    out.v[i] = lane == 0 ? a0.v[i]
               : lane == 1 ? a1.v[i]
               : lane == 2 ? a2.v[i] : a3.v[i];
}

// Round 2 of both formulas from E, F, G, H: X3 = E F, Y3 = G H, Z3 = F G,
// T3 = E H.
FE_FN void x4_round2(fe& out, int lane, const fe& e, const fe& f,
                     const fe& g, const fe& h) {
  fe a, b;
  fe_pick4(a, lane, e, g, f, e);
  fe_pick4(b, lane, f, h, g, h);
  fe_mul(out, a, b);
}

// Doubling, round 1: lane 0 X^2, lane 1 Y^2, lane 2 2 Z^2, lane 3
// (X + Y)^2.
FE_FN void x4_dbl_r1(fe& out, int lane, const fe g[4]) {
  fe xy, in;
  fe_add_raw(xy, g[0], g[1]);
  fe_pick4(in, lane, g[0], g[1], g[2], xy);
  fe_sq(out, in);
  fe twice;
  fe_add(twice, out, out);  // carried: F = C - G
  fe_pick4(out, lane, out, out, twice, out);
}

// Doubling, round 2, from round 1's (A, B, C, D) gathered.
FE_FN void x4_dbl_r2(fe& out, int lane, const fe q[4]) {
  fe e, f, g, h;
  fe_add_raw(h, q[0], q[1]);
  fe_sub_raw(g, q[1], q[0]);
  fe_sub_raw(e, q[3], h);
  fe_sub_raw(f, q[2], g);
  x4_round2(out, lane, e, f, g, h);
}

// Addition, round 1: this lane's component ``op`` of the cached entry
// (lane 0 Y2 - X2, lane 1 Y2 + X2, lane 2 2 Z2, lane 3 2d T2) times lane
// 0 Y1 - X1, lane 1 Y1 + X1, lane 2 Z1, lane 3 T1.
FE_FN void x4_add_r1(fe& out, int lane, const fe g[4], const fe& op) {
  fe ymx, ypx, in;
  fe_sub_raw(ymx, g[1], g[0]);
  fe_add_raw(ypx, g[1], g[0]);
  fe_pick4(in, lane, ymx, ypx, g[2], g[3]);
  fe_mul(out, in, op);
}

// Addition, round 2, from round 1's (A, B, D, C) gathered.
FE_FN void x4_add_r2(fe& out, int lane, const fe q[4]) {
  fe e, f, g, h;
  fe_sub_raw(e, q[1], q[0]);
  fe_sub_raw(f, q[2], q[3]);
  fe_add_raw(g, q[2], q[3]);
  fe_add_raw(h, q[1], q[0]);
  x4_round2(out, lane, e, f, g, h);
}

// This lane's component of the cached form (Y - X, Y + X, 2 Z, 2d T) of
// the point whose X and Y are gathered: one product, lane 3's (the others
// compute it too and drop it, in the same time).
FE_FN void x4_to_cached(fe& out, int lane, const fe g[4], const fe& d2) {
  fe ymx, ypx, z2, t2d;
  fe_sub_raw(ymx, g[1], g[0]);
  fe_add_raw(ypx, g[1], g[0]);
  fe_add_raw(z2, g[2], g[2]);
  fe_mul(t2d, g[3], d2);
  fe_pick4(out, lane, ymx, ypx, z2, t2d);
}

// This lane's component of entry |digit| of a cached table laid out
// [entry][component], negated for a negative digit: -P swaps Y - X and
// Y + X and negates 2d T, so lanes 0 and 1 read each other's component
// and lane 3 negates; lane 2 reads its own.
FE_FN void x4_entry(fe& out, int lane, const fe* tab, int digit) {
  const int neg = digit < 0;
  const int m = neg ? -digit : digit;
  const int comp = (lane < 2 && neg) ? lane ^ 1 : lane;
  out = tab[4 * m + comp];
  fe minus;
  fe_neg(minus, out);
  if (lane == 3 && neg) out = minus;
}

// The identity's cached component for this lane: (1, 1, 2, 0).
FE_FN void x4_identity_cached(fe& out, int lane) {
  fe_0(out);
  out.v[0] = lane == 2 ? 2 : (lane == 3 ? 0 : 1);
}

// Element ``idx`` (entry idx / 4, component idx % 4) of an affine table
// in cached form, laid out [entry][component] for x4_entry: entry 0 the
// identity, entry v the affine ``base[v - 1]`` = v*P as (y - x, y + x, 2,
// 2dxy).
FE_FN void x4_stage_affine(fe* tab, const ge_precomp* base, int idx) {
  const int k = idx >> 2, comp = idx & 3;
  fe out;
  x4_identity_cached(out, comp);
  if (k > 0) {
    const ge_precomp& e = base[k - 1];
    if (comp == 0) out = e.yminusx;
    if (comp == 1) out = e.yplusx;
    if (comp == 3) out = e.xy2d;
  }
  tab[idx] = out;
}

// The gather. ``L`` is the number of lanes one thread runs: 1 on the card
// (this thread is lane ``lane0``), 4 in the host build (lanes 0..3 in
// turn, ``own[j]`` lane j's value).
#if defined(__CUDACC__)
template <int L>
__device__ __forceinline__ void x4_gather(fe g[4], const fe own[L]) {
  static_assert(L == 1, "a CUDA thread runs one lane");
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 10; ++i)
      g[k].v[i] = __shfl_sync(0xffffffffu, own[0].v[i], k, 4);
}

// X and Y from lanes 0 and 1; g[2] and g[3] hold this lane's own value.
template <int L>
__device__ __forceinline__ void x4_gather_xy(fe g[4], const fe own[L]) {
  static_assert(L == 1, "a CUDA thread runs one lane");
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int i = 0; i < 10; ++i)
      g[k].v[i] = __shfl_sync(0xffffffffu, own[0].v[i], k, 4);
  g[2] = own[0];
  g[3] = own[0];
}

__device__ __forceinline__ void x4_sync() { __syncwarp(); }
#else
template <int L>
inline void x4_gather(fe g[4], const fe own[L]) {
  static_assert(L == 4, "the host build runs the four lanes in turn");
  for (int k = 0; k < 4; ++k) g[k] = own[k];
}

// The host gathers all four values; round 1 reads only g[0], g[1] and
// g[lane], the values the card's gather gives it.
template <int L>
inline void x4_gather_xy(fe g[4], const fe own[L]) {
  x4_gather<L>(g, own);
}

inline void x4_sync() {}
#endif
