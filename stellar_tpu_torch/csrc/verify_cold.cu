// K1, the cold batch ed25519 verify kernel, written for Hopper (sm_90a).
//
// Replaces stellar_tpu/ops/verify.py:verify_kernel (with decompress,
// signed_digits32_dev, _double_scalarmult32, build_point_table_affine,
// fe.batch_inv, table_select_affine and compress_equals under it). For each
// row of (A, R, s, h), 32 bytes each, it writes
//     decompress_ok(A) AND encode(s*B + h*(-A)) == R   (bytewise)
// for every byte pattern; the host's policy gate is ANDed in afterwards.
//
// What bounds it: integer multiplies. A row costs about 3,600 field
// multiplies (255 doublings, up to 104 mixed adds, a 16-entry table of -A
// with its inversion, the square root of decompress, the final inversion),
// each 55 or 100 32x32->64 multiply-adds, against 129 bytes of input and
// output. The operations bound is the card's 32-bit integer multiply rate.
//
// Design (first, simple version): one thread per row, everything in the
// thread's registers and local memory, nothing shared between rows but the
// constants. Field elements are ref10's ten 25.5-bit limbs (fe25519.cuh).
// The 16-entry affine B-table and the curve constants live in __constant__
// memory (filled once from stellar_tpu_torch/state.py) and each block
// stages them in shared memory, since the lanes of a warp pick different
// entries. The per-row A-table (16 x 3 x 10 int32 = 1,920 B) sits in local
// memory; its Z column is normalised by Montgomery's trick inside the
// thread, one Fermat inversion for all 16 entries (the reference's
// cross-lane product tree is a TPU device and is not needed here). Tables
// are indexed directly by |digit|: verification data is public, and
// libsodium's verify is itself variable-time. A zero digit skips its add.
//
// One thread per row fills only 2,048 threads of the card's 132 SMs at a
// 2k-signature TxSet: expected for a first, right kernel. Spreading a row
// over a group of threads is later work.
#include <stdint.h>

#include "ge25519.cuh"

struct verify_consts {
  ge_consts c;
  ge_precomp base[16];  // v*B for v = 1..16
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

// Entry |digit| of a 16-entry table of multiples 1..16, negated for a
// negative digit. digit != 0.
FE_FN void table_select(ge_precomp& out, const ge_precomp* tab, int digit) {
  const int m = digit < 0 ? -digit : digit;
  out = tab[(m - 1) & 15];
  if (digit < 0) ge_precomp_neg(out);
}

// Affine cached multiples 1..16 of p (given extended, Z == 1). 4 sq and
// 4 + 14 * 7 + 1 mul for the multiples, then 15 + 30 + 32 + 32 mul and one
// fe_invert to normalise them.
FE_CALL void build_table(ge_precomp tab[16], const ge_p3& p, const fe& d2) {
  ge_precomp p1;
  fe_add(p1.yplusx, p.Y, p.X);
  fe_sub(p1.yminusx, p.Y, p.X);
  fe_mul(p1.xy2d, p.T, d2);
  // projective multiples: X, Y, Z parked in the entry's three slots
  ge_p3 q = p;
  ge_p1p1 t;
  ge_p2 q2 = {p.X, p.Y, p.Z};
  tab[0].yplusx = p.X;
  tab[0].yminusx = p.Y;
  tab[0].xy2d = p.Z;
  ge_p2_dbl(t, q2);
  ge_p1p1_to_p3(q, t);
  tab[1].yplusx = q.X;
  tab[1].yminusx = q.Y;
  tab[1].xy2d = q.Z;
  for (int k = 2; k < 16; ++k) {
    ge_madd(t, q, p1);
    ge_p1p1_to_p3(q, t);
    tab[k].yplusx = q.X;
    tab[k].yminusx = q.Y;
    tab[k].xy2d = q.Z;
  }
  // Montgomery's trick over the 16 Z values
  fe prefix[16];
  prefix[0] = tab[0].xy2d;
  for (int k = 1; k < 16; ++k) fe_mul(prefix[k], prefix[k - 1], tab[k].xy2d);
  fe inv;
  fe_invert(inv, prefix[15]);
  for (int k = 15; k >= 0; --k) {
    fe zinv, x, y;
    if (k > 0) {
      fe_mul(zinv, inv, prefix[k - 1]);
      fe_mul(inv, inv, tab[k].xy2d);
    } else {
      zinv = inv;
    }
    fe_mul(x, tab[k].yplusx, zinv);
    fe_mul(y, tab[k].yminusx, zinv);
    fe_add(tab[k].yplusx, y, x);
    fe_sub(tab[k].yminusx, y, x);
    fe_mul(x, x, y);
    fe_mul(tab[k].xy2d, x, d2);
  }
}

// The device bit for one row.
FE_FN int verify_row(const uint8_t a[32], const uint8_t r[32],
                     const uint8_t s[32], const uint8_t h[32],
                     const verify_consts& K) {
  ge_p3 nega;
  const int ok = ge_frombytes_negate(nega, a, K.c);

  ge_precomp atab[16];
  build_table(atab, nega, K.c.d2);

  int8_t sd[52], hd[52];
  recode32(sd, s);
  recode32(hd, h);

  // Strauss-Shamir over both scalars, most significant window first
  ge_p3 acc;
  ge_p3_0(acc);
  ge_p1p1 t;
  ge_precomp e;
  for (int w = 51; w >= 0; --w) {
    if (w != 51) {
      ge_p2 q = {acc.X, acc.Y, acc.Z};
      for (int k = 0; k < 4; ++k) {
        ge_p2_dbl(t, q);
        ge_p1p1_to_p2(q, t);
      }
      ge_p2_dbl(t, q);
      ge_p1p1_to_p3(acc, t);
    }
    if (sd[w]) {
      table_select(e, K.base, sd[w]);
      ge_madd(t, acc, e);
      ge_p1p1_to_p3(acc, t);
    }
    if (hd[w]) {
      table_select(e, atab, hd[w]);
      ge_madd(t, acc, e);
      ge_p1p1_to_p3(acc, t);
    }
  }

  return ok & ge_p3_encodes_to(acc, r);
}

#ifdef __CUDACC__
#include "launch.cuh"

__constant__ verify_consts g_consts;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
verify_cold_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ r,
                   const uint8_t* __restrict__ s, const uint8_t* __restrict__ h,
                   uint8_t* __restrict__ out, int n) {
  __shared__ verify_consts K;
  {
    const int32_t* src = reinterpret_cast<const int32_t*>(&g_consts);
    int32_t* dst = reinterpret_cast<int32_t*>(&K);
    constexpr int words = sizeof(verify_consts) / sizeof(int32_t);
    for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = src[i];
  }
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  uint8_t ra[32], rr[32], rs[32], rh[32];
  const size_t off = (size_t)row * 32;
  for (int b = 0; b < 32; ++b) {
    ra[b] = a[off + b];
    rr[b] = r[off + b];
    rs[b] = s[off + b];
    rh[b] = h[off + b];
  }
  out[row] = (uint8_t)verify_row(ra, rr, rs, rh, K);
}

extern "C" {

// Bytes of the constants block that verify_cold_set_consts takes.
int verify_cold_consts_bytes() { return (int)sizeof(verify_consts); }

// Copy the constants (d, 2d, sqrt(-1), then 16 affine B entries; int32
// limbs) from host memory to the card `device`. Returns a cudaError_t.
int verify_cold_set_consts(const void* host, int device) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  return (int)cudaMemcpyToSymbol(g_consts, host, sizeof(verify_consts));
}

// Launch on `stream` of `device`; n rows of 32 bytes each, n bools out.
// Returns cudaGetLastError() after the launch; does not synchronise.
int verify_cold_launch(const void* a, const void* r, const void* s,
                       const void* h, void* out, int n, int device,
                       void* stream) {
  if (n <= 0) return 0;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  const int blocks = (n + kThreads - 1) / kThreads;
  verify_cold_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)r, (const uint8_t*)s,
      (const uint8_t*)h, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}

const char* verify_cold_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
#endif  // __CUDACC__
