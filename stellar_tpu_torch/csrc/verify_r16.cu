// K5, the radix-16 batch ed25519 verify kernel, written for Hopper
// (sm_90a).
//
// Replaces the radix-16 arm of stellar_tpu/ops: signed_digits16_dev
// (ops/verify.py), _double_scalarmult16, table_select, build_point_table
// and base_table (ops/edwards.py), composed with decompress and
// compress_equals as the reference's radix sweep builds it
// (tools/kernel_cost.py). For each row of (A, R, s, h), 32 bytes each, it
// writes
//     decompress_ok(A) AND encode(s*B + h*(-A)) == R   (bytewise)
// for every byte pattern, K1's bit from another window scheme; the host's
// policy gate is ANDed in afterwards.
//
// What bounds it: integer multiplies. A row costs about 1,520 squarings
// and 910 multiplies (252 doublings, an 8-entry projective table of -A,
// the square root of decompress, the final inversion) plus 7 multiplies
// for each nonzero digit of s and 8 for each of h, up to 128 digits, each
// product 55 or 100 32x32->64 multiply-adds; 129 bytes of input and
// output a row. The operations bound is the card's 32-bit integer
// multiply rate.
//
// Design (first, simple version): one thread per row. Field
// elements are ref10's ten 25.5-bit limbs (fe25519.cuh). The 8-entry
// affine B-table and the curve constants live in __constant__ memory
// (filled once from stellar_tpu_torch/state.py) and each block stages
// them in shared memory. The per-row table of -A holds the multiples
// 1..8 in projective cached form (8 x 4 x 10 int32 = 1,280 B), built by
// one doubling and six additions with no inversion: where K1 normalises
// its 16 entries with one inversion a thread, this arm pays a fourth
// multiply in each A addition instead. The recode runs in the kernel from
// the raw 32-byte scalars: 64 signed digits in [-8, 8), the top one in
// [0, 16]. A top digit above 8 (a scalar from 0x8777...78 on, every
// s >= 9 * 2^252 among them) selects the all-zero entry, as the
// reference's one-hot select does: the accumulator then ends at
// (0 : 0 : 0), which encodes to 32 zero bytes, so such a row's bit is
// decompress_ok(A) AND R == 0, the plain version's bit. Tables are
// indexed directly by |digit|: verification data is public. A zero digit
// skips its add.
#include <stdint.h>

#include "ge25519.cuh"

constexpr int kR16Entries = 8;

struct verify_r16_consts {
  ge_consts c;
  ge_precomp base[kR16Entries];  // v*B for v = 1..8
};

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

// acc += digit * B from the affine table; |digit| above 8 adds the zero
// entry. digit != 0.
FE_FN void add_base(ge_p3& acc, const ge_precomp* tab, int digit) {
  const int m = digit < 0 ? -digit : digit;
  ge_precomp e;
  if (m <= kR16Entries) {
    e = tab[m - 1];
    if (digit < 0) ge_precomp_neg(e);
  } else {
    fe_0(e.yplusx);
    fe_0(e.yminusx);
    fe_0(e.xy2d);
  }
  ge_p1p1 t;
  ge_madd(t, acc, e);
  ge_p1p1_to_p3(acc, t);
}

// acc += digit * (-A) from the projective cached table; |digit| above 8
// adds the zero entry. digit != 0.
FE_FN void add_a(ge_p3& acc, const ge_cached* tab, int digit) {
  const int m = digit < 0 ? -digit : digit;
  ge_p1p1 t;
  if (m <= kR16Entries) {
    if (digit < 0) {
      ge_sub(t, acc, tab[m - 1]);
    } else {
      ge_add(t, acc, tab[m - 1]);
    }
  } else {
    ge_cached z;
    fe_0(z.YplusX);
    fe_0(z.YminusX);
    fe_0(z.Z);
    fe_0(z.T2d);
    ge_add(t, acc, z);
  }
  ge_p1p1_to_p3(acc, t);
}

// Projective cached multiples 1..8 of p: one doubling, six additions, 8
// to-cached conversions; 4 sq and 4 + 6 * 8 + 8 mul.
FE_CALL void build_table16(ge_cached tab[kR16Entries], const ge_p3& p,
                           const fe& d2) {
  ge_p1p1 t;
  ge_p3 q;
  ge_p3_to_cached(tab[0], p, d2);
  ge_p3_dbl(t, p);
  ge_p1p1_to_p3(q, t);
  ge_p3_to_cached(tab[1], q, d2);
  for (int k = 2; k < kR16Entries; ++k) {
    ge_add(t, q, tab[0]);
    ge_p1p1_to_p3(q, t);
    ge_p3_to_cached(tab[k], q, d2);
  }
}

// The device bit for one row.
FE_FN int verify_r16_row(const uint8_t a[32], const uint8_t r[32],
                         const uint8_t s[32], const uint8_t h[32],
                         const verify_r16_consts& K) {
  ge_p3 nega;
  const int ok = ge_frombytes_negate(nega, a, K.c);

  ge_cached atab[kR16Entries];
  build_table16(atab, nega, K.c.d2);

  int8_t sd[64], hd[64];
  recode16(sd, s);
  recode16(hd, h);

  // Strauss-Shamir over both scalars, most significant window first; the
  // fourth doubling of a window keeps T for the two adds
  ge_p3 acc;
  ge_p3_0(acc);
  ge_p1p1 t;
  for (int w = 63; w >= 0; --w) {
    if (w != 63) {
      ge_p2 q = {acc.X, acc.Y, acc.Z};
      for (int k = 0; k < 3; ++k) {
        ge_p2_dbl(t, q);
        ge_p1p1_to_p2(q, t);
      }
      ge_p2_dbl(t, q);
      ge_p1p1_to_p3(acc, t);
    }
    if (sd[w]) add_base(acc, K.base, sd[w]);
    if (hd[w]) add_a(acc, atab, hd[w]);
  }

  return ok & ge_p3_encodes_to(acc, r);
}

#ifdef __CUDACC__
#include "launch.cuh"

__constant__ verify_r16_consts g_r16_consts;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
verify_r16_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ r,
                  const uint8_t* __restrict__ s, const uint8_t* __restrict__ h,
                  uint8_t* __restrict__ out, int n) {
  __shared__ verify_r16_consts K;
  {
    const int32_t* src = reinterpret_cast<const int32_t*>(&g_r16_consts);
    int32_t* dst = reinterpret_cast<int32_t*>(&K);
    constexpr int words = sizeof(verify_r16_consts) / sizeof(int32_t);
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
  out[row] = (uint8_t)verify_r16_row(ra, rr, rs, rh, K);
}

extern "C" {

// Bytes of the constants block that verify_r16_set_consts takes.
int verify_r16_consts_bytes() { return (int)sizeof(verify_r16_consts); }

// Copy the constants (d, 2d, sqrt(-1), then 8 affine B entries; int32
// limbs) from host memory to the card `device`. Returns a cudaError_t.
int verify_r16_set_consts(const void* host, int device) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  return (int)cudaMemcpyToSymbol(g_r16_consts, host,
                                 sizeof(verify_r16_consts));
}

// Launch on `stream` of `device`; n rows of 32 bytes each, n bools out.
// Returns cudaGetLastError() after the launch; does not synchronise.
int verify_r16_launch(const void* a, const void* r, const void* s,
                      const void* h, void* out, int n, int device,
                      void* stream) {
  if (n <= 0) return 0;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  const int blocks = (n + kThreads - 1) / kThreads;
  verify_r16_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)r, (const uint8_t*)s,
      (const uint8_t*)h, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}

const char* verify_r16_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
#endif  // __CUDACC__
