// K2, the hot-signer batch ed25519 verify kernel, written for Hopper
// (sm_90a).
//
// Replaces stellar_tpu/ops/verify.py:verify_kernel_hot (with
// signed_digits256_dev, dsm_stage_hot, double_scalarmult_hot,
// base_table_affine_wide, table_select_affine and compress_equals under
// it). For each row of (table of -A, R, s, h) it writes
//     encode(s*B + h*(-A)) == R   (bytewise)
// for every byte pattern of R, s and h; the host's policy gate is ANDed in
// afterwards. The table is the signer-table cache's (128, 3, 20) int16
// operand: the affine cached multiples 1..128 of -A in canonical 13-bit
// limbs.
//
// What bounds it: integer multiplies. A row costs about 1,250 squarings
// and 790 multiplies (248 doublings, the final inversion) plus 7
// multiplies for each nonzero digit (up to 64), each product 55 or 100
// 32x32->64 multiply-adds, about 190k in all. Its operands are 15,457
// bytes a row (the table, R, s, h and the bit); it reads only the table
// entries its digits select, at most 64 of 120 bytes each. The operations
// bound is the card's 32-bit integer multiply rate; the bytes bound is
// below it.
//
// Design (first, simple version): one thread per row, as K1. The
// 128-entry B-table and d, 2d sit in __constant__ memory (filled once
// from stellar_tpu_torch/state.py) and each block stages them, 15,440
// bytes, in shared memory: the lanes of a warp pick different entries.
// The A entries are read from the row's own table in device memory, only
// the one each nonzero digit selects, and converted from twenty 13-bit
// limbs to ref10's ten 25.5-bit limbs as they are read. The signed
// radix-256 recode uses the bytes as windows; a top digit above 128 (a
// top byte of s or h at 0x81 or above, or 0x80 with a carry into it)
// selects entry 128, as the reference's select does, so the raw bit
// matches on every row. No decompression: cache membership is its proof.
// A zero digit skips its add.
#include <stdint.h>

#include "verify_hot.cuh"

#ifdef __CUDACC__
#include "launch.cuh"

__constant__ verify_hot_consts g_hot_consts;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
verify_hot_kernel(const int16_t* __restrict__ tab,
                  const uint8_t* __restrict__ r, const uint8_t* __restrict__ s,
                  const uint8_t* __restrict__ h, uint8_t* __restrict__ out,
                  int n) {
  __shared__ verify_hot_consts K;
  {
    const int32_t* src = reinterpret_cast<const int32_t*>(&g_hot_consts);
    int32_t* dst = reinterpret_cast<int32_t*>(&K);
    constexpr int words = sizeof(verify_hot_consts) / sizeof(int32_t);
    for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = src[i];
  }
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  uint8_t rr[32], rs[32], rh[32];
  const size_t off = (size_t)row * 32;
  for (int b = 0; b < 32; ++b) {
    rr[b] = r[off + b];
    rs[b] = s[off + b];
    rh[b] = h[off + b];
  }
  out[row] = (uint8_t)verify_hot_row(tab + (size_t)row * kTableLimbs, rr,
                                     rs, rh, K);
}

extern "C" {

// Bytes of the constants block that verify_hot_set_consts takes.
int verify_hot_consts_bytes() { return (int)sizeof(verify_hot_consts); }

// Copy the constants (d, 2d, then 128 affine B entries; int32 limbs) from
// host memory to the card `device`. Returns a cudaError_t.
int verify_hot_set_consts(const void* host, int device) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  return (int)cudaMemcpyToSymbol(g_hot_consts, host,
                                 sizeof(verify_hot_consts));
}

// Launch on `stream` of `device`: n rows of a (128, 3, 20) int16 table and
// 32 bytes each of R, s, h; n bools out. Returns cudaGetLastError() after
// the launch; does not synchronise.
int verify_hot_launch(const void* table, const void* r, const void* s,
                      const void* h, void* out, int n, int device,
                      void* stream) {
  if (n <= 0) return 0;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  const int blocks = (n + kThreads - 1) / kThreads;
  verify_hot_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)table, (const uint8_t*)r, (const uint8_t*)s,
      (const uint8_t*)h, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}

const char* verify_hot_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
#endif  // __CUDACC__
