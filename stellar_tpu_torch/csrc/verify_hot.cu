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
// What bounds it: integer multiplies. The function's work is about 1,250
// squarings and 760 multiplies a row (248 doublings, the final inversion)
// plus 7 multiplies for each nonzero digit (up to 64), each product 55 or
// 100 32x32->64 multiply-adds, about 190k in all. Its operands are 15,457
// bytes a row (the table, R, s, h and the bit); it reads only the table
// entries its digits select, 40 bytes a lane of each. The operations bound
// is the card's 32-bit integer multiply rate; the bytes bound is below it.
// What the card runs is integer instructions issued by one scheduler a
// warp, along one long dependent chain a row (248 doublings, 64 additions,
// the final inversion), and a TxSet gives only 2,048 rows.
//
// Design: four lanes a row, as K1 (csrc/verify_cold.cu), on
// ge25519_x4.cuh's two-round formulas. Lane j of a group of four owns
// coordinate j (X, Y, Z, T) of the accumulator; a doubling or an addition
// is two rounds of four field products, one a lane, with __shfl_sync
// gathers between them. That cuts a row's chain from about 2,580 field
// products to about 890 latencies (624 ladder rounds, the encode's 267)
// and puts four times the warps on the card.
// * The ladder is Strauss-Shamir over the signed radix-256 digits (the
//   bytes), 32 windows, 8 doublings a window below the top one; every
//   window runs its s-add and h-add, a zero digit adding the identity's
//   cached entry by a select, so no lane branches around a shuffle.
// * The 128 affine B entries and d, 2d sit in __constant__ memory (filled
//   once from stellar_tpu_torch/state.py); each block stages the entries
//   in shared memory in cached form [entry][component], entry 0 the
//   identity and 2Z = 2 (129 x 4 x 40 B = 20,640 B a block): the lanes of
//   a warp pick different entries.
// * The -A entry comes straight from the row's table in device memory:
//   each lane reads only its own component, 40 bytes as five 8-byte
//   loads, and converts it from twenty 13-bit limbs to ref10's ten (lane 2
//   reads nothing: 2 Z2 = 2). A negative digit swaps the lanes' components
//   0 and 1 and negates lane 3's, so the operand keeps the cache's layout.
//   A window's loads are issued before its 8 doublings, whose 16 rounds
//   hide their latency.
// * The signed radix-256 recode uses the bytes as windows; a top digit
//   above 128 (a top byte of s or h at 0x81 or above, or 0x80 with a carry
//   into it) takes entry 128, as the reference's select does, so the raw
//   bit matches on every row.
// * The final encode (one inversion) runs on all four lanes, in the time
//   one would; lane 0 stores the bit. A row past n runs row n - 1's
//   operands (it must take part in every shuffle) and stores nothing.
// No decompression: cache membership is its proof.
#include <stdint.h>

#include "verify_hot.cuh"

#ifdef __CUDACC__
#include "launch.cuh"

__constant__ verify_hot_consts g_hot_consts;

// Lanes a row, and the most threads a block the launch takes (the caller
// picks the block size: ops/verify.py, and the sweep in chip_smoke.py).
constexpr int kLanes = 4;
constexpr int kMaxThreads = 128;

__global__ void __launch_bounds__(kMaxThreads)
verify_hot_kernel(const int16_t* __restrict__ tab,
                  const uint8_t* __restrict__ r, const uint8_t* __restrict__ s,
                  const uint8_t* __restrict__ h, uint8_t* __restrict__ out,
                  int n) {
  __shared__ fe btab[kHotTableFe];
  for (int i = threadIdx.x; i < kHotTableFe; i += blockDim.x)
    x4_stage_affine(btab, g_hot_consts.base, i);
  __syncthreads();

  const int row = blockIdx.x * (blockDim.x / kLanes) + threadIdx.x / kLanes;
  // a row past n runs row n - 1 so that its lanes join every shuffle
  const size_t src = (size_t)(row < n ? row : n - 1);
  alignas(16) uint8_t rr[32], rs[32], rh[32];
  // 16-byte loads: the wrapper passes 16-byte-aligned rows
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    reinterpret_cast<uint4*>(rr)[k] =
        reinterpret_cast<const uint4*>(r + src * 32)[k];
    reinterpret_cast<uint4*>(rs)[k] =
        reinterpret_cast<const uint4*>(s + src * 32)[k];
    reinterpret_cast<uint4*>(rh)[k] =
        reinterpret_cast<const uint4*>(h + src * 32)[k];
  }
  const int lane = threadIdx.x % kLanes;
  const int bit = verify_hot_row_lanes<1>(lane, tab + src * kTableLimbs, rr,
                                          rs, rh, btab);
  if (lane == 0 && row < n) out[row] = (uint8_t)bit;
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

// Threads of the group that verifies one row.
int verify_hot_lanes_per_row() { return kLanes; }

// Launch on `stream` of `device`: n rows of a (128, 3, 20) int16 table and
// 32 bytes each of R, s, h; n bools out; `threads` a block (a multiple of
// 32 up to kMaxThreads). Returns cudaGetLastError() after the launch; does
// not synchronise.
int verify_hot_launch(const void* table, const void* r, const void* s,
                      const void* h, void* out, int n, int threads,
                      int device, void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  const int rows = threads / kLanes;
  const int blocks = (n + rows - 1) / rows;
  verify_hot_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)table, (const uint8_t*)r, (const uint8_t*)s,
      (const uint8_t*)h, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}

const char* verify_hot_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
#endif  // __CUDACC__
