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
// What bounds it: integer multiplies, as for K1. The function costs about
// 1,520 squarings and 910 multiplies a row (252 doublings, an 8-entry
// projective table of -A, the square root of decompress, the final
// inversion) plus 7 multiplies for each nonzero digit of s and 8 for each
// of h, each product 55 or 100 32x32->64 multiply-adds, against 129 bytes
// of input and output a row.
//
// Design: K1's, four lanes a row on ge25519_x4.cuh's two-round formulas;
// the row is verify_lanes.cuh's verify_row_lanes at 4 bits a window, the
// one function K1 runs at 5. The ladder is 63 windows of 4 doublings and
// 64 of two adds (760 rounds; K1's 718), and the table of -A 7 group
// operations (K1's 15). Each table holds the multiples 0..8 and, at index
// 9, the zero entry that a top digit above 8 selects (a scalar from
// 0x8777...78 on, every s >= 9 * 2^252 among them), as the reference's
// one-hot select does: the accumulator then ends at (0, 0, 0, 0), which
// encodes to 32 zero bytes, so such a row's bit is decompress_ok(A) AND
// R == 0, the plain version's bit. 10 x 4 x 40 B = 1,600 B a row of
// shared memory; the affine B-table and the curve constants come from
// __constant__ (filled once from stellar_tpu_torch/state.py) and each
// block stages them in shared memory in the same layout. A row past n
// runs row n - 1's operands (it must take part in every shuffle) and
// stores nothing.
#include <stdint.h>

#include "verify_lanes.cuh"

using Radix16 = ladder<4>;
static_assert(Radix16::zero_entry && Radix16::entries == 10,
              "multiples 0..8 and the zero entry");

struct verify_r16_consts {
  ge_consts c;
  ge_precomp base[Radix16::multiples];  // v*B for v = 1..8
};

// Element ``idx`` of the staged B-table: x4_stage_affine's entries 0..8,
// then the zero entry.
FE_FN void r16_stage_base(fe* tab, const ge_precomp* base, int idx) {
  if (idx < 4 * (Radix16::multiples + 1)) {
    x4_stage_affine(tab, base, idx);
  } else {
    fe_0(tab[idx]);
  }
}

#ifndef __CUDACC__
// The kernel's bit for one row, its four lanes run in turn on the host.
inline int verify_r16_row_x4(const uint8_t a[32], const uint8_t r[32],
                             const uint8_t s[32], const uint8_t h[32],
                             const verify_r16_consts& K) {
  fe btab[Radix16::table_fe], atab[Radix16::table_fe];
  for (int i = 0; i < Radix16::table_fe; ++i)
    r16_stage_base(btab, K.base, i);
  return verify_row_lanes<4, 4>(0, a, r, s, h, K.c, btab, atab);
}
#endif

#ifdef __CUDACC__
#include "launch.cuh"

__constant__ verify_r16_consts g_r16_consts;

// Lanes a row and threads a block: K1's pick (chip_smoke.py's sweep).
constexpr int kLanes = 4;
constexpr int kThreads = 64;
constexpr int kRows = kThreads / kLanes;

__global__ void __launch_bounds__(kThreads)
verify_r16_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ r,
                  const uint8_t* __restrict__ s, const uint8_t* __restrict__ h,
                  uint8_t* __restrict__ out, int n) {
  __shared__ fe btab[Radix16::table_fe];
  __shared__ ge_consts c;
  __shared__ fe atab[kRows][Radix16::table_fe];
  for (int i = threadIdx.x; i < Radix16::table_fe; i += blockDim.x)
    r16_stage_base(btab, g_r16_consts.base, i);
  if (threadIdx.x == 0) c = g_r16_consts.c;
  __syncthreads();

  const int row = blockIdx.x * kRows + threadIdx.x / kLanes;
  // a row past n runs row n - 1 so that its lanes join every shuffle
  const size_t off = (size_t)(row < n ? row : n - 1) * 32;
  alignas(16) uint8_t ra[32], rr[32], rs[32], rh[32];
  // 16-byte loads: the wrapper passes 16-byte-aligned rows
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    reinterpret_cast<uint4*>(ra)[k] = reinterpret_cast<const uint4*>(a + off)[k];
    reinterpret_cast<uint4*>(rr)[k] = reinterpret_cast<const uint4*>(r + off)[k];
    reinterpret_cast<uint4*>(rs)[k] = reinterpret_cast<const uint4*>(s + off)[k];
    reinterpret_cast<uint4*>(rh)[k] = reinterpret_cast<const uint4*>(h + off)[k];
  }
  const int lane = threadIdx.x % kLanes;
  const int bit = verify_row_lanes<1, 4>(lane, ra, rr, rs, rh, c, btab,
                                         atab[threadIdx.x / kLanes]);
  if (lane == 0 && row < n) out[row] = (uint8_t)bit;
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

// Threads of the group that verifies one row.
int verify_r16_lanes_per_row() { return kLanes; }

// Launch on `stream` of `device`; n rows of 32 bytes each, n bools out.
// Returns cudaGetLastError() after the launch; does not synchronise.
int verify_r16_launch(const void* a, const void* r, const void* s,
                      const void* h, void* out, int n, int device,
                      void* stream) {
  if (n <= 0) return 0;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  const int blocks = (n + kRows - 1) / kRows;
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
