// K1, the cold batch ed25519 verify kernel, written for Hopper (sm_90a).
//
// Replaces stellar_tpu/ops/verify.py:verify_kernel (with decompress,
// signed_digits32_dev, _double_scalarmult32, build_point_table_affine,
// fe.batch_inv, table_select_affine and compress_equals under it). For each
// row of (A, R, s, h), 32 bytes each, it writes
//     decompress_ok(A) AND encode(s*B + h*(-A)) == R   (bytewise)
// for every byte pattern; the host's policy gate is ANDed in afterwards.
//
// What bounds it on this card. The work is integer multiplies: a row is
// about 1,530 field squarings (55 32x32->64 multiply-adds each) and 1,970
// multiplies (100 each) against 129 bytes of input and output, so the
// operations bound is the card's 32-bit integer multiply rate. What the
// card runs is integer instructions, a few for each multiply-add (the
// carries, the shuffles, the selects), issued by one scheduler a warp;
// and a row is one long dependent chain (the square root of decompress,
// 255 doublings, 104 additions, the final inversion), while a TxSet gives
// only 2,048 rows. With one thread a row the card held 16 warps, each
// running the whole chain, so 128 to 2,048 rows took the same time.
//
// Design: four lanes a row (ge25519_x4.cuh). Lane j of a group of four
// owns coordinate j (X, Y, Z, T) of the accumulator, and each doubling or
// addition is two rounds of four independent field products, one a lane,
// with the operands gathered by __shfl_sync between rounds. That cuts the
// ladder's chain from 255 x 8 + 104 x 7 products to 718 rounds, puts four
// times as many warps on the card, and leaves a lane one field element of
// state and a product's accumulators, not a whole point. The sums inside
// a round are not carried (ge25519_x4.cuh states the bounds), which
// leaves a round about 300 instructions a lane.
//
// The row is verify_lanes.cuh's verify_row_lanes at 5 bits a window,
// which K5 (verify_r16.cu) instantiates at 4:
//
// * Decompress and the final encode (one square-root chain, one
//   inversion) are one chain each; all four lanes compute them, in the
//   time one would, and lane 0 stores the bit.
// * The table of -A holds the multiples 0..16 in projective cached form
//   (Y - X, Y + X, 2Z, 2dT), built by one doubling and 14 additions in
//   four-lane rounds: no inversion. It lives in shared memory as
//   [row][entry][component] (17 x 4 x 40 B = 2,720 B a row), each lane
//   writing and reading its own component; a negative digit swaps
//   components 0 and 1 and negates 3, so no lane needs a shuffle to read
//   it. The affine B-table and the curve constants come from __constant__
//   (filled once from stellar_tpu_torch/state.py); each block stages them
//   in shared memory in the same layout, 2Z = 2.
// * The ladder is Strauss-Shamir over signed radix-32 digits, 52 windows,
//   and every window runs its s-add and h-add: a zero digit adds entry 0,
//   the identity (1, 1, 2, 0). The formulas are complete, so that is
//   exact, and no lane of a warp branches around a shuffle.
// * A row past n runs row n - 1's operands (it must take part in every
//   shuffle) and stores nothing.
//
// Tables are indexed directly by |digit|: verification data is public,
// and libsodium's verify is itself variable-time.
#include <stdint.h>

#include "verify_lanes.cuh"

struct verify_consts {
  ge_consts c;
  ge_precomp base[16];  // v*B for v = 1..16
};

// The cached tables' field elements: 17 entries of 4 components.
constexpr int kTableFe = ladder<5>::table_fe;

#ifndef __CUDACC__
// The kernel's bit for one row, its four lanes run in turn on the host.
inline int verify_row_x4(const uint8_t a[32], const uint8_t r[32],
                         const uint8_t s[32], const uint8_t h[32],
                         const verify_consts& K) {
  fe btab[kTableFe], atab[kTableFe];
  for (int i = 0; i < kTableFe; ++i) x4_stage_affine(btab, K.base, i);
  return verify_row_lanes<4, 5>(0, a, r, s, h, K.c, btab, atab);
}
#endif

#ifdef __CUDACC__
#include "launch.cuh"

__constant__ verify_consts g_consts;

// Lanes a row, and the most threads a block the launch takes (the
// caller picks the block size: ops/verify.py, and the sweep in
// chip_smoke.py).
constexpr int kLanes = 4;
constexpr int kMaxThreads = 128;

// Shared memory of a block of ``threads``: the B-table, the constants,
// then one table of -A a row.
static size_t smem_bytes(int threads) {
  return sizeof(fe) * kTableFe * (1 + threads / kLanes) +
         sizeof(ge_consts);
}

__global__ void __launch_bounds__(kMaxThreads)
verify_cold_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ r,
                   const uint8_t* __restrict__ s, const uint8_t* __restrict__ h,
                   uint8_t* __restrict__ out, int n) {
  extern __shared__ int4 smem[];
  fe* btab = reinterpret_cast<fe*>(smem);
  ge_consts* c = reinterpret_cast<ge_consts*>(btab + kTableFe);
  fe* atab =
      reinterpret_cast<fe*>(c + 1) + (threadIdx.x / kLanes) * kTableFe;
  for (int i = threadIdx.x; i < kTableFe; i += blockDim.x)
    x4_stage_affine(btab, g_consts.base, i);
  if (threadIdx.x == 0) *c = g_consts.c;
  __syncthreads();

  const int row = blockIdx.x * (blockDim.x / kLanes) + threadIdx.x / kLanes;
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
  const int bit =
      verify_row_lanes<1, 5>(lane, ra, rr, rs, rh, *c, btab, atab);
  if (lane == 0 && row < n) out[row] = (uint8_t)bit;
}

extern "C" {

// Bytes of the constants block that verify_cold_set_consts takes.
int verify_cold_consts_bytes() { return (int)sizeof(verify_consts); }

// Copy the constants (d, 2d, sqrt(-1), then 16 affine B entries; int32
// limbs) from host memory to the card `device`, and let the kernel take
// the shared memory of its largest block there. Returns a cudaError_t.
int verify_cold_set_consts(const void* host, int device) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaError_t err = cudaFuncSetAttribute(
      verify_cold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxThreads));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(g_consts, host, sizeof(verify_consts));
}

// Threads of the group that verifies one row.
int verify_cold_lanes_per_row() { return kLanes; }

// Launch on `stream` of `device`; n rows of 32 bytes each, n bools out,
// `threads` a block (a multiple of 32 up to kMaxThreads). Returns
// cudaGetLastError() after the launch; does not synchronise.
int verify_cold_launch(const void* a, const void* r, const void* s,
                       const void* h, void* out, int n, int threads,
                       int device, void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  const int rows = threads / kLanes;
  const int blocks = (n + rows - 1) / rows;
  verify_cold_kernel<<<blocks, threads, smem_bytes(threads),
                       (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)r, (const uint8_t*)s,
      (const uint8_t*)h, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}

const char* verify_cold_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
#endif  // __CUDACC__
