// K3, batched SHA-256, written for Hopper (sm_90a).
//
// Replaces stellar_tpu/ops/sha256.py:sha256_kernel. For each row of
// (words (max_blocks, 16) uint32, active (max_blocks,) bool) it writes the
// FIPS 180-4 digest as eight uint32 word values: the blocks are the
// message after padding and big-endian packing on the host
// (ops/sha256.py:pack_messages).
//
// What bounds it: 32-bit integer add, logic and shift operations, 1,384 a
// compressed block by the standard's count (chip_smoke.py), against 552
// bytes a row at the capacity of 8 blocks. nvcc makes Ch, Maj and each
// three-way XOR one LOP3, each rotate one funnel shift (SHF), and folds
// the add chains into IADD3, so the built loop does the function's work
// and little else. On the H100 a warp takes about 3,900 cycles a block,
// at 2,048 rows as at 16,384: about what its scheduler's integer pipe
// needs if a funnel shift issues every 4 cycles and the rest every 2.
//
// Design: one thread per message, the state and the 16-word rolling
// schedule in registers (the 64 rounds unrolled, so every schedule index
// is a constant), the round constants in __constant__ memory (the lanes of
// a warp read the same one). A block is read as four 16-byte loads.
// Inactive blocks are skipped. Additions wrap natively mod 2^32: the
// reference's split-carry adds serve its interval prover only. Two warps
// for 32 rows, one compressing while the other loads and expands the next
// block, ran 20-22% faster at 2,048 rows but 14-17% slower at 16,384,
// where the card is full and the split only adds work (PERF.md).
#include "sha256.cuh"

#include "launch.cuh"

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
sha256_kernel(const uint32_t* __restrict__ words,
              const uint8_t* __restrict__ active, uint32_t* __restrict__ out,
              int n, int max_blocks) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  uint32_t st[8];
  sha256_row(st, words + (size_t)row * max_blocks * 16,
             active + (size_t)row * max_blocks, max_blocks);
  for (int i = 0; i < 8; ++i) out[(size_t)row * 8 + i] = st[i];
}

extern "C" {

// Launch on `stream` of `device`: n rows of (max_blocks, 16) uint32 words
// and (max_blocks,) bool active flags; (n, 8) uint32 digest words out.
// Returns cudaGetLastError() after the launch; does not synchronise.
int sha256_launch(const void* words, const void* active, void* out, int n,
                  int max_blocks, int device, void* stream) {
  if (n <= 0) return 0;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  const int blocks = (n + kThreads - 1) / kThreads;
  sha256_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const uint8_t*)active, (uint32_t*)out, n,
      max_blocks);
  return (int)cudaGetLastError();
}

const char* sha256_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
