// K3's per-message arithmetic: FIPS 180-4 SHA-256 for one CUDA thread. It
// also compiles as host C++ (SHA_FN set to a plain function), which is how
// the CPU tests run it.
#pragma once
#include <stdint.h>
#include <string.h>

#ifndef SHA_FN
#define SHA_FN __device__ __forceinline__
#endif

#ifdef __CUDACC__
__constant__
#else
static
#endif
    const uint32_t kSha256K[64] = {
        0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
        0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
        0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
        0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
        0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
        0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
        0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
        0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
        0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
        0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
        0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
        0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
        0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

SHA_FN uint32_t sha_rotr(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

// One compression: st += rounds(st, block). w holds the block's sixteen
// big-endian word values and becomes the rolling schedule: before round
// i >= 16, w[i & 15] still holds w[i - 16]. Additions wrap mod 2^32, as
// the standard asks.
SHA_FN void sha256_compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    uint32_t wi = w[i & 15];
    if (i >= 16) {
      const uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
      const uint32_t s0 = sha_rotr(w15, 7) ^ sha_rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = sha_rotr(w2, 17) ^ sha_rotr(w2, 19) ^ (w2 >> 10);
      wi += s0 + w[(i - 7) & 15] + s1;
      w[i & 15] = wi;
    }
    const uint32_t S1 = sha_rotr(e, 6) ^ sha_rotr(e, 11) ^ sha_rotr(e, 25);
    const uint32_t ch = g ^ (e & (f ^ g));
    const uint32_t t1 = h + S1 + ch + kSha256K[i] + wi;
    const uint32_t S0 = sha_rotr(a, 2) ^ sha_rotr(a, 13) ^ sha_rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + S0 + maj;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

// The digest words of one packed message: `words` holds max_blocks blocks
// of sixteen words, `active` one flag a block. Active blocks are
// compressed in order and inactive ones skipped (pack_messages makes the
// active blocks a prefix); a row with no active block returns H0.
SHA_FN void sha256_row(uint32_t out[8], const uint32_t* words,
                       const uint8_t* active, int max_blocks) {
  uint32_t st[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                    0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
  for (int k = 0; k < max_blocks; ++k) {
    if (!active[k]) continue;
    uint32_t w[16];
#ifdef __CUDA_ARCH__
    const uint4* src = reinterpret_cast<const uint4*>(words + 16 * k);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = __ldg(src + q);
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
#else
    memcpy(w, words + 16 * k, sizeof(w));
#endif
    sha256_compress(st, w);
  }
  for (int i = 0; i < 8; ++i) out[i] = st[i];
}
