// The 12-round ChaCha and Salsa cores of the stream-cipher PRFs, shared by
// K2 (subtree.cu), K4 (sqrt_grid.cu) and K5 (chacha_level.cu).
//
// Layouts (core/prf.py): ChaCha puts the seed in words 7..4 (limb 0 in word
// 7) and the position in word 13, output words 7..4; Salsa puts the seed in
// words 4..1 and the position in word 9, output words 4..1 (12 rounds
// despite the name); block-PRG child b is block words [4b..4b+3], most
// significant word first.  Positions are below 2^32, so the high counter
// word is 0.
#pragma once

#include "dpf_common.cuh"

namespace dpf {

constexpr uint32_t kSigma0 = 0x65787061u, kSigma1 = 0x6E642033u,
                   kSigma2 = 0x322D6279u, kSigma3 = 0x7465206Bu;

#define CHACHA_QR(a, b, c, d)            \
  x[a] += x[b];                          \
  x[d] = dpf::rotl32(x[d] ^ x[a], 16);   \
  x[c] += x[d];                          \
  x[b] = dpf::rotl32(x[b] ^ x[c], 12);   \
  x[a] += x[b];                          \
  x[d] = dpf::rotl32(x[d] ^ x[a], 8);    \
  x[c] += x[d];                          \
  x[b] = dpf::rotl32(x[b] ^ x[c], 7);

#define SALSA_QR(a, b, c, d)                 \
  x[b] ^= dpf::rotl32(x[a] + x[d], 7);       \
  x[c] ^= dpf::rotl32(x[b] + x[a], 9);       \
  x[d] ^= dpf::rotl32(x[c] + x[b], 13);      \
  x[a] ^= dpf::rotl32(x[d] + x[c], 18);

__device__ __forceinline__ void chacha_block(const uint32_t s[4], uint32_t pos,
                                             uint32_t o[16]) {
  const uint32_t init[16] = {kSigma0, kSigma1, kSigma2, kSigma3,
                             s[3],    s[2],    s[1],    s[0],
                             0u,      0u,      0u,      0u,
                             0u,      pos,     0u,      0u};
  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = init[i];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    CHACHA_QR(0, 4, 8, 12)
    CHACHA_QR(1, 5, 9, 13)
    CHACHA_QR(2, 6, 10, 14)
    CHACHA_QR(3, 7, 11, 15)
    CHACHA_QR(0, 5, 10, 15)
    CHACHA_QR(1, 6, 11, 12)
    CHACHA_QR(2, 7, 8, 13)
    CHACHA_QR(3, 4, 9, 14)
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = x[i] + init[i];
}

__device__ __forceinline__ void salsa_block(const uint32_t s[4], uint32_t pos,
                                            uint32_t o[16]) {
  const uint32_t init[16] = {kSigma0, s[3], s[2],    s[1],
                             s[0],    kSigma1, 0u,   0u,
                             0u,      pos,  kSigma2, 0u,
                             0u,      0u,   0u,      kSigma3};
  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = init[i];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    SALSA_QR(0, 4, 8, 12)
    SALSA_QR(5, 9, 13, 1)
    SALSA_QR(10, 14, 2, 6)
    SALSA_QR(15, 3, 7, 11)
    SALSA_QR(0, 1, 2, 3)
    SALSA_QR(5, 6, 7, 4)
    SALSA_QR(10, 11, 8, 9)
    SALSA_QR(15, 12, 13, 14)
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = x[i] + init[i];
}

// PRF ids: 1 Salsa20-12, 2 ChaCha20-12, 4 Salsa20-12 block-PRG,
// 5 ChaCha20-12 block-PRG.
template <int PRF>
__device__ __forceinline__ void core_block(const uint32_t s[4], uint32_t pos,
                                           uint32_t o[16]) {
  if (PRF == 2 || PRF == 5) {
    chacha_block(s, pos, o);
  } else {
    salsa_block(s, pos, o);
  }
}

}  // namespace dpf

#undef CHACHA_QR
#undef SALSA_QR
