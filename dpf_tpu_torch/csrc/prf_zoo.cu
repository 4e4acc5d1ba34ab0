// K7 prf_zoo: the PRF-selection study's 15 candidates, one kernel instance
// each.
//
// Replaces dpf_tpu/core/prf_zoo.py::benchmark_zoo's jit-compiled
// candidates (XLA, not Pallas: the TPU has no hand kernel here); the
// reference ran the same study as CUDA device code
// (paper/kernel/gpu/dpf_gpu/prf/prf.cu).  Every candidate is a per-thread
// cipher or hash core over 32-bit words, with dpf_tpu's bits
// (core/prf_zoo.py and core/prf_zoo_hash.py hold the plain versions):
//
//   ids 0-5   Salsa20/8, /12, /20 and ChaCha8, 12, 20 (one child at `pos`)
//   ids 6-12  siphash24, siphash13, blake2s, keccakf800, highway_proxy,
//             md5, sha256 (one child at `pos`)
//   ids 13-14 chacha12_blk, salsa20_12_blk (one 12-round core block at
//             counter `pos`, all four children: block words [4b..4b+3],
//             most significant word first)
//
// A grid-stride loop runs one seed (4 limbs, one 16-byte load) a thread
// and writes the candidate's 128-bit output, out[n, 4], or the four
// children, out[4, n, 4] (16-byte stores), so the work is kept.  Bound on the H100: operations, hundreds to
// thousands of 32-bit instructions a seed against 16 bytes read and 16 or
// 64 written.  The cores are straight-line code: the round loops have
// constant trip counts and are unrolled, so table values, message indices
// and rotation amounts are constants and the state stays in registers.
// The Salsa/ChaCha cores are this file's own, with the rounds a template
// parameter (K2 and K4's 12-round cores in stream_cipher.cuh are not
// touched).

#include "dpf_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCandidates = 15;

using dpf::rotl32;

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int b) {
  return (x >> b) | (x << (32 - b));
}

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int b) {
  return (x << b) | (x >> (64 - b));
}

// ------------------------------------------------------------ Salsa/ChaCha

constexpr uint32_t kSigma0 = 0x65787061u, kSigma1 = 0x6E642033u,
                   kSigma2 = 0x322D6279u, kSigma3 = 0x7465206Bu;

#define ZOO_SALSA_QR(a, b, c, d)      \
  x[b] ^= rotl32(x[a] + x[d], 7);     \
  x[c] ^= rotl32(x[b] + x[a], 9);     \
  x[d] ^= rotl32(x[c] + x[b], 13);    \
  x[a] ^= rotl32(x[d] + x[c], 18);

#define ZOO_CHACHA_QR(a, b, c, d)     \
  x[a] += x[b];                       \
  x[d] = rotl32(x[d] ^ x[a], 16);     \
  x[c] += x[d];                       \
  x[b] = rotl32(x[b] ^ x[c], 12);     \
  x[a] += x[b];                       \
  x[d] = rotl32(x[d] ^ x[a], 8);      \
  x[c] += x[d];                       \
  x[b] = rotl32(x[b] ^ x[c], 7);

// key in words 1..4 (limb 0 in word 4), 64-bit counter in words 8 (high)
// and 9 (low); o = rounds(x) + x
template <int R>
__device__ __forceinline__ void salsa_block(const uint32_t s[4],
                                            uint64_t ctr, uint32_t o[16]) {
  const uint32_t in[16] = {kSigma0, s[3], s[2], s[1], s[0], kSigma1,
                           0u, 0u, (uint32_t)(ctr >> 32), (uint32_t)ctr,
                           kSigma2, 0u, 0u, 0u, 0u, kSigma3};
  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = in[i];
#pragma unroll
  for (int r = 0; r < R / 2; ++r) {
    ZOO_SALSA_QR(0, 4, 8, 12)
    ZOO_SALSA_QR(5, 9, 13, 1)
    ZOO_SALSA_QR(10, 14, 2, 6)
    ZOO_SALSA_QR(15, 3, 7, 11)
    ZOO_SALSA_QR(0, 1, 2, 3)
    ZOO_SALSA_QR(5, 6, 7, 4)
    ZOO_SALSA_QR(10, 11, 8, 9)
    ZOO_SALSA_QR(15, 12, 13, 14)
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = x[i] + in[i];
}

// key in words 4..7 (limb 0 in word 7), 64-bit counter in words 12 (high)
// and 13 (low)
template <int R>
__device__ __forceinline__ void chacha_block(const uint32_t s[4],
                                             uint64_t ctr, uint32_t o[16]) {
  const uint32_t in[16] = {kSigma0, kSigma1, kSigma2, kSigma3,
                           s[3], s[2], s[1], s[0], 0u, 0u, 0u, 0u,
                           (uint32_t)(ctr >> 32), (uint32_t)ctr, 0u, 0u};
  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = in[i];
#pragma unroll
  for (int r = 0; r < R / 2; ++r) {
    ZOO_CHACHA_QR(0, 4, 8, 12)
    ZOO_CHACHA_QR(1, 5, 9, 13)
    ZOO_CHACHA_QR(2, 6, 10, 14)
    ZOO_CHACHA_QR(3, 7, 11, 15)
    ZOO_CHACHA_QR(0, 5, 10, 15)
    ZOO_CHACHA_QR(1, 6, 11, 12)
    ZOO_CHACHA_QR(2, 7, 8, 13)
    ZOO_CHACHA_QR(3, 4, 9, 14)
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = x[i] + in[i];
}

// ----------------------------------------------------------------- SipHash

__device__ __forceinline__ void sipround(uint64_t& v0, uint64_t& v1,
                                         uint64_t& v2, uint64_t& v3) {
  v0 += v1;
  v1 = rotl64(v1, 13);
  v1 ^= v0;
  v0 = rotl64(v0, 32);
  v2 += v3;
  v3 = rotl64(v3, 16);
  v3 ^= v2;
  v0 += v3;
  v3 = rotl64(v3, 21);
  v3 ^= v0;
  v2 += v1;
  v1 = rotl64(v1, 17);
  v1 ^= v2;
  v2 = rotl64(v2, 32);
}

// SipHash-c-d of one 8-byte message block m (then the empty final block)
template <int C, int D>
__device__ __forceinline__ uint64_t siphash64(uint64_t k0, uint64_t k1,
                                              uint64_t m) {
  uint64_t v0 = k0 ^ 0x736f6d6570736575ull, v1 = k1 ^ 0x646f72616e646f6dull;
  uint64_t v2 = k0 ^ 0x6c7967656e657261ull, v3 = k1 ^ 0x7465646279746573ull;
  v3 ^= m;
#pragma unroll
  for (int i = 0; i < C; ++i) sipround(v0, v1, v2, v3);
  v0 ^= m;
  const uint64_t mf = 8ull << 56;   // empty remainder, length 8
  v3 ^= mf;
#pragma unroll
  for (int i = 0; i < C; ++i) sipround(v0, v1, v2, v3);
  v0 ^= mf;
  v2 ^= 0xFFull;
#pragma unroll
  for (int i = 0; i < D; ++i) sipround(v0, v1, v2, v3);
  return v0 ^ v1 ^ v2 ^ v3;
}

// 128 bits = two instances on the messages 2 pos and 2 pos + 1
template <int C, int D>
__device__ __forceinline__ void siphash_core(const uint32_t s[4],
                                             uint64_t pos, uint32_t o[4]) {
  const uint64_t k0 = s[0] | ((uint64_t)s[1] << 32);
  const uint64_t k1 = s[2] | ((uint64_t)s[3] << 32);
  const uint64_t lo = siphash64<C, D>(k0, k1, 2 * pos);
  const uint64_t hi = siphash64<C, D>(k0, k1, 2 * pos + 1);
  o[0] = (uint32_t)lo;
  o[1] = (uint32_t)(lo >> 32);
  o[2] = (uint32_t)hi;
  o[3] = (uint32_t)(hi >> 32);
}

// ------------------------------------------------------------- BLAKE2s-128

__host__ __device__ constexpr uint32_t b2s_iv(int i) {
  const uint32_t iv[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u,
                          0xA54FF53Au, 0x510E527Fu, 0x9B05688Cu,
                          0x1F83D9ABu, 0x5BE0CD19u};
  return iv[i];
}

__host__ __device__ constexpr int b2s_sigma(int r, int i) {
  const unsigned char s[10][16] = {
      {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
      {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
      {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
      {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
      {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
      {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
      {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
      {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
      {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
      {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0}};
  return s[r][i];
}

#define ZOO_B2S_G(a, b, c, d, x, y)        \
  v[a] = v[a] + v[b] + (x);                \
  v[d] = rotr32(v[d] ^ v[a], 16);          \
  v[c] = v[c] + v[d];                      \
  v[b] = rotr32(v[b] ^ v[c], 12);          \
  v[a] = v[a] + v[b] + (y);                \
  v[d] = rotr32(v[d] ^ v[a], 8);           \
  v[c] = v[c] + v[d];                      \
  v[b] = rotr32(v[b] ^ v[c], 7);

__device__ __forceinline__ void b2s_compress(uint32_t h[8],
                                             const uint32_t m[16],
                                             uint32_t t, bool last) {
  uint32_t v[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = h[i];
    v[i + 8] = b2s_iv(i);
  }
  v[12] ^= t;                       // the counter's high word is 0
  if (last) v[14] = ~v[14];
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    ZOO_B2S_G(0, 4, 8, 12, m[b2s_sigma(r, 0)], m[b2s_sigma(r, 1)])
    ZOO_B2S_G(1, 5, 9, 13, m[b2s_sigma(r, 2)], m[b2s_sigma(r, 3)])
    ZOO_B2S_G(2, 6, 10, 14, m[b2s_sigma(r, 4)], m[b2s_sigma(r, 5)])
    ZOO_B2S_G(3, 7, 11, 15, m[b2s_sigma(r, 6)], m[b2s_sigma(r, 7)])
    ZOO_B2S_G(0, 5, 10, 15, m[b2s_sigma(r, 8)], m[b2s_sigma(r, 9)])
    ZOO_B2S_G(1, 6, 11, 12, m[b2s_sigma(r, 10)], m[b2s_sigma(r, 11)])
    ZOO_B2S_G(2, 7, 8, 13, m[b2s_sigma(r, 12)], m[b2s_sigma(r, 13)])
    ZOO_B2S_G(3, 4, 9, 14, m[b2s_sigma(r, 14)], m[b2s_sigma(r, 15)])
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

// keyed BLAKE2s-128 (RFC 7693): key = the seed's 16 LE bytes, message =
// pos as 8 LE bytes
__device__ __forceinline__ void blake2s_core(const uint32_t s[4],
                                             uint64_t pos, uint32_t o[4]) {
  uint32_t h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = b2s_iv(i);
  h[0] ^= 16u | (16u << 8) | (1u << 16) | (1u << 24);  // digest, key, fan
  uint32_t m[16] = {s[0], s[1], s[2], s[3], 0u, 0u, 0u, 0u,
                    0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  b2s_compress(h, m, 64u, false);
  const uint32_t mp[16] = {(uint32_t)pos, (uint32_t)(pos >> 32), 0u, 0u,
                           0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  b2s_compress(h, mp, 72u, true);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = h[i];
}

// ------------------------------------------------------------ Keccak-f[800]

// the round constants and rotation offsets prf_zoo_hash derives (the LFSR
// x^8 + x^6 + x^5 + x^4 + 1, truncated to 32-bit lanes; (t+1)(t+2)/2 along
// the (x, y) -> (y, 2x + 3y) walk, mod 32)
__host__ __device__ constexpr uint32_t keccak_rc(int i) {
  const uint32_t rc[22] = {
      0x00000001u, 0x00008082u, 0x0000808Au, 0x80008000u, 0x0000808Bu,
      0x80000001u, 0x80008081u, 0x00008009u, 0x0000008Au, 0x00000088u,
      0x80008009u, 0x8000000Au, 0x8000808Bu, 0x0000008Bu, 0x00008089u,
      0x00008003u, 0x00008002u, 0x00000080u, 0x0000800Au, 0x8000000Au,
      0x80008081u, 0x00008080u};
  return rc[i];
}

__host__ __device__ constexpr int keccak_rho(int x, int y) {
  const int rho[5][5] = {{0, 36, 3, 105, 210},
                         {1, 300, 10, 45, 66},
                         {190, 6, 171, 15, 253},
                         {28, 55, 153, 21, 120},
                         {91, 276, 231, 136, 78}};
  return rho[x][y] % 32;
}

__device__ __forceinline__ uint32_t rotl32_any(uint32_t x, int b) {
  return b == 0 ? x : rotl32(x, b);
}

// lanes a[x][y] at a[5 x + y]: seed limbs in (0..3, 0), pos in (4, 0),
// 0x1F in (0, 1), the closing pad bit in (4, 4); one permutation; output
// lanes (0..3, 0)
__device__ __forceinline__ void keccakf800_core(const uint32_t s[4],
                                                uint64_t pos, uint32_t o[4]) {
  uint32_t a[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) a[i] = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) a[5 * i] = s[i];
  a[20] = (uint32_t)pos;
  a[1] = 0x1Fu;
  a[24] = 0x80000000u;
#pragma unroll
  for (int r = 0; r < 22; ++r) {
    uint32_t c[5], d[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      c[x] = a[5 * x] ^ a[5 * x + 1] ^ a[5 * x + 2] ^ a[5 * x + 3] ^
             a[5 * x + 4];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      d[x] = c[(x + 4) % 5] ^ rotl32(c[(x + 1) % 5], 1);
#pragma unroll
    for (int x = 0; x < 5; ++x)
#pragma unroll
      for (int y = 0; y < 5; ++y)
        b[5 * y + (2 * x + 3 * y) % 5] =
            rotl32_any(a[5 * x + y] ^ d[x], keccak_rho(x, y));
#pragma unroll
    for (int x = 0; x < 5; ++x)
#pragma unroll
      for (int y = 0; y < 5; ++y)
        a[5 * x + y] = b[5 * x + y] ^
                       (~b[5 * ((x + 1) % 5) + y] & b[5 * ((x + 2) % 5) + y]);
    a[0] ^= keccak_rc(r);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = a[5 * i];
}

// ------------------------------------------------------ HighwayHash proxy

__host__ __device__ constexpr uint64_t hwy_init(int i) {
  return 0x9E3779B97F4A7C15ull * (uint64_t)(2 * i + 1);
}

struct HwyState {
  uint64_t v0[4], v1[4], mul0[4], mul1[4];
};

__device__ __forceinline__ uint64_t swap_halves(uint64_t x) {
  return rotl64(x, 32);
}

__device__ __forceinline__ void hwy_update(HwyState& st,
                                           const uint64_t pkt[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st.v1[i] += st.mul0[i] + pkt[i];
    st.mul0[i] ^= (uint64_t)(uint32_t)st.v1[i] * (uint32_t)(st.v0[i] >> 32);
    st.v0[i] += st.mul1[i];
    st.mul1[i] ^= (uint64_t)(uint32_t)st.v0[i] * (uint32_t)(st.v1[i] >> 32);
  }
  uint64_t v0[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v0[i] = st.v0[i] + swap_halves(st.v1[(i + 1) % 4]);
#pragma unroll
  for (int i = 0; i < 4; ++i) st.v0[i] = v0[i];
  uint64_t v1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v1[i] = st.v1[i] + swap_halves(st.v0[(i + 2) % 4]);
#pragma unroll
  for (int i = 0; i < 4; ++i) st.v1[i] = v1[i];
}

// HighwayHash-style op mix with non-published constants (NOT HighwayHash)
__device__ __forceinline__ void highway_proxy_core(const uint32_t s[4],
                                                   uint64_t pos,
                                                   uint32_t o[4]) {
  HwyState st;
  uint64_t packet[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st.v0[i] = hwy_init(i) ^ (s[i] | ((uint64_t)s[(i + 1) % 4] << 32));
    st.v1[i] = hwy_init(4 + i);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st.mul0[i] = st.v0[i] ^ hwy_init((i + 2) % 8);
    st.mul1[i] = st.v1[i] ^ hwy_init((i + 5) % 8);
    packet[i] = (pos << 1) ^ ((uint64_t)i * 0x0123456789ABCDEFull);
  }
  hwy_update(st, packet);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    uint64_t p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = rotl64(packet[i], 17 * (r + 1));
    hwy_update(st, p);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {   // permuted-state finalization rounds
    uint64_t p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = st.v0[(i + 2) % 4];
    hwy_update(st, p);
  }
  const uint64_t out0 = (st.v0[0] + st.v1[0]) + (st.mul0[0] + st.mul1[0]);
  const uint64_t out1 = (st.v0[1] + st.v1[1]) + (st.mul0[1] + st.mul1[1]);
  o[0] = (uint32_t)out0;
  o[1] = (uint32_t)(out0 >> 32);
  o[2] = (uint32_t)out1;
  o[3] = (uint32_t)(out1 >> 32);
}

// --------------------------------------------------------------------- MD5

// K[i] = floor(|sin(i + 1)| 2^32), as prf_zoo_hash derives them
__host__ __device__ constexpr uint32_t md5_k(int i) {
  const uint32_t k[64] = {
      0xD76AA478u, 0xE8C7B756u, 0x242070DBu, 0xC1BDCEEEu, 0xF57C0FAFu,
      0x4787C62Au, 0xA8304613u, 0xFD469501u, 0x698098D8u, 0x8B44F7AFu,
      0xFFFF5BB1u, 0x895CD7BEu, 0x6B901122u, 0xFD987193u, 0xA679438Eu,
      0x49B40821u, 0xF61E2562u, 0xC040B340u, 0x265E5A51u, 0xE9B6C7AAu,
      0xD62F105Du, 0x02441453u, 0xD8A1E681u, 0xE7D3FBC8u, 0x21E1CDE6u,
      0xC33707D6u, 0xF4D50D87u, 0x455A14EDu, 0xA9E3E905u, 0xFCEFA3F8u,
      0x676F02D9u, 0x8D2A4C8Au, 0xFFFA3942u, 0x8771F681u, 0x6D9D6122u,
      0xFDE5380Cu, 0xA4BEEA44u, 0x4BDECFA9u, 0xF6BB4B60u, 0xBEBFBC70u,
      0x289B7EC6u, 0xEAA127FAu, 0xD4EF3085u, 0x04881D05u, 0xD9D4D039u,
      0xE6DB99E5u, 0x1FA27CF8u, 0xC4AC5665u, 0xF4292244u, 0x432AFF97u,
      0xAB9423A7u, 0xFC93A039u, 0x655B59C3u, 0x8F0CCC92u, 0xFFEFF47Du,
      0x85845DD1u, 0x6FA87E4Fu, 0xFE2CE6E0u, 0xA3014314u, 0x4E0811A1u,
      0xF7537E82u, 0xBD3AF235u, 0x2AD7D2BBu, 0xEB86D391u};
  return k[i];
}

__host__ __device__ constexpr int md5_s(int i) {
  const int s[16] = {7, 12, 17, 22, 5, 9, 14, 20,
                     4, 11, 16, 23, 6, 10, 15, 21};
  return s[4 * (i / 16) + i % 4];
}

__host__ __device__ constexpr int md5_g(int i) {
  return i < 16 ? i : i < 32 ? (5 * i + 1) % 16
                    : i < 48 ? (3 * i + 5) % 16 : (7 * i) % 16;
}

// MD5(seed LE bytes || pos LE 4 bytes): one padded block; the digest's
// state words are the output limbs
__device__ __forceinline__ void md5_core(const uint32_t s[4], uint64_t pos,
                                         uint32_t o[4]) {
  const uint32_t m[16] = {s[0], s[1], s[2], s[3], (uint32_t)pos, 0x80u,
                          0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 160u, 0u};
  const uint32_t iv[4] = {0x67452301u, 0xEFCDAB89u, 0x98BADCFEu,
                          0x10325476u};
  uint32_t a = iv[0], b = iv[1], c = iv[2], d = iv[3];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    uint32_t f;
    if (i < 16)
      f = (b & c) | (~b & d);
    else if (i < 32)
      f = (d & b) | (~d & c);
    else if (i < 48)
      f = b ^ c ^ d;
    else
      f = c ^ (b | ~d);
    f = f + a + md5_k(i) + m[md5_g(i)];
    a = d;
    d = c;
    c = b;
    b = b + rotl32(f, md5_s(i));
  }
  o[0] = a + iv[0];
  o[1] = b + iv[1];
  o[2] = c + iv[2];
  o[3] = d + iv[3];
}

// ----------------------------------------------------------------- SHA-256

// the fractional bits of the first primes' square and cube roots, as
// prf_zoo_hash derives them with integer roots
__host__ __device__ constexpr uint32_t sha256_h0(int i) {
  const uint32_t h[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u,
                         0xA54FF53Au, 0x510E527Fu, 0x9B05688Cu,
                         0x1F83D9ABu, 0x5BE0CD19u};
  return h[i];
}

__host__ __device__ constexpr uint32_t sha256_k(int i) {
  const uint32_t k[64] = {
      0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu,
      0x59F111F1u, 0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u,
      0x243185BEu, 0x550C7DC3u, 0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u,
      0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u, 0x0FC19DC6u, 0x240CA1CCu,
      0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu, 0x983E5152u,
      0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
      0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu,
      0x53380D13u, 0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u,
      0xA2BFE8A1u, 0xA81A664Bu, 0xC24B8B70u, 0xC76C51A3u, 0xD192E819u,
      0xD6990624u, 0xF40E3585u, 0x106AA070u, 0x19A4C116u, 0x1E376C08u,
      0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au, 0x5B9CCA4Fu,
      0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
      0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u};
  return k[i];
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0u, 0x0123u);
}

// SHA-256(seed LE bytes || pos LE 4 bytes) truncated to 128 bits; the
// output limbs' bytes are the digest's bytes 0..15
__device__ __forceinline__ void sha256_core(const uint32_t s[4],
                                            uint64_t pos, uint32_t o[4]) {
  uint32_t w[64];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = bswap32(s[i]);
  w[4] = bswap32((uint32_t)pos);
  w[5] = 0x80000000u;
#pragma unroll
  for (int i = 6; i < 15; ++i) w[i] = 0u;
  w[15] = 160u;
#pragma unroll
  for (int t = 16; t < 64; ++t) {
    const uint32_t s0 = rotr32(w[t - 15], 7) ^ rotr32(w[t - 15], 18) ^
                        (w[t - 15] >> 3);
    const uint32_t s1 = rotr32(w[t - 2], 17) ^ rotr32(w[t - 2], 19) ^
                        (w[t - 2] >> 10);
    w[t] = w[t - 16] + s0 + w[t - 7] + s1;
  }
  uint32_t a = sha256_h0(0), b = sha256_h0(1), c = sha256_h0(2),
           d = sha256_h0(3), e = sha256_h0(4), f = sha256_h0(5),
           g = sha256_h0(6), h = sha256_h0(7);
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    const uint32_t s1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + s1 + ch + sha256_k(t) + w[t];
    const uint32_t s0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + s0 + maj;
  }
  o[0] = bswap32(a + sha256_h0(0));
  o[1] = bswap32(b + sha256_h0(1));
  o[2] = bswap32(c + sha256_h0(2));
  o[3] = bswap32(d + sha256_h0(3));
}

// ------------------------------------------------------------------ kernel

// one candidate's 128-bit output at pos (ids 0-12)
template <int C>
__device__ __forceinline__ void zoo_child(const uint32_t s[4], uint64_t pos,
                                          uint32_t o[4]) {
  if constexpr (C <= 2) {          // Salsa20/8, /12, /20: words 4..1
    uint32_t x[16];
    salsa_block<C == 0 ? 8 : C == 1 ? 12 : 20>(s, pos, x);
    o[0] = x[4]; o[1] = x[3]; o[2] = x[2]; o[3] = x[1];
  } else if constexpr (C <= 5) {   // ChaCha8, 12, 20: words 7..4
    uint32_t x[16];
    chacha_block<C == 3 ? 8 : C == 4 ? 12 : 20>(s, pos, x);
    o[0] = x[7]; o[1] = x[6]; o[2] = x[5]; o[3] = x[4];
  } else if constexpr (C == 6) {
    siphash_core<2, 4>(s, pos, o);
  } else if constexpr (C == 7) {
    siphash_core<1, 3>(s, pos, o);
  } else if constexpr (C == 8) {
    blake2s_core(s, pos, o);
  } else if constexpr (C == 9) {
    keccakf800_core(s, pos, o);
  } else if constexpr (C == 10) {
    highway_proxy_core(s, pos, o);
  } else if constexpr (C == 11) {
    md5_core(s, pos, o);
  } else {
    sha256_core(s, pos, o);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    prf_zoo_kernel(const uint4* __restrict__ seeds, uint4* __restrict__ out,
                   long long n, uint64_t pos) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint4 sd = seeds[i];
    const uint32_t s[4] = {sd.x, sd.y, sd.z, sd.w};
    if constexpr (C >= 13) {       // block-PRG: all four children
      uint32_t x[16];
      if constexpr (C == 13)
        chacha_block<12>(s, pos, x);
      else
        salsa_block<12>(s, pos, x);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        out[b * n + i] = make_uint4(x[4 * b + 3], x[4 * b + 2],
                                    x[4 * b + 1], x[4 * b]);
    } else {
      uint32_t o[4];
      zoo_child<C>(s, pos, o);
      out[i] = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

template <int C>
cudaError_t launch_one(const uint4* seeds, uint4* out, long long n,
                       uint64_t pos, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // a grid-stride loop over at most 16 blocks an SM (2048 threads: the
  // cores need 17-56 registers, so an SM holds them all)
  const long long want = (n + kThreads - 1) / kThreads;
  const long long blocks = want < 16LL * sms ? want : 16LL * sms;
  prf_zoo_kernel<C><<<(unsigned)blocks, kThreads, 0, stream>>>(seeds, out, n,
                                                               pos);
  return cudaGetLastError();
}

}  // namespace

// candidate id (the order of core/prf_zoo.ZOO), seeds [n, 4] uint32,
// out [n, 4] (ids 0-12: the output at pos) or [4, n, 4] (ids 13-14: the
// four children of the block at counter pos), both 16-byte aligned.
// Returns the launch's cudaError_t.
extern "C" int prf_zoo_launch(int candidate, const void* seeds, void* out,
                              long long n, unsigned long long pos,
                              void* stream) {
  if (candidate < 0 || candidate >= kCandidates || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const uint4* s = (const uint4*)seeds;
  uint4* o = (uint4*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (candidate) {
    case 0: return (int)launch_one<0>(s, o, n, pos, st);
    case 1: return (int)launch_one<1>(s, o, n, pos, st);
    case 2: return (int)launch_one<2>(s, o, n, pos, st);
    case 3: return (int)launch_one<3>(s, o, n, pos, st);
    case 4: return (int)launch_one<4>(s, o, n, pos, st);
    case 5: return (int)launch_one<5>(s, o, n, pos, st);
    case 6: return (int)launch_one<6>(s, o, n, pos, st);
    case 7: return (int)launch_one<7>(s, o, n, pos, st);
    case 8: return (int)launch_one<8>(s, o, n, pos, st);
    case 9: return (int)launch_one<9>(s, o, n, pos, st);
    case 10: return (int)launch_one<10>(s, o, n, pos, st);
    case 11: return (int)launch_one<11>(s, o, n, pos, st);
    case 12: return (int)launch_one<12>(s, o, n, pos, st);
    case 13: return (int)launch_one<13>(s, o, n, pos, st);
    default: return (int)launch_one<14>(s, o, n, pos, st);
  }
}

extern "C" const char* prf_zoo_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
