// Native PRFs over unsigned __int128 — bit-exact with the framework's
// Python/JAX implementations (semantics per the reference,
// dpf_base/dpf.h:65-235): DUMMY, Salsa20-12, ChaCha20-12, AES-128.
// AES uses AES-NI when the CPU supports it, with a portable fallback.
#pragma once

#include <cstdint>
#include <cstring>

#if defined(__x86_64__)
#include <immintrin.h>
#include <wmmintrin.h>
#endif

namespace dpftpu {

typedef unsigned __int128 u128;

enum PrfMethod {
  kDummy = 0,
  kSalsa20 = 1,
  kChaCha20 = 2,
  kAes128 = 3,
  // Block-PRG ("wide") variants: child pos = 128-bit word group
  // pos%4 of the 512-bit core block at counter pos/4 — one core call
  // serves four GGM children (core/prf_ref.py prf_salsa20_12_blk).
  kSalsa20Blk = 4,
  kChaCha20Blk = 5,
};

inline u128 prf_dummy(u128 seed, u128 pos) {
  u128 t = pos + 4242;
  return seed * t + t;
}

namespace detail {

inline uint32_t rotl32(uint32_t v, int s) { return (v << s) | (v >> (32 - s)); }

constexpr uint32_t kSigma[4] = {0x65787061u, 0x6e642033u, 0x322d6279u,
                                0x7465206bu};

}  // namespace detail

// 12-round Salsa20 full block; 128-bit key in state words 1..4 (MSW
// first), 64-bit counter in words 8..9 (high word first).
inline void salsa20_12_block(u128 seed, u128 ctr, uint32_t out[16]) {
  using detail::rotl32;
  uint32_t in[16] = {0}, x[16];
  in[0] = detail::kSigma[0];
  in[5] = detail::kSigma[1];
  in[10] = detail::kSigma[2];
  in[15] = detail::kSigma[3];
  in[1] = static_cast<uint32_t>(seed >> 96);
  in[2] = static_cast<uint32_t>(seed >> 64);
  in[3] = static_cast<uint32_t>(seed >> 32);
  in[4] = static_cast<uint32_t>(seed);
  in[8] = static_cast<uint32_t>(ctr >> 32);
  in[9] = static_cast<uint32_t>(ctr);
  std::memcpy(x, in, sizeof(x));
#define DPFTPU_SALSA_QR(a, b, c, d)   \
  x[b] ^= rotl32(x[a] + x[d], 7);     \
  x[c] ^= rotl32(x[b] + x[a], 9);     \
  x[d] ^= rotl32(x[c] + x[b], 13);    \
  x[a] ^= rotl32(x[d] + x[c], 18);
  for (int r = 0; r < 6; r++) {
    DPFTPU_SALSA_QR(0, 4, 8, 12)
    DPFTPU_SALSA_QR(5, 9, 13, 1)
    DPFTPU_SALSA_QR(10, 14, 2, 6)
    DPFTPU_SALSA_QR(15, 3, 7, 11)
    DPFTPU_SALSA_QR(0, 1, 2, 3)
    DPFTPU_SALSA_QR(5, 6, 7, 4)
    DPFTPU_SALSA_QR(10, 11, 8, 9)
    DPFTPU_SALSA_QR(15, 12, 13, 14)
  }
#undef DPFTPU_SALSA_QR
  for (int i = 0; i < 16; i++) out[i] = x[i] + in[i];
}

inline u128 prf_salsa20_12(u128 seed, u128 pos) {
  uint32_t o[16];
  salsa20_12_block(seed, pos, o);
  return (static_cast<u128>(o[1]) << 96) | (static_cast<u128>(o[2]) << 64) |
         (static_cast<u128>(o[3]) << 32) | static_cast<u128>(o[4]);
}

// 12-round ChaCha full block; key in words 4..7 (MSW first), 64-bit
// counter in words 12..13 (high word first).
inline void chacha20_12_block(u128 seed, u128 ctr, uint32_t out[16]) {
  using detail::rotl32;
  uint32_t in[16] = {0}, x[16];
  for (int i = 0; i < 4; i++) in[i] = detail::kSigma[i];
  in[4] = static_cast<uint32_t>(seed >> 96);
  in[5] = static_cast<uint32_t>(seed >> 64);
  in[6] = static_cast<uint32_t>(seed >> 32);
  in[7] = static_cast<uint32_t>(seed);
  in[12] = static_cast<uint32_t>(ctr >> 32);
  in[13] = static_cast<uint32_t>(ctr);
  std::memcpy(x, in, sizeof(x));
#define DPFTPU_CHACHA_QR(a, b, c, d)      \
  x[a] += x[b]; x[d] = rotl32(x[d] ^ x[a], 16); \
  x[c] += x[d]; x[b] = rotl32(x[b] ^ x[c], 12); \
  x[a] += x[b]; x[d] = rotl32(x[d] ^ x[a], 8);  \
  x[c] += x[d]; x[b] = rotl32(x[b] ^ x[c], 7);
  for (int r = 0; r < 6; r++) {
    DPFTPU_CHACHA_QR(0, 4, 8, 12)
    DPFTPU_CHACHA_QR(1, 5, 9, 13)
    DPFTPU_CHACHA_QR(2, 6, 10, 14)
    DPFTPU_CHACHA_QR(3, 7, 11, 15)
    DPFTPU_CHACHA_QR(0, 5, 10, 15)
    DPFTPU_CHACHA_QR(1, 6, 11, 12)
    DPFTPU_CHACHA_QR(2, 7, 8, 13)
    DPFTPU_CHACHA_QR(3, 4, 9, 14)
  }
#undef DPFTPU_CHACHA_QR
  for (int i = 0; i < 16; i++) out[i] = x[i] + in[i];
}

inline u128 prf_chacha20_12(u128 seed, u128 pos) {
  uint32_t o[16];
  chacha20_12_block(seed, pos, o);
  return (static_cast<u128>(o[4]) << 96) | (static_cast<u128>(o[5]) << 64) |
         (static_cast<u128>(o[6]) << 32) | static_cast<u128>(o[7]);
}

// Block-PRG variants (see PrfMethod): group pos%4 of block at counter pos/4.
inline u128 blk_child(const uint32_t o[16], u128 pos) {
  int g = 4 * static_cast<int>(pos & 3);
  return (static_cast<u128>(o[g]) << 96) |
         (static_cast<u128>(o[g + 1]) << 64) |
         (static_cast<u128>(o[g + 2]) << 32) | static_cast<u128>(o[g + 3]);
}

inline u128 prf_salsa20_12_blk(u128 seed, u128 pos) {
  uint32_t o[16];
  salsa20_12_block(seed, pos >> 2, o);
  return blk_child(o, pos);
}

inline u128 prf_chacha20_12_blk(u128 seed, u128 pos) {
  uint32_t o[16];
  chacha20_12_block(seed, pos >> 2, o);
  return blk_child(o, pos);
}

// ---------------------------------------------------------------------------
// AES-128 (FIPS-197): key = 16 LE bytes of seed, pt = 16 LE bytes of pos.
// ---------------------------------------------------------------------------

namespace detail {

struct AesTables {
  uint8_t sbox[256];
  AesTables() {
    // generate S-box from the GF(2^8) inverse + affine transform
    uint8_t p = 1, q = 1;
    do {
      p = static_cast<uint8_t>(p ^ (p << 1) ^ ((p & 0x80) ? 0x1B : 0));
      q ^= static_cast<uint8_t>(q << 1);
      q ^= static_cast<uint8_t>(q << 2);
      q ^= static_cast<uint8_t>(q << 4);
      if (q & 0x80) q ^= 0x09;
      sbox[p] = static_cast<uint8_t>(q ^ rotl8(q, 1) ^ rotl8(q, 2) ^
                                     rotl8(q, 3) ^ rotl8(q, 4) ^ 0x63);
    } while (p != 1);
    sbox[0] = 0x63;
  }
  static uint8_t rotl8(uint8_t v, int s) {
    return static_cast<uint8_t>((v << s) | (v >> (8 - s)));
  }
};

inline const AesTables& aes_tables() {
  static AesTables t;
  return t;
}

inline uint8_t xtime(uint8_t b) {
  return static_cast<uint8_t>((b << 1) ^ ((b & 0x80) ? 0x1B : 0));
}

inline void aes128_portable(const uint8_t key[16], const uint8_t in[16],
                            uint8_t out[16]) {
  const uint8_t* S = aes_tables().sbox;
  uint8_t rk[16], st[16];
  std::memcpy(rk, key, 16);
  for (int i = 0; i < 16; i++) st[i] = in[i] ^ rk[i];
  uint8_t rcon = 1;
  for (int round = 1; round <= 10; round++) {
    uint8_t tmp[16];
    // SubBytes + ShiftRows fused: out byte 4c+r <- S[st[4((c+r)%4)+r]]
    for (int c = 0; c < 4; c++)
      for (int r = 0; r < 4; r++)
        tmp[4 * c + r] = S[st[4 * ((c + r) % 4) + r]];
    if (round < 10) {
      for (int c = 0; c < 4; c++) {
        uint8_t* a = tmp + 4 * c;
        uint8_t t = a[0] ^ a[1] ^ a[2] ^ a[3];
        uint8_t a0 = a[0];
        a[0] = static_cast<uint8_t>(a[0] ^ t ^ xtime(a[0] ^ a[1]));
        a[1] = static_cast<uint8_t>(a[1] ^ t ^ xtime(a[1] ^ a[2]));
        a[2] = static_cast<uint8_t>(a[2] ^ t ^ xtime(a[2] ^ a[3]));
        a[3] = static_cast<uint8_t>(a[3] ^ t ^ xtime(a[3] ^ a0));
      }
    }
    // next round key (fused schedule)
    uint8_t w[4] = {S[rk[13]], S[rk[14]], S[rk[15]], S[rk[12]]};
    w[0] ^= rcon;
    rcon = xtime(rcon);
    for (int i = 0; i < 4; i++) rk[i] ^= w[i];
    for (int i = 4; i < 16; i++) rk[i] ^= rk[i - 4];
    for (int i = 0; i < 16; i++) st[i] = tmp[i] ^ rk[i];
  }
  std::memcpy(out, st, 16);
}

#if defined(__x86_64__) && defined(__AES__)
template <int R>
inline __m128i aes_expand_step(__m128i k) {
  __m128i t = _mm_aeskeygenassist_si128(k, R);
  t = _mm_shuffle_epi32(t, 0xFF);
  k = _mm_xor_si128(k, _mm_slli_si128(k, 4));
  k = _mm_xor_si128(k, _mm_slli_si128(k, 4));
  k = _mm_xor_si128(k, _mm_slli_si128(k, 4));
  return _mm_xor_si128(k, t);
}

inline void aes128_ni(const uint8_t key[16], const uint8_t in[16],
                      uint8_t out[16]) {
  __m128i k[11];
  k[0] = _mm_loadu_si128(reinterpret_cast<const __m128i*>(key));
  k[1] = aes_expand_step<0x01>(k[0]);
  k[2] = aes_expand_step<0x02>(k[1]);
  k[3] = aes_expand_step<0x04>(k[2]);
  k[4] = aes_expand_step<0x08>(k[3]);
  k[5] = aes_expand_step<0x10>(k[4]);
  k[6] = aes_expand_step<0x20>(k[5]);
  k[7] = aes_expand_step<0x40>(k[6]);
  k[8] = aes_expand_step<0x80>(k[7]);
  k[9] = aes_expand_step<0x1B>(k[8]);
  k[10] = aes_expand_step<0x36>(k[9]);
  __m128i st = _mm_loadu_si128(reinterpret_cast<const __m128i*>(in));
  st = _mm_xor_si128(st, k[0]);
  for (int r = 1; r < 10; r++) st = _mm_aesenc_si128(st, k[r]);
  st = _mm_aesenclast_si128(st, k[10]);
  _mm_storeu_si128(reinterpret_cast<__m128i*>(out), st);
}
#endif

}  // namespace detail

inline u128 prf_aes128(u128 seed, u128 pos) {
  uint8_t key[16], in[16], out[16];
  std::memcpy(key, &seed, 16);  // little-endian host
  std::memcpy(in, &pos, 16);
#if defined(__x86_64__) && defined(__AES__)
  static const bool has_ni = __builtin_cpu_supports("aes");
  if (has_ni)
    detail::aes128_ni(key, in, out);
  else
    detail::aes128_portable(key, in, out);
#else
  detail::aes128_portable(key, in, out);
#endif
  u128 r;
  std::memcpy(&r, out, 16);
  return r;
}

inline u128 prf(int method, u128 seed, u128 pos) {
  switch (method) {
    case kDummy: return prf_dummy(seed, pos);
    case kSalsa20: return prf_salsa20_12(seed, pos);
    case kChaCha20: return prf_chacha20_12(seed, pos);
    case kAes128: return prf_aes128(seed, pos);
    case kSalsa20Blk: return prf_salsa20_12_blk(seed, pos);
    case kChaCha20Blk: return prf_chacha20_12_blk(seed, pos);
  }
  return 0;
}

}  // namespace dpftpu
