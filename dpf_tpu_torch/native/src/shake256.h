// SHAKE-256 XOF (FIPS-202), self-contained implementation for the native
// keygen DRBG.  Must produce byte-identical streams to Python's
// hashlib.shake_256 so native and Python keygen agree key-for-key
// (dpf_tpu/core/keygen.py Shake256Drbg).
#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

namespace dpftpu {

class Keccak1600 {
 public:
  static constexpr int kRounds = 24;

  static void permute(uint64_t st[25]) {
    static const uint64_t RC[kRounds] = {
        0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
        0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
        0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
        0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
        0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
        0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
        0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
        0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};
    static const int rho[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10,
                                43, 25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56,
                                14};
    for (int round = 0; round < kRounds; round++) {
      // theta
      uint64_t C[5], D[5];
      for (int x = 0; x < 5; x++)
        C[x] = st[x] ^ st[x + 5] ^ st[x + 10] ^ st[x + 15] ^ st[x + 20];
      for (int x = 0; x < 5; x++) {
        D[x] = C[(x + 4) % 5] ^ rotl(C[(x + 1) % 5], 1);
        for (int y = 0; y < 5; y++) st[x + 5 * y] ^= D[x];
      }
      // rho + pi
      uint64_t B[25];
      for (int x = 0; x < 5; x++)
        for (int y = 0; y < 5; y++)
          B[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(st[x + 5 * y],
                                                  rho[x + 5 * y]);
      // chi
      for (int x = 0; x < 5; x++)
        for (int y = 0; y < 5; y++)
          st[x + 5 * y] = B[x + 5 * y] ^
                          ((~B[(x + 1) % 5 + 5 * y]) & B[(x + 2) % 5 + 5 * y]);
      // iota
      st[0] ^= RC[round];
    }
  }

 private:
  static inline uint64_t rotl(uint64_t v, int s) {
    return s == 0 ? v : (v << s) | (v >> (64 - s));
  }
};

// One-shot SHAKE-256: absorb `in`, squeeze `outlen` bytes.
inline void shake256(const uint8_t* in, size_t inlen, uint8_t* out,
                     size_t outlen) {
  constexpr size_t rate = 136;  // SHAKE-256 rate in bytes
  uint64_t st[25];
  std::memset(st, 0, sizeof(st));
  // absorb
  size_t off = 0;
  while (inlen - off >= rate) {
    for (size_t i = 0; i < rate; i++)
      reinterpret_cast<uint8_t*>(st)[i] ^= in[off + i];
    Keccak1600::permute(st);
    off += rate;
  }
  // final partial block + padding (0x1F ... 0x80)
  uint8_t* stb = reinterpret_cast<uint8_t*>(st);
  for (size_t i = 0; i < inlen - off; i++) stb[i] ^= in[off + i];
  stb[inlen - off] ^= 0x1F;
  stb[rate - 1] ^= 0x80;
  Keccak1600::permute(st);
  // squeeze
  size_t produced = 0;
  while (produced < outlen) {
    size_t take = std::min(rate, outlen - produced);
    std::memcpy(out + produced, st, take);
    produced += take;
    if (produced < outlen) Keccak1600::permute(st);
  }
}

// Deterministic DRBG matching Python's Shake256Drbg: the stream is the
// concatenation of SHAKE-256(seed || ctr_le64)[0:1024] blocks.
class Shake256Drbg {
 public:
  Shake256Drbg(const uint8_t* seed, size_t seed_len)
      : seed_(seed, seed + seed_len), ctr_(0), pos_(0) {}

  void bytes(uint8_t* out, size_t n) {
    size_t got = 0;
    while (got < n) {
      if (pos_ == buf_.size()) refill();
      size_t take = std::min(n - got, buf_.size() - pos_);
      std::memcpy(out + got, buf_.data() + pos_, take);
      pos_ += take;
      got += take;
    }
  }

  unsigned __int128 u128() {
    uint8_t b[16];
    bytes(b, 16);
    unsigned __int128 v = 0;
    for (int i = 15; i >= 0; i--) v = (v << 8) | b[i];  // little-endian
    return v;
  }

  unsigned __int128 u128_odd() { return u128() | 1; }

 private:
  void refill() {
    std::vector<uint8_t> msg(seed_);
    for (int i = 0; i < 8; i++)
      msg.push_back(static_cast<uint8_t>((ctr_ >> (8 * i)) & 0xFF));
    ctr_++;
    buf_.assign(1024, 0);
    shake256(msg.data(), msg.size(), buf_.data(), buf_.size());
    pos_ = 0;
  }

  std::vector<uint8_t> seed_;
  uint64_t ctr_;
  std::vector<uint8_t> buf_;
  size_t pos_;
};

}  // namespace dpftpu
