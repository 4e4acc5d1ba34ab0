// T-table AES-128 on little-endian columns for Hopper, shared by K1
// (aes_level.cu) and K4's AES instance (sqrt_grid.cu).
//
// Conventions (core/prf_ref.py::prf_aes128): the key is the seed's 16
// little-endian bytes (limb 0 = bytes 0-3), the plaintext is the position's
// 16 little-endian bytes, the ciphertext is re-read little-endian.  So an
// AES column is one limb: byte r of column c = (limb_c >> 8r) & 0xff.
//
// What bounds a T-table AES on the card is its 16 data-dependent table
// lookups per round.  With one table in shared memory the 32 lanes of a
// warp hit random banks, and the warp's lookup replays as often as its
// busiest bank is hit (3-4 times for 32 random bytes).  This core keeps
// one copy of the table per bank and lane l reads only copy l, so every
// lookup of a warp is one shared-memory wavefront whatever the data:
//
//   * the table is 256 entries of 256 bytes (64 KB a block): word 64x + l
//     is T0[x] = (2S, S, S, 3S)[x] for lane l, word 64x + 32 + l is
//     T2[x] = rotl(T0[x], 16).  Both words of lane l lie in bank l;
//   * a lookup's byte offset, 256 x + 4 l (T0) or 256 x + 4 l + 128 (T2),
//     is one byte permute (PRMT) of the state word and the lane's offset,
//     and the load adds the table's base from a uniform register: two
//     instructions per lookup;
//   * rotl is linear over xor, so a round column
//       T0[a] ^ rotl8(T0[b]) ^ rotl16(T0[c]) ^ rotl24(T0[d])
//     is T0[a] ^ T2[c] ^ rotl8(T0[b] ^ T2[d]): one rotation, not three;
//   * the S-box is byte 1 and 2 of T0 and byte 0 and 3 of T2, so the last
//     round and the key schedule read S already in the byte they need and
//     merge four lookups with three byte permutes;
//   * the table is filled with conflict-free stores (a warp's 32 stores
//     write one entry to its 32 copies) from the S-box in constant memory
//     read at a warp-uniform index.
//
// The key schedule runs on the fly, one round key live at a time, and is
// shared by every block encrypted under the key: 40 lookups.  A block
// takes 160 (16 a round), so P blocks under a key take 40 + 160 P
// (aes128_encrypt).  K1's plaintexts b = 0..A-1 differ in one byte, and
// aes128_encrypt_byte0 runs the lookups of rounds 1 and 2 that do not
// read it once for all A: 27 fewer for each block after the first,
// 333 at A = 2 and 599 at A = 4 (utils/sass_count.py::k1_lookups).
#pragma once

#include "dpf_common.cuh"

namespace dpf {

static __constant__ uint8_t kSbox[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b, 0xfe, 0xd7, 0xab, 0x76,
    0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0, 0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0,
    0xb7, 0xfd, 0x93, 0x26, 0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2, 0xeb, 0x27, 0xb2, 0x75,
    0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0, 0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84,
    0x53, 0xd1, 0x00, 0xed, 0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f, 0x50, 0x3c, 0x9f, 0xa8,
    0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5, 0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2,
    0xcd, 0x0c, 0x13, 0xec, 0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14, 0xde, 0x5e, 0x0b, 0xdb,
    0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c, 0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79,
    0xe7, 0xc8, 0x37, 0x6d, 0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f, 0x4b, 0xbd, 0x8b, 0x8a,
    0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e, 0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e,
    0xe1, 0xf8, 0x98, 0x11, 0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f, 0xb0, 0x54, 0xbb, 0x16,
};

constexpr int kAesTableWords = 256 * 64;
constexpr int kAesTableBytes = 4 * kAesTableWords;

// Fill the table with all the block's threads (blockDim.x a multiple of
// 32); the caller synchronises before the first lookup.  Word i is copy
// i % 32 of entry i / 64, so a warp's 32 stores go to 32 banks and its
// S-box reads to one address.
__device__ __forceinline__ void aes_fill_table(uint32_t* T) {
  for (int i = threadIdx.x; i < kAesTableWords; i += blockDim.x) {
    const uint32_t s = kSbox[i >> 6];
    const uint32_t s2 = ((s << 1) ^ ((s >> 7) * 0x1bu)) & 0xffu;
    const uint32_t t0 = s2 | (s << 8) | (s << 16) | ((s2 ^ s) << 24);
    T[i] = (i & 32) ? __byte_perm(t0, 0u, 0x1032) : t0;
  }
}

// A thread's view of the table: its base and its lane's byte offsets
// into the T0 and T2 halves of an entry.
struct AesTable {
  const uint8_t* base;
  uint32_t t0, t2;
};

__device__ __forceinline__ AesTable aes_table(const uint32_t* T) {
  const uint32_t lane4 = 4u * (threadIdx.x & 31u);
  return {reinterpret_cast<const uint8_t*>(T), lane4, lane4 + 128u};
}

// The entry at byte R of w, read at the lane offset `lane` (t.t0 or t.t2):
// PRMT puts the lane offset in byte 0 and byte R of w in byte 1.
template <int R>
__device__ __forceinline__ uint32_t lookup(const AesTable& t, uint32_t lane,
                                           uint32_t w) {
  return *reinterpret_cast<const uint32_t*>(
      t.base + __byte_perm(w, lane, 0x5504 | (R << 4)));
}

// S[byte RA of a] | S[byte RB of b] << 8 | S[byte RC of c] << 16 |
// S[byte RD of d] << 24, each S read from the half that keeps it in the
// byte it lands in.
template <int RA, int RB, int RC, int RD>
__device__ __forceinline__ uint32_t sub_bytes(const AesTable& t, uint32_t a,
                                              uint32_t b, uint32_t c,
                                              uint32_t d) {
  const uint32_t lo = __byte_perm(lookup<RA>(t, t.t2, a),
                                  lookup<RB>(t, t.t0, b), 0x7650);
  const uint32_t hi = __byte_perm(lookup<RC>(t, t.t0, c),
                                  lookup<RD>(t, t.t2, d), 0x7210);
  return __byte_perm(lo, hi, 0x7610);
}

// SubBytes + ShiftRows + MixColumns + AddRoundKey on little-endian columns:
// byte r of new column c comes from old column (c + r) % 4.
__device__ __forceinline__ void aes_round(const AesTable& t, uint32_t s[4],
                                          const uint32_t rk[4]) {
  uint32_t n[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t bd = lookup<1>(t, t.t0, s[(c + 1) & 3]) ^
                        lookup<3>(t, t.t2, s[(c + 3) & 3]);
    n[c] = lookup<0>(t, t.t0, s[c]) ^ lookup<2>(t, t.t2, s[(c + 2) & 3]) ^
           __funnelshift_l(bd, bd, 8) ^ rk[c];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] = n[c];
}

// Last round: no MixColumns.
__device__ __forceinline__ void aes_final_round(const AesTable& t,
                                                uint32_t s[4],
                                                const uint32_t rk[4]) {
  uint32_t n[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    n[c] = sub_bytes<0, 1, 2, 3>(t, s[c], s[(c + 1) & 3], s[(c + 2) & 3],
                                 s[(c + 3) & 3]) ^ rk[c];
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] = n[c];
}

// One AES-128 key-schedule step: RotWord is a right rotation of a
// little-endian word (byte i of it is byte i + 1 of rk[3]), the round
// constant goes into byte 0.
__device__ __forceinline__ void next_round_key(const AesTable& t,
                                               uint32_t rk[4], uint32_t rcon) {
  rk[0] ^= sub_bytes<1, 2, 3, 0>(t, rk[3], rk[3], rk[3], rk[3]) ^ rcon;
  rk[1] ^= rk[0];
  rk[2] ^= rk[1];
  rk[3] ^= rk[2];
}

// P blocks under one AES-128 key: st[p] holds plaintext p on entry and
// its ciphertext on exit.  The key schedule is computed once for all P.
template <int P>
__device__ __forceinline__ void aes128_encrypt(const AesTable& t,
                                               const uint32_t key[4],
                                               uint32_t st[P][4]) {
  uint32_t rk[4] = {key[0], key[1], key[2], key[3]};
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int c = 0; c < 4; ++c) st[p][c] ^= rk[c];
  uint32_t rcon = 1u;
#pragma unroll
  for (int r = 1; r < 10; ++r) {
    next_round_key(t, rk, rcon);
    rcon = ((rcon << 1) ^ ((rcon >> 7) * 0x11bu)) & 0xffu;
#pragma unroll
    for (int p = 0; p < P; ++p) aes_round(t, st[p], rk);
  }
  next_round_key(t, rk, rcon);
#pragma unroll
  for (int p = 0; p < P; ++p) aes_final_round(t, st[p], rk);
}

// A blocks under one AES-128 key whose plaintexts are b = 0..A-1: the
// all-zero block with b in byte 0 (the low byte of column 0).  That is
// the precondition; ct[b] receives block b's ciphertext.  The result is
// aes128_encrypt<A>'s on those plaintexts, bit for bit.
//
// The plaintexts differ only in byte (row 0, column 0), so after
// AddRoundKey columns 1-3 are the key's for every b.  Round 1 reads that
// byte in one lookup, T0 of new column 0; its other 15 lookups, and so
// new columns 1-3, are the same for every b.  Round 2 reads each byte of
// old column 0 once (new column c its byte (4 - c) % 4) and 12 bytes of
// the shared columns.  So rounds 1 and 2 take 15 + A and 12 + 4A lookups,
// not 16A each; from round 3 on every byte differs.  A shared partial
// that feeds a column's rotated half (bd in aes_round) is rotated per
// block after the block's lookup is merged, as in aes_round.
template <int A>
__device__ __forceinline__ void aes128_encrypt_byte0(const AesTable& t,
                                                     const uint32_t key[4],
                                                     uint32_t ct[A][4]) {
  static_assert(A >= 1 && A <= 256, "plaintext b must fit in byte 0");
  uint32_t rk[4] = {key[0], key[1], key[2], key[3]};
  // round 1 on the state {rk[0] ^ b, rk[1], rk[2], rk[3]}
  uint32_t x[A];  // T0 of byte 0 of column 0, one a block
#pragma unroll
  for (int b = 0; b < A; ++b) x[b] = lookup<0>(t, t.t0, rk[0] ^ (uint32_t)b);
  uint32_t m[4];  // new column 0 without x[b]; new columns 1-3
  {
    const uint32_t bd = lookup<1>(t, t.t0, rk[1]) ^ lookup<3>(t, t.t2, rk[3]);
    m[0] = lookup<2>(t, t.t2, rk[2]) ^ __funnelshift_l(bd, bd, 8);
  }
#pragma unroll
  for (int c = 1; c < 4; ++c) {
    const uint32_t bd = lookup<1>(t, t.t0, rk[(c + 1) & 3]) ^
                        lookup<3>(t, t.t2, rk[(c + 3) & 3]);
    m[c] = lookup<0>(t, t.t0, rk[c]) ^ lookup<2>(t, t.t2, rk[(c + 2) & 3]) ^
           __funnelshift_l(bd, bd, 8);
  }
  next_round_key(t, rk, 1u);
#pragma unroll
  for (int c = 0; c < 4; ++c) m[c] ^= rk[c];
#pragma unroll
  for (int b = 0; b < A; ++b) x[b] ^= m[0];  // column 0 of block b

  // round 2 on the state {x[b], m[1], m[2], m[3]}: per new column the
  // shared lookups (q: the unrotated half with the round key, r: the
  // rotated half), then one lookup of x[b] merged into q or r
  next_round_key(t, rk, 2u);
  const uint32_t r0 = lookup<1>(t, t.t0, m[1]) ^ lookup<3>(t, t.t2, m[3]);
  const uint32_t q0 = lookup<2>(t, t.t2, m[2]) ^ __funnelshift_l(r0, r0, 8) ^
                      rk[0];
  const uint32_t r1 = lookup<1>(t, t.t0, m[2]);
  const uint32_t q1 = lookup<0>(t, t.t0, m[1]) ^ lookup<2>(t, t.t2, m[3]) ^
                      rk[1];
  const uint32_t r2 = lookup<1>(t, t.t0, m[3]) ^ lookup<3>(t, t.t2, m[1]);
  const uint32_t q2 = lookup<0>(t, t.t0, m[2]) ^ __funnelshift_l(r2, r2, 8) ^
                      rk[2];
  const uint32_t r3 = lookup<3>(t, t.t2, m[2]);
  const uint32_t q3 = lookup<0>(t, t.t0, m[3]) ^ lookup<2>(t, t.t2, m[1]) ^
                      rk[3];
#pragma unroll
  for (int b = 0; b < A; ++b) {
    const uint32_t bd1 = r1 ^ lookup<3>(t, t.t2, x[b]);
    const uint32_t bd3 = lookup<1>(t, t.t0, x[b]) ^ r3;
    ct[b][0] = q0 ^ lookup<0>(t, t.t0, x[b]);
    ct[b][1] = q1 ^ __funnelshift_l(bd1, bd1, 8);
    ct[b][2] = q2 ^ lookup<2>(t, t.t2, x[b]);
    ct[b][3] = q3 ^ __funnelshift_l(bd3, bd3, 8);
  }

  // rounds 3-10 as aes128_encrypt's
  uint32_t rcon = 4u;
#pragma unroll
  for (int r = 3; r < 10; ++r) {
    next_round_key(t, rk, rcon);
    rcon = ((rcon << 1) ^ ((rcon >> 7) * 0x11bu)) & 0xffu;
#pragma unroll
    for (int b = 0; b < A; ++b) aes_round(t, ct[b], rk);
  }
  next_round_key(t, rk, rcon);
#pragma unroll
  for (int b = 0; b < A; ++b) aes_final_round(t, ct[b], rk);
}

}  // namespace dpf
