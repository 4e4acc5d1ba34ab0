// K1 aes_level_step: one GGM level of arity 2 or 4 under AES-128.
//
// Replaces the TPU kernel dpf_tpu/ops/aes_planes.py::aes_level_step_pallas
// (arity 2 for the binary tree and the binary base level of a radix-4
// tree at odd depth, arity 4 for the radix-4 levels), which bit-slices
// 32 keys into uint32 planes for the TPU's vector unit.  Here the cipher
// is the word-oriented T-table form the upstream GPU-DPF used: one thread
// per (key, node), the arity a template parameter of one kernel.
//
//   child[A j + b] = AES_{seed_j}(b) + (lsb(seed_j) ? cw2 : cw1)[b]  mod 2^128
//
// Conventions (core/prf_ref.py::prf_aes128): the key is the seed's 16
// little-endian bytes (limb 0 = bytes 0-3), the plaintext is the position
// in byte 0, the ciphertext is re-read little-endian.  So an AES column
// is one limb, little-endian: byte r of column c = (limb_c >> 8r) & 0xff,
// and plaintext b is the all-zero block with b in the low byte of limb 0.
//
// Bound on the H100: operations.  Each node costs one key schedule and
// A encryptions, ~160 + 180 A table lookups in shared memory plus ALU
// work, against 16 (1 + A) bytes of device memory.  The design keeps one
// 1 KB table (T0; the S-box is byte 1 of it, the other three T-tables
// are rotations), builds it per block from constant memory, and runs the
// key schedule on the fly so one round key is live at a time and the A
// plaintexts share it (at A = 4 the schedule is amortised over twice the
// children).  Loads and stores are 16 bytes a thread on neighbouring
// addresses.

#include "dpf_common.cuh"

namespace {

__constant__ uint8_t kSbox[256] = {
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

constexpr int kThreads = 256;

// S-box through T0: T0[x] = (2S, S, S, 3S) as bytes 0..3, so S = byte 1.
__device__ __forceinline__ uint32_t sbox_t(const uint32_t* T, uint32_t x) {
  return (T[x] >> 8) & 0xffu;
}

__device__ __forceinline__ uint32_t sub_word(const uint32_t* T, uint32_t w) {
  return sbox_t(T, w & 0xffu) | (sbox_t(T, (w >> 8) & 0xffu) << 8) |
         (sbox_t(T, (w >> 16) & 0xffu) << 16) | (sbox_t(T, w >> 24) << 24);
}

// SubBytes + ShiftRows + MixColumns + AddRoundKey on little-endian columns:
// byte r of new column c comes from old column (c + r) % 4.
__device__ __forceinline__ void aes_round(const uint32_t* T, uint32_t s[4],
                                          const uint32_t rk[4]) {
  uint32_t n[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    n[c] = T[s[c] & 0xffu] ^ dpf::rotl32(T[(s[(c + 1) & 3] >> 8) & 0xffu], 8) ^
           dpf::rotl32(T[(s[(c + 2) & 3] >> 16) & 0xffu], 16) ^
           dpf::rotl32(T[s[(c + 3) & 3] >> 24], 24) ^ rk[c];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] = n[c];
}

// Last round: no MixColumns.
__device__ __forceinline__ void aes_final_round(const uint32_t* T,
                                                uint32_t s[4],
                                                const uint32_t rk[4]) {
  uint32_t n[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    n[c] = (sbox_t(T, s[c] & 0xffu) | (sbox_t(T, (s[(c + 1) & 3] >> 8) & 0xffu) << 8) |
            (sbox_t(T, (s[(c + 2) & 3] >> 16) & 0xffu) << 16) |
            (sbox_t(T, s[(c + 3) & 3] >> 24) << 24)) ^
           rk[c];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] = n[c];
}

// One AES-128 key-schedule step: RotWord is a right rotation of a
// little-endian word, the round constant goes into byte 0.
__device__ __forceinline__ void next_round_key(const uint32_t* T,
                                               uint32_t rk[4], uint32_t rcon) {
  const uint32_t t = sub_word(T, (rk[3] >> 8) | (rk[3] << 24)) ^ rcon;
  rk[0] ^= t;
  rk[1] ^= rk[0];
  rk[2] ^= rk[1];
  rk[3] ^= rk[2];
}

template <int A>
__global__ void __launch_bounds__(kThreads)
    aes_level_kernel(const uint4* __restrict__ seeds,
                     const uint32_t* __restrict__ cw1,
                     const uint32_t* __restrict__ cw2, long long cw_stride_b,
                     uint4* __restrict__ out, long long w, long long total) {
  __shared__ uint32_t T[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const uint32_t s = kSbox[i];
    const uint32_t s2 = ((s << 1) ^ ((s >> 7) * 0x1bu)) & 0xffu;
    T[i] = s2 | (s << 8) | (s << 16) | ((s2 ^ s) << 24);
  }
  __syncthreads();

  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long key = idx / w;

  const uint4 sd = seeds[idx];
  uint32_t rk[4] = {sd.x, sd.y, sd.z, sd.w};
  uint32_t st[A][4];  // plaintext b xor the first round key
#pragma unroll
  for (int b = 0; b < A; ++b) {
    st[b][0] = sd.x ^ (uint32_t)b;
    st[b][1] = sd.y;
    st[b][2] = sd.z;
    st[b][3] = sd.w;
  }
  uint32_t rcon = 1u;
#pragma unroll 1
  for (int r = 1; r < 10; ++r) {
    next_round_key(T, rk, rcon);
    rcon = ((rcon << 1) ^ ((rcon >> 7) * 0x11bu)) & 0xffu;
#pragma unroll
    for (int b = 0; b < A; ++b) aes_round(T, st[b], rk);
  }
  next_round_key(T, rk, rcon);
#pragma unroll
  for (int b = 0; b < A; ++b) aes_final_round(T, st[b], rk);

  // this level's A codewords for this key, selected by the seed's LSB
  const uint32_t* cw = ((sd.x & 1u) ? cw2 : cw1) + key * cw_stride_b;
#pragma unroll
  for (int b = 0; b < A; ++b) {
    const uint32_t c[4] = {cw[4 * b], cw[4 * b + 1], cw[4 * b + 2],
                           cw[4 * b + 3]};
    dpf::add128(st[b], st[b], c);
    out[A * idx + b] = make_uint4(st[b][0], st[b][1], st[b][2], st[b][3]);
  }
}

}  // namespace

// seeds [B, w, 4], cw1/cw2 [B, arity, 4] with key stride cw_stride_b (in
// 32-bit words; inner dims contiguous), out [B, arity*w, 4], arity 2 or
// 4.  Returns the launch's cudaError_t.
extern "C" int aes_level_launch(const void* seeds, const void* cw1,
                                const void* cw2, long long cw_stride_b,
                                void* out, long long batch, long long w,
                                int arity, void* stream) {
  const long long total = batch * w;
  if (arity != 2 && arity != 4) return (int)cudaErrorInvalidValue;
  if (total <= 0) return (int)cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
#define DPF_LAUNCH(A)                                                      \
  aes_level_kernel<A><<<(unsigned)blocks, kThreads, 0,                     \
                        (cudaStream_t)stream>>>(                           \
      (const uint4*)seeds, (const uint32_t*)cw1, (const uint32_t*)cw2,     \
      cw_stride_b, (uint4*)out, w, total)
  if (arity == 4) {
    DPF_LAUNCH(4);
  } else {
    DPF_LAUNCH(2);
  }
#undef DPF_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" const char* aes_level_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
