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

#include "aes_ttable.cuh"
#include "dpf_common.cuh"

namespace {

constexpr int kThreads = 256;

template <int A>
__global__ void __launch_bounds__(kThreads)
    aes_level_kernel(const uint4* __restrict__ seeds,
                     const uint32_t* __restrict__ cw1,
                     const uint32_t* __restrict__ cw2, long long cw_stride_b,
                     uint4* __restrict__ out, long long w, long long total) {
  __shared__ uint32_t T[256];
  dpf::aes_build_ttable(T);
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
    dpf::next_round_key(T, rk, rcon);
    rcon = ((rcon << 1) ^ ((rcon >> 7) * 0x11bu)) & 0xffu;
#pragma unroll
    for (int b = 0; b < A; ++b) dpf::aes_round(T, st[b], rk);
  }
  dpf::next_round_key(T, rk, rcon);
#pragma unroll
  for (int b = 0; b < A; ++b) dpf::aes_final_round(T, st[b], rk);

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
