// K1 aes_level_step: one GGM level of arity 2 or 4 under AES-128.
//
// Replaces the TPU kernel dpf_tpu/ops/aes_planes.py::aes_level_step_pallas
// (arity 2 for the binary tree and the binary base level of a radix-4
// tree at odd depth, arity 4 for the radix-4 levels), which bit-slices
// 32 keys into uint32 planes for the TPU's vector unit.  A bitsliced core
// does not fit a card thread: with a different key in every lane it needs
// 128 state words and 128 words of round key live at once, more than the
// 255 registers a thread has.  Here the cipher is the word-oriented
// T-table form the upstream GPU-DPF used: one thread per (key, node), the
// arity a template parameter of one kernel.
//
//   child[A j + b] = AES_{seed_j}(b) + (lsb(seed_j) ? cw2 : cw1)[b]  mod 2^128
//
// Conventions (core/prf_ref.py::prf_aes128): the key is the seed's 16
// little-endian bytes (limb 0 = bytes 0-3), the plaintext is the position
// in byte 0, the ciphertext is re-read little-endian.  So an AES column
// is one limb, little-endian: byte r of column c = (limb_c >> 8r) & 0xff,
// and plaintext b is the all-zero block with b in the low byte of limb 0.
//
// Bound on the H100: shared-memory lookups and instruction issue.  Each
// node costs one key schedule (40 S-box lookups) and A encryptions (160
// lookups each) against 16 (1 + A) bytes of device memory: 360 lookups at
// A = 2, 680 at A = 4.  The design:
//
//   * the AES core of aes_ttable.cuh: a 64 KB table with one copy per
//     bank, so a warp's lookup is one wavefront whatever the data, two
//     instructions per lookup and one rotation per round column;
//   * a persistent grid: as many blocks as fit on the card at once
//     (SMs x resident blocks per SM, read once per process), each filling
//     its table once and walking nodes with a grid-stride loop.  A level
//     with fewer nodes launches only the blocks it needs;
//   * the key schedule on the fly, shared by the A plaintexts (at A = 4 it
//     is amortised over twice the children);
//   * 16-byte loads of the seed and stores of the A children, neighbouring
//     threads on neighbouring addresses;
//   * a second form (kLow) for the last level of a frontier group, whose
//     children only the contraction reads, and it only their low limb:
//     it stores limb 0 of the A children as one 8- or 16-byte word, into
//     a contiguous [B, A w] plane (a quarter of the bytes), which K3 then
//     streams without the 12 unused bytes of each leaf.  Everything
//     before the store is the same code.
//
// The SASS of sm_90a (utils/sass_count.py) issues ~1,300 instructions and
// 360 shared-memory loads per node at A = 2, ~2,300 and 680 at A = 4:
// at the card's issue rate and one wavefront per SM per clock, the widest
// level's lookups (2^26 nodes x 360) take longer than its instructions,
// so the lookups are the floor.

#include <algorithm>
#include <type_traits>

#include "aes_ttable.cuh"
#include "dpf_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;  // 64 KB of table each: 3 fit an SM

// The children as stored: whole 16-byte limbs, or limb 0 alone (kLow).
template <bool kLow>
using Child = std::conditional_t<kLow, uint32_t, uint4>;

template <int A, bool kLow>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    aes_level_kernel(const uint4* __restrict__ seeds,
                     const uint32_t* __restrict__ cw1,
                     const uint32_t* __restrict__ cw2, long long cw_stride_b,
                     Child<kLow>* __restrict__ out, long long w,
                     long long total) {
  extern __shared__ uint4 dpf_smem[];
  uint32_t* const T = reinterpret_cast<uint32_t*>(dpf_smem);
  dpf::aes_fill_table(T);
  __syncthreads();
  const dpf::AesTable tab = dpf::aes_table(T);
  const bool narrow = total <= 0xffffffffLL;  // 32-bit key division

  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long key =
        narrow ? (long long)((uint32_t)idx / (uint32_t)w) : idx / w;
    const uint4 sd = seeds[idx];
    const uint32_t k[4] = {sd.x, sd.y, sd.z, sd.w};
    uint32_t st[A][4];  // plaintext b: the all-zero block with b in byte 0
#pragma unroll
    for (int b = 0; b < A; ++b) {
      st[b][0] = (uint32_t)b;
      st[b][1] = st[b][2] = st[b][3] = 0u;
    }
    dpf::aes128_encrypt<A>(tab, k, st);

    // this level's A codewords for this key, selected by the seed's LSB
    const uint32_t* cw = ((sd.x & 1u) ? cw2 : cw1) + key * cw_stride_b;
#pragma unroll
    for (int b = 0; b < A; ++b) {
      const uint32_t c[4] = {cw[4 * b], cw[4 * b + 1], cw[4 * b + 2],
                             cw[4 * b + 3]};
      dpf::add128(st[b], st[b], c);
      if constexpr (!kLow)
        out[A * idx + b] = make_uint4(st[b][0], st[b][1], st[b][2], st[b][3]);
    }
    if constexpr (kLow) {
      if constexpr (A == 4)
        reinterpret_cast<uint4*>(out)[idx] =
            make_uint4(st[0][0], st[1][0], st[2][0], st[3][0]);
      else
        reinterpret_cast<uint2*>(out)[idx] = make_uint2(st[0][0], st[1][0]);
    }
  }
}

// Blocks of the persistent grid for one form: SMs x resident blocks per
// SM, read once per process (0 with the error if the query failed).
template <int A, bool kLow>
struct Grid {
  int blocks = 0;
  cudaError_t err = cudaSuccess;
  Grid() {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             aes_level_kernel<A, kLow>,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             dpf::kAesTableBytes)) != cudaSuccess ||
        (err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, aes_level_kernel<A, kLow>, kThreads,
             dpf::kAesTableBytes)) != cudaSuccess)
      return;
    blocks = sms * per_sm;
  }
};

template <int A, bool kLow>
int launch(const void* seeds, const void* cw1, const void* cw2,
           long long cw_stride_b, void* out, long long w, long long total,
           cudaStream_t stream) {
  static const Grid<A, kLow> grid;  // initialised once, thread-safely
  if (grid.err != cudaSuccess) return (int)grid.err;
  if (grid.blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long blocks =
      std::min<long long>((total + kThreads - 1) / kThreads, grid.blocks);
  aes_level_kernel<A, kLow><<<(unsigned)blocks, kThreads,
                              dpf::kAesTableBytes, stream>>>(
      (const uint4*)seeds, (const uint32_t*)cw1, (const uint32_t*)cw2,
      cw_stride_b, (Child<kLow>*)out, w, total);
  return (int)cudaGetLastError();
}

}  // namespace

// seeds [B, w, 4], cw1/cw2 [B, arity, 4] with key stride cw_stride_b (in
// 32-bit words; inner dims contiguous), arity 2 or 4; out [B, arity*w, 4],
// or with low32 its limb 0 alone, [B, arity*w].  Returns the launch's
// cudaError_t.
extern "C" int aes_level_launch(const void* seeds, const void* cw1,
                                const void* cw2, long long cw_stride_b,
                                void* out, long long batch, long long w,
                                int arity, int low32, void* stream) {
  const long long total = batch * w;
  if (arity != 2 && arity != 4) return (int)cudaErrorInvalidValue;
  if (total <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const auto form = arity == 4 ? (low32 ? launch<4, true> : launch<4, false>)
                               : (low32 ? launch<2, true> : launch<2, false>);
  return form(seeds, cw1, cw2, cw_stride_b, out, w, total, st);
}

extern "C" const char* aes_level_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
