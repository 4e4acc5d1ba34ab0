// K5 chacha_level_step: one GGM level under ChaCha20-12.
//
// Replaces the TPU kernel dpf_tpu/ops/pallas_level.py::
// chacha_level_step_pallas (body _level_kernel), which tiles (keys, width)
// into uint32 planes for the TPU's vector unit.  Like that function it is on
// no serving path (the stream ciphers go through the fused K2 and K4); it is
// kept to hold and time one ChaCha level beside K1's AES level.
//
//   child[2 j + b] = ChaCha_{seed_j}(b) + (lsb(seed_j) ? cw2 : cw1)[b]
//                                                              mod 2^128
//
// One thread per (key, node): two core blocks at positions 0 and 1, the
// full 128-bit codeword add (all four limbs are output), children written
// node-major.  Bound on the H100: operations, ~2 x 592 32-bit operations
// of the two blocks plus two adds per node against 16 bytes read and 32
// written; loads and stores are 16 bytes a thread on neighbouring
// addresses.

#include "dpf_common.cuh"
#include "stream_cipher.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    chacha_level_kernel(const uint4* __restrict__ seeds,
                        const uint32_t* __restrict__ cw1,
                        const uint32_t* __restrict__ cw2,
                        long long cw_stride_b, uint4* __restrict__ out,
                        long long w, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long key = idx / w;

  const uint4 sd = seeds[idx];
  const uint32_t s[4] = {sd.x, sd.y, sd.z, sd.w};
  // this level's two codewords for this key, selected by the seed's LSB
  const uint32_t* cw = ((sd.x & 1u) ? cw2 : cw1) + key * cw_stride_b;
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    uint32_t o[16];
    dpf::chacha_block(s, (uint32_t)b, o);
    const uint32_t v[4] = {o[7], o[6], o[5], o[4]};
    const uint32_t c[4] = {cw[4 * b], cw[4 * b + 1], cw[4 * b + 2],
                           cw[4 * b + 3]};
    uint32_t kid[4];
    dpf::add128(kid, v, c);
    out[2 * idx + b] = make_uint4(kid[0], kid[1], kid[2], kid[3]);
  }
}

}  // namespace

// seeds [B, w, 4], cw1/cw2 [B, 2, 4] with key stride cw_stride_b (in
// 32-bit words; inner dims contiguous), out [B, 2w, 4].  Returns the
// launch's cudaError_t.
extern "C" int chacha_level_launch(const void* seeds, const void* cw1,
                                   const void* cw2, long long cw_stride_b,
                                   void* out, long long batch, long long w,
                                   void* stream) {
  const long long total = batch * w;
  if (total <= 0) return (int)cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  chacha_level_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint4*)seeds, (const uint32_t*)cw1, (const uint32_t*)cw2,
      cw_stride_b, (uint4*)out, w, total);
  return (int)cudaGetLastError();
}

extern "C" const char* chacha_level_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
