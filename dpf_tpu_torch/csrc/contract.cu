// K3 contract_i32: out[b, e] = sum_k a[b, k] * t[k, e]  mod 2^32.
//
// Replaces dpf_tpu/ops/matmul128.py::dot_i32, an XLA int32 dot_general
// (not a Pallas kernel).  The AES and DUMMY paths end in it
// (dpf_tpu/core/expand.py:437): the low 32 bits of each leaf times its
// bit-reversed table row.  torch has no int32 matmul on CUDA.
//
// Bound on the H100: bytes.  Each a[b, k] is used once per output column
// (E <= 16 on the main path), so there are 2E operations per 4-byte
// element of a: far below the card's operations-per-byte balance.  The
// design is a plain tiled product: a block owns 16 rows x 16 columns of
// the output and a slice of k (split-K, so even B = 1 fills the card);
// it stages a 16 x 256 tile of a and a 256 x 16 tile of t in shared
// memory, each thread accumulates one output in a register with wrapping
// uint32 arithmetic, and adds it into the zeroed output with one
// atomicAdd.  Integer addition mod 2^32 is associative, so the order in
// which the atomics land does not change a bit of the result.
//
// ``a`` may be strided (row stride lda, element stride inc, in 32-bit
// words): the AES path hands in the low limb of [B, K, 4] leaves (inc=4)
// without a copy.

#include "dpf_common.cuh"

namespace {

constexpr int kRows = 16;     // output rows per block
constexpr int kCols = 16;     // output columns per block
constexpr int kTileK = 256;   // k per shared-memory stage
constexpr int kThreads = kRows * kCols;

__global__ void __launch_bounds__(kThreads)
    contract_kernel(const int32_t* __restrict__ a, long long lda,
                    long long inc, const int32_t* __restrict__ t,
                    uint32_t* __restrict__ out, int batch, long long k_total,
                    int e_total, long long k_per_block) {
  __shared__ uint32_t As[kRows][kTileK + 1];  // +1: no bank conflicts
  __shared__ uint32_t Ts[kTileK][kCols];

  const int row0 = blockIdx.x * kRows;
  const long long kb0 = (long long)blockIdx.y * k_per_block;
  const long long kb1 = min(k_total, kb0 + k_per_block);
  const int e0 = blockIdx.z * kCols;
  const int tr = threadIdx.x / kCols;
  const int tc = threadIdx.x % kCols;

  uint32_t acc = 0;
  for (long long k0 = kb0; k0 < kb1; k0 += kTileK) {
    for (int i = threadIdx.x; i < kRows * kTileK; i += kThreads) {
      const int r = i / kTileK;
      const int kk = i % kTileK;
      const long long k = k0 + kk;
      const int row = row0 + r;
      As[r][kk] = (row < batch && k < kb1)
                      ? (uint32_t)a[(long long)row * lda + k * inc]
                      : 0u;
    }
    for (int i = threadIdx.x; i < kTileK * kCols; i += kThreads) {
      const int kk = i / kCols;
      const int c = i % kCols;
      const long long k = k0 + kk;
      Ts[kk][c] = (k < kb1 && e0 + c < e_total)
                      ? (uint32_t)t[k * e_total + e0 + c]
                      : 0u;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTileK; ++kk) acc += As[tr][kk] * Ts[kk][tc];
    __syncthreads();
  }
  const int row = row0 + tr;
  const int e = e0 + tc;
  if (row < batch && e < e_total) {
    atomicAdd(&out[(long long)row * e_total + e], acc);
  }
}

}  // namespace

// a [batch, k_total] int32 (strides lda, inc), t [k_total, e_total] int32
// contiguous, out [batch, e_total] int32, zeroed by the caller.  Returns
// the launch's cudaError_t.
extern "C" int contract_i32_launch(const void* a, long long lda,
                                   long long inc, const void* t, void* out,
                                   long long batch, long long k_total,
                                   int e_total, int num_sms, void* stream) {
  if (batch <= 0 || k_total <= 0 || e_total <= 0) return (int)cudaSuccess;
  const long long row_tiles = (batch + kRows - 1) / kRows;
  const long long col_tiles = (e_total + kCols - 1) / kCols;
  const long long k_tiles = (k_total + kTileK - 1) / kTileK;
  // split k until the grid holds about eight blocks per SM
  const long long want = 8LL * (num_sms > 0 ? num_sms : 132);
  long long split = (want + row_tiles * col_tiles - 1) / (row_tiles * col_tiles);
  if (split > k_tiles) split = k_tiles;
  if (split > 65535) split = 65535;
  if (split < 1) split = 1;
  const long long tiles_per_block = (k_tiles + split - 1) / split;
  split = (k_tiles + tiles_per_block - 1) / tiles_per_block;
  dim3 grid((unsigned)row_tiles, (unsigned)split, (unsigned)col_tiles);
  contract_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, lda, inc, (const int32_t*)t, (uint32_t*)out,
      (int)batch, k_total, e_total, tiles_per_block * kTileK);
  return (int)cudaGetLastError();
}

extern "C" const char* contract_i32_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
