// K3 contract_i32: out[b, e] = sum_k a[b, k] * t[k, e]  mod 2^32.
//
// Replaces dpf_tpu/ops/matmul128.py::dot_i32, an XLA int32 dot_general
// (not a Pallas kernel).  The AES and DUMMY paths end in it
// (dpf_tpu/core/expand.py:437): the low 32 bits of each leaf times its
// bit-reversed table row.  torch has no int32 matmul on CUDA.
//
// Bound on the H100: bytes.  At the main path's shape, a [512, 2^18] x
// t [2^18, 16], the 512 MiB of `a` take 0.165 ms at 3.35 TB/s, while the
// 2.1e9 wrapping products, one IMAD each on the FMA pipe (16.7e12 a
// second), take 0.128 ms.  Tensor cores are no help: an exact 32-bit
// product on the int8 units takes 10 byte-limb products and their bias
// corrections, more work and more traffic for a kernel that is not bound
// by its arithmetic.  The layout of `a` sets the floor: the low limbs
// of [B, K, 4] leaves (inc = 4) sit 16 bytes apart, so every 32-byte
// sector the card moves holds two leaves of which 4 bytes each are used,
// 2 GiB a launch and 0.646 ms whatever the kernel does.  The AES path
// therefore hands in a contiguous plane of low limbs (inc = 1, written
// by K1's low-limb store); DUMMY's binary path still hands in leaves.
//
// The design:
//   * one thread owns one row of `a` and one tile of 16 columns, with 16
//     wrapping uint32 sums in registers; the 32 lanes of a warp are 32
//     rows at the same k, so the table row t[k][0:16] is four 16-byte
//     shared-memory loads that the whole warp reads as broadcasts (one
//     wavefront each, 128 products a wavefront);
//   * `a` reaches shared memory in coalesced row chunks: a stage is 32 k
//     of each of the block's rows and the stage's 32 table rows, copied
//     with cp.async (the intrinsics of <cuda_pipeline_primitives.h>)
//     into a ring of kStages stages, so two stages are in flight while
//     the third is multiplied and the bytes in flight cost no registers.
//     A contiguous, 16-byte-aligned row copies as 16-byte words.  Any
//     other row (leaves at stride 4, another stride, an unaligned start)
//     and the ragged last stage copy one 4-byte word per k, neighbouring
//     lanes on neighbouring k of one row, zero past the end of k: at
//     stride 4 a warp's copy covers 32 leaves, 512 contiguous bytes.  A
//     row chunk sits at a pitch of 36 words, so the threads' 16-byte
//     loads of their own rows hit distinct banks;
//   * a table that is not a whole 16-byte-aligned column tile, and the
//     ragged last stage's table rows, go through registers;
//   * the grid splits k and rows: a block serves up to 128 rows over one
//     range of k, each table row leaving L2 once per 128 rows.  The k
//     ranges are cut so that the grid is one wave of as many blocks as
//     the card holds at once: every block streams the same number of
//     bytes, and no block waits for a second wave;
//   * at the end the block's sums pass through shared memory, so that a
//     warp adds 32 neighbouring words of the zeroed output (two rows of
//     16 columns) with one atomicAdd instruction, not 32 words 64 bytes
//     apart.  Addition mod 2^32 is associative, so the order in which the
//     atomics land changes no bit of the result.

#include <cuda_pipeline_primitives.h>

#include <algorithm>
#include <cstdint>

#include "dpf_common.cuh"

namespace {

constexpr int kCols = 16;      // columns a thread sums (one column tile)
constexpr int kThreads = 128;  // most rows a block serves, one a thread
constexpr int kMinBlocks = 3;  // blocks of kThreads resident on an SM
constexpr int kStages = 3;     // shared-memory ring of copy stages
constexpr int kChunk = 32;     // 32-bit words of a row in one stage
constexpr int kVecs = kChunk / 4;   // its 16-byte words
constexpr int kPitch = kChunk + 4;  // words between rows: no bank conflict
constexpr int kSumPitch = kCols + 4;  // words between rows of the sums

// Words of one stage of a block of `rows` threads: its rows, then the
// stage's table rows.
__host__ __device__ constexpr int stage_words(int rows) {
  return rows * kPitch + kChunk * kCols;
}

// How a row of `a` reaches shared memory.
enum Form {
  kRows = 0,   // contiguous, 16-byte aligned: 16-byte copies
  kWords = 1,  // anything else: a 4-byte copy per k
};

// acc[c] += x * T[c] for the 16 columns of one staged table row.
__device__ __forceinline__ void mac(uint32_t acc[kCols],
                                    const uint4* trow, uint32_t x) {
  const uint4 t0 = trow[0], t1 = trow[1], t2 = trow[2], t3 = trow[3];
  acc[0] += x * t0.x;
  acc[1] += x * t0.y;
  acc[2] += x * t0.z;
  acc[3] += x * t0.w;
  acc[4] += x * t1.x;
  acc[5] += x * t1.y;
  acc[6] += x * t1.z;
  acc[7] += x * t1.w;
  acc[8] += x * t2.x;
  acc[9] += x * t2.y;
  acc[10] += x * t2.z;
  acc[11] += x * t2.w;
  acc[12] += x * t3.x;
  acc[13] += x * t3.y;
  acc[14] += x * t3.z;
  acc[15] += x * t3.w;
}

template <int F>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    contract_kernel(const uint32_t* __restrict__ a, long long lda,
                    long long inc, const uint32_t* __restrict__ t,
                    uint32_t* __restrict__ out, int batch, long long k_total,
                    int e_total, long long k_per_block) {
  extern __shared__ uint4 contract_smem[];  // kStages x [rows | table]
  uint32_t* const ring = reinterpret_cast<uint32_t*>(contract_smem);
  const int nt = blockDim.x;
  const int sw = stage_words(nt);
  const int row0 = blockIdx.y * nt;
  const int row = row0 + threadIdx.x;
  const int e0 = blockIdx.z * kCols;
  const long long kb = (long long)blockIdx.x * k_per_block;
  const long long ke = min(k_total, kb + k_per_block);
  const int stages = (int)((ke - kb + kChunk - 1) / kChunk);
  // a whole column tile of 16-byte-aligned table rows copies as 16 bytes
  const bool table_vec = e0 + kCols <= e_total && e_total % 4 == 0 &&
                         (reinterpret_cast<uintptr_t>(t) & 15) == 0;

  // Copy stage s into its ring slot (nothing past the last stage) and
  // commit one copy group, so that the groups count stages.
  auto copy_stage = [&](int s) {
    if (s < stages) {
      uint32_t* const A = ring + (s % kStages) * sw;
      uint32_t* const T = A + nt * kPitch;
      const long long k0 = kb + (long long)s * kChunk;
      const bool whole = k0 + kChunk <= ke;
      if (F == kRows && whole) {
        // kVecs 16-byte words of each row, neighbouring lanes on one row
        for (int i = threadIdx.x; i < nt * kVecs; i += nt) {
          const int r = i / kVecs, q = i % kVecs;
          if (row0 + r < batch)
            __pipeline_memcpy_async(
                A + r * kPitch + 4 * q,
                a + (long long)(row0 + r) * lda + k0 + 4 * q, 16);
        }
      } else {
        // one word of each row's k a lane, zero past the end of k
        for (int i = threadIdx.x; i < nt * kChunk; i += nt) {
          const int r = i / kChunk, j = i % kChunk;
          if (row0 + r >= batch) continue;
          if (k0 + j < ke)
            __pipeline_memcpy_async(
                A + r * kPitch + j,
                a + (long long)(row0 + r) * lda + (k0 + j) * inc, 4);
          else
            A[r * kPitch + j] = 0u;
        }
      }
      if (table_vec && whole) {
        for (int i = threadIdx.x; i < kChunk * 4; i += nt)
          __pipeline_memcpy_async(
              T + 4 * i, t + (k0 + (i >> 2)) * e_total + e0 + 4 * (i & 3),
              16);
      } else {
        for (int i = threadIdx.x; i < kChunk * kCols; i += nt) {
          const long long k = k0 + i / kCols;
          const int c = e0 + i % kCols;
          T[i] = k < ke && c < e_total ? t[k * e_total + c] : 0u;
        }
      }
    }
    __pipeline_commit();
  };

  uint32_t acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0u;
  for (int s = 0; s < kStages - 1; ++s) copy_stage(s);
  for (int s = 0; s < stages; ++s) {
    __pipeline_wait_prior(kStages - 2);  // this thread's copies of stage s
    __syncthreads();  // everyone's copies landed; stage s - 1 is read
    copy_stage(s + kStages - 1);         // into stage s - 1's slot
    if (row < batch) {
      const uint32_t* const A = ring + (s % kStages) * sw;
      const uint4* const T = reinterpret_cast<const uint4*>(A + nt * kPitch);
      const uint4* const mine =
          reinterpret_cast<const uint4*>(A + threadIdx.x * kPitch);
#pragma unroll
      for (int q = 0; q < kVecs; ++q) {
        const uint4 v = mine[q];
        mac(acc, T + 4 * (4 * q + 0), v.x);
        mac(acc, T + 4 * (4 * q + 1), v.y);
        mac(acc, T + 4 * (4 * q + 2), v.z);
        mac(acc, T + 4 * (4 * q + 3), v.w);
      }
    }
  }
  // every copy has landed (the last stage was waited for); reuse the ring
  __syncthreads();
  uint4* const sums = contract_smem + threadIdx.x * (kSumPitch / 4);
#pragma unroll
  for (int q = 0; q < kCols / 4; ++q)
    sums[q] = make_uint4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                         acc[4 * q + 3]);
  __syncthreads();
  for (int i = threadIdx.x; i < nt * kCols; i += nt) {
    const int r = i / kCols, c = i % kCols;
    if (row0 + r < batch && e0 + c < e_total)
      atomicAdd(out + (long long)(row0 + r) * e_total + e0 + c,
                ring[r * kSumPitch + c]);
  }
}

// Dynamic shared memory of a block of `threads` threads.
constexpr int smem_bytes(int threads) {
  return kStages * stage_words(threads) * 4;
}

// Blocks of each width (32, 64, .. kThreads threads) and form an SM holds,
// read once per process; err if a query failed.
struct Occupancy {
  int per_sm[2][kThreads / 32 + 1] = {};
  cudaError_t err = cudaSuccess;
  template <int F>
  bool query() {
    if ((err = cudaFuncSetAttribute(
             contract_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
             smem_bytes(kThreads))) != cudaSuccess)
      return false;
    for (int w = 1; w <= kThreads / 32; ++w)
      if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm[F][w], contract_kernel<F>, 32 * w,
               smem_bytes(32 * w))) != cudaSuccess)
        return false;
    return true;
  }
  Occupancy() { query<kRows>() && query<kWords>(); }
};

}  // namespace

// a [batch, k_total] int32 (strides lda, inc, in elements), t [k_total,
// e_total] int32 contiguous, out [batch, e_total] int32, zeroed by the
// caller.  Returns the launch's cudaError_t.
extern "C" int contract_i32_launch(const void* a, long long lda,
                                   long long inc, const void* t, void* out,
                                   long long batch, long long k_total,
                                   int e_total, int num_sms, void* stream) {
  if (batch <= 0 || k_total <= 0 || e_total <= 0) return (int)cudaSuccess;
  static const Occupancy occ;  // C++ initialises it once, thread-safely
  if (occ.err != cudaSuccess) return (int)occ.err;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(a) & 15) == 0 && lda % 4 == 0;
  const int form = aligned && inc == 1 ? kRows : kWords;
  // one row a thread; a block as wide as the batch needs, in warps
  const int warps =
      (int)std::min<long long>(kThreads / 32, (batch + 31) / 32);
  const int threads = 32 * warps;
  const long long row_groups = (batch + threads - 1) / threads;
  const long long col_tiles = (e_total + kCols - 1) / kCols;
  if (row_groups > 65535 || col_tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  // split k, in whole stages, so that the grid is one wave of the blocks
  // the card holds
  const long long slots = (long long)std::max(num_sms, 1) *
                          std::max(occ.per_sm[form][warps], 1);
  const long long split =
      std::max<long long>(1, slots / (row_groups * col_tiles));
  long long k_per_block = (k_total + split - 1) / split;
  k_per_block = (k_per_block + kChunk - 1) / kChunk * kChunk;
  const long long blocks_k = (k_total + k_per_block - 1) / k_per_block;
  dim3 grid((unsigned)blocks_k, (unsigned)row_groups, (unsigned)col_tiles);
  const int smem = smem_bytes(threads);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* pa = (const uint32_t*)a;
  const uint32_t* pt = (const uint32_t*)t;
  uint32_t* po = (uint32_t*)out;
  if (form == kRows)
    contract_kernel<kRows><<<grid, threads, smem, st>>>(
        pa, lda, inc, pt, po, (int)batch, k_total, e_total, k_per_block);
  else
    contract_kernel<kWords><<<grid, threads, smem, st>>>(
        pa, lda, inc, pt, po, (int)batch, k_total, e_total, k_per_block);
  return (int)cudaGetLastError();
}

extern "C" const char* contract_i32_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
