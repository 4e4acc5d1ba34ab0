// K6 contract_i32_per_key: out[b, e] = sum_j a[b, j] * t[b, j, e]  mod 2^32.
//
// Replaces the batched contraction of the JAX package's per-key-table
// evaluations, an XLA lax.dot_general with a batch axis (not a Pallas
// kernel): the `bdot` of dpf_tpu/core/expand.py:470
// (expand_and_contract_per_key_tables), core/radix4.py:611 and
// core/sqrtn.py:637.  Batch-PIR gives every key its own table, one bin
// of the binned table, so the AES and DUMMY paths end in it: the low 32
// bits of each leaf times its key's own bit-reversed (or digit-reversed)
// table row.  torch has no int32 batched product on CUDA, and
// torch._int_mm has no batch axis.
//
// Bound on the H100: bytes.  No table row is shared between keys, so
// the kernel is a pure stream: each key's rows are read once, B C E 4
// bytes, with its B C 4 bytes of leaves.  At the batch-PIR slice's
// [256, 4096] x [256, 4096, 16] that is 68 MiB, 21.3 us at 3.35 TB/s,
// against 16.8e6 products (one IMAD each, 1.0 us on the FMA pipe).
//
// The design:
//   * one block of 256 threads per (key, range of rows); a key's rows
//     are contiguous (row stride E), keys may sit at any stride (a
//     group's chunk of rows out of [B, N, E] tables), so the table
//     streams in order.  The row ranges are cut so that the grid is
//     about one wave of the blocks the card holds;
//   * when E is 4 q with q a power of two, each thread owns one 16-byte
//     quad of columns and every (256 / q)-th row: its loads are 16-byte
//     words, neighbouring lanes on neighbouring addresses, four rows in
//     flight a thread.  Any other E takes one 4-byte word a thread, the
//     columns in sweeps of up to 256;
//   * the leaf of a row is read by the q threads that share the row
//     (one broadcast load); `a` may have any strides, so the low limbs
//     of [B, C, 4] leaves are taken in place;
//   * the block reduces each column's lanes in shared memory and adds
//     it atomically into the zeroed [B, E] output.  uint32 addition
//     wraps mod 2^32 and is associative, so neither the split of the
//     rows nor the order of the atomics changes a bit.

#include <algorithm>
#include <cstdint>

#include "dpf_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // rows in flight a thread (vector form)

// VEC: e_total = 4 q, q a power of two <= kThreads; the table 16-byte
// aligned with a key stride that is a multiple of 4 words.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    contract_pkt_kernel(const uint32_t* __restrict__ a, long long lda,
                        long long inc, const uint32_t* __restrict__ t,
                        long long ldt, uint32_t* __restrict__ out,
                        long long k_total, int e_total,
                        long long k_per_block) {
  __shared__ uint32_t red[4 * kThreads];
  const long long b = blockIdx.x;
  const long long k0 = (long long)blockIdx.y * k_per_block;
  const long long k1 = min(k_total, k0 + k_per_block);
  const uint32_t* const ak = a + b * lda;
  const uint32_t* const tk = t + b * ldt;
  uint32_t* const ok = out + b * e_total;
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    const int q = e_total >> 2;        // column quads of a row
    const int cq = tid & (q - 1);      // this thread's quad ...
    const int lane = tid / q;          // ... and first row
    const int lanes = kThreads / q;
    const uint4* const tv = reinterpret_cast<const uint4*>(tk) + cq;
    uint32_t s0 = 0u, s1 = 0u, s2 = 0u, s3 = 0u;
    long long j = k0 + lane;
    for (; j + (kUnroll - 1) * lanes < k1; j += kUnroll * lanes) {
      uint4 v[kUnroll];
      uint32_t l[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = tv[(j + u * lanes) * q];
        l[u] = ak[(j + u * lanes) * inc];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s0 += l[u] * v[u].x;
        s1 += l[u] * v[u].y;
        s2 += l[u] * v[u].z;
        s3 += l[u] * v[u].w;
      }
    }
    for (; j < k1; j += lanes) {
      const uint4 v = tv[j * q];
      const uint32_t l = ak[j * inc];
      s0 += l * v.x;
      s1 += l * v.y;
      s2 += l * v.z;
      s3 += l * v.w;
    }
    red[4 * tid] = s0;
    red[4 * tid + 1] = s1;
    red[4 * tid + 2] = s2;
    red[4 * tid + 3] = s3;
    __syncthreads();
    // column e = 4 c + w: the lanes of quad c at red[4 (l q + c) + w]
    for (int e = tid; e < e_total; e += kThreads) {
      uint32_t sum = 0u;
      for (int l = 0; l < lanes; ++l)
        sum += red[4 * (l * q + (e >> 2)) + (e & 3)];
      atomicAdd(ok + e, sum);
    }
  } else {
    for (int e0 = 0; e0 < e_total; e0 += kThreads) {
      int ew = 1;  // lanes per row: a power of two covering the columns
      while (ew < e_total - e0 && ew < kThreads) ew <<= 1;
      const int e = e0 + tid % ew;
      const int lanes = kThreads / ew;
      uint32_t s = 0u;
      if (e < e_total)
        for (long long j = k0 + tid / ew; j < k1; j += lanes)
          s += ak[j * inc] * tk[j * e_total + e];
      red[tid] = s;
      __syncthreads();
      for (int c = tid; c < ew; c += kThreads) {
        if (e0 + c < e_total) {
          uint32_t sum = 0u;
          for (int l = 0; l < lanes; ++l) sum += red[l * ew + c];
          atomicAdd(ok + e0 + c, sum);
        }
      }
      __syncthreads();
    }
  }
}

// Blocks of each form an SM holds, read once per process.
struct Occupancy {
  int per_sm[2] = {1, 1};
  cudaError_t err = cudaSuccess;
  Occupancy() {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[0], contract_pkt_kernel<false>, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[1], contract_pkt_kernel<true>, kThreads, 0);
  }
};

}  // namespace

// a [batch, k_total] int32 (strides lda, inc, in elements), t [batch,
// k_total, e_total] int32 with key stride ldt and contiguous rows, out
// [batch, e_total] int32, zeroed by the caller.  Returns the launch's
// cudaError_t.
extern "C" int contract_pkt_launch(const void* a, long long lda,
                                   long long inc, const void* t,
                                   long long ldt, void* out, long long batch,
                                   long long k_total, int e_total,
                                   int num_sms, void* stream) {
  if (batch <= 0 || k_total <= 0 || e_total <= 0) return (int)cudaSuccess;
  if (batch > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  static const Occupancy occ;  // C++ initialises it once, thread-safely
  if (occ.err != cudaSuccess) return (int)occ.err;
  const int q = e_total / 4;
  const bool vec = e_total % 4 == 0 && q <= kThreads && (q & (q - 1)) == 0 &&
                   (reinterpret_cast<uintptr_t>(t) & 15) == 0 && ldt % 4 == 0;
  // rows a block takes: the batch's blocks fill about one wave of the
  // card, in whole unrolled sweeps of the block's rows
  const long long slots =
      (long long)std::max(num_sms, 1) * std::max(occ.per_sm[vec], 1);
  const long long split = std::max<long long>(1, (slots + batch - 1) / batch);
  const long long step = vec ? (long long)kUnroll * (kThreads / q) : kThreads;
  long long k_per_block = (k_total + split - 1) / split;
  k_per_block = (k_per_block + step - 1) / step * step;
  const long long blocks_k = (k_total + k_per_block - 1) / k_per_block;
  if (blocks_k > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)batch, (unsigned)blocks_k);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* pa = (const uint32_t*)a;
  const uint32_t* pt = (const uint32_t*)t;
  uint32_t* po = (uint32_t*)out;
  if (vec)
    contract_pkt_kernel<true><<<grid, kThreads, 0, st>>>(
        pa, lda, inc, pt, ldt, po, k_total, e_total, k_per_block);
  else
    contract_pkt_kernel<false><<<grid, kThreads, 0, st>>>(
        pa, lda, inc, pt, ldt, po, k_total, e_total, k_per_block);
  return (int)cudaGetLastError();
}

extern "C" const char* contract_pkt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
