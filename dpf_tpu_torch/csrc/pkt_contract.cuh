// The contraction of the per-key-table kernels (K2's and K4's per-key
// modes, subtree.cu and sqrt_grid.cu): one key's leaves, held in shared
// memory, against that key's own table rows, summed over the block and
// added atomically into the key's row of the zeroed [B, E] output.
//
// No table value serves more than one key, so the rows stream from device
// memory once: each thread owns one 16-byte quad of columns when E = 4 q
// with q a power of two <= the block's threads (the vector form), else
// one column, in sweeps of up to kThreads columns; neighbouring threads
// read neighbouring addresses.  A leaf is read by the threads that share
// its row (one broadcast load).  The block then reduces its lanes by a
// tree in shared memory and issues one atomic per column.  uint32
// addition wraps mod 2^32 and is associative, so neither the split of the
// rows nor the order of the atomics changes a bit.
#pragma once

#include "dpf_common.cuh"

namespace dpf {

// red [lanes, cols] in shared memory: sum over the lanes by halves (a
// tree: for the 64 lanes of E = 16 six short steps, faster here than
// fewer steps of longer sums), then column c < valid added atomically
// to out[c].  Ends with a barrier, so red may be written again after it.
template <int kThreads>
__device__ __forceinline__ void pkt_reduce_add(uint32_t* red, int lanes,
                                               int cols, int valid,
                                               uint32_t* out) {
  __syncthreads();
  for (int s = lanes >> 1; s > 0; s >>= 1) {
    for (int i = threadIdx.x; i < s * cols; i += kThreads)
      red[i] += red[i + s * cols];
    __syncthreads();
  }
  for (int c = threadIdx.x; c < valid; c += kThreads)
    atomicAdd(out + c, red[c]);
  __syncthreads();
}

// out[e] += sum over segments g < nseg and rows p < len of
//   leaves[g ld_leaf + p] * t[(g ld_row + p) e_total + e]
// for every column e < e_total, by all kThreads threads of the block (a
// segment's rows are contiguous in the table).  vec: the vector form (see
// above), t 16-byte aligned.  red: 4 kThreads words of shared memory
// apart from the leaves.  The leaves must be written before a barrier the
// caller passes; the function ends with one, so the leaves and red may be
// written again after it.
template <int kThreads>
__device__ __forceinline__ void pkt_contract(const uint32_t* leaves, int nseg,
                                             int len, int ld_leaf,
                                             long long ld_row,
                                             const uint32_t* t, int e_total,
                                             bool vec, uint32_t* red,
                                             uint32_t* out) {
  const int tid = threadIdx.x;
  if (vec) {
    const int q = e_total >> 2;     // column quads of a row
    const int cq = tid & (q - 1);   // this thread's quad ...
    const int lanes = kThreads / q;
    const int lane = tid / q;       // ... and first row
    uint32_t s0 = 0u, s1 = 0u, s2 = 0u, s3 = 0u;
    for (int g = 0; g < nseg; ++g) {
      const uint32_t* lv = leaves + g * ld_leaf;
      const uint4* tv =
          reinterpret_cast<const uint4*>(t + g * ld_row * e_total) + cq;
      int p = lane;
      // four rows in flight a thread
      for (; p + 3 * lanes < len; p += 4 * lanes) {
        uint4 v[4];
        uint32_t l[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          v[u] = tv[(long long)(p + u * lanes) * q];
          l[u] = lv[p + u * lanes];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          s0 += l[u] * v[u].x;
          s1 += l[u] * v[u].y;
          s2 += l[u] * v[u].z;
          s3 += l[u] * v[u].w;
        }
      }
      for (; p < len; p += lanes) {
        const uint4 v = tv[(long long)p * q];
        const uint32_t l = lv[p];
        s0 += l * v.x;
        s1 += l * v.y;
        s2 += l * v.z;
        s3 += l * v.w;
      }
    }
    // column e = 4 cq + w of lane l at red[l e_total + e]
    red[4 * tid] = s0;
    red[4 * tid + 1] = s1;
    red[4 * tid + 2] = s2;
    red[4 * tid + 3] = s3;
    pkt_reduce_add<kThreads>(red, lanes, e_total, e_total, out);
  } else {
    for (int e0 = 0; e0 < e_total; e0 += kThreads) {
      int ew = 1;  // lanes per row: a power of two covering the columns
      while (ew < e_total - e0 && ew < kThreads) ew <<= 1;
      const int e = e0 + tid % ew;
      const int lanes = kThreads / ew;
      uint32_t s = 0u;
      if (e < e_total)
        for (int g = 0; g < nseg; ++g) {
          const uint32_t* lv = leaves + g * ld_leaf;
          const uint32_t* tg = t + g * ld_row * e_total + e;
          for (int p = tid / ew; p < len; p += lanes)
            s += lv[p] * tg[(long long)p * e_total];
        }
      red[tid] = s;
      pkt_reduce_add<kThreads>(red, lanes, ew, min(ew, e_total - e0),
                               out + e0);
    }
  }
}

}  // namespace dpf
