// K2 subtree_contract: fused GGM subtree expansion + table contraction
// for the stream-cipher PRFs (Salsa20-12, ChaCha20-12 and their block-PRG
// ids 4/5).
//
// Replaces the TPU kernel dpf_tpu/ops/pallas_level.py::
// subtree_contract_pallas (binary schedule).  That kernel walks a grid
// (key tile, frontier subtree) in order on one core, expands each
// subtree breadth-first in VMEM and carries the [TB, E] sum from one
// subtree to the next.  Blocks on the card run in no order, so here:
//
//   * one block per (key, block subtree of CB <= 4096 leaves); the key
//     index varies fastest, so blocks that run together read the same
//     table rows and the table streams from L2, not device memory;
//   * thread 0 walks from the frontier node down to the block's subtree
//     root (one PRF child per level); with a frontier of one node per
//     key (f_levels = 0) the kernel starts at the root, so no level of
//     the tree is left to plain tensor code;
//   * the block expands breadth-first in shared memory to 256 nodes, then
//     each thread expands its node depth-first in registers (a stack of
//     right siblings), as the upstream dpf_hybrid.cu does, and writes the
//     low 32 bits of its leaves to shared memory;
//   * the block multiplies the leaves by their (bit-reversed) table rows,
//     reduces per column in shared memory, and atomically adds [E] into
//     the zeroed [B, E] output.  int32 addition wraps mod 2^32 and is
//     associative, so the order of the atomics changes no bit.
//
// Bound on the H100: operations.  A binary level costs two 12-round core
// blocks per parent (one for the block-PRG ids), ~600 32-bit operations
// each, against a few bytes of input per key; the table (N x E x 4 bytes)
// is read once per key but served from L2.
//
// Cipher layouts (core/prf.py): ChaCha puts the seed in words 7..4 (limb
// 0 in word 7) and the position in word 13, output words 7..4; Salsa puts
// the seed in words 4..1 and the position in word 9, output words 4..1
// (12 rounds despite the name); block-PRG child b is block words
// [4b..4b+3], most significant word first.

#include "dpf_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLogThreads = 8;
constexpr int kMaxLogBlockLeaves = 12;                 // CB <= 4096
constexpr int kMaxDfs = kMaxLogBlockLeaves - kLogThreads;

constexpr uint32_t kSigma0 = 0x65787061u, kSigma1 = 0x6E642033u,
                   kSigma2 = 0x322D6279u, kSigma3 = 0x7465206Bu;

#define CHACHA_QR(a, b, c, d)            \
  x[a] += x[b];                          \
  x[d] = dpf::rotl32(x[d] ^ x[a], 16);   \
  x[c] += x[d];                          \
  x[b] = dpf::rotl32(x[b] ^ x[c], 12);   \
  x[a] += x[b];                          \
  x[d] = dpf::rotl32(x[d] ^ x[a], 8);    \
  x[c] += x[d];                          \
  x[b] = dpf::rotl32(x[b] ^ x[c], 7);

#define SALSA_QR(a, b, c, d)                 \
  x[b] ^= dpf::rotl32(x[a] + x[d], 7);       \
  x[c] ^= dpf::rotl32(x[b] + x[a], 9);       \
  x[d] ^= dpf::rotl32(x[c] + x[b], 13);      \
  x[a] ^= dpf::rotl32(x[d] + x[c], 18);

__device__ __forceinline__ void chacha_block(const uint32_t s[4], uint32_t pos,
                                             uint32_t o[16]) {
  const uint32_t init[16] = {kSigma0, kSigma1, kSigma2, kSigma3,
                             s[3],    s[2],    s[1],    s[0],
                             0u,      0u,      0u,      0u,
                             0u,      pos,     0u,      0u};
  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = init[i];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    CHACHA_QR(0, 4, 8, 12)
    CHACHA_QR(1, 5, 9, 13)
    CHACHA_QR(2, 6, 10, 14)
    CHACHA_QR(3, 7, 11, 15)
    CHACHA_QR(0, 5, 10, 15)
    CHACHA_QR(1, 6, 11, 12)
    CHACHA_QR(2, 7, 8, 13)
    CHACHA_QR(3, 4, 9, 14)
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = x[i] + init[i];
}

__device__ __forceinline__ void salsa_block(const uint32_t s[4], uint32_t pos,
                                            uint32_t o[16]) {
  const uint32_t init[16] = {kSigma0, s[3], s[2],    s[1],
                             s[0],    kSigma1, 0u,   0u,
                             0u,      pos,  kSigma2, 0u,
                             0u,      0u,   0u,      kSigma3};
  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = init[i];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    SALSA_QR(0, 4, 8, 12)
    SALSA_QR(5, 9, 13, 1)
    SALSA_QR(10, 14, 2, 6)
    SALSA_QR(15, 3, 7, 11)
    SALSA_QR(0, 1, 2, 3)
    SALSA_QR(5, 6, 7, 4)
    SALSA_QR(10, 11, 8, 9)
    SALSA_QR(15, 12, 13, 14)
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = x[i] + init[i];
}

// PRF ids: 1 Salsa20-12, 2 ChaCha20-12, 4 Salsa20-12 block-PRG,
// 5 ChaCha20-12 block-PRG.
template <int PRF>
__device__ __forceinline__ void core_block(const uint32_t s[4], uint32_t pos,
                                           uint32_t o[16]) {
  if (PRF == 2 || PRF == 5) {
    chacha_block(s, pos, o);
  } else {
    salsa_block(s, pos, o);
  }
}

// PRF(seed, 0) and PRF(seed, 1) as little-endian limbs.
template <int PRF>
__device__ __forceinline__ void prf_children(const uint32_t s[4],
                                             uint32_t v0[4], uint32_t v1[4]) {
  uint32_t o[16];
  if (PRF == 4 || PRF == 5) {
    core_block<PRF>(s, 0u, o);
    v0[0] = o[3]; v0[1] = o[2]; v0[2] = o[1]; v0[3] = o[0];
    v1[0] = o[7]; v1[1] = o[6]; v1[2] = o[5]; v1[3] = o[4];
  } else if (PRF == 2) {
    chacha_block(s, 0u, o);
    v0[0] = o[7]; v0[1] = o[6]; v0[2] = o[5]; v0[3] = o[4];
    chacha_block(s, 1u, o);
    v1[0] = o[7]; v1[1] = o[6]; v1[2] = o[5]; v1[3] = o[4];
  } else {
    salsa_block(s, 0u, o);
    v0[0] = o[4]; v0[1] = o[3]; v0[2] = o[2]; v0[3] = o[1];
    salsa_block(s, 1u, o);
    v1[0] = o[4]; v1[1] = o[3]; v1[2] = o[2]; v1[3] = o[1];
  }
}

// PRF(seed, br) for one branch br in {0, 1}.
template <int PRF>
__device__ __forceinline__ void prf_child(const uint32_t s[4], uint32_t br,
                                          uint32_t v[4]) {
  uint32_t o[16];
  if (PRF == 4 || PRF == 5) {
    core_block<PRF>(s, 0u, o);
    v[0] = br ? o[7] : o[3];
    v[1] = br ? o[6] : o[2];
    v[2] = br ? o[5] : o[1];
    v[3] = br ? o[4] : o[0];
  } else if (PRF == 2) {
    chacha_block(s, br, o);
    v[0] = o[7]; v[1] = o[6]; v[2] = o[5]; v[3] = o[4];
  } else {
    salsa_block(s, br, o);
    v[0] = o[4]; v[1] = o[3]; v[2] = o[2]; v[3] = o[1];
  }
}

// Both children of node s at the level whose codeword slots are
// slot, slot+1 (flat level i: slot = 2i); codeword row by the seed's LSB.
template <int PRF>
__device__ __forceinline__ void expand_node(const uint32_t s[4],
                                            const uint32_t* cw1s,
                                            const uint32_t* cw2s, int slot,
                                            uint32_t c0[4], uint32_t c1[4]) {
  uint32_t v0[4], v1[4];
  prf_children<PRF>(s, v0, v1);
  const uint32_t* cw = (s[0] & 1u) ? cw2s : cw1s;
  dpf::add128(c0, v0, cw + 4 * slot);
  dpf::add128(c1, v1, cw + 4 * (slot + 1));
}

template <int PRF>
__global__ void __launch_bounds__(kThreads)
    subtree_kernel(const uint32_t* __restrict__ frontier,
                   const uint32_t* __restrict__ cw1,
                   const uint32_t* __restrict__ cw2,
                   const int32_t* __restrict__ table,
                   uint32_t* __restrict__ out, int batch, int f_cnt, int depth,
                   int f_levels, int log_s, int log_cb, int e_total) {
  __shared__ uint32_t cws[2][64 * 4];
  __shared__ uint32_t nodes[2][kThreads * 4];
  __shared__ uint32_t leaves[1 << kMaxLogBlockLeaves];
  __shared__ uint32_t red[kThreads];

  const int tid = threadIdx.x;
  const long long blk = blockIdx.x;
  const int key = (int)(blk % batch);
  const long long sub = blk / batch;           // in [0, F << log_s)
  const int f = (int)(sub >> log_s);
  const long long s_idx = sub & ((1LL << log_s) - 1);

  for (int i = tid; i < 64 * 4; i += kThreads) {
    cws[0][i] = cw1[(long long)key * 256 + i];
    cws[1][i] = cw2[(long long)key * 256 + i];
  }
  __syncthreads();

  // kernel level k (from the frontier) uses flat level depth-1-(f_levels+k)
  // walk from the frontier node to this block's subtree root
  if (tid == 0) {
    const uint32_t* fr = frontier + ((long long)key * f_cnt + f) * 4;
    uint32_t cur[4] = {fr[0], fr[1], fr[2], fr[3]};
    for (int k = 0; k < log_s; ++k) {
      const uint32_t br = (uint32_t)((s_idx >> (log_s - 1 - k)) & 1);
      const int slot = 2 * (depth - 1 - (f_levels + k)) + (int)br;
      uint32_t v[4];
      prf_child<PRF>(cur, br, v);
      const uint32_t* cw = (cur[0] & 1u) ? cws[1] : cws[0];
      dpf::add128(cur, v, cw + 4 * slot);
    }
#pragma unroll
    for (int l = 0; l < 4; ++l) nodes[0][l] = cur[l];
  }
  __syncthreads();

  // breadth-first in shared memory down to W = min(CB, 256) nodes
  const int lb = log_cb < kLogThreads ? log_cb : kLogThreads;
  int k = log_s;
  int buf = 0;
  for (int l = 0; l < lb; ++l, ++k) {
    if (tid < (1 << l)) {
      const uint32_t* src = nodes[buf] + 4 * tid;
      uint32_t s[4] = {src[0], src[1], src[2], src[3]};
      uint32_t c0[4], c1[4];
      expand_node<PRF>(s, cws[0], cws[1], 2 * (depth - 1 - (f_levels + k)),
                       c0, c1);
      uint32_t* dst = nodes[buf ^ 1] + 8 * tid;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dst[q] = c0[q];
        dst[4 + q] = c1[q];
      }
    }
    buf ^= 1;
    __syncthreads();
  }

  // depth-first per thread: leaf q of node tid lands at tid * 2^m + q
  const int m = log_cb - lb;
  if (tid < (1 << lb)) {
    const uint32_t* src = nodes[buf] + 4 * tid;
    uint32_t node[4] = {src[0], src[1], src[2], src[3]};
    uint32_t sib[kMaxDfs > 0 ? kMaxDfs : 1][4];
    uint32_t c0[4], c1[4];
    for (int d = 0; d < m; ++d) {
      expand_node<PRF>(node, cws[0], cws[1],
                       2 * (depth - 1 - (f_levels + k + d)), c0, c1);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        sib[d][q] = c1[q];
        node[q] = c0[q];
      }
    }
    leaves[tid << m] = node[0];
    for (int q = 1; q < (1 << m); ++q) {
      // the lowest set bit of q is the level that turns right
      const int d0 = m - __ffs(q);
#pragma unroll
      for (int l = 0; l < 4; ++l) node[l] = sib[d0][l];
      for (int d = d0 + 1; d < m; ++d) {
        expand_node<PRF>(node, cws[0], cws[1],
                         2 * (depth - 1 - (f_levels + k + d)), c0, c1);
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          sib[d][l] = c1[l];
          node[l] = c0[l];
        }
      }
      leaves[(tid << m) + q] = node[0];
    }
  }
  __syncthreads();

  // contract the CB leaves with table rows row0 .. row0 + CB - 1
  const int cb = 1 << log_cb;
  const long long row0 =
      ((long long)f << (depth - f_levels)) + (s_idx << log_cb);
  for (int e0 = 0; e0 < e_total; e0 += kThreads) {
    int ew = 1;  // lanes per table row: a power of two covering the columns
    while (ew < e_total - e0 && ew < kThreads) ew <<= 1;
    const int e = e0 + tid % ew;
    uint32_t part = 0;
    if (e < e_total) {
      for (int p = tid / ew; p < cb; p += kThreads / ew) {
        part += leaves[p] * (uint32_t)table[(row0 + p) * e_total + e];
      }
    }
    red[tid] = part;
    __syncthreads();
    if (tid < ew && e < e_total) {
      uint32_t sum = 0;
      for (int j = tid; j < kThreads; j += ew) sum += red[j];
      atomicAdd(&out[(long long)key * e_total + e], sum);
    }
    __syncthreads();
  }
}

}  // namespace

// frontier [B, F, 4], cw1/cw2 [B, 64, 4], table [N, E] (bit-reversed
// rows), out [B, E] zeroed by the caller; N = 2^depth, F = 2^f_levels,
// block subtrees of 2^log_cb leaves.  Returns the launch's cudaError_t.
extern "C" int subtree_contract_launch(const void* frontier, const void* cw1,
                                       const void* cw2, const void* table,
                                       void* out, int batch, int f_cnt,
                                       int depth, int f_levels, int log_cb,
                                       int e_total, int prf, void* stream) {
  const int log_s = depth - f_levels - log_cb;
  if (batch <= 0 || log_s < 0 || log_cb > kMaxLogBlockLeaves || e_total <= 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)batch * f_cnt) << log_s;
  const dim3 grid((unsigned)blocks);
  cudaStream_t st = (cudaStream_t)stream;
#define DPF_LAUNCH(P)                                                       \
  subtree_kernel<P><<<grid, kThreads, 0, st>>>(                             \
      (const uint32_t*)frontier, (const uint32_t*)cw1, (const uint32_t*)cw2, \
      (const int32_t*)table, (uint32_t*)out, batch, f_cnt, depth, f_levels, \
      log_s, log_cb, e_total)
  switch (prf) {
    case 1: DPF_LAUNCH(1); break;
    case 2: DPF_LAUNCH(2); break;
    case 4: DPF_LAUNCH(4); break;
    case 5: DPF_LAUNCH(5); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef DPF_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" const char* subtree_contract_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
