// K2 subtree_contract: fused GGM subtree expansion + table contraction
// for the stream-cipher PRFs (Salsa20-12, ChaCha20-12 and their block-PRG
// ids 4/5), over a per-level arity schedule.
//
// Replaces the TPU kernels dpf_tpu/ops/pallas_level.py::
// subtree_contract_pallas (binary schedule) and
// subtree_contract_pallas_mixed (radix-4 schedule: arities ars[f_lv:],
// codeword slots at radix4.cw_offsets).  Those kernels walk a grid (key
// tile of 32, frontier subtree) in order on one core, expand each subtree
// breadth-first in VMEM, contract [TB, C] leaves with one table chunk per
// step and carry the [TB, E] sum from one subtree to the next.  Blocks on
// the card run in no order, so here:
//
//   * one kernel serves both trees: the caller passes each eval level's
//     arity (2 or 4) and codeword slot (Sched); the binary tree's slots
//     are the reversed wire layout 2 (depth-1-j) + b, a radix-4 tree's
//     are its eval-order blocks cw_offsets(ars)[j] + b.  A block subtree
//     of binary levels only takes an instance with the arity fixed at 2;
//   * one block per (key tile of kTileKeys = 4 keys, block subtree of
//     CB <= 4096 leaves); the tile index varies fastest, so blocks that
//     run together read the same table rows and the table streams from
//     L2, not device memory.  The last tile of a ragged batch is masked;
//   * the tile's keys expand side by side, 256 / 4 threads each (a batch
//     of one key gets all 256, so it does not leave three quarters of a
//     block idle; at 2 keys, 128 threads would leave half of a radix-4
//     key's threads idle in the breadth-first phase), reading their
//     codewords from global memory (L1).  One thread per key walks
//     from the frontier node down to the block's subtree root, one PRF
//     child per level, taking the block index's mixed-radix digits most
//     significant first (arities are powers of two, so each digit is a
//     field of 1 or 2 bits); with a frontier of one node per key the
//     kernel starts at the root, so no level of the tree is left to plain
//     tensor code;
//   * each key expands breadth-first in shared memory while its width
//     stays <= its thread count (a product of the arities, so not always
//     a power of 4), then each thread expands its node depth-first in
//     registers and local memory (a stack of right siblings per level),
//     as the upstream dpf_hybrid.cu does, and writes the low 32 bits of
//     its leaves to its key's row of the tile's leaves: leaf q of thread
//     t lands at t (CB/W) + q, the digit-reversed (BFS) order the table
//     was permuted into.  Side by side, a tile of 4 keys over CB leaves
//     keeps as many threads busy as one key over 4 CB leaves, in
//     the shared memory that those leaves take;
//   * each thread owns one table column and every lanes-th quad of rows:
//     it loads each table value once, multiplies it into all 4 keys'
//     sums held in registers (the leaves read as 16-byte quads),
//     then the block reduces each (key, column) in shared memory and adds
//     it atomically into the zeroed [B, E] output.  int32 addition wraps
//     mod 2^32 and is associative, so the order of the atomics changes no
//     bit.
//
// Bound on the H100: operations.  A parent of arity a costs a 12-round
// core blocks (one for the block-PRG ids, whose block feeds all four
// children), ~600 32-bit operations each, plus one multiply-add per leaf
// and column, against a few bytes of input per key and the N x E x 4
// bytes of the table.  Each table value a block loads serves its
// 4 keys, so the table's L2 -> SM traffic per batch is B / 4 x N x E x 4
// bytes: 8 GiB at B = 512, N = 2^20, E = 16, against 32 GiB with one key
// per block.
//
// The per-key-table mode (subtree_pkt_kernel) serves batch-PIR, where key
// b of the batch has its own table rows at table + b N E (tables
// [B, N, E], each permuted like the shared one; no JAX counterpart of its
// own: the JAX package's per-key paths, core/expand.py:448 and
// core/radix4.py:628, run the same expansion and contract with a batched
// XLA dot_general).  No table value serves more than one key, so a key
// tile buys nothing and would divide the grid by 4:
//
//   * one block per (key, block subtree), all 256 threads on the one key,
//     the blocks of a key adjacent.  Block subtrees are small enough
//     (ops/subtree.py::pkt_block_leaves) that a batch-PIR group's grid
//     holds several blocks on every SM; each costs one serial PRF call a
//     level on the walk from the frontier to its root, by one thread;
//   * the expansion is the shared kernel's for one key of 256 threads
//     (breadth-first to W = 128 or 256 nodes, then depth-first), with a
//     depth-first stack sized for that width;
//   * the contraction streams the key's CB rows once, 16-byte loads on
//     neighbouring addresses, and adds one atomic per column
//     (pkt_contract.cuh).  At most 16 KB of leaves and 8 KB of scratch:
//     no opt-in beyond 48 KB of shared memory.
//
// The cipher cores and their layouts are in stream_cipher.cuh, shared
// with K4 and K5.

#include "dpf_common.cuh"
#include "pkt_contract.cuh"
#include "stream_cipher.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLogBlockLeaves = 12;                 // CB <= 4096
constexpr int kMaxLevels = 32;                         // N <= 2^32
constexpr int kMaxSlots = 64;                          // codewords per key
constexpr int kLogThreads = 8;
constexpr int kTileKeys = 4;                           // keys per block
// a key's threads: 64, or all 256 when the batch has one key
constexpr int kLogMinKeyThreads = kLogThreads - 2;
static_assert(kThreads == 1 << kLogThreads &&
              kThreads == kTileKeys << kLogMinKeyThreads, "tile layout");
// Dynamic shared memory past the leaves: two buffers of kThreads
// breadth-first nodes during the expansion, the [kTileKeys, kThreads]
// lane sums of the reduction after it.
constexpr int kScratchWords = 2 * kThreads * 4;
static_assert(kTileKeys * kThreads <= kScratchWords, "lane sums");
// A block's shared memory is at most 227 KB.
constexpr int kMaxDynSmemBytes = 232448;
// Depth-first levels below a key's breadth-first width W: W stops
// growing only once W * arity exceeds the key's threads (>= 64), so
// W >= 32, CB / W <= 2^(12 + 1 - 6) leaves and a level takes at least one
// bit of that; an all-binary block reaches W >= 64.
constexpr int kMaxDfs = kMaxLogBlockLeaves + 1 - kLogMinKeyThreads;
constexpr int kMaxDfsBinary = kMaxLogBlockLeaves - kLogMinKeyThreads;
// the same for the per-key kernel, whose key has all kThreads threads
constexpr int kPktMaxDfs = kMaxLogBlockLeaves + 1 - kLogThreads;
constexpr int kPktMaxDfsBinary = kMaxLogBlockLeaves - kLogThreads;

// The arity schedule of one launch, built on the host, passed by value.
// Eval level j (0 = the root's) has arity 1 << lg[j] and reads codeword
// slots off[j] .. off[j] + arity - 1.
struct Sched {
  int levels;   // eval levels of the tree
  int f_lv;     // level of the frontier nodes
  int s_lv;     // level of the block subtrees' roots
  int bfs_end;  // first level expanded depth-first
  int log_s;    // log2 block subtrees per frontier node
  int log_c;    // log2 leaves per frontier node
  int log_cb;   // log2 leaves per block subtree (CB)
  int log_w;    // log2 breadth-first width (W)
  int log_kt;   // log2 threads per key
  int lg[kMaxLevels];
  int off[kMaxLevels];
};

// PRF(seed, br) for one branch br in {0, 1, 2, 3}, as little-endian limbs.
template <int PRF>
__device__ __forceinline__ void prf_child(const uint32_t s[4], uint32_t br,
                                          uint32_t v[4]) {
  uint32_t o[16];
  if (PRF == 4 || PRF == 5) {
    dpf::core_block<PRF>(s, 0u, o);
#pragma unroll
    for (uint32_t g = 0; g < 4; ++g) {
      if (g == br) {
        v[0] = o[4 * g + 3];
        v[1] = o[4 * g + 2];
        v[2] = o[4 * g + 1];
        v[3] = o[4 * g];
      }
    }
  } else if (PRF == 2) {
    dpf::chacha_block(s, br, o);
    v[0] = o[7]; v[1] = o[6]; v[2] = o[5]; v[3] = o[4];
  } else {
    dpf::salsa_block(s, br, o);
    v[0] = o[4]; v[1] = o[3]; v[2] = o[2]; v[3] = o[1];
  }
}

// The a children of node s at the level whose codewords start at slot
// off: kid[b] = PRF(s, b) + cw[lsb(s)][off + b] for b < a <= A.  The
// block-PRG ids take all children from one core block, the others one
// block each (both unrolled when A = 2, so kid stays in registers).
template <int PRF, int A>
__device__ __forceinline__ void expand_node(const uint32_t s[4], int a,
                                            int off, const uint32_t* cw1s,
                                            const uint32_t* cw2s,
                                            uint32_t kid[A][4]) {
  const uint32_t* cw = ((s[0] & 1u) ? cw2s : cw1s) + 4 * off;
  if constexpr (PRF == 4 || PRF == 5) {
    uint32_t o[16];
    dpf::core_block<PRF>(s, 0u, o);
#pragma unroll
    for (int b = 0; b < A; ++b) {
      const uint32_t v[4] = {o[4 * b + 3], o[4 * b + 2], o[4 * b + 1],
                             o[4 * b]};
      if (b < a) dpf::add128(kid[b], v, cw + 4 * b);
    }
  } else if constexpr (A == 2) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      uint32_t v[4];
      prf_child<PRF>(s, (uint32_t)b, v);
      dpf::add128(kid[b], v, cw + 4 * b);
    }
  } else {
#pragma unroll 1
    for (int b = 0; b < a; ++b) {
      uint32_t v[4];
      prf_child<PRF>(s, (uint32_t)b, v);
      dpf::add128(kid[b], v, cw + 4 * b);
    }
  }
}

// BIN: every level below the block subtrees' roots is binary (the whole
// binary tree, and radix-4 trees of one binary level above the block), so
// arities are the constant 2 there and the depth-first stack holds one
// sibling per level.  Otherwise the children loops keep a run-time trip
// count: unrolled with a guard they hold kid in registers, 48 instead of
// 32 for the block-PRG ids, and fewer blocks fit on an SM.
template <int PRF, bool BIN>
__global__ void __launch_bounds__(kThreads)
    subtree_kernel(const uint32_t* __restrict__ frontier,
                   const uint32_t* __restrict__ cw1,
                   const uint32_t* __restrict__ cw2,
                   const int32_t* __restrict__ table,
                   uint32_t* __restrict__ out, int batch, int f_cnt,
                   int e_total, const Sched sc, long long s0, int log_n) {
  constexpr int kA = BIN ? 2 : 4;                 // widest arity in the block
  // dynamic: the tile's leaves, quad-major (leaf r of key k at word
  // (r / 4) 4 kTileKeys + 4 k + r % 4, so the kTileKeys keys' leaves of a
  // row quad are adjacent 16-byte vectors), then the scratch words
  extern __shared__ uint4 dpf_smem[];
  const int cb = 1 << sc.log_cb;
  uint32_t* const leaves = reinterpret_cast<uint32_t*>(dpf_smem);
  uint32_t* const scratch = leaves + kTileKeys * (cb < 4 ? 4 : cb);
  auto nodes = reinterpret_cast<uint32_t (*)[kThreads * 4]>(scratch);

  const int tid = threadIdx.x;
  const int kb = tid >> sc.log_kt;               // this thread's key ...
  const int lt = tid & ((1 << sc.log_kt) - 1);   // ... and place in it
  const long long blk = blockIdx.x;
  const int tiles = (batch + kTileKeys - 1) / kTileKeys;
  const int key0 = (int)(blk % tiles) * kTileKeys;
  const int nk = min(kTileKeys, batch - key0);  // keys of this tile
  const bool live = kb < nk;
  const long long key = key0 + (live ? kb : 0);
  const uint32_t* const kc1 = cw1 + key * kMaxSlots * 4;
  const uint32_t* const kc2 = cw2 + key * kMaxSlots * 4;
  // the launch's block subtrees under each frontier node: 2^log_n of
  // them from s0 (a leaf range; the whole node: log_n = log_s, s0 = 0)
  const long long sub = blk / tiles;             // in [0, F << log_n)
  const int f = (int)(sub >> log_n);
  const long long s_idx = s0 + (sub & ((1LL << log_n) - 1));
  // key kb's breadth-first nodes sit at (kb << log_kt) + i
  const int nb = 4 * (kb << sc.log_kt);

  if (cb < 4 && tid < 4 * kTileKeys) leaves[tid] = 0u;

  // walk from the frontier node to this block's subtree root, one thread
  // per key: the digit of level j is the next lg[j] bits of s_idx, most
  // significant first
  if (live && lt == 0) {
    const uint32_t* fr = frontier + (key * f_cnt + f) * 4;
    uint32_t cur[4] = {fr[0], fr[1], fr[2], fr[3]};
    int shift = sc.log_s;
    for (int j = sc.f_lv; j < sc.s_lv; ++j) {
      shift -= sc.lg[j];
      const uint32_t br =
          (uint32_t)(s_idx >> shift) & ((1u << sc.lg[j]) - 1u);
      uint32_t v[4];
      prf_child<PRF>(cur, br, v);
      const uint32_t* cw = (cur[0] & 1u) ? kc2 : kc1;
      dpf::add128(cur, v, cw + 4 * (sc.off[j] + (int)br));
    }
#pragma unroll
    for (int l = 0; l < 4; ++l) nodes[0][nb + l] = cur[l];
  }
  __syncthreads();

  // every key breadth-first in shared memory, side by side, down to W
  // nodes, at most its threads; child b of node t lands at a t + b
  int buf = 0;
  int w = 1;
  for (int j = sc.s_lv; j < sc.bfs_end; ++j) {
    const int a = BIN ? 2 : 1 << sc.lg[j];
    if (live && lt < w) {
      const uint32_t* src = nodes[buf] + nb + 4 * lt;
      const uint32_t s[4] = {src[0], src[1], src[2], src[3]};
      uint32_t kid[kA][4];
      expand_node<PRF, kA>(s, a, sc.off[j], kc1, kc2, kid);
      uint32_t* dst = nodes[buf ^ 1] + nb + 4 * a * lt;
      for (int b = 0; b < a; ++b) {
#pragma unroll
        for (int l = 0; l < 4; ++l) dst[4 * b + l] = kid[b][l];
      }
    }
    w *= a;
    buf ^= 1;
    __syncthreads();
  }

  // depth-first per thread over the m levels left: leaf q of node lt
  // lands at lt * per + q of row kb, q's digits (last level least
  // significant) naming the branch taken at each level
  const int m = sc.levels - sc.bfs_end;
  const int per = 1 << (sc.log_cb - sc.log_w);
  if (live && lt < w) {
    const uint32_t* src = nodes[buf] + nb + 4 * lt;
    uint32_t node[4] = {src[0], src[1], src[2], src[3]};
    uint32_t sib[BIN ? kMaxDfsBinary : kMaxDfs][kA - 1][4];
    int d_start = 0;
    for (int q = 0; q < per; ++q) {
      if (q > 0) {
        // the deepest level whose digit is not 0 turns right: resume from
        // its stored sibling
        int d0, dig;
        if constexpr (BIN) {
          d0 = m - __ffs(q);
          dig = 1;
        } else {
          d0 = m - 1;
          int rest = q;
          dig = rest & ((1 << sc.lg[sc.bfs_end + d0]) - 1);
          while (dig == 0) {
            rest >>= sc.lg[sc.bfs_end + d0];
            --d0;
            dig = rest & ((1 << sc.lg[sc.bfs_end + d0]) - 1);
          }
        }
#pragma unroll
        for (int l = 0; l < 4; ++l) node[l] = sib[d0][dig - 1][l];
        d_start = d0 + 1;
      }
      for (int d = d_start; d < m; ++d) {
        const int j = sc.bfs_end + d;
        const int a = BIN ? 2 : 1 << sc.lg[j];
        uint32_t kid[kA][4];
        expand_node<PRF, kA>(node, a, sc.off[j], kc1, kc2, kid);
        for (int b = 1; b < a; ++b) {
#pragma unroll
          for (int l = 0; l < 4; ++l) sib[d][b - 1][l] = kid[b][l];
        }
#pragma unroll
        for (int l = 0; l < 4; ++l) node[l] = kid[0][l];
      }
      const int r = lt * per + q;
      leaves[(r >> 2) * 4 * kTileKeys + 4 * kb + (r & 3)] = node[0];
    }
  }
  __syncthreads();

  // contract the tile's leaves with table rows row0 .. row0 + CB - 1
  // (the launch's table holds its block subtrees' rows in order):
  // thread tid takes column e0 + tid % ew and the row quads tid / ew,
  // tid / ew + lanes, ...  Keys past the batch's end multiply whatever
  // their leaves hold and are not added.  The lane sums go to the nodes'
  // buffer, free since the barrier above
  const long long row0 = sub << sc.log_cb;
  const long long ld = e_total;
  uint32_t* const red = scratch;
  for (int e0 = 0; e0 < e_total; e0 += kThreads) {
    int ew = 1;  // lanes per table row: a power of two covering the columns
    while (ew < e_total - e0 && ew < kThreads) ew <<= 1;
    const int e = e0 + tid % ew;
    const int lanes = kThreads / ew;
    uint32_t acc[kTileKeys];
#pragma unroll
    for (int k = 0; k < kTileKeys; ++k) acc[k] = 0u;
    if (e < e_total) {
      // rows past CB (CB < 4) read row CB - 1 against zeroed leaves
      const long long o1 = cb > 1 ? ld : 0, o2 = cb > 2 ? 2 * ld : o1,
                      o3 = cb > 2 ? 3 * ld : o1;
      const int q0 = tid / ew;
      const int32_t* row = table + (row0 + 4 * q0) * ld + e;
      for (int qd = q0; 4 * qd < cb; qd += lanes, row += 4 * lanes * ld) {
        const uint32_t t0 = row[0], t1 = row[o1], t2 = row[o2], t3 = row[o3];
        const uint4* lq =
            reinterpret_cast<const uint4*>(leaves) + qd * kTileKeys;
#pragma unroll
        for (int k = 0; k < kTileKeys; ++k) {
          const uint4 l = lq[k];
          acc[k] += l.x * t0;
          acc[k] += l.y * t1;
          acc[k] += l.z * t2;
          acc[k] += l.w * t3;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kTileKeys; ++k) red[k * kThreads + tid] = acc[k];
    __syncthreads();
    for (int i = tid; i < nk * ew; i += kThreads) {
      const int k = i / ew;
      const int c = i % ew;
      if (e0 + c < e_total) {
        uint32_t sum = 0;
        for (int l = 0; l < lanes; ++l) sum += red[k * kThreads + l * ew + c];
        atomicAdd(&out[(long long)(key0 + k) * e_total + e0 + c], sum);
      }
    }
    __syncthreads();
  }
}

// The per-key-table mode (see above): block blockIdx.x expands block
// subtree blockIdx.x % (F << log_s) of key blockIdx.x / (F << log_s) with
// all kThreads threads (log_kt = kLogThreads) and contracts its leaves
// with the key's own rows.  The expansion is subtree_kernel's for one
// live key, copied rather than shared so that the shared-table instances
// keep their code instruction for instruction; vec: pkt_contract's
// vector form.
template <int PRF, bool BIN>
__global__ void __launch_bounds__(kThreads)
    subtree_pkt_kernel(const uint32_t* __restrict__ frontier,
                       const uint32_t* __restrict__ cw1,
                       const uint32_t* __restrict__ cw2,
                       const uint32_t* __restrict__ table,
                       uint32_t* __restrict__ out, int f_cnt, int e_total,
                       bool vec, const Sched sc) {
  constexpr int kA = BIN ? 2 : 4;                 // widest arity in the block
  // dynamic: the key's CB leaves, then two buffers of kThreads
  // breadth-first nodes (the contraction's lane sums after the expansion)
  extern __shared__ uint4 dpf_smem[];
  const int cb = 1 << sc.log_cb;
  uint32_t* const leaves = reinterpret_cast<uint32_t*>(dpf_smem);
  uint32_t* const scratch = leaves + cb;
  auto nodes = reinterpret_cast<uint32_t (*)[kThreads * 4]>(scratch);

  const int tid = threadIdx.x;
  const long long per_key = (long long)f_cnt << sc.log_s;  // blocks a key
  const long long key = blockIdx.x / per_key;
  const long long sub = blockIdx.x % per_key;
  const int f = (int)(sub >> sc.log_s);
  const long long s_idx = sub & ((1LL << sc.log_s) - 1);
  const uint32_t* const kc1 = cw1 + key * kMaxSlots * 4;
  const uint32_t* const kc2 = cw2 + key * kMaxSlots * 4;

  // walk from the frontier node to this block's subtree root, the digit
  // of level j the next lg[j] bits of s_idx, most significant first
  if (tid == 0) {
    const uint32_t* fr = frontier + (key * f_cnt + f) * 4;
    uint32_t cur[4] = {fr[0], fr[1], fr[2], fr[3]};
    int shift = sc.log_s;
    for (int j = sc.f_lv; j < sc.s_lv; ++j) {
      shift -= sc.lg[j];
      const uint32_t br =
          (uint32_t)(s_idx >> shift) & ((1u << sc.lg[j]) - 1u);
      uint32_t v[4];
      prf_child<PRF>(cur, br, v);
      const uint32_t* cw = (cur[0] & 1u) ? kc2 : kc1;
      dpf::add128(cur, v, cw + 4 * (sc.off[j] + (int)br));
    }
#pragma unroll
    for (int l = 0; l < 4; ++l) nodes[0][l] = cur[l];
  }
  __syncthreads();

  // breadth-first in shared memory down to W <= kThreads nodes; child b
  // of node t lands at a t + b
  int buf = 0;
  int w = 1;
  for (int j = sc.s_lv; j < sc.bfs_end; ++j) {
    const int a = BIN ? 2 : 1 << sc.lg[j];
    if (tid < w) {
      const uint32_t* src = nodes[buf] + 4 * tid;
      const uint32_t s[4] = {src[0], src[1], src[2], src[3]};
      uint32_t kid[kA][4];
      expand_node<PRF, kA>(s, a, sc.off[j], kc1, kc2, kid);
      uint32_t* dst = nodes[buf ^ 1] + 4 * a * tid;
      for (int b = 0; b < a; ++b) {
#pragma unroll
        for (int l = 0; l < 4; ++l) dst[4 * b + l] = kid[b][l];
      }
    }
    w *= a;
    buf ^= 1;
    __syncthreads();
  }

  // depth-first per thread over the m levels left: leaf q of node tid
  // lands at tid * per + q, q's digits (last level least significant)
  // naming the branch taken at each level
  const int m = sc.levels - sc.bfs_end;
  const int per = 1 << (sc.log_cb - sc.log_w);
  if (tid < w) {
    const uint32_t* src = nodes[buf] + 4 * tid;
    uint32_t node[4] = {src[0], src[1], src[2], src[3]};
    uint32_t sib[BIN ? kPktMaxDfsBinary : kPktMaxDfs][kA - 1][4];
    int d_start = 0;
    for (int q = 0; q < per; ++q) {
      if (q > 0) {
        // the deepest level whose digit is not 0 turns right: resume from
        // its stored sibling
        int d0, dig;
        if constexpr (BIN) {
          d0 = m - __ffs(q);
          dig = 1;
        } else {
          d0 = m - 1;
          int rest = q;
          dig = rest & ((1 << sc.lg[sc.bfs_end + d0]) - 1);
          while (dig == 0) {
            rest >>= sc.lg[sc.bfs_end + d0];
            --d0;
            dig = rest & ((1 << sc.lg[sc.bfs_end + d0]) - 1);
          }
        }
#pragma unroll
        for (int l = 0; l < 4; ++l) node[l] = sib[d0][dig - 1][l];
        d_start = d0 + 1;
      }
      for (int d = d_start; d < m; ++d) {
        const int j = sc.bfs_end + d;
        const int a = BIN ? 2 : 1 << sc.lg[j];
        uint32_t kid[kA][4];
        expand_node<PRF, kA>(node, a, sc.off[j], kc1, kc2, kid);
        for (int b = 1; b < a; ++b) {
#pragma unroll
          for (int l = 0; l < 4; ++l) sib[d][b - 1][l] = kid[b][l];
        }
#pragma unroll
        for (int l = 0; l < 4; ++l) node[l] = kid[0][l];
      }
      leaves[tid * per + q] = node[0];
    }
  }
  __syncthreads();

  // the key's rows row0 .. row0 + CB - 1, in the leaves' order; the lane
  // sums go to the nodes' buffer, free since the barrier above
  const long long row0 =
      ((long long)f << sc.log_c) + (s_idx << sc.log_cb);
  const long long n = (long long)f_cnt << sc.log_c;
  dpf::pkt_contract<kThreads>(leaves, 1, cb, 0, 0,
                              table + (key * n + row0) * e_total, e_total,
                              vec, scratch, out + key * e_total);
}

// Check a schedule and fill its split: the block subtrees are the last
// log_cb bits of the levels, the breadth-first phase takes levels while
// the width stays <= 2^log_kt, a key's threads.  Sets bin if every
// level below the block root is binary.  Returns false if an arity or
// slot is out of range, the frontier does not match f_lv, the schedule
// does not split at log_cb or it needs more depth-first levels than the
// kernel holds.
bool split_schedule(Sched& sc, int f_cnt, int f_lv, int log_cb, int log_kt,
                    bool& bin) {
  if (sc.levels < 1 || sc.levels > kMaxLevels || f_lv < 0 ||
      f_lv > sc.levels || log_cb < 0 || log_cb > kMaxLogBlockLeaves ||
      log_kt < kLogMinKeyThreads || log_kt > kLogThreads)
    return false;
  int f_bits = 0;
  for (int j = 0; j < sc.levels; ++j) {
    if (sc.lg[j] < 1 || sc.lg[j] > 2 || sc.off[j] < 0 ||
        sc.off[j] + (1 << sc.lg[j]) > kMaxSlots)
      return false;
    if (j < f_lv) f_bits += sc.lg[j];
  }
  if (f_bits > 30 || f_cnt != 1 << f_bits) return false;
  sc.f_lv = f_lv;
  sc.log_cb = log_cb;
  int j = sc.levels, bits = 0;
  while (j > f_lv && bits < log_cb) bits += sc.lg[--j];
  if (bits != log_cb) return false;
  sc.s_lv = j;
  sc.log_s = 0;
  for (j = f_lv; j < sc.s_lv; ++j) sc.log_s += sc.lg[j];
  sc.log_c = sc.log_s + log_cb;
  sc.log_kt = log_kt;
  sc.log_w = 0;
  for (j = sc.s_lv; j < sc.levels && sc.log_w + sc.lg[j] <= log_kt; ++j)
    sc.log_w += sc.lg[j];
  sc.bfs_end = j;
  bin = true;
  for (j = sc.s_lv; j < sc.levels; ++j) bin = bin && sc.lg[j] == 1;
  // the kernels' depth-first stacks: kMaxDfs(Binary) at 64 threads a
  // key, kPktMaxDfs(Binary) at 256
  return sc.levels - sc.bfs_end <=
         kMaxLogBlockLeaves - log_kt + (bin ? 0 : 1);
}

// Shared memory above 48 KB must be allowed per kernel, once per process.
template <int P, bool BIN>
cudaError_t launch_kernel(dim3 grid, size_t smem, cudaStream_t st,
                          const void* frontier, const void* cw1,
                          const void* cw2, const void* table, void* out,
                          int batch, int f_cnt, int e_total, const Sched& sc,
                          long long s0, int log_n) {
  static const cudaError_t err = cudaFuncSetAttribute(
      subtree_kernel<P, BIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxDynSmemBytes);
  if (err != cudaSuccess) return err;
  subtree_kernel<P, BIN><<<grid, kThreads, smem, st>>>(
      (const uint32_t*)frontier, (const uint32_t*)cw1, (const uint32_t*)cw2,
      (const int32_t*)table, (uint32_t*)out, batch, f_cnt, e_total, sc, s0,
      log_n);
  return cudaGetLastError();
}

template <int P, bool BIN>
cudaError_t launch_pkt(dim3 grid, size_t smem, cudaStream_t st,
                       const void* frontier, const void* cw1,
                       const void* cw2, const void* table, void* out,
                       int f_cnt, int e_total, bool vec, const Sched& sc) {
  subtree_pkt_kernel<P, BIN><<<grid, kThreads, smem, st>>>(
      (const uint32_t*)frontier, (const uint32_t*)cw1, (const uint32_t*)cw2,
      (const uint32_t*)table, (uint32_t*)out, f_cnt, e_total, vec, sc);
  return cudaGetLastError();
}

}  // namespace

// One tree of `levels` eval levels: level j (0 = the root's) has arity
// 1 << lg[j] (2 or 4) and reads codeword slots off[j] .. off[j] + arity - 1
// of cw1/cw2 [B, 64, 4] (the binary tree's wire layout: off[j] =
// 2 (levels-1-j); a radix-4 tree's: cw_offsets(ars)[j]).  frontier
// [B, F, 4] holds the nodes at level f_lv (F = the product of the first
// f_lv arities), table [N, E] rows in digit-reversed order, out [B, E]
// zeroed by the caller, block subtrees of 2^log_cb leaves (a product of
// trailing arities).  per_key: table is [B, N, E], one permuted table a
// key, served by the per-key kernel.  log_n < 0: every block subtree of
// each frontier node; else the shared-table kernel launches 2^log_n of
// them from block s0 (subtree_contract_window_launch), table holding
// their rows.  Returns the launch's cudaError_t.
static int subtree_launch(
    const void* frontier, const void* cw1, const void* cw2, const void* table,
    void* out, int batch, int f_cnt, int levels, const int* lg,
    const int* off, int f_lv, int log_cb, int e_total, int prf, int per_key,
    long long s0, int log_n, void* stream) {
  Sched sc{};
  if (levels < 1 || levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  sc.levels = levels;
  for (int j = 0; j < levels; ++j) {
    sc.lg[j] = lg[j];
    sc.off[j] = off[j];
  }
  const int log_kt =
      per_key || batch == 1 ? kLogThreads : kLogMinKeyThreads;
  bool bin = false;
  if (batch <= 0 || e_total <= 0 ||
      !split_schedule(sc, f_cnt, f_lv, log_cb, log_kt, bin) || sc.log_s > 30)
    return (int)cudaErrorInvalidValue;
  if (per_key && (log_n >= 0 || s0 != 0)) return (int)cudaErrorInvalidValue;
  if (log_n < 0) log_n = sc.log_s;
  if (log_n > sc.log_s || s0 < 0 || s0 + (1LL << log_n) > (1LL << sc.log_s))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (per_key) {
    const long long blocks = ((long long)batch * f_cnt) << sc.log_s;
    const size_t smem = 4 * ((size_t)1 << log_cb) + 4 * kScratchWords;
    const int q = e_total / 4;
    const bool vec = e_total % 4 == 0 && q <= kThreads && (q & (q - 1)) == 0 &&
                     (reinterpret_cast<uintptr_t>(table) & 15) == 0;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)blocks);
#define DPF_LAUNCH(P)                                                     \
  return (int)(bin ? launch_pkt<P, true>(grid, smem, st, frontier, cw1,   \
                                         cw2, table, out, f_cnt, e_total, \
                                         vec, sc)                         \
                   : launch_pkt<P, false>(grid, smem, st, frontier, cw1,  \
                                          cw2, table, out, f_cnt,         \
                                          e_total, vec, sc))
    switch (prf) {
      case 1: DPF_LAUNCH(1);
      case 2: DPF_LAUNCH(2);
      case 4: DPF_LAUNCH(4);
      case 5: DPF_LAUNCH(5);
      default: return (int)cudaErrorInvalidValue;
    }
#undef DPF_LAUNCH
  }
  const long long tiles = (batch + kTileKeys - 1) / kTileKeys;
  const long long blocks = (tiles * f_cnt) << log_n;
  const size_t smem = 4 * ((size_t)kTileKeys * (log_cb < 2 ? 4 : 1 << log_cb)
                           + kScratchWords);
  if (blocks > 0x7fffffffLL || smem > (size_t)kMaxDynSmemBytes)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
#define DPF_LAUNCH(P)                                                       \
  return (int)(bin ? launch_kernel<P, true>(grid, smem, st, frontier, cw1,  \
                                            cw2, table, out, batch, f_cnt,  \
                                            e_total, sc, s0, log_n)         \
                   : launch_kernel<P, false>(grid, smem, st, frontier, cw1, \
                                             cw2, table, out, batch, f_cnt, \
                                             e_total, sc, s0, log_n))
  switch (prf) {
    case 1: DPF_LAUNCH(1);
    case 2: DPF_LAUNCH(2);
    case 4: DPF_LAUNCH(4);
    case 5: DPF_LAUNCH(5);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DPF_LAUNCH
}

extern "C" int subtree_contract_launch(
    const void* frontier, const void* cw1, const void* cw2, const void* table,
    void* out, int batch, int f_cnt, int levels, const int* lg,
    const int* off, int f_lv, int log_cb, int e_total, int prf, int per_key,
    void* stream) {
  return subtree_launch(frontier, cw1, cw2, table, out, batch, f_cnt, levels,
                        lg, off, f_lv, log_cb, e_total, prf, per_key, 0, -1,
                        stream);
}

// The leaf-range form: the shared-table kernel over 2^log_n consecutive
// block subtrees from block s0 under each frontier node (every block
// walks its path from the node, so the frontier may be the root), table
// holding exactly their rows [F << log_n << log_cb, E].
extern "C" int subtree_contract_window_launch(
    const void* frontier, const void* cw1, const void* cw2, const void* table,
    void* out, int batch, int f_cnt, int levels, const int* lg,
    const int* off, int f_lv, int log_cb, int e_total, int prf, long long s0,
    int log_n, void* stream) {
  if (log_n < 0) return (int)cudaErrorInvalidValue;
  return subtree_launch(frontier, cw1, cw2, table, out, batch, f_cnt, levels,
                        lg, off, f_lv, log_cb, e_total, prf, 0, s0, log_n,
                        stream);
}

extern "C" const char* subtree_contract_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
