// K4 sqrt_grid_contract: the sqrt-N PRF grid of each key fused with the
// contraction against the natural-order table, every PRF id 0-5.
//
// Replaces the TPU kernel dpf_tpu/ops/pallas_sqrt.py::
// sqrt_grid_contract_pallas (body _make_sqrt_kernel), which takes PRF ids
// 1, 2, 4 and 5; for AES-128 (3) and DUMMY (0) the JAX package runs the
// XLA scan core/sqrtn.py::_eval_contract_batched_jit, which gives the same
// bits, so here they are template instances of the same kernel.  For key b
// and cell x = r K + c of the [R, K] grid:
//
//   leaf32[b, x] = low32(PRF(seed[b, c], row0 + r)) + (lsb(seed[b, c]) ?
//                  cw2 : cw1)[b, r].limb0                        mod 2^32
//   out[b, e]    = sum_x leaf32[b, x] * table[x, e]                mod 2^32
//
// Only the low limb is contracted and 128-bit adds carry upward only, so
// the codeword add needs the low limb alone; the ciphers still run whole.
// Cell x meets table row x directly (natural order, no permutation).
//
// The TPU kernel walks a grid (key tile of 32, row tile) in order and
// carries the [TB, E] sum across the sequential row axis.  Blocks on the
// card run in no order, so here:
//
//   * one block per (tile of kKeys = 8 keys, row chunk of rc rows); rc is
//     the TPU kernel's row tile (ops/sqrt_grid.sqrt_row_chunk: R halved
//     down to 2048 cells, at least 4 rows).  Key tiles vary fastest, so
//     the blocks that run together read the same table rows from L2;
//   * the block walks its row chunk in sub-tiles of at most 1024 cells:
//     ct = min(K, 256) columns by 4 (256 / ct) rows, each thread one
//     column and one quad of 4 consecutive rows.  A quad is one core block
//     for the block-PRG ids (4, 5: row 4q + g takes block words
//     [4g..4g+3] most significant first, so its low limb is word 4g + 3),
//     one key schedule shared by 4 encryptions for AES (the seed is the
//     key and the row the plaintext: the reverse of K1, where one seed's
//     schedule serves the A children), and 4 core blocks for Salsa and
//     ChaCha.  Rows past the chunk or past R are masked, so any R works;
//     a quad starts at a multiple of 4 whenever row0 does;
//   * the block writes the 8 keys' leaves of a sub-tile to shared memory,
//     then each thread multiplies them by table rows for one column e,
//     reading each table value once for all 8 keys (E = 16: 16 lanes of
//     rows), and keeps 8 sums in registers across the sub-tiles;
//   * at the end the block reduces the lanes in shared memory (in the
//     leaves' buffer, free by then) and atomically adds [8, E] into the
//     zeroed [B, E] output.  int32 addition wraps mod 2^32 and is
//     associative, so the order of the atomics changes no bit;
//   * shared memory is dynamic and sized per instance: the 32 KB of
//     leaves for every id, and for AES (id 3) the 64 KB table of
//     aes_ttable.cuh before them (one copy per bank, so the four
//     encryptions of a quad never replay a lookup).  96 KB fit two blocks
//     on an SM.  Half the copies would fit three, but lanes l and l + 16
//     would share a bank and nearly every lookup would take two
//     wavefronts: twice the lookup floor for 1.5 times the warps.
//
// The per-key-table mode (sqrt_grid_pkt_kernel) serves batch-PIR, where
// key b has its own natural-order table at table + b N E (tables
// [B, N, E]; the JAX package's counterpart is the scan core/sqrtn.py:612,
// whose contraction is a batched XLA dot_general).  No table value serves
// more than one key, so a tile of keys buys nothing:
//
//   * one key an item, an item a chunk of rc rows (ops/sqrt_grid.py::
//     pkt_row_chunk: the fewest rows that fill a sub-tile, so the most
//     items), each thread one column and one quad of rows of a sub-tile
//     as above; no loop over keys inside a thread;
//   * the grid is persistent: as many blocks as the SMs hold
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor), each walking items
//     blockIdx.x, blockIdx.x + gridDim.x, ...  So the AES instance fills
//     its 64 KB table once a block, not once an item;
//   * each sub-tile's leaves meet the key's own rows, streamed once in
//     16-byte loads on neighbouring addresses, one atomic per column
//     (pkt_contract.cuh).  Shared memory: the AES table (id 3), the 4 KB
//     of a sub-tile's leaves and 4 KB of lane sums.
//
// Bound on the H100: operations.  A cell costs ~592 32-bit operations of
// one ChaCha/Salsa block (a quarter of that for ids 4 and 5) or ~520 of
// an AES block and a quarter key schedule, plus ~35 of select, add and
// contraction at E = 16, against 64 table bytes read from L2.  The AES
// instance also makes 170 table lookups a cell, one shared-memory
// wavefront per warp each.  Serving 8 keys per table read cuts the table
// traffic from B x 64 MiB (32 GiB) to 4 GiB per batch.

#include "aes_ttable.cuh"
#include "dpf_common.cuh"
#include "pkt_contract.cuh"
#include "stream_cipher.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKeys = 8;                       // keys per block
constexpr int kTileCells = 4 * kThreads;       // cells per sub-tile

// Dynamic shared memory of an instance: the AES table, then the leaves.
template <int PRF>
constexpr int kTableWords = PRF == 3 ? dpf::kAesTableWords : 0;
template <int PRF>
constexpr int kSmemBytes = 4 * (kTableWords<PRF> + kKeys * kTileCells);
// the per-key kernel's: the AES table, one key's leaves, the lane sums
template <int PRF>
constexpr int kPktSmemBytes = 4 * (kTableWords<PRF> + 2 * kTileCells);

// Low limbs of PRF(s, pos0 + g) for g = 0..3 (ids 0, 3, 4, 5; ids 1 and 2
// take one core block per row in the kernel).  pos0 is a multiple of 4 for
// the block-PRG ids.
template <int PRF>
__device__ __forceinline__ void quad_low_limbs(const uint32_t s[4],
                                               uint32_t pos0,
                                               const dpf::AesTable& tab,
                                               uint32_t v[4]) {
  if constexpr (PRF == 4 || PRF == 5) {
    uint32_t o[16];
    dpf::core_block<PRF>(s, pos0 >> 2, o);
#pragma unroll
    for (int g = 0; g < 4; ++g) v[g] = o[4 * g + 3];
  } else if constexpr (PRF == 3) {
    uint32_t st[4][4];  // plaintext pos0 + g
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      st[g][0] = pos0 + (uint32_t)g;
      st[g][1] = st[g][2] = st[g][3] = 0u;
    }
    dpf::aes128_encrypt<4>(tab, s, st);
#pragma unroll
    for (int g = 0; g < 4; ++g) v[g] = st[g][0];
  } else {
    // DUMMY: seed * t + t mod 2^128 with t = pos + 4242, low limb only
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const uint32_t t = pos0 + (uint32_t)g + 4242u;
      v[g] = s[0] * t + t;
    }
  }
}

template <int PRF>
__global__ void __launch_bounds__(kThreads)
    sqrt_grid_kernel(const uint32_t* __restrict__ seeds, long long ld_seed,
                     const uint32_t* __restrict__ cw1,
                     const uint32_t* __restrict__ cw2, long long ld_cw,
                     const int32_t* __restrict__ table,
                     uint32_t* __restrict__ out, int batch, int k, int r,
                     int rc, int e_total, uint32_t row0) {
  extern __shared__ uint4 dpf_smem[];
  uint32_t* const T = reinterpret_cast<uint32_t*>(dpf_smem);
  auto leaves = reinterpret_cast<uint32_t (*)[kTileCells]>(
      T + kTableWords<PRF>);
  if constexpr (PRF == 3) dpf::aes_fill_table(T);  // first sub-tile syncs
  const dpf::AesTable tab = dpf::aes_table(T);

  const int tid = threadIdx.x;
  const int key0 = blockIdx.x * kKeys;
  const int r_begin = blockIdx.y * rc;
  const int r_end = min(r, r_begin + rc);
  const int e0 = blockIdx.z * kThreads;
  int ew = 1;  // lanes per table row: a power of two covering the columns
  while (ew < e_total - e0 && ew < kThreads) ew <<= 1;
  const int e = e0 + tid % ew;
  const int lane = tid / ew;
  const int lanes = kThreads / ew;

  const int ct = min(k, kThreads);   // columns per sub-tile
  const int quads = kThreads / ct;   // row quads per sub-tile
  const int rt = 4 * quads;          // rows per sub-tile
  const int cells = rt * ct;
  const int j = tid % ct;            // this thread's column and quad
  const int qd = tid / ct;

  uint32_t acc[kKeys];
#pragma unroll
  for (int kb = 0; kb < kKeys; ++kb) acc[kb] = 0u;

  for (int lr0 = r_begin; lr0 < r_end; lr0 += rt) {
    for (int c0 = 0; c0 < k; c0 += ct) {
      __syncthreads();  // the last sub-tile's leaves are consumed
      // phase 1: the leaves of 8 keys x this sub-tile, rows lr0 + 4 qd + g
      const int row = lr0 + 4 * qd;
      const int col = c0 + j;
      if (qd < quads) {
#pragma unroll 1
        for (int kb = 0; kb < kKeys; ++kb) {
          const int key = key0 + kb;
          uint32_t* dst = &leaves[kb][4 * qd * ct + j];
          if (key >= batch || col >= k || row >= r_end) {
#pragma unroll
            for (int g = 0; g < 4; ++g) dst[g * ct] = 0u;
            continue;
          }
          const uint32_t* sp = seeds + key * ld_seed + 4LL * col;
          const uint32_t s[4] = {sp[0], sp[1], sp[2], sp[3]};
          const uint32_t* cw = ((s[0] & 1u) ? cw2 : cw1) + key * ld_cw;
          const uint32_t pos0 = row0 + (uint32_t)row;
          if constexpr (PRF == 1 || PRF == 2) {
#pragma unroll 1
            for (int g = 0; g < 4; ++g) {
              uint32_t o[16];
              dpf::core_block<PRF>(s, pos0 + (uint32_t)g, o);
              const uint32_t v = PRF == 2 ? o[7] : o[4];
              dst[g * ct] = row + g < r_end ? v + cw[4LL * (row + g)] : 0u;
            }
          } else {
            uint32_t v[4];
            quad_low_limbs<PRF>(s, pos0, tab, v);
#pragma unroll
            for (int g = 0; g < 4; ++g)
              dst[g * ct] = row + g < r_end ? v[g] + cw[4LL * (row + g)] : 0u;
          }
        }
      }
      __syncthreads();
      // phase 2: each table value once for the 8 keys; cell p of the
      // sub-tile is row lr0 + p / ct, column c0 + p % ct
      if (e < e_total) {
        for (int p = lane; p < cells; p += lanes) {
          const int lr = lr0 + p / ct;
          const int cc = c0 + p % ct;
          if (lr < r_end && cc < k) {
            const uint32_t t =
                (uint32_t)table[((long long)lr * k + cc) * e_total + e];
#pragma unroll
            for (int kb = 0; kb < kKeys; ++kb) acc[kb] += leaves[kb][p] * t;
          }
        }
      }
    }
  }

  // reduce the lanes of each (key, column) and add into the output; the
  // sums reuse the leaves' buffer once every thread is done reading it
  auto red = reinterpret_cast<uint32_t (*)[kThreads]>(leaves);
  __syncthreads();
#pragma unroll
  for (int kb = 0; kb < kKeys; ++kb) red[kb][tid] = acc[kb];
  __syncthreads();
  for (int i = tid; i < kKeys * ew; i += kThreads) {
    const int kb = i / ew;
    const int col_e = e0 + i % ew;
    const int key = key0 + kb;
    if (key < batch && col_e < e_total) {
      uint32_t sum = 0u;
      for (int l = 0; l < lanes; ++l) sum += red[kb][l * ew + i % ew];
      atomicAdd(&out[(long long)key * e_total + col_e], sum);
    }
  }
}

// The per-key-table mode (see above): item it = (key it / chunks, row
// chunk it % chunks) of batch x chunks, rows row0 + chunk rc ..; phase 1
// is sqrt_grid_kernel's for one key, copied so that the shared-table
// instances keep their code; vec: pkt_contract's vector form.
template <int PRF>
__global__ void __launch_bounds__(kThreads)
    sqrt_grid_pkt_kernel(const uint32_t* __restrict__ seeds,
                         long long ld_seed, const uint32_t* __restrict__ cw1,
                         const uint32_t* __restrict__ cw2, long long ld_cw,
                         const uint32_t* __restrict__ table,
                         uint32_t* __restrict__ out, int batch, int k, int r,
                         int rc, int e_total, uint32_t row0, bool vec) {
  extern __shared__ uint4 dpf_smem[];
  uint32_t* const T = reinterpret_cast<uint32_t*>(dpf_smem);
  uint32_t* const leaves = T + kTableWords<PRF>;  // [rt, ct] cells
  uint32_t* const red = leaves + kTileCells;
  if constexpr (PRF == 3) {
    dpf::aes_fill_table(T);
    __syncthreads();
  }
  const dpf::AesTable tab = dpf::aes_table(T);

  const int tid = threadIdx.x;
  const int ct = min(k, kThreads);   // columns per sub-tile
  const int quads = kThreads / ct;   // row quads per sub-tile
  const int rt = 4 * quads;          // rows per sub-tile
  const int j = tid % ct;            // this thread's column and quad
  const int qd = tid / ct;
  const int chunks = (r + rc - 1) / rc;
  const long long items = (long long)batch * chunks;

  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const long long key = it / chunks;
    const int r_begin = (int)(it % chunks) * rc;
    const int r_end = min(r, r_begin + rc);
    const uint32_t* const ks = seeds + key * ld_seed;
    const uint32_t* const kc1 = cw1 + key * ld_cw;
    const uint32_t* const kc2 = cw2 + key * ld_cw;
    const uint32_t* const tk = table + key * r * (long long)k * e_total;
    uint32_t* const ok = out + key * e_total;
    for (int lr0 = r_begin; lr0 < r_end; lr0 += rt) {
      const int nr = min(rt, r_end - lr0);  // rows of this sub-tile
      for (int c0 = 0; c0 < k; c0 += ct) {
        // phase 1: the key's leaves at rows lr0 + 4 qd + g, column c0 + j,
        // cell (4 qd + g) ct + j of the sub-tile
        const int row = lr0 + 4 * qd;
        const int col = c0 + j;
        uint32_t* dst = leaves + 4 * qd * ct + j;
        if (qd < quads) {
          if (col >= k || row >= r_end) {
#pragma unroll
            for (int g = 0; g < 4; ++g) dst[g * ct] = 0u;
          } else {
            const uint32_t* sp = ks + 4LL * col;
            const uint32_t s[4] = {sp[0], sp[1], sp[2], sp[3]};
            const uint32_t* cw = (s[0] & 1u) ? kc2 : kc1;
            const uint32_t pos0 = row0 + (uint32_t)row;
            if constexpr (PRF == 1 || PRF == 2) {
#pragma unroll 1
              for (int g = 0; g < 4; ++g) {
                uint32_t o[16];
                dpf::core_block<PRF>(s, pos0 + (uint32_t)g, o);
                const uint32_t v = PRF == 2 ? o[7] : o[4];
                dst[g * ct] = row + g < r_end ? v + cw[4LL * (row + g)] : 0u;
              }
            } else {
              uint32_t v[4];
              quad_low_limbs<PRF>(s, pos0, tab, v);
#pragma unroll
              for (int g = 0; g < 4; ++g)
                dst[g * ct] =
                    row + g < r_end ? v[g] + cw[4LL * (row + g)] : 0u;
            }
          }
        }
        __syncthreads();
        // phase 2: the sub-tile's nr rows of nc cells against the key's
        // rows; whole grid rows (ct = K) are one contiguous run
        const int nc = min(ct, k - c0);
        if (ct == k)
          dpf::pkt_contract<kThreads>(leaves, 1, nr * k, 0, 0,
                                      tk + (long long)lr0 * k * e_total,
                                      e_total, vec, red, ok);
        else
          dpf::pkt_contract<kThreads>(
              leaves, nr, nc, ct, k, tk + ((long long)lr0 * k + c0) * e_total,
              e_total, vec, red, ok);
      }
    }
  }
}

// Shared memory above 48 KB must be allowed per kernel, once per process.
template <int P>
cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      sqrt_grid_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes<P>);
  return err;
}

template <int P>
cudaError_t launch_kernel(dim3 grid, cudaStream_t st, const void* seeds,
                          long long ld_seed, const void* cw1, const void* cw2,
                          long long ld_cw, const void* table, void* out,
                          int batch, int k, int r, int rc, int e_total,
                          uint32_t row0) {
  const cudaError_t err = allow_smem<P>();
  if (err != cudaSuccess) return err;
  sqrt_grid_kernel<P><<<grid, kThreads, kSmemBytes<P>, st>>>(
      (const uint32_t*)seeds, ld_seed, (const uint32_t*)cw1,
      (const uint32_t*)cw2, ld_cw, (const int32_t*)table, (uint32_t*)out,
      batch, k, r, rc, e_total, row0);
  return cudaGetLastError();
}

// Blocks of one per-key instance an SM holds, read once per process after
// its shared memory is allowed.
template <int P>
struct PktOccupancy {
  int per_sm = 1;
  cudaError_t err;
  PktOccupancy() {
    err = cudaFuncSetAttribute(sqrt_grid_pkt_kernel<P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kPktSmemBytes<P>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sqrt_grid_pkt_kernel<P>, kThreads, kPktSmemBytes<P>);
  }
};

// The persistent grid: the items, at most the blocks the card holds.
template <int P>
cudaError_t launch_pkt(cudaStream_t st, const void* seeds, long long ld_seed,
                       const void* cw1, const void* cw2, long long ld_cw,
                       const void* table, void* out, int batch, int k, int r,
                       int rc, int e_total, uint32_t row0, bool vec) {
  static const PktOccupancy<P> occ;  // initialised once, thread-safely
  if (occ.err != cudaSuccess) return occ.err;
  int dev = 0, sms = 1;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long items = (long long)batch * ((r + rc - 1) / rc);
  const long long slots =
      (long long)(occ.per_sm > 1 ? occ.per_sm : 1) * (sms > 1 ? sms : 1);
  const dim3 grid((unsigned)(items < slots ? items : slots));
  sqrt_grid_pkt_kernel<P><<<grid, kThreads, kPktSmemBytes<P>, st>>>(
      (const uint32_t*)seeds, ld_seed, (const uint32_t*)cw1,
      (const uint32_t*)cw2, ld_cw, (const uint32_t*)table, (uint32_t*)out,
      batch, k, r, rc, e_total, row0, vec);
  return cudaGetLastError();
}

}  // namespace

// seeds [B, K, 4] with key stride ld_seed, cw1/cw2 [B, R, 4] with key
// stride ld_cw (in 32-bit words; row and limb axes contiguous), table
// [R K, E] contiguous, out [B, E] zeroed by the caller; rows are
// row0 .. row0 + R - 1, grid steps of rc rows (rc < R: a multiple of 4
// for the block-PRG ids, whose row0 must be a multiple of 4 too).
// per_key: table is [B, R K, E], one natural-order table a key, served by
// the per-key kernel in items of rc rows.  Returns the launch's
// cudaError_t.
extern "C" int sqrt_grid_launch(const void* seeds, long long ld_seed,
                                const void* cw1, const void* cw2,
                                long long ld_cw, const void* table, void* out,
                                int batch, int k, int r, int rc, int e_total,
                                long long row0, int prf, int per_key,
                                void* stream) {
  const bool blk = prf == 4 || prf == 5;
  if (batch <= 0 || k <= 0 || r <= 0 || e_total <= 0 || rc <= 0 ||
      rc > r || row0 < 0 || row0 > 0xffffffffLL ||
      (blk && ((row0 & 3) || (rc < r && rc % 4))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (per_key) {
    const int q = e_total / 4;
    const bool vec = e_total % 4 == 0 && q <= kThreads && (q & (q - 1)) == 0 &&
                     (reinterpret_cast<uintptr_t>(table) & 15) == 0;
#define DPF_LAUNCH(P)                                                     \
  return (int)launch_pkt<P>(st, seeds, ld_seed, cw1, cw2, ld_cw, table,   \
                            out, batch, k, r, rc, e_total, (uint32_t)row0, \
                            vec)
    switch (prf) {
      case 0: DPF_LAUNCH(0);
      case 1: DPF_LAUNCH(1);
      case 2: DPF_LAUNCH(2);
      case 3: DPF_LAUNCH(3);
      case 4: DPF_LAUNCH(4);
      case 5: DPF_LAUNCH(5);
      default: return (int)cudaErrorInvalidValue;
    }
#undef DPF_LAUNCH
  }
  const long long key_tiles = (batch + kKeys - 1) / kKeys;
  const long long row_chunks = (r + (long long)rc - 1) / rc;
  const long long e_chunks = (e_total + kThreads - 1) / kThreads;
  if (key_tiles > 0x7fffffffLL || row_chunks > 65535 || e_chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)key_tiles, (unsigned)row_chunks,
                  (unsigned)e_chunks);
#define DPF_LAUNCH(P)                                                      \
  return (int)launch_kernel<P>(grid, st, seeds, ld_seed, cw1, cw2, ld_cw,  \
                               table, out, batch, k, r, rc, e_total,       \
                               (uint32_t)row0)
  switch (prf) {
    case 0: DPF_LAUNCH(0);
    case 1: DPF_LAUNCH(1);
    case 2: DPF_LAUNCH(2);
    case 3: DPF_LAUNCH(3);
    case 4: DPF_LAUNCH(4);
    case 5: DPF_LAUNCH(5);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DPF_LAUNCH
}

extern "C" const char* sqrt_grid_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
