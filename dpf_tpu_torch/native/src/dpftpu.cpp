// Native DPF runtime: keygen (GGM log-N construction), flat evaluation,
// and full breadth-first expansion.  C ABI for ctypes.
//
// Mirrors the capabilities of the reference's C++ core (dpf_base/dpf.h)
// with this framework's own iterative construction (seed-LSB control bit,
// identical wire format: 524 int32 = depth | cw1[64] | cw2[64] | last | n)
// and a SHAKE-256 DRBG byte-identical to the Python keygen, so both paths
// produce the same keys for the same seed.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "prf.h"
#include "shake256.h"

namespace dpftpu {

constexpr int kKeyWords = 524;

namespace {

struct FlatKey {
  int depth;
  u128 cw1[64];
  u128 cw2[64];
  u128 last_key;
  uint64_t n;
};

void serialize(const FlatKey& k, int32_t* out) {
  u128* slots = reinterpret_cast<u128*>(out);
  std::memset(out, 0, kKeyWords * sizeof(int32_t));
  slots[0] = static_cast<u128>(k.depth);
  std::memcpy(&slots[1], k.cw1, sizeof(k.cw1));
  std::memcpy(&slots[65], k.cw2, sizeof(k.cw2));
  slots[129] = k.last_key;
  slots[130] = static_cast<u128>(k.n);
}

void deserialize(const int32_t* in, FlatKey* k) {
  const u128* slots = reinterpret_cast<const u128*>(in);
  k->depth = static_cast<int>(slots[0]);
  std::memcpy(k->cw1, &slots[1], sizeof(k->cw1));
  std::memcpy(k->cw2, &slots[65], sizeof(k->cw2));
  k->last_key = slots[129];
  k->n = static_cast<uint64_t>(slots[130]);
}

// Iterative GGM construction, base level (alpha bit 0) up to the root.
// Draw order matches dpf_tpu.core.keygen.generate_keys exactly.
int generate(uint64_t alpha, uint64_t n, const uint8_t* seed, size_t seed_len,
             int prf_method, u128 beta, FlatKey* k0, FlatKey* k1) {
  if (n < 2 || (n & (n - 1)) != 0 || alpha >= n) return -1;
  int depth = 0;
  for (uint64_t v = n; v > 1; v >>= 1) depth++;
  if (depth > 32) return -1;

  Shake256Drbg rng(seed, seed_len);
  std::memset(k0, 0, sizeof(FlatKey));
  std::memset(k1, 0, sizeof(FlatKey));
  k0->depth = k1->depth = depth;
  k0->n = k1->n = n;

  // base level
  u128 ka = rng.u128() & ~static_cast<u128>(1);
  u128 kb = rng.u128() | 1;
  k0->last_key = ka;
  k1->last_key = kb;
  u128 beta_l = (depth == 1) ? beta : rng.u128_odd();
  int i = depth - 1;
  int bit0 = static_cast<int>(alpha & 1);
  u128 c1[2] = {rng.u128(), rng.u128()};
  for (int b = 0; b < 2; b++) {
    u128 d = prf(prf_method, ka, b) - prf(prf_method, kb, b);
    if (b == bit0) d -= beta_l;
    k0->cw1[2 * i + b] = k1->cw1[2 * i + b] = c1[b];
    k0->cw2[2 * i + b] = k1->cw2[2 * i + b] = c1[b] + d;
  }
  u128 s1 = prf(prf_method, ka, bit0) + c1[bit0];
  u128 s2 = prf(prf_method, kb, bit0) + k0->cw2[2 * i + bit0];

  // upper levels
  for (int l = 1; l < depth; l++) {
    i = depth - 1 - l;
    beta_l = (l == depth - 1) ? beta : rng.u128_odd();
    int tb = static_cast<int>((alpha >> l) & 1);
    bool s1_even = (s1 & 1) == 0;
    u128 cc[2] = {rng.u128(), rng.u128()};
    for (int b = 0; b < 2; b++) {
      u128 d = prf(prf_method, s2, b) - prf(prf_method, s1, b);
      if (s1_even) d = -d;
      k0->cw2[2 * i + b] = k1->cw2[2 * i + b] = cc[b] + d;
    }
    cc[tb] += s1_even ? beta_l : -beta_l;
    for (int b = 0; b < 2; b++)
      k0->cw1[2 * i + b] = k1->cw1[2 * i + b] = cc[b];
    u128 cw2t = k0->cw2[2 * i + tb];
    u128 n1 = prf(prf_method, s1, tb) + (s1_even ? cc[tb] : cw2t);
    u128 n2 = prf(prf_method, s2, tb) + (s1_even ? cw2t : cc[tb]);
    s1 = n1;
    s2 = n2;
  }
  return 0;
}

u128 eval_point(const FlatKey& k, uint64_t indx, int prf_method) {
  u128 cur = k.last_key;
  uint64_t rem = indx;
  for (int i = k.depth - 1; i >= 0; i--) {
    int b = static_cast<int>(rem & 1);
    u128 val = prf(prf_method, cur, b);
    const u128* cw = ((cur & 1) == 0) ? k.cw1 : k.cw2;
    cur = val + cw[2 * i + b];
    rem >>= 1;
  }
  return cur;
}

// Full breadth-first expansion; out[j] = low 32 bits of the leaf for
// natural index j (bit-reversal applied on store).
int expand_all(const FlatKey& k, int prf_method, int32_t* out) {
  uint64_t n = k.n;
  std::vector<u128> cur(1, k.last_key), next;
  uint64_t width = 1;
  for (int i = k.depth - 1; i >= 0; i--) {
    next.resize(width * 2);
    for (uint64_t j = 0; j < width; j++) {
      u128 s = cur[j];
      const u128* cw = ((s & 1) == 0) ? k.cw1 : k.cw2;
      next[2 * j] = prf(prf_method, s, 0) + cw[2 * i];
      next[2 * j + 1] = prf(prf_method, s, 1) + cw[2 * i + 1];
    }
    cur.swap(next);
    width *= 2;
  }
  // natural[j] = bfs[bit_reverse(j)]; equivalently scatter bfs[p] to
  // natural[bit_reverse(p)]
  int bits = k.depth;
  for (uint64_t p = 0; p < n; p++) {
    uint64_t r = 0;
    for (int b = 0; b < bits; b++) r |= ((p >> b) & 1) << (bits - 1 - b);
    out[r] = static_cast<int32_t>(static_cast<uint32_t>(cur[p]));
  }
  return 0;
}

}  // namespace
}  // namespace dpftpu

extern "C" {

int dpftpu_gen(uint64_t alpha, uint64_t n, const uint8_t* seed,
               uint64_t seed_len, int prf_method, int32_t* key0_out,
               int32_t* key1_out) {
  dpftpu::FlatKey k0, k1;
  int rc = dpftpu::generate(alpha, n, seed, seed_len, prf_method, 1, &k0, &k1);
  if (rc != 0) return rc;
  dpftpu::serialize(k0, key0_out);
  dpftpu::serialize(k1, key1_out);
  return 0;
}

// out must hold n int32 (natural index order, low-32 truncated shares).
int dpftpu_eval_expand(const int32_t* key, int prf_method, int32_t* out) {
  dpftpu::FlatKey k;
  dpftpu::deserialize(key, &k);
  if (k.depth < 1 || k.depth > 32) return -1;
  return dpftpu::expand_all(k, prf_method, out);
}

// out4: little-endian uint32 limbs of the full 128-bit share at indx.
int dpftpu_eval_point(const int32_t* key, uint64_t indx, int prf_method,
                      uint32_t* out4) {
  dpftpu::FlatKey k;
  dpftpu::deserialize(key, &k);
  if (k.depth < 1 || k.depth > 32) return -1;
  dpftpu::u128 v = dpftpu::eval_point(k, indx, prf_method);
  for (int i = 0; i < 4; i++)
    out4[i] = static_cast<uint32_t>(v >> (32 * i));
  return 0;
}

// Batched expansion with fused mod-2^32 contraction against a table:
// keys is batch x 524 int32 (contiguous); table is [n x entry_size] int32
// in natural row order; out is [batch x entry_size] int32.  Runs the batch
// across `n_threads` std::threads — the CPU-baseline analogue of the
// reference's OpenMP harness (paper/kernel/cpu/dpf_google/benchmark.cu),
// used for the CPU-vs-TPU speedup tables.
int dpftpu_eval_contract(const int32_t* keys, uint64_t batch, int prf_method,
                         const int32_t* table, uint64_t entry_size,
                         int n_threads, int32_t* out) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> workers;
  std::atomic<int> rc{0};
  auto work = [&](uint64_t lo, uint64_t hi) {
    for (uint64_t b = lo; b < hi; b++) {
      dpftpu::FlatKey k;
      dpftpu::deserialize(keys + b * dpftpu::kKeyWords, &k);
      if (k.depth < 1 || k.depth > 32) {
        rc.store(-1, std::memory_order_relaxed);
        return;
      }
      std::vector<int32_t> hot(k.n);
      dpftpu::expand_all(k, prf_method, hot.data());
      for (uint64_t e = 0; e < entry_size; e++) {
        uint32_t acc = 0;
        for (uint64_t j = 0; j < k.n; j++)
          acc += static_cast<uint32_t>(hot[j]) *
                 static_cast<uint32_t>(table[j * entry_size + e]);
        out[b * entry_size + e] = static_cast<int32_t>(acc);
      }
    }
  };
  uint64_t per = (batch + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    uint64_t lo = t * per, hi = std::min(batch, (t + 1) * per);
    if (lo >= hi) break;
    workers.emplace_back(work, lo, hi);
  }
  for (auto& w : workers) w.join();
  return rc.load();
}

int dpftpu_key_words(void) { return dpftpu::kKeyWords; }
}
