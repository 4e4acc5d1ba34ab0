// Device helpers shared by the port's kernels: 128-bit limb arithmetic
// (limb 0 least significant, as in core/u128.py) and a rotate.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dpf {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int b) {
  return (x << b) | (x >> (32 - b));
}

// r = (a + b) mod 2^128.  r may alias a or b.
__device__ __forceinline__ void add128(uint32_t r[4], const uint32_t a[4],
                                       const uint32_t b[4]) {
  uint64_t s = (uint64_t)a[0] + b[0];
  r[0] = (uint32_t)s;
  s = (s >> 32) + a[1] + b[1];
  r[1] = (uint32_t)s;
  s = (s >> 32) + a[2] + b[2];
  r[2] = (uint32_t)s;
  r[3] = (uint32_t)((s >> 32) + a[3] + b[3]);
}

}  // namespace dpf
