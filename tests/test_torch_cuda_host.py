"""The CUDA kernels' logic, compiled for the host and run on the CPU.

There is no GPU and no ``nvcc`` here, so the sources in
``dpf_tpu_torch/csrc`` are compiled with ``g++`` against a small shim
(below) that emulates what they use of CUDA: ``threadIdx``/``blockIdx``
as thread-locals, ``__syncthreads`` as a ``std::barrier``, ``atomicAdd``
as an atomic fetch-add, ``__shared__`` as static storage (blocks run one
after another), ``extern __shared__`` as a per-launch buffer of the
launch's dynamic size, ``__byte_perm`` and ``__funnelshift_l`` with
CUDA's semantics, ``uint2`` and ``uint4``, the ``cp.async`` intrinsics of
``<cuda_pipeline_primitives.h>`` as ordered copies (each poisons its
destination when issued and lands only at the ``__pipeline_wait_prior``
that retires its commit group, and a thread that ends with a copy not
waited for fails its launch), and a card of two SMs that hold one block
each, so a persistent grid's grid-stride loop runs more than once.  Each
``kernel<<<grid, block, smem, stream>>>(args)`` launch is rewritten
into a loop that runs every block's threads as ``std::thread``s.  The
kernels use no warp-level primitives, so this executes exactly their
arithmetic and indexing; the results are held against the kernels'
plain PyTorch versions at small shapes.  It says
nothing about speed or about what ``nvcc`` accepts (``chip_smoke.py``
does that on the card).
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dpf_tpu_torch.ops import (aes_level, cuda_build, matmul128, prf_zoo,
                               sqrt_grid, subtree)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread here: the suite runs several worker
    processes side by side, and an oversubscribed host stalls the other
    workers' timing-sensitive tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

SHIM = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <deque>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static
#define __constant__
using std::max;
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
inline uint2 make_uint2(uint32_t a, uint32_t b) { return uint2{a, b}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return uint4{a, b, c, d};
}
typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
// set by a thread that ends with a cp.async not waited for; the launch's
// cudaGetLastError reports it
inline std::atomic<int> host_launch_error{0};
inline cudaError_t cudaGetLastError() {
  return host_launch_error.exchange(0) ? cudaErrorInvalidValue : cudaSuccess;
}
// cp.async: a copy poisons its destination when issued and lands at the
// __pipeline_wait_prior that retires its commit group, the latest moment
// the card may land it.  A read before that wait, or a copy issued into
// a slot another thread still reads, sees the poison.
struct HostCopy {
  void* dst;
  const void* src;
  size_t n, zfill;
};
inline thread_local std::vector<HostCopy> host_open_copies;
inline thread_local std::deque<std::vector<HostCopy>> host_copy_groups;
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n,
                                    size_t zfill = 0) {
  std::memset(dst, 0xa5, n);
  host_open_copies.push_back(HostCopy{dst, src, n, zfill});
}
inline void __pipeline_commit() {
  host_copy_groups.push_back(std::move(host_open_copies));
  host_open_copies.clear();
}
inline void __pipeline_wait_prior(size_t n) {
  for (; host_copy_groups.size() > n; host_copy_groups.pop_front())
    for (const HostCopy& c : host_copy_groups.front()) {
      std::memcpy(c.dst, c.src, c.n - c.zfill);
      std::memset(static_cast<char*>(c.dst) + c.n - c.zfill, 0, c.zfill);
    }
}
// at a thread's end: every copy issued was committed and waited for
inline void host_check_copies_landed() {
  bool pending = !host_open_copies.empty();
  for (const auto& g : host_copy_groups) pending |= !g.empty();
  if (pending) host_launch_error = 1;
  host_open_copies.clear();
  host_copy_groups.clear();
}
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
// a card of 2 SMs, one resident block each
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = 1;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t in = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int n = 0; n < 4; ++n)
    r |= (uint32_t)((in >> (8 * ((s >> (4 * n)) & 7))) & 0xff) << (8 * n);
  return r;
}
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t sh) {
  return (uint32_t)(((((uint64_t)hi << 32) | lo) << (sh & 31)) >> 32);
}
inline const char* cudaGetErrorString(cudaError_t e) {
  return e ? "invalid value" : "no error";
}
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local std::barrier<>* host_barrier = nullptr;
inline thread_local unsigned char* host_dyn_smem = nullptr;
inline void __syncthreads() { host_barrier->arrive_and_wait(); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}
inline int __ffs(int x) { return __builtin_ffs(x); }
template <class F>
void host_launch(dim3 grid, dim3 block, size_t smem, F f) {
  const unsigned nt = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::vector<uint4> dyn(smem / sizeof(uint4) + 1);
        std::barrier<> bar(nt);
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < nt; ++t)
          ts.emplace_back([&, t] {
            threadIdx = dim3(t % block.x, (t / block.x) % block.y,
                             t / (block.x * block.y));
            blockIdx = dim3(bx, by, bz);
            blockDim = block;
            gridDim = grid;
            host_barrier = &bar;
            host_dyn_smem = reinterpret_cast<unsigned char*>(dyn.data());
            f();
            host_check_copies_landed();
            bar.arrive_and_drop();
          });
        for (auto& th : ts) th.join();
      }
}
"""


# the intrinsics themselves are in SHIM, beside the launch that checks
# that every copy landed
PIPELINE_SHIM = r"""
#pragma once
#include "cuda_runtime.h"
"""


def _host_source(src: str) -> str:
    """Rewrite every ``extern __shared__ T name[];`` into a pointer to the
    launch's buffer and every ``name<<<cfg>>>(args)`` launch into
    host_launch."""
    src = re.sub(r"extern\s+__shared__\s+(\w+)\s+(\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(host_dyn_smem);", src)
    out, pos = [], 0
    while True:
        i = src.find("<<<", pos)
        if i < 0:
            return "".join(out) + src[pos:]
        start = pos + re.search(r"([A-Za-z_]\w*(?:<[\w, ]+>)?)$",
                                src[pos:i]).start(1)
        j = src.index(">>>", i)
        cfg = [c.strip() for c in src[i + 3:j].split(",")]
        k = p = src.index("(", j)
        depth = 0
        while True:
            depth += {"(": 1, ")": -1}.get(src[p], 0)
            if depth == 0:
                break
            p += 1
        out.append(src[pos:start])
        out.append("host_launch(dim3(%s), dim3(%s), %s, [&] { %s(%s); })"
                   % (cfg[0], cfg[1], cfg[2] if len(cfg) > 2 else "0",
                      src[start:i], src[k + 1:p]))
        pos = p + 1


@pytest.fixture(scope="module")
def shim_dir(tmp_path_factory):
    """A directory holding the shim's headers."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels for the host")
    build = tmp_path_factory.mktemp("cuda_host")
    (build / "cuda_runtime.h").write_text(SHIM)
    (build / "cuda_pipeline_primitives.h").write_text(PIPELINE_SHIM)
    return build


@pytest.fixture(scope="module")
def host_libs(shim_dir):
    gxx = shutil.which("g++")
    build = shim_dir

    def compile_one(name):
        cpp = build / (name + ".cpp")
        cpp.write_text(_host_source(
            (cuda_build.CSRC_DIR / (name + ".cu")).read_text()))
        so = build / ("lib%s.so" % name)
        res = subprocess.run(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             "-I", str(build), "-I", str(cuda_build.CSRC_DIR), "-o", str(so),
             str(cpp)], capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-4000:]
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in cuda_build.SOURCES[name][0].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        return lib

    # one compiler at a time: the suite's other workers share the host
    return {name: compile_one(name) for name in cuda_build.SOURCES}


def test_pipeline_shim_lands_copies_at_their_wait(shim_dir, tmp_path):
    """The shim's cp.async: a copy is poison until the wait that retires
    its group, and a launch whose thread never waits for a copy fails."""
    cpp = tmp_path / "check.cpp"
    cpp.write_text("""
#include <cuda_pipeline_primitives.h>
extern "C" int check() {
  uint32_t from[2] = {1u, 2u}, to[2] = {0u, 0u};
  __pipeline_memcpy_async(&to[0], &from[0], 4);
  __pipeline_commit();
  __pipeline_memcpy_async(&to[1], &from[1], 4);
  __pipeline_commit();
  if (to[0] == 1u || to[1] == 2u) return 1;   // landed before its wait
  __pipeline_wait_prior(1);
  if (to[0] != 1u || to[1] == 2u) return 2;   // the newer group waits on
  __pipeline_wait_prior(0);
  if (to[1] != 2u) return 3;
  host_launch(dim3(1), dim3(2), 0, [&] {
    __pipeline_memcpy_async(&to[threadIdx.x], &from[0], 4);
    __pipeline_commit();
  });
  if (cudaGetLastError() == cudaSuccess) return 4;  // never waited for
  if (cudaGetLastError() != cudaSuccess) return 5;  // reported once
  return 0;
}
""")
    so = cpp.with_suffix(".so")
    res = subprocess.run(
        [shutil.which("g++"), "-std=c++20", "-O1", "-shared", "-fPIC",
         "-pthread", "-I", str(shim_dir), "-o", str(so), str(cpp)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert ctypes.CDLL(str(so)).check() == 0


def _rnd(rng, *shape):
    return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, shape,
                                         dtype=np.int64).astype(np.int32))


@pytest.mark.parametrize("arity", [2, 4])
@pytest.mark.parametrize("bsz,w", [
    (1, 1), (3, 5),          # below one block
    (2, 300),                # past the 2-block grid's stride of 512
    (1, 255),                # one block, not a multiple of 32
    (4, 256),                # exactly two strides
    (3, 401),                # two strides and a ragged third
])
def test_aes_level_kernel_on_host(host_libs, bsz, w, arity):
    rng = np.random.default_rng(bsz * 1000 + w)
    seeds, cw1, cw2 = _rnd(rng, bsz, w, 4), _rnd(rng, bsz, 64, 4), \
        _rnd(rng, bsz, 64, 4)
    c1, c2 = cw1[:, 14:14 + arity], cw2[:, 14:14 + arity]
    out = torch.empty(bsz, arity * w, 4, dtype=torch.int32)
    assert host_libs["aes_level"].aes_level_launch(
        seeds.data_ptr(), c1.data_ptr(), c2.data_ptr(), c1.stride(0),
        out.data_ptr(), bsz, w, arity, 0, None) == 0
    assert torch.equal(out, aes_level.aes_level_step_plain(seeds, c1, c2,
                                                           arity))


@pytest.mark.parametrize("arity", [2, 4])
@pytest.mark.parametrize("bsz,w", [(1, 1), (3, 5), (2, 300), (3, 401)])
def test_aes_level_low32_kernel_on_host(host_libs, bsz, w, arity):
    """K1's low-limb form: a contiguous [B, a*w] plane equal to limb 0 of
    the full form's children."""
    rng = np.random.default_rng(bsz * 1000 + w + 7)
    seeds, cw1, cw2 = _rnd(rng, bsz, w, 4), _rnd(rng, bsz, 64, 4), \
        _rnd(rng, bsz, 64, 4)
    c1, c2 = cw1[:, 20:20 + arity], cw2[:, 20:20 + arity]
    full = torch.empty(bsz, arity * w, 4, dtype=torch.int32)
    low = torch.empty(bsz, arity * w, dtype=torch.int32)
    for out, low32 in ((full, 0), (low, 1)):
        assert host_libs["aes_level"].aes_level_launch(
            seeds.data_ptr(), c1.data_ptr(), c2.data_ptr(), c1.stride(0),
            out.data_ptr(), bsz, w, arity, low32, None) == 0
    assert torch.equal(low, full[..., 0])
    assert torch.equal(low, aes_level.aes_level_step_plain(
        seeds, c1, c2, arity, low32=True))


def test_aes_level_kernel_on_host_rejects_bad_arity(host_libs):
    z = torch.zeros(1, 4, 4, dtype=torch.int32)
    assert host_libs["aes_level"].aes_level_launch(
        z.data_ptr(), z.data_ptr(), z.data_ptr(), 16, z.data_ptr(), 1, 1, 3,
        0, None) != 0


def _contract_on_host(lib, a, t, sms=4):
    out = torch.zeros(a.shape[0], t.shape[1], dtype=torch.int32)
    assert lib.contract_i32_launch(
        a.data_ptr(), a.stride(0), a.stride(1), t.data_ptr(), out.data_ptr(),
        a.shape[0], a.shape[1], t.shape[1], sms, None) == 0
    return out


@pytest.mark.parametrize("bsz,k,e,inc", [(1, 7, 1, 1), (3, 300, 3, 1),
                                         (17, 1000, 16, 4), (5, 600, 20, 1)])
def test_contract_kernel_on_host(host_libs, bsz, k, e, inc):
    rng = np.random.default_rng(k + e)
    base = _rnd(rng, bsz, k, inc)
    a = base[..., 0]
    t = _rnd(rng, k, e)
    assert torch.equal(_contract_on_host(host_libs["contract"], a, t),
                       matmul128.dot_i32_plain(a, t))


@pytest.mark.parametrize("bsz,k,e,inc", [
    (1, 7, 16, 1),        # fewer k than one 32-k stage: 4-byte copies only
    (3, 300, 16, 1),      # contiguous groups and a ragged tail
    (33, 1001, 16, 1),    # two warps, one row of the second live
    (257, 4096, 16, 1),   # three row groups of 128, the last of one row
    (3, 4096, 1, 1),      # one column
    (1, 1001, 3, 1),      # three columns: the scalar table stage
    (33, 300, 17, 1),     # two column tiles, the second of one column
    (3, 1001, 20, 1),     # two column tiles of 16 and 4
    (257, 300, 16, 4),    # the low word of 16-byte leaves
    (3, 1001, 20, 4),
    (1, 4096, 16, 4),
    (33, 7, 3, 4),        # leaves, fewer k than one stage
    (3, 1001, 16, 3),     # an odd stride
    (33, 300, 17, 5),
    (1, 4096, 1, 3),
    (257, 7, 20, 3),
])
def test_contract_kernel_forms_on_host(host_libs, bsz, k, e, inc):
    """K3 against ``dot_i32_plain`` for each way it copies a row: 16-byte
    words of a contiguous aligned row (inc 1), one 4-byte word per k of
    anything else (the low word of 16-byte leaves at inc 4, odd strides),
    at ragged K, B and E."""
    rng = np.random.default_rng(bsz * 7 + k * 3 + e + inc)
    a = _rnd(rng, bsz, k, inc)[..., 0]
    t = _rnd(rng, k, e)
    assert torch.equal(_contract_on_host(host_libs["contract"], a, t),
                       matmul128.dot_i32_plain(a, t))


@pytest.mark.parametrize("offset,width", [(1, 1000), (3, 1003), (2, 64)])
@pytest.mark.parametrize("bsz", [1, 33])
def test_contract_kernel_unaligned_rows_on_host(host_libs, offset, width,
                                                bsz):
    """Rows that start off a 16-byte boundary (a column slice at an odd
    offset; with an odd width each row starts at another alignment) copy
    one 4-byte word per k."""
    rng = np.random.default_rng(offset * 100 + width + bsz)
    k = width - 4
    a = _rnd(rng, bsz, width)[:, offset:offset + k]
    assert a.data_ptr() % 16 != 0 and a.stride(1) == 1
    t = _rnd(rng, k, 16)
    assert torch.equal(_contract_on_host(host_libs["contract"], a, t),
                       matmul128.dot_i32_plain(a, t))


@pytest.mark.parametrize("sms", [1, 7, 64])
def test_contract_kernel_k_split_on_host(host_libs, sms):
    """The grid's split of k follows the card's size: one block, a few,
    and more blocks than 32-k stages; the sum is the same."""
    rng = np.random.default_rng(sms)
    a, t = _rnd(rng, 5, 700), _rnd(rng, 700, 16)
    assert torch.equal(_contract_on_host(host_libs["contract"], a, t, sms),
                       matmul128.dot_i32_plain(a, t))


# K2's keys per block (kTileKeys in csrc/subtree.cu), for the ragged key
# tiles below
TB = 4


def _subtree_launch(lib, fr, cw1, cw2, tbl, out, sched, f_lv, log_cb,
                    method):
    """Call K2's C entry with a schedule of (arity, first slot) pairs; a
    [B, N, E] table takes the per-key mode."""
    lg = (ctypes.c_int * len(sched))(*(a.bit_length() - 1 for a, _ in sched))
    off = (ctypes.c_int * len(sched))(*(o for _, o in sched))
    return lib.subtree_contract_launch(
        fr.data_ptr(), cw1.data_ptr(), cw2.data_ptr(), tbl.data_ptr(),
        out.data_ptr(), out.shape[0], fr.shape[1], len(sched), lg, off,
        f_lv, log_cb, out.shape[1], method, int(tbl.dim() == 3), None)


@pytest.mark.parametrize("method", subtree.SUBTREE_PRFS)
@pytest.mark.parametrize("bsz,depth,f_levels,cb,e", [
    (2, 7, 0, 128, 16),      # one block per key, no path walk
    (3, 9, 1, 64, 3),        # frontier of 2, two-level path walk
    (2, 8, 2, 16, 5),        # block smaller than the 256-thread BFS
    (1, 10, 0, 1024, 1),     # depth-first below the 256-node level
    (1, 8, 0, 256, 16),      # a tile of one key, 256 threads
    (2, 9, 0, 512, 16),      # a tile of two keys
    (3, 12, 0, 4096, 2),     # 64 threads a key, the deepest depth-first
    (TB - 1, 8, 1, 64, 17),  # one ragged tile, frontier of 2, 17 columns
    (TB + 1, 9, 2, 32, 33),  # two tiles, frontier of 4, 33 columns
    (2 * TB + 3, 7, 0, 16, 1),  # three tiles, one column
    (3, 7, 0, 2, 5),         # block of 2 leaves: a quad past CB
    (2, 6, 0, 64, 260),      # columns past one 256-thread sweep
])
def test_subtree_kernel_on_host(host_libs, method, bsz, depth, f_levels, cb,
                                e):
    rng = np.random.default_rng(depth * 10 + method)
    n = 1 << depth
    fr = _rnd(rng, bsz, 1 << f_levels, 4)
    cw1, cw2, tbl = _rnd(rng, bsz, 64, 4), _rnd(rng, bsz, 64, 4), \
        _rnd(rng, n, e)
    out = torch.zeros(bsz, e, dtype=torch.int32)
    assert _subtree_launch(host_libs["subtree"], fr, cw1, cw2, tbl, out,
                           subtree._binary_schedule(depth), f_levels,
                           cb.bit_length() - 1, method) == 0
    assert torch.equal(out, subtree.subtree_contract_plain(
        fr, cw1, cw2, tbl, depth=depth, f_levels=f_levels,
        prf_method=method))


def test_subtree_kernel_on_host_rejects_bad_prf(host_libs):
    z = torch.zeros(1, 64, 4, dtype=torch.int32)
    assert _subtree_launch(host_libs["subtree"], z[:, :1], z, z, z, z[:, 0],
                           subtree._binary_schedule(7), 0, 7, 3) != 0


@pytest.mark.parametrize("method", subtree.SUBTREE_PRFS)
@pytest.mark.parametrize("bsz,depth,f_lv,cb,e", [
    (2, 11, 0, 2048, 3),     # odd depth, one block covers the binary level
    (3, 9, 1, 64, 16),       # odd depth, frontier below the binary level
    (2, 7, 0, 4, 5),         # walk through the binary level, BFS only
    (2, 8, 0, 16, 2),        # even depth, two-level path walk
    (1, 10, 2, 64, 1),       # frontier of 16, no path walk
    (1, 12, 0, 4096, 4),     # BFS to 256 nodes, then depth-first
    (1, 11, 0, 2048, 16),    # a tile of one key, 256 threads
    (2, 11, 0, 2048, 3),     # a tile of two keys
    (3, 12, 0, 4096, 2),     # 64 threads a key, the deepest depth-first
    (TB - 1, 9, 1, 16, 17),  # one ragged tile, CB below the BFS width
    (TB + 1, 10, 1, 64, 33),  # two tiles, frontier of 4, 33 columns
    (2 * TB + 3, 8, 0, 4, 1),  # three tiles, BFS only, one column
])
def test_subtree_mixed_kernel_on_host(host_libs, method, bsz, depth, f_lv,
                                      cb, e):
    from dpf_tpu_torch.core import radix4
    rng = np.random.default_rng(depth * 10 + method + 1000)
    n = 1 << depth
    ars = radix4.arities(n)
    f_cnt = int(np.prod(ars[:f_lv]))
    fr = _rnd(rng, bsz, f_cnt, 4)
    cw1, cw2, tbl = _rnd(rng, bsz, 64, 4), _rnd(rng, bsz, 64, 4), \
        _rnd(rng, n, e)
    out = torch.zeros(bsz, e, dtype=torch.int32)
    assert _subtree_launch(host_libs["subtree"], fr, cw1, cw2, tbl, out,
                           list(zip(ars, radix4.cw_offsets(ars))), f_lv,
                           cb.bit_length() - 1, method) == 0
    assert torch.equal(out, subtree.subtree_contract_mixed_plain(
        fr, cw1, cw2, tbl, ars=ars, f_lv=f_lv, prf_method=method,
        block_leaves=cb))


@pytest.mark.parametrize("f_cnt,sched,log_cb,prf", [
    (1, [(4, 0)] * 4, 3, 2),            # 2^3 leaves: not a product of 4s
    (1, [(4, 0)] * 4, 8, 3),            # PRF id 3 (AES) has no subtree kernel
    (2, [(4, 0)] * 4, 8, 2),            # frontier count does not match f_lv
    (1, [(2, 0)] * 33, 1, 2),           # more levels than the kernel holds
    (1, [(4, 62), (4, 0)], 4, 2),       # codeword slots past the 64th
    (1, [(8, 0), (2, 0)], 4, 2),        # arity 8
])
def test_subtree_mixed_kernel_on_host_rejects_bad_schedule(
        host_libs, f_cnt, sched, log_cb, prf):
    z = torch.zeros(2, 64, 4, dtype=torch.int32)
    assert _subtree_launch(host_libs["subtree"], z[:1, :f_cnt], z, z, z,
                           z[:1, 0, :1], sched, 0, log_cb, prf) != 0


def _sqrt_launch(lib, seeds, cw1, cw2, tbl, out, rc, row0, method):
    return lib.sqrt_grid_launch(
        seeds.data_ptr(), seeds.stride(0), cw1.data_ptr(), cw2.data_ptr(),
        cw1.stride(0), tbl.data_ptr(), out.data_ptr(), out.shape[0],
        seeds.shape[1], cw1.shape[1], rc, out.shape[1], row0, method,
        int(tbl.dim() == 3), None)


@pytest.mark.parametrize("method", range(6))
@pytest.mark.parametrize("bsz,k,r,rc,e,row0", [
    (3, 32, 16, 16, 5, 0),      # K < the block's 256 threads, one step
    (1, 64, 32, 4, 16, 0),      # odd log N (N = 2^11): K != R, 8 steps
    (9, 512, 8, 4, 3, 8),       # two column sub-tiles, two key tiles
    (2, 16, 2, 2, 1, 0),        # R = 2: rows of the last quad masked
    (3, 32, 8, 8, 2, 1 << 31),  # row0 past 2^31
    (9, 16, 2, 2, 3, (1 << 31) + 12),  # R = 2, two key tiles, row0 > 2^31
])
def test_sqrt_grid_kernel_on_host(host_libs, method, bsz, k, r, rc, e,
                                  row0):
    """K4 through the host shim against its plain version: the key
    stride is the wire's (seeds and codewords are views of one buffer)."""
    rng = np.random.default_rng(k * 7 + r + method)
    wire = _rnd(rng, bsz, 4 * (k + 2 * r))
    seeds = wire[:, :4 * k].unflatten(1, (k, 4))
    cw1 = wire[:, 4 * k:4 * (k + r)].unflatten(1, (r, 4))
    cw2 = wire[:, 4 * (k + r):].unflatten(1, (r, 4))
    tbl = _rnd(rng, r * k, e)
    out = torch.zeros(bsz, e, dtype=torch.int32)
    assert _sqrt_launch(host_libs["sqrt_grid"], seeds, cw1, cw2, tbl, out,
                        rc, row0, method) == 0
    assert torch.equal(out, sqrt_grid.sqrt_grid_contract_plain(
        seeds, cw1, cw2, tbl, prf_method=method, row0=row0))


@pytest.mark.parametrize("method,rc,row0", [
    (6, 4, 0),          # unknown PRF id
    (5, 4, 2),          # block-PRG row0 inside a quad
    (4, 2, 0),          # block-PRG chunk of 2 rows out of 8
    (2, 16, 0),         # chunk longer than R
])
def test_sqrt_grid_kernel_on_host_rejects(host_libs, method, rc, row0):
    z = torch.zeros(1, 64, 4, dtype=torch.int32)
    tbl = torch.zeros(8 * 8, 1, dtype=torch.int32)
    assert _sqrt_launch(host_libs["sqrt_grid"], z[:, :8], z[:, :8], z[:, :8],
                        tbl, z[:, 0, :1], rc, row0, method) != 0


@pytest.mark.parametrize("method", subtree.SUBTREE_PRFS)
@pytest.mark.parametrize("radix,bsz,depth,f_lv,cb,e", [
    (2, 1, 7, 0, 128, 16),       # one key, 256 threads
    (2, TB - 1, 8, 1, 64, 17),   # three keys, frontier of 2
    (2, 2 * TB + 3, 7, 0, 2, 5),  # eleven keys, a block of 2 leaves
    (4, TB + 1, 9, 1, 16, 3),    # radix 4, odd depth, five keys
    (4, 2, 8, 0, 256, 1),        # radix 4, even depth, one column
    (2, 3, 9, 0, 512, 260),      # two sweeps of columns
    (2, 2, 10, 0, 256, 16),      # the block pkt_block_leaves picks, a walk
    (4, 2, 10, 0, 256, 8),       # the same in the radix-4 tree
])
def test_subtree_per_key_kernel_on_host(host_libs, method, radix, bsz,
                                        depth, f_lv, cb, e):
    """K2's per-key kernel: key b against table b of [B, N, E], one key a
    block, reading no table past the last key's."""
    from dpf_tpu_torch.core import radix4
    rng = np.random.default_rng(depth * 10 + method + 2000)
    n = 1 << depth
    if radix == 4:
        ars = radix4.arities(n)
        sched = list(zip(ars, radix4.cw_offsets(ars)))
        f_cnt = int(np.prod(ars[:f_lv]))
    else:
        sched, f_cnt = subtree._binary_schedule(depth), 1 << f_lv
    fr = _rnd(rng, bsz, f_cnt, 4)
    cw1, cw2 = _rnd(rng, bsz, 64, 4), _rnd(rng, bsz, 64, 4)
    # the batch's tables, then one more that no key may read
    tables = _rnd(rng, bsz + 1, n, e)
    tables[bsz] = 0
    out = torch.zeros(bsz, e, dtype=torch.int32)
    assert _subtree_launch(host_libs["subtree"], fr, cw1, cw2,
                           tables[:bsz], out, sched, f_lv,
                           cb.bit_length() - 1, method) == 0
    if radix == 4:
        want = subtree.subtree_contract_mixed_plain(
            fr, cw1, cw2, tables[:bsz], ars=ars, f_lv=f_lv,
            prf_method=method, block_leaves=cb)
    else:
        want = subtree.subtree_contract_plain(
            fr, cw1, cw2, tables[:bsz], depth=depth, f_levels=f_lv,
            prf_method=method, block_leaves=cb)
    assert torch.equal(out, want)


@pytest.mark.parametrize("method", range(6))
@pytest.mark.parametrize("bsz,k,r,rc,e,row0", [
    (3, 32, 16, 16, 5, 0),       # one item a key
    (9, 16, 8, 4, 3, 8),         # two items a key, rows of 4
    (1, 64, 32, 8, 16, 0),       # one key, four items
    (1, 512, 8, 4, 16, 8),       # K past a sub-tile's 256 columns
    (2, 300, 12, 4, 3, 4),       # a ragged last column tile
    (2, 32, 32, 32, 260, 0),     # two sweeps of columns
])
def test_sqrt_grid_per_key_kernel_on_host(host_libs, method, bsz, k, r, rc,
                                          e, row0):
    """K4's per-key kernel: key b against table b of [B, R K, E], items
    walked by a persistent grid of the shim's two blocks."""
    rng = np.random.default_rng(k * 7 + r + method + 3000)
    wire = _rnd(rng, bsz, 4 * (k + 2 * r))
    seeds = wire[:, :4 * k].unflatten(1, (k, 4))
    cw1 = wire[:, 4 * k:4 * (k + r)].unflatten(1, (r, 4))
    cw2 = wire[:, 4 * (k + r):].unflatten(1, (r, 4))
    tables = _rnd(rng, bsz, r * k, e)
    out = torch.zeros(bsz, e, dtype=torch.int32)
    assert _sqrt_launch(host_libs["sqrt_grid"], seeds, cw1, cw2, tables,
                        out, rc, row0, method) == 0
    assert torch.equal(out, sqrt_grid.sqrt_grid_contract_plain(
        seeds, cw1, cw2, tables, prf_method=method, row0=row0))


def _contract_pkt_on_host(lib, a, t, sms=2):
    out = torch.zeros(a.shape[0], t.shape[2], dtype=torch.int32)
    assert lib.contract_pkt_launch(
        a.data_ptr(), a.stride(0), a.stride(1), t.data_ptr(), t.stride(0),
        out.data_ptr(), a.shape[0], a.shape[1], t.shape[2], sms, None) == 0
    return out


@pytest.mark.parametrize("bsz,k,e,inc,sms", [
    (1, 7, 16, 1, 2),        # fewer rows than one sweep
    (3, 1001, 16, 1, 2),     # 16-byte quads, ragged unrolled sweeps
    (5, 300, 4, 4, 7),       # one quad a row, leaves at stride 4
    (2, 600, 8, 1, 1),       # two quads a row, one block a key
    (3, 300, 3, 1, 2),       # three columns: one word a thread
    (2, 400, 20, 3, 2),      # five quads: not a power of two
    (1, 64, 260, 1, 2),      # columns past one sweep of 256
    (4, 2048, 16, 1, 64),    # more row ranges than rows a sweep
])
def test_contract_pkt_kernel_on_host(host_libs, bsz, k, e, inc, sms):
    """K6 against ``dot_i32_per_key_plain`` in each form: 16-byte quads
    (E = 4, 8, 16) and one word a thread (E = 3, 20, 260), strided
    leaves, and the rows of a key split over blocks."""
    rng = np.random.default_rng(bsz * 7 + k * 3 + e + inc)
    a = _rnd(rng, bsz, k, inc)[..., 0]
    t = _rnd(rng, bsz, k, e)
    assert torch.equal(_contract_pkt_on_host(host_libs["contract_pkt"], a, t,
                                             sms),
                       matmul128.dot_i32_per_key_plain(a, t))


@pytest.mark.parametrize("offset,e", [(64, 16), (3, 16), (5, 3)])
def test_contract_pkt_kernel_row_chunks_on_host(host_libs, offset, e):
    """A chunk of rows of [B, N, E] tables (keys N E words apart): at a
    16-byte boundary the quads, off it one word a thread."""
    rng = np.random.default_rng(offset + e)
    tables = _rnd(rng, 3, 256, e)
    t = tables[:, offset:offset + 128]
    a = _rnd(rng, 3, 128)
    assert torch.equal(_contract_pkt_on_host(host_libs["contract_pkt"], a, t),
                       matmul128.dot_i32_per_key_plain(a, t))


@pytest.mark.parametrize("bsz,w", [(1, 1), (3, 5), (2, 300)])
def test_chacha_level_kernel_on_host(host_libs, bsz, w):
    rng = np.random.default_rng(bsz * 100 + w)
    seeds, cw = _rnd(rng, bsz, w, 4), _rnd(rng, bsz, 64, 4)
    c1, c2 = cw[:, 10:12], cw[:, 40:42]
    out = torch.empty(bsz, 2 * w, 4, dtype=torch.int32)
    assert host_libs["chacha_level"].chacha_level_launch(
        seeds.data_ptr(), c1.data_ptr(), c2.data_ptr(), c1.stride(0),
        out.data_ptr(), bsz, w, None) == 0
    assert torch.equal(out, subtree.chacha_level_step_plain(seeds, c1, c2))


@pytest.mark.parametrize("name", prf_zoo.CANDIDATES)
def test_prf_zoo_kernel_on_host(host_libs, name):
    """K7: each of the 15 instances equals the candidate's plain core at
    ragged n, below one block, past one block and past the 2-SM grid's
    stride (n = 4500 > 32 blocks x 128 threads), at a position above
    2^32 too."""
    cand = prf_zoo.CANDIDATES.index(name)
    kids = 4 if name in ("chacha12_blk", "salsa20_12_blk") else 1
    for n, pos in ((1, 1), (33, 0), (257, 1), (4500, (1 << 33) + 5)):
        seeds = _rnd(np.random.default_rng(n + cand), n, 4)
        out = torch.empty((kids, n, 4) if kids > 1 else (n, 4),
                          dtype=torch.int32)
        assert host_libs["prf_zoo"].prf_zoo_launch(
            cand, seeds.data_ptr(), out.data_ptr(), n, pos, None) == 0
        assert torch.equal(out, prf_zoo.zoo_plain(name, seeds, pos)), (n,
                                                                       pos)


def test_prf_zoo_kernel_on_host_rejects_bad_candidate(host_libs):
    seeds = torch.zeros((4, 4), dtype=torch.int32)
    out = torch.empty((4, 4), dtype=torch.int32)
    for cand in (-1, len(prf_zoo.CANDIDATES)):
        assert host_libs["prf_zoo"].prf_zoo_launch(
            cand, seeds.data_ptr(), out.data_ptr(), 4, 1, None) != 0
