#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``dpf_tpu_torch``) on one GPU.

Run from the repository root on a machine with one NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build every CUDA kernel from ``dpf_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once) and the host C++ library of
   ``dpf_tpu_torch/native`` (the binary keygen; the script fails with
   the compiler's output if it does not build), print the build time,
   ``ptxas``' registers
   and spills per kernel, K1's instructions per node and K2's per leaf,
   with K2's split between the INT32 and FMA pipes, from their SASS
   (``utils/sass_count.py``, where the toolkit has ``cuobjdump``; a
   diagnostic beside the bounds, which are counted from the function);
2. hold each kernel against its plain PyTorch version on the card, bit
   for bit: small shapes, ragged batches (B = 1, 3, 33; for K2 also
   B = 2 and ragged key tiles of TB - 1, TB + 1 and 2 TB + 3 keys at
   TB = 4, and 17 or 33 columns), odd and even depths for the radix-4
   subtree kernel, every PRF id and a row base for the sqrt-N grid
   kernel, and the main paths' shapes (B = 512, N = 2^20, E = 16); time
   kernel, plain version and, for the contraction, the ``torch._int_mm``
   byte-limb decomposition (``matmul128.dot_i32_mxu``) as the library
   yardstick, held bit-equal too;
   K1's low-limb form (the last level of each frontier group) against
   the limb 0 of its full form, at every K1 shape, and timed beside it;
   K3 on the contiguous low-limb plane the AES path hands it and on the
   strided low limbs of 16-byte leaves (DUMMY's binary path), at
   [512, 2^16] and [512, 2^18], each with the bytes its sectors move;
   K2's eight instances (PRF ids 1, 2, 4, 5 over
   the binary and the radix-4 tree) at full width, each also at E = 1
   (the same expansion, a sixteenth of the contraction); the ChaCha
   level step (on no path) at K1's widest shape; beside each bound, the
   AES kernels' lookup floor (their shared-memory table lookups at one
   warp-wide lookup per SM per clock) and K2's pipe bound (its cipher
   cores' xors and rotations on the INT32 pipe, its products on the FMA
   pipe, each at half the issue rate);
3. the sample flow for PRF ids 0-5, binary tree at N = 16384, radix-4
   tree and sqrt-N grid at N = 16384 and 8192 (odd depth): two ``DPF``
   servers answer 8 distinct indices, the client recovers each row
   exactly, and the shares, the one-hot expansion and the point
   evaluation on the card equal the CPU oracle ``eval_cpu``;
4. full width: binary AES-128 and ChaCha20, radix-4 AES-128 and
   ChaCha20-BLK, sqrt-N AES-128 and ChaCha20-BLK at N = 2^20, E = 16,
   B = 512, and AES-128 in the three constructions at the headline
   configuration N = 65536, E = 16, B = 512: a distinct key in every
   row, 512 pairs from one ``gen_batch`` call (the generator, native or
   vectorized, and its host seconds printed), every recovered row
   checked;
5. launch counts: phases 3-4 run once per path (binary, radix-4, then
   sqrt-N), every count set to 0 just before the path and read just
   after; each kernel of a path must have been launched in its run, the
   sqrt-N path once per 512-key batch and nothing else, and the launches
   per 512-key batch of each full-width configuration are printed; then
   one binary and one radix-4 AES batch at N = 2^20 under
   ``torch.profiler`` give K1's and K3's device time summed over a
   batch's launches, beside the bound (and K1's lookup floor) summed over
   the same work;
6. the harness, after phase 5's counts are read (its own counts set to 0
   before 6.1 and read after 6.2): (1) the reference's sweep through
   ``dpf_tpu_torch.benchmark.run_sweep``, N = 2^14 .. 2^20 x AES-128,
   Salsa20, ChaCha20, binary, B = 512 distinct keys, E = 16, each row
   recovery-checked, beside the upstream P100 / V100 figures; (2)
   single-query latency (``test_dpf_latency``, recovery-checked) of
   AES-128 at N = 65536 and 2^20 in the three constructions and of
   binary ChaCha20 at 2^20; (3) ``test_matmul_perf`` ("i32" = K3, "mxu"
   = ``torch._int_mm`` byte limbs, each held bit-equal first) at
   [512, 65536] x [65536, 16] and [8, 256] x [256, 4]; (4) host keygen
   keys/s of ``gen_batch`` at B = 512, N = 2^20, three constructions x
   AES-128 and ChaCha20 (and the binary tree's vectorized generator
   beside the native one).

The last lines are the card's name and power limit, one
``{"kernels": [...]}`` line, and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the package beside it, the script
fails before printing any result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
# Instruction issue rate: 132 SMs x 4 warp schedulers x 32 lanes x the
# 1.98 GHz boost clock (H100 SXM data sheet, Hopper architecture white
# paper).  The kernels' work is 32-bit integer instructions and none is a
# fused multiply-add, which the 67 TFLOP/s fp32 rate counts as two; the
# INT32 pipe alone has half this rate (16 lanes per scheduler).
PEAK_INSTR_PER_S = 132 * 4 * 32 * 1.98e9
# Shared-memory lookups: one wavefront of 32 banks x 4 bytes per SM per
# clock, 32 lanes' lookups when no two lanes hit one bank
LOOKUPS_PER_S = 132 * 32 * 1.98e9
# The INT32 pipe (IADD3, LOP3, SHF, PRMT, ...) and the FMA pipe (IMAD):
# 16 lanes per scheduler each (64 a clock per SM)
ALU_INSTR_PER_S = PEAK_INSTR_PER_S / 2
FMA_INSTR_PER_S = PEAK_INSTR_PER_S / 2

# 32-bit instructions per unit of work, counted from the kernels' code
# (each byte permute, table lookup, rotate, shift, mask, add, xor or
# multiply is one).  The AES core (csrc/aes_ttable.cuh): a round is 16
# lookups x (permute + load) + 4 rotations + 12 xors = 48, the last
# round 16 x 2 + 12 permutes + 4 xors = 48, a key-schedule step
# 4 x 2 + 3 permutes + 4 xors = 15; an AES-128 node = key schedule + A
# blocks + A x add128 (~10) + select, A = 2 or 4
OPS_AES_BLOCK = 10 * 48
OPS_AES_SCHEDULE = 10 * 15
OPS_AES_NODE = OPS_AES_SCHEDULE + 2 * OPS_AES_BLOCK + 2 * 10 + 10
OPS_AES_NODE_A4 = OPS_AES_SCHEDULE + 4 * OPS_AES_BLOCK + 4 * 10 + 10
# table lookups: a key schedule takes 40, a block 160
LOOKUPS_AES_SCHEDULE = 40
LOOKUPS_AES_BLOCK = 160
# K1's low-limb form (the last level of a frontier group) keeps limb 0 of
# each child: of its block's last round one column (4 lookups x 2 + 3
# permutes + 1 xor = 12 of the 48 instructions), of its add128 one limb
# (1 of ~10).  Fewer a child: 3 x 12 + 9 instructions, 3 x 4 lookups
OPS_AES_LOW_SAVED = 3 * 12 + 9
LOOKUPS_AES_LOW_SAVED = 3 * 4
# Salsa/ChaCha-12 core block = 48 quarter rounds x 12 ops + 16 adds; of
# a quarter round's 4 adds, 4 xors and 4 rotations, the xors and
# rotations run on the INT32 pipe only (an add may also be an IMAD)
OPS_CORE_BLOCK = 48 * 12 + 16
OPS_CORE_BLOCK_ALU = 48 * 8
OPS_CHILD_ADD = 12           # add128 + codeword select per child
# sqrt-N grid cell: one AES block and a quarter key schedule (one serves a
# quad of rows) or one core block (a quarter for the block-PRG ids), then
# select + add (3) and 2 per table column


def log(*a):
    print(*a, flush=True)


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import dpf_tpu_torch
    from dpf_tpu_torch import DPF, EvalConfig
    from dpf_tpu_torch.core import radix4, sqrtn
    from dpf_tpu_torch import benchmark, native
    from dpf_tpu_torch.core import keygen
    from dpf_tpu_torch.ops import (aes_level, cuda_build, matmul128,
                                   sqrt_grid, subtree)
    from dpf_tpu_torch.utils import profile_batch, sass_count
    from dpf_tpu_torch.utils.bench import (cuda_ms, test_dpf_latency,
                                           test_dpf_perf, test_matmul_perf)

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("python %s torch %s cuda %s device %s"
        % (sys.version.split()[0], torch.__version__, torch.version.cuda,
           torch.cuda.get_device_name(0)))
    rng = np.random.default_rng(20261016)
    gen = torch.Generator(device=dev).manual_seed(20261016)

    def rnd(*shape):
        # random 32-bit limbs made on the card from a fixed seed
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int64,
                             device=dev, generator=gen).to(torch.int32)

    def sync():
        torch.cuda.synchronize()

    def bound(work):
        """The larger of bytes over the memory rate and instructions over
        the issue rate, in ms, and which one it is; beside it the lookup
        floor of the AES kernels (None for the others)."""
        by_bytes = work["bytes"] / PEAK_BYTES_PER_S
        by_ops = work["ops"] / PEAK_INSTR_PER_S
        lookups = work.get("lookups")
        return (1e3 * max(by_bytes, by_ops),
                "bytes" if by_bytes >= by_ops else "operations",
                None if lookups is None else 1e3 * lookups / LOOKUPS_PER_S)

    def log_row(name, r):
        """Fill a timing row's bound and lookup floor and print the row."""
        r["bound_ms"], r["bound_by"], r["lookup_floor_ms"] = bound(r)
        log("  %-22s %-44s ms %.4f  plain_ms %.2f  bound_ms %.4f (%s)  "
            "lookup_floor_ms %s  library_ms %s"
            % (name, r["shape"], r["ms"], r["plain_ms"], r["bound_ms"],
               r["bound_by"],
               "%.4f" % r["lookup_floor_ms"]
               if r["lookup_floor_ms"] is not None else "null",
               "%.4f" % r["library_ms"]
               if r["library_ms"] is not None else "null"))

    def pipe_bound_ms(ops, alu_only, products):
        """K2's pipe bound in ms: the larger of all its operations over
        the issue rate, the ones only the INT32 pipe runs over its rate
        and the multiply-adds (one IMAD each) over the FMA pipe's."""
        return 1e3 * max(ops / PEAK_INSTR_PER_S, alu_only / ALU_INSTR_PER_S,
                         products / FMA_INSTR_PER_S)

    def held(name, got, want):
        sync()
        if got.shape != want.shape:
            raise AssertionError("%s: shape %s != %s" % (
                name, tuple(got.shape), tuple(want.shape)))
        err = 0 if torch.equal(got, want) else int(
            (got.long() - want.long()).abs().max().item())
        if err != 0:
            raise AssertionError("%s: kernel differs from its plain version "
                                 "(max_abs_err %d)" % (name, err))
        log("  %-44s bit-equal" % name)
        return err

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    logs = cuda_build.build()
    log("phase 1 build: %.1f s (%s)" % (time.perf_counter() - t0,
                                        ", ".join(sorted(logs)) or "cached"))
    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError("the native host library did not build:\n%s"
                           % native.build_error())
    log("  native host library %s: %.1f s" % (native.library_path().name,
                                              time.perf_counter() - t0))
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                log("  %s: %s" % (name, line.strip()))
    try:
        sass = sass_count.k1_counts()
    except (OSError, subprocess.CalledProcessError, ValueError) as exc:
        sass = {}
        log("  K1 SASS: not counted (%s)" % exc)
    for arity, c in sorted(sass.items()):
        log("  K1 %s SASS: %d instructions and %d LDS per node (%s)"
            % (arity, c["instructions"], c["lds"], json.dumps(c)))
    try:
        sass_k2 = sass_count.k2_counts()
    except (OSError, subprocess.CalledProcessError, ValueError) as exc:
        sass_k2 = {}
        log("  K2 SASS: not counted (%s)" % exc)
    for inst, c in sorted(sass_k2.items()):
        x, k = c["expansion_per_leaf"], c["contraction_per_product"]
        log("  K2 %s SASS: expansion %.1f instructions per leaf (INT32 "
            "%.3f, FMA %.3f), contraction %.2f per leaf and column (INT32 "
            "%.3f, FMA %.3f)" % (inst, x["instructions"], x["alu_share"],
                                 x["fma_share"], k["instructions"],
                                 k["alu_share"], k["fma_share"]))

    # ---------------------------------------- 2. kernels vs plain versions
    log("phase 2 kernels against their plain versions")
    errs = {"aes_level_step": 0, "aes_level_step_a4": 0,
            "subtree_contract": 0, "subtree_contract_mixed": 0,
            "contract_i32": 0, "sqrt_grid_contract": 0,
            "chacha_level_step": 0}
    rows = {}

    def k1_low(r, seeds, c1, c2, arity):
        """K1's low-limb form at the row's shape, timed in turns with the
        full form; its bound moves a quarter of the child bytes."""
        bsz, w, _ = seeds.shape
        nodes = bsz * w
        r["full_ms_again"] = cuda_ms(
            lambda: aes_level.aes_level_step(seeds, c1, c2, arity=arity), 10)
        r["low32_ms"] = cuda_ms(lambda: aes_level.aes_level_step(
            seeds, c1, c2, arity=arity, low32=True), 10)
        r["low32_bound_ms"], _, r["low32_lookup_floor_ms"] = bound(dict(
            bytes=nodes * 16 + 2 * bsz * arity * 16 + arity * nodes * 4,
            ops=r["ops"] - arity * nodes * OPS_AES_LOW_SAVED,
            lookups=r["lookups"] - arity * nodes * LOOKUPS_AES_LOW_SAVED))
        log("  K1 arity %d B=%d w=%d: full ms %.4f / %.4f, low32 ms %.4f "
            "(bound %.4f, lookup floor %.4f)"
            % (arity, bsz, w, r["ms"], r["full_ms_again"], r["low32_ms"],
               r["low32_bound_ms"], r["low32_lookup_floor_ms"]))

    # K1: AES level step; the AES path's widest call at N = 2^20, B = 512
    # (choose_chunk -> C = 8192, choose_group -> 32 subtrees) is w = 2^17.
    # 5 x 40013 nodes: not a multiple of 32, more than one grid stride
    for bsz, w in ((3, 5), (1, 1), (33, 64), (5, 40013), (512, 1 << 17)):
        seeds, cw1, cw2 = rnd(bsz, w, 4), rnd(bsz, 64, 4), rnd(bsz, 64, 4)
        c1, c2 = cw1[:, 6:8], cw2[:, 6:8]
        full = aes_level.aes_level_step(seeds, c1, c2)
        errs["aes_level_step"] |= held(
            "K1 aes_level_step B=%d w=%d" % (bsz, w), full,
            aes_level.aes_level_step_plain(seeds, c1, c2))
        errs["aes_level_step"] |= held(
            "K1 aes_level_step low32 B=%d w=%d" % (bsz, w),
            aes_level.aes_level_step(seeds, c1, c2, low32=True),
            full[..., 0])
        del full
    nodes = bsz * w
    rows["aes_level_step"] = dict(
        ms=cuda_ms(lambda: aes_level.aes_level_step(seeds, c1, c2), 10),
        plain_ms=cuda_ms(lambda: aes_level.aes_level_step_plain(
            seeds, c1, c2), 1),
        library_ms=None,
        bytes=nodes * 16 + 2 * bsz * 2 * 16 + 2 * nodes * 16,
        ops=nodes * OPS_AES_NODE,
        lookups=nodes * (LOOKUPS_AES_SCHEDULE + 2 * LOOKUPS_AES_BLOCK),
        shape="B=%d w=%d -> 2w (one level)" % (bsz, w))
    k1_low(rows["aes_level_step"], seeds, c1, c2, 2)
    del seeds, cw1, cw2, c1, c2

    # K1 at arity 4; the radix-4 AES path's widest call at N = 2^20,
    # B = 512 (C = 4096 leaves per frontier node, 64 nodes per group) is
    # w = 2^16 -> 2^18
    for bsz, w in ((3, 5), (1, 1), (33, 64), (5, 40013), (512, 1 << 16)):
        seeds, cw1, cw2 = rnd(bsz, w, 4), rnd(bsz, 64, 4), rnd(bsz, 64, 4)
        c1, c2 = cw1[:, 6:10], cw2[:, 6:10]
        full = aes_level.aes_level_step(seeds, c1, c2, arity=4)
        errs["aes_level_step_a4"] |= held(
            "K1 aes_level_step arity 4 B=%d w=%d" % (bsz, w), full,
            aes_level.aes_level_step_plain(seeds, c1, c2, 4))
        errs["aes_level_step_a4"] |= held(
            "K1 aes_level_step arity 4 low32 B=%d w=%d" % (bsz, w),
            aes_level.aes_level_step(seeds, c1, c2, arity=4, low32=True),
            full[..., 0])
        del full
    nodes = bsz * w
    rows["aes_level_step_a4"] = dict(
        ms=cuda_ms(lambda: aes_level.aes_level_step(seeds, c1, c2, arity=4),
                   10),
        plain_ms=cuda_ms(lambda: aes_level.aes_level_step_plain(
            seeds, c1, c2, 4), 1),
        library_ms=None,
        bytes=nodes * 16 + 2 * bsz * 4 * 16 + 4 * nodes * 16,
        ops=nodes * OPS_AES_NODE_A4,
        lookups=nodes * (LOOKUPS_AES_SCHEDULE + 4 * LOOKUPS_AES_BLOCK),
        shape="B=%d w=%d -> 4w (one radix-4 level)" % (bsz, w))
    k1_low(rows["aes_level_step_a4"], seeds, c1, c2, 4)
    del seeds, cw1, cw2, c1, c2

    # K3: contraction.  The AES path hands it a contiguous plane of the
    # leaves' low limbs (K1's low-limb form), DUMMY's binary path the low
    # limbs of [B, C, 4] leaves (element stride 4); K = 2^18 at N = 2^20,
    # 2^16 at N = 65536.  Why it exists: torch's int32 matmul on CUDA
    # (probed, not relied on)
    try:
        probe = rnd(2, 2) @ rnd(2, 2)
        log("  torch int32 matmul on CUDA: supported (%s)" % probe.dtype)
    except (NotImplementedError, RuntimeError) as exc:
        log("  torch int32 matmul on CUDA: %s: %s"
            % (type(exc).__name__, str(exc).splitlines()[0]))
    # small and ragged shapes, each also from an unaligned column slice
    # and at stride 3
    for bsz, k, e in ((3, 300, 3), (1, 4096, 16), (3, 4096, 1),
                      (33, 4096, 16), (5, 1001, 17), (257, 16, 20)):
        a, t = rnd(bsz, k), rnd(k, e)
        for form, sa, st in (("", a, t),
                             (" unaligned", a[:, 3:-2], t[3:-2]),
                             (" stride 3", a[:, ::3], t[::3].contiguous())):
            errs["contract_i32"] |= held(
                "K3 contract_i32 B=%d K=%d E=%d%s"
                % (bsz, sa.shape[1], e, form),
                matmul128.dot_i32(sa, st), matmul128.dot_i32_plain(sa, st))
    k3_rows = {}
    for bsz, k in ((512, 1 << 16), (512, 1 << 18)):
        leaves = rnd(bsz, k, 4)
        strided = leaves[..., 0]
        plane = strided.contiguous()
        t = rnd(k, 16)
        t0 = time.perf_counter()
        want = matmul128.dot_i32_plain(plane, t)
        sync()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        errs["contract_i32"] |= held(
            "K3 contract_i32 B=%d K=%d E=16 contiguous" % (bsz, k),
            matmul128.dot_i32(plane, t), want)
        errs["contract_i32"] |= held(
            "K3 contract_i32 B=%d K=%d E=16 strided" % (bsz, k),
            matmul128.dot_i32(strided, t), want)
        held("torch._int_mm yardstick B=%d K=%d E=16" % (bsz, k),
             matmul128.dot_i32_mxu(plane, t), want)
        lib_ms = cuda_ms(lambda: matmul128.dot_i32_mxu(plane, t), 5)
        small = k * 16 * 4 + bsz * 16 * 4     # table read, output written
        for form, a, leaf_bytes in (("contiguous", plane, 4),
                                    ("strided", strided, 16)):
            # a strided leaf moves its whole 16 bytes: two leaves a sector
            r = dict(ms=cuda_ms(lambda: matmul128.dot_i32(a, t), 20),
                     plain_ms=plain_ms, library_ms=lib_ms,
                     bytes=bsz * k * leaf_bytes + small,
                     ops=2 * bsz * k * 16,
                     shape="[%d, %d] %s low limbs x [%d, 16]"
                           % (bsz, k, form, k))
            log_row("K3 " + form, r)
            k3_rows["%s K=%d" % (form, k)] = r
        del leaves, strided, plane, t, want
    # the kernels line's row: the main path's contiguous form at 2^18,
    # the other three beside it
    main = k3_rows["contiguous K=%d" % (1 << 18)]
    rows["contract_i32"] = dict(main, **{
        "%s_%s" % (key.replace(" K=", "_k"), f): r[f]
        for key, r in k3_rows.items() if r is not main
        for f in ("ms", "bound_ms")})

    # K2: subtree expand + contract; small and ragged shapes for every
    # stream-cipher id (B = 1 gives its key all 256 threads; key tiles of
    # 2, TB - 1, TB + 1 and 2 TB + 3 keys; 17 and 33 columns), then
    # each id at the full-width shape
    tb = 4                                # kTileKeys, csrc/subtree.cu
    for prf in subtree.SUBTREE_PRFS:
        for bsz, depth, cb, e in ((3, 10, 256, 16), (1, 14, 4096, 16),
                                  (2, 14, 4096, 16),
                                  (tb - 1, 14, 4096, 17),
                                  (tb + 1, 12, 1024, 33),
                                  (2 * tb + 3, 14, 4096, 16),
                                  (33, 14, 4096, 16)):
            fr, cw1, cw2 = rnd(bsz, 1, 4), rnd(bsz, 64, 4), rnd(bsz, 64, 4)
            tbl = rnd(1 << depth, e)
            kw = dict(depth=depth, f_levels=0, prf_method=prf,
                      block_leaves=cb)
            errs["subtree_contract"] |= held(
                "K2 subtree_contract prf=%d B=%d N=2^%d E=%d"
                % (prf, bsz, depth, e),
                subtree.subtree_contract(fr, cw1, cw2, tbl, **kw),
                subtree.subtree_contract_plain(fr, cw1, cw2, tbl, **kw))
    k2_rows = {}

    def k2_full(name, entry, plain, n, nodes, arity, blocks, kw):
        """One full-width K2 instance: held at E = 16 and E = 1 (against
        the plain version's first column), timed at both; nodes parents
        of arity children, blocks core blocks each."""
        t0 = time.perf_counter()
        want = plain(fr, cw1, cw2, tbl, **kw)
        sync()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        errs[entry.__name__] |= held("K2 %s B=512 N=2^20 E=16" % name,
                                     entry(fr, cw1, cw2, tbl, **kw), want)
        errs[entry.__name__] |= held("K2 %s B=512 N=2^20 E=1" % name,
                                     entry(fr, cw1, cw2, tbl1, **kw),
                                     want[:, :1])
        ops = bsz * (nodes * (blocks * OPS_CORE_BLOCK
                              + arity * OPS_CHILD_ADD) + n * 16 * 2)
        r = dict(
            ms=cuda_ms(lambda: entry(fr, cw1, cw2, tbl, **kw), 5),
            e1_ms=cuda_ms(lambda: entry(fr, cw1, cw2, tbl1, **kw), 5),
            plain_ms=plain_ms, library_ms=None,
            bytes=bsz * 16 + 2 * bsz * 64 * 16 + n * 16 * 4 + bsz * 16 * 4,
            ops=ops,
            pipe_bound_ms=pipe_bound_ms(
                ops, bsz * nodes * blocks * OPS_CORE_BLOCK_ALU, bsz * n * 16),
            block_leaves=kw["block_leaves"],
            shape="%s B=%d N=2^20 E=16 from the root" % (name, bsz))
        log_row("K2 " + name, r)
        log("    E=1 ms %.4f (contraction share %.3f), pipe bound ms %.4f"
            % (r["e1_ms"], 1 - r["e1_ms"] / r["ms"], r["pipe_bound_ms"]))
        k2_rows[name] = r
        return r

    bsz, depth, prf = 512, 20, dpf_tpu_torch.PRF_CHACHA20
    n = 1 << depth
    fr, cw1, cw2 = rnd(bsz, 1, 4), rnd(bsz, 64, 4), rnd(bsz, 64, 4)
    tbl = rnd(n, 16)
    tbl1 = tbl[:, :1].contiguous()
    prf_names = {1: "Salsa20", 2: "ChaCha20", 4: "Salsa20-BLK",
                 5: "ChaCha20-BLK"}
    # a binary tree has N - 1 parents of 2 children, one core block a
    # child (one a parent for the block-PRG ids); the row holds ChaCha20
    for p in subtree.SUBTREE_PRFS:
        r = k2_full("binary " + prf_names[p], subtree.subtree_contract,
                    subtree.subtree_contract_plain, n, n - 1, 2,
                    1 if p in (4, 5) else 2,
                    dict(depth=depth, f_levels=0, prf_method=p,
                         block_leaves=4096))
        if p == prf:
            rows["subtree_contract"] = r

    # mixed K2: the radix-4 schedule at odd depth (a binary level on top,
    # inside the block at 2^11, walked at 2^13) and even depth, frontiers
    # at eval levels 0-2, ragged batches and key tiles; then every id at
    # the full-width shape from the root
    for prf in subtree.SUBTREE_PRFS:
        for bsz_s, depth, f_lv, cb, e in (
                (3, 11, 0, 2048, 16), (1, 13, 0, 4096, 16),
                (33, 13, 1, 4096, 16), (3, 14, 0, 4096, 16),
                (33, 14, 2, 256, 16), (2, 14, 0, 4096, 16),
                (tb - 1, 14, 0, 4096, 17),
                (tb + 1, 13, 1, 1024, 33), (2 * tb + 3, 12, 0, 4096, 16)):
            ars = radix4.arities(1 << depth)
            f_cnt = int(np.prod(ars[:f_lv]))
            frs, c1s, c2s = rnd(bsz_s, f_cnt, 4), rnd(bsz_s, 64, 4), \
                rnd(bsz_s, 64, 4)
            tbls = rnd(1 << depth, e)
            kw = dict(ars=ars, f_lv=f_lv, prf_method=prf, block_leaves=cb)
            errs["subtree_contract_mixed"] |= held(
                "K2 subtree_contract_mixed prf=%d B=%d N=2^%d f_lv=%d E=%d"
                % (prf, bsz_s, depth, f_lv, e),
                subtree.subtree_contract_mixed(frs, c1s, c2s, tbls, **kw),
                subtree.subtree_contract_mixed_plain(frs, c1s, c2s, tbls,
                                                     **kw))
    ars = radix4.arities(n)
    nodes = (n - 1) // 3          # parents of a radix-4 tree, 4 children each
    # Salsa20 and ChaCha20 take four core blocks per radix-4 parent, the
    # block-PRG ids one; the row holds ChaCha20-BLK
    for p in subtree.SUBTREE_PRFS:
        r = k2_full("radix-4 " + prf_names[p],
                    subtree.subtree_contract_mixed,
                    subtree.subtree_contract_mixed_plain, n, nodes, 4,
                    1 if p in (4, 5) else 4,
                    dict(ars=ars, f_lv=0, prf_method=p, block_leaves=4096))
        if p == dpf_tpu_torch.PRF_CHACHA20_BLK:
            rows["subtree_contract_mixed"] = r
    del fr, cw1, cw2, tbl, tbl1, frs, c1s, c2s, tbls
    torch.cuda.empty_cache()

    # K5: the ChaCha20 level step, on no path; held and timed at K1's
    # widest shape so the two level kernels compare row by row
    for bsz, w in ((3, 5), (1, 1), (33, 64), (512, 1 << 17)):
        seeds, cw1, cw2 = rnd(bsz, w, 4), rnd(bsz, 64, 4), rnd(bsz, 64, 4)
        c1, c2 = cw1[:, 6:8], cw2[:, 6:8]
        errs["chacha_level_step"] |= held(
            "K5 chacha_level_step B=%d w=%d" % (bsz, w),
            subtree.chacha_level_step(seeds, c1, c2),
            subtree.chacha_level_step_plain(seeds, c1, c2))
    nodes = bsz * w
    rows["chacha_level_step"] = dict(
        ms=cuda_ms(lambda: subtree.chacha_level_step(seeds, c1, c2), 10),
        plain_ms=cuda_ms(lambda: subtree.chacha_level_step_plain(
            seeds, c1, c2), 1),
        library_ms=None,
        bytes=nodes * 16 + 2 * bsz * 2 * 16 + 2 * nodes * 16,
        ops=nodes * (2 * OPS_CORE_BLOCK + 2 * OPS_CHILD_ADD),
        shape="B=%d w=%d -> 2w (one level)" % (bsz, w))
    k5_launches = subtree.chacha_level_step.launches
    del seeds, cw1, cw2, c1, c2

    # K4: the sqrt-N grid; seeds and codewords are views of one wire
    # buffer at its key stride, as the server hands them over
    def sqrt_case(bsz, n, e=16):
        k, r = sqrtn.default_split(n)
        wire = rnd(bsz, 4 * (k + 2 * r))
        return (wire[:, :4 * k].unflatten(1, (k, 4)),
                wire[:, 4 * k:4 * (k + r)].unflatten(1, (r, 4)),
                wire[:, 4 * (k + r):].unflatten(1, (r, 4)), rnd(n, e))

    def sqrt_ops(prf, cells, e):
        per = {0: 4, 3: OPS_AES_BLOCK + OPS_AES_SCHEDULE // 4,
               4: OPS_CORE_BLOCK // 4, 5: OPS_CORE_BLOCK // 4}
        return cells * (per.get(prf, OPS_CORE_BLOCK) + 3 + 2 * e)

    for prf in range(6):
        for bsz, n, row0, rc in ((1, 1 << 11, 0, None), (3, 1 << 13, 0, None),
                                 (33, 1 << 14, 0, None), (3, 1 << 13, 64, 4)):
            seeds, cw1, cw2, tbl = sqrt_case(bsz, n)
            kw = dict(prf_method=prf, row0=row0, row_chunk=rc)
            errs["sqrt_grid_contract"] |= held(
                "K4 sqrt_grid_contract prf=%d B=%d N=2^%d row0=%d"
                % (prf, bsz, n.bit_length() - 1, row0),
                sqrt_grid.sqrt_grid_contract(seeds, cw1, cw2, tbl, **kw),
                sqrt_grid.sqrt_grid_contract_plain(seeds, cw1, cw2, tbl,
                                                   **kw))
    bsz, n = 512, 1 << 20
    seeds, cw1, cw2, tbl = sqrt_case(bsz, n)
    k, r = sqrtn.default_split(n)
    rc = sqrt_grid.sqrt_row_chunk(r, k, sqrtn.clamp_row_chunk(None, r, k,
                                                              bsz))
    sqrt_rows = {}
    for prf in (dpf_tpu_torch.PRF_CHACHA20_BLK, dpf_tpu_torch.PRF_AES128,
                dpf_tpu_torch.PRF_CHACHA20):
        kw = dict(prf_method=prf, row_chunk=rc)
        t0 = time.perf_counter()
        want = sqrt_grid.sqrt_grid_contract_plain(seeds, cw1, cw2, tbl, **kw)
        sync()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        errs["sqrt_grid_contract"] |= held(
            "K4 sqrt_grid_contract prf=%d B=512 N=2^20" % prf,
            sqrt_grid.sqrt_grid_contract(seeds, cw1, cw2, tbl, **kw), want)
        sqrt_rows[prf] = dict(
            ms=cuda_ms(lambda: sqrt_grid.sqrt_grid_contract(
                seeds, cw1, cw2, tbl, **kw), 5),
            plain_ms=plain_ms, library_ms=None,
            bytes=bsz * k * 16 + 2 * bsz * r * 16 + n * 16 * 4
            + bsz * 16 * 4,
            ops=sqrt_ops(prf, bsz * n, 16),
            lookups=bsz * n * (LOOKUPS_AES_BLOCK + LOOKUPS_AES_SCHEDULE // 4)
            if prf == dpf_tpu_torch.PRF_AES128 else None,
            shape="prf %d sqrt-N B=%d N=2^20 (K=R=%d, rc=%d) E=16"
                  % (prf, bsz, k, rc))
        log_row("sqrt_grid_contract", sqrt_rows[prf])
        del want
    # the row holds AES-128, the default PRF
    rows["sqrt_grid_contract"] = sqrt_rows[dpf_tpu_torch.PRF_AES128]
    # the same ChaCha20-BLK launch with one table column: the grid is
    # unchanged and the table traffic (read once per 8 keys, from L2)
    # falls 16x, so the difference bounds what the contraction costs
    tbl1 = tbl[:, :1].contiguous()
    kw = dict(prf_method=dpf_tpu_torch.PRF_CHACHA20_BLK, row_chunk=rc)
    errs["sqrt_grid_contract"] |= held(
        "K4 sqrt_grid_contract prf=5 B=512 N=2^20 E=1",
        sqrt_grid.sqrt_grid_contract(seeds, cw1, cw2, tbl1, **kw),
        sqrt_grid.sqrt_grid_contract_plain(seeds, cw1, cw2, tbl1, **kw))
    log("  K4 sqrt_grid_contract prf=5 B=512 N=2^20: E=1 ms %.4f, "
        "E=16 ms %.4f" % (cuda_ms(lambda: sqrt_grid.sqrt_grid_contract(
            seeds, cw1, cw2, tbl1, **kw), 5),
            sqrt_rows[dpf_tpu_torch.PRF_CHACHA20_BLK]["ms"]))
    del seeds, cw1, cw2, tbl, tbl1
    torch.cuda.empty_cache()

    for name, r in rows.items():
        log_row(name, r)

    # ---------------------------------------- the main paths: 3 + 4 + 5
    # kernel name -> the wrapper that counts its launches
    counters = {
        "aes_level_step": aes_level.aes_level_step,
        "aes_level_step_a4": aes_level.aes_level_step,
        "subtree_contract": subtree.subtree_contract,
        "subtree_contract_mixed": subtree.subtree_contract_mixed,
        "contract_i32": matmul128.dot_i32,
        "sqrt_grid_contract": sqrt_grid.sqrt_grid_contract,
        "chacha_level_step": subtree.chacha_level_step}

    def count_attr(name):
        return "launches_a4" if name == "aes_level_step_a4" else "launches"

    def read_counts():
        return {k: getattr(fn, count_attr(k)) for k, fn in counters.items()}

    def zero_counts():
        for k, fn in counters.items():
            setattr(fn, count_attr(k), 0)

    n3 = 16384
    table3 = rng.integers(0, 2 ** 31, (n3, 16), dtype=np.int64).astype(
        np.int32)

    def sample_flow(radix, n, prfs=range(6), scheme="logn"):
        """Phase 3: two servers answer 8 indices for each PRF id; exact
        rows, shares equal to eval_cpu."""
        table = table3[:n]
        idx = [int(i) for i in rng.choice(n, 8, replace=False)]
        cfg = EvalConfig(radix=radix, scheme=scheme)
        label = "sqrt-N " if scheme == "sqrtn" else "radix %d" % radix
        for prf in prfs:
            client = DPF(prf=prf, config=cfg, device="cpu")
            pairs = [client.gen(i, n, seed=b"smoke-%d-%d" % (prf, i))
                     for i in idx]
            server_a = DPF(prf=prf, config=cfg)
            server_b = DPF(prf=prf, config=cfg)
            server_a.eval_init(table)
            server_b.eval_init(table)
            t0 = time.perf_counter()
            sa = server_a.eval_gpu([p[0] for p in pairs])
            sb = server_b.eval_gpu([p[1] for p in pairs])
            sync()
            dt = time.perf_counter() - t0
            ua = sa.cpu().numpy().view(np.uint32)
            ub = sb.cpu().numpy().view(np.uint32)
            rec = (ua - ub).view(np.int32)
            if not (rec == table[idx]).all():
                raise AssertionError("%s N=%d prf %d: recovered rows "
                                     "differ" % (label, n, prf))
            keys_a = [p[0] for p in pairs]
            oracle = server_a.eval_cpu(keys_a).numpy()
            if not (oracle == sa.cpu().numpy()).all():
                raise AssertionError("%s N=%d prf %d: GPU shares "
                                     "differ from eval_cpu" % (label, n, prf))
            hot = server_a.eval_cpu(keys_a, one_hot_only=True).numpy()
            if not ((server_a.eval_one_hot(keys_a).cpu().numpy() == hot).all()
                    and (server_a.eval_points(keys_a, idx).cpu().numpy()
                         == hot[:, idx]).all()):
                raise AssertionError("%s N=%d prf %d: one-hot or point "
                                     "shares on the card differ from "
                                     "eval_cpu" % (label, n, prf))
            log("  %s N=%-6d prf %d %-12s 8 rows recovered exactly, "
                "shares, one-hot and points == eval_cpu (both servers "
                "%.1f ms)" % (label, n, prf, server_a.prf_method_string,
                              1e3 * dt))

    per_batch = {}

    def full_width(radix, prf, n4, reps, scheme="logn"):
        """Phase 4 through the user's entry points, a distinct key in
        every row; launches per batch from the counts of this
        configuration alone."""
        before = read_counts()
        r = test_dpf_perf(N=n4, batch=512, entrysize=16, prf=prf, reps=reps,
                          check=True, quiet=True,
                          config=EvalConfig(radix=radix, scheme=scheme))
        batches = 3 + reps           # check (two servers), warm-up, reps
        tree = "sqrtn" if scheme == "sqrtn" else "radix-%d" % radix
        key = "%s %s N=%d" % (r["prf"], tree, n4)
        per_batch[key] = {k: (v - before[k]) / batches
                          for k, v in read_counts().items()
                          if v != before[k]}
        log("  %-8s %s N=%-8d E=16 B=512 (%d distinct keys, %s keygen "
            "%.3f s on the host): %.1f dpfs/s (%.2f ms/batch, recovery "
            "exact) on %s"
            % (r["prf"], tree, n4, r["keys_distinct"], r["keygen"],
               r["keygen_s"], r["dpfs_per_sec"], r["ms_per_batch"], smi))
        log("    launches per batch: %s" % per_batch[key])
        log("  " + json.dumps(r))

    path_kernels = {
        "binary": ("aes_level_step", "subtree_contract", "contract_i32"),
        "radix4": ("aes_level_step", "aes_level_step_a4",
                   "subtree_contract_mixed", "contract_i32"),
        "sqrtn": ("sqrt_grid_contract",)}
    by_path = {}

    # the binary path
    zero_counts()
    log("phase 3 binary sample flow, N=16384 E=16, 8 indices, PRF ids 0-5")
    sample_flow(2, n3)
    from dpf_tpu_torch import sample
    sample.client()
    log("phase 4 binary full width (512 distinct key pairs, every row "
        "checked)")
    for prf, n4, reps in ((dpf_tpu_torch.PRF_AES128, 1 << 20, 3),
                          (dpf_tpu_torch.PRF_CHACHA20, 1 << 20, 5),
                          (dpf_tpu_torch.PRF_AES128, 65536, 10)):
        full_width(2, prf, n4, reps)
    by_path["binary"] = read_counts()

    # the radix-4 path
    zero_counts()
    log("phase 3 radix-4 sample flow, N=16384 and N=8192 (odd depth), "
        "E=16, 8 indices, PRF ids 0-5")
    sample_flow(4, n3)
    sample_flow(4, n3 // 2)
    log("phase 4 radix-4 full width (512 distinct key pairs, every row "
        "checked)")
    for prf, n4, reps in ((dpf_tpu_torch.PRF_AES128, 1 << 20, 3),
                          (dpf_tpu_torch.PRF_CHACHA20_BLK, 1 << 20, 5),
                          (dpf_tpu_torch.PRF_AES128, 65536, 10)):
        full_width(4, prf, n4, reps)
    by_path["radix4"] = read_counts()

    # the sqrt-N path
    zero_counts()
    log("phase 3 sqrt-N sample flow, N=16384 (K=R=128) and N=8192 (K=128, "
        "R=64), E=16, 8 indices, PRF ids 0-5")
    sample_flow(2, n3, scheme="sqrtn")
    sample_flow(2, n3 // 2, scheme="sqrtn")
    log("phase 4 sqrt-N full width (512 distinct key pairs, every row "
        "checked)")
    for prf, n4, reps in ((dpf_tpu_torch.PRF_AES128, 1 << 20, 3),
                          (dpf_tpu_torch.PRF_CHACHA20_BLK, 1 << 20, 5),
                          (dpf_tpu_torch.PRF_AES128, 65536, 10)):
        full_width(2, prf, n4, reps, scheme="sqrtn")
    by_path["sqrtn"] = read_counts()

    # 5. launch counts of each path
    for path, counts in by_path.items():
        log("phase 5 launches during the %s path (phases 3-4): %s"
            % (path, counts))
        for k in path_kernels[path]:
            if counts[k] <= 0:
                raise AssertionError("kernel %s was never launched on the "
                                     "%s path" % (k, path))
    others = {k: v for k, v in by_path["sqrtn"].items()
              if k != "sqrt_grid_contract" and v}
    if others:
        raise AssertionError("the sqrt-N path launched %s" % others)
    for key, counts in per_batch.items():
        if " sqrtn " in key and counts != {"sqrt_grid_contract": 1.0}:
            raise AssertionError("%s: launches per batch %s, not one K4"
                                 % (key, counts))

    # K1 per 512-key batch: device time summed over a batch's launches
    # (torch.profiler, one warm batch) beside the bound and lookup floor
    # of the same work.  A batch expands every inner node of each key's
    # tree once: B (N - 1) binary nodes, B (N - 1) / 3 radix-4 nodes.
    for name, radix, arity, ops in (
            ("aes_level_step", 2, 2, OPS_AES_NODE),
            ("aes_level_step_a4", 4, 4, OPS_AES_NODE_A4)):
        n = 1 << 20
        prof = profile_batch.profile_config(dpf_tpu_torch.PRF_AES128, n,
                                            radix)
        k1 = [v for k, v in prof["kernels"].items() if "aes_level_kernel" in k]
        if not k1:
            raise AssertionError("no K1 device time recorded for a radix-%d "
                                 "batch: %s" % (radix, prof["note"]))
        nodes = 512 * (n - 1) // (arity - 1)
        leaves = 512 * n          # written by the low-limb form, 4 bytes
        launches = sum(v["count"] for v in k1)
        work = dict(bytes=nodes * 16 + (nodes * arity - leaves) * 16
                    + leaves * 4 + launches * 2 * 512 * arity * 16,
                    ops=nodes * ops - leaves * OPS_AES_LOW_SAVED,
                    lookups=nodes * (LOOKUPS_AES_SCHEDULE
                                     + arity * LOOKUPS_AES_BLOCK)
                    - leaves * LOOKUPS_AES_LOW_SAVED)
        b_ms, _, floor_ms = bound(work)
        rows[name].update(batch_ms=sum(v["ms"] for v in k1),
                          batch_launches=launches, batch_bound_ms=b_ms,
                          batch_lookup_floor_ms=floor_ms)
        log("  %s per radix-%d AES batch at N=2^20: %d launches, device "
            "ms %.4f, bound_ms %.4f, lookup_floor_ms %.4f (batch wall ms "
            "%.2f)" % (name, radix, launches, rows[name]["batch_ms"], b_ms,
                       floor_ms, prof["wall_ms"]))
        # K3 on the same batch: B x N low limbs, the table, and the output
        # once a launch (4 groups of [512, 2^18] at N = 2^20)
        k3 = [v for k, v in prof["kernels"].items() if "contract_kernel" in k]
        if not k3:
            raise AssertionError("no K3 device time recorded for a radix-%d "
                                 "batch" % radix)
        k3_launches = sum(v["count"] for v in k3)
        k3_ms = sum(v["ms"] for v in k3)
        k3_bound = bound(dict(bytes=512 * n * 4 + n * 16 * 4
                              + k3_launches * 512 * 16 * 4,
                              ops=2 * 512 * n * 16))[0]
        suffix = "" if radix == 2 else "_radix4"
        rows["contract_i32"].update({
            "batch_ms" + suffix: k3_ms,
            "batch_launches" + suffix: k3_launches,
            "batch_bound_ms" + suffix: k3_bound})
        log("  contract_i32 per radix-%d AES batch at N=2^20: %d launches, "
            "device ms %.4f, bound_ms %.4f"
            % (radix, k3_launches, k3_ms, k3_bound))

    # ------------------------------------------------------ 6. harness
    t6 = time.perf_counter()
    zero_counts()
    log("phase 6.1 the reference's sweep (binary, B=512 distinct keys, "
        "E=16, every row checked; P100 / V100: upstream GPU-DPF's "
        "published dpfs/s, BASELINE.md, an outside yardstick)")
    sweep = benchmark.run_sweep(reps=5, quiet=True)
    if len(sweep) != 12 or not all(r["checked"] for r in sweep):
        raise AssertionError("the sweep gave %d rows" % len(sweep))
    for r in sweep:
        y = r["yardstick_dpfs_per_sec"]
        log("  N=%-8d %-8s %12.1f dpfs/s %9.3f ms/batch  keygen %s %.3f s"
            "  (P100 %d, V100 %d) on %s"
            % (r["entries"], r["prf"], r["dpfs_per_sec"], r["ms_per_batch"],
               r["keygen"], r["keygen_s"], y["P100"], y["V100"], smi))
        log("  " + json.dumps(r))
    log("phase 6.2 single-query latency (one key, one dispatch, "
        "synchronised; recovery checked)")
    latency = []
    for prf, n6, radix, scheme in (
            (dpf_tpu_torch.PRF_AES128, 65536, 2, "logn"),
            (dpf_tpu_torch.PRF_AES128, 65536, 4, "logn"),
            (dpf_tpu_torch.PRF_AES128, 65536, 2, "sqrtn"),
            (dpf_tpu_torch.PRF_AES128, 1 << 20, 2, "logn"),
            (dpf_tpu_torch.PRF_AES128, 1 << 20, 4, "logn"),
            (dpf_tpu_torch.PRF_AES128, 1 << 20, 2, "sqrtn"),
            (dpf_tpu_torch.PRF_CHACHA20, 1 << 20, 2, "logn")):
        r = test_dpf_latency(N=n6, prf=prf, reps=20, quiet=True,
                             config=EvalConfig(radix=radix, scheme=scheme))
        latency.append(r)
        log("  %-8s %s radix %d N=%-8d %.3f ms a query on %s"
            % (r["prf"], r["scheme"], r["radix"], n6, r["latency_ms"], smi))
    by_path["phase 6"] = read_counts()
    log("phase 6 launches during 6.1-6.2: %s" % by_path["phase 6"])
    for k in ("aes_level_step", "aes_level_step_a4", "subtree_contract",
              "contract_i32", "sqrt_grid_contract"):
        if by_path["phase 6"][k] <= 0:
            raise AssertionError("kernel %s was never launched in phase 6"
                                 % k)
    log("phase 6.3 the contraction alone (test_matmul_perf)")
    matmul_rows = []
    for bsz, k, e in ((512, 65536, 16), (8, 256, 4)):
        for r in test_matmul_perf(B=bsz, K=k, E=e, reps=10,
                                  quiet=True).values():
            if not r["gops_per_sec"] > 0:
                raise AssertionError("matmul rate %r" % r)
            matmul_rows.append(r)
            log("  %-4s [%d, %d] x [%d, %d]: %.3f ms a call, %.2f Gop/s "
                "(bit-equal to the plain version) on %s"
                % (r["impl"], bsz, k, k, e, 1e3 * r["elapsed_s"] / r["reps"],
                   r["gops_per_sec"], smi))
    log("phase 6.4 host keygen, B=512 distinct keys, N=2^20")
    keygen_rows = []
    idx = [(i * 0x9E3779B1) % (1 << 20) for i in range(512)]
    for prf in (dpf_tpu_torch.PRF_AES128, dpf_tpu_torch.PRF_CHACHA20):
        for label, cfg in (("binary", EvalConfig()),
                           ("radix-4", EvalConfig(radix=4)),
                           ("sqrt-N", EvalConfig(scheme="sqrtn"))):
            client = DPF(prf=prf, config=cfg)
            t0 = time.perf_counter()
            wa, wb = client.gen_batch(idx, 1 << 20)
            dt = time.perf_counter() - t0
            keygen_rows.append(dict(prf=prf, construction=label, seconds=dt,
                                    keys_per_s=512 / dt))
            if wa.shape[0] != 512 or wa.shape != wb.shape:
                raise AssertionError("gen_batch shapes %s, %s"
                                     % (tuple(wa.shape), tuple(wb.shape)))
            gen_name = ("native" if label == "binary" else "vectorized")
            log("  prf %d %-8s %-10s %.3f s, %.1f keys/s on the host"
                % (prf, label, gen_name, dt, 512 / dt))
            if label == "binary":
                t0 = time.perf_counter()
                keygen.gen_batched(idx, 1 << 20, [b"k%d" % i for i in idx],
                                   prf_method=prf)
                dt = time.perf_counter() - t0
                keygen_rows.append(dict(prf=prf, construction="binary "
                                        "vectorized", seconds=dt,
                                        keys_per_s=512 / dt))
                log("  prf %d %-8s %-10s %.3f s, %.1f keys/s on the host"
                    % (prf, label, "vectorized", dt, 512 / dt))
    log("phase 6: %.1f s" % (time.perf_counter() - t6))
    log(json.dumps({"phase6": {"sweep": sweep, "latency": latency,
                               "matmul": matmul_rows,
                               "keygen": keygen_rows}}))

    meta = {
        "aes_level_step": ("dpf_tpu_torch/csrc/aes_level.cu",
                           "dpf_tpu/ops/aes_planes.py:408"),
        "aes_level_step_a4": ("dpf_tpu_torch/csrc/aes_level.cu",
                              "dpf_tpu/ops/aes_planes.py:408"),
        "subtree_contract": ("dpf_tpu_torch/csrc/subtree.cu",
                             "dpf_tpu/ops/pallas_level.py:402"),
        "subtree_contract_mixed": ("dpf_tpu_torch/csrc/subtree.cu",
                                   "dpf_tpu/ops/pallas_level.py:442"),
        "contract_i32": ("dpf_tpu_torch/csrc/contract.cu",
                         "dpf_tpu/ops/matmul128.py:29"),
        "sqrt_grid_contract": ("dpf_tpu_torch/csrc/sqrt_grid.cu",
                               "dpf_tpu/ops/pallas_sqrt.py:312"),
        "chacha_level_step": ("dpf_tpu_torch/csrc/chacha_level.cu",
                              "dpf_tpu/ops/pallas_level.py:251"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = rows[name]
        launches = {p: c[name] for p, c in by_path.items() if c[name]}
        if name == "chacha_level_step":
            # on no path: its launches are phase 2's
            launches = {"phase 2": k5_launches}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": errs[name], "matched": errs[name] == 0,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "lookup_floor_ms": r["lookup_floor_ms"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            **{k: v for k, v in r.items() if k not in (
                "ms", "plain_ms", "bound_ms", "bound_by", "lookup_floor_ms",
                "library_ms", "shape", "bytes", "ops", "lookups")},
            **({"sass_per_node": sass["arity %d" % (4 if "a4" in name
                                                    else 2)]}
               if sass and name.startswith("aes_level") else {})})
    log(json.dumps({"launches_per_batch": per_batch}))
    log(json.dumps({"k2_full_width": k2_rows, "k2_sass": sass_k2}))
    log(json.dumps({"k3": k3_rows}))
    log("chip_smoke: %.1f s" % (time.perf_counter() - t_start))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
