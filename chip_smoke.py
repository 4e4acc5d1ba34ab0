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
   strided low limbs of 16-byte leaves (a form no path hands it since
   every group's last level keeps a contiguous plane), at
   [512, 2^16] and [512, 2^18], each with the bytes its sectors move;
   K2's eight instances (PRF ids 1, 2, 4, 5 over
   the binary and the radix-4 tree) at full width, each also at E = 1
   (the same expansion, a sixteenth of the contraction); K2's
   leaf-range form (``subtree_contract_window``, phase 12's shards and
   granules: the first block subtree and a count are launch arguments)
   on ranges of 80 and 7 blocks at ragged batches, and on the 4-way
   table mesh's second shard at N = 2^20 (2^18 rows, B = 512, binary
   ChaCha20 and radix-4 ChaCha20-BLK) held and timed with its bound and
   pipe bound (the ``k2_window`` line); the ChaCha
   level step (the dispatch mode's ChaCha20 level) at K1's widest shape;
   beside each bound, the
   AES kernels' lookup floor (their shared-memory table lookups at one
   warp-wide lookup per SM per clock) and K2's pipe bound (its cipher
   cores' xors and rotations on the INT32 pipe, its products on the FMA
   pipe, each at half the issue rate); then the per-key-table forms of
   batch-PIR (phase 9): K6 ``contract_i32_per_key`` at small, ragged,
   strided and row-chunk shapes and at phase 9's group of G = 256 bins
   of n = 4096 rows, E = 16 (``torch.bmm`` on int32 CUDA tensors probed
   as the library yardstick and its error printed); the per-key kernels
   of K2 (every stream-cipher id, both trees) and K4 (every id) at
   ragged G = 1, 3, 5, 255, 257, small n and E = 16, 3, 1; then the
   sweep of one 2^20 x 16 table cut into bins, (G, n) = (256, 4096),
   (16, 65536) and (1024, 1024): K2 per-key for binary ChaCha20, radix-4
   ChaCha20 and radix-4 ChaCha20-BLK, K4 per-key for AES-128, ChaCha20
   and ChaCha20-BLK, each at the geometry its wrapper picks, with its
   bound, its tighter limit (K2's pipe bound, K4 AES's lookup floor)
   and the share of it reached; the per-key rows' ms is device time
   under ``torch.profiler`` (CUDA events around a wrapper of tens of
   microseconds time the host's enqueue rate; K6 prints those beside
   it as ``events_ms``);
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
7. serving (``dpf_tpu_torch.serve``), each part's counts set to 0 just
   before it and read just after, at N = 2^20, E = 16, cap 512: (1) the
   ``ServingEngine`` (max_in_flight 2, pinned key staging, one CUDA
   event a part) against the blocking loop for binary, radix-4 and
   sqrt-N AES-128 and binary ChaCha20, ragged batches 512, 300, 17, 512,
   129, 1 and 1,100 of distinct ``gen_batch`` keys, every row bit-equal
   to ``eval_gpu``'s and two servers' engines recovering the table rows;
   (2) the per-level dispatch mode (``kernel_impl="dispatch"``: K1, K5
   for ChaCha20, K3) for binary AES and ChaCha20 and radix-4 AES, bit-equal
   to the fused path, a past ``dispatch_deadline`` raising
   ``DeadlineExceeded`` and the next submit exact; (3) 64 batches of
   512 at N = 65536 and 2^20 (binary AES) through the blocking loop and
   the engine at max_in_flight 1, 2, 4: dpfs/s, the engine's pack /
   dispatch / wait host ms a batch and the device busy share
   (``torch.profiler``); (4) ``bench_load.load_bench`` over the three
   AES constructions (a ``SchemeRouter`` with probe-seeded costs): a
   bursty open-loop trace whose ON windows keep the sticky engine busy
   1.5 of the time and its OFF windows 0.3 (by its probed per-bucket
   costs), sticky, router and shed
   (slo 250 ms, max_queue_depth 8, a client window of 64 so that the
   depth bound can trip) legs of about 6 s, qps, p50 / p99
   and sheds, every served batch gated against ``eval_cpu`` with 0
   rejections.
8. tables and tenants (``serve.registry``, ``serve.tenant``, the chaos
   and multitenant benches), AES-128 in the three constructions, each
   part's counts set to 0 just before it and read just after: (1) a
   ``TableRegistry`` with a budget of two versions of A (2^20 x 16 in
   three layouts, 192 MiB), registering A twice, B (2^18 x 8) and C
   (2^16 x 4): every promotion and demotion must move
   ``torch.cuda.memory_allocated()`` by the version's bytes and the
   bytes live above the registry's base must equal its resident-bytes
   gauge after every step; A's shares on 512 distinct keys in each
   construction equal after a demotion and re-promotion (the promotion's
   ms printed); a ``GranuleStore`` over A's permuted layout in 2^16-row
   granules with a budget of 4 must show misses, evictions and a
   deferred demotion, its leased granules equal to the host slices;
   (2) ``bench_chaos.chaos_bench`` at N = 2^20, cap 512: baseline,
   faults (12% dispatch errors, stragglers, 3% corrupted shares) and
   chaos (+ the favourite's death) legs of 3 s, with 0 gate escapes,
   every corruption detected, and the chaos leg failing over and
   rebuilding; availability, p50 / p99, retries, failovers and breaker
   walks printed; (3) ``bench_multitenant.multitenant_bench`` with four
   tenants (2^20 x 16 cap 512, 2^18 x 8 cap 256, a 2^16 x 4 victim cap
   128, and one sharing the first table): solo, combined, cold-table
   (the combined traces again with the first table demoted, so its
   promotion runs under load) and noisy-neighbour legs of 2.5 s, 0 gate
   escapes and every tenant's
   label in the record's metrics (raised), the isolation verdict
   (availability, p99 against 1.5 x solo + the slack derived from the
   probed top-bucket cost) printed as measured.  The CPU oracle's keys
   are few (2 a construction and table): ``eval_cpu`` costs ~2 s a
   radix-4 or sqrt-N key at 2^20.
9. batch-PIR (``apps.batch_pir``, ``serve.bench_pir``), its counts set
   to 0 before and read after: a 2^20 x 16 table planned into 256 bins
   of 4096 rows (``HotColdConfig(1.0)``, ``CollocateConfig(0)``,
   ``PIRConfig(bin_fraction=1/256)``), each server holding one
   ``[256, 4096, 16]`` stack of per-key tables; for the binary, radix-4
   and sqrt-N constructions with AES-128 and with ChaCha20: one round
   through ``answer`` on two servers, equal to ``answer_scalar``, every
   planned row recovered exactly (then one server's warm round timed,
   best of 3) and the same warm round split into its stages (packed
   decode, staging copy, the group's program on the host, the wait for
   the card, download, the Python rest, with the upload's and the
   kernels' device time from CUDA events; ``answer_split``), then 6
   rounds through ``LookupStream`` equal to ``answer`` and recovered
   exactly (bin-queries/s printed);
   then ``bench_pir.pir_point`` at 2^20 and ``pir_bench``'s default
   points, their records printed.  K1, K6 and the per-key modes of K2
   and K4 must have been launched, and no shared-table K2, K3 or K4.
10. the workload models, the bitsliced AES and the PRF zoo
   (``models_zoo_phase``): (1) ``models.rec`` and ``models.lm`` trained
   with ``device=None`` at the datasets' and models' defaults (2,000
   items, 400 users x 6 samples, 16 dimensions, 64 hidden, 3 epochs;
   vocabulary 1,000, sequence 32, 300 / 60 sequences, 32 dimensions, 64
   hidden, 2 epochs), train seconds, steps/s and
   ``torch.cuda.max_memory_allocated`` printed; ``evaluate_with_pir``
   with no plan and with a ``BatchPIROptimize`` plan
   (``PIRConfig(bin_fraction=0.02, queries_to_hot=q)``) at q = 0 and 8,
   raising unless the rec AUC is > 0.55, AUC(q=8) > AUC(q=0) and the
   LM's masked perplexity >= 0.9 x the unmasked one; a two-point
   ``sweep.run_sweep(model_eval=...)``; a checkpoint round trip; one
   set of weights on the card and the CPU, logits and one Adam step
   within 1e-4 with cuDNN's TF32 off (the difference with it on
   printed beside); no kernel launched; (2) ``aes128_multi_bitsliced``
   on 512 x 1024 seeds at n_pts 2 and 4 with each S-box circuit,
   bit-equal to K1 (zero codewords) and the gather AES, timed beside
   them; (3) K7 for each of the 15 candidates at n = 1, 33, 1000 and
   2^20 bit-equal to the plain cores, then ``benchmark_zoo`` at 2^20
   calls and 5 repetitions, its counts set to 0 before and read after
   (K7 and nothing else launched): children/s (``dpf_tpu``'s metric,
   the wrapper's host work included), the kernel's device time under
   ``torch.profiler`` and the bound (bytes over 3.35 TB/s or the
   instructions ``ops/prf_zoo.ops_per_call`` counts from the function
   as the card executes it, LOP3, IADD3 and LEA.HI fused, over the
   issue rate)
   per candidate; the count must not exceed the instructions of K7's
   own loop (``utils/sass_count.k7_counts``), nor the bound the
   kernel's time.
11. tuning and the trace (``tuning_phase``; the script points the
   port's tuning cache, ``DPF_TPU_TORCH_TUNE_CACHE``, at a fresh
   temporary file before it imports the port, so phases 1-10 resolve
   every knob from the heuristics), each part's counts set to 0 just
   before it and read just after: (1) ``tune.search.tune_eval`` at
   N = 2^20, E = 16, B = 512 for binary AES-128 (K1 + K3), radix-4
   ChaCha20-BLK (mixed K2's block; its dispatch route runs plain level
   steps, so its search is the block alone) and sqrt-N AES-128 (K4's
   grid step), every timed candidate equal to ``eval_cpu``'s shares
   first (few distinct keys for the radix-4 and sqrt-N oracles, ~2 s a
   key on the host), a second ``tune_eval`` answering from the cache;
   (2) ``kernel_search_ggm`` for binary ChaCha20 (2 generations x 4);
   (3) ``keygen_search`` for the binary generator (host work); (4)
   ``tune_serving`` at 65536 cap 512, ``warmup(tune=True)`` taking its
   ladder, and ``tune_router`` at ``dpf_tpu``'s load-bench point
   (4096 x 16, cap 128); (5) ``obs.bench_trace`` at its defaults, its
   gates raised on; (6) fresh all-auto servers of each tuned shape
   resolving ``tuned`` (``searched`` for binary ChaCha20) from the
   cache, with tuning-cache hits, two of them recovering every row of
   a fresh 512-key batch.  Each tuned shape prints the heuristic's and
   the winner's ms, candidates tried and rejected and gate escapes
   beside the card's name and power limit.
12. multi-GPU and the cluster tier (``mesh_cluster_phase``), each part's
   counts set to 0 just before it and read just after, N = 2^20, E = 16,
   512 distinct keys, every mesh and host on the one card: (1)
   ``ShardedDPFServer`` through ``DPF.sharded_server`` on a 1 x 4 table
   mesh, a 2 x 2 batch x table mesh and a 1 x 2 x 2 rows x bytes mesh
   (binary tree only), each of ``cuda:0`` repeated, for binary AES-128
   and ChaCha20, radix-4 AES-128 and ChaCha20-BLK, sqrt-N AES-128 and
   ChaCha20, ``psum_group`` 0 and 4: every share equal to the one
   device's ``eval_gpu``, both servers' shares recovering the rows, the
   1 x 4 mesh's ms a batch beside the one device's (host clock to a
   synchronise, median of 3; no gain claimed); (2) two processes of
   ``python -m dpf_tpu_torch.parallel.multihost`` on the card (gloo:
   NCCL refuses two ranks on one GPU) as a 1 x 2 table mesh, binary
   ChaCha20, their shares equal to the one device's, their launches
   reported by each rank; (3) the cluster, binary AES-128:
   ``ClusterRouter.local`` with 2 hosts; 4 hosts with an injected
   ``host_drop`` answered by reshard and by degrade; two
   ``spawn_cluster`` workers sharing the card (their launches read from
   their ``stats``), one killed and resharded; a paged
   ``ClusterShardServer`` (two granules, a budget of one) whose
   ``torch.cuda.memory_allocated`` moves by exactly one granule; every
   answer equal to the one device's; (4) ``tune_mesh_eval`` for binary
   ChaCha20 on the 1 x 4 mesh (0 rejected, 0 gate escapes), then a
   short ``bench_multichip`` (65536 x 16, two entries of the card) and
   ``bench_multihost`` (65536 x 16, two worker processes, AES-128).
13. the last modules (``last_modules_phase``), each part's counts set to
   0 just before it and read just after: (1) batch-PIR on meshes of the
   card repeated: phase 9's table (2^20 x 16 in 256 bins of 4096) on a
   1 x 4 and a 2 x 2 mesh, the three constructions x AES-128 and
   ChaCha20, every meshed ``answer`` equal to the one-device server's,
   two meshed servers recovering every planned row, the per-key kernel
   (K6 after K1 for AES) launched once an entry and group and no
   shared-table K2, K3 or K4, 6 rounds through the 1 x 4 mesh's
   ``LookupStream`` equal to ``answer``, the warm round's ms beside the
   one device's (no gain claimed); then 2^16 x 16 in 37 bins, a group
   that zero bins pad to 40; (2) planning: ``device_memory_stats``
   (``bytes_limit`` = ``mem_get_info``'s total) and
   ``detect_hbm_budget`` on the card, ``plan.bench_plan.plan_bench`` at
   2^20 x 16, cap 512, AES-128, key pools of 8, its ON windows keeping
   the sticky engine 1.5 busy by its probed costs, 4 s traces and one
   rep (0 gate rejections, a monotone planner and the real-engine
   autoscale leg raised on; the twin's fidelity and autoscale verdicts
   printed as measured), and ``plan_fleet`` for 10^9 rows x 16 words at
   the card's own budget; (3) ``serve.bench_bigtable.bigtable_bench`` at
   2^20 x 16, cap 512, AES-128: 2 hosts x 4 granules of 8 MiB under a
   budget of 2 (0 gate escapes, misses on every store, and
   ``memory_allocated`` moving by 0 while the paged hosts are built and
   by exactly the held granules when they demote, all raised on; the
   prefetch race's p99 verdict printed as measured), the 2D mesh leg on
   ``cuda:0`` repeated; (4) ``python -m dpf_tpu_torch.benchmark --plan
   --dryrun`` and ``--bigtable --dryrun`` in two processes at once,
   each exiting 0.

The last lines are the card's name and power limit, one
``{"kernels": [...]}`` line, and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the package beside it, the script
fails before printing any result.  It imports nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
# K1 runs rounds 1 and 2 once a node for what its A plaintexts share
# (csrc/aes_ttable.cuh::aes128_encrypt_byte0): for each plaintext after
# the first, 15 lookups of round 1 and 12 of round 2 fewer, and their
# permutes (K4 keeps 160 lookups a block)
LOOKUPS_AES_SHARED_SAVED = 15 + 12
OPS_AES_SHARED_SAVED = 2 * LOOKUPS_AES_SHARED_SAVED


def k1_node_work(arity):
    """Operations and table lookups of one K1 node at arity 2 or 4."""
    ops = OPS_AES_NODE if arity == 2 else OPS_AES_NODE_A4
    return (ops - (arity - 1) * OPS_AES_SHARED_SAVED,
            LOOKUPS_AES_SCHEDULE + arity * LOOKUPS_AES_BLOCK
            - (arity - 1) * LOOKUPS_AES_SHARED_SAVED)

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


def launch_counters():
    """The read / zero helpers over every kernel wrapper's launch
    counter (``ops.LAUNCH_COUNTERS``)."""
    from dpf_tpu_torch.ops import launch_counts, zero_launch_counts
    return launch_counts, zero_launch_counts


def serving_phase(smi, read_counts, zero_counts, n=1 << 20,
                  device=None) -> tuple:
    """Phase 7 at table size ``n`` (the overlap part also at n / 16) on
    ``device`` (None = the card; the CPU rehearses it at a small n);
    returns ({part: launch counts}, the phase's records)."""
    import numpy as np

    from dpf_tpu_torch import DPF, EvalConfig
    from dpf_tpu_torch.core.expand import DeadlineExceeded
    from dpf_tpu_torch.serve import bench_load, bench_serve

    cap = 512
    table = np.random.default_rng(7).integers(
        0, 2 ** 31, (n, 16), dtype=np.int64).astype(np.int32)
    by_part, records = {}, {}
    aes, chacha = DPF.PRF_AES128, DPF.PRF_CHACHA20

    def servers(prf, cfg, count=2):
        out = []
        for _ in range(count):
            d = DPF(prf=prf, config=cfg, device=device)
            d.eval_init(table)
            out.append(d)
        return out

    # 7.1 the engine against the blocking loop
    t0 = time.perf_counter()
    zero_counts()
    sizes = (512, 300, 17, 512, 129, 1, 1100)
    log("phase 7.1 engine (max_in_flight 2) against the blocking loop, "
        "N=%d E=16 cap 512, batches %s of distinct keys" % (n, sizes))
    for label, prf, cfg in (
            ("binary AES-128", aes, EvalConfig()),
            ("radix-4 AES-128", aes, EvalConfig(radix=4)),
            ("sqrt-N AES-128", aes, EvalConfig(scheme="sqrtn")),
            ("binary ChaCha20", chacha, EvalConfig())):
        sa, sb = servers(prf, cfg)
        idx = np.array([(i * 0x9E3779B1) % n for i in range(max(sizes))])
        wa, wb = sa.gen_batch(idx, n)
        ea = sa.serving_engine(max_in_flight=2, warmup=True)
        eb = sb.serving_engine(max_in_flight=2, warmup=True)
        batches = [np.arange(j * 97, j * 97 + b) % len(idx)
                   for j, b in enumerate(sizes)]
        t1 = time.perf_counter()
        fa = [ea.submit(wa[r]) for r in batches]
        fb = [eb.submit(wb[r]) for r in batches]
        outs = [(x.result(), y.result()) for x, y in zip(fa, fb)]
        dt = time.perf_counter() - t1
        for r, (oa, ob) in zip(batches, outs):
            if not np.array_equal(oa, sa.eval_gpu(wa[r]).cpu().numpy()):
                raise AssertionError("%s: engine rows differ from "
                                     "eval_gpu's (batch %d)" % (label, len(r)))
            rec = (oa.view(np.uint32) - ob.view(np.uint32)).view(np.int32)
            if not (rec == table[idx[r]]).all():
                raise AssertionError("%s: recovered rows differ (batch %d)"
                                     % (label, len(r)))
        st = ea.stats.as_dict()
        log("  %-16s %d batches, %d rows == eval_gpu, rows recovered "
            "exactly; both engines %.1f ms; dispatches %d, in-flight hwm "
            "%d, pad waste %.3f" % (label, len(sizes), sum(sizes), 1e3 * dt,
                                    st["dispatches"], st["in_flight_hwm"],
                                    st["pad_waste"]))
        del sa, sb, ea, eb
    torch.cuda.empty_cache()
    by_part["7.1 engine"] = read_counts()

    # 7.2 the per-level dispatch mode
    zero_counts()
    log("phase 7.2 dispatch mode (kernel_impl='dispatch') against the "
        "fused path, N=%d" % n)
    for label, prf, radix in (("binary AES-128", aes, 2),
                              ("binary ChaCha20", chacha, 2),
                              ("radix-4 AES-128", aes, 4)):
        fused = servers(prf, EvalConfig(radix=radix), 1)[0]
        disp = servers(prf, EvalConfig(radix=radix, kernel_impl="dispatch"),
                       1)[0]
        idx = np.array([(i * 0x9E3779B1) % n for i in range(cap)])
        keys = fused.gen_batch(idx, n)[0]
        engine = disp.serving_engine(max_in_flight=2, warmup=True)
        want = fused.eval_gpu(keys).cpu().numpy()
        t1 = time.perf_counter()
        got = [engine.submit(keys), engine.submit(keys[:129])]
        got = [f.result() for f in got]
        dt = time.perf_counter() - t1
        if not (np.array_equal(got[0], want)
                and np.array_equal(got[1], want[:129])):
            raise AssertionError("%s: dispatch-mode shares differ from the "
                                 "fused path's" % label)
        disp.dispatch_deadline = time.monotonic() - 1.0
        try:
            engine.submit(keys)
        except DeadlineExceeded:
            pass
        else:
            raise AssertionError("%s: a past deadline did not raise" % label)
        if engine.stats.deadline_misses != 1 or engine.in_flight:
            raise AssertionError("%s: window or counters inconsistent after "
                                 "the deadline" % label)
        disp.dispatch_deadline = None
        if not np.array_equal(engine.submit(keys).result(), want):
            raise AssertionError("%s: the submit after the deadline is not "
                                 "exact" % label)
        from dpf_tpu_torch.utils.bench import cuda_ms
        ms = {name: cuda_ms(lambda srv=srv: srv.eval_gpu(keys), 3)
              for name, srv in (("fused", fused), ("dispatch", disp))}
        records.setdefault("dispatch_ms", {})[label] = ms
        log("  %-16s B=512 and 129 == fused (both %.1f ms); a past deadline "
            "raised DeadlineExceeded, the next submit exact; eval_gpu B=512 "
            "fused %.3f ms, dispatch %.3f ms (knobs %s)"
            % (label, 1e3 * dt, ms["fused"], ms["dispatch"],
               json.dumps(disp.resolved_eval_knobs(cap))))
        del fused, disp, engine
    torch.cuda.empty_cache()
    by_part["7.2 dispatch"] = read_counts()

    # 7.3 overlap: the blocking loop against the engine's windows
    zero_counts()
    log("phase 7.3 overlap: 64 batches of 512 (binary AES-128), blocking "
        "loop against the engine at max_in_flight 1, 2, 4")
    overlap = {}
    for n3 in (n // 16, n):
        d = DPF(prf=aes, device=device)
        d.eval_init(table[:n3])
        keys = d.gen_batch(np.array([(i * 0x9E3779B1) % n3
                                     for i in range(cap)]), n3)[0]
        r = bench_serve.overlap_bench(d, [keys] * 64)
        overlap[n3] = r
        for mode, m in r["modes"].items():
            log("  N=%-8d %-9s %10.1f dpfs/s (%.3f s)%s  busy share %s on %s"
                % (n3, mode, m["dpfs_per_sec"], m["seconds"],
                   "" if mode == "blocking" else
                   "  pack %.3f / dispatch %.3f / wait %.3f ms a batch"
                   % (m["pack_ms_per_batch"], m["dispatch_ms_per_batch"],
                      m["wait_ms_per_batch"]),
                   "%.3f" % m["busy_share"] if m.get("busy_share") is not None
                   else "not measured", smi))
        del d, keys
    records["overlap"] = overlap
    by_part["7.3 overlap"] = read_counts()

    # 7.4 router and open-loop load (the profiled passes of 7.3 leave
    # many host objects and cached device blocks behind)
    gc.collect()
    torch.cuda.empty_cache()
    zero_counts()
    log("phase 7.4 router and load: three AES-128 constructions, N=%d, "
        "cap 512, bursty trace keeping the sticky engine 1.5 / 0.3 busy"
        % n)
    rec = bench_load.load_bench(
        n=n, entry_size=16, cap=cap, prf=aes, on_rate=None, on_load=1.5,
        off_load=0.3, duration_s=6.0, reps=1, distinct=8,
        shed_queue_depth=8, shed_window=64, slo_ms=250.0, device=device,
        quiet=True)
    if rec["gate_rejections"] != 0:
        raise AssertionError("phase 7.4: %d gate rejections"
                             % rec["gate_rejections"])
    log("  trace %s" % json.dumps(rec["trace"]))
    log("  cost model after the router leg (ms): %s" % json.dumps(
        {k: round(1e3 * v, 4) for k, v in rec["cost_table"].items()}))
    for leg in ("sticky", "router", "shed_leg"):
        r = rec[leg]
        log("  %-8s %s qps, p50 %s ms, p99 %s ms, sheds %s (gate "
            "rejections 0) on %s"
            % (leg, r.get("qps", r.get("qps_admitted")), r["p50_ms"],
               r["p99_ms"], r.get("shed_batches", 0), smi))
    log("  routes %s" % json.dumps(rec["router"]["router_stats"]
                                   ["route_counts"]))
    records["load"] = {k: v for k, v in rec.items() if k != "obs"}
    by_part["7.4 router"] = read_counts()
    torch.cuda.empty_cache()
    log("phase 7: %.1f s" % (time.perf_counter() - t0))
    return by_part, records


def multitable_phase(smi, read_counts, zero_counts, n=1 << 20,
                     device=None) -> tuple:
    """Phase 8 at table size ``n`` on ``device`` (None = the card; the
    CPU rehearses it at a small n, where the byte checks on
    ``torch.cuda.memory_allocated`` are skipped and the multitenant
    bench serves its default tenants): the table registry and a granule
    store, the chaos bench and the multitenant bench, AES-128 in the
    three constructions; returns ({part: launch counts}, the phase's
    records)."""
    import numpy as np

    from dpf_tpu_torch import DPF
    from dpf_tpu_torch.api import resolve_device
    from dpf_tpu_torch.core import expand
    from dpf_tpu_torch.serve import bench_chaos, bench_multitenant, loadgen
    from dpf_tpu_torch.serve.registry import (GranulePrefetcher,
                                              TableRegistry)

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    aes = DPF.PRF_AES128
    by_part, records = {}, {}
    t0 = time.perf_counter()

    def allocated():
        return torch.cuda.memory_allocated() if cuda else 0

    def held_bytes(what, want, base):
        """The device bytes live above ``base`` must be ``want``."""
        if cuda and allocated() - base != want:
            raise AssertionError("%s: %d bytes allocated above the base, "
                                 "%d expected" % (what, allocated() - base,
                                                  want))

    # 8.1 registry residency: A (n x 16) twice, B (n/4 x 8), C (n/16 x 4)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
    zero_counts()
    rng = np.random.default_rng(8)
    shapes = {"A": (n, 16), "B": (n // 4, 8), "C": (n // 16, 4)}
    tables = {k: rng.integers(0, 2 ** 31, shp, dtype=np.int64)
              .astype(np.int32) for k, shp in shapes.items()}
    one = 3 * n * 16 * 4
    reg = TableRegistry(2 * one, prf_method=aes, device=dev)
    base = allocated()
    log("phase 8.1 registry: budget %d bytes (two versions of A, %d x 16 "
        "in three layouts)" % (2 * one, n))
    steps = []

    def step(what, fn):
        before = allocated()
        fn()
        if cuda:
            torch.cuda.synchronize()
        steps.append((what, allocated() - before, reg.resident_bytes))
        held_bytes(what, reg.resident_bytes, base)
        log("  %-34s allocated %+12d bytes, resident %d, counters %s"
            % (what, steps[-1][1], reg.resident_bytes,
               json.dumps(reg.counters)))
        return steps[-1][1]

    step("register A v1", lambda: reg.register("A", tables["A"]))
    a2 = tables["A"].copy()
    a2[::7] ^= 0x5A5A
    step("register A v2", lambda: reg.register("A", a2))
    nb = {k: None for k in ("A", "B", "C")}
    nb["A"] = reg._get("A", 1).nbytes
    if nb["A"] != one:
        raise AssertionError("A's nbytes %d != %d" % (nb["A"], one))
    d = step("register B (evicts A v1)", lambda: reg.register("B",
                                                               tables["B"]))
    nb["B"] = reg._get("B", None).nbytes
    if cuda and d != nb["B"] - nb["A"]:
        raise AssertionError("register B moved %d bytes, %d expected"
                             % (d, nb["B"] - nb["A"]))
    step("register C", lambda: reg.register("C", tables["C"]))
    nb["C"] = reg._get("C", None).nbytes
    if reg.counters["evictions"] != 1 or reg._get("A", 1).resident:
        raise AssertionError("A v1 was not the LRU eviction")

    # shares of A v2 before and after a demotion, on 512 distinct keys
    idx = np.array([(i * 0x9E3779B1) % n for i in range(512)])
    keys, before = {}, {}
    with reg.acquire("A", 2) as lease:
        for lb, srv in lease.servers.items():
            keys[lb] = srv.gen_batch(idx, n)[0]
            before[lb] = srv.eval_gpu(keys[lb]).cpu()
    d = step("demote A v2", lambda: reg.demote("A", 2))
    if cuda and d != -nb["A"]:
        raise AssertionError("demotion moved %d bytes, %d expected"
                             % (d, -nb["A"]))
    promo = {}

    def promote():
        t1 = time.perf_counter()
        reg.acquire("A", 2).release()
        if cuda:
            torch.cuda.synchronize()
        promo["ms"] = 1e3 * (time.perf_counter() - t1)
    d = step("acquire A v2 (promotes)", promote)
    if cuda and d != nb["A"]:
        raise AssertionError("promotion moved %d bytes, %d expected"
                             % (d, nb["A"]))
    with reg.acquire("A", 2) as lease:
        for lb, srv in lease.servers.items():
            after = srv.eval_gpu(keys[lb]).cpu()
            if not torch.equal(after, before[lb]):
                raise AssertionError("%s: shares after re-promotion differ"
                                     % lb)
    log("  re-promoted A v2: 512 distinct keys x 3 constructions, shares "
        "bit-equal to before the demotion; promotion %.3f ms for %d bytes "
        "(host permute + pageable upload of three layouts) on %s"
        % (promo["ms"], nb["A"], smi))
    d = step("acquire A v1 (promotes, evicts)",
             lambda: reg.acquire("A", 1).release())
    if reg.counters["promotions"] != 2:
        raise AssertionError("registry counters %s" % reg.counters)

    # a granule store over A v2's permuted layout: 2^16-row granules
    # (n / 16 on the CPU), a budget of 4 granules
    g = max(n // 16, 64)
    store = reg.granule_store("A", 2, granule=g,
                              budget_bytes=4 * g * 16 * 4)
    perm = expand.permute_table(reg._get("A", 2).servers["logn"].table)
    gbase = allocated()
    page = []
    for i in range(6):
        t1 = time.perf_counter()
        with store.lease(i * g) as lease:
            page.append(1e3 * (time.perf_counter() - t1))
            want = torch.from_numpy(perm[i * g:(i + 1) * g]).to(dev)
            if not torch.equal(lease.table, want):
                raise AssertionError("granule %d differs from its host "
                                     "slice" % i)
            del want
        held_bytes("granule store", store.resident_bytes, gbase)
    pinned = store.lease(0)
    store.demote(0)
    store.lease(5 * g).release()
    pinned.release()
    pf = GranulePrefetcher(store, rates_fn=lambda: loadgen.bucket_rates(
        loadgen.default_bursty(512), (64, 128, 256, 512)), max_per_tick=4)
    pf.tick()
    held_bytes("granule store", store.resident_bytes, gbase)
    st = store.stats()["counters"]
    for k in ("misses", "evictions", "deferred_demotions"):
        if st[k] <= 0:
            raise AssertionError("granule store: no %s (%s)" % (k, st))
    log("  granule store %d x %d rows (%d bytes a granule, budget 4): "
        "counters %s, prefetcher %s; leased granules == host slices; "
        "demand lease ms %s (pageable copy) on %s"
        % (len(store.row0s), g, store.granule_bytes, json.dumps(st),
           json.dumps(pf.stats()), ", ".join("%.3f" % x for x in page), smi))
    records["registry"] = {
        "steps": steps, "promotion_ms": promo["ms"], "nbytes": nb,
        "counters": dict(reg.counters), "granule": store.stats(),
        "granule_lease_ms": page}
    del reg, store, pf, pinned, lease, before, keys, perm
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    by_part["8.1 registry"] = read_counts()

    # 8.2 chaos: three legs over one bursty trace
    zero_counts()
    log("phase 8.2 chaos: N=%d E=16 cap 512 AES-128, baseline / faults / "
        "faults + the favourite's death" % n)
    rec = bench_chaos.chaos_bench(
        n=n, entry_size=16, cap=512, prf=aes, duration_s=3.0,
        on_rate=40.0, distinct=2, device=dev, quiet=True)
    chaos = rec["chaos_leg"]
    if rec["gate_escapes"] != 0:
        raise AssertionError("phase 8.2: %d gate escapes"
                             % rec["gate_escapes"])
    for leg in ("baseline_leg", "faults_leg", "chaos_leg"):
        r = rec[leg]
        f = r["faults"]
        if f["corruptions_detected"] != f["corruptions_injected"]:
            raise AssertionError("phase 8.2 %s: %d corruptions detected, "
                                 "%d injected" % (leg,
                                                  f["corruptions_detected"],
                                                  f["corruptions_injected"]))
        log("  %-12s availability %s, p50 %s ms, p99 %s ms, qps %s, "
            "recovery %s, injected %s, corruptions %d/%d detected on %s"
            % (leg, r["availability"], r["p50_ms"], r["p99_ms"], r["qps"],
               json.dumps(r["recovery"]), json.dumps(f["injected"]),
               f["corruptions_detected"], f["corruptions_injected"], smi))
        log("  %-12s breaker transitions %s" % (leg, json.dumps(
            {lb: [s for _, s in b["transitions"]]
             for lb, b in r["breakers"].items()})))
    if (chaos["recovery"]["failovers"] < 1
            or chaos["recovery"]["engine_restarts"] < 1):
        raise AssertionError("phase 8.2: the chaos leg did not fail over "
                             "and rebuild (%s)" % chaos["recovery"])
    log("  victim %s killed at arrival %d; trace %s; checked %s"
        % (chaos["victim"], chaos["killed_at_arrival"],
           json.dumps(rec["trace"]), rec["checked"]))
    records["chaos"] = {k: v for k, v in rec.items() if k != "obs"}
    by_part["8.2 chaos"] = read_counts()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # 8.3 multitenant: one TenantRouter over one TableRegistry
    zero_counts()
    full = n >= 1 << 20
    log("phase 8.3 multitenant: %s tenants, AES-128, solo / combined / "
        "noisy-neighbour legs" % ("full-width" if full else "default"))
    rec = bench_multitenant.multitenant_bench(
        duration_s=2.5, prf=aes, distinct=2, full_width=full, device=dev,
        quiet=True)
    if rec["gate_escapes"] != 0:
        raise AssertionError("phase 8.3: %d gate escapes"
                             % rec["gate_escapes"])
    if not rec["per_tenant_series"]["visible"] or not rec["ladder_shared"]:
        raise AssertionError("phase 8.3: per-tenant series %s, ladder "
                             "shared %s" % (rec["per_tenant_series"],
                                            rec["ladder_shared"]))
    for leg, per in (("solo", rec["solo"]),
                     ("combined", rec["combined"]["per_tenant"]),
                     ("cold", rec["cold_table"]["per_tenant"]),
                     ("chaos", rec["chaos"]["per_tenant"])):
        for name, r in per.items():
            log("  %-8s %-6s availability %s, p50 %s ms, p99 %s ms, ok %d "
                "shed %d failed %d of %d" % (
                    leg, name, r["availability"], r["p50_ms"], r["p99_ms"],
                    r["ok_batches"], r["shed_batches"], r["failed_batches"],
                    r["arrivals"]))
    cold = rec["cold_table"]
    log("  cold leg: %s's table demoted first, %d promotion(s) under load, "
        "%s s (host permutes + uploads, the registry lock held) on %s"
        % (cold["demoted"], cold["promotions"], cold["promotion_s"], smi))
    log("  isolation (tolerance %.1f x solo p99 + slack %.3f ms = %d x "
        "%s's %s top bucket %.3f ms): %s; victim degraded %s; checked %s "
        "on %s" % (rec["tolerance"], rec["slack"]["ms"],
                   rec["slack"]["batches"], rec["slack"]["tenant"],
                   rec["slack"]["construction"], rec["slack"]["batch_ms"],
                   json.dumps(rec["isolation"]), rec["victim_degraded"],
                   rec["checked"], smi))
    log("  combined %d qps (ok batches); registry %s; metrics tenants %s"
        % (rec["value"], json.dumps(rec["scheduler"]["registry"]
                                    ["counters"]),
           rec["per_tenant_series"]["metrics_tenants"]))
    records["multitenant"] = {k: v for k, v in rec.items() if k not in (
        "obs", "scheduler", "flight_on_gate_failure")}
    by_part["8.3 multitenant"] = read_counts()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log("phase 8: %.1f s" % (time.perf_counter() - t0))
    return by_part, records


def answer_split(server, keys_per_bin) -> dict:
    """One round through ``PrivateLookupServer.answer``'s steps, each
    group's timed on the host clock: the packed decode, the staging copy
    into the pinned buffer, the group's program (its Python, the upload
    and the launches enqueued), the host's wait for the card, the
    download; the rest of the round's wall time is the Python around
    them.  On the card, CUDA events around the upload (``api.upload``,
    wrapped for this round only: the program looks it up when it runs)
    and after the program split the device's time into the upload and
    the kernels.  The wait makes this round's download follow the
    kernels alone; ``answer`` gathers after every group is enqueued, the
    same here with one group.  Returns ms by stage."""
    import numpy as np
    from dpf_tpu_torch import api
    cuda = server.device.type == "cuda"
    upload, marks = api.upload, []

    def timed_upload(staged, device):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        buf = upload(staged, device)
        ev[1].record()
        marks.append(ev)
        return buf

    host = dict.fromkeys(("decode", "staging", "program", "wait",
                          "download"), 0.0)
    dev = {"upload": 0.0, "kernels": 0.0}
    api.upload = timed_upload if cuda else upload
    try:
        t_round = time.perf_counter()
        out = np.zeros((len(server.bins), server.entry_size), np.int32)
        for n, grp in server._groups.items():
            t0 = time.perf_counter()
            pk = server._decode_group(n, grp,
                                      [keys_per_bin[bi] for bi in grp.idxs])
            t1 = time.perf_counter()
            staged = server._stage_group(grp, pk, server._answer_stage(n))
            t2 = time.perf_counter()
            shares = server._run_group_program(n, grp, staged)
            if cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
            t3 = time.perf_counter()
            if cuda:
                torch.cuda.synchronize()
            t4 = time.perf_counter()
            out[grp.idxs] = shares.cpu().numpy()
            t5 = time.perf_counter()
            for k, dt in zip(host, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                    t5 - t4)):
                host[k] += 1e3 * dt
            if cuda:
                dev["upload"] += marks[-1][0].elapsed_time(marks[-1][1])
                dev["kernels"] += marks[-1][1].elapsed_time(end)
        total = 1e3 * (time.perf_counter() - t_round)
    finally:
        api.upload = upload
    return dict(round=total, **host, rest=total - sum(host.values()),
                upload_device=dev["upload"] if cuda else None,
                kernels_device=dev["kernels"] if cuda else None)


def batch_pir_phase(smi, read_counts, zero_counts, entries=1 << 20,
                    device=None, rounds=6, reps=3) -> tuple:
    """Phase 9: batch-PIR (``apps.batch_pir``) over an ``entries`` x 16
    table in bins of 1/256 of it (256 bins of 4096 at 2^20), the counts
    set to 0 before and read after.  For each construction x {AES-128,
    ChaCha20} on two servers: one round through ``answer`` equal to
    ``answer_scalar`` and every planned row recovered exactly, then
    ``rounds`` rounds through ``LookupStream`` equal to ``answer`` and
    recovered exactly; then ``bench_pir.pir_point`` at ``entries`` and
    ``pir_bench``'s default points.  Rehearse on the CPU with a small
    ``entries`` and ``device="cpu"``.  Returns (launch counts, the
    phase's records)."""
    from dpf_tpu_torch.apps.batch_pir import (PrivateLookupClient,
                                              PrivateLookupServer)
    from dpf_tpu_torch.serve import bench_pir
    import numpy as np

    t9 = time.perf_counter()
    table, opt = bench_pir._workload(entries, 16, 1 / 256.)
    bins = opt.hot_table_bins
    rounds_w = bench_pir._wanted_rounds(opt, entries, rounds)
    log("phase 9 batch-PIR: %d x 16 table in %d bins of %d, two servers, "
        "3 constructions x AES-128 / ChaCha20, 1 answer round + %d stream "
        "rounds each (plan %.1f s)" % (entries, len(bins),
                                      len(bins[0]), rounds,
                                      time.perf_counter() - t9))

    def exact(got, plan, what):
        want = sum(t is not None for t in plan)
        if len(got) != want or not all(
                np.array_equal(row, table[w]) for w, row in got.items()):
            raise AssertionError("phase 9 %s: recovered rows differ from "
                                 "the table" % what)
        return want

    zero_counts()
    records = []
    for scheme, radix, label in (("logn", 2, "binary"),
                                 ("logn", 4, "radix-4"),
                                 ("sqrtn", 2, "sqrt-N")):
        for prf in (3, 2):                  # AES-128, ChaCha20
            what = "%s prf %d" % (label, prf)
            servers = [PrivateLookupServer(table, bins, prf=prf, radix=radix,
                                           scheme=scheme, device=device)
                       for _ in range(2)]
            client = PrivateLookupClient(bins, servers[0].bin_sizes,
                                         prf=prf, radix=radix, scheme=scheme,
                                         entry_size=16)
            t0 = time.perf_counter()
            key_rounds = [client.make_queries(w) for w in rounds_w]
            keygen_s = (time.perf_counter() - t0) / rounds
            ka, kb, plan = key_rounds[0]
            sa = servers[0].answer(ka)
            if not np.array_equal(sa, servers[0].answer_scalar(ka)):
                raise AssertionError("phase 9 %s: answer differs from "
                                     "answer_scalar" % what)
            rows_ok = exact(client.recover(sa, servers[1].answer(kb), plan),
                            plan, what + " answer")
            # a warm round: the best of 3 (the first call of a server
            # also allocates its pinned key buffer)
            answer_ms = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                servers[0].answer(ka)
                answer_ms = min(answer_ms, 1e3 * (time.perf_counter() - t0))
            # the same warm round split into its stages, the round of
            # the least wall time of 3
            split = min((answer_split(servers[0], ka) for _ in range(3)),
                        key=lambda sp: sp["round"])
            log("  %-8s prf %d: one warm round split (ms): %s"
                % (label, prf, ", ".join(
                    "%s %s" % (k, "not measured" if v is None else
                               "%.3f" % v) for k, v in split.items())))
            streams = [sv.stream(max_in_flight=2, warmup=True)
                       for sv in servers]
            t0 = time.perf_counter()
            futs = [(streams[0].submit(a), streams[1].submit(b), p)
                    for a, b, p in key_rounds]
            shares = [(fa.result(), fb.result(), p) for fa, fb, p in futs]
            stream_s = time.perf_counter() - t0
            for (ra, rb, p), (a, b, _) in zip(shares, key_rounds):
                if not (np.array_equal(ra, servers[0].answer(a))
                        and np.array_equal(rb, servers[1].answer(b))):
                    raise AssertionError("phase 9 %s: LookupStream differs "
                                         "from answer" % what)
                rows_ok += exact(client.recover(ra, rb, p), p,
                                 what + " stream")
            rec = dict(construction=label, prf=prf, bins=len(bins),
                       bin_rows=servers[0].bin_sizes[0],
                       groups=servers[0].group_constructions(),
                       keygen_s_a_round=keygen_s, answer_ms=answer_ms,
                       answer_split_ms=split,
                       stream_s=stream_s, rounds=rounds,
                       stream_bin_queries_per_s=len(bins) * rounds
                       / stream_s, rows_recovered=rows_ok,
                       stream_stats=streams[0].stats())
            records.append(rec)
            log("  %-8s prf %d: answer == answer_scalar, %d rows recovered "
                "exactly, stream == answer; answer %.3f ms (one server, "
                "one warm round, best of 3), stream %.1f bin-queries/s (%d "
                "rounds, two servers), keygen %.3f s a round on %s"
                % (label, prf, rows_ok, answer_ms,
                   rec["stream_bin_queries_per_s"], rounds, keygen_s, smi))
            del servers, streams
    point = bench_pir.pir_point(entries=entries, bin_fraction=1 / 256.,
                                rounds=rounds, reps=reps, quiet=True,
                                device=device)
    log("  pir_point entries=%d: e2e %.1f bin-queries/s (per-key path "
        "%.1f), stream %.1f on %s" % (entries, point["e2e"]["batched_qps"],
                                      point["e2e"]["scalar_qps"],
                                      point["streaming"]["qps"], smi))
    log(json.dumps({"pir_point": point}))
    bench = bench_pir.pir_bench(rounds=rounds, reps=reps, quiet=True,
                                device=device)
    bench.pop("obs")
    log(json.dumps({"pir_bench": bench}))
    counts = read_counts()
    log("phase 9: %.1f s" % (time.perf_counter() - t9))
    return counts, {"rounds": records, "pir_point": point,
                    "pir_bench": bench}


def max_abs_err(got, want) -> int:
    """The largest difference of two integer tensors of one shape (0 when
    they are equal)."""
    if torch.equal(got, want):
        return 0
    return int((got.long() - want.long()).abs().max().item())


def _device_ms(fn, reps: int, device) -> float:
    """Mean ms of ``fn`` a call: CUDA events on the card, the host clock
    (after a synchronised warm call) on the CPU."""
    from dpf_tpu_torch.utils.bench import cuda_ms
    if torch.device(device).type == "cuda":
        return cuda_ms(fn, reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def models_zoo_phase(smi, read_counts, zero_counts, device=None,
                     zoo_n=1 << 20, zoo_reps=5, aes_keys=512,
                     aes_width=1 << 10, rec_kw=None, lm_kw=None) -> tuple:
    """Phase 10: the workload models, the bitsliced AES and the PRF zoo
    on ``device`` (None = the card).  Rehearse on the CPU with
    ``device="cpu"`` and small sizes (``zoo_n``, ``aes_width``, and the
    datasets' ``rec_kw`` / ``lm_kw``).  Returns ({part: launch counts},
    the K7 row of the kernels line, K7's largest difference from the
    plain cores over its checks, the phase's records)."""
    import copy
    import tempfile

    from dpf_tpu_torch.api import resolve_device
    from dpf_tpu_torch.apps import sweep
    from dpf_tpu_torch.apps.batch_pir import (BatchPIROptimize,
                                              CollocateConfig, HotColdConfig,
                                              PIRConfig)
    from dpf_tpu_torch.core import aes_bitsliced, prf, prf_zoo
    from dpf_tpu_torch.models import checkpoint, datasets, lm, rec
    from dpf_tpu_torch.ops import aes_level
    from dpf_tpu_torch.ops import prf_zoo as ops_zoo
    from dpf_tpu_torch.utils.bench import profiled_ms

    dev = resolve_device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t10 = time.perf_counter()
    parts, records = {}, {}

    # ---------------------------------------- 10.1 the models, full width
    zero_counts()
    ds = datasets.make_rec_dataset(**(rec_kw or {}))
    lds = datasets.make_lm_dataset(**(lm_kw or {}))
    log("phase 10.1 models on %s: rec %d items, %d examples (%d train), "
        "16 dims, 64 hidden, 3 epochs of batch 64; LSTM LM vocabulary %d, "
        "sequence %d, %d / %d sequences, 32 dims, 64 hidden, 2 epochs of "
        "batch 32" % (dev, ds.n_items, ds.hist.shape[0], len(ds.train_idx),
                      lds.vocab_size, lds.seq_len, len(lds.train_tokens),
                      len(lds.val_tokens)))
    trained = {}
    for label, train, steps in (
            ("rec", lambda: rec.train_rec_model(ds, device=device),
             3 * (len(ds.train_idx) // 64)),
            ("lm", lambda: lm.train_lm(lds, device=device),
             2 * len(range(0, len(lds.train_tokens) - 31, 32)))):
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev) if cuda else None
        t0 = time.perf_counter()
        trained[label] = train()
        sync()
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        records[label + "_train"] = dict(seconds=train_s, steps=steps,
                                         steps_per_s=steps / train_s,
                                         max_memory_allocated=peak,
                                         allocated_before=base)
        log("  %-3s train: %.3f s, %d steps, %.1f steps/s, "
            "max_memory_allocated %s bytes (%s allocated before) on %s"
            % (label, train_s, steps, steps / train_s, peak, base, smi))
    model, lmodel = trained["rec"], trained["lm"]

    def plan(d, queries):
        return BatchPIROptimize(
            d.access_patterns("train"), d.access_patterns("val"),
            HotColdConfig(1.0), CollocateConfig(0),
            PIRConfig(bin_fraction=0.02, queries_to_hot=queries))

    evals = {}
    for label, d, fn, key in (("rec", ds, rec.evaluate_with_pir, "roc_auc"),
                              ("lm", lds, lm.evaluate_with_pir,
                               "perplexity")):
        m = trained[label]
        for q in (None, 0, 8):
            t0 = time.perf_counter()
            r = fn(m, d, None if q is None else plan(d, q))
            r["seconds"] = time.perf_counter() - t0
            evals["%s %s" % (label, "no plan" if q is None else "q=%d" % q)] \
                = r
            log("  %-3s %-8s %s %.6f (n_eval %d, %.2f s)"
                % (label, "no plan" if q is None else "q=%d" % q, key,
                   r[key], r["n_eval"], r["seconds"]))
    records["evaluate_with_pir"] = evals
    if not evals["rec no plan"]["roc_auc"] > 0.55:
        raise AssertionError("phase 10.1: rec AUC %.4f <= 0.55"
                             % evals["rec no plan"]["roc_auc"])
    if not evals["rec q=8"]["roc_auc"] > evals["rec q=0"]["roc_auc"]:
        raise AssertionError("phase 10.1: AUC(q=8) %.4f <= AUC(q=0) %.4f"
                             % (evals["rec q=8"]["roc_auc"],
                                evals["rec q=0"]["roc_auc"]))
    if not evals["lm q=0"]["perplexity"] >= \
            0.9 * evals["lm no plan"]["perplexity"]:
        raise AssertionError("phase 10.1: masked perplexity %.3f < 0.9 x "
                             "unmasked %.3f" % (evals["lm q=0"]["perplexity"],
                                                evals["lm no plan"]
                                                ["perplexity"]))
    grid = {"cache_size_fraction": [1.0], "num_collocate": [0],
            "bin_fraction": [0.02], "queries_to_hot": [0, 8],
            "queries_to_cold": [0]}
    res = sweep.run_sweep(ds.access_patterns("train"),
                          ds.access_patterns("val"), grid=grid,
                          model_eval=lambda opt: rec.evaluate_with_pir(
                              model, ds, opt))
    if len(res) != 2 or not all(r["accuracy_stats"] and
                                r["accuracy_stats"]["n_eval"] ==
                                len(ds.val_idx) for r in res):
        raise AssertionError("phase 10.1: the sweep's accuracy_stats are "
                             "not filled: %s" % res)
    records["sweep"] = [dict(config=r["config"],
                             mean_recovered=r["mean_recovered"],
                             accuracy_stats=r["accuracy_stats"])
                        for r in res]
    log("  sweep (two points, model_eval = rec AUC): %s"
        % ", ".join("q=%d recovered %.4f AUC %.6f"
                    % (r["config"]["queries_to_hot"], r["mean_recovered"],
                       r["accuracy_stats"]["roc_auc"]) for r in res))
    # a checkpoint round trip on the device
    from dpf_tpu_torch.ops.cuda_build import BUILD_DIR
    BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        path = os.path.join(tmp, "lm.pt")
        back = checkpoint.train_or_restore(
            path, lambda: lm.init_lm(lds, seed=1, device=device),
            lambda: lmodel)
        again = checkpoint.train_or_restore(
            path, lambda: lm.init_lm(lds, seed=1, device=device),
            lambda: None)
        toks = torch.from_numpy(lds.val_tokens[:4]).long().to(dev)
        with torch.no_grad():
            if not (back is lmodel and torch.equal(again(toks),
                                                    lmodel(toks))):
                raise AssertionError("phase 10.1: the checkpoint round "
                                     "trip changed the model")
    log("  checkpoint: saved, restored into a fresh model on %s, logits "
        "equal" % dev)
    # the card against the CPU: one set of weights on both devices
    diffs = {}
    for label in ("rec", "lm"):
        if label == "rec":
            host = rec.init_rec_model(ds, seed=5, device="cpu")
            b = ds.train_idx[:64]
            args = [torch.from_numpy(a[b]).long() for a in
                    (ds.hist, ds.hist_len, ds.target)]
            target = torch.from_numpy(ds.label[b])

            def loss(m, a, t):
                return rec.rec_loss(m, *a, t)
        else:
            host = lm.init_lm(lds, seed=5, device="cpu")
            args = [torch.from_numpy(lds.train_tokens[:32]).long()]
            target = None

            def loss(m, a, t):
                return lm.lm_loss(m, a[0])
        for tf32 in (False, True):
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
                ms = []
                for d in ("cpu", dev):
                    m = copy.deepcopy(host).to(d)
                    a = [x.to(d) for x in args]
                    t = None if target is None else target.to(d)
                    with torch.no_grad():
                        logits = m(*a)
                    opt = torch.optim.Adam(
                        [p for p in m.parameters() if p.requires_grad],
                        lr=1e-2)
                    loss(m, a, t).backward()
                    opt.step()
                    ms.append((logits.float().cpu(),
                               {k: v.cpu() for k, v in
                                m.state_dict().items()}))
            dl = float((ms[0][0] - ms[1][0]).abs().max())
            by_param = {k: float((ms[0][1][k] - ms[1][1][k]).abs().max())
                        for k in ms[0][1]}
            dp = max(by_param.values())
            diffs["%s tf32=%s" % (label, tf32)] = dict(
                logits=dl, adam_step=dp, adam_step_by_param=by_param)
            if not tf32 and (dl > 1e-4 or dp > 1e-4):
                raise AssertionError("phase 10.1 %s: %s against the CPU: "
                                     "logits %.3g, one Adam step %.3g > "
                                     "1e-4" % (label, dev, dl, dp))
        log("  %-3s Adam step differences by parameter (TF32 off): %s"
            % (label, diffs["%s tf32=False" % label]["adam_step_by_param"]))
        log("  %-3s %s against the CPU, one set of weights: max |logits| "
            "diff %.3g, after one Adam step %.3g (cuDNN TF32 off; with it "
            "on %.3g / %.3g)" % (label, dev,
                                 diffs["%s tf32=False" % label]["logits"],
                                 diffs["%s tf32=False" % label]
                                 ["adam_step"],
                                 diffs["%s tf32=True" % label]["logits"],
                                 diffs["%s tf32=True" % label]
                                 ["adam_step"]))
    records["device_vs_cpu"] = diffs
    parts["10.1 models"] = read_counts()

    # ------------------------------------------ 10.2 the bitsliced AES
    zero_counts()
    g = torch.Generator(device=dev).manual_seed(20261017)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (aes_keys, aes_width, 4),
                          dtype=torch.int64, device=dev,
                          generator=g).to(torch.int32)
    nodes = aes_keys * aes_width
    log("phase 10.2 bitsliced AES on %s: %d seeds (%d x %d)"
        % (dev, nodes, aes_keys, aes_width))
    aes_rows = []
    for n_pts in (2, 4):
        zero_cw = torch.zeros((aes_keys, n_pts, 4), dtype=torch.int32,
                              device=dev)
        k1_out = aes_level.aes_level_step(seeds, zero_cw, zero_cw,
                                          arity=n_pts)
        k1_kids = k1_out.reshape(aes_keys, aes_width, n_pts, 4)
        gather = prf.aes128_multi(seeds, range(n_pts))
        k1_ms = _device_ms(lambda: aes_level.aes_level_step(
            seeds, zero_cw, zero_cw, arity=n_pts), 10, dev)
        gather_ms = _device_ms(lambda: prf.aes128_multi(seeds, range(n_pts)),
                               3, dev)
        for sbox in ("bp", "tower", "chain"):
            outs = aes_bitsliced.aes128_multi_bitsliced(seeds, n_pts, sbox)
            sync()
            for b in range(n_pts):
                if not (torch.equal(outs[b], gather[b])
                        and torch.equal(outs[b], k1_kids[:, :, b])):
                    raise AssertionError(
                        "phase 10.2: bitsliced AES (%s, n_pts %d) differs "
                        "from K1 or the gather AES at child %d"
                        % (sbox, n_pts, b))
            ms = _device_ms(lambda: aes_bitsliced.aes128_multi_bitsliced(
                seeds, n_pts, sbox), 3, dev)
            aes_rows.append(dict(n_pts=n_pts, sbox=sbox, nodes=nodes,
                                 bitsliced_ms=ms, k1_ms=k1_ms,
                                 gather_ms=gather_ms))
            log("  n_pts %d %-5s bit-equal to K1 and the gather AES; "
                "bitsliced %.3f ms, K1 %.4f ms, gather %.3f ms a call of "
                "%d nodes on %s" % (n_pts, sbox, ms, k1_ms, gather_ms,
                                    nodes, smi))
    records["bitsliced_aes"] = aes_rows

    # --------------------------------------------------- 10.3 the zoo
    log("phase 10.3 PRF zoo: K7 against the plain cores at n = 1, 33, "
        "1000, %d" % zoo_n)
    zoo_err = 0
    for name in ops_zoo.CANDIDATES:
        pos = 0 if name in prf_zoo.CHILDREN_PER_CALL else 1
        for n in (1, 33, 1000, zoo_n):
            s = torch.randint(-2 ** 31, 2 ** 31, (n, 4), dtype=torch.int64,
                              device=dev, generator=g).to(torch.int32)
            got = ops_zoo.zoo_eval(name, s, pos)
            want = ops_zoo.zoo_plain(name, s, pos)
            sync()
            err = max_abs_err(got, want)
            zoo_err = max(zoo_err, err)
            if err:
                raise AssertionError("phase 10.3: K7 %s differs from its "
                                     "plain core at n=%d (max_abs_err %d)"
                                     % (name, n, err))
    log("  K7: all %d candidates bit-equal to their plain cores at the four "
        "sizes (max_abs_err %d)" % (len(ops_zoo.CANDIDATES), zoo_err))
    # the instructions each instance's loop executes for one call
    sass = {}
    if cuda:
        from dpf_tpu_torch.utils import sass_count
        try:
            sass = sass_count.k7_counts()
        except (OSError, subprocess.CalledProcessError, ValueError) as exc:
            log("  K7 SASS: not counted (%s)" % exc)
    zero_counts()
    cps = prf_zoo.benchmark_zoo(n_calls=zoo_n, reps=zoo_reps,
                                device=device)
    parts["10.3 zoo"] = read_counts()
    zoo_rows = {}
    s = torch.randint(-2 ** 31, 2 ** 31, (zoo_n, 4), dtype=torch.int64,
                      device=dev, generator=g).to(torch.int32)

    def zoo_call(name):
        pos = 0 if name in prf_zoo.CHILDREN_PER_CALL else 1
        return (lambda: ops_zoo.zoo_eval(name, s, pos),
                "prf_zoo_kernel<%d>" % ops_zoo.CANDIDATES.index(name))
    # the kernels' device time, all 15 in one profiler session (the
    # benchmark's events also hold the wrapper's host work between
    # launches, which a 0.02 ms kernel does not hide)
    if cuda:
        dev_ms = profiled_ms({n: zoo_call(n) for n in ops_zoo.CANDIDATES})
    else:
        dev_ms = {n: _device_ms(zoo_call(n)[0], 1, dev)
                  for n in ops_zoo.CANDIDATES}
    for name in ops_zoo.CANDIDATES:
        kids = prf_zoo.CHILDREN_PER_CALL.get(name, 1)
        pos = 0 if kids > 1 else 1
        ops = ops_zoo.ops_per_call(name)
        in_sass = sass.get(ops_zoo.CANDIDATES.index(name))
        if in_sass and ops > in_sass["instructions"]:
            raise AssertionError(
                "phase 10.3: %s's count, %d instructions a call, exceeds "
                "the %d of K7's own loop: the bound overstates the work"
                % (name, ops, in_sass["instructions"]))
        work = dict(bytes=zoo_n * 16 * (1 + kids), ops=zoo_n * ops)
        by_bytes = work["bytes"] / PEAK_BYTES_PER_S
        by_ops = work["ops"] / PEAK_INSTR_PER_S
        ms = dev_ms[name]
        r = dict(children_per_s=cps[name], ms=ms,
                 benchmark_ms=1e3 * zoo_n * kids / cps[name],
                 bound_ms=1e3 * max(by_bytes, by_ops),
                 bound_by="bytes" if by_bytes >= by_ops else "operations",
                 ops_per_call=ops, children_per_call=kids,
                 sass_per_call=in_sass,
                 plain_ms=_device_ms(lambda: ops_zoo.zoo_plain(name, s, pos),
                                     1, dev), **work)
        if cuda and r["bound_ms"] > ms:
            raise AssertionError(
                "phase 10.3: %s took %.4f ms, under its bound of %.4f ms: "
                "the bound overstates the work" % (name, ms, r["bound_ms"]))
        r["share_of_bound"] = r["bound_ms"] / ms
        zoo_rows[name] = r
        log("  %-15s %14.1f children/s (benchmark, %.4f ms a call)  "
            "kernel ms %.4f  bound_ms %.4f (%s, %d instructions a call; "
            "K7's loop %s)  %.3f of the bound  plain_ms %.2f on %s"
            % (name, r["children_per_s"], r["benchmark_ms"], ms,
               r["bound_ms"], r["bound_by"], ops,
               json.dumps(in_sass) if in_sass else "not counted",
               r["share_of_bound"], r["plain_ms"], smi))
    records["zoo"] = zoo_rows
    # the kernels line's row: ChaCha12-BLK (the block-PRG the DPF ships as
    # PRF id 5) at zoo_n, the other candidates beside it
    row = dict(zoo_rows["chacha12_blk"],
               shape="chacha12_blk, [%d, 4] seeds -> [4, %d, 4]"
               % (zoo_n, zoo_n), library_ms=None, lookup_floor_ms=None,
               candidates={k: {f: v[f] for f in (
                   "ms", "benchmark_ms", "bound_ms", "bound_by", "plain_ms",
                   "children_per_s", "ops_per_call", "sass_per_call")}
                   for k, v in zoo_rows.items()})
    log("phase 10: %.1f s" % (time.perf_counter() - t10))
    return parts, row, zoo_err, records


def tuning_phase(smi, read_counts, zero_counts, n=1 << 20, batch=512,
                 device=None, serve_n=1 << 16, load_n=4096,
                 trace_kw=None, distinct=None, reps=3) -> tuple:
    """Phase 11, tuning and trace, at full width (a 2^20 x 16 int32
    table, 512 distinct keys a batch): ``tune_eval`` for binary AES-128
    (K1 + K3), radix-4 ChaCha20-BLK (mixed K2) and sqrt-N AES-128 (K4);
    ``kernel_search_ggm`` for binary ChaCha20 (2 generations x 4);
    ``keygen_search`` for the binary generator; ``tune_serving`` at
    ``serve_n`` cap 512 and ``tune_router`` at ``dpf_tpu``'s load-bench
    point (``load_n`` x 16, cap 128); ``bench_trace`` at its defaults;
    then a fresh all-auto ``DPF`` of each tuned shape resolves
    ``tuned`` or ``searched`` from the cache and two servers recover a
    fresh 512-key batch exactly.  Every timed candidate is gated against
    ``eval_cpu`` first.  Returns ({part: launch counts}, the phase's
    records)."""
    import numpy as np

    from dpf_tpu_torch import DPF, EvalConfig
    from dpf_tpu_torch.obs import bench_trace
    from dpf_tpu_torch.tune import search, serve_tune
    from dpf_tpu_torch.tune.kernel_search import (kernel_search_ggm,
                                                  keygen_search)
    from dpf_tpu_torch.utils.profiling import CACHE_COUNTERS

    t11 = time.perf_counter()
    parts, records = {}, {}
    distinct = distinct or {"logn.r2": 8, "logn.r4": 2, "sqrtn": 2}

    def report(name, rec):
        m = rec["measured"]
        heur = m.get("heuristic_s") or m.get("seed_s")
        log("  %s: heuristic %.4f ms, winner %.4f ms (%s), %d tried, %d "
            "rejected, %d gate escapes, distinct keys %s; %s"
            % (name, 1e3 * heur, 1e3 * m["best_s"],
               rec.get("variant_tag") or json.dumps(rec["knobs"]),
               m["candidates_tried"], m["rejected"], m["gate_escapes"],
               m.get("distinct", "-"), smi))
        if m["rejected"] or m["gate_escapes"]:
            raise AssertionError("phase 11 %s: %d rejected, %d gate "
                                 "escapes" % (name, m["rejected"],
                                              m["gate_escapes"]))
        records[name] = {k: m.get(k) for k in (
            "best_s", "heuristic_s", "seed_s", "candidates_tried",
            "rejected", "gate_escapes", "distinct", "keys_per_s",
            "baseline_keys_per_s")}
        records[name]["knobs"] = rec["knobs"]

    # 11.1 staged descent, three constructions
    zero_counts()
    log("phase 11.1 tune_eval: N=%d E=16 B=%d, reps %d" % (n, batch, reps))
    shapes = (("binary AES-128", 3, "logn", 2, None),
              # the dispatch route of the block-PRG ids runs plain level
              # steps on the card (no kernel of theirs has a level mode):
              # minutes at 2^20, so this one searches K2's block only
              ("radix-4 ChaCha20-BLK", 5, "logn", 4,
               ("chunk_leaves", "dot_impl")),
              ("sqrt-N AES-128", 3, "sqrtn", 2, None))
    for name, prf, scheme, radix, stages in shapes:
        kw = dict(prf_method=prf, scheme=scheme, radix=radix, reps=reps,
                  device=device, stages=stages,
                  distinct=distinct["sqrtn" if scheme == "sqrtn"
                                    else "logn.r%d" % radix])
        rec = search.tune_eval(n, batch, **kw)
        if not rec["searched"]:
            raise AssertionError("phase 11.1 %s: a fresh cache answered"
                                 % name)
        report(name, rec)
        again = search.tune_eval(n, batch, **kw)
        if again["searched"] or again["knobs"] != rec["knobs"]:
            raise AssertionError("phase 11.1 %s: the second tune_eval "
                                 "searched again" % name)
    parts["11.1 tune_eval"] = read_counts()

    # 11.2 the GGM family's variant search, binary ChaCha20
    zero_counts()
    log("phase 11.2 kernel_search_ggm: binary ChaCha20, N=%d B=%d, 2 "
        "generations x 4" % (n, batch))
    rec = kernel_search_ggm(n, batch, prf_method=2, reps=reps,
                            generations=2, population=4,
                            distinct=distinct["logn.r2"], device=device)
    report("ggm ChaCha20", rec)
    parts["11.2 kernel_search_ggm"] = read_counts()

    # 11.3 the keygen family (host work; no kernel)
    log("phase 11.3 keygen_search: binary AES-128, N=%d B=%d"
        % (n, batch))
    t0 = time.perf_counter()
    rec = keygen_search(n, batch, prf_method=3, reps=1,
                        generations=2, population=4, device=device)
    report("keygen binary AES-128", rec)
    log("  keys/s %d (baseline %d), %.1f s"
        % (rec["measured"]["keys_per_s"],
           rec["measured"]["baseline_keys_per_s"],
           time.perf_counter() - t0))

    # 11.4 serving and router knobs
    zero_counts()
    log("phase 11.4 tune_serving: AES-128 N=%d cap 512; tune_router: "
        "DUMMY N=%d E=16 cap 128" % (serve_n, load_n))
    srv = DPF(prf=3, device=device)
    srv.eval_init(np.random.default_rng(serve_n ^ 0x5e12).integers(
        0, 2 ** 31, (serve_n, 16), dtype=np.int32, endpoint=False))
    rec = serve_tune.tune_serving(srv, cap=512)
    m = rec["measured"]
    log("  serving: %s, %d qps, %d tried, %d rejected; %s"
        % (rec["knobs"], m["qps"], m["candidates_tried"], m["rejected"],
           smi))
    engine = srv.serving_engine(buckets=(512,))
    engine.warmup(tune=True)
    if list(engine.buckets.sizes) != rec["knobs"]["buckets"]:
        raise AssertionError("phase 11.4: warmup(tune=True) kept %s"
                             % (engine.buckets.sizes,))
    table = np.random.default_rng(11 ^ 0x10ad).integers(
        0, 2 ** 31, (load_n, 16), dtype=np.int32, endpoint=False)
    rrec = serve_tune.tune_router(table, prf_method=0, cap=128,
                                  device=device)
    mr = rrec["measured"]
    log("  router: %s, %d qps, %d tried, %d rejected"
        % (rrec["knobs"], mr["qps"], mr["candidates_tried"],
           mr["rejected"]))
    if m["rejected"] or mr["rejected"]:
        raise AssertionError("phase 11.4: rejected candidates")
    records["serve"] = {"knobs": rec["knobs"], "qps": m["qps"]}
    records["router"] = {"knobs": rrec["knobs"], "qps": mr["qps"]}
    parts["11.4 serving"] = read_counts()

    # 11.5 the observability bench at its defaults
    zero_counts()
    log("phase 11.5 bench_trace: N=%d E=16 cap 128 seed 11" % load_n)
    tr = bench_trace.trace_bench(device=device, quiet=True,
                                 **(trace_kw or {}))
    dig = tr["profile"]["joint_digest"]
    ov = tr["overhead"]
    dl = ov["paired_deltas_pct"]
    log("  checked %s; overhead %.3f%% (bound 2%%; median of %d paired "
        "segment deltas, quartiles %.3f / %.3f %%; summed makespans off "
        "%.4f s, on %.4f s: %+.3f%%), qps off %d on %d; device digest %s "
        "ms over %s (top %s); host %s ms; attributed faults %d; families "
        "%s; spans recorded in %s; %s"
        % (tr["checked"], ov["overhead_pct"], ov["pairs"],
           dl[len(dl) // 4], dl[(3 * len(dl)) // 4], ov["makespan_off_s"],
           ov["makespan_on_s"], ov["makespan_ratio_pct"],
           ov["qps_tracing_off"], ov["qps_tracing_on"],
           (dig["device"] or {}).get("device_ms"),
           (dig["device"] or {}).get("tracks"),
           (dig["device"] or {}).get("top_ops", [])[:3],
           (dig["host"] or {}).get("host_ms"),
           tr["chaos_flight"]["attributed_faults"],
           tr["openmetrics"]["families_required"],
           "C" if ov["native_spans"] else "Python", smi))
    if not tr["checked"]:
        raise AssertionError("phase 11.5: bench_trace's gates failed")
    records["bench_trace"] = {k: ov[k] for k in (
        "overhead_pct", "makespan_ratio_pct", "makespan_off_s",
        "makespan_on_s", "qps_tracing_off", "qps_tracing_on", "pairs",
        "native_spans")}
    records["bench_trace"]["device_ms"] = (dig["device"] or {}).get(
        "device_ms")
    parts["11.5 bench_trace"] = read_counts()

    # 11.6 the tuned resolution, end to end
    zero_counts()
    hits = CACHE_COUNTERS.tuning_hits
    auto = dict(kernel_impl=None, dot_impl=None, chunk_leaves=None)
    for name, prf, radix, scheme, want in (
            ("binary AES-128", 3, 2, "logn", "tuned"),
            ("radix-4 ChaCha20-BLK", 5, 4, "logn", "tuned"),
            ("sqrt-N AES-128", 3, 2, "sqrtn", "tuned"),
            ("binary ChaCha20", 2, 2, "logn", "searched")):
        tbl = np.random.default_rng(n ^ (batch << 1)).integers(
            0, 2 ** 31, (n, 16), dtype=np.int32, endpoint=False)
        pair = []
        for _ in range(2):
            d = DPF(config=EvalConfig(prf_method=prf, radix=radix,
                                      scheme=scheme, **auto), device=device)
            d.eval_init(tbl)
            pair.append(d)
        kn = pair[0].resolved_eval_knobs(batch)
        if kn["kernel_resolved_from"] not in ("tuned", "searched") or \
                kn["kernel_resolved_from"] != want:
            raise AssertionError("phase 11.6 %s resolved %r, not %s"
                                 % (name, kn, want))
        idx = np.random.default_rng(prf + radix).choice(n, batch,
                                                        replace=False)
        ka, kb = pair[0].gen_batch(idx, n)
        rows = (pair[0].eval_gpu(ka) - pair[1].eval_gpu(kb)).cpu().numpy()
        if not np.array_equal(rows, tbl[idx]):
            raise AssertionError("phase 11.6 %s: rows not recovered" % name)
        log("  %s resolves %s: %s; %d rows recovered"
            % (name, kn["kernel_resolved_from"],
               {k: v for k, v in kn.items() if k != "kernel_variant"},
               batch))
    if CACHE_COUNTERS.tuning_hits <= hits:
        raise AssertionError("phase 11.6: no tuning-cache hit")
    parts["11.6 tuned resolution"] = read_counts()
    log("  cache counters %s" % CACHE_COUNTERS.as_dict())
    log("phase 11: %.1f s" % (time.perf_counter() - t11))
    return parts, records


def _batch_ms(fn, reps: int, device) -> float:
    """Median host ms of one call of ``fn`` ended by a device
    synchronise (after a warm call): a whole batch, host work
    included."""
    cuda = torch.device(device).type == "cuda"
    times = []
    for i in range(reps + 1):
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        if i:
            times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


#: phase 12's constructions: (label, PRF id, scheme, radix)
MESH_CONSTRUCTIONS = (("binary AES-128", 3, "logn", 2),
                      ("binary ChaCha20", 2, "logn", 2),
                      ("radix-4 AES-128", 3, "logn", 4),
                      ("radix-4 ChaCha20-BLK", 5, "logn", 4),
                      ("sqrt-N AES-128", 3, "sqrtn", 2),
                      ("sqrt-N ChaCha20", 2, "sqrtn", 2))


def mesh_cluster_phase(smi, read_counts, zero_counts, n=1 << 20, batch=512,
                       device=None, psum_group=4, reps=3,
                       multichip_kw=None, multihost_kw=None) -> tuple:
    """Phase 12, the multi-GPU and cluster tier, at table size ``n`` x 16
    with ``batch`` distinct keys, every mesh and host on ``device`` (None
    = the card, repeated: one card rehearses every mesh).  (1) the
    sharded server on a 4-way table mesh, a 2 x 2 batch x table mesh and
    a 2 x 2 rows x bytes mesh (binary tree) for the six constructions of
    ``MESH_CONSTRUCTIONS``, ``psum_group`` 0 and ``psum_group``, every
    share equal to the one-device ``eval_gpu``'s and both servers
    recovering the rows, the ms a batch of the 4-way mesh beside the one
    device's; (2) two processes under ``parallel.multihost`` (gloo) as a
    1 x 2 table mesh, equal to the one device; (3) the cluster: a
    two-host ``ClusterRouter.local``, an injected ``host_drop`` answered
    by reshard and by degrade (four hosts), two spawned workers sharing
    the device with one killed, and a paged ``ClusterShardServer`` whose
    device bytes move by exactly its granules; (4) ``tune_mesh_eval`` on
    one shape (0 rejected, 0 gate escapes) and short ``bench_multichip``
    and ``bench_multihost`` runs.  Returns ({part: launch counts}, the
    phase's records)."""
    import numpy as np

    from dpf_tpu_torch import DPF, EvalConfig
    from dpf_tpu_torch.core import expand, keygen
    from dpf_tpu_torch.parallel import cluster_net, multihost, sharded
    from dpf_tpu_torch.parallel.cluster import (ClusterRouter,
                                                ClusterShardServer)
    from dpf_tpu_torch.serve.bench_multichip import multichip_bench
    from dpf_tpu_torch.serve.bench_multihost import multihost_bench
    from dpf_tpu_torch.serve.faults import FaultPlan, FaultSpec
    from dpf_tpu_torch.tune.mesh_tune import tune_mesh_eval
    from dpf_tpu_torch.utils.hermetic import free_port

    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    t12 = time.perf_counter()
    parts, records = {}, {}
    rng = np.random.default_rng(20261018)
    table = rng.integers(-2 ** 31, 2 ** 31, (n, 16),
                         dtype=np.int64).astype(np.int32)
    # distinct indices: an odd multiplier is a bijection mod 2^k
    idx = np.array([(i * 0x9E3779B1 + 7) % n for i in range(batch)])
    devs = [dev] * 4
    meshes = (("1x4 table", sharded.make_mesh(4, 1, devices=devs)),
              ("2x2 batch x table", sharded.make_mesh(2, 2, devices=devs)),
              ("1x2x2 rows x bytes",
               sharded.make_mesh_2d(2, 2, 1, devices=devs)))

    def same(name, got, want):
        err = max_abs_err(got.cpu(), want.cpu())
        if err:
            raise AssertionError("phase 12 %s: differs from the one device "
                                 "(max_abs_err %d)" % (name, err))

    # ------------------------------------------------ 12.1 sharded server
    log("phase 12.1 sharded server: N=%d E=16 B=%d distinct keys, meshes "
        "%s on %s (one device repeated), psum_group 0 and %d"
        % (n, batch, ", ".join(m for m, _ in meshes), dev, psum_group))
    # the one-device references and times first, so that the counts
    # read below hold the meshes' launches only
    want_rows = torch.from_numpy(table[idx])
    ones = []
    for label, prf, scheme, radix in MESH_CONSTRUCTIONS:
        d = DPF(config=EvalConfig(prf_method=prf, scheme=scheme,
                                  radix=radix), device=dev)
        d.eval_init(table)
        t0 = time.perf_counter()
        wa, wb = d.gen_batch(idx, n)
        gen_s = time.perf_counter() - t0
        ref_a = d.eval_gpu(wa)
        same(label + " one-device recovery",
             (ref_a - d.eval_gpu(wb)).cpu(), want_rows)
        one_ms = _batch_ms(lambda: d.eval_gpu(wa), reps, dev)
        ones.append((d, wa, wb, gen_s, ref_a, one_ms))
    zero_counts()
    rows12 = []
    for (label, prf, scheme, radix), (d, wa, wb, gen_s, ref_a, one_ms) in \
            zip(MESH_CONSTRUCTIONS, ones):
        checked = []
        for mname, mesh in meshes:
            if mesh.shape.get("byte", 1) > 1 and (scheme, radix) != \
                    ("logn", 2):
                continue
            for pg in (0, psum_group):
                srv = d.sharded_server(mesh, psum_group=pg)
                same("%s %s psum_group %d" % (label, mname, pg),
                     srv.eval(wa), ref_a)
                checked.append("%s pg=%d" % (mname, pg))
            same("%s %s recovery" % (label, mname),
                 (srv.eval(wa) - srv.eval(wb)).cpu(), want_rows)
        srv = d.sharded_server(meshes[0][1], psum_group=0)
        mesh_ms = _batch_ms(lambda: srv.eval(wa), reps, dev)
        log("  %-22s bit-equal on %s; ms a batch: one device %.3f, 1x4 "
            "mesh %.3f (%.3f x); keygen %.2f s on the host; %s"
            % (label, ", ".join(checked), one_ms, mesh_ms,
               mesh_ms / one_ms, gen_s, smi))
        rows12.append(dict(construction=label, prf=prf, scheme=scheme,
                           radix=radix, meshes=checked, one_device_ms=one_ms,
                           mesh_1x4_ms=mesh_ms, keygen_s=gen_s,
                           knobs=srv.resolved_eval_knobs(batch)))
        del d, srv, ref_a
    parts["12.1 sharded"] = read_counts()
    records["12.1 sharded"] = rows12
    del ones

    # ------------------------------------------------ 12.2 two processes
    log("phase 12.2 two processes under multihost (gloo) as a 1x2 table "
        "mesh on %s: binary ChaCha20 N=%d E=16 B=%d" % (dev, n, batch))
    t0 = time.perf_counter()
    port = free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "shares.npy")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "dpf_tpu_torch.parallel.multihost",
             "--rank", str(r), "--world", "2", "--port", str(port),
             "--backend", "gloo", "--device", str(dev), "--n", str(n),
             "--entry-size", "16", "--prf", "2", "--batch", str(batch),
             "--seed", "12", "--out", out_path],
            cwd=root, env=env, stdout=subprocess.PIPE, text=True)
            for r in range(2)]
        results = []
        for p in procs:
            out, _ = p.communicate(timeout=600)
            if p.returncode != 0:
                raise AssertionError("phase 12.2: a rank exited %d"
                                     % p.returncode)
            results += [json.loads(ln[7:]) for ln in out.splitlines()
                        if ln.startswith("RESULT ")]
        shares = np.load(out_path)
    d = DPF(prf=2, device=dev)
    d.eval_init(cluster_net.make_table(n, 16, 12))
    keys = multihost.rank_keys(n, 2, "logn", 2, batch, 12)[0]
    same("12.2 two-process mesh", torch.from_numpy(shares),
         d.eval_gpu(keys))
    counts = dict.fromkeys(read_counts(), 0)
    for res in results:
        for k, v in res["launches"].items():
            counts[k] += v
    parts["12.2 multihost"] = counts
    records["12.2 multihost"] = dict(
        ranks=len(results), backend=sorted({r["backend"] for r in results}),
        device=sorted({r["device"] for r in results}),
        seconds=time.perf_counter() - t0)
    log("  bit-equal to the one device; ranks %s, launches %s, %.1f s"
        % ([(r["rank"], r["backend"], r["device"]) for r in results],
           counts, time.perf_counter() - t0))
    del d

    # ------------------------------------------------------- 12.3 cluster
    log("phase 12.3 cluster: binary AES-128 N=%d E=16 B=%d on %s"
        % (n, batch, dev))
    table3 = cluster_net.make_table(n, 16, 13)
    d = DPF(prf=3, device=dev)
    d.eval_init(table3)
    ka, kb = d.gen_batch(idx, n)
    ref = d.eval_gpu(ka).cpu().numpy()
    want_rows = table3[idx]
    del d
    # the paged host's reference: the same granule on a host without a
    # budget, run before the counts are zeroed
    perm = expand.permute_table(table3)
    g = n // 4
    gbytes = g * 16 * 4
    plain = ClusterShardServer(perm, (0, g), g, prf_method=3, device=dev)
    ref_paged = plain._dispatch_packed(
        keygen.decode_keys_batched(ka))[:batch].cpu()
    del plain
    rec3 = {}
    zero_counts()
    c = ClusterRouter.local(table3, hosts=2, prf_method=3,
                            buckets=(batch,), device=dev)
    c.warmup()
    t0 = time.perf_counter()
    out_a = c.submit(ka).result()
    rec3["local_2_hosts_ms"] = 1e3 * (time.perf_counter() - t0)
    same("12.3 two local hosts", torch.from_numpy(out_a),
         torch.from_numpy(ref))
    rows_b = (out_a.astype(np.int64) - c.submit(kb).result()).astype(
        np.int32)
    same("12.3 two local hosts recovery", torch.from_numpy(rows_b),
         torch.from_numpy(want_rows))
    c.close()
    for policy in ("reshard", "degrade"):
        inj = FaultPlan([FaultSpec(kind="host_drop", construction="host3",
                                   start=1)], seed=12).injector()
        c = ClusterRouter.local(table3, hosts=4, prf_method=3,
                                buckets=(batch,), injector=inj,
                                policy=policy, device=dev)
        c.warmup()
        for j in range(3):
            inj.begin_arrival(j)
            same("12.3 %s arrival %d" % (policy, j),
                 torch.from_numpy(c.submit_resilient(ka).result()),
                 torch.from_numpy(ref))
        if c.decision_counts[policy] != 1 or \
                c.host_state("host3") != "down":
            raise AssertionError("phase 12.3 %s: decisions %s, host3 %s"
                                 % (policy, c.decision_counts,
                                    c.host_state("host3")))
        rec3[policy] = dict(decisions=dict(c.decision_counts),
                            assignment={k: list(v) for k, v in
                                        c.assignment.items()})
        log("  injected host_drop of host3 answered by %s: exact before, "
            "through and after; assignment %s" % (policy, c.assignment))
        c.close()
    t0 = time.perf_counter()
    nodes = cluster_net.spawn_cluster(n, 16, 2, table_seed=13, prf_method=3,
                                      buckets=(batch,), device=dev,
                                      timeout_s=300.0)
    c = ClusterRouter(nodes, granule=n // 2,
                      table_perm=expand.permute_table(table3),
                      policy="reshard", prf_method=3,
                      spare_engine_kw={"buckets": (batch,)}, device=dev)
    worker_counts = dict.fromkeys(read_counts(), 0)
    try:
        c.warmup()
        spawn_s = time.perf_counter() - t0
        same("12.3 two workers", torch.from_numpy(c.submit(ka).result()),
             torch.from_numpy(ref))
        for k, v in nodes[1].stats()["launches"].items():
            worker_counts[k] += v
        nodes[1].kill()                   # a real process death
        same("12.3 worker killed",
             torch.from_numpy(c.submit_resilient(ka).result()),
             torch.from_numpy(ref))
        # the survivor's counts include the resharded granule's launches
        for k, v in nodes[0].stats()["launches"].items():
            worker_counts[k] += v
        if c.decision_counts["reshard"] != 1:
            raise AssertionError("phase 12.3: the killed worker was not "
                                 "resharded (%s)" % c.decision_counts)
        for k in ("aes_level_step", "contract_i32"):
            if cuda and worker_counts[k] <= 0:
                raise AssertionError("kernel %s was never launched in the "
                                     "workers of phase 12.3" % k)
        rec3["workers"] = dict(spawn_and_warm_s=spawn_s,
                               decisions=dict(c.decision_counts),
                               launches=worker_counts)
        log("  two workers sharing %s (spawned and warmed in %.1f s), one "
            "killed and resharded onto the other: exact; worker launches "
            "%s" % (dev, spawn_s, worker_counts))
    finally:
        c.close()
        for node in nodes:
            node.kill()
    # paged: a host assigned two granules under a budget of one

    def allocated():
        if cuda:
            torch.cuda.synchronize()
            return torch.cuda.memory_allocated(dev)
        return 0
    gc.collect()
    m0 = allocated()
    srv = ClusterShardServer(perm, (0, g), g, prf_method=3,
                             budget_bytes=gbytes, device=dev)
    moved = [allocated() - m0]
    lease = srv.store.lease(0)
    moved.append(allocated() - m0)
    lease.release()
    part = srv._dispatch_packed(keygen.decode_keys_batched(ka))
    counts = read_counts()
    same("12.3 paged host", part[:batch], ref_paged)
    del part
    gc.collect()
    moved.append(allocated() - m0)
    st = srv.store.counters
    if cuda and moved != [0, gbytes, srv.store.resident_bytes] or \
            srv.store.resident_bytes > gbytes:
        raise AssertionError("phase 12.3 paged: memory_allocated moved by "
                             "%s, granule %d bytes, resident %d"
                             % (moved, gbytes, srv.store.resident_bytes))
    rec3["paged"] = dict(granule_bytes=gbytes, budget_bytes=gbytes,
                         memory_allocated_moves=moved,
                         counters=dict(st))
    log("  paged host (2 granules of %d bytes, budget 1): "
        "memory_allocated moved %s; store %s" % (gbytes, moved, dict(st)))
    del srv
    records["12.3 cluster"] = rec3
    for k, v in worker_counts.items():
        counts[k] += v
    parts["12.3 cluster"] = counts

    # --------------------------------------------- 12.4 tuner and benches
    zero_counts()
    log("phase 12.4 tune_mesh_eval: binary ChaCha20 N=%d E=16 B=%d on the "
        "1x4 mesh of %s" % (n, batch, dev))
    rec = tune_mesh_eval(n, batch, mesh=meshes[0][1], prf_method=2, reps=2,
                         distinct=8, force=True)
    m = rec["measured"]
    log("  heuristic %.4f ms, winner %.4f ms (%s), %d tried, %d rejected, "
        "%d gate escapes; %s"
        % (1e3 * m["heuristic_s"], 1e3 * m["best_s"],
           json.dumps(rec["knobs"]), m["candidates_tried"], m["rejected"],
           m["gate_escapes"], smi))
    if m["rejected"] or m["gate_escapes"]:
        raise AssertionError("phase 12.4 tune_mesh_eval: %d rejected, %d "
                             "gate escapes" % (m["rejected"],
                                               m["gate_escapes"]))
    records["12.4 tune_mesh_eval"] = dict(knobs=rec["knobs"], **{
        k: m[k] for k in ("best_s", "heuristic_s", "candidates_tried",
                          "rejected", "gate_escapes", "devices")})
    mc = multichip_bench(**dict(dict(shapes=((1 << 16, 64),), n_devices=2,
                                     device=dev, prf=2, reps=1, quiet=True,
                                     force=True), **(multichip_kw or {})))
    if mc["total_rejected"] or not mc["checked"]:
        raise AssertionError("phase 12.4 bench_multichip: %d rejected"
                             % mc["total_rejected"])
    log("  bench_multichip: %d devices %s (repeated %s), winner %s, serve "
        "%s %s qps; %s" % (mc["n_devices"], mc["mesh_devices"],
                           mc["repeated_device"],
                           [p["winner"] for p in mc["points"]],
                           mc["serve"]["mesh"], mc["serve"]["qps"], smi))
    mh = multihost_bench(**dict(dict(n=1 << 16, entry_size=16, cap=64,
                                     prf=3, hosts=2, mode="multiprocess",
                                     duration_s=1.5, on_rate=20.0,
                                     distinct=8, quiet=True, device=dev),
                                **(multihost_kw or {})))
    legs = ("baseline_leg", "chaos_degrade_leg", "chaos_reshard_leg")
    if mh["gate_escapes"] or not mh["pir_group_routing"]["checked"] or \
            not all(mh[leg]["drop_attributed"] for leg in legs[1:]):
        raise AssertionError("phase 12.4 bench_multihost: %d gate escapes, "
                             "attribution %s, PIR leg %s"
                             % (mh["gate_escapes"],
                                [mh[leg]["drop_attributed"]
                                 for leg in legs],
                                mh["pir_group_routing"]["checked"]))
    log("  bench_multihost (%s, %d hosts on %s): availability %s, p99 ms "
        "%s, gate escapes %d, checked %s; %s"
        % (mh["mode"], mh["hosts"], mh["device"],
           [mh[leg]["availability"] for leg in legs],
           [mh[leg]["p99_ms"] for leg in legs], mh["gate_escapes"],
           mh["checked"], smi))
    records["12.4 benches"] = dict(
        multichip={k: mc[k] for k in ("n_devices", "mesh_devices",
                                      "repeated_device", "points", "serve",
                                      "total_rejected", "elapsed_s")},
        multihost={k: mh[k] for k in ("mode", "hosts", "device",
                                      "device_name", "value", "checked",
                                      "gate_escapes")} | {
            leg: {f: mh[leg][f] for f in ("availability", "p50_ms",
                                          "p99_ms", "decision_counts",
                                          "drop_attributed")}
            for leg in legs})
    parts["12.4 tuner and benches"] = read_counts()
    log("phase 12: %.1f s" % (time.perf_counter() - t12))
    return parts, records

#: phase 13.1's constructions: (label, scheme, radix)
PIR_CONSTRUCTIONS = (("binary", "logn", 2), ("radix-4", "logn", 4),
                     ("sqrt-N", "sqrtn", 2))
#: the per-key kernel each construction launches once an entry and group,
#: by PRF id (AES: K6 after K1's levels)
PER_KEY_KERNEL = {("logn", 2, 3): "contract_i32_per_key",
                  ("logn", 2, 2): "subtree_contract_pkt",
                  ("logn", 4, 3): "contract_i32_per_key",
                  ("logn", 4, 2): "subtree_contract_mixed_pkt",
                  ("sqrtn", 2, 3): "sqrt_grid_contract_pkt",
                  ("sqrtn", 2, 2): "sqrt_grid_contract_pkt"}
SHARED_KERNELS = ("subtree_contract", "subtree_contract_mixed",
                  "contract_i32", "sqrt_grid_contract")


def _best_ms(fn, reps: int = 3) -> float:
    """Least host ms of ``reps`` calls of ``fn`` (each ends in a host
    gather)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, 1e3 * (time.perf_counter() - t0))
    return best


def last_modules_phase(smi, read_counts, zero_counts, entries=1 << 20,
                       small_entries=1 << 16, device=None, rounds=6,
                       plan_kw=None, fleet_rows=10 ** 9, bigtable_kw=None,
                       cli=True) -> tuple:
    """Phase 13, the last modules, on ``device`` (None = the card; the
    CPU rehearses it at small sizes), each part's counts set to 0 just
    before it and read just after; every one-device reference runs
    before the counts are zeroed.  (1) batch-PIR on meshes: phase 9's
    ``entries`` x 16 table in 256 bins, a 1 x 4 and a 2 x 2 mesh of the
    device repeated, the three constructions x AES-128 and ChaCha20:
    each meshed ``answer`` equal to the one-device server's, two meshed
    servers recovering every planned row, the per-key kernel launched
    once an entry and group and no shared-table K2 / K3 / K4, ``rounds``
    rounds through the 1 x 4 mesh's ``LookupStream`` equal to
    ``answer``; then ``small_entries`` x 16 in 37 bins (a group of 37:
    zero bins pad it to 40); (2) planning: ``device_memory_stats`` and
    ``detect_hbm_budget`` on the device, ``plan_bench`` (gate rejections,
    the planner's monotonicity and the real-engine autoscale leg raised
    on; the twin's fidelity verdicts printed as measured; on the card
    the twin's autoscale leg must fail its availability gate and no
    other, its known deviation) and ``plan_fleet`` for
    ``fleet_rows`` x 16 words at the device's own budget; (3)
    ``bigtable_bench`` (gate escapes, store misses and the paged hosts'
    memory raised on; the prefetch race's p99 verdict printed); (4) the
    ``--plan`` and ``--bigtable`` dry runs of ``python -m
    dpf_tpu_torch.benchmark`` in two processes at once.  Returns
    ({part: launch counts}, the phase's records)."""
    import numpy as np

    from dpf_tpu_torch.apps.batch_pir import (PrivateLookupClient,
                                              PrivateLookupServer)
    from dpf_tpu_torch.parallel import sharded
    from dpf_tpu_torch.plan.bench_plan import plan_bench
    from dpf_tpu_torch.plan.capacity import detect_hbm_budget, plan_fleet
    from dpf_tpu_torch.plan.twin import CostTable
    from dpf_tpu_torch.serve import bench_pir, loadgen
    from dpf_tpu_torch.serve.bench_bigtable import bigtable_bench
    from dpf_tpu_torch.utils.compat import device_memory_stats

    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    t13 = time.perf_counter()
    parts, records = {}, {}
    meshes = (("1x4", sharded.make_mesh(4, 1, devices=[dev] * 4)),
              ("2x2", sharded.make_mesh(2, 2, devices=[dev] * 4)))

    def exact(table, got, plan, what):
        want = sum(t is not None for t in plan)
        if len(got) != want or not all(
                np.array_equal(row, table[w]) for w, row in got.items()):
            raise AssertionError("phase 13.1 %s: recovered rows differ "
                                 "from the table" % what)
        return want

    def launches_ok(counts, kernel, want, what):
        if not cuda:
            return
        shared = {k: counts[k] for k in SHARED_KERNELS if counts[k]}
        if counts[kernel] != want or shared:
            raise AssertionError(
                "phase 13.1 %s: %s launched %d times (want %d, one an "
                "entry and group), shared-table kernels %s"
                % (what, kernel, counts[kernel], want, shared))

    # ---------------------------------------- 13.1 meshed batch-PIR
    table, opt = bench_pir._workload(entries, 16, 1 / 256.)
    bins = opt.hot_table_bins
    rounds_w = bench_pir._wanted_rounds(opt, entries, rounds)
    log("phase 13.1 meshed batch-PIR: %d x 16 table in %d bins of %d on "
        "meshes %s of %s (repeated), 3 constructions x AES-128 / ChaCha20"
        % (entries, len(bins), len(bins[0]),
           ", ".join(m for m, _ in meshes), dev))
    # the one-device references and timings, the key rounds and the
    # 37-bin plan's references first: the counts are zeroed after them
    refs = []
    for label, scheme, radix in PIR_CONSTRUCTIONS:
        for prf in (3, 2):
            kw = dict(prf=prf, radix=radix, scheme=scheme)
            one = PrivateLookupServer(table, bins, device=dev, **kw)
            client = PrivateLookupClient(bins, one.bin_sizes, entry_size=16,
                                         **kw)
            key_rounds = [client.make_queries(w) for w in rounds_w]
            ka = key_rounds[0][0]
            refs.append((label, scheme, radix, prf, kw, client, key_rounds,
                         one.answer(ka), _best_ms(lambda: one.answer(ka)),
                         len(one._groups)))
            del one
            gc.collect()
    small, sopt = bench_pir._workload(small_entries, 16,
                                      1772 / float(small_entries))
    sbins = sopt.hot_table_bins
    swant = bench_pir._wanted_rounds(sopt, small_entries, 1)[0]
    srefs = []
    for label, scheme, radix in PIR_CONSTRUCTIONS:
        kw = dict(prf=3, radix=radix, scheme=scheme)
        one = PrivateLookupServer(small, sbins, device=dev, **kw)
        client = PrivateLookupClient(sbins, one.bin_sizes, entry_size=16,
                                     **kw)
        ka, kb, plan = client.make_queries(swant)
        srefs.append((label, kw, client, ka, kb, plan, one.answer(ka)))
        del one

    zero_counts()
    rows13 = []
    for (label, scheme, radix, prf, kw, client, key_rounds, want, one_ms,
         groups) in refs:
        what = "%s prf %d" % (label, prf)
        ka, kb, plan = key_rounds[0]
        row = dict(construction=label, prf=prf, bins=len(bins),
                   groups=groups, one_device_ms=one_ms)
        for mname, mesh in meshes:
            srv_a, srv_b = (PrivateLookupServer(table, bins, mesh=mesh,
                                                **kw) for _ in range(2))
            before = read_counts()
            got = srv_a.answer(ka)
            after = read_counts()
            launches_ok({k: after[k] - before[k] for k in after},
                        PER_KEY_KERNEL[(scheme, radix, prf)],
                        mesh.size * groups, "%s %s" % (what, mname))
            if not np.array_equal(got, want):
                raise AssertionError("phase 13.1 %s %s: the meshed answer "
                                     "differs from the one device's"
                                     % (what, mname))
            row[mname + "_rows_recovered"] = exact(
                table, client.recover(got, srv_b.answer(kb), plan), plan,
                "%s %s" % (what, mname))
            row[mname + "_ms"] = _best_ms(lambda: srv_a.answer(ka))
            if mname == "1x4":
                stream = srv_a.stream(max_in_flight=2, warmup=True)
                futs = [(stream.submit(a), a) for a, _, _ in key_rounds]
                for fut, a in futs:
                    if not np.array_equal(fut.result(), srv_a.answer(a)):
                        raise AssertionError(
                            "phase 13.1 %s: the 1x4 mesh's stream differs "
                            "from answer" % what)
                row["stream_rounds"] = len(futs)
                del stream
            del srv_a, srv_b
        rows13.append(row)
        log("  %-8s prf %d: 1x4 and 2x2 answers equal the one device's, "
            "%d rows recovered on each, %d stream rounds equal answer; "
            "warm round ms (best of 3): one device %.3f, 1x4 %.3f, 2x2 "
            "%.3f (no gain claimed: one card) on %s"
            % (label, prf, row["1x4_rows_recovered"], row["stream_rounds"],
               one_ms, row["1x4_ms"], row["2x2_ms"], smi))
        gc.collect()
    # zero-bin padding: a group of 37 over the 1x4 mesh
    pads = {}
    for label, kw, client, ka, kb, plan, want in srefs:
        srv_a, srv_b = (PrivateLookupServer(small, sbins, mesh=meshes[0][1],
                                            **kw) for _ in range(2))
        got = srv_a.answer(ka)
        if not np.array_equal(got, want):
            raise AssertionError("phase 13.1 %s AES-128 %d bins: the 1x4 "
                                 "mesh differs from the one device"
                                 % (label, len(sbins)))
        exact(small, client.recover(got, srv_b.answer(kb), plan), plan,
              "%s %d bins" % (label, len(sbins)))
        pads[label] = {n: (len(g.idxs), g.gpad)
                       for n, g in srv_a._groups.items()}
        if not any(g.gpad for g in srv_a._groups.values()):
            raise AssertionError("phase 13.1: no zero-bin padding in %s"
                                 % pads[label])
    log("  %d x 16 in %d bins, AES-128, 1x4 mesh: (groups, zero bins) %s; "
        "equal to the one device, rows recovered" % (
            small_entries, len(sbins), pads))
    parts["13.1 meshed batch-PIR"] = read_counts()
    records["13.1 meshed batch-PIR"] = dict(rounds=rows13, padding=pads)
    del srv_a, srv_b, refs, srefs
    gc.collect()

    # ------------------------------------------------- 13.2 planning
    zero_counts()
    stats = device_memory_stats(dev)
    hbm = detect_hbm_budget(dev)
    if cuda:
        total_b = torch.cuda.mem_get_info(dev)[1]
        if stats["bytes_limit"] != total_b or hbm is None:
            raise AssertionError("phase 13.2: device_memory_stats %s, "
                                 "mem_get_info total %d, budget %s"
                                 % (stats, total_b, hbm))
    elif stats is not None or hbm is not None:
        raise AssertionError("phase 13.2: a CPU device has no ceiling")
    log("phase 13.2 planning: device_memory_stats %s, detect_hbm_budget "
        "%s on %s" % (stats, hbm, smi))
    pkw = dict(n=entries, entry_size=16, cap=512, prf=3, on_rate=None,
               on_load=1.5, duration_s=4.0, reps=1, distinct=8,
               device=dev, quiet=True)
    pkw.update(plan_kw or {})
    rec = plan_bench(**pkw)
    real = rec["autoscale_real"]
    if rec["gate_rejections"] or not rec["planner"]["monotone"] or \
            not real["ok"]:
        raise AssertionError("phase 13.2 plan_bench: %d gate rejections, "
                             "monotone %s, real autoscale leg %s"
                             % (rec["gate_rejections"],
                                rec["planner"]["monotone"], real))
    # the twin's autoscale leg compresses its trace by the cap bucket's
    # cost; on the card's bucket costs, which grow with the bucket, the
    # engine death leaves no replica and the leg fails availability and
    # no other gate.  Any other verdict is a change to look at
    twin = rec["autoscale_twin"]
    failed = sorted(k for k, v in twin["gates"].items() if not v)
    if cuda and failed != ["availability"]:
        raise AssertionError("phase 13.2 plan_bench: the twin's autoscale "
                             "leg failed gates %s (expected availability "
                             "alone): %s" % (failed, twin["gates"]))
    log("  autoscale twin leg (%s): gates %s, autoscaled availability %s "
        "and %s engine-hours against %d static replicas' %s, as measured"
        % ("ok" if twin["ok"] else "not ok", twin["gates"],
           twin["autoscaled"]["availability"],
           twin["autoscaled"]["engine_hours"], twin["static_replicas"],
           twin["static"]["engine_hours"]))
    for leg in rec["fidelity"]["legs"]:
        log("  fidelity %-15s (%s dispatch): real p99 %s ms, twin p99 %s "
            "ms, real shed %.4f, twin shed %.4f: %s %s as measured"
            % (leg["name"], rec["fidelity"]["dispatch_model"],
               leg["real"]["p99_ms"], leg["twin"]["p99_ms"],
               leg["real"]["shed_rate"], leg["twin"]["shed_rate"],
               leg["gated"], "within" if leg.get("p99_within",
                                                 leg.get("shed_within"))
               else "outside"))
    log("  plan_bench (%s, on_rate %.2f): worst p99 rel error %s, planner "
        "%s replicas / %s hosts (monotone), autoscale twin saved %s "
        "engine-hours, real ups %d downs %d, 0 gate rejections; %s"
        % (rec["construction"], rec["trace"]["on_rate"], rec["value"],
           rec["planner"]["replicas"], rec["planner"]["hosts"],
           rec["autoscale_twin"]["engine_hours_saved"],
           rec["autoscale_real"]["scale_ups"],
           rec["autoscale_real"]["scale_downs"], smi))
    fleet = plan_fleet(loadgen.default_bursty(512, seed=13),
                       CostTable(rec["cost_table"]),
                       label=rec["construction"], slo_s=0.25,
                       table_bytes=fleet_rows * 16 * 4, device=dev)
    log("  plan_fleet %d rows x 16 words (%d bytes) at this device's "
        "budget (%s, %s bytes): %d hosts minimum (memory floor %d), %d "
        "replicas" % (fleet_rows, fleet["memory"]["table_bytes"],
                      fleet["memory"]["hbm_source"],
                      fleet["memory"]["hbm_bytes_per_host"],
                      fleet["hosts"],
                      fleet["memory"]["hosts_memory_floor"],
                      fleet["replicas"]))
    parts["13.2 planning"] = read_counts()
    records["13.2 planning"] = dict(
        device_memory_stats=stats, hbm_budget=hbm,
        plan_bench={k: rec[k] for k in (
            "construction", "value", "trace", "cost_table", "fidelity",
            "planner", "plan_stats", "gate_rejections", "checked")} | {
            "autoscale_twin": {k: twin[k] for k in (
                "ok", "gates", "trace", "static", "static_replicas",
                "engine_hours_saved")} | {"autoscaled": {
                    k: v for k, v in twin["autoscaled"].items()
                    if k != "autoscale"}},
            "autoscale_real": rec["autoscale_real"]},
        plan_fleet=fleet)
    gc.collect()

    # ------------------------------------------------- 13.3 big table
    # (the bench computes its references, then zeroes the counts)
    bkw = dict(n=entries, entry_size=16, cap=512, prf=3, hosts=2,
               granules_per_host=4, budget_granules=2, distinct=4,
               device=dev, quiet=True, before_legs=zero_counts)
    bkw.update(bigtable_kw or {})
    log("phase 13.3 bigtable_bench: %d x 16, cap %d, AES-128, %d hosts x "
        "%d granules, budget %d granules a host, on %s"
        % (bkw["n"], bkw["cap"], bkw["hosts"], bkw["granules_per_host"],
           bkw["budget_granules"], dev))
    bt = bigtable_bench(**bkw)
    paged, race = bt["paged_cluster"], bt["prefetch_race"]
    misses = {h: st["counters"]["misses"]
              for h, st in paged["stores"].items()}
    mem = paged["memory"]
    if bt["gate_escapes"] or not all(misses.values()) or \
            (cuda and not mem["whole_granules"]) or \
            not (paged["checked"] and bt["mesh_2d"]["checked"]
                 and bt["plan"]["checked"]):
        raise AssertionError("phase 13.3 bigtable_bench: %d gate escapes, "
                             "store misses %s, memory %s, paged / mesh-2D "
                             "/ plan checked %s" % (
                                 bt["gate_escapes"], misses, mem,
                                 (paged["checked"], bt["mesh_2d"]["checked"],
                                  bt["plan"]["checked"])))
    log("  paged cluster: %d granules of %d bytes a host under a budget of "
        "%d bytes, availability %s, p99 %s ms, 0 gate escapes, store "
        "misses %s, memory_allocated %s; mesh-2D %d variants equal; plan "
        "floor %d hosts; on %s" % (
            paged["granules_per_host"], paged["assigned_bytes_per_host"]
            // paged["granules_per_host"], paged["budget_bytes_per_host"],
            paged["availability"], paged["p99_ms"], misses, mem,
            len(bt["mesh_2d"]["variants"]), bt["plan"]["hosts_memory_floor"],
            smi))
    log("  prefetch race p99 ms: off %s, on %s (x%s): the on side %s, as "
        "measured; prefetch hits %d" % (
            race["prefetch_off"]["p99_ms"], race["prefetch_on"]["p99_ms"],
            race["p99_speedup"],
            "does not lose" if race["checked"] else "loses",
            race["prefetch_on"]["store"]["counters"]["prefetch_hits"]))
    parts["13.3 big table"] = read_counts()
    records["13.3 big table"] = {k: bt[k] for k in (
        "table", "trace", "slo_ms", "paged_cluster", "prefetch_race",
        "mesh_2d", "gate_escapes", "checked")} | {
        "plan": {k: bt["plan"][k] for k in ("hosts_memory_floor",
                                            "memory_floor_binds",
                                            "jointly_monotone", "checked")}}
    gc.collect()

    # ------------------------------------------------------ 13.4 CLI
    if cli:
        t0 = time.perf_counter()
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=root)
        extra = [] if cuda else ["--device", "cpu"]
        procs = {flag: subprocess.Popen(
            [sys.executable, "-m", "dpf_tpu_torch.benchmark", flag,
             "--dryrun"] + extra, cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for flag in ("--plan", "--bigtable")}
        rcs = {}
        for flag, p in procs.items():
            out, err = p.communicate(timeout=600)
            rcs[flag] = p.returncode
            if p.returncode != 0 or not out.strip():
                raise AssertionError("phase 13.4 benchmark %s --dryrun "
                                     "exited %d: %s" % (flag, p.returncode,
                                                        err[-2000:]))
            json.loads(out.strip().splitlines()[-1])
        records["13.4 CLI"] = dict(rcs=rcs,
                                   seconds=time.perf_counter() - t0)
        log("phase 13.4 python -m dpf_tpu_torch.benchmark --plan --dryrun "
            "and --bigtable --dryrun (two processes at once): exit %s, "
            "%.1f s" % (rcs, time.perf_counter() - t0))
    log("phase 13: %.1f s" % (time.perf_counter() - t13))
    return parts, records


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # a fresh tuning cache: phases 1-10 resolve from the heuristics, and
    # a cache left on this machine cannot move their numbers
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    os.environ["DPF_TPU_TORCH_TUNE_CACHE"] = os.path.join(tune_dir,
                                                          "tuning.json")
    try:
        return _main(t_start)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def _main(t_start) -> int:
    import numpy as np

    import dpf_tpu_torch
    from dpf_tpu_torch import DPF, EvalConfig
    from dpf_tpu_torch.core import radix4, sqrtn
    from dpf_tpu_torch import benchmark, native
    from dpf_tpu_torch.core import keygen
    from dpf_tpu_torch.ops import (aes_level, cuda_build, matmul128,
                                   sqrt_grid, subtree)
    from dpf_tpu_torch.utils import profile_batch, sass_count
    from dpf_tpu_torch.utils.bench import (cuda_ms, profiled_ms,
                                           test_dpf_latency, test_dpf_perf,
                                           test_matmul_perf)

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
        err = max_abs_err(got, want)
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
            "chacha_level_step": 0, "contract_i32_per_key": 0,
            "subtree_contract_pkt": 0, "subtree_contract_mixed_pkt": 0,
            "sqrt_grid_contract_pkt": 0}
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
        ops=nodes * k1_node_work(2)[0],
        lookups=nodes * k1_node_work(2)[1],
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
        ops=nodes * k1_node_work(4)[0],
        lookups=nodes * k1_node_work(4)[1],
        shape="B=%d w=%d -> 4w (one radix-4 level)" % (bsz, w))
    k1_low(rows["aes_level_step_a4"], seeds, c1, c2, 4)
    del seeds, cw1, cw2, c1, c2

    # K3: contraction.  Every path hands it a contiguous plane of the
    # leaves' low limbs (K1's low-limb form, or the plain step's limb 0
    # copied out); its strided form (the low limbs of [B, C, 4] leaves,
    # element stride 4) is held too; K = 2^18 at N = 2^20,
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

    # K2's leaf-range form (subtree_contract_window: a mesh shard's or a
    # cluster granule's rows, phase 12; the window is a launch argument,
    # the first block subtree and a power-of-two count): ranges of 80 and
    # 7 blocks (two and three launches) at ragged batches, held against
    # the plain version; then the 4-way table mesh's second shard at
    # N = 2^20 (rows 2^18 .. 2^19, B = 512) held and timed, binary
    # ChaCha20 and radix-4 ChaCha20-BLK
    from dpf_tpu_torch.parallel.sharded import tree_levels
    k2_window = {}
    for radix_w, p, row0_w, rows_w, bsz_w in (
            (2, dpf_tpu_torch.PRF_CHACHA20, 3 << 16, 5 << 16, 33),
            (2, dpf_tpu_torch.PRF_SALSA20_BLK, 7 << 12, 7 << 12, 5),
            (4, dpf_tpu_torch.PRF_CHACHA20_BLK, 1 << 18, 3 << 16, 33),
            (4, dpf_tpu_torch.PRF_SALSA20, 1 << 16, 7 << 16, 5),
            (2, dpf_tpu_torch.PRF_CHACHA20, 1 << 18, 1 << 18, 512),
            (4, dpf_tpu_torch.PRF_CHACHA20_BLK, 1 << 18, 1 << 18, 512)):
        ars_w, offs_w = tree_levels(n, radix_w)
        frw, c1w, c2w = rnd(bsz_w, 1, 4), rnd(bsz_w, 64, 4), \
            rnd(bsz_w, 64, 4)
        tblw = rnd(rows_w, 16)
        kw = dict(sched=list(zip(ars_w, offs_w)), row0=row0_w, prf_method=p,
                  block_leaves=4096, radix=radix_w)
        entry = (subtree.subtree_contract if radix_w == 2
                 else subtree.subtree_contract_mixed)
        t0 = time.perf_counter()
        want = subtree.subtree_contract_window_plain(frw, c1w, c2w, tblw,
                                                     **kw)
        sync()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        name = "%s %s rows [%d, %d)" % (
            "binary" if radix_w == 2 else "radix-4", prf_names[p], row0_w,
            row0_w + rows_w)
        errs[entry.__name__] |= held(
            "K2 window %s B=%d" % (name, bsz_w),
            subtree.subtree_contract_window(frw, c1w, c2w, tblw, **kw), want)
        if bsz_w != 512:
            continue
        arity = radix_w
        # parents below the shard's node, and the walk from the root to
        # it: one parent a level above the node
        above = next(j for j in range(len(ars_w) + 1)
                     if int(np.prod(ars_w[j:])) == rows_w)
        nodes_w = (rows_w - 1) // (arity - 1) + above
        blocks = 1 if p in (4, 5) else arity if radix_w == 4 else 2
        ops = bsz_w * (nodes_w * (blocks * OPS_CORE_BLOCK
                                  + arity * OPS_CHILD_ADD)
                       + rows_w * 16 * 2)
        r = dict(ms=cuda_ms(lambda: subtree.subtree_contract_window(
                     frw, c1w, c2w, tblw, **kw), 5),
                 plain_ms=plain_ms, library_ms=None,
                 bytes=bsz_w * 16 + 2 * bsz_w * 64 * 16 + rows_w * 16 * 4
                 + bsz_w * 16 * 4,
                 ops=ops,
                 pipe_bound_ms=pipe_bound_ms(
                     ops, bsz_w * nodes_w * blocks * OPS_CORE_BLOCK_ALU,
                     bsz_w * rows_w * 16),
                 shape="%s B=512 E=16" % name)
        log_row("K2 shard window", r)
        log("    pipe bound ms %.4f on %s" % (r["pipe_bound_ms"], smi))
        k2_window[name] = r
    del fr, cw1, cw2, tbl, tbl1, frs, c1s, c2s, tbls, frw, c1w, c2w, tblw
    torch.cuda.empty_cache()

    # K5: the ChaCha20 level step (the dispatch mode's ChaCha20 levels,
    # phase 7.2); held and timed at K1's widest shape
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

    # the per-key-table forms (batch-PIR, phase 9): every key its own
    # table of [G, n, E]; at phase 9's shape G = 256 bins of n = 4096
    # rows, E = 16 (2^20 x 16 in 256 bins).  K6 first: small, ragged,
    # strided and row-chunk shapes, then the main path's.  Why it exists:
    # torch's int32 batched product on CUDA (probed, not relied on)
    try:
        probe = torch.bmm(rnd(2, 1, 4), rnd(2, 4, 3))
        bmm_note = "supported (%s)" % probe.dtype
    except (NotImplementedError, RuntimeError) as exc:
        bmm_note = "%s: %s" % (type(exc).__name__,
                               str(exc).splitlines()[0])
    log("  torch.bmm int32 on CUDA: %s" % bmm_note)
    for bsz, k, e, inc in ((1, 7, 16, 1), (3, 1001, 16, 1), (5, 300, 4, 4),
                           (3, 300, 3, 1), (2, 400, 20, 3), (1, 64, 260, 1),
                           (256, 4096, 16, 4)):
        a, t = rnd(bsz, k, inc)[..., 0], rnd(bsz, k, e)
        errs["contract_i32_per_key"] |= held(
            "K6 contract_i32_per_key B=%d C=%d E=%d inc=%d"
            % (bsz, k, e, inc), matmul128.dot_i32_per_key(a, t),
            matmul128.dot_i32_per_key_plain(a, t))
    g9, n9 = 256, 4096
    a, t = rnd(g9, n9), rnd(g9, 2 * n9, 16)
    errs["contract_i32_per_key"] |= held(
        "K6 contract_i32_per_key row chunk of [256, 8192, 16]",
        matmul128.dot_i32_per_key(a, t[:, n9 // 2:3 * n9 // 2]),
        matmul128.dot_i32_per_key_plain(a, t[:, n9 // 2:3 * n9 // 2]))
    t = t[:, :n9].contiguous()
    t0 = time.perf_counter()
    want = matmul128.dot_i32_per_key_plain(a, t)
    sync()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    errs["contract_i32_per_key"] |= held(
        "K6 contract_i32_per_key B=256 C=4096 E=16",
        matmul128.dot_i32_per_key(a, t), want)
    # each new row's kernel time comes from one profiler session below
    pkt_calls = {"contract_i32_per_key": (
        lambda a=a, t=t: matmul128.dot_i32_per_key(a, t),
        "contract_pkt_kernel<true>")}
    rows["contract_i32_per_key"] = dict(
        events_ms=cuda_ms(lambda: matmul128.dot_i32_per_key(a, t), 50),
        plain_ms=plain_ms, library_ms=None, library_note=bmm_note,
        bytes=g9 * n9 * 16 * 4 + g9 * n9 * 4 + g9 * 16 * 4,
        ops=2 * g9 * n9 * 16,
        shape="[256, 4096] x [256, 4096, 16] (phase 9's group)")
    del a, t, want
    # K2's per-key mode, one key a block: every stream-cipher id in both
    # trees at ragged G (1, 3, 5, 255, 257), small n and E of 16, 3 and 1,
    # at the block the wrapper picks (None) and at small explicit ones
    for prf in subtree.SUBTREE_PRFS:
        for bsz, depth, cb, e in ((1, 7, None, 16), (3, 9, 2, 3),
                                  (5, 12, None, 16), (255, 8, None, 1),
                                  (257, 10, 64, 16)):
            fr, cw1, cw2 = rnd(bsz, 1, 4), rnd(bsz, 64, 4), rnd(bsz, 64, 4)
            tbl = rnd(bsz, 1 << depth, e)
            kw = dict(depth=depth, f_levels=0, prf_method=prf,
                      block_leaves=cb)
            errs["subtree_contract_pkt"] |= held(
                "K2 per-key prf=%d G=%d n=2^%d E=%d block %s"
                % (prf, bsz, depth, e, cb),
                subtree.subtree_contract(fr, cw1, cw2, tbl, **kw),
                subtree.subtree_contract_plain(fr, cw1, cw2, tbl, **kw))
            ars = radix4.arities(1 << depth)
            kw = dict(ars=ars, f_lv=0, prf_method=prf, block_leaves=None
                      if cb is None else radix4._suffix_chunk(ars, cb)[1])
            errs["subtree_contract_mixed_pkt"] |= held(
                "K2 mixed per-key prf=%d G=%d n=2^%d E=%d block %s"
                % (prf, bsz, depth, e, kw["block_leaves"]),
                subtree.subtree_contract_mixed(fr, cw1, cw2, tbl, **kw),
                subtree.subtree_contract_mixed_plain(fr, cw1, cw2, tbl,
                                                     **kw))
    # K4's per-key mode, one key an item: every id at ragged G, K above
    # and below the 256 columns of a sub-tile, a row base, E of 16, 3, 1
    for prf in range(6):
        for bsz, k, r, e, row0 in ((1, 64, 64, 16, 0), (3, 512, 8, 16, 8),
                                   (5, 300, 12, 3, 4), (255, 32, 32, 1, 0),
                                   (257, 16, 16, 16, 0)):
            wire = rnd(bsz, 4 * (k + 2 * r))
            seeds = wire[:, :4 * k].unflatten(1, (k, 4))
            cw1 = wire[:, 4 * k:4 * (k + r)].unflatten(1, (r, 4))
            cw2 = wire[:, 4 * (k + r):].unflatten(1, (r, 4))
            tbl = rnd(bsz, r * k, e)
            kw = dict(prf_method=prf, row0=row0)
            errs["sqrt_grid_contract_pkt"] |= held(
                "K4 per-key prf=%d G=%d K=%d R=%d E=%d row0=%d"
                % (prf, bsz, k, r, e, row0),
                sqrt_grid.sqrt_grid_contract(seeds, cw1, cw2, tbl, **kw),
                sqrt_grid.sqrt_grid_contract_plain(seeds, cw1, cw2, tbl,
                                                   **kw))

    # the sweep: one 2^20 x 16 table cut into G bins of n rows, the same
    # 64 MiB of per-key tables at every point; (256, 4096) is phase 9's
    # group.  Each point's six rows are timed in one profiler session
    # (K6 joins phase 9's point)
    chacha = dpf_tpu_torch.PRF_CHACHA20
    chacha_blk = dpf_tpu_torch.PRF_CHACHA20_BLK
    pkt_sweep = []
    for g, n in ((256, 4096), (16, 65536), (1024, 1024)):
        depth = n.bit_length() - 1
        tbl = rnd(g, n, 16)
        fr, cw1, cw2 = rnd(g, 1, 4), rnd(g, 64, 4), rnd(g, 64, 4)
        calls = dict(pkt_calls) if g == g9 and n == n9 else {}
        point = {}
        # K2: a binary tree has n - 1 parents of 2 children, a radix-4
        # tree (n - 1) / 3 of 4; ChaCha20 takes a core block a child, the
        # block-PRG ids one a parent
        for key, name, entry, plain, kw, nodes, arity, blocks in (
                ("binary ChaCha20", "subtree_contract_pkt",
                 subtree.subtree_contract, subtree.subtree_contract_plain,
                 dict(depth=depth, f_levels=0, prf_method=chacha), n - 1,
                 2, 2),
                ("radix-4 ChaCha20", "subtree_contract_mixed_pkt",
                 subtree.subtree_contract_mixed,
                 subtree.subtree_contract_mixed_plain,
                 dict(ars=radix4.arities(n), f_lv=0, prf_method=chacha),
                 (n - 1) // 3, 4, 4),
                ("radix-4 ChaCha20-BLK", "subtree_contract_mixed_pkt",
                 subtree.subtree_contract_mixed,
                 subtree.subtree_contract_mixed_plain,
                 dict(ars=radix4.arities(n), f_lv=0, prf_method=chacha_blk),
                 (n - 1) // 3, 4, 1)):
            t0 = time.perf_counter()
            want = plain(fr, cw1, cw2, tbl, **kw)
            sync()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            errs[name] |= held("K2 %s G=%d n=%d" % (key, g, n),
                               entry(fr, cw1, cw2, tbl, **kw), want)
            ops = g * (nodes * (blocks * OPS_CORE_BLOCK
                                + arity * OPS_CHILD_ADD) + n * 16 * 2)
            calls[key] = (
                lambda entry=entry, kw=kw, fr=fr, cw1=cw1, cw2=cw2, tbl=tbl:
                entry(fr, cw1, cw2, tbl, **kw),
                "subtree_pkt_kernel<%d, %s>" % (kw["prf_method"], "true"
                                                if arity == 2 else "false"))
            point[key] = dict(
                name=name, plain_ms=plain_ms, library_ms=None,
                bytes=g * 16 + 2 * g * 64 * 16 + g * n * 16 * 4 + g * 16 * 4,
                ops=ops, pipe_bound_ms=pipe_bound_ms(
                    ops, g * nodes * blocks * OPS_CORE_BLOCK_ALU, g * n * 16),
                block_leaves=subtree.pkt_block_leaves(
                    g, kw.get("ars", (2,) * depth)),
                shape="%s G=%d n=%d E=16, per-key tables" % (key, g, n))
            del want
        # K4, K = R = sqrt(n); seeds and codewords views of one wire buffer
        k, r = sqrtn.default_split(n)
        wire = rnd(g, 4 * (k + 2 * r))
        seeds = wire[:, :4 * k].unflatten(1, (k, 4))
        c1 = wire[:, 4 * k:4 * (k + r)].unflatten(1, (r, 4))
        c2 = wire[:, 4 * (k + r):].unflatten(1, (r, 4))
        for key, prf in (("AES-128", dpf_tpu_torch.PRF_AES128),
                         ("ChaCha20", chacha), ("ChaCha20-BLK", chacha_blk)):
            kw = dict(prf_method=prf)
            t0 = time.perf_counter()
            want = sqrt_grid.sqrt_grid_contract_plain(
                seeds, c1, c2, tbl, row_chunk=sqrt_grid.pkt_row_chunk(r, k),
                **kw)
            sync()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            errs["sqrt_grid_contract_pkt"] |= held(
                "K4 %s G=%d n=%d" % (key, g, n),
                sqrt_grid.sqrt_grid_contract(seeds, c1, c2, tbl, **kw), want)
            calls["sqrt-N " + key] = (
                lambda kw=kw, seeds=seeds, c1=c1, c2=c2, tbl=tbl:
                sqrt_grid.sqrt_grid_contract(seeds, c1, c2, tbl, **kw),
                "sqrt_grid_pkt_kernel<%d>" % prf)
            point["sqrt-N " + key] = dict(
                name="sqrt_grid_contract_pkt", plain_ms=plain_ms,
                library_ms=None,
                bytes=g * k * 16 + 2 * g * r * 16 + g * n * 16 * 4
                + g * 16 * 4, ops=sqrt_ops(prf, g * n, 16),
                lookups=g * n * (LOOKUPS_AES_BLOCK + LOOKUPS_AES_SCHEDULE
                                 // 4) if prf == 3 else None,
                row_chunk=sqrt_grid.pkt_row_chunk(r, k),
                shape="%s sqrt-N G=%d n=%d (K=R=%d) E=16, per-key tables"
                      % (key, g, n, k))
            del want
        for key, ms in profiled_ms(calls).items():
            if key in point:
                r_ = point[key]
                r_["ms"] = ms
                r_["bound_ms"], r_["bound_by"], r_["lookup_floor_ms"] = \
                    bound(r_)
                # the tighter limit: the bound, K2's pipe bound or the
                # AES lookup floor, whichever is the largest
                r_["limit_ms"] = max(r_["bound_ms"],
                                     r_["lookup_floor_ms"] or 0.0,
                                     r_.get("pipe_bound_ms", 0.0))
                r_["limit_share"] = r_["limit_ms"] / ms
                log("  per-key %-22s G=%-5d n=%-6d ms %.4f  bound_ms %.4f "
                    "(%s)  limit_ms %.4f  share %.3f  plain_ms %.1f  %s"
                    % (key, g, n, ms, r_["bound_ms"], r_["bound_by"],
                       r_["limit_ms"], r_["limit_share"], r_["plain_ms"],
                       "block %d" % r_["block_leaves"]
                       if "block_leaves" in r_ else
                       "rows %d" % r_["row_chunk"]))
                pkt_sweep.append(dict(r_, instance=key, g=g, n=n))
            else:
                rows[key]["ms"] = ms            # K6 at phase 9's group
        if g == g9 and n == n9:
            for key, name in (("binary ChaCha20", "subtree_contract_pkt"),
                              ("radix-4 ChaCha20",
                               "subtree_contract_mixed_pkt"),
                              ("sqrt-N AES-128", "sqrt_grid_contract_pkt")):
                rows[name] = {k_: v for k_, v in point[key].items()
                              if k_ not in ("name", "limit_ms",
                                            "limit_share")}
        del tbl, fr, cw1, cw2, wire, seeds, c1, c2, calls
        torch.cuda.empty_cache()
    del pkt_calls

    for name, r in rows.items():
        log_row(name, r)

    # ---------------------------------------- the main paths: 3 + 4 + 5
    read_counts, zero_counts = launch_counters()

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
    for name, radix, arity in (("aes_level_step", 2, 2),
                               ("aes_level_step_a4", 4, 4)):
        ops, lookups = k1_node_work(arity)
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
                    lookups=nodes * lookups - leaves * LOOKUPS_AES_LOW_SAVED)
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

    # ------------------------------------------------------ 7. serving
    parts, serving = serving_phase(smi, read_counts, zero_counts)
    path7 = {
        "7.1 engine": ("aes_level_step", "aes_level_step_a4",
                       "subtree_contract", "sqrt_grid_contract",
                       "contract_i32"),
        "7.2 dispatch": ("aes_level_step", "aes_level_step_a4",
                         "chacha_level_step", "contract_i32"),
        "7.3 overlap": ("aes_level_step", "contract_i32"),
        "7.4 router": ("aes_level_step", "contract_i32")}
    for part, counts in parts.items():
        log("phase %s launches: %s" % (part, counts))
        for k in path7[part]:
            if counts[k] <= 0:
                raise AssertionError("kernel %s was never launched in phase "
                                     "%s" % (k, part))
    by_path.update(parts)
    log(json.dumps({"phase7": serving}))

    # --------------------------------------- 8. tables and tenants
    parts, multitable = multitable_phase(smi, read_counts, zero_counts)
    path8 = ("aes_level_step", "aes_level_step_a4", "sqrt_grid_contract",
             "contract_i32")
    for part, counts in parts.items():
        log("phase %s launches: %s" % (part, counts))
        for k in path8:
            if counts[k] <= 0:
                raise AssertionError("kernel %s was never launched in phase "
                                     "%s" % (k, part))
    by_path.update(parts)
    log(json.dumps({"phase8": multitable}, default=str))

    # ------------------------------------------------------- 9. batch-PIR
    counts, _ = batch_pir_phase(smi, read_counts, zero_counts)
    log("phase 9 launches: %s" % counts)
    for k in ("aes_level_step", "aes_level_step_a4", "contract_i32_per_key",
              "subtree_contract_pkt", "subtree_contract_mixed_pkt",
              "sqrt_grid_contract_pkt"):
        if counts[k] <= 0:
            raise AssertionError("kernel %s was never launched in phase 9"
                                 % k)
    shared = {k: counts[k] for k in ("subtree_contract",
                                     "subtree_contract_mixed",
                                     "contract_i32", "sqrt_grid_contract")
              if counts[k]}
    if shared:
        raise AssertionError("phase 9 launched shared-table kernels: %s"
                             % shared)
    by_path["phase 9"] = counts

    # ------------------------- 10. models, the bitsliced AES, the PRF zoo
    parts, rows["prf_zoo"], errs["prf_zoo"], _ = models_zoo_phase(
        smi, read_counts, zero_counts)
    for part, counts in parts.items():
        log("phase %s launches: %s" % (part, counts))
    dpf_kernels = {k: v for k, v in parts["10.1 models"].items() if v}
    if dpf_kernels:
        raise AssertionError("phase 10.1 launched %s" % dpf_kernels)
    zoo = parts["10.3 zoo"]
    if zoo["prf_zoo"] <= 0 or any(v for k, v in zoo.items()
                                  if k != "prf_zoo"):
        raise AssertionError("phase 10.3 launches %s: K7 and nothing else "
                             "expected" % zoo)
    by_path.update(parts)

    # ---------------------------------------- 11. tuning and the trace
    # phases 1-10 ran on the fresh cache: every lookup missed, so every
    # knob they did not pin resolved from the heuristics
    from dpf_tpu_torch.utils.profiling import CACHE_COUNTERS
    log("phases 1-10 tuning cache: %s" % CACHE_COUNTERS.as_dict())
    if CACHE_COUNTERS.tuning_hits or CACHE_COUNTERS.tuning_stores:
        raise AssertionError("phases 1-10 read or wrote tuned knobs: %s"
                             % CACHE_COUNTERS.as_dict())
    parts, tuning = tuning_phase(smi, read_counts, zero_counts)
    for part, counts in parts.items():
        log("phase %s launches: %s" % (part, counts))
    tuned = parts["11.1 tune_eval"]
    for k in ("aes_level_step", "contract_i32", "subtree_contract_mixed",
              "sqrt_grid_contract"):
        if tuned[k] <= 0:
            raise AssertionError("kernel %s was never launched in phase "
                                 "11.1" % k)
    for k in ("subtree_contract", "chacha_level_step"):
        if parts["11.2 kernel_search_ggm"][k] <= 0:
            raise AssertionError("kernel %s was never launched in phase "
                                 "11.2" % k)
    by_path.update(parts)
    log(json.dumps({"phase11": tuning}, default=str))

    # --------------------------- 12. multi-GPU and the cluster tier
    parts, mesh_cluster = mesh_cluster_phase(smi, read_counts, zero_counts)
    path12 = {
        "12.1 sharded": ("aes_level_step", "aes_level_step_a4",
                         "subtree_contract", "subtree_contract_mixed",
                         "contract_i32", "sqrt_grid_contract"),
        "12.2 multihost": ("subtree_contract",),
        "12.3 cluster": ("aes_level_step", "contract_i32"),
        "12.4 tuner and benches": ("subtree_contract",
                                   "subtree_contract_mixed",
                                   "sqrt_grid_contract")}
    for part, counts in parts.items():
        log("phase %s launches: %s" % (part, counts))
        for k in path12[part]:
            if counts[k] <= 0:
                raise AssertionError("kernel %s was never launched in phase "
                                     "%s" % (k, part))
    by_path.update(parts)
    log(json.dumps({"phase12": mesh_cluster}, default=str))

    # ------------------------------------------------- 13. the last modules
    parts, last = last_modules_phase(smi, read_counts, zero_counts)
    path13 = {
        "13.1 meshed batch-PIR": ("aes_level_step", "aes_level_step_a4",
                                  "contract_i32_per_key",
                                  "subtree_contract_pkt",
                                  "subtree_contract_mixed_pkt",
                                  "sqrt_grid_contract_pkt"),
        "13.2 planning": ("aes_level_step", "contract_i32"),
        "13.3 big table": ("aes_level_step", "contract_i32")}
    for part, counts in parts.items():
        log("phase %s launches: %s" % (part, counts))
        for k in path13[part]:
            if counts[k] <= 0:
                raise AssertionError("kernel %s was never launched in phase "
                                     "%s" % (k, part))
    shared = {k: v for k, v in parts["13.1 meshed batch-PIR"].items()
              if k in SHARED_KERNELS and v}
    if shared:
        raise AssertionError("phase 13.1 launched shared-table kernels: %s"
                             % shared)
    by_path.update(parts)
    log(json.dumps({"phase13": last}, default=str))

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
        "contract_i32_per_key": ("dpf_tpu_torch/csrc/contract_pkt.cu",
                                 "dpf_tpu/core/expand.py:470"),
        "subtree_contract_pkt": ("dpf_tpu_torch/csrc/subtree.cu",
                                 "dpf_tpu/ops/pallas_level.py:402"),
        "subtree_contract_mixed_pkt": ("dpf_tpu_torch/csrc/subtree.cu",
                                       "dpf_tpu/ops/pallas_level.py:442"),
        "sqrt_grid_contract_pkt": ("dpf_tpu_torch/csrc/sqrt_grid.cu",
                                   "dpf_tpu/ops/pallas_sqrt.py:312"),
        "prf_zoo": ("dpf_tpu_torch/csrc/prf_zoo.cu",
                    "dpf_tpu/core/prf_zoo.py:132"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = rows[name]
        launches = {p: c[name] for p, c in by_path.items() if c[name]}
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
    log(json.dumps({"k2_window": k2_window}))
    log(json.dumps({"pkt_sweep": pkt_sweep}))
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
