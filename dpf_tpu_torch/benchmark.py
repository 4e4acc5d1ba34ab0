"""The reference's default benchmark sweep on the port.

Port of the root ``benchmark.py``'s default mode (``:286-291``): N in
{2^14, 2^16, 2^18, 2^20} x {AES-128, Salsa20, ChaCha20}, B = 512 keys a
dispatch, E = 16 int32 words an entry, binary tree, through
``utils/bench.test_dpf_perf(check=True)``: every key of the batch
distinct (one ``gen_batch`` call), every row recovered from both
servers' shares before the timed batches.  One JSON line a row with
dpfs/s, ms a batch and the host's keygen seconds, and beside them the
upstream GPU-DPF's published dpfs/s for the same (N, PRF) on a P100 and
a V100 (``BASELINE.md``, from its ``README.md:105-146``): an outside
yardstick, other cards and code, not a number of this port.  The last
line is ``nvidia-smi``'s name and power limit.  Needs one CUDA card:

    python -m dpf_tpu_torch.benchmark [--n N ...] [--prf ID ...] [--reps R]

Every other mode of the root ``benchmark.py`` (``:229-291``) runs here
too, routed in the root's order to the port's module, the flag removed
and the rest of the arguments passed on (``MODES``): ``--multichip``
(the mesh autotune matrix), ``--multihost`` (the serving cluster across
a host's death), ``--bigtable`` (paged granules, the prefetch race, 2D
meshes, memory-aware planning), ``--batch-pir``, ``--load`` (router vs
sticky engine under bursts), ``--chaos``, ``--multitenant``, ``--plan``
(the digital twin against the card), ``--trace`` (tracing overhead),
``--autotune-kernel`` (``tune.kernel_search``), ``--autotune-scheme``
(``tune.search --scheme-sweep``), ``--autotune`` (``tune.search``) and
``--serve``.  Each runs on the card
unless its ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .core.prf_ref import PRF_AES128, PRF_CHACHA20, PRF_SALSA20
from .utils.bench import gpu_name_and_power, test_dpf_perf

SWEEP_N = (1 << 14, 1 << 16, 1 << 18, 1 << 20)
SWEEP_PRFS = (PRF_AES128, PRF_SALSA20, PRF_CHACHA20)

# (N, PRF id) -> upstream dpfs/s by card (BASELINE.md, upstream
# README.md:105-116 for the P100, :129-146 for the V100)
BASELINE_DPFS = {
    (1 << 14, PRF_AES128): {"P100": 23954, "V100": 52536},
    (1 << 14, PRF_SALSA20): {"P100": 76073, "V100": 145646},
    (1 << 14, PRF_CHACHA20): {"P100": 75679, "V100": 139590},
    (1 << 16, PRF_AES128): {"P100": 6131, "V100": 15392},
    (1 << 16, PRF_SALSA20): {"P100": 23141, "V100": 54892},
    (1 << 16, PRF_CHACHA20): {"P100": 22433, "V100": 56120},
    (1 << 18, PRF_AES128): {"P100": 1443, "V100": 3967},
    (1 << 18, PRF_SALSA20): {"P100": 5849, "V100": 16650},
    (1 << 18, PRF_CHACHA20): {"P100": 5830, "V100": 16086},
    (1 << 20, PRF_AES128): {"P100": 379, "V100": 923},
    (1 << 20, PRF_SALSA20): {"P100": 1447, "V100": 3894},
    (1 << 20, PRF_CHACHA20): {"P100": 1424, "V100": 4054},
}


def sweep_configs(ns=SWEEP_N, prfs=SWEEP_PRFS) -> list:
    """The sweep's ``(N, PRF id)`` rows, N outermost as upstream."""
    return [(n, prf) for n in ns for prf in prfs]


def run_sweep(configs=None, batch: int = 512, entrysize: int = 16,
              reps: int = 10, device=None, quiet: bool = False) -> list:
    """One checked ``test_dpf_perf`` a configuration; the rows, each
    printed as one JSON line unless ``quiet``."""
    rows = []
    for n, prf in configs or sweep_configs():
        r = test_dpf_perf(N=n, batch=batch, entrysize=entrysize, prf=prf,
                          reps=reps, check=True, quiet=True, device=device)
        row = {k: r[k] for k in (
            "entries", "prf", "batch_size", "entry_size", "device",
            "keys_distinct", "checked", "dpfs_per_sec", "ms_per_batch",
            "keygen", "keygen_s", "reps")}
        row["yardstick_dpfs_per_sec"] = {
            "source": "BASELINE.md: upstream GPU-DPF README, other cards",
            **BASELINE_DPFS.get((n, prf), {})}
        rows.append(row)
        if not quiet:
            print(json.dumps(row), flush=True)
    return rows


#: the root ``benchmark.py``'s modes in its order: (flag, the port's
#: module whose ``main`` takes the rest of the arguments, arguments it
#: adds)
MODES = (("--multichip", ".serve.bench_multichip", ()),
         ("--multihost", ".serve.bench_multihost", ()),
         ("--bigtable", ".serve.bench_bigtable", ()),
         ("--batch-pir", ".serve.bench_pir", ()),
         ("--load", ".serve.bench_load", ()),
         ("--chaos", ".serve.bench_chaos", ()),
         ("--multitenant", ".serve.bench_multitenant", ()),
         ("--plan", ".plan.bench_plan", ()),
         ("--trace", ".obs.bench_trace", ()),
         ("--autotune-kernel", ".tune.kernel_search", ()),
         ("--autotune-scheme", ".tune.search", ("--scheme-sweep",)),
         ("--autotune", ".tune.search", ()),
         ("--serve", ".serve.bench_serve", ()))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    for flag, module, added in MODES:
        if flag in argv:
            import importlib
            importlib.import_module(module, __package__).main(
                [a for a in argv if a != flag] + list(added))
            return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, action="append",
                    help="table size (repeatable; default the sweep's)")
    ap.add_argument("--prf", type=int, action="append",
                    help="PRF id (repeatable; default 3, 1, 2)")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device", file=sys.stderr)
        return 2
    run_sweep(sweep_configs(args.n or SWEEP_N, args.prf or SWEEP_PRFS),
              reps=args.reps)
    print(gpu_name_and_power())
    return 0


if __name__ == "__main__":
    sys.exit(main())
