"""Multi-process scale-out: ``torch.distributed`` init and the global
mesh (port of ``dpf_tpu/parallel/multihost.py``).

Where the JAX package starts ``jax.distributed`` and builds one mesh
over every process's devices, here each process joins a process group
and contributes one device; ``global_mesh`` lays the ranks out on
("batch", "table") axes, each process evaluates its own entries and the
partials meet in one wrapping int32 ``all_reduce``
(``sharded.mesh_sum``):

    multihost.initialize("tcp://10.0.0.1:29500", 2, rank)
    mesh = multihost.global_mesh(n_table=2)
    srv = sharded.ShardedDPFServer(table, mesh)     # same code as one process

The backend is the caller's, or follows the devices: NCCL when every
rank has a card of its own, gloo on the CPU or when ranks share a card
(NCCL refuses two ranks on one GPU).  A failed init raises or, with no
arguments and no cluster in sight, returns False with the cause kept in
``init_error()``; it never retries with another backend.

``python -m dpf_tpu_torch.parallel.multihost --rank R --world W --port P``
runs one rank of a table-sharded evaluation over the deterministic table
of ``cluster_net.make_table`` and writes rank 0's shares (the tests and
the chip smoke run two such ranks).
"""

from __future__ import annotations

import datetime
import json
import os

import numpy as np
import torch

_initialized = False            # initialize() succeeded in this process
_init_error: str | None = None  # why the last initialize() did not


def is_initialized() -> bool:
    """True when this process is in a default process group (through
    ``initialize`` or a launcher)."""
    import torch.distributed as dist
    return _initialized or (dist.is_available() and dist.is_initialized())


def default_backend(world_size: int, device=None) -> str:
    """NCCL when ``device`` is a card and there is a card for every rank,
    else gloo."""
    dev = torch.device("cuda" if device is None and torch.cuda.is_available()
                       else device or "cpu")
    if dev.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               initialization_timeout_s: float | None = None,
               backend: str | None = None, device=None) -> bool:
    """Join the default process group (idempotent).

    ``coordinator_address``: ``host:port`` or an init URL
    (``tcp://...``); with no arguments the ``env://`` variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) are
    read.  Explicit arguments, or a cluster the environment announces
    (``_cluster_expected``), make a failure raise; a plain single
    process returns False.  Every failure keeps its cause in
    ``init_error()``.  ``initialization_timeout_s`` bounds the
    rendezvous.  ``backend`` None = ``default_backend(world, device)``."""
    global _initialized, _init_error
    import torch.distributed as dist
    if is_initialized():
        _init_error = None
        return True
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    env = os.environ
    try:
        if explicit:
            if None in (coordinator_address, num_processes, process_id):
                raise ValueError("initialize needs coordinator_address, "
                                 "num_processes and process_id together")
            url = (coordinator_address if "://" in coordinator_address
                   else "tcp://" + coordinator_address)
            world, rank = int(num_processes), int(process_id)
        else:
            missing = [v for v in ("MASTER_ADDR", "MASTER_PORT",
                                   "WORLD_SIZE", "RANK") if v not in env]
            if missing:
                raise RuntimeError("no process group in the environment "
                                   "(unset: %s)" % ", ".join(missing))
            url, world, rank = "env://", int(env["WORLD_SIZE"]), \
                int(env["RANK"])
        kw = {}
        if initialization_timeout_s is not None:
            kw["timeout"] = datetime.timedelta(
                seconds=max(1, int(initialization_timeout_s)))
        dist.init_process_group(backend or default_backend(world, device),
                                init_method=url, world_size=world,
                                rank=rank, **kw)
    except Exception as e:
        cause = "%s: %s" % (type(e).__name__, e)
        if initialization_timeout_s is not None and _looks_like_timeout(e):
            cause = ("InitializationTimeout: coordinator %s did not "
                     "respond within %.0fs (%s)"
                     % (coordinator_address or "<env>",
                        initialization_timeout_s, cause))
        _init_error = cause
        if explicit or _cluster_expected():
            raise
        return False
    _initialized = True
    _init_error = None
    _label_observability()
    return True


def shutdown() -> None:
    """Leave the default process group (idempotent)."""
    global _initialized
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def _looks_like_timeout(e: BaseException) -> bool:
    msg = str(e).lower()
    return ("timeout" in msg or "timed out" in msg or "deadline" in msg
            or isinstance(e, TimeoutError))


def _label_observability() -> None:
    """Stamp this process's flight and metrics output with its rank."""
    try:
        import torch.distributed as dist

        from ..obs import set_process_index
        set_process_index(dist.get_rank())
    except Exception as e:  # observability must never break init
        from ..utils.profiling import note_swallowed
        note_swallowed("multihost.label_observability", e)


def _cluster_expected() -> bool:
    """Does the environment announce a multi-process run?  Then a failed
    no-argument ``initialize`` raises instead of serving from one
    process.  ``DPF_EXPECT_CLUSTER`` decides when set ("0"/"false" =
    no); otherwise a ``WORLD_SIZE`` (or ``SLURM_NTASKS``,
    ``OMPI_COMM_WORLD_SIZE``) above 1 or a ``MASTER_ADDR`` does."""
    explicit = os.environ.get("DPF_EXPECT_CLUSTER", "").strip().lower()
    if explicit:
        return explicit not in ("0", "false", "no", "off")
    if os.environ.get("MASTER_ADDR"):
        return True
    for var in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        try:
            if int(os.environ.get(var, "") or 0) > 1:
                return True
        except ValueError:
            pass  # an unparsable hint is not a cluster claim
    return False


def global_mesh(n_batch: int = 1, n_table: int | None = None, device=None):
    """A ("batch", "table") mesh with one entry per rank: this process
    contributes ``device`` (None = the card, ``cuda:<rank % cards>``;
    raises when there is none), rank r at position r of the row-major
    layout, so the "table" axis spans consecutive ranks."""
    import torch.distributed as dist

    from .sharded import Mesh, _device_array
    if not is_initialized():
        raise RuntimeError("global_mesh needs initialize() first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("global_mesh: no CUDA device; pass device=")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    names = [None] * world
    dist.all_gather_object(names, str(device))
    if n_table is None:
        n_table = world // n_batch
    if n_table * n_batch != world:
        raise ValueError("mesh axes (%d x %d) must cover %d processes"
                         % (n_batch, n_table, world))
    devs = [device if r == rank else torch.device(names[r])
            for r in range(world)]
    return Mesh(_device_array(devs, (n_batch, n_table)), ("batch", "table"),
                ranks=np.arange(world).reshape(n_batch, n_table))


class ProcessInfo(tuple):
    """(process_index, process_count) that also carries ``init_error``,
    why the last ``initialize()`` did not join (None when it did or was
    never tried)."""
    init_error: str | None

    def __new__(cls, index, count, init_error=None):
        self = super().__new__(cls, (index, count))
        self.init_error = init_error
        return self

    @property
    def index(self):
        return self[0]

    @property
    def count(self):
        return self[1]


def init_error() -> str | None:
    """The cause of the last ``initialize()`` that did not join."""
    return _init_error


def process_info() -> ProcessInfo:
    """(rank, world size), (0, 1) outside a process group."""
    import torch.distributed as dist
    if is_initialized():
        return ProcessInfo(dist.get_rank(), dist.get_world_size(),
                           _init_error)
    return ProcessInfo(0, 1, _init_error)


# ------------------------------------------------ one rank of a mesh run

def rank_keys(n: int, prf_method: int, scheme: str, radix: int,
              batch: int, seed: int):
    """The deterministic key batch every rank and the checker mint:
    ``batch`` distinct indices, key i from seed ``mh-<seed>-i``."""
    from ..api import DPF
    from ..utils.config import EvalConfig
    client = DPF(config=EvalConfig(prf_method=prf_method, scheme=scheme,
                                   radix=radix), device="cpu")
    idx = [(i * 0x9E3779B1 + seed) % n for i in range(batch)]
    return client.gen_batch(idx, n, seeds=[b"mh-%d-%d" % (seed, i)
                                           for i in range(batch)])


def run_rank(*, n: int, entry_size: int, prf_method: int, scheme: str,
             radix: int, batch: int, seed: int, device, n_batch: int = 1,
             psum_group: int = 0) -> np.ndarray:
    """Evaluate server 0's keys on the global mesh (this process's
    share of it) and return the all-reduced ``[B, E]`` shares."""
    from .cluster_net import make_table
    from .sharded import ShardedDPFServer
    table = make_table(n, entry_size, seed)
    mesh = global_mesh(n_batch=n_batch, device=device)
    srv = ShardedDPFServer(table, mesh, prf_method=prf_method,
                           batch_size=batch, radix=radix, scheme=scheme,
                           psum_group=psum_group)
    keys = rank_keys(n, prf_method, scheme, radix, batch, seed)[0]
    return srv.eval(keys).cpu().numpy()


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--device", default=None,
                    help="this rank's device (default: the card)")
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--entry-size", type=int, default=16)
    ap.add_argument("--prf", type=int, default=3)
    ap.add_argument("--scheme", default="logn")
    ap.add_argument("--radix", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-batch", type=int, default=1)
    ap.add_argument("--psum-group", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="rank 0 writes its shares here (.npy)")
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args(argv)
    initialize("127.0.0.1:%d" % args.port, args.world, args.rank,
               initialization_timeout_s=args.timeout, backend=args.backend,
               device=args.device)
    from ..ops import launch_counts
    try:
        before = launch_counts()
        out = run_rank(n=args.n, entry_size=args.entry_size,
                       prf_method=args.prf, scheme=args.scheme,
                       radix=args.radix, batch=args.batch, seed=args.seed,
                       device=args.device, n_batch=args.n_batch,
                       psum_group=args.psum_group)
        launches = {k: v - before[k] for k, v in launch_counts().items()}
        if args.rank == 0 and args.out:
            np.save(args.out, out)
        print("RESULT " + json.dumps({
            "rank": args.rank, "world": args.world,
            "backend": torch.distributed.get_backend(),
            "device": str(torch.device(args.device or "cuda")),
            "launches": launches}), flush=True)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
