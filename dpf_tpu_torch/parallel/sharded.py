"""Multi-GPU DPF evaluation: table row-sharding and batch sharding on a
mesh of devices.

Port of ``dpf_tpu/parallel/sharded.py``.  A ``Mesh`` is a small array of
``torch.device``s with named axes; the workload maps onto it as in the
JAX package:

* **"table" axis** -- the bit-reverse-permuted table (digit-reversed for
  radix 4, natural order for sqrt-N) is row-sharded: each shard owns a
  contiguous range of BFS leaves, a set of whole frontier subtrees.
  Every shard expands only its own subtrees (the stream ciphers through
  K2's leaf-range form ``ops/subtree.subtree_contract_window``, whose
  blocks walk from the root themselves; AES from its own window of
  nodes, reached a level a launch, through K1 and K3 a group; sqrt-N
  through K4 from the shard's first grid row) and contracts them against
  its own rows; the int32 partials are summed mod 2^32.
* **"batch" axis** -- keys are split over its rows and the outputs
  concatenated.
* **"byte" axis** (``make_mesh_2d``) -- entry columns split over it, the
  outputs concatenated along the columns (binary tree only).

JAX's ``psum`` becomes a wrapping int32 sum of the shard partials: in
one process on the output device (the mesh's first device, with
``non_blocking`` copies between cards), across processes a
``torch.distributed.all_reduce`` (``multihost.global_mesh``) that is
exact mod 2^32 whichever backend reduces it.  ``psum_group`` > 0 sums
per group of that many chunks and gives the same bits.  A device may
repeat in a mesh: the tests build meshes of CPU devices, and one card
rehearses a 4-way mesh on ``cuda:0``.

``eval_leaf_range_local`` is the one evaluation every entry point lands
in (JAX's ``_eval_leaf_range``), and the cluster tier's per-granule
primitive (``parallel/cluster.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import expand, radix4
from ..core.expand import SUBTREE_PRFS, dispatch_contract, route_level


class Mesh:
    """Devices on named axes: ``devices`` an object array of
    ``torch.device`` shaped by ``axis_names`` (``("batch", "table")`` or
    ``("batch", "table", "byte")``); ``shape`` maps each axis to its
    size.  ``ranks`` (same shape, or None for one process) names the
    process of the default process group that owns each entry
    (``multihost.global_mesh``)."""

    def __init__(self, devices, axis_names, ranks=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError("a %d-axis device array for axes %r"
                             % (devices.ndim, self.axis_names))
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.ranks = None if ranks is None else np.asarray(ranks)
        self.rank = None
        if self.ranks is not None:
            import torch.distributed as dist
            self.rank = dist.get_rank()
        self._wraps = None          # the backend's int32 sum wraps

    @property
    def distributed(self) -> bool:
        return self.ranks is not None

    @property
    def size(self) -> int:
        """The mesh's entry count (JAX's ``Mesh.size``)."""
        return int(self.devices.size)

    def coord(self, idx: tuple, axis: str) -> int:
        """``idx``'s position on ``axis`` (0 on an axis the mesh lacks)."""
        if axis not in self.axis_names:
            return 0
        return idx[self.axis_names.index(axis)]

    def local_entries(self) -> list:
        """Index tuples of the entries this process evaluates."""
        return [idx for idx in np.ndindex(self.devices.shape)
                if self.ranks is None or self.ranks[idx] == self.rank]

    def local_devices(self) -> list:
        """This process's distinct devices, in entry order."""
        out = []
        for idx in self.local_entries():
            if self.devices[idx] not in out:
                out.append(self.devices[idx])
        return out

    @property
    def output_device(self) -> torch.device:
        """Where the summed shares land: the first local entry's device."""
        return self.devices[self.local_entries()[0]]

    def sum_wraps(self) -> bool:
        """Whether the process group's int32 SUM wraps mod 2^32 (probed
        once: every rank adds 2^31 - 1)."""
        if self._wraps is None:
            import torch.distributed as dist
            big = (1 << 31) - 1
            t = torch.full((1,), big, dtype=torch.int32,
                           device=self._reduce_device())
            dist.all_reduce(t)
            want = (big * dist.get_world_size()) % (1 << 32)
            self._wraps = int(t.item()) % (1 << 32) == want
        return self._wraps

    def _reduce_device(self) -> torch.device:
        import torch.distributed as dist
        if dist.get_backend() == "nccl":
            return self.output_device
        return torch.device("cpu")

    def __repr__(self):
        return "Mesh(%s, devices=%s%s)" % (
            ", ".join("%s=%d" % kv for kv in self.shape.items()),
            sorted({str(d) for d in self.devices.flat}),
            "" if self.ranks is None else ", rank=%d" % self.rank)


def _device_list(devices) -> list:
    """Explicit devices, or every visible CUDA device; raises when there
    is none and the caller named none (no quiet CPU mesh)."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; name the mesh's "
                "devices (utils.hermetic.force_cpu_mesh(n) for CPU tests)")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in np.asarray(devices, dtype=object).reshape(-1):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", 0)
        out.append(d)
    return out


def _device_array(devices, shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return arr.reshape(shape)


def make_mesh(n_table: int | None = None, n_batch: int = 1,
              devices=None) -> Mesh:
    """A ("batch", "table") mesh over ``devices`` (None = every visible
    CUDA device).  A device may repeat."""
    devs = _device_list(devices)
    if n_table is None:
        n_table = len(devs) // n_batch
    if n_table * n_batch != len(devs):
        raise ValueError("mesh axes (%d x %d) must cover %d devices"
                         % (n_batch, n_table, len(devs)))
    return Mesh(_device_array(devs, (n_batch, n_table)), ("batch", "table"))


def make_mesh_2d(n_table: int | None = None, n_byte: int = 1,
                 n_batch: int = 1, devices=None) -> Mesh:
    """A ("batch", "table", "byte") mesh: rows x entry columns."""
    devs = _device_list(devices)
    if n_table is None:
        n_table = len(devs) // (n_batch * n_byte)
    if n_table * n_batch * n_byte != len(devs):
        raise ValueError("mesh axes (%d x %d x %d) must cover %d devices"
                         % (n_batch, n_table, n_byte, len(devs)))
    return Mesh(_device_array(devs, (n_batch, n_table, n_byte)),
                ("batch", "table", "byte"))


class ShardedTable:
    """A host table placed on a mesh: ``blocks[idx]`` is entry ``idx``'s
    contiguous ``[rows / n_table, E / n_byte]`` block on its device
    (replicas along the batch axis on one device share a tensor)."""

    def __init__(self, host: np.ndarray, mesh: Mesh):
        n, e = host.shape
        nt, ny = mesh.shape["table"], mesh.shape.get("byte", 1)
        if n % nt:
            raise ValueError("table rows (%d) must divide over %d table "
                             "shards" % (n, nt))
        if e % ny:
            raise ValueError("entry columns (%d) must divide over %d byte "
                             "shards" % (e, ny))
        self.shape = (n, e)
        rows, cols = n // nt, e // ny
        self.blocks, placed = {}, {}
        for idx in mesh.local_entries():
            it, iy = mesh.coord(idx, "table"), mesh.coord(idx, "byte")
            key = (mesh.devices[idx], it, iy)
            if key not in placed:
                blk = host[it * rows:(it + 1) * rows,
                           iy * cols:(iy + 1) * cols]
                placed[key] = torch.from_numpy(
                    np.ascontiguousarray(blk)).to(mesh.devices[idx])
            self.blocks[idx] = placed[key]


def shard_table(table_i32, mesh: Mesh) -> ShardedTable:
    """Bit-reverse-permute and row-shard a table over the "table" axis."""
    return ShardedTable(expand.permute_table(np.asarray(table_i32,
                                                        dtype=np.int32)),
                        mesh)


def shard_table_2d(table_i32, mesh: Mesh) -> ShardedTable:
    """Bit-reverse-permute and block-shard a table over the ("table",
    "byte") plane: each entry holds ``[rows / n_table, E / n_byte]``."""
    return shard_table(table_i32, mesh)


def shard_table_mixed(table_i32, mesh: Mesh) -> ShardedTable:
    """Digit-reverse-permute (radix-4 BFS order) and row-shard a table."""
    tbl = np.asarray(table_i32, dtype=np.int32)
    perm = radix4.mixed_reverse_indices(radix4.arities(tbl.shape[0]))
    return ShardedTable(tbl[perm], mesh)


def shard_table_sqrt(table_i32, mesh: Mesh) -> ShardedTable:
    """Row-shard a natural-order table for the sqrt-N grid: N / shards
    rows are R / shards whole grid rows for any key split whose R divides
    over the shards."""
    return ShardedTable(np.asarray(table_i32, dtype=np.int32), mesh)


# ------------------------------------------------------------- reduction

def _valid_psum_group(psum_group, n_chunks: int) -> int:
    """The chunk-group size of grouped sums: 0 (one terminal sum) unless
    ``psum_group`` divides the chunk count with at least two groups."""
    g = int(psum_group or 0)
    return g if 0 < g < n_chunks and n_chunks % g == 0 else 0


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values -> their int32 residues mod 2^32."""
    v = v % (1 << 32)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def all_reduce_i32(t: torch.Tensor, mesh: Mesh) -> None:
    """In-place wrapping int32 sum of ``t`` over the mesh's processes.
    Gloo reduces host tensors (a card's tensor is copied out and back);
    where the backend's int32 sum does not wrap, the two 16-bit halves
    are summed apart and folded mod 2^32."""
    import torch.distributed as dist
    dev = mesh._reduce_device()
    buf = t if t.device == dev else t.to(dev)
    if mesh.sum_wraps():
        dist.all_reduce(buf)
    else:
        lo, hi = buf & 0xFFFF, (buf >> 16) & 0xFFFF
        dist.all_reduce(lo)
        dist.all_reduce(hi)
        buf = _wrap_i32(hi.long() * 65536 + lo.long())
    if buf is not t:
        t.copy_(buf)


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t.to(dev, non_blocking=t.is_cuda and dev.type == "cuda")


def mesh_sum(mesh: Mesh, bsz: int, e: int, partial, n_groups: int = 1):
    """The mesh program's reduction: ``partial(idx, k)`` is local entry
    ``idx``'s ``[B / n_batch, E / n_byte]`` int32 partial of group ``k``;
    per group the partials sum (wrapping) into their batch rows and byte
    columns on the output device, across processes too, and the groups
    add up.  Returns ``[B, E]`` int32 on the output device."""
    out = mesh.output_device
    nb, ny = mesh.shape["batch"], mesh.shape.get("byte", 1)
    bb, eb = bsz // nb, e // ny
    acc = torch.zeros((bsz, e), dtype=torch.int32, device=out)
    for k in range(n_groups):
        part = acc if n_groups == 1 else torch.zeros_like(acc)
        for idx in mesh.local_entries():
            ib, iy = mesh.coord(idx, "batch"), mesh.coord(idx, "byte")
            part[ib * bb:(ib + 1) * bb,
                 iy * eb:(iy + 1) * eb] += _to(partial(idx, k), out)
        if mesh.distributed:
            all_reduce_i32(part, mesh)
        if part is not acc:
            acc += part
    return acc


def keys_on_devices(mesh: Mesh, *tensors) -> dict:
    """{device: the key tensors there} for this process's devices."""
    return {dev: tuple(t.to(dev) for t in tensors)
            for dev in mesh.local_devices()}


# ------------------------------------------------------------ leaf range

def tree_levels(n_total: int, radix: int = 2) -> tuple:
    """(arities, first codeword slots) of the eval levels: the binary
    tree's wire layout, or ``radix4.arities`` / ``cw_offsets``."""
    if radix == 4:
        ars = radix4.arities(n_total)
        return ars, radix4.cw_offsets(ars)
    depth = n_total.bit_length() - 1
    return (2,) * depth, [2 * (depth - 1 - j) for j in range(depth)]


def eval_leaf_range_local(cw1, cw2, last, tbl, row0: int, *,
                          prf_method: int, chunk_leaves: int, n_total: int,
                          depth: int | None = None, radix: int = 2,
                          aes_impl: str | None = None,
                          dot_impl: str | None = None) -> torch.Tensor:
    """Partial evaluation of the BFS leaf range ``[row0, row0 + rows)``
    of the full-domain keys against ``tbl`` (those rows of the permuted
    table, on the keys' device) -> ``[B, E]`` int32.  Partials of
    disjoint ranges sum (wrapping) to the one-device shares.

    The stream ciphers run K2's leaf-range form on the range
    (``subtree_contract_window``: blocks of ``chunk_leaves`` leaves at
    most, each walking from the root inside the kernel).  AES and DUMMY
    walk from the root to the shallowest level whose nodes tile the
    range, a level a launch (K1 for AES), take those nodes, continue to
    the nodes of ``chunk_leaves`` leaves and contract them a group at a
    time (K3, or ``dot_impl``).  ``chunk_leaves`` (rounded
    down to a product of trailing arities for radix 4) must divide
    ``row0`` and the range.  On CPU tensors every kernel takes its plain
    version.  ``depth``, when given, must be the binary tree's."""
    rows = tbl.shape[0]
    ars, offs = tree_levels(n_total, radix)
    if radix == 2 and depth is not None and n_total != 1 << depth:
        raise ValueError("n_total %d is not 2^%d" % (n_total, depth))
    c = int(chunk_leaves)
    if radix == 4:
        c = radix4._suffix_chunk(ars, c)[1]
    if (c < 1 or c & (c - 1) or rows < 1 or rows % c or row0 % c
            or not 0 <= row0 <= n_total - rows):
        raise ValueError("leaf range [%d, %d) of %d rows must be whole "
                         "chunks of %d leaves" % (row0, row0 + rows,
                                                  n_total, c))
    if prf_method in SUBTREE_PRFS:
        from ..ops.subtree import subtree_contract_window
        return subtree_contract_window(
            last[:, None, :], cw1, cw2, tbl, sched=list(zip(ars, offs)),
            row0=row0, prf_method=prf_method, block_leaves=c, radix=radix)
    size = [int(np.prod(ars[j:], dtype=np.int64))
            for j in range(len(ars) + 1)]
    lv0 = next(j for j in range(len(ars) + 1)
               if rows % size[j] == 0 and row0 % size[j] == 0)

    def level(s, j, low32):
        a, o = ars[j], offs[j]
        return route_level(s, cw1[:, o:o + a], cw2[:, o:o + a], prf_method,
                           a, low32, aes_impl)

    seeds = last[:, None, :]
    for j in range(lv0):
        seeds = level(seeds, j, False)
    m0 = row0 // size[lv0]
    seeds = seeds[:, m0:m0 + rows // size[lv0]].contiguous()
    f_lv = size.index(c)
    return dispatch_contract(seeds, tbl, level, len(ars), f_lv, c, None,
                             None, dot_impl, lv0=lv0)


def _tree_program(keys: dict, table: ShardedTable, *, n: int, radix: int,
                  prf_method: int, chunk_leaves: int, mesh: Mesh,
                  aes_impl: str | None, psum_group: int,
                  dot_impl: str | None) -> torch.Tensor:
    """The GGM trees' mesh program over keys already on each device
    (``keys[device] = (cw1, cw2, last)``)."""
    nt, nb = mesh.shape["table"], mesh.shape["batch"]
    if table.shape[0] != n:
        raise ValueError("sharded table of %d rows for n=%d"
                         % (table.shape[0], n))
    rows = n // nt
    bsz = next(iter(keys.values()))[2].shape[0]
    if bsz % nb:
        raise ValueError("batch %d does not split over %d batch shards"
                         % (bsz, nb))
    c = min(int(chunk_leaves), rows)
    if radix == 4:
        ars = radix4.arities(n)
        if rows < ars[-1]:
            raise ValueError("shards of %d rows hold no whole radix-4 "
                             "subtree" % rows)
        c = radix4._suffix_chunk(ars, c)[1]
    f_local = rows // c
    g = _valid_psum_group(psum_group, f_local)
    n_groups = f_local // g if g else 1
    span, bb = rows // n_groups, bsz // nb

    def partial(idx, k):
        ib, it = mesh.coord(idx, "batch"), mesh.coord(idx, "table")
        c1, c2, la = keys[mesh.devices[idx]]
        sl = slice(ib * bb, (ib + 1) * bb)
        return eval_leaf_range_local(
            c1[sl], c2[sl], la[sl],
            table.blocks[idx][k * span:(k + 1) * span],
            it * rows + k * span, prf_method=prf_method, chunk_leaves=c,
            n_total=n, radix=radix, aes_impl=aes_impl, dot_impl=dot_impl)

    return mesh_sum(mesh, bsz, table.shape[1], partial, n_groups)


def eval_sharded(cw1, cw2, last, table_sharded: ShardedTable, *,
                 depth: int, prf_method: int, chunk_leaves: int, mesh: Mesh,
                 aes_impl: str | None = None, psum_group: int = 0,
                 dot_impl: str | None = None) -> torch.Tensor:
    """Mesh-parallel binary-tree evaluation: keys as in
    ``expand.expand_and_contract`` (int32 tensors on any device), the
    table from ``shard_table``.  ``psum_group`` > 0 sums the partials
    per group of that many chunks of ``chunk_leaves`` leaves.  Returns
    ``[B, E]`` int32 on the mesh's output device."""
    return _tree_program(keys_on_devices(mesh, cw1, cw2, last),
                         table_sharded, n=1 << depth, radix=2,
                         prf_method=prf_method, chunk_leaves=chunk_leaves,
                         mesh=mesh, aes_impl=aes_impl,
                         psum_group=psum_group, dot_impl=dot_impl)


def eval_sharded_2d(cw1, cw2, last, table_sharded: ShardedTable, *,
                    depth: int, prf_method: int, chunk_leaves: int,
                    mesh: Mesh, aes_impl: str | None = None,
                    psum_group: int = 0,
                    dot_impl: str | None = None) -> torch.Tensor:
    """The same over a ``make_mesh_2d`` mesh and a ``shard_table_2d``
    table: the leaf expansion is repeated along the byte axis, the
    partials of one byte column sum over the table axis and the byte
    columns concatenate."""
    return eval_sharded(cw1, cw2, last, table_sharded, depth=depth,
                        prf_method=prf_method, chunk_leaves=chunk_leaves,
                        mesh=mesh, aes_impl=aes_impl, psum_group=psum_group,
                        dot_impl=dot_impl)


def eval_sharded_mixed(cw1, cw2, last, table_sharded: ShardedTable, *,
                       n: int, prf_method: int, chunk_leaves: int,
                       mesh: Mesh, aes_impl: str | None = None,
                       psum_group: int = 0,
                       dot_impl: str | None = None) -> torch.Tensor:
    """Mesh-parallel radix-4 evaluation over a ``shard_table_mixed``
    table: each shard owns whole trailing radix-4 subtrees."""
    return _tree_program(keys_on_devices(mesh, cw1, cw2, last),
                         table_sharded, n=n, radix=4, prf_method=prf_method,
                         chunk_leaves=chunk_leaves, mesh=mesh,
                         aes_impl=aes_impl, psum_group=psum_group,
                         dot_impl=dot_impl)


# ---------------------------------------------------------------- server

class ShardedDPFServer:
    """One table, mesh-parallel evaluation, for the three constructions:
    ``scheme="logn"`` (binary GGM, or radix 4 with ``radix=4``),
    ``"sqrtn"`` (``core.sqrtn.eval_sharded_sqrt``) or ``"auto"`` (the
    tuning cache's winner for this shape, as ``DPF(scheme="auto")``;
    ``scheme_resolved_from`` says which answered).

    Knobs (``resolved_eval_knobs``): an explicit value (constructor
    argument or the attribute set later) wins; an auto (None) knob takes
    the mesh-tuned entry of this device and mesh split
    (``tune.cache.lookup_mesh_knobs``), then the single-device tuned
    entry, then the per-shard heuristic, with chunks clamped to the
    shard's rows.  The server takes ``serve.ServingEngine``'s protocol
    (``serving_engine``): dispatches are padded to the batch axis and
    return without a host sync."""

    def __init__(self, table, mesh: Mesh | None = None, prf_method: int = 3,
                 batch_size: int = 512, radix: int = 2,
                 scheme: str = "logn", chunk_leaves: int | None = None,
                 row_chunk: int | None = None,
                 psum_group: int | None = None,
                 dot_impl: str | None = None):
        from ..api import _check_construction
        self.mesh = mesh if mesh is not None else make_mesh()
        tbl = np.ascontiguousarray(np.asarray(table, dtype=np.int32))
        self.n, self.entry_size = tbl.shape
        if self.n & (self.n - 1):
            raise ValueError("table rows (%d) must be a power of two"
                             % self.n)
        _check_construction(scheme, radix)
        self.device = self.mesh.output_device
        self.scheme_resolved_from = None
        self.prf_method = prf_method
        if scheme == "auto":
            if radix == 4:
                raise ValueError(
                    "scheme='auto' resolves the whole construction "
                    "(scheme AND radix) from the tuning cache; leave "
                    "radix at 2")
            scheme, radix = self._resolve_auto_scheme(batch_size)
        self.scheme = scheme
        self.radix = radix
        self.batch_size = self.BATCH_SIZE = batch_size
        n_shards = self.mesh.shape["table"]
        if self.n % n_shards:
            raise ValueError("table rows (%d) must divide over %d table "
                             "shards" % (self.n, n_shards))
        if self.mesh.shape.get("byte", 1) > 1 and \
                (self.scheme != "logn" or self.radix != 2):
            raise ValueError(
                "byte-axis (2D) sharding serves the binary GGM "
                "construction only (scheme=%r radix=%d)"
                % (self.scheme, self.radix))
        if self.scheme == "sqrtn":
            self.table_sharded = shard_table_sqrt(tbl, self.mesh)
        elif self.radix == 4:
            self.table_sharded = shard_table_mixed(tbl, self.mesh)
        else:
            self.table_sharded = shard_table(tbl, self.mesh)
        # the explicit knob layer (None = auto); setting an attribute
        # later pins the knob the same way
        self.chunk = chunk_leaves
        self.row_chunk = row_chunk
        self.psum_group = psum_group
        self.dot_impl = dot_impl
        self._tuned_memo = {}       # batch -> (mesh-tuned, single-tuned)

    # the engine's names for the table shape
    @property
    def table_num_entries(self) -> int:
        return self.n

    @property
    def table_effective_entry_size(self) -> int:
        return self.entry_size

    @property
    def shard_rows(self) -> int:
        """Table rows each "table"-axis shard owns."""
        return self.n // self.mesh.shape["table"]

    def _resolve_auto_scheme(self, batch_size: int):
        """scheme="auto" -> the concrete construction: the scheme tuning
        cache's winner for this shape, else the cold-cache heuristic."""
        from ..tune.cache import lookup_scheme
        rec = lookup_scheme(n=self.n, entry_size=self.entry_size,
                            batch=batch_size, prf_method=self.prf_method,
                            device=self.device)
        if rec and rec.get("scheme") in ("logn", "sqrtn"):
            self.scheme_resolved_from = "cache"
        else:
            from ..tune.search import heuristic_scheme
            rec = heuristic_scheme(self.n)
            self.scheme_resolved_from = "heuristic"
        return rec["scheme"], int(rec.get("radix") or 2)

    def _decode_batch(self, keys):
        """Wire keys (or an already packed batch) -> a packed batch of
        this construction, validated against the table."""
        from ..core import keygen, sqrtn
        if isinstance(keys, (keygen.PackedKeys, sqrtn.PackedSqrtKeys)):
            pk = keys
        else:
            if not len(keys):
                raise ValueError("empty key batch")
            if self.scheme == "sqrtn":
                pk = sqrtn.decode_sqrt_keys_batched(keys)
            elif self.radix == 4:
                pk = radix4.decode_mixed_keys_batched(keys)
            else:
                pk = keygen.decode_keys_batched(keys)
        if pk.n != self.n:
            raise ValueError("key generated for n=%d but table has n=%d"
                             % (pk.n, self.n))
        return pk

    def resolved_eval_knobs(self, batch: int) -> dict:
        """The mesh program's knobs for one dispatch batch size:
        explicit > mesh-tuned > single-device tuned > heuristic, chunks
        against the shard's rows.  sqrt-N: ``row_chunk`` may stay None;
        the dispatch resolves it against the batch's key split."""
        from ..ops import matmul128
        from ..tune.cache import lookup_eval_knobs, lookup_mesh_knobs
        from ..tune.fingerprint import mesh_tag
        explicit = {"chunk_leaves": self.chunk, "row_chunk": self.row_chunk,
                    "psum_group": self.psum_group,
                    "dot_impl": self.dot_impl}
        fields = (("row_chunk", "psum_group", "dot_impl")
                  if self.scheme == "sqrtn"
                  else ("chunk_leaves", "psum_group", "dot_impl"))
        if all(explicit[f] is not None for f in fields):
            # fully pinned (a tuner's candidate): no cache reads
            tuned = single = {}
        else:
            memo = self._tuned_memo.get(batch)
            if memo is None:
                shape = dict(n=self.n, entry_size=self.entry_size,
                             batch=batch, prf_method=self.prf_method,
                             scheme=self.scheme, radix=self.radix,
                             device=self.device)
                memo = (lookup_mesh_knobs(mesh=mesh_tag(self.mesh),
                                          **shape) or {},
                        lookup_eval_knobs(**shape) or {})
                self._tuned_memo[batch] = memo
            tuned, single = memo

        def pick(field, fallback=None):
            if explicit[field] is not None:
                return explicit[field]
            v = tuned.get(field, single.get(field))
            return v if v is not None else fallback

        out = {"psum_group": int(pick("psum_group", 0) or 0),
               "dot_impl": pick("dot_impl", matmul128.default_impl())}
        if self.scheme == "sqrtn":
            out["row_chunk"] = pick("row_chunk")
            out["kernel_impl"] = "fused"     # K4, whatever was asked
            out["kernel_resolved_from"] = (
                "config" if explicit["row_chunk"] is not None else
                "tuned" if tuned.get("row_chunk", single.get("row_chunk"))
                else "heuristic")
            return out
        if explicit["chunk_leaves"] is not None:
            out["chunk_leaves"] = min(int(explicit["chunk_leaves"]),
                                      self.shard_rows)
        else:
            out["chunk_leaves"] = expand.clamp_chunk(
                tuned.get("chunk_leaves", single.get("chunk_leaves")),
                self.shard_rows, batch)
        return out

    def _stage_packed(self, pk, size: int | None = None, stage=None):
        """``api.stage_packed`` at ``size`` rows rounded up to the batch
        axis."""
        from ..api import stage_packed
        size = pk.batch if size is None else int(size)
        size += (-size) % self.mesh.shape["batch"]
        return stage_packed(pk, size, stage, self.scheme == "sqrtn")

    def _dispatch_packed(self, pk) -> torch.Tensor:
        """Dispatch one packed (or staged) batch without a host sync: the
        keys are uploaded once to each device of the mesh.  The
        ``[size, E]`` result may carry pad rows; callers trim."""
        from ..api import StagedKeys, _logn_planes, upload
        staged = (pk if isinstance(pk, StagedKeys)
                  else self._stage_packed(pk))
        pk, size = staged.pk, staged.size
        kn = self.resolved_eval_knobs(size)
        bufs = {dev: upload(staged, dev)
                for dev in self.mesh.local_devices()}
        if self.scheme == "sqrtn":
            from ..core import sqrtn
            n_shards = self.mesh.shape["table"]
            if pk.n_codewords % n_shards:
                raise ValueError(
                    "sqrt-N key split R=%d does not divide over %d "
                    "table shards" % (pk.n_codewords, n_shards))
            rc = kn["row_chunk"]
            if self.row_chunk is None:
                rc = sqrtn.clamp_row_chunk(
                    rc, pk.n_codewords // n_shards, pk.n_keys, size)
            keys = {dev: sqrtn.sqrt_key_views(b, pk.n_keys, pk.n_codewords,
                                              pad_to=size)
                    for dev, b in bufs.items()}
            return sqrtn.sharded_sqrt_program(
                keys, self.table_sharded, prf_method=self.prf_method,
                mesh=self.mesh, row_chunk=rc, psum_group=kn["psum_group"])
        keys = {dev: _logn_planes(b, size) for dev, b in bufs.items()}
        return _tree_program(
            keys, self.table_sharded, n=self.n, radix=self.radix,
            prf_method=self.prf_method, chunk_leaves=kn["chunk_leaves"],
            mesh=self.mesh, aes_impl=None, psum_group=kn["psum_group"],
            dot_impl=kn["dot_impl"])

    def eval(self, keys) -> torch.Tensor:
        """``[len(keys), E]`` int32 shares on the output device."""
        pk = self._decode_batch(keys)
        return self._dispatch_packed(pk)[:pk.batch]

    def serving_engine(self, **kwargs):
        """A ``serve.ServingEngine`` over this mesh server."""
        from ..serve import ServingEngine
        return ServingEngine(self, **kwargs)
