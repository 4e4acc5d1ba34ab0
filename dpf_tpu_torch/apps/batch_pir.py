"""Batch-PIR: the planner (hot/cold split, co-location, binning, cost
model) and the lookup server, client and stream that run its plan.

Port of ``dpf_tpu/apps/batch_pir.py``.  The planner is the JAX package's
host code (numpy and the standard library), copied so this package
imports no JAX: the same access patterns give the same hot and cold
tables, bins and collocation map, and a collocation cache file written
by either package loads in the other.  ``BatchPIROptimize`` keeps the
``sha256`` stable shuffle and the set-based tie-breaking of ``fetch`` as
written: client and server derive the bins independently.

The serving half runs the plan on the card.  ``PrivateLookupServer``
pads each bin to a power-of-two mini-table; the bins of one padded size
form a size group, stacked into one ``[G, n, E]`` tensor of per-key
tables on the device (bit-reversed, digit-reversed or natural order by
construction), and one per-key-table evaluation answers a query round
across the group in one dispatch:

* the binary tree: ``expand.expand_and_contract_per_key_tables`` (K2's
  per-key mode for the stream ciphers; K1 per level and K6 per group
  for AES, plain level steps and K6 for DUMMY);
* the radix-4 tree: ``radix4.expand_and_contract_per_key_tables_mixed``
  (the mixed K2's per-key mode, or K1 at each level's arity and K6);
* the sqrt-N grid: ``sqrtn.eval_contract_per_key_tables`` (K4's per-key
  mode, every PRF id).

``answer`` decodes each group through the packed wire codec, stages the
keys in a pinned buffer and enqueues every group before one gather;
``answer_scalar`` is the per-key decode with a host wait per group, kept
as the parity oracle.  ``LookupStream`` serves rounds through one
``ServingEngine`` per size group; ``PrivateLookupClient`` mints one key
per bin with the batched generators and recovers the rows.

``scheme="auto"`` resolves each (n, G) size group from the tuning
cache's scheme winner for that shape, else the caller's log-N radix, on
client and server alike (``_resolve_construction``).  The group knobs
are the per-key kernels' geometry (``subtree.pkt_block_leaves``,
``sqrt_grid.pkt_row_chunk``), which no tuned knob reaches: a block size
or row chunk timed on a shared table is not a per-key one.  AES and
DUMMY take the tuning cache's live-seed chunk for the group's shape when
it was tuned on the fused route (the per-key route expands the same
way), re-clamped to the 64 MiB budget; ``expand.clamp_chunk`` on a cold
cache.

With ``mesh=`` (a ``parallel.sharded.Mesh``) each size group pads G with
zero bins to the mesh's entry count and splits its ``[G + pad, n, E]``
stack into one contiguous slice an entry, in the row-major order of the
mesh's entries (``dpf_tpu``'s ``P(all axes)``).  Each entry's device
holds its slice and evaluates it with its slice of the keys (the last key
repeated into the pad rows, whose tables are zero); bins are disjoint,
so the entries' answers are concatenated on the mesh's output device,
never summed, and the pad rows dropped.  A group's knobs fall back to the
mesh-tuned entry (``tune.cache.lookup_mesh_knobs``) when the one-device
entry is absent.  A multi-process mesh (``ranks``) raises: the mesh is
in-process, as ``dpf_tpu``'s.
"""

from __future__ import annotations

import hashlib
import json
import os
from collections import Counter, defaultdict
from dataclasses import asdict, dataclass

import numpy as np
import torch

from ..obs.tracer import span
from ..utils.config import check_construction


@dataclass(frozen=True)
class HotColdConfig:
    cache_size_fraction: float = 1.0


@dataclass(frozen=True)
class CollocateConfig:
    num_collocate: int = 0


@dataclass(frozen=True)
class PIRConfig:
    bin_fraction: float = 0.1      # fraction of a table forming one bin
    entry_size_bytes: int = 256
    queries_to_hot: int = 1
    queries_to_cold: int = 0
    # construction the cost model prices upload bytes for: "logn" (the
    # binary tree, or the radix-4 tree with radix=4; both ship the same
    # 524-word container) or "sqrtn" (O(sqrt N) keys)
    scheme: str = "logn"
    radix: int = 2

    def __post_init__(self):
        check_construction(self.scheme, self.radix,
                           schemes=("logn", "sqrtn"))


@dataclass
class DPFCost:
    computation: int = 0
    upload_communication: int = 0
    download_communication: int = 0

    def _asdict(self):
        return asdict(self)


def dpf_key_cost_bytes(table_size: int, scheme: str = "logn",
                       radix: int = 2) -> int:
    """Upload bytes per query: the exact wire size of one serialized key
    for the construction over the padded power-of-two bin domain the
    lookup servers use (``_pad_pow2``, 128-entry floor): 2096 B for the
    log-N trees (the fixed 524-int32 container), ``(4 + K + 2R) x 16`` B
    for sqrt-N.  A single-entry bin still prices a whole key."""
    if table_size < 1:
        return 0
    check_construction(scheme, radix, schemes=("logn", "sqrtn"))
    n = _pad_pow2(table_size)
    if scheme == "sqrtn":
        from ..core.sqrtn import default_split
        k, r = default_split(n)
        return (4 + k + 2 * r) * 16
    from ..core.keygen import KEY_WORDS
    return KEY_WORDS * 4


class BatchPIROptimize:
    """Plan (and cost) private batched lookups over access patterns."""

    def __init__(self, train_set, validation_set,
                 hotcold_config: HotColdConfig = HotColdConfig(),
                 collocate_config: CollocateConfig = CollocateConfig(),
                 pir_config: PIRConfig = PIRConfig(),
                 collocate_cache: str | dict | None = None):
        self.hotcold_config = hotcold_config
        self.collocate_config = collocate_config
        self.pir_config = pir_config
        self.train = [list(s) for s in train_set]
        self.val = [list(s) for s in validation_set]

        self._count_accesses()
        self._split_hot_cold()
        self._build_collocation(collocate_cache)
        self._build_bins()
        self.accuracy_stats = None
        self.cost = DPFCost()

    # -------------------------------------------------------- statistics

    def _count_accesses(self):
        self.embedding_counts = Counter()
        for idx_set in self.train:
            self.embedding_counts.update(idx_set)
        self.all_embedding_indices = set(self.embedding_counts)
        for idx_set in self.val:
            self.all_embedding_indices.update(idx_set)
        self.num_embeddings = len(self.all_embedding_indices)

    def _split_hot_cold(self):
        frac = self.hotcold_config.cache_size_fraction
        n_hot = int(frac * self.num_embeddings)
        by_freq = sorted(self.all_embedding_indices,
                         key=lambda x: self.embedding_counts[x], reverse=True)
        self.hot_table = by_freq[:n_hot]
        self.cold_table = by_freq[n_hot:]

        # shuffle within each table so bins are unbiased, stably across
        # processes (client and server derive bins independently): a
        # keyed digest, not the per-process-salted builtin hash()
        def stable_key(x):
            return hashlib.sha256(str(x).encode()).digest()
        self.hot_table.sort(key=stable_key)
        self.cold_table.sort(key=stable_key)

    def _build_collocation(self, cache):
        """Top co-accessed neighbours per entry (cacheable: O(sum k^2))."""
        k = self.collocate_config.num_collocate
        if isinstance(cache, str) and os.path.exists(cache):
            with open(cache) as f:
                loaded = json.load(f)
            self.collocation_map = {int(i): v for i, v in loaded.items()}
            return
        if isinstance(cache, dict):
            self.collocation_map = {int(i): v for i, v in cache.items()}
            return
        co = defaultdict(Counter)
        if k > 0:
            for idx_set in self.train:
                uniq = set(idx_set)
                for src in uniq:
                    for dst in uniq:
                        if src != dst:
                            co[src][dst] += 1
        self.collocation_map = {
            idx: [d for d, _ in co[idx].most_common(k)] if idx in co else []
            for idx in self.all_embedding_indices}
        if isinstance(cache, str):
            with open(cache, "w") as f:
                json.dump(self.collocation_map, f)

    def _build_bins(self):
        def bins_of(table):
            if not table:
                return [], 0
            per_bin = max(1, int(len(table) * self.pir_config.bin_fraction))
            return ([set(table[i:i + per_bin])
                     for i in range(0, len(table), per_bin)], per_bin)

        self.hot_table_bins, self.hot_entries_per_bin = bins_of(self.hot_table)
        self.cold_table_bins, self.cold_entries_per_bin = \
            bins_of(self.cold_table)

    # -------------------------------------------------------------- fetch

    def fetch(self, batch_indices):
        """Greedy multi-query plan for one batch of needed indices.

        Returns (recovered index set, DPFCost).  Each query round
        retrieves at most one entry per bin; the most-needed unrecovered
        candidate in each bin wins."""
        counts = Counter(batch_indices)
        targets = set(counts)
        recovered = set()

        def one_query(bins):
            for b in bins:
                cands = b & targets
                if not cands:
                    continue
                best = max(cands, key=lambda x: (-1, 0) if x in recovered
                           else (0, counts[x]))
                if best not in recovered:
                    recovered.add(best)

        for _ in range(self.pir_config.queries_to_hot):
            one_query(self.hot_table_bins)
        for _ in range(self.pir_config.queries_to_cold):
            one_query(self.cold_table_bins)

        collocated = set()
        for idx in recovered:
            collocated.update(self.collocation_map.get(idx, []))
        all_recovered = recovered | collocated

        qh, qc = (self.pir_config.queries_to_hot,
                  self.pir_config.queries_to_cold)
        sch, rad = self.pir_config.scheme, self.pir_config.radix
        cost = DPFCost(
            computation=qh * len(self.hot_table) + qc * len(self.cold_table),
            upload_communication=(
                qh * dpf_key_cost_bytes(self.hot_entries_per_bin, sch, rad)
                * len(self.hot_table_bins)
                + qc * dpf_key_cost_bytes(self.cold_entries_per_bin, sch, rad)
                * len(self.cold_table_bins)),
            download_communication=(
                (qh * len(self.hot_table_bins)
                 + qc * len(self.cold_table_bins))
                * self.pir_config.entry_size_bytes))
        return all_recovered, cost

    # ---------------------------------------------------------- evaluate

    def evaluate(self, limit=None):
        """Fraction-of-batch-recovered over the validation patterns."""
        self.percentage_of_query_recovered = []
        for val in self.val[:limit]:
            if not val:
                continue
            recovered, self.cost = self.fetch(val)
            hit = set(x for x in recovered if x in val)
            self.percentage_of_query_recovered.append(
                len(hit) / len(set(val)))
        return self.percentage_of_query_recovered

    def evaluate_with_model(self, dataset_module, limit=None):
        """Evaluate, then the downstream model's accuracy with the
        unrecovered embeddings masked."""
        self.evaluate(limit=limit)
        self.accuracy_stats = dataset_module.evaluate(self)
        return self.accuracy_stats

    def summarize_evaluation(self):
        p = self.percentage_of_query_recovered
        return {
            "pir_config": asdict(self.pir_config),
            "hotcold_config": asdict(self.hotcold_config),
            "collocate_config": asdict(self.collocate_config),
            "mean_recovered": float(np.mean(p)),
            **{"recovered_p_%d" % q: float(np.percentile(p, q))
               for q in (0, 5, 10, 50, 90, 95)},
            "cost": self.cost._asdict(),
            "accuracy_stats": self.accuracy_stats,
            "extra": {
                "hot_table_size": len(self.hot_table),
                "cold_table_size": len(self.cold_table),
                "hot_table_entries_per_bin": self.hot_entries_per_bin,
                "cold_table_entries_per_bin": self.cold_entries_per_bin,
            },
        }


# ---------------------------------------------------------------------------
# Running a batch-PIR plan on the card
# ---------------------------------------------------------------------------

def _pad_pow2(n, lo=128):
    from ..core.u128 import next_pow2
    return next_pow2(max(n, lo))


def _resolve_construction(scheme: str, radix: int, n: int, group_size: int,
                          entry_size: int, prf_method: int,
                          device=None) -> tuple:
    """The concrete construction of one (n, G) size group: sqrt-N, or for
    ``scheme="auto"`` the tuning cache's scheme winner for this shape on
    ``device`` (``tune.cache.lookup_scheme``), else the caller's log-N
    radix.  Client and server derive it independently, so it depends
    only on the bins and the cache."""
    if scheme == "sqrtn":
        return "sqrtn", 2
    if scheme == "auto":
        from ..core.u128 import next_pow2
        from ..tune.cache import lookup_scheme
        rec = lookup_scheme(n=n, entry_size=entry_size,
                            batch=next_pow2(max(1, group_size)),
                            prf_method=prf_method, device=device)
        if rec and rec.get("scheme") in ("logn", "sqrtn"):
            return rec["scheme"], int(rec.get("radix") or 2)
    return "logn", radix


def group_knobs(prf_method: int, entry_size: int, device, n: int,
                batch: int, sch: str, rad: int, mesh=None) -> dict:
    """Program knobs of one (n, G) per-key dispatch: K2's per-key block
    subtree for the stream ciphers (``subtree.pkt_block_leaves``); for
    sqrt-N a row chunk of None, resolved by K4's wrapper
    (``sqrt_grid.pkt_row_chunk``); for AES and DUMMY the live-seed chunk,
    the tuning cache's for this group's shape on ``device`` when it was
    tuned on the fused route, re-clamped (``expand.clamp_chunk``), else
    ``clamp_chunk``'s.  With a ``mesh`` the cache is read at the group's
    padded size ``batch`` and falls back to the mesh-tuned entry of this
    split; the geometry is each entry's, ``batch / entries`` keys a
    launch.  None of them changes a bit."""
    from ..core import expand, radix4
    from ..ops import subtree
    if sch == "sqrtn":
        return {"row_chunk": None}
    per = batch // (1 if mesh is None else mesh.size)
    if prf_method not in expand.SUBTREE_PRFS:
        from ..tune.cache import lookup_eval_knobs, lookup_mesh_knobs
        shape = dict(n=n, entry_size=entry_size, batch=batch,
                     prf_method=prf_method, scheme=sch, radix=rad,
                     device=device)
        tuned = lookup_eval_knobs(**shape) or {}
        if not tuned and mesh is not None:
            from ..tune.fingerprint import mesh_tag
            tuned = lookup_mesh_knobs(mesh=mesh_tag(mesh), **shape) or {}
        chunk = (tuned.get("chunk_leaves") if tuned.get(
            "kernel_impl", "fused") in ("fused", "xla") else None)
        return {"chunk_leaves": expand.clamp_chunk(chunk, n, per)}
    ars = radix4.arities(n) if rad == 4 else (2,) * (n.bit_length() - 1)
    return {"chunk_leaves": subtree.pkt_block_leaves(per, ars)}


@dataclass
class _SizeGroup:
    """All bins sharing one padded mini-table size n, stacked."""
    idxs: list           # bin indices, in stacked (axis 0) order
    tables: list         # [G + gpad, n, E] permuted per scheme: one
    #                      tensor, or with a mesh one slice an entry
    devices: list        # the device of each entry of ``tables``
    gpad: int            # zero bins appended for the mesh (0 without)
    scheme: str          # construction of this group
    radix: int

    @property
    def padded(self) -> int:
        return len(self.idxs) + self.gpad


class _ShardStaged:
    """One key batch staged for a meshed group: a ``StagedKeys`` an
    entry (its slice of the padded keys)."""
    __slots__ = ("parts", "size")

    def __init__(self, parts, size):
        self.parts = parts
        self.size = size


class PrivateLookupServer:
    """Holds one bin-structured table; answers DPF queries per bin.

    Each bin is padded to a power-of-two mini-table; bins of equal
    padded size form one (n, G) size group stacked into a ``[G, n, E]``
    tensor on the device, so one per-key-table evaluation answers a
    query round across all of them in one dispatch.  ``answer`` is the
    production path (packed wire codec, pinned staging, every group
    enqueued before one gather); ``answer_scalar`` the per-key path kept
    as its parity oracle; ``stream()`` serves multi-round query streams
    through one ``ServingEngine`` per size group."""

    def __init__(self, table: np.ndarray, bins, prf=None, radix: int = 2,
                 mesh=None, scheme: str = "logn", device=None):
        """scheme: ``"logn"`` (the binary tree, or the radix-4 tree with
        radix=4) or ``"sqrtn"``; the client must be built with the same
        arguments; ``"auto"`` resolves each size group from the tuning
        cache's scheme winner, else the log-N ``radix``.  mesh: a
        ``parallel.sharded.Mesh`` of one process over which each size
        group's bins split (the answers gather on its output device);
        ``device`` is then the mesh's and must not be given.  device:
        where the tables live and the groups evaluate without a mesh
        (None = CUDA; ``"cpu"`` runs the kernels' plain versions)."""
        from ..api import DPF, resolve_device
        from ..core import expand, radix4
        check_construction(scheme, radix)
        if mesh is not None:
            if mesh.distributed:
                raise ValueError(
                    "batch-PIR serves an in-process mesh; this mesh spans "
                    "processes (ranks %s)" % sorted(set(mesh.ranks.flat)))
            if device is not None:
                raise ValueError("pass mesh= or device=, not both: a "
                                 "mesh names its own devices")
        self.prf_method = DPF.DEFAULT_PRF if prf is None else prf
        self.radix = radix
        self.scheme = scheme
        self.mesh = mesh
        self.device = (mesh.output_device if mesh is not None
                       else resolve_device(device))
        table = np.asarray(table, dtype=np.int32)
        self.entry_size = table.shape[1]
        self.bins = [sorted(b) for b in bins]
        self.bin_sizes = []
        by_size = {}    # n -> (bin indices, natural padded tables)
        for bi, b in enumerate(self.bins):
            sub = table[b] if b else np.zeros((1, self.entry_size), np.int32)
            n = _pad_pow2(len(sub))
            padded = np.zeros((n, self.entry_size), np.int32)
            padded[:len(sub)] = sub
            self.bin_sizes.append(n)
            by_size.setdefault(n, ([], []))
            by_size[n][0].append(bi)
            by_size[n][1].append(padded)

        def permute(padded, sch, rad):
            if sch == "sqrtn":           # the grid emits natural order
                return padded
            if rad == 4:
                perm = radix4.mixed_reverse_indices(
                    radix4.arities(padded.shape[0]))
                return padded[perm]
            return expand.permute_table(padded)

        devices = ([self.device] if mesh is None
                   else [mesh.devices[idx] for idx in mesh.local_entries()])
        self._groups = {}
        self._knobs = {}    # (n, batch, scheme, radix) -> group knobs
        self._stages = {}   # n -> the pinned key buffer(s) of ``answer``
        for n, (idxs, tbls) in by_size.items():
            sch, rad = _resolve_construction(
                scheme, radix, n, len(idxs), self.entry_size,
                self.prf_method, self.device)
            gpad = (-len(idxs)) % len(devices)
            stacked = np.stack([permute(t, sch, rad) for t in tbls]
                               + [np.zeros_like(tbls[0])] * gpad)
            g = stacked.shape[0] // len(devices)
            self._groups[n] = _SizeGroup(
                idxs, [torch.from_numpy(stacked[s * g:(s + 1) * g]).to(dev)
                       for s, dev in enumerate(devices)],
                devices, gpad, sch, rad)

    def group_constructions(self) -> dict:
        """{bin size n: (scheme, radix)} of each size group."""
        return {n: (g.scheme, g.radix) for n, g in self._groups.items()}

    # ------------------------------------------------------ the hot path

    def _group_knobs(self, n: int, batch: int, sch: str, rad: int) -> dict:
        """Program knobs of one (n, G) dispatch (``group_knobs``; ``batch``
        is the group's padded size), memoized per (n, batch,
        construction)."""
        key = (n, batch, sch, rad)
        knobs = self._knobs.get(key)
        if knobs is None:
            knobs = self._knobs[key] = group_knobs(
                self.prf_method, self.entry_size, self.device, *key,
                mesh=getattr(self, "mesh", None))
        return knobs

    def _decode_group(self, n: int, grp: _SizeGroup, keys):
        """Packed-codec ingest of one size group's keys, with fail-fast
        validation: a wrong-domain or wrong-construction key is reported
        with its bin index before any batch decode work."""
        from ..core import keygen, radix4, sqrtn
        if len(keys) != len(grp.idxs):
            raise ValueError("size-%d group: expected %d keys, got %d"
                             % (n, len(grp.idxs), len(keys)))
        if grp.scheme == "sqrtn":
            try:
                arr = sqrtn.stack_sqrt_wire_keys(keys)
                kn = sqrtn.sqrt_wire_ns(arr)
            except ValueError as exc:
                raise ValueError("size-%d group (bins %s): %s"
                                 % (n, grp.idxs, exc)) from None
            bad = np.flatnonzero(kn != n)
            if bad.size:
                raise ValueError("key for bin %d (bin size %d) got n=%d"
                                 % (grp.idxs[bad[0]], n, kn[bad[0]]))
            return sqrtn.decode_sqrt_keys_batched(arr)
        try:
            arr = keygen.stack_wire_keys(keys)
        except ValueError as exc:
            raise ValueError("size-%d group (bins %s): %s"
                             % (n, grp.idxs, exc)) from None
        marker, kn = keygen.wire_headers(arr)
        bad = np.flatnonzero(marker != (4 if grp.radix == 4 else 0))
        if bad.size:
            raise ValueError(
                "key for bin %d (bin size %d) is not a %s key "
                "(radix marker %d)"
                % (grp.idxs[bad[0]], n,
                   "radix-4" if grp.radix == 4 else "binary",
                   marker[bad[0]]))
        bad = np.flatnonzero(kn != n)
        if bad.size:
            raise ValueError("key for bin %d (bin size %d) got n=%d"
                             % (grp.idxs[bad[0]], n, kn[bad[0]]))
        decode = (radix4.decode_mixed_keys_batched if grp.radix == 4
                  else keygen.decode_keys_batched)
        return decode(arr)

    def _shard_spans(self, grp: _SizeGroup) -> list:
        """The real key rows ``(lo, hi)`` of each entry's slice of the
        padded group: a slice past the last bin takes the last key, and
        every slice pads to ``padded / entries`` rows by repeating its
        last key into rows whose tables are zero."""
        g, last = grp.padded // len(grp.tables), len(grp.idxs)
        return [(s * g, min((s + 1) * g, last)) if s * g < last
                else (last - 1, last) for s in range(len(grp.tables))]

    def _stage_group(self, grp: _SizeGroup, pk, stage=None):
        """A group's packed keys in one host buffer in the layout the
        device takes (``api.stage_packed``); with a mesh, each entry's
        slice in a buffer of its own (``stage``: a list, one an entry)."""
        from ..api import stage_packed
        sqrt = grp.scheme == "sqrtn"
        if self.mesh is None:
            return stage_packed(pk, pk.batch, stage, sqrt)
        g = grp.padded // len(grp.tables)
        stages = stage or [None] * len(grp.tables)
        return _ShardStaged([stage_packed(pk.slice(lo, hi), g, st, sqrt)
                             for (lo, hi), st in zip(self._shard_spans(grp),
                                                     stages)], grp.padded)

    def _program(self, n: int, grp: _SizeGroup, staged, tables, device):
        """Upload one staged key batch to ``device`` and enqueue the
        group's per-key program on ``tables`` there; returns the shares
        on the device without a host wait (on the card every copy and
        kernel is ordered on the current stream)."""
        from ..api import _logn_planes, upload
        from ..core import expand, radix4, sqrtn
        buf = upload(staged, device)
        knobs = self._group_knobs(n, grp.padded, grp.scheme, grp.radix)
        if grp.scheme == "sqrtn":
            pk = staged.pk
            seeds, cw1, cw2 = sqrtn.sqrt_key_views(
                buf, pk.n_keys, pk.n_codewords, pad_to=staged.size)
            return sqrtn.eval_contract_per_key_tables(
                seeds, cw1, cw2, tables, prf_method=self.prf_method,
                **knobs)
        cw1, cw2, last = _logn_planes(buf, staged.size)
        if grp.radix == 4:
            return radix4.expand_and_contract_per_key_tables_mixed(
                cw1, cw2, last, tables, n=n, prf_method=self.prf_method,
                **knobs)
        return expand.expand_and_contract_per_key_tables(
            cw1, cw2, last, tables, depth=n.bit_length() - 1,
            prf_method=self.prf_method, **knobs)

    def _gather(self, grp: _SizeGroup, outs) -> torch.Tensor:
        """The entries' ``[G / entries, E]`` answers concatenated on the
        output device, the pad rows dropped."""
        from ..parallel.sharded import _to
        if len(outs) == 1:
            return outs[0][:len(grp.idxs)]
        return torch.cat([_to(o, self.device)
                          for o in outs])[:len(grp.idxs)]

    def _run_group_program(self, n: int, grp: _SizeGroup, staged):
        """Enqueue one staged key batch's group program, on each entry of
        a mesh; returns the ``[G, E]`` shares on the (output) device
        without a host wait."""
        if self.mesh is None:
            return self._program(n, grp, staged, grp.tables[0], self.device)
        return self._gather(grp, [
            self._program(n, grp, st, tbl, dev)
            for st, tbl, dev in zip(staged.parts, grp.tables, grp.devices)])

    def _answer_stage(self, n: int):
        """The pinned key buffer of group n's ``answer`` (None on the
        CPU), one an entry with a mesh (a device that repeats in the mesh
        gets one for each of its entries, so that no entry's fill waits
        for another's copy): its next fill waits only for the upload that
        last read it."""
        if self.device.type != "cuda":
            return None
        if n not in self._stages:
            from ..serve.engine import PinnedStage
            self._stages[n] = (PinnedStage() if self.mesh is None else
                               [PinnedStage() for _ in self._groups[n].tables])
        return self._stages[n]

    def answer(self, keys_per_bin):
        """keys_per_bin: one serialized key per bin -> [n_bins, E] shares.

        The production path: each size group's keys decode through the
        packed wire codec, are staged in the group's pinned buffer and
        uploaded without a host wait, and every group's program is
        enqueued before one gather.  Bit-identical to ``answer_scalar``."""
        if len(keys_per_bin) != len(self.bins):
            raise ValueError("expected one key per bin (%d bins), got %d"
                             % (len(self.bins), len(keys_per_bin)))
        pending = []
        for n, grp in self._groups.items():
            pk = self._decode_group(n, grp,
                                    [keys_per_bin[bi] for bi in grp.idxs])
            staged = self._stage_group(grp, pk, self._answer_stage(n))
            pending.append((grp, self._run_group_program(n, grp, staged)))
        out = np.zeros((len(self.bins), self.entry_size), np.int32)
        for grp, dev in pending:
            out[grp.idxs] = dev.cpu().numpy()
        return out

    def answer_scalar(self, keys_per_bin):
        """The per-key path, kept as the parity oracle: per-key scalar
        deserialize and pack, then the same staging, knobs and program as
        ``answer``, with a host wait per size group.  Same kernels, so
        ``answer`` must match it bit for bit."""
        from ..core import expand, keygen, radix4, sqrtn
        if len(keys_per_bin) != len(self.bins):
            raise ValueError("expected one key per bin (%d bins), got %d"
                             % (len(self.bins), len(keys_per_bin)))
        out = np.zeros((len(self.bins), self.entry_size), np.int32)
        for n, grp in self._groups.items():
            keys = [keys_per_bin[bi] for bi in grp.idxs]
            if grp.scheme == "sqrtn":
                parsed = [sqrtn.deserialize_sqrt_key(k) for k in keys]
            elif grp.radix == 4:
                parsed = [radix4.deserialize_mixed_key(k) for k in keys]
            else:
                parsed = [keygen.deserialize_key(k) for k in keys]
            for bi, k in zip(grp.idxs, parsed):
                if k.n != n:
                    raise ValueError("key for bin %d (bin size %d) got n=%d"
                                     % (bi, n, k.n))
            if grp.scheme == "sqrtn":
                pk = sqrtn.PackedSqrtKeys(*sqrtn.pack_sqrt_keys(parsed), n)
            else:
                pk = keygen.PackedKeys(*(radix4.pack_mixed_keys
                                         if grp.radix == 4
                                         else expand.pack_keys)(parsed),
                                       depth=n.bit_length() - 1, n=n)
            staged = self._stage_group(grp, pk)
            out[grp.idxs] = self._run_group_program(
                n, grp, staged).cpu().numpy()
        return out

    # ------------------------------------------------------- streaming

    def stream(self, *, max_in_flight: int = 2, warmup: bool = True,
               retry=None):
        """A ``LookupStream`` serving multi-round query batches through
        one ``ServingEngine`` per (n, G) size group.  ``retry`` (a
        ``serve.RetryPolicy``) re-attempts failed group dispatches."""
        return LookupStream(self, max_in_flight=max_in_flight,
                            warmup=warmup, retry=retry)


class _GroupStreamServer:
    """``ServingEngine`` adapter presenting one (n, G) size group as a
    server: the engine's ``_decode_batch``, ``_stage_packed`` and
    ``_dispatch_packed`` plus the shape attributes it reads.  A group's
    batch is always one key per bin, G keys, and the engine's one bucket
    is at least the group's mesh-padded size (its warmup keys are a whole
    bucket): staging keeps the first G keys, and the dispatch runs the
    same program as ``answer``.  On a mesh each of the engine's pinned
    slots stands for one slot an entry."""

    def __init__(self, owner: PrivateLookupServer, n: int,
                 grp: _SizeGroup):
        self._owner = owner
        self._grp = grp
        self._g = len(grp.idxs)
        self._slots = {}                # engine slot -> one an entry
        self.table_num_entries = n
        self.table_effective_entry_size = owner.entry_size
        self.device = owner.device
        self.scheme = grp.scheme       # engine: sqrt-N warmup key shape

    def _decode_batch(self, keys):
        if hasattr(keys, "batch"):  # decoded by LookupStream.submit
            return keys
        return self._owner._decode_group(self.table_num_entries, self._grp,
                                         keys)

    def _stage_packed(self, pk, size, stage=None):
        if stage is not None and self._owner.mesh is not None:
            from ..serve.engine import PinnedStage
            if stage not in self._slots:
                self._slots[stage] = [PinnedStage()
                                      for _ in self._grp.tables]
            stage = self._slots[stage]
        return self._owner._stage_group(self._grp, pk.slice(0, self._g),
                                        stage)

    def _dispatch_packed(self, staged):
        return self._owner._run_group_program(self.table_num_entries,
                                              self._grp, staged)

    def resolved_eval_knobs(self, batch: int) -> dict:
        return self._owner._group_knobs(self.table_num_entries,
                                        self._grp.padded, self._grp.scheme,
                                        self._grp.radix)


class LookupRoundFuture:
    """One submitted query round; ``result()`` assembles the
    [n_bins, E] share matrix from the per-group engine futures (blocking
    only on this round's dispatches, FIFO per group)."""

    __slots__ = ("_n_bins", "_entry_size", "_parts", "_value")

    def __init__(self, n_bins, entry_size, parts):
        self._n_bins = n_bins
        self._entry_size = entry_size
        self._parts = parts             # [(group, EngineFuture)]
        self._value = None

    def done(self) -> bool:
        """True once this round has been resolved by ``result()`` or a
        covering ``drain()``; nothing flips it in the background."""
        return (self._value is not None
                or all(f.done() for _, f in self._parts))

    def result(self) -> np.ndarray:
        if self._value is None:
            out = np.zeros((self._n_bins, self._entry_size), np.int32)
            for grp, fut in self._parts:
                out[grp.idxs] = fut.result()
            self._value = out
            self._parts = []
        return self._value


class LookupStream:
    """Streaming batch-PIR serving: multi-round query batches pipelined
    through one ``ServingEngine`` per (n, G) size group.

    Each engine owns a single shape bucket (the group's mesh-padded size
    to the next power of two), ingest is the packed group codec, and up to
    ``max_in_flight`` rounds per group overlap host decode and staging
    with the card.  ``submit`` returns a ``LookupRoundFuture`` at once;
    results are bit-identical to ``PrivateLookupServer.answer``.
    ``retry`` (a ``serve.RetryPolicy``) re-attempts a failed group
    dispatch under bounded backoff; ``LoadShed`` and deadlines propagate
    at once."""

    def __init__(self, server: PrivateLookupServer, *,
                 max_in_flight: int = 2, warmup: bool = True,
                 retry=None):
        from ..core.u128 import next_pow2
        from ..serve import ServingEngine
        self._server = server
        self._n_bins = len(server.bins)
        self._retry = retry
        self._engines = []              # [(n, group, engine)]
        for n, grp in server._groups.items():
            adapter = _GroupStreamServer(server, n, grp)
            self._engines.append((n, grp, ServingEngine(
                adapter, max_in_flight=max_in_flight,
                buckets=[next_pow2(grp.padded)], warmup=warmup,
                label="n%dxG%d" % (n, len(grp.idxs)))))

    def submit(self, keys_per_bin) -> LookupRoundFuture:
        """Decode and dispatch one query round (one key per bin); returns
        a future at once.  Every group decodes (and fail-fast validates)
        before any engine dispatch, so a bad key in a later group leaves
        no earlier group's dispatch behind."""
        if len(keys_per_bin) != self._n_bins:
            raise ValueError("expected one key per bin (%d bins), got %d"
                             % (self._n_bins, len(keys_per_bin)))
        with span("round", bins=self._n_bins, groups=len(self._engines)):
            with span("pack", phase="group_decode"):
                decoded = [
                    (grp, eng, self._server._decode_group(
                        n, grp, [keys_per_bin[bi] for bi in grp.idxs]))
                    for n, grp, eng in self._engines]
            if self._retry is None:
                parts = [(grp, eng.submit(pk)) for grp, eng, pk in decoded]
            else:
                from ..serve.faults import submit_with_retry
                parts = [(grp, submit_with_retry(
                    lambda eng=eng, pk=pk: eng.submit(pk), self._retry,
                    stats=eng.stats)) for grp, eng, pk in decoded]
            return LookupRoundFuture(self._n_bins,
                                     self._server.entry_size, parts)

    def drain(self) -> None:
        """Resolve every outstanding dispatch across all group engines."""
        for _, _, eng in self._engines:
            eng.drain()

    def stats(self) -> dict:
        """Per-group engine counters, keyed "n<bin size>xG<group size>"."""
        return {"n%dxG%d" % (n, len(grp.idxs)): eng.stats.as_dict()
                for n, grp, eng in self._engines}

    def counters(self):
        """All group engines' counters folded into one
        ``EngineCounters``."""
        from ..utils.profiling import EngineCounters
        agg = EngineCounters()
        for _, _, eng in self._engines:
            agg.merge(eng.stats)
        return agg


class PrivateLookupClient:
    """Generates per-bin keys for a planned fetch and recovers entries.

    ``make_queries`` mints one batch of keys per (n, G) size group with
    the batched generators (``api.gen_batched_binary``,
    ``radix4.gen_batched_r4``, ``sqrtn.gen_sqrt_batched``);
    ``make_queries_scalar`` keeps the per-bin ``DPF.gen`` loop as its
    oracle (byte-identical keys under the same seeds).  ``scheme`` and
    ``radix`` mirror the server's; with ``scheme="auto"`` the table's
    ``entry_size`` and the server's ``device`` (None = the card when
    present, else the CPU) key the tuning-cache lookup that resolves
    each size group, so pass the server's.  Keys are int32 numpy
    arrays, byte-equal to ``dpf_tpu``'s."""

    def __init__(self, bins, bin_sizes, prf=None, radix: int = 2,
                 scheme: str = "logn", entry_size: int | None = None,
                 device=None):
        from ..api import DPF
        check_construction(scheme, radix)
        self.prf_method = DPF.DEFAULT_PRF if prf is None else prf
        self.radix = radix
        self.scheme = scheme
        self.entry_size = DPF.ENTRY_SIZE if entry_size is None \
            else entry_size
        self.bins = [sorted(b) for b in bins]
        self.bin_sizes = list(bin_sizes)
        self.index_to_bin = {}
        for bi, b in enumerate(self.bins):
            for pos, idx in enumerate(b):
                self.index_to_bin[idx] = (bi, pos)
        # size groups in bin order, as the server groups them
        self._size_groups = {}
        for bi, n in enumerate(self.bin_sizes):
            self._size_groups.setdefault(n, []).append(bi)
        self._constructions = {
            n: _resolve_construction(scheme, radix, n, len(idxs),
                                     self.entry_size, self.prf_method,
                                     device)
            for n, idxs in self._size_groups.items()}
        self._scalar_dpfs = {}

    def group_constructions(self) -> dict:
        """{bin size n: (scheme, radix)}; equal to the server's."""
        return dict(self._constructions)

    def _plan(self, wanted):
        plan = [None] * len(self.bins)
        for idx in wanted:
            if idx in self.index_to_bin:
                bi, _ = self.index_to_bin[idx]
                if plan[bi] is None:
                    plan[bi] = idx
        return plan

    def make_queries(self, wanted, seeds=None):
        """Pick at most one wanted index per bin; the others get a dummy
        query (position 0).

        Returns (keys for server A, keys for server B, plan), plan[bin]
        the table index retrieved there (None for a dummy query,
        indistinguishable from a real one to each server).  ``seeds``:
        an optional per-bin DRBG seed list (None = fresh entropy)."""
        from ..api import gen_batched_binary
        from ..core import radix4, sqrtn
        plan = self._plan(wanted)
        pos = [self.index_to_bin[t][1] if t is not None else 0
               for t in plan]
        ka = [None] * len(self.bins)
        kb = [None] * len(self.bins)
        for n, idxs in self._size_groups.items():
            sch, rad = self._constructions[n]
            alphas = [pos[bi] for bi in idxs]
            sd = None if seeds is None else [seeds[bi] for bi in idxs]
            if sch == "sqrtn":
                wa, wb = sqrtn.gen_sqrt_batched(
                    alphas, n, sd, prf_method=self.prf_method)
            elif rad == 4:
                wa, wb = radix4.gen_batched_r4(
                    alphas, n, sd, prf_method=self.prf_method)
            else:
                wa, wb = gen_batched_binary(alphas, n, sd, self.prf_method)
            wa, wb = wa.numpy(), wb.numpy()
            for p, bi in enumerate(idxs):
                ka[bi] = wa[p]
                kb[bi] = wb[p]
        return ka, kb, plan

    def _scalar_dpf(self, sch: str, rad: int):
        from ..api import DPF
        from ..utils.config import EvalConfig
        key = (sch, rad)
        if key not in self._scalar_dpfs:
            self._scalar_dpfs[key] = DPF(
                config=EvalConfig(prf_method=self.prf_method, radix=rad,
                                  scheme=sch), device="cpu")
        return self._scalar_dpfs[key]

    def make_queries_scalar(self, wanted, seeds=None):
        """The per-bin ``DPF.gen`` loop, kept as the oracle: keys
        byte-identical to ``make_queries`` under the same ``seeds``."""
        plan = self._plan(wanted)
        ka, kb = [], []
        for bi, target in enumerate(plan):
            pos = self.index_to_bin[target][1] if target is not None else 0
            n = self.bin_sizes[bi]
            dpf = self._scalar_dpf(*self._constructions[n])
            k1, k2 = dpf.gen(pos, n,
                             seed=None if seeds is None else seeds[bi])
            ka.append(k1.numpy())
            kb.append(k2.numpy())
        return ka, kb, plan

    def recover(self, shares_a, shares_b, plan):
        """-> {table index: entry row} for the non-dummy queries."""
        diff = (np.asarray(shares_a, np.int64)
                - np.asarray(shares_b, np.int64)).astype(np.int32)
        return {target: diff[bi] for bi, target in enumerate(plan)
                if target is not None}
