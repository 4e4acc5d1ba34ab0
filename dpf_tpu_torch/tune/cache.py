"""Persistent JSON tuning cache: search once per shape per machine.

Port of ``dpf_tpu/tune/cache.py``.  One small file maps
``fingerprint.cache_key`` strings to tuned-knob records (``{"knobs":
{...}, "measured": {...}, "fingerprint": ..., "gated": true,
"tuned_at": ...}``).  The port keeps a file of its own so that the two
packages' tests and tuners never write one file: the default is
``~/.cache/dpf_tpu_torch/tuning.json``, ``DPF_TPU_TORCH_TUNE_CACHE=
<path>`` overrides it and ``DPF_TPU_TORCH_TUNE_CACHE=0`` (or ``off``,
``none``, ``disabled``) keeps the cache in memory only.

Every lookup moves ``utils.profiling.CACHE_COUNTERS.tuning_{hits,
misses}``, every store ``tuning_stores``.  Writes are atomic (a temporary
file, then a rename) and merge on save: concurrent tuners lose at worst
their own last write.  A lookup on behalf of a server passes the
server's device, so the key's device half is that device's fingerprint.
"""

from __future__ import annotations

import datetime
import json
import os
import tempfile

from ..utils.profiling import CACHE_COUNTERS, note_swallowed
from .fingerprint import cache_key

ENV = "DPF_TPU_TORCH_TUNE_CACHE"
_OFF = ("0", "off", "none", "disabled")
VERSION = 1


def default_path() -> str | None:
    """Resolved cache file path: ``$DPF_TPU_TORCH_TUNE_CACHE``, None when
    it is "0"/"off"/"none"/"disabled", else
    ``~/.cache/dpf_tpu_torch/tuning.json``."""
    v = os.environ.get(ENV)
    if v is not None:
        return None if v.strip().lower() in _OFF or not v.strip() else v
    return os.path.join(os.path.expanduser("~"), ".cache", "dpf_tpu_torch",
                        "tuning.json")


class TuningCache:
    """Dict-of-records view over the JSON file (loaded once per
    instance).  ``path=None`` means ``default_path()``; when that is None
    too the cache lives in memory only."""

    def __init__(self, path: str | None = None):
        self.path = path if path is not None else default_path()
        self.entries: dict = {}
        self.load_error: str | None = None
        if self.path and os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    data = json.load(f)
                if data.get("version") == VERSION:
                    self.entries = dict(data.get("entries", {}))
            except (OSError, ValueError) as e:
                # a corrupt cache is a cold cache, with the cause kept
                self.entries = {}
                self.load_error = "%s: %s" % (type(e).__name__, e)
                note_swallowed("tune.cache.load", e)

    # ------------------------------------------------------------ lookups

    def lookup(self, key: str) -> dict | None:
        rec = self.entries.get(key)
        if rec is None:
            CACHE_COUNTERS.tuning_misses += 1
        else:
            CACHE_COUNTERS.tuning_hits += 1
        return rec

    def lookup_knobs(self, kind: str, *, nearest_batch: bool = False,
                     device=None, **shape) -> dict | None:
        """The tuned knob dict for one shape, or None.  With
        ``nearest_batch`` an exact-batch miss falls back to the same-shape
        entry whose batch is closest (the largest tuned batch <= the one
        asked, else the smallest above).  One call moves one counter."""
        rec = self.entries.get(cache_key(kind, device=device, **shape))
        if rec is None and nearest_batch:
            want = shape["batch"]
            below, above = None, None
            for b, r in self._batch_variants(kind, device, **shape):
                if b <= want and (below is None or b > below[0]):
                    below = (b, r)
                if b > want and (above is None or b < above[0]):
                    above = (b, r)
            hit = below or above
            rec = hit[1] if hit else None
        if rec is None:
            CACHE_COUNTERS.tuning_misses += 1
            return None
        CACHE_COUNTERS.tuning_hits += 1
        return rec.get("knobs")

    def _batch_variants(self, kind: str, device, **shape):
        for b in (1 << i for i in range(21)):
            if b == shape["batch"]:
                continue
            rec = self.entries.get(
                cache_key(kind, device=device, **{**shape, "batch": b}))
            if rec is not None:
                yield b, rec

    # ------------------------------------------------------------- stores

    def store(self, key: str, record: dict) -> None:
        record = dict(record)
        record.setdefault(
            "tuned_at",
            datetime.datetime.now(datetime.timezone.utc).isoformat(
                timespec="seconds"))
        self.entries[key] = record
        CACHE_COUNTERS.tuning_stores += 1
        self._save()

    def _save(self) -> None:
        if not self.path:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        merged = dict(self.entries)
        try:  # merge on save: keep entries another process added
            with open(self.path) as f:
                disk = json.load(f)
            if disk.get("version") == VERSION:
                merged = {**disk.get("entries", {}), **self.entries}
        except (OSError, ValueError):
            pass
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(self.path) or ".", suffix=".tuning")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"version": VERSION, "entries": merged}, f,
                          indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


_DEFAULT: TuningCache | None = None


def default_cache(refresh: bool = False) -> TuningCache:
    """The process-wide cache over ``default_path()`` (re-created when
    the env var moves the path, or on ``refresh=True``)."""
    global _DEFAULT
    path = default_path()
    if refresh or _DEFAULT is None or _DEFAULT.path != path:
        _DEFAULT = TuningCache(path)
    return _DEFAULT


def _lookup(site: str, kind: str, **kw) -> dict | None:
    """``default_cache().lookup_knobs`` with the nearest-batch fallback;
    never raises (an unreadable cache is a miss)."""
    try:
        return default_cache().lookup_knobs(kind, nearest_batch=True, **kw)
    except Exception as e:  # never break serving
        note_swallowed("tune.cache." + site, e)
        return None


def lookup_eval_knobs(*, n: int, entry_size: int, batch: int,
                      prf_method: int, scheme: str = "logn", radix: int = 2,
                      device=None) -> dict | None:
    """Tuned eval knobs (``search.tune_eval``) for this shape on
    ``device``'s hardware."""
    return _lookup("lookup_eval_knobs", "eval", n=n, entry_size=entry_size,
                   batch=batch, prf_method=prf_method, scheme=scheme,
                   radix=radix, device=device)


def lookup_mesh_knobs(*, n: int, entry_size: int, batch: int,
                      prf_method: int, mesh: str, scheme: str = "logn",
                      radix: int = 2, device=None) -> dict | None:
    """Tuned mesh-path knobs (``mesh_tune.tune_mesh_eval``: per-shard
    ``chunk_leaves`` / ``row_chunk``, ``psum_group``) for this shape on
    ``device``'s hardware and this mesh split (``mesh`` =
    ``fingerprint.mesh_tag``)."""
    return _lookup("lookup_mesh_knobs", "mesh", n=n, entry_size=entry_size,
                   batch=batch, prf_method=prf_method, scheme=scheme,
                   radix=radix, mesh=mesh, device=device)


def lookup_kernel_variant(*, n: int, entry_size: int, batch: int,
                          prf_method: int, scheme: str = "sqrtn",
                          radix: int = 2, device=None) -> dict | None:
    """The searched kernel-variant knobs (``kernel_search``'s
    ``kvariant`` entries) for this shape; sqrt-N entries under
    scheme="sqrtn", GGM entries under scheme="logn" with their radix."""
    return _lookup("lookup_kernel_variant", "kvariant", n=n,
                   entry_size=entry_size, batch=batch,
                   prf_method=prf_method, scheme=scheme, radix=radix,
                   device=device)


def lookup_keygen_variant(*, n: int, batch: int, prf_method: int,
                          scheme: str = "logn", radix: int = 2,
                          device=None) -> dict | None:
    """The searched batched-keygen knobs (``kernel_search.keygen_search``),
    keyed with the ``entry_size=0`` sentinel (keygen cost does not depend
    on the table's width)."""
    return _lookup("lookup_keygen_variant", "kvariant", n=n, entry_size=0,
                   batch=batch, prf_method=prf_method, scheme=scheme,
                   radix=radix, device=device)


def lookup_scheme(*, n: int, entry_size: int, batch: int, prf_method: int,
                  device=None) -> dict | None:
    """The measured winning construction (``search.scheme_sweep``):
    ``{"scheme", "radix", "construction"}``."""
    return _lookup("lookup_scheme", "scheme", n=n, entry_size=entry_size,
                   batch=batch, prf_method=prf_method, scheme="any",
                   radix=0, device=device)
