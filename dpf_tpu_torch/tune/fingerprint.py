"""Cache keys for the autotuner: device fingerprint x program shape.

Port of ``dpf_tpu/tune/fingerprint.py``.  A tuned knob set is only
valid for the (hardware, program shape) pair it was measured on.  The
key has two halves:

* ``device_fingerprint(device)``: on a CUDA device the card's name, its
  compute capability, its SM count, the number of cards and the torch
  and CUDA versions (``cuda/<name>/sm<major><minor>/<SMs>sm/x<cards>/
  torch<ver>+cuda<ver>``); on the CPU ``cpu/<machine>/x1/torch<ver>``.
  The two tiers never share a prefix, so a knob tuned on the card never
  answers a CPU server's lookup, nor the reverse;
* ``shape_key()``: (N, E, B, prf, scheme, radix), ``dpf_tpu``'s grammar
  byte for byte.

``cache_key(kind, ...)`` joins both as ``<kind>|<device>|<shape>``;
the mesh-path kinds (``mesh``, ``meshsplit``, mesh-tagged ``serve``,
``cluster``) add ``.m<mesh_tag>`` to the shape.
"""

from __future__ import annotations

import functools
import platform


def _resolve(device):
    import torch
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


@functools.lru_cache(maxsize=None)
def _fingerprint(kind: str, index: int) -> str:
    import torch
    if kind == "cuda":
        p = torch.cuda.get_device_properties(index)
        return "cuda/%s/sm%d%d/%dsm/x%d/torch%s+cuda%s" % (
            p.name.replace(" ", "_"), p.major, p.minor,
            p.multi_processor_count, torch.cuda.device_count(),
            torch.__version__, torch.version.cuda)
    return "cpu/%s/x1/torch%s" % (platform.machine() or "unknown",
                                  torch.__version__)


def device_fingerprint(device=None) -> str:
    """Stable id of the measuring hardware and toolchain for ``device``
    (None = the card when CUDA is available, else the CPU)."""
    dev = _resolve(device)
    if dev.type == "cuda":
        return _fingerprint("cuda", dev.index or 0)
    return _fingerprint("cpu", 0)


def shape_key(*, n: int, entry_size: int, batch: int, prf_method: int,
              scheme: str = "logn", radix: int = 2,
              mesh: str | None = None) -> str:
    """The shape half of a key: ``n<N>.e<E>.b<B>.prf<id>.<scheme>.r<radix>``
    (``.m<mesh>`` for the mesh-path kinds)."""
    key = "n%d.e%d.b%d.prf%d.%s.r%d" % (
        n, entry_size, batch, prf_method, scheme, radix)
    if mesh is not None:
        key += ".m%s" % mesh
    return key


def mesh_tag(mesh) -> str:
    """The mesh half of a mesh-path key (``dpf_tpu``'s grammar):
    ``<n_batch>x<n_table>``, with ``b<n_byte>`` after it for a 2D mesh
    whose byte axis is larger than 1; any other layout tags as
    ``<axis><size>`` pairs in axis order.  A mesh of one card repeated
    tags like one of distinct cards: the device half of the key tells
    the machines apart, not how the mesh placed its shards."""
    shape = dict(mesh.shape)
    if set(shape) == {"batch", "table"}:
        return "%dx%d" % (shape["batch"], shape["table"])
    if set(shape) == {"batch", "table", "byte"}:
        tag = "%dx%d" % (shape["batch"], shape["table"])
        return tag if shape["byte"] == 1 else tag + "b%d" % shape["byte"]
    return "x".join("%s%d" % (a, shape[a]) for a in mesh.axis_names)


def cache_key(kind: str, *, n: int, entry_size: int, batch: int,
              prf_method: int, scheme: str = "logn", radix: int = 2,
              mesh: str | None = None, fingerprint: str | None = None,
              device=None) -> str:
    """Full tuning-cache key: ``<kind>|<device>|<shape>``; the device half
    is ``fingerprint`` when given, else ``device_fingerprint(device)``."""
    fp = fingerprint if fingerprint is not None else \
        device_fingerprint(device)
    return "%s|%s|%s" % (kind, fp, shape_key(
        n=n, entry_size=entry_size, batch=batch, prf_method=prf_method,
        scheme=scheme, radix=radix, mesh=mesh))
