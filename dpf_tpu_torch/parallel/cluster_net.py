"""Socket transport for the serving cluster: ``RemoteHost`` and worker
spawn (port of ``dpf_tpu/parallel/cluster_net.py``).

``parallel/cluster.py``'s router does not know the transport: any object
with the host protocol (``submit`` / ``heartbeat`` / ``add_granules`` /
``counters`` / ``stats``) can sit in its scatter plan.  This module is
the out-of-process one:

* **Framing** -- length-prefixed pickle over a localhost TCP socket
  (trusted child processes only: the parent spawns the worker and never
  exposes it).  One request, one reply, FIFO per connection, so a
  client pipelines: ``submit`` sends and returns a future whose
  ``result()`` drains the replies in order.
* **``RemoteHost``** -- the socket client.  Any transport failure
  (worker killed, socket reset, a timeout) raises
  ``cluster.HostUnreachable``, which the router treats as a host drop;
  best-effort teardown records what it swallows under
  ``cluster.peer_unreachable``.
* **``spawn_worker`` / ``spawn_cluster``** -- start ``cluster_worker``
  children (one per host) on ephemeral ports and connect.  Workers
  rebuild the table from ``make_table(n, entry_size, seed)``, as the
  front end does, so no table bytes cross the socket; a worker's config
  names its device, and workers of one machine share its card, loading
  the kernels the parent built into ``dpf_tpu_torch/_build/``.

The wire carries packed key batches (the front end decodes once), int32
partial shares and small control dicts.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from ..core import keygen
from ..utils.profiling import EngineCounters, note_swallowed
from .cluster import HostUnreachable

_LEN = struct.Struct(">I")
#: per-reply receive timeout (seconds) — a worker that stops answering
#: is a dead host, not a slow one
DEFAULT_TIMEOUT_S = 30.0


def make_table(n: int, entry_size: int, seed: int) -> np.ndarray:
    """The deterministic table both sides build (a worker from its
    config, the front end for the oracle and the spare): no table bytes
    on the wire.  ``dpf_tpu``'s rows, byte for byte."""
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, size=(n, entry_size),
                        dtype=np.int32)


def send_frame(sock, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(data)) + data)


def recv_frame(sock):
    head = _recv_exact(sock, _LEN.size)
    (length,) = _LEN.unpack(head)
    return pickle.loads(_recv_exact(sock, length))


def _recv_exact(sock, count: int) -> bytes:
    buf = bytearray()
    while len(buf) < count:
        chunk = sock.recv(count - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def pk_to_wire(pk: keygen.PackedKeys) -> dict:
    return {"cw1": pk.cw1, "cw2": pk.cw2, "last": pk.last,
            "depth": pk.depth, "n": pk.n}


def pk_from_wire(d: dict) -> keygen.PackedKeys:
    return keygen.PackedKeys(cw1=d["cw1"], cw2=d["cw2"], last=d["last"],
                             depth=int(d["depth"]), n=int(d["n"]))


class _ReplySlot:
    __slots__ = ("value", "filled")

    def __init__(self):
        self.value = None
        self.filled = False


class RemoteFuture:
    """FIFO-pipelined result handle for one remote ``serve`` call."""

    def __init__(self, host, slot):
        self._host = host
        self._slot = slot

    def done(self) -> bool:
        return self._slot.filled

    def result(self):
        out = self._host._wait(self._slot)
        if not out.get("ok"):
            raise self._host._as_error(out)
        return out["out"]


class RemoteHost:
    """Host-protocol client over one worker socket.

    Mirrors ``cluster.LocalHost``; every transport failure raises
    ``HostUnreachable`` so the router's recovery state machine treats a
    killed worker exactly like an injected host drop."""

    def __init__(self, address, label: str, *,
                 process_index: int | None = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S, proc=None):
        self.label = label
        self.process_index = process_index
        self.proc = proc                  # the Popen, when we spawned it
        self._timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._slots = []                  # unread reply slots, FIFO
        self._sock = socket.create_connection(address,
                                              timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        hello = self._call({"op": "hello"})
        self._granules = tuple(hello["granules"])
        self.n = int(hello["n"])
        self.entry_size = int(hello["entry_size"])
        if process_index is None:
            self.process_index = hello.get("process_index")

    # ----------------------------------------------------------- wire

    def _send(self, req) -> _ReplySlot:
        slot = _ReplySlot()
        with self._lock:
            try:
                send_frame(self._sock, req)
            except OSError as e:
                raise HostUnreachable(
                    "host %r unreachable on send: %s"
                    % (self.label, e)) from e
            self._slots.append(slot)
        return slot

    def _wait(self, slot: _ReplySlot):
        with self._lock:
            while not slot.filled:
                try:
                    reply = recv_frame(self._sock)
                except (OSError, EOFError, ConnectionError,
                        pickle.UnpicklingError) as e:
                    raise HostUnreachable(
                        "host %r unreachable on recv: %s"
                        % (self.label, e)) from e
                head = self._slots.pop(0)
                head.value = reply
                head.filled = True
        return slot.value

    def _call(self, req):
        out = self._wait(self._send(req))
        if not out.get("ok"):
            raise self._as_error(out)
        return out

    def _as_error(self, out) -> Exception:
        from ..serve.faults import HostDropped
        name = out.get("error", "RuntimeError")
        detail = out.get("detail", "")
        if name in ("HostDropped", "EngineDead"):
            return HostDropped("host %r: %s" % (self.label, detail))
        return RuntimeError("host %r %s: %s" % (self.label, name, detail))

    # -------------------------------------------------- host protocol

    def submit(self, pk) -> RemoteFuture:
        if not isinstance(pk, keygen.PackedKeys):
            pk = keygen.decode_keys_batched(pk)
        return RemoteFuture(self, self._send({"op": "serve",
                                              "pk": pk_to_wire(pk)}))

    def heartbeat(self) -> dict:
        # unwrap to the status dict so the node protocol matches
        # LocalHost.heartbeat exactly
        return self._call({"op": "heartbeat"})["status"]

    def add_granules(self, row0s) -> None:
        out = self._call({"op": "add_granules",
                          "row0s": [int(r) for r in row0s]})
        self._granules = tuple(out["granules"])

    @property
    def granules(self) -> tuple:
        return self._granules

    def counters(self) -> EngineCounters:
        """The worker's additive counter fields rebuilt into a local
        ``EngineCounters`` so ``ClusterRouter.counters()`` merges
        remote hosts like local ones (latency ring stays worker-side;
        the scalar SLO/fault fields all transfer)."""
        out = self._call({"op": "counters"})
        agg = EngineCounters()
        for name, value in out["counters"].items():
            if hasattr(agg, name) and isinstance(value, (int, float)) \
                    and not name.startswith("_"):
                try:
                    agg.inc(name, value)
                except Exception:
                    pass    # derived/readonly field — ring stays remote
        return agg

    def stats(self) -> dict:
        return self._call({"op": "stats"})["stats"]

    def warmup(self) -> None:
        self._call({"op": "warmup"})

    def drain(self) -> None:
        self._call({"op": "drain"})

    def kill(self) -> None:
        """Hard-kill the worker process (chaos legs): the next
        touch raises ``HostUnreachable`` — a REAL host death, detected
        through the same path as an injected one."""
        if self.proc is not None:
            self.proc.kill()
            self.proc.wait()

    def close(self) -> None:
        try:
            self._send({"op": "shutdown"})
        except Exception as e:
            # the peer may already be gone (chaos legs kill it); the
            # suppressed cause stays visible in the swallowed registry
            note_swallowed("cluster.peer_unreachable", e)
        try:
            self._sock.close()
        except OSError as e:
            note_swallowed("cluster.peer_unreachable", e)
        if self.proc is not None:
            try:
                self.proc.wait(timeout=5)
            except Exception as e:
                note_swallowed("cluster.peer_unreachable", e)
                self.proc.kill()


# -------------------------------------------------------------- spawn

def _child_env() -> dict:
    """This environment with the package's root first on PYTHONPATH, so
    a child imports the same ``dpf_tpu_torch``."""
    root = str(Path(__file__).resolve().parents[2])
    path = os.environ.get("PYTHONPATH")
    return {**os.environ,
            "PYTHONPATH": root if not path else root + os.pathsep + path}


def _start_worker(config: dict):
    """Start one ``cluster_worker`` child on an ephemeral port (its
    standard error is this process's); returns (config, process)."""
    cfg = dict(config)
    cfg.setdefault("port", 0)
    proc = subprocess.Popen(
        [sys.executable, "-m", "dpf_tpu_torch.parallel.cluster_worker",
         pickle.dumps(cfg).hex()],
        stdout=subprocess.PIPE, text=True, env=_child_env())
    return cfg, proc


def _connect_worker(cfg: dict, proc, timeout_s: float):
    """Read the started worker's port and connect a ``RemoteHost``."""
    deadline = time.monotonic() + timeout_s
    port = None
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        if line.startswith("PORT "):
            port = int(line.split()[1])
            break
    if port is None:
        proc.kill()
        raise HostUnreachable(
            "worker %r never published its port (exit=%s)"
            % (cfg.get("label"), proc.poll()))
    return RemoteHost(("127.0.0.1", port), cfg["label"],
                      process_index=cfg.get("process_index"),
                      timeout_s=timeout_s, proc=proc)


def spawn_worker(config: dict, *, timeout_s: float = 60.0):
    """Start one ``cluster_worker`` child and return a connected
    ``RemoteHost``.  ``config`` needs label / row0s / granule / n /
    entry_size / table_seed / prf_method / device (see
    ``cluster_worker``)."""
    return _connect_worker(*_start_worker(config), timeout_s)


def spawn_cluster(n: int, entry_size: int, hosts: int, *,
                  table_seed: int = 0, prf_method: int | None = None,
                  buckets=None, max_in_flight: int = 2,
                  timeout_s: float = 60.0, device=None):
    """Spawn one worker per host over the deterministic table, all
    started together, and return the connected ``RemoteHost`` list (plan
    order).  ``device``: every worker's device (None = the card)."""
    from .cluster import make_plan
    if prf_method is None:
        from ..api import DPF
        prf_method = DPF.DEFAULT_PRF
    plan = sorted(make_plan(n, hosts).items(),
                  key=lambda kv: int(kv[0][4:]))
    started = [_start_worker({
        "label": lb, "row0s": list(row0s), "granule": n // hosts, "n": n,
        "entry_size": entry_size, "table_seed": table_seed,
        "prf_method": prf_method, "process_index": i,
        "buckets": list(buckets) if buckets else None,
        "max_in_flight": max_in_flight,
        "device": str(device) if device is not None else None,
    }) for i, (lb, row0s) in enumerate(plan)]
    nodes = []
    try:
        for cfg, proc in started:
            nodes.append(_connect_worker(cfg, proc, timeout_s))
    except Exception:
        for _, proc in started:
            proc.kill()
            proc.wait()
        raise
    return nodes
