"""Serving-cluster worker process (``python -m
dpf_tpu_torch.parallel.cluster_worker <hex-pickled-config>``; port of
``dpf_tpu/parallel/cluster_worker.py``).

One worker is one serving host: it rebuilds the table from its config
(``cluster_net.make_table``: no table bytes cross the wire), permutes
it, holds its granules in a ``ClusterShardServer`` behind a
``ServingEngine`` on the device its config names (None = the card; a
named card that is absent fails the worker, it does not serve from the
CPU), then answers framed-pickle requests on a localhost TCP socket
(port 0 = ephemeral; the port is published as a ``PORT <p>`` line on
stdout).  Requests are handled one at a time, so replies are FIFO.
Config keys:

  label, row0s, granule, n, entry_size, table_seed, prf_method,
  process_index, port (0), buckets, max_in_flight, device,
  fault_plan (optional: {"seed", "specs": [FaultSpec kwargs]}, so a
  worker can drop itself deterministically), and distributed (optional:
  {"coordinator_address", "num_processes", "process_id", "timeout_s",
  "backend"} to join a process group through ``multihost.initialize``).

The worker stamps its flight and metrics output with ``process_index``
(``obs.set_process_index``) and ships ``obs.record_sections()`` and its
kernels' launch counts (``ops.launch_counts``) in its ``stats`` reply.
"""

from __future__ import annotations

import pickle
import socket
import sys


def _build(config):
    """Build this host's shard server + engine from the config."""
    from ..core import expand
    from ..obs import set_process_index
    from ..parallel.cluster import ClusterShardServer, LocalHost
    from .cluster_net import make_table

    if config.get("process_index") is not None:
        set_process_index(int(config["process_index"]))
    dist = config.get("distributed")
    if dist:
        from . import multihost
        multihost.initialize(
            coordinator_address=dist.get("coordinator_address"),
            num_processes=dist.get("num_processes"),
            process_id=dist.get("process_id"),
            initialization_timeout_s=dist.get("timeout_s"),
            backend=dist.get("backend"), device=config.get("device"))
    injector = None
    fp = config.get("fault_plan")
    if fp:
        from ..serve.faults import FaultPlan, FaultSpec
        injector = FaultPlan([FaultSpec(**s) for s in fp["specs"]],
                             seed=fp.get("seed", 0)).injector()
    table = make_table(config["n"], config["entry_size"],
                       config.get("table_seed", 0))
    perm = expand.permute_table(table)
    srv = ClusterShardServer(perm, config["row0s"], config["granule"],
                             prf_method=config["prf_method"],
                             device=config.get("device"))
    node = LocalHost(config["label"], srv,
                     process_index=config.get("process_index"),
                     buckets=config.get("buckets"), injector=injector,
                     max_in_flight=config.get("max_in_flight", 2))
    return node, injector


def _handle(node, injector, req):
    """One request -> one reply dict ({"ok": True, ...} or an error
    envelope carrying the exception class name for the client to
    re-raise as the right cluster error)."""
    from ..core import keygen
    from .cluster_net import pk_from_wire

    op = req.get("op")
    if op == "hello":
        return {"ok": True, "host": node.label,
                "granules": list(node.granules), "n": node.server.n,
                "entry_size": node.server.entry_size,
                "process_index": node.process_index}
    if op == "serve":
        if injector is not None:
            arrival = req.get("arrival")
            if arrival is not None:
                injector.begin_arrival(int(arrival))
        pk = pk_from_wire(req["pk"])
        if not isinstance(pk, keygen.PackedKeys):  # defensive
            raise TypeError("serve needs a packed batch")
        return {"ok": True, "out": node.submit(pk).result()}
    if op == "heartbeat":
        return {"ok": True, "status": node.heartbeat()}
    if op == "add_granules":
        node.add_granules(req["row0s"])
        return {"ok": True, "granules": list(node.granules)}
    if op == "counters":
        return {"ok": True, "counters": node.counters().as_dict()}
    if op == "stats":
        from ..obs import record_sections
        from ..ops import launch_counts
        return {"ok": True,
                "stats": dict(node.stats(), obs=record_sections(),
                              launches=launch_counts())}
    if op == "warmup":
        node.warmup()
        return {"ok": True}
    if op == "drain":
        node.drain()
        return {"ok": True}
    if op == "shutdown":
        return {"ok": True, "bye": True}
    return {"ok": False, "error": "ValueError",
            "detail": "unknown op %r" % (op,)}


def serve_forever(config) -> int:
    """Bind, publish the port, build the host, answer until shutdown
    or EOF.  Returns the exit code."""
    from .cluster_net import recv_frame, send_frame

    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(("127.0.0.1", int(config.get("port", 0))))
    lsock.listen(1)
    # publish after bind, before the build (the table upload): the
    # parent's connect waits in the accept backlog meanwhile
    print("PORT %d" % lsock.getsockname()[1], flush=True)
    node, injector = _build(config)
    conn, _ = lsock.accept()
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        while True:
            try:
                req = recv_frame(conn)
            except (ConnectionError, EOFError):
                return 0          # parent went away: clean exit
            try:
                reply = _handle(node, injector, req)
            except BaseException as e:  # noqa: BLE001 — the envelope IS
                # the error channel; the client re-raises by class name
                reply = {"ok": False, "error": type(e).__name__,
                         "detail": str(e)}
            send_frame(conn, reply)
            if reply.get("bye"):
                return 0
    finally:
        conn.close()
        lsock.close()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m dpf_tpu_torch.parallel.cluster_worker "
              "<hex-pickled-config>", file=sys.stderr)
        return 2
    config = pickle.loads(bytes.fromhex(argv[0]))
    return serve_forever(config)


if __name__ == "__main__":
    sys.exit(main())
