"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result line.

    python3 pirbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start to the first
timed submit): imports, the CUDA context, the table from the seed on
the card, the key pool (the frozen generator, on the host),
``DPF.eval_init``, ``dpf.serving_engine()`` with the program's defaults,
and one real request of each bucket size the cell's traffic uses.  The
window drives ``ServingEngine.submit(keys)`` and
``EngineFuture.result()``.  After it, the peak device memory is read,
the modules are checked for JAX, the program's state is freed, and a
sample of the window's answers is held against the reference.  With
``--trace 1`` the window runs under ``torch.profiler`` (the card's
activity) and the program's span tracer, and the line carries the
per-layer metrics, ``busy_s``, ``window_s`` and a breakdown.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from . import check, client, devtrace, loadgen, spec
from .peaks import least_seconds

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "dpf_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden (the
    program's own name starts with ``dpf_tpu`` and is not)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class RunView:
    """What the metric readers read: the window's requests and time, the
    program's counters over the window, the device trace's reduction
    (None when nothing was traced on a card) and the frozen work."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    @property
    def answered(self) -> list:
        return [r for r in self.requests if r.shares is not None]


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


def _power_limit() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def make_table(n: int, e: int, seed: int, device):
    """The [n, e] int32 table, drawn on ``device`` from the seed."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2 ** 63 - 1))
    return torch.randint(-2 ** 31, 2 ** 31, (n, e), generator=g,
                         device=device, dtype=torch.int64).to(torch.int32)


def make_pool(cfg: dict, traffic: dict, seed: int):
    """The key pool: distinct keys of both servers at seeded indices."""
    n = int(cfg["entries"])
    size = int(traffic["pool_keys"])
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 1])
    alphas = rng.integers(0, n, size)
    seeds = [b"pirbench:%d:%d" % (seed, i) for i in range(size)]
    cons = spec.construction(cfg["construction"])
    w0, w1 = cons.gen(alphas, n, seeds, spec.cipher(cfg["prf"]))
    return {"wire0": w0, "wire1": w1, "alphas": alphas}


def plan(traffic: dict, pool_size: int, seconds: float, seed: int):
    """The requests the window will offer: (due times or None, pool rows
    of each request, the sizes to warm up)."""
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 2])
    if traffic["loop"] == "closed":
        b = int(traffic["batch_keys"])
        batches = [rng.choice(pool_size, b, replace=False)
                   for _ in range(int(traffic["distinct_batches"]))]
        return None, batches, [b]
    times, sizes = loadgen.poisson_schedule(traffic, seconds)
    rows = [rng.choice(pool_size, int(k), replace=False) for k in sizes]
    return times, rows, sorted({int(k) for k in sizes})


def prepare(cell: dict, seed: int, seconds: float, device: str,
            log) -> dict:
    """Set-up: the table on the device, the key pool, the planned
    requests, the program's server and engine, and one warm-up of each
    bucket size the traffic uses (two real requests a size)."""
    import torch
    from dpf_tpu_torch.api import DPF

    cfg, traffic = cell["config"], cell["traffic"]
    n, e = int(cfg["entries"]), int(cfg["entry_words"])
    marks = [("start", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    table = make_table(n, e, seed, torch.device(device))
    mark("table and CUDA context")
    pool = make_pool(cfg, traffic, seed)
    mark("key pool")
    times, rows, sizes = plan(traffic, len(pool["alphas"]), seconds, seed)
    mark("plan")
    dpf = DPF(device=device, **cfg["program"])
    dpf.eval_init(table.cpu().numpy())
    engine = dpf.serving_engine()
    mark("eval_init")
    buckets = sorted({engine.buckets.bucket_for(min(k, engine.buckets.max))
                      for k in sizes})
    warm_rng = np.random.default_rng(0)
    for b in buckets:
        for _ in range(2):
            engine.submit(pool["wire0"][warm_rng.choice(
                len(pool["alphas"]), b, replace=False)]).result()
    mark("warm-up")
    log("pirbench: set-up steps (s): " + ", ".join(
        "%s %.3f" % (name, t - marks[i][1])
        for i, (name, t) in enumerate(marks[1:])))
    return {"table": table, "pool": pool, "times": times, "rows": rows,
            "dpf": dpf, "engine": engine, "buckets": buckets}


def offer(st: dict, traffic: dict, seconds: float, rec) -> tuple:
    """The window: the traffic's loop through ``engine.submit`` and
    ``EngineFuture.result``.  Returns (requests, window seconds)."""
    if st["times"] is None:
        return client.closed_loop(st["engine"], st["pool"]["wire0"],
                                  st["rows"], seconds,
                                  int(traffic["outstanding"]), rec)
    return client.open_loop(st["engine"], st["pool"]["wire0"], st["times"],
                            st["rows"], int(traffic["outstanding"]), rec)


def _reduce_trace(prof, wall0, perf0, wall1, spans, tracer_zero,
                  client_spans, log):
    """Export the window's profiler trace to a temporary file and reduce
    it (``devtrace.reduce``), the program's spans and the client's put on
    the trace's clock; None when the trace holds no device event."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "window.json")
        prof.export_chrome_trace(path)
        events = devtrace.device_events(path)

    def to_wall(t):
        return wall0 + (t - perf0) * 1e6

    zero = to_wall(tracer_zero)
    prog = [(s["name"], zero + s["ts_us"], zero + s["ts_us"] + s["dur_us"])
            for s in spans]
    cli = [(lab, to_wall(a), to_wall(b)) for lab, a, b in client_spans]
    log("pirbench: trace %d device events, %d program spans"
        % (len(events), len(prog)))
    if not events:
        return None
    return devtrace.reduce(events, wall0, wall1, prog, cli)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             log=None) -> dict:
    """Run ``cell`` (``spec.load_cell``) once; returns the result line's
    object.  ``device="cpu"`` runs the program's plain versions (for
    rehearsal at small sizes; no device number is then reported)."""
    import torch
    from dpf_tpu_torch import ops
    from dpf_tpu_torch.obs import tracer as port_tracer

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    cfg, traffic = cell["config"], cell["traffic"]
    cuda = device != "cpu"
    n, e = int(cfg["entries"]), int(cfg["entry_words"])

    # ---- set-up
    log("pirbench: imports and CUDA context %.3f s"
        % (time.perf_counter() - t_start))
    st = prepare(cell, seed, seconds, device, log)
    engine, table, pool = st["engine"], st["table"], st["pool"]
    rec = client.Recorder(trace)
    prof = tracer = None
    if trace:
        port_tracer.spanring_error()        # build the span ring first
        a = time.perf_counter()
        tracer = port_tracer.enable(capacity=1 << 20)
        tracer_zero = (a + time.perf_counter()) / 2
        if cuda:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
    if cuda:
        torch.cuda.synchronize()
    stats0 = engine.stats.as_dict()
    launches0 = ops.launch_counts()
    found = forbidden_modules()
    if found:
        raise SystemExit("forbidden modules loaded after set-up: %s"
                         % ", ".join(found))
    wall0, perf0 = devtrace.clock_pair()
    setup_s = time.perf_counter() - t_start

    # ---- the window
    reqs, window_s = offer(st, traffic, seconds, rec)
    if cuda:
        torch.cuda.synchronize()
    wall1, _ = devtrace.clock_pair()
    log("pirbench: set-up %.3f s, window %.3f s, %d requests"
        % (setup_s, window_s, len(reqs)))
    if prof is not None:
        prof.stop()
    spans = tracer.events() if tracer is not None else []
    if trace:
        port_tracer.disable()
    stats = _delta(engine.stats.as_dict(), stats0)
    launches = _delta(ops.launch_counts(), launches0)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    found = forbidden_modules()
    if found:
        raise SystemExit("forbidden modules loaded after the window: %s"
                         % ", ".join(found))

    # ---- the device trace
    dtrace = None
    if prof is not None:
        dtrace = _reduce_trace(prof, wall0, perf0, wall1, spans,
                               tracer_zero, rec.spans, log)
        del prof

    # ---- the check, with the program's state freed
    answers = {}
    sample = check.draw_sample(reqs, st["buckets"], seed)
    for i, j in sample:
        answers[(i, j)] = reqs[i].shares[j]
    del engine, st
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    cons = spec.construction(cfg["construction"])
    t_ref = time.perf_counter()
    numbers = check.compare(reqs, sample, answers, pool, table, cons,
                            spec.cipher(cfg["prf"]))
    log("pirbench: reference check of %d sampled answers %.3f s"
        % (len(sample), time.perf_counter() - t_ref))

    # ---- metrics
    answered = [r for r in reqs if r.shares is not None]
    work = spec.work(cfg["work"]).work(
        n, e, sum(r.keys for r in answered), len(answered))
    view = RunView(cell=cell, requests=reqs, window_s=window_s,
                   setup_s=setup_s, stats=stats, launches=launches,
                   trace=dtrace, least_s=least_seconds(work))
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        value = spec.reader(m["name"]).read(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": (torch.cuda.get_device_name() if cuda
                         else "cpu"),
                "count": int(cell["entry"]["chips"]),
                "memory_peak_bytes": peak}
    if dtrace is not None:
        dev_info["busy_s"] = dtrace["busy_s"]
        dev_info["window_s"] = dtrace["window_s"]
    out = {"correct": check.verdict(numbers),
           "attempted": len(reqs),
           "failed": sum(1 for r in reqs if r.error is not None),
           "metrics": metrics, "device": dev_info}
    if dtrace is not None:
        out["breakdown"] = {"device_ops": dtrace["device_ops"],
                            "idle_gaps": dtrace["idle_gaps"]}
    out["checks"] = check.listing(numbers)
    return out


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(t_start: float, argv=None) -> int:
    args = parse(argv)
    bench = spec.load_benchmark()
    cell = spec.load_cell(bench, args.workload)
    os.environ["DPF_TPU_TORCH_TUNE_CACHE"] = "off"
    import torch
    need = int(cell["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print("pirbench: cell %s needs %d CUDA device(s); found %s"
              % (args.workload, need,
                 torch.cuda.device_count() if torch.cuda.is_available()
                 else "none"), file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   t_start=t_start)
    smi = _power_limit()
    if smi:
        print("card: %s" % smi, file=sys.stderr)
    for k, v in out["checks"].items():
        print("check %s %s limit %s" % (k, v["value"], v["limit"]),
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0
