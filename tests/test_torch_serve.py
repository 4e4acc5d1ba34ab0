"""The port's serving path against dpf_tpu's, on the CPU.

``Buckets`` and the ``loadgen`` traces equal the JAX package's; the
per-level dispatch modes (``eval_dispatch``, ``eval_dispatch_mixed``)
give dpf_tpu's shares for PRF ids 0-5 at odd and even depth and several
group sizes; the ``ServingEngine`` answers as dpf_tpu's engine and the
blocking loop do in the three constructions, with ragged and multi-part
batches; and backpressure, shedding, deadlines (the engine's and the
dispatch mode's) and ``EngineClosed`` behave as ``tests/test_serve.py``
has them.  Shares are integers mod 2^32: every comparison is exact.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import dpf_tpu
from dpf_tpu.core import expand as jexpand
from dpf_tpu.core import keygen as jkeygen
from dpf_tpu.serve import Buckets as JBuckets
from dpf_tpu.serve import loadgen as jloadgen
from dpf_tpu.utils.config import EvalConfig as JEvalConfig
from dpf_tpu_torch import DPF, EvalConfig
from dpf_tpu_torch.core import expand, radix4
from dpf_tpu_torch.core.expand import DeadlineExceeded
from dpf_tpu_torch.core.u32 import from_u32
from dpf_tpu_torch.serve import (Buckets, EngineClosed, LoadShed,
                                 ServingEngine, loadgen)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _table(n, e=7, seed=5):
    return np.random.default_rng(seed).integers(
        -2 ** 31, 2 ** 31, (n, e), dtype=np.int64).astype(np.int32)


def _server(n=256, prf=None, config=None, scheme=None, e=7):
    if prf is None and config is None:
        prf = 0
    d = DPF(prf=prf, config=config, scheme=scheme, device="cpu")
    d.eval_init(_table(n, e))
    keys = d.gen_batch([(i * 97) % n for i in range(20)], n,
                       seeds=[b"serve-%d" % i for i in range(20)])[0]
    return d, keys


def _rows(keys, j, b):
    return keys[[(j + i) % len(keys) for i in range(b)]]


# ---------------------------------------------------- buckets and traces

@pytest.mark.parametrize("sizes", [(16, 4), (1,), (2, 8, 64, 512), (128,)])
def test_buckets_equal_dpf_tpu(sizes):
    ours, theirs = Buckets(sizes), JBuckets(sizes)
    assert ours.sizes == theirs.sizes and ours.max == theirs.max
    for b in range(1, 2 * ours.max + 3):
        assert ours.chunks(b) == theirs.chunks(b)
        if b <= ours.max:
            assert ours.bucket_for(b) == theirs.bucket_for(b)
    for cap, fanout, count in ((512, 2, 4), (512, 4, 4), (8, 2, 4),
                               (500, 2, 4), (1, 2, 4), (64, 2, 2)):
        assert (Buckets.default_sizes(cap, fanout, count)
                == JBuckets.default_sizes(cap, fanout, count))
    for bad in ((3,), (), (0,)):
        with pytest.raises(ValueError):
            Buckets(bad)
    with pytest.raises(ValueError):
        ours.bucket_for(ours.max + 1)


TRACES = {
    "poisson": dict(rate=25.0, duration_s=3.0, cap=64, seed=3),
    "bursty": dict(on_rate=30.0, off_rate=1.0, on_s=0.5, off_s=1.0,
                   duration_s=4.0, cap=64, seed=9),
    "diurnal": dict(base_rate=3.0, peak_rate=30.0, period_s=2.0,
                    duration_s=4.0, cap=64, seed=5),
    "replay": dict(sizes=[1, 64, 7, 32], rate=10.0),
}


@pytest.mark.parametrize("kind", sorted(TRACES))
@pytest.mark.parametrize("seed", [0, 17])
def test_traces_equal_dpf_tpu(kind, seed):
    kw = dict(TRACES[kind])
    if "seed" in kw:
        kw["seed"] = seed
    ours = [dataclasses.astuple(a) for a in loadgen.make_trace(kind, **kw)]
    theirs = [dataclasses.astuple(a)
              for a in jloadgen.make_trace(kind, **kw)]
    assert ours == theirs and len(ours) >= 4
    if kind != "replay":
        assert ([dataclasses.astuple(a)
                 for a in loadgen.default_trace(kind, 32, seed=seed)]
                == [dataclasses.astuple(a)
                    for a in jloadgen.default_trace(kind, 32, seed=seed)])
    squeezed = loadgen.squeeze(loadgen.make_trace(kind, **kw), 4.0)
    assert ([dataclasses.astuple(a) for a in squeezed]
            == [dataclasses.astuple(a) for a in jloadgen.squeeze(
                jloadgen.make_trace(kind, **kw), 4.0)])
    assert loadgen.batch_sizes(squeezed) == [a.batch for a in squeezed]


# ------------------------------------------------------- dispatch modes

@pytest.mark.parametrize("prf", range(6))
@pytest.mark.parametrize("n", [128, 256])
def test_eval_dispatch_equals_dpf_tpu(prf, n):
    """Binary tree: the per-level mode at several groups (1, 2, a value
    that does not divide the frontier, auto) equals dpf_tpu's CPU shares
    and the port's fused path."""
    table = _table(n, 5, seed=prf)
    theirs = dpf_tpu.DPF(prf=prf)
    theirs.eval_init(table)
    flat = [jkeygen.generate_keys(i, n, b"disp-%d" % i, prf)[0]
            for i in (3, n // 2 + 1, n - 1)]
    want = np.asarray(theirs.eval_cpu([k.serialize() for k in flat]))
    cw1, cw2, last = (from_u32(a) for a in jexpand.pack_keys(flat))
    tperm = torch.from_numpy(expand.permute_table(table))
    depth = n.bit_length() - 1
    fused = expand.expand_and_contract(cw1, cw2, last, tperm, depth=depth,
                                       prf_method=prf, chunk_leaves=16)
    assert (fused.numpy() == want).all()
    for chunk, group in ((16, 1), (16, 2), (32, 3), (n, None), (1, 5)):
        got = expand.eval_dispatch(cw1, cw2, last, tperm, depth=depth,
                                   prf_method=prf, chunk_leaves=chunk,
                                   group=group)
        assert (got.numpy() == want).all(), (chunk, group)


@pytest.mark.parametrize("prf", range(6))
@pytest.mark.parametrize("n", [128, 256])
def test_eval_dispatch_mixed_equals_dpf_tpu(prf, n):
    """Radix-4 tree at odd (2^7: a binary base level) and even depth."""
    table = _table(n, 5, seed=prf)
    theirs = dpf_tpu.DPF(config=JEvalConfig(prf_method=prf, radix=4))
    theirs.eval_init(table)
    ours = DPF(config=EvalConfig(prf_method=prf, radix=4), device="cpu")
    keys = ours.gen_batch([1, n // 3, n - 2], n,
                          seeds=[b"m%d" % i for i in range(3)])[0]
    want = np.asarray(theirs.eval_cpu([k.numpy() for k in keys]))
    pk = radix4.decode_mixed_keys_batched(keys)
    cw1, cw2, last = (from_u32(a) for a in (pk.cw1, pk.cw2, pk.last))
    perm = radix4.mixed_reverse_indices(radix4.arities(n))
    tperm = torch.from_numpy(np.ascontiguousarray(table[perm]))
    for chunk, group in ((16, 1), (64, 3), (None, None), (8, 2)):
        got = radix4.eval_dispatch_mixed(cw1, cw2, last, tperm, n=n,
                                         prf_method=prf, chunk_leaves=chunk,
                                         group=group)
        assert (got.numpy() == want).all(), (chunk, group)


def test_eval_dispatch_equals_jax_eval_dispatch():
    """Against dpf_tpu's own per-level function, group by group."""
    n, depth, prf = 256, 8, 2
    flat = [jkeygen.generate_keys(33, n, b"disp", prf)[0],
            jkeygen.generate_keys(200, n, b"disp2", prf)[1]]
    packed = jexpand.pack_keys(flat)
    table = _table(n, 4)
    tperm = jexpand.permute_table(table)
    for g in (1, 4, 8):
        want = np.asarray(jexpand.eval_dispatch(
            *packed, tperm, depth=depth, prf_method=prf, chunk_leaves=32,
            group=g))
        got = expand.eval_dispatch(*(from_u32(a) for a in packed),
                                   torch.from_numpy(tperm), depth=depth,
                                   prf_method=prf, chunk_leaves=32, group=g)
        assert (got.numpy() == want).all(), g


@pytest.mark.parametrize("radix", [2, 4])
def test_dispatch_config_and_deadline(radix):
    """``kernel_impl="dispatch"`` through the API: the knobs report it,
    shares equal the fused server's, a bad group raises, and a past
    ``dispatch_deadline`` raises DeadlineExceeded before any launch."""
    n = 512
    fused, keys = _server(n, 2, EvalConfig(prf_method=2, radix=radix))
    cfg = EvalConfig(prf_method=2, radix=radix, kernel_impl="dispatch",
                     dispatch_group=4)
    d = DPF(config=cfg, device="cpu")
    d.eval_init(fused.table)
    kn = d.resolved_eval_knobs(4)
    assert kn["kernel_impl"] == "dispatch" and kn["dispatch_group"] == 4
    assert kn["kernel_resolved_from"] == "config"
    assert fused.resolved_eval_knobs(4)["kernel_impl"] == "fused"
    assert torch.equal(d.eval_gpu(keys[:5]), fused.eval_gpu(keys[:5]))
    d.dispatch_deadline = time.monotonic() - 1
    with pytest.raises(DeadlineExceeded):
        d.eval_gpu(keys[:2])
    d.dispatch_deadline = time.monotonic() + 3600
    assert torch.equal(d.eval_gpu(keys[:2]), fused.eval_gpu(keys[:2]))
    bad = DPF(config=EvalConfig(prf_method=2, radix=radix,
                                kernel_impl="dispatch", dispatch_group=-1),
              device="cpu")
    bad.eval_init(fused.table)
    with pytest.raises(ValueError, match="dispatch group"):
        bad.eval_gpu(keys[:1])
    with pytest.raises(ValueError, match="kernel_impl"):
        EvalConfig(kernel_impl="triton")


# --------------------------------------------- engine == dpf_tpu engine

@pytest.mark.parametrize("cfg", [
    dict(prf=0), dict(config=EvalConfig(prf_method=0, radix=4)),
    dict(prf=0, scheme="sqrtn")], ids=["binary", "radix4", "sqrtn"])
def test_engine_equals_dpf_tpu_engine(cfg):
    """Ragged and multi-part batches (buckets 4 and 8) through both
    packages' engines on the same table and keys."""
    n = 256
    ours, keys = _server(n, **cfg)
    jcfg = (dict(config=JEvalConfig(prf_method=0, radix=4))
            if "config" in cfg else dict(cfg))
    theirs = dpf_tpu.DPF(**jcfg)
    theirs.eval_init(ours.table)
    sizes = (8, 3, 17, 1, 8)
    mine = ours.serving_engine(buckets=(4, 8), max_in_flight=2,
                               warmup=True)
    jeng = theirs.serving_engine(buckets=(4, 8), max_in_flight=2)
    batches = [_rows(keys, j, b) for j, b in enumerate(sizes)]
    futs = [mine.submit(b) for b in batches]
    jfuts = [jeng.submit([k.numpy() for k in b]) for b in batches]
    for b, f, jf in zip(batches, futs, jfuts):
        assert np.array_equal(f.result(), jf.result())
        assert np.array_equal(f.result(), ours.eval_gpu(b).numpy())
    assert mine.stats.dispatches == jeng.stats.dispatches == 7
    assert mine.stats.padded_queries == jeng.stats.padded_queries
    assert mine.stats.batches_submitted == 5


@pytest.mark.parametrize("prf", range(6))
@pytest.mark.parametrize("construction", ["binary", "radix4", "sqrtn"])
def test_engine_equals_dpf_tpu_shares(prf, construction):
    """Every PRF id in the three constructions: the engine's rows equal
    dpf_tpu's CPU shares, and two servers' engines recover the rows."""
    n = 256
    cfg = dict(config=EvalConfig(prf_method=prf,
                                 radix=4 if construction == "radix4" else 2,
                                 scheme="sqrtn" if construction == "sqrtn"
                                 else "logn"))
    ours, _ = _server(n, **cfg)
    idx = [0, 5, 77, n - 1, 128, 9]
    ka, kb = ours.gen_batch(idx, n, seeds=[b"e%d" % i for i in idx])
    jcfg = JEvalConfig(prf_method=prf,
                              radix=4 if construction == "radix4" else 2)
    theirs = dpf_tpu.DPF(config=jcfg, scheme="sqrtn"
                         if construction == "sqrtn" else None)
    theirs.eval_init(ours.table)
    ea = ours.serving_engine(buckets=(2, 4), max_in_flight=1)
    eb = ours.serving_engine(buckets=(2, 4), max_in_flight=3)
    fa, fb = ea.submit(ka), eb.submit(kb)
    want = np.asarray(theirs.eval_cpu([k.numpy() for k in ka]))
    assert np.array_equal(fa.result(), want)
    rec = (fa.result().view(np.uint32) - fb.result().view(np.uint32))
    assert (rec.view(np.int32) == ours.table[idx]).all()


# ------------------------------------------ window, admission, deadline

def test_window_backpressure_and_fifo():
    d, keys = _server()
    engine = d.serving_engine(buckets=(4,), max_in_flight=2)
    stream = [_rows(keys, j, 4) for j in range(6)]
    futs = [engine.submit(b) for b in stream]
    assert engine.in_flight <= 2 and engine.stats.in_flight_hwm == 2
    engine.drain()
    assert engine.in_flight == 0 and all(f.done() for f in futs)
    for b, f in zip(stream, futs):
        assert np.array_equal(f.result(), d.eval_gpu(b).numpy())
    one = d.serving_engine(buckets=(4,), max_in_flight=1)
    f1 = one.submit(stream[0])
    f2 = one.submit(stream[1])
    assert one.in_flight == 1 and one.stats.in_flight_hwm == 1
    f2.result()
    assert f1.done()
    with pytest.raises(RuntimeError, match="does not belong"):
        engine._resolve_through(one.submit(stream[2]))


def _trip_after_first_dispatch(d, engine):
    real = d._dispatch_packed

    def slow(pk):
        out = real(pk)
        engine.deadline = time.monotonic() - 1
        return out
    d._dispatch_packed = slow
    return real


@pytest.mark.parametrize("window", [1, 8])
def test_deadline_mid_batch_unwinds(window):
    """A deadline passing between the parts of a two-part submit (in the
    dispatch loop, or with a window of 1 in the backpressure wait)
    leaves the window, the pending queue and the counters consistent;
    the next submit answers exactly."""
    d, keys = _server()
    engine = d.serving_engine(buckets=(4,), max_in_flight=window)
    real = _trip_after_first_dispatch(d, engine)
    try:
        with pytest.raises(DeadlineExceeded):
            engine.submit(_rows(keys, 0, 8))
    finally:
        d._dispatch_packed = real
    assert engine.in_flight == 0 and not engine._pending
    assert engine.stats.deadline_misses == 1
    assert engine.stats.batches_submitted == 0
    assert engine.stats.dispatches == 1
    engine.deadline = None
    b = _rows(keys, 1, 4)
    assert np.array_equal(engine.submit(b).result(), d.eval_gpu(b).numpy())


def test_dispatch_mode_deadline_through_the_engine():
    """The server's dispatch-mode deadline trips inside a part: counted
    as a deadline miss, the batch's earlier part unwound."""
    n = 256
    d = DPF(config=EvalConfig(prf_method=3, kernel_impl="dispatch"),
            device="cpu")
    d.eval_init(_table(n))
    keys = d.gen_batch(list(range(8)), n)[0]
    engine = d.serving_engine(buckets=(4,), max_in_flight=4)
    real = d._dispatch_packed
    calls = []

    def second_late(pk):
        calls.append(1)
        if len(calls) == 2:
            d.dispatch_deadline = time.monotonic() - 1
        return real(pk)
    d._dispatch_packed = second_late
    try:
        with pytest.raises(DeadlineExceeded):
            engine.submit(keys)
    finally:
        d._dispatch_packed = real
    assert engine.in_flight == 0 and not engine._pending
    assert engine.stats.deadline_misses == 1
    d.dispatch_deadline = None
    assert np.array_equal(engine.submit(keys).result(),
                          d.eval_gpu(keys).numpy())


def test_engine_deadline_and_timeout():
    d, keys = _server()
    engine = d.serving_engine(buckets=(4,))
    engine.deadline = time.monotonic() - 1
    with pytest.raises(DeadlineExceeded):
        engine.submit(_rows(keys, 0, 4))
    assert engine.stats.deadline_misses == 1
    engine.deadline = None
    assert engine.submit(_rows(keys, 0, 4)).result().shape == (4, 7)
    with pytest.raises(DeadlineExceeded):
        d.serving_engine(buckets=(4,), timeout_s=-1.0).submit(
            _rows(keys, 0, 4))
    with pytest.raises(ValueError, match="not both"):
        d.serving_engine(deadline=time.monotonic() + 1, timeout_s=1.0)
    with pytest.raises(ValueError):
        d.serving_engine(max_in_flight=0)


def test_failed_mid_submit_leaves_engine_consistent():
    d, keys = _server()
    engine = d.serving_engine(buckets=(4,), max_in_flight=8)
    real = d._dispatch_packed
    calls = []

    def flaky(pk):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected dispatch failure")
        return real(pk)
    d._dispatch_packed = flaky
    try:
        with pytest.raises(RuntimeError, match="injected"):
            engine.submit(_rows(keys, 0, 8))
    finally:
        d._dispatch_packed = real
    assert engine.in_flight == 0 and engine.stats.batches_submitted == 0
    b = _rows(keys, 2, 4)
    assert np.array_equal(engine.submit(b).result(), d.eval_gpu(b).numpy())


def test_admission_shed_and_depth():
    d, keys = _server()
    b = _rows(keys, 0, 4)
    engine = d.serving_engine(buckets=(4,), max_in_flight=8,
                              max_queue_depth=1, shed=True)
    f1 = engine.submit(b)
    with pytest.raises(LoadShed):
        engine.submit(b)
    assert (engine.stats.shed_batches, engine.stats.shed_queries) == (1, 4)
    assert np.array_equal(f1.result(), d.eval_gpu(b).numpy())
    assert engine.submit(b).result() is not None
    blocking = d.serving_engine(buckets=(4,), max_in_flight=8,
                                max_queue_depth=2)
    futs = [blocking.submit(b) for _ in range(5)]
    assert len(blocking._pending) <= 2
    blocking.drain()
    assert all(f.done() for f in futs) and blocking.stats.shed_batches == 0
    slo = d.serving_engine(buckets=(4,), max_in_flight=8, slo_s=1e-9,
                           shed=True)
    slo.stats.note_latency(1.0)
    f1 = slo.submit(b)                   # an idle engine admits
    with pytest.raises(LoadShed):
        slo.submit(b)                    # a backlog with p99 over the SLO
    f1.result()
    slo.drain()
    assert slo.submit(b).result() is not None


def test_close_latency_pad_and_warmup():
    d, keys = _server()
    engine = d.serving_engine(buckets=(4, 16), warmup=True)
    assert engine.stats.batches_submitted == engine.stats.dispatches == 0
    engine.submit(_rows(keys, 0, 1)).result()
    assert engine.stats.padded_queries == 3
    assert engine.stats.pad_waste == pytest.approx(0.75)
    for j in range(4):
        engine.submit(_rows(keys, j, 16)).result()
    assert engine.stats.padded_queries == 3
    lat = engine.stats.as_dict()["latency_ms"]
    assert lat["count"] == 5 and lat["p50"] <= lat["p99"]
    pending = engine.submit(_rows(keys, 0, 5))
    engine.close()
    assert pending.done() and engine.closed
    with pytest.raises(EngineClosed):
        engine.submit(_rows(keys, 0, 4))
    engine.close()                       # idempotent
    rc = engine.resolved_config()
    assert rc["buckets"] == [4, 16] and rc["kernel_impl"] == "fused"
    probe = d.serving_engine(buckets=(2, 4)).probe(reps=2)
    assert sorted(probe) == [2, 4] and all(v > 0 for v in probe.values())
    with pytest.raises(RuntimeError, match="eval_init"):
        ServingEngine(DPF(prf=0, device="cpu"))


def test_staged_layouts():
    """The staged buffers hold the packed batch in the device layout:
    log-N planes padded with the last key on the host, sqrt-N rows
    padded on the device."""
    d, keys = _server()
    pk = d._decode_batch(keys[:3])
    st = d._stage_packed(pk, 4)
    assert st.rows == 3 and st.size == 4 and not st.host.is_pinned()
    from dpf_tpu_torch.api import LOGN_KEY_WORDS, _logn_planes
    assert st.host.numel() == 4 * LOGN_KEY_WORDS
    cw1, cw2, last = _logn_planes(st.host.numpy().view(np.uint32), 4)
    assert (cw1[:3] == pk.cw1).all() and (cw1[3] == pk.cw1[2]).all()
    assert (last[:3] == pk.last).all() and (last[3] == pk.last[2]).all()
    with pytest.raises(ValueError, match="cannot stage"):
        d._stage_packed(pk, 2)
    s, skeys = _server(scheme="sqrtn")
    spk = s._decode_batch(skeys[:3])
    sst = s._stage_packed(spk, 8)
    k, r = spk.n_keys, spk.n_codewords
    assert tuple(sst.host.shape) == (3, 4 * (k + 2 * r))
    out = s._dispatch_packed(sst)
    assert out.shape[0] == 8
    assert np.array_equal(out[:3].numpy(), s.eval_gpu(skeys[:3]).numpy())
    assert np.array_equal(out[3].numpy(), out[2].numpy())


# ------------------------------------------------------- bench_serve

def test_bench_serve_records():
    """The codec microbenchmarks agree with the scalar codecs, the stream
    bench's three passes agree bit for bit, and the overlap bench gives
    the blocking loop and every window a row (no busy share off the
    card)."""
    from dpf_tpu_torch.serve import bench_serve
    for fn in (bench_serve.ingest_microbench,
               bench_serve.sqrt_ingest_microbench):
        r = fn(B=16, n=1024, distinct=4, reps=1)
        assert r["batch"] == 16 and r["scalar_s"] > 0 and r["batched_s"] > 0
    rec = bench_serve.stream_bench(n=256, batch=8, batches=4, ragged=True,
                                   device="cpu", quiet=True)
    assert rec["checked"] and rec["device"] == "cpu" and rec["value"] > 0
    assert rec["engine_stats"]["batches_submitted"] == 4
    d, keys = _server(prf=3)
    r = bench_serve.overlap_bench(d, [keys[:4], keys[4:8]], windows=(1, 2))
    assert set(r["modes"]) == {"blocking", "engine_1", "engine_2"}
    assert r["queries"] == 8 and "busy_share" not in r["modes"]["engine_2"]
    assert r["modes"]["engine_2"]["in_flight_hwm"] == 2
