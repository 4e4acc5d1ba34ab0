"""Spans and device times inside the serving engine and the construction
route: ``route.*`` spans nested in ``dispatch`` (the key upload and the
sqrt-N grid among them), the window wait apart from result waits, one
``req`` a request, the key bytes each upload names, and timing events
only while a tracer is installed.  The CPU cases run the plain
kernels; the ``chip`` case needs a CUDA card and skips without one.
This file imports no JAX, so on a machine with a card it runs on its own:
``python -m pytest --noconftest tests/test_torch_engine_trace.py``."""

import numpy as np
import pytest
import torch

from dpf_tpu_torch import DPF, EvalConfig
from dpf_tpu_torch.core import expand, sqrtn
from dpf_tpu_torch.obs import tracer as obs_tracer
from dpf_tpu_torch.serve import engine as engine_mod

N = 256
ENGINE_SPANS = {"submit", "admit", "pack", "dispatch", "wait",
                "window_wait", "decode"}


@pytest.fixture
def traced(monkeypatch):
    """A fresh process tracer, removed after the test."""
    t = obs_tracer.Tracer(capacity=1 << 14)
    monkeypatch.setattr(obs_tracer, "_TRACER", t)
    return t


def _server(config, n=N, device="cpu"):
    d = DPF(config=config, device=device)
    d.eval_init(np.random.default_rng(5).integers(
        -2 ** 31, 2 ** 31, (n, 7), dtype=np.int64).astype(np.int32))
    keys = d.gen_batch([(i * 97) % n for i in range(24)], n,
                       seeds=[b"trace-%d" % i for i in range(24)])[0]
    return d, keys


def _by_id(events):
    return {e["span_id"]: e for e in events}


def _parent(e, ids):
    return ids.get(e["parent_id"])


def _serve(engine, keys, sizes):
    futs = [engine.submit(keys[:b]) for b in sizes]
    engine.drain()
    return futs


# ----------------------------------------------------- route spans

@pytest.mark.parametrize("config, top, groups, group_levels", [
    # f = 256 / 32 = 8 frontier nodes, 3 levels above them, 2 a group
    (EvalConfig(prf_method=3, kernel_impl="dispatch", chunk_leaves=32,
                dispatch_group=2), 1, 4, 5),
    # f = 4, choose_group(4, 64) = 4: one group of 6 levels
    (EvalConfig(prf_method=3, kernel_impl="fused", chunk_leaves=64), 1, 1,
     6),
    (EvalConfig(prf_method=0, kernel_impl="fused", chunk_leaves=64), 1, 1,
     6),
    # K2 from the root: its contraction alone
    (EvalConfig(prf_method=2, kernel_impl="fused", chunk_leaves=64), 0, 0,
     None),
], ids=["aes-dispatch", "aes-fused", "dummy-fused", "chacha20-k2"])
def test_route_spans_nest_in_each_dispatch(traced, config, top, groups,
                                           group_levels):
    d, keys = _server(config)
    engine = d.serving_engine(buckets=(4, 8), max_in_flight=2)
    _serve(engine, keys, (3, 8, 11))          # 11 keys: two parts
    events = traced.events()
    ids = _by_id(events)
    dispatches = [e for e in events if e["name"] == "dispatch"]
    assert len(dispatches) == engine.stats.dispatches == 4
    uploads = [e for e in events if e["name"] == "route.key_upload"]
    assert sorted(_parent(e, ids)["span_id"] for e in uploads) == sorted(
        e["span_id"] for e in dispatches)
    route = [e for e in events if e["name"].startswith("route.")
             and e not in uploads]
    assert len(route) == len(dispatches) * (top + 2 * groups
                                            + (groups == 0))
    for disp in dispatches:
        kids = [e for e in route if e["parent_id"] == disp["span_id"]]
        names = [e["name"] for e in kids]
        assert names.count("route.top") == top
        assert names.count("route.group") == groups
        if groups == 0:
            assert names == ["route.contract"]
        starts = []
        for g in (e for e in kids if e["name"] == "route.group"):
            inner = [e for e in route if e["parent_id"] == g["span_id"]]
            assert [e["name"] for e in inner] == ["route.contract"]
            assert g["attrs"]["levels"] == group_levels
            starts.append(g["attrs"]["start"])
        assert starts == sorted(starts) and len(set(starts)) == groups
    for e in route:
        assert _parent(e, ids)["name"] in ("dispatch", "route.group")


def test_stream_route_spans_its_top_levels(traced):
    g = torch.Generator().manual_seed(3)

    def rnd(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=g,
                             dtype=torch.int64).to(torch.int32)

    cw1, cw2, last, table = rnd(2, 64, 4), rnd(2, 64, 4), rnd(2, 4), rnd(N, 3)
    kw = dict(depth=8, prf_method=2, chunk_leaves=64)
    with obs_tracer.span("outer"):
        fl2 = expand.expand_and_contract(cw1, cw2, last, table, f_levels=2,
                                         **kw)
    events = traced.events()
    assert [(e["name"], e.get("attrs")) for e in events] == [
        ("route.top", {"levels": 2}), ("route.contract", None),
        ("outer", None)]
    ids = _by_id(events)
    assert {_parent(e, ids)["name"] for e in events[:2]} == {"outer"}
    assert torch.equal(fl2, expand.expand_and_contract(cw1, cw2, last,
                                                       table, **kw))


# ------------------------------------ the key upload and the sqrt-N grid

def _sqrt_server(prf_method=2, n=N, device="cpu"):
    d = DPF(prf=prf_method, scheme="sqrtn", device=device)
    d.eval_init(np.random.default_rng(6).integers(
        -2 ** 31, 2 ** 31, (n, 5), dtype=np.int64).astype(np.int32))
    keys = d.gen_batch([(i * 37) % n for i in range(24)], n,
                       seeds=[b"sqrt-%d" % i for i in range(24)])[0]
    return d, keys


def test_sqrt_grid_span_nests_in_each_dispatch(traced):
    d, keys = _sqrt_server()
    engine = d.serving_engine(buckets=(4, 8), max_in_flight=2)
    futs = _serve(engine, keys, (3, 8, 11))
    for f, b in zip(futs, (3, 8, 11)):
        assert np.array_equal(f.result(), d.eval_cpu(keys[:b]).numpy())
    events = traced.events()
    ids = _by_id(events)
    dispatches = [e for e in events if e["name"] == "dispatch"]
    assert len(dispatches) == engine.stats.dispatches == 4
    _, r = sqrtn.default_split(N)
    for disp in dispatches:
        kids = [e for e in events if e["parent_id"] == disp["span_id"]]
        assert [e["name"] for e in kids] == ["route.key_upload",
                                             "route.sqrt_grid"]
        grid = kids[1]["attrs"]
        assert grid["keys"] == disp["attrs"]["bucket"]
        assert grid["rows"] == r
        assert r % grid["row_chunk"] == 0
    grids = [e for e in events if e["name"] == "route.sqrt_grid"]
    assert all(_parent(e, ids)["name"] == "dispatch" for e in grids)


@pytest.mark.parametrize("scheme", ["logn", "sqrtn"])
def test_key_bytes_are_the_staged_rows(traced, scheme):
    """A log-N part uploads its padded rows (cw1, cw2 and the start seed:
    2,064 bytes a row); a sqrt-N part its real keys' seeds and codewords
    (the wire less its 64-byte header: 49,152 bytes a key at 2^20) and
    pads on the device."""
    if scheme == "logn":
        d, keys = _server(EvalConfig(prf_method=2))
        per_row = 4 * (2 * 64 * 4 + 4)
    else:
        d, keys = _sqrt_server()
        k, r = sqrtn.default_split(N)
        per_row = 16 * (k + 2 * r)
        assert keys.shape[1] * 4 == per_row + 64
        k20, r20 = sqrtn.default_split(1 << 20)
        assert 16 * (k20 + 2 * r20) == 49152
    engine = d.serving_engine(buckets=(4, 8), max_in_flight=2)
    _serve(engine, keys, (3, 8, 11))        # parts of 3, 8, 8 and 3 keys
    st = engine.stats
    rows = (st.queries_submitted + st.padded_queries if scheme == "logn"
            else st.queries_submitted)
    uploads = [e for e in traced.events() if e["name"] == "route.key_upload"]
    assert len(uploads) == st.dispatches == 4
    assert sum(e["attrs"]["bytes"] for e in uploads) == rows * per_row


# ------------------------------------------- window wait and req ids

def test_window_wait_only_under_submit(traced):
    d, keys = _server(EvalConfig(prf_method=0))
    engine = d.serving_engine(buckets=(4,), max_in_flight=1)
    futs = _serve(engine, keys, (4, 4, 4, 4, 4))
    assert all(f.done() for f in futs)
    events = traced.events()
    ids = _by_id(events)
    window = [e for e in events if e["name"] == "window_wait"]
    waits = [e for e in events if e["name"] == "wait"]
    assert len(window) == 4 and len(waits) == 1   # drain took the last
    for e in window:
        sub = _parent(e, ids)
        assert sub["name"] == "submit"
        # the part waited for is the previous request's
        assert e["attrs"]["req"] == sub["attrs"]["req"] - 1
    assert all(e["parent_id"] is None for e in waits)
    st = engine.stats
    assert 0 < st.window_wait_time_s <= st.wait_time_s
    assert st.device_time_s == 0          # a CPU server has no events


def test_every_span_of_a_request_carries_its_req(traced):
    d, keys = _server(EvalConfig(prf_method=0, kernel_impl="dispatch",
                                 chunk_leaves=32, dispatch_group=2))
    engine = d.serving_engine(buckets=(4, 8), max_in_flight=2)
    _serve(engine, keys, (2, 8, 11, 5))
    events = traced.events()
    ids = _by_id(events)
    mine = [e for e in events if e["name"] in ENGINE_SPANS]
    assert all("req" in e["attrs"] for e in mine)
    reqs = sorted({e["attrs"]["req"] for e in mine})
    assert reqs == [0, 1, 2, 3]
    parts = {0: 1, 1: 1, 2: 2, 3: 1}
    for r in reqs:
        spans = [e for e in mine if e["attrs"]["req"] == r]
        names = [e["name"] for e in spans]
        assert names.count("submit") == names.count("decode") == 1
        assert names.count("dispatch") == parts[r]
        assert names.count("wait") + names.count("window_wait") == parts[r]
        sub = next(e for e in spans if e["name"] == "submit")
        for e in spans:
            if e["name"] in ("admit", "pack", "dispatch"):
                assert _parent(e, ids) is sub
    for e in events:
        if e["name"].startswith("route."):
            up = e
            while up["name"] != "dispatch":
                up = _parent(up, ids)
            assert up["attrs"]["req"] in reqs


# ------------------------------------- timing events (fake CUDA flag)

class _StubEvent:
    """Stands in for ``torch.cuda.Event`` on an engine told it serves a
    card; every construction and every record is kept."""
    made = recorded = None
    elapsed_ms = 2.5

    def __init__(self, enable_timing=False):
        self.timing = enable_timing
        _StubEvent.made.append(self)

    def record(self):
        _StubEvent.recorded.append(self)

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        assert self.timing and end.timing
        return self.elapsed_ms


@pytest.fixture
def fake_card(monkeypatch):
    """Engines on a CPU server whose CUDA flag is set: the engine's event
    and pinned-buffer calls go to stubs."""
    _StubEvent.made, _StubEvent.recorded = [], []
    monkeypatch.setattr(torch.cuda, "Event", _StubEvent)
    empty = torch.empty

    def unpinned(*a, pin_memory=False, **kw):
        return empty(*a, **kw)

    monkeypatch.setattr(torch, "empty", unpinned)

    def make(max_in_flight=2):
        d, keys = _server(EvalConfig(prf_method=0))
        engine = d.serving_engine(buckets=(4, 8),
                                  max_in_flight=max_in_flight)
        engine._cuda = True
        return engine, keys
    return make


def test_untraced_engine_makes_no_timing_event(fake_card, monkeypatch):
    monkeypatch.setattr(obs_tracer, "_TRACER", None)
    got = []

    def spy(name, **attrs):
        got.append(obs_tracer.span(name, **attrs))
        return got[-1]

    monkeypatch.setattr(engine_mod, "span", spy)
    monkeypatch.setattr(expand, "span", spy)
    engine, keys = fake_card()
    _serve(engine, keys, (3, 8, 11, 4))
    assert len(_StubEvent.made) == engine.stats.dispatches == 5
    assert not any(ev.timing for ev in _StubEvent.made)
    assert got and all(s is obs_tracer.NULL_SPAN for s in got)
    assert engine.stats.device_time_s == 0


@pytest.mark.parametrize("every", [1, 2, 8])
def test_traced_engine_times_one_part_of_a_bucket_in_k(fake_card, traced,
                                                       monkeypatch, every):
    monkeypatch.setattr(engine_mod, "TIME_EVERY", every)
    engine, keys = fake_card(max_in_flight=1)
    _serve(engine, keys, [1 + (i * 5) % 12 for i in range(30)])
    parts = engine.stats.dispatches
    waited = [e for e in traced.events()
              if e["name"] in ("wait", "window_wait")]
    assert len(waited) == parts == 40          # 9-12 keys: two parts
    timed = [e for e in waited if "device_ms" in e["attrs"]]
    assert all(e["attrs"]["device_ms"] == _StubEvent.elapsed_ms
               for e in timed)
    for b in (4, 8):
        n_b = sum(e["attrs"]["bucket"] == b for e in waited)
        t_b = sum(e["attrs"]["bucket"] == b for e in timed)
        assert n_b // every <= t_b <= -(-n_b // every)
    st = engine.stats
    assert st.timed_parts == len(timed) >= 2
    assert st.device_time_s == pytest.approx(
        len(timed) * _StubEvent.elapsed_ms / 1e3)
    # a timed part records two events, any other part one
    assert len(_StubEvent.recorded) == parts + len(timed)
    timing = [ev for ev in _StubEvent.made if ev.timing]
    assert len(_StubEvent.made) - len(timing) == parts - len(timed)
    # a window of one: a timed part's two events come back before the
    # next part is launched
    assert len(timing) == 2


# ---------------------------------------------------------- the card

@pytest.fixture
def chip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.chip
def test_device_time_on_the_card(chip, traced, monkeypatch):
    monkeypatch.setattr(engine_mod, "TIME_EVERY", 1)
    d, keys = _server(EvalConfig(prf_method=3), n=1 << 12, device="cuda")
    engine = d.serving_engine(buckets=(8, 16), max_in_flight=2)
    futs = _serve(engine, keys, (5, 16, 20, 7, 16))
    for f, b in zip(futs, (5, 16, 20, 7, 16)):
        assert np.array_equal(f.result(), d.eval_gpu(keys[:b]).cpu().numpy())
    assert engine.stats.device_time_s > 0
    assert engine.stats.timed_parts == engine.stats.dispatches
    waited = [e for e in traced.events()
              if e["name"] in ("wait", "window_wait")]
    assert len(waited) == engine.stats.dispatches == 6
    assert all(e["attrs"]["device_ms"] >= 0 for e in waited)
    assert any(e["name"].startswith("route.") for e in traced.events())


@pytest.mark.chip
def test_sqrt_keys_upload_beside_the_grid_on_the_card(chip):
    """A sqrt-N part's keys go to the card on a side stream while the
    grid of the part before them runs; with the window full and each
    part's keys different, every answer is still the one-shot path's."""
    from dpf_tpu_torch import api
    d, keys = _sqrt_server(n=1 << 12, device="cuda")
    keys = np.asarray(keys)
    engine = d.serving_engine(buckets=(8, 16), max_in_flight=2)
    batches = [np.roll(keys, 5 * i, axis=0)[:b]
               for i, b in enumerate((16, 16, 5, 16, 20, 16, 7, 16, 16))]
    futs = [engine.submit(b) for b in batches]
    for f, b in zip(futs, batches):
        assert np.array_equal(f.result(), d.eval_gpu(b).cpu().numpy())
    assert api._COPY_STREAMS
