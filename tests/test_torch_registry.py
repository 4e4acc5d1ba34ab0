"""The port's table registry and granule store against dpf_tpu's, on the
CPU.

The same register / acquire / release / demote script run on
``dpf_tpu.serve.registry.TableRegistry`` and on the port's gives equal
counters, resident bytes, table rows and registry flight events after
every step; the shares of leased servers equal ``dpf_tpu``'s
``eval_cpu`` exactly, before a demotion and after the re-promotion;
``GranuleStore`` and ``GranulePrefetcher`` follow the same counter
trajectories as ``dpf_tpu``'s and lease the same rows.  Shares are
integers mod 2^32: every comparison is exact.
"""

import warnings

import numpy as np
import pytest
import torch

from dpf_tpu.obs.flight import FLIGHT as JFLIGHT
from dpf_tpu.serve import registry as jregistry
from dpf_tpu.serve.router import build_servers as jbuild_servers
from dpf_tpu_torch.core import expand
from dpf_tpu_torch.obs.flight import FLIGHT
from dpf_tpu_torch.serve import registry
from dpf_tpu_torch.serve.router import LABELS
from dpf_tpu_torch.utils.profiling import swallowed_snapshot

N, ENTRY = 256, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _table(n=N, entry=ENTRY, seed=7):
    return np.random.default_rng(seed).integers(
        0, 2 ** 31, (n, entry), dtype=np.int32)


def _one(labels=1, n=N, entry=ENTRY):
    """Padded device bytes of one registered version."""
    return n * entry * 4 * labels


def _pair(**kw):
    """(dpf_tpu's registry, the port's) with the same arguments."""
    kw.setdefault("labels", ("logn",))
    return (jregistry.TableRegistry(**kw),
            registry.TableRegistry(device="cpu", **kw))


def _registry_events(flight) -> list:
    return [(e["action"], e.get("table"), e.get("version"),
             e.get("bytes"), e.get("pins"), e.get("resident_bytes"),
             e.get("need_bytes"))
            for e in flight.dump() if e.get("kind") == "registry"]


def _state(reg) -> tuple:
    st = reg.stats()
    return (st["counters"], st["resident_bytes"], st["tables"])


def _run(reg, script) -> list:
    """Run a residency script; returns the state after every step.  An
    op that raises records the exception's class."""
    held, states = {}, []
    for op, *args in script:
        try:
            if op == "register":
                name, seed, version = args
                reg.register(name, _table(seed=seed), version=version)
            elif op == "acquire":
                name, version, hold = args
                lease = reg.acquire(name, version=version)
                if hold is None:
                    lease.release()
                else:
                    held[hold] = lease
            elif op == "release":
                held[args[0]].release()
            elif op == "demote":
                name, version = args
                states.append(("demoted", reg.demote(name, version)))
            else:
                raise AssertionError(op)
        except (KeyError, ValueError) as e:
            states.append(("raised", type(e).__name__))
        states.append(_state(reg))
    return states


SCRIPTS = {
    "budget_across_versions": (2 * _one(), [
        ("register", "t", 1, None), ("register", "t", 2, None),
        ("register", "t", 3, None), ("acquire", "t", 1, None),
        ("acquire", "t", None, None)]),
    "lru_interleaved_tenants": (2 * _one(), [
        ("register", "a", 1, None), ("register", "b", 2, None),
        ("acquire", "b", None, None), ("acquire", "a", None, None),
        ("register", "c", 3, None), ("acquire", "b", None, None),
        ("acquire", "a", None, None)]),
    "pinned_under_pressure": (_one(), [
        ("register", "hot", 1, None), ("acquire", "hot", None, "h"),
        ("register", "cold", 2, None), ("demote", "hot", None),
        ("release", "h"), ("acquire", "hot", None, None)]),
    "nested_pins": (None, [
        ("register", "t", 1, None), ("acquire", "t", None, "l1"),
        ("acquire", "t", None, "l2"), ("demote", "t", None),
        ("release", "l1"), ("release", "l1"), ("release", "l2"),
        ("demote", "t", None)]),
    "versions_and_lookups": (None, [
        ("register", "t", 1, 3), ("register", "t", 2, 3),
        ("register", "t", 2, None), ("acquire", "nope", None, None),
        ("acquire", "t", 99, None), ("acquire", "t", 3, None)]),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_registry_script_matches_dpf_tpu(name):
    budget, script = SCRIPTS[name]
    jreg, reg = _pair(budget_bytes=budget)
    JFLIGHT.clear()
    FLIGHT.clear()
    want = _run(jreg, script)
    got = _run(reg, script)
    assert got == want
    assert _registry_events(FLIGHT) == _registry_events(JFLIGHT)
    assert reg.resident_bytes == jreg.resident_bytes
    assert repr(reg) == repr(jreg)


def test_three_construction_budget_matches_dpf_tpu():
    """Every construction's layout counts: three labels a version, a
    budget of one and a half versions."""
    one = _one(labels=len(LABELS))
    jreg, reg = _pair(budget_bytes=3 * one // 2, labels=LABELS)
    script = [("register", "a", 1, None), ("register", "b", 2, None),
              ("acquire", "a", None, "x"), ("register", "c", 3, None),
              ("release", "x"), ("acquire", "b", None, None)]
    assert _run(reg, script) == _run(jreg, script)
    assert all(r["bytes"] == one for r in reg.stats()["tables"])


def _numpy(keys):
    return [np.asarray(k) for k in keys.numpy()]


@pytest.mark.parametrize("prf", [0, 3])
def test_leased_shares_equal_dpf_tpu_eval_cpu_across_repromotion(prf):
    table = _table(seed=5)
    reg = registry.TableRegistry(labels=LABELS, device="cpu",
                                 prf_method=prf)
    reg.register("t", table)
    jservers = jbuild_servers(table, LABELS, prf_method=prf)
    idx = [(i * 37) % N for i in range(6)]
    keys, want = {}, {}
    with reg.acquire("t") as lease:
        for lb in LABELS:
            srv = lease.server(lb)
            assert srv.device.type == "cpu"
            keys[lb] = srv.gen_batch(
                idx, N, seeds=[b"reg-%s-%d" % (lb.encode(), i)
                               for i in range(len(idx))])[0]
            want[lb] = np.asarray(jservers[lb].eval_cpu(_numpy(keys[lb])))
            got = srv.eval_gpu(keys[lb]).numpy()
            assert np.array_equal(got, want[lb]), lb
    assert reg.demote("t") is True
    assert all(s.table_device is None
               for s in reg._get("t", None).servers.values())
    with reg.acquire("t") as lease:           # miss -> promote
        for lb in LABELS:
            got = lease.server(lb).eval_gpu(keys[lb]).numpy()
            assert np.array_equal(got, want[lb]), lb
    assert reg.counters["promotions"] == 1
    assert reg.counters["misses"] == 1


def test_pinned_version_serves_under_eviction_pressure():
    reg = registry.TableRegistry(_one(), labels=("logn",), device="cpu")
    table = _table(seed=1)
    reg.register("hot", table)
    with reg.acquire("hot") as lease:
        srv = lease.server("logn")
        keys = srv.gen_batch([3, 77, 200], N,
                             seeds=[b"p-%d" % i for i in range(3)])[0]
        reg.register("cold", _table(seed=2))  # overcommits
        assert reg.demote("hot") is False     # deferred
        assert srv.table_device is not None
        got = srv.eval_gpu(keys).numpy()
        assert np.array_equal(got, srv.eval_cpu(keys).numpy())
    assert srv.table_device is None           # the last release demoted
    assert reg.counters["overcommits"] == 1


# ----------------------------------------------------- granule store


def _granule_pair(n=1024, entry=8, granule=128, budget_granules=None,
                  seed=3):
    perm = expand.permute_table(_table(n, entry, seed))
    gb = granule * entry * 4
    budget = None if budget_granules is None else budget_granules * gb
    return (jregistry.GranuleStore(perm, granule, budget_bytes=budget),
            registry.GranuleStore(perm, granule, budget_bytes=budget,
                                  device="cpu"),
            perm)


def _granule_run(store, perm, script) -> list:
    held, out = {}, []
    g = store.granule
    for op, arg in script:
        if op == "lease":
            lease = store.lease(arg * g)
            assert np.array_equal(np.asarray(lease.table),
                                  perm[arg * g:(arg + 1) * g])
            held.setdefault(arg, []).append(lease)
            out.append(("lease", arg))
        elif op == "release":
            held[arg].pop().release()
        elif op == "prefetch":
            out.append(("prefetch",
                        store.prefetch(None if arg is None else arg * g)))
        elif op == "demote":
            out.append(("demote", store.demote(arg * g)))
        elif op == "demote_all":
            out.append(("demote_all", store.demote_all()))
        st = store.stats()
        out.append((dict(st["counters"]), st["granules_resident"],
                    st["resident_bytes"], store.resident_row0s(),
                    store.cold_row0s()))
    return out


GRANULE_SCRIPTS = {
    "lru_evicts": (2, [("lease", 0), ("release", 0), ("lease", 1),
                       ("release", 1), ("lease", 2), ("release", 2),
                       ("lease", 0), ("release", 0)]),
    "pinned_defers": (1, [("lease", 0), ("demote", 0), ("lease", 1),
                          ("release", 1), ("release", 0), ("lease", 3),
                          ("release", 3)]),
    "prefetch_never_evicts": (2, [("prefetch", 0), ("prefetch", 1),
                                  ("prefetch", 2), ("lease", 0),
                                  ("release", 0), ("lease", 2),
                                  ("release", 2), ("prefetch", None)]),
    "unbounded_demote_all": (None, [("prefetch", None), ("lease", 5),
                                    ("prefetch", None), ("demote_all", 0),
                                    ("release", 5), ("demote_all", 0)]),
}


@pytest.mark.parametrize("name", sorted(GRANULE_SCRIPTS))
def test_granule_store_trajectory_matches_dpf_tpu(name):
    budget, script = GRANULE_SCRIPTS[name]
    jstore, store, perm = _granule_pair(budget_granules=budget)
    JFLIGHT.clear()
    FLIGHT.clear()
    assert (_granule_run(store, perm, script)
            == _granule_run(jstore, perm, script))
    pick = [(e["action"], e.get("granule"), e.get("pins"),
             e.get("resident"), e.get("prefetch"))
            for e in FLIGHT.dump() if e.get("kind") == "registry"]
    jpick = [(e["action"], e.get("granule"), e.get("pins"),
              e.get("resident"), e.get("prefetch"))
             for e in JFLIGHT.dump() if e.get("kind") == "registry"]
    assert pick == jpick
    assert store.page_s is not None and store.page_s >= 0


def test_granule_store_rejects_like_dpf_tpu():
    perm = _table(1000, 4)
    for mod in (jregistry, registry):
        kw = {} if mod is jregistry else {"device": "cpu"}
        with pytest.raises(ValueError):
            mod.GranuleStore(perm, 128, **kw)
        store = mod.GranuleStore(perm[:512], 128, **kw)
        with pytest.raises(KeyError):
            store.lease(64)


def test_prefetcher_ticks_match_dpf_tpu():
    jstore, store, _ = _granule_pair(budget_granules=None)
    trajectories = []
    for st, mod in ((jstore, jregistry), (store, registry)):
        pf = mod.GranulePrefetcher(st, max_per_tick=3)
        traj = [pf.budget_this_tick(), pf.tick(), st.resident_row0s()]
        st._page_s = 0.050
        for hz, cap in ((20.0, 8), (2.0, 8), (0.0, 2)):
            p = mod.GranulePrefetcher(st, rates_fn=lambda hz=hz: {8: hz},
                                      max_per_tick=cap, slack=0.5)
            traj += [p.budget_this_tick(), p.tick()]
        broken = mod.GranulePrefetcher(st, rates_fn=lambda: 1 / 0,
                                       max_per_tick=2)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            traj.append(broken.budget_this_tick())
        traj += [pf.stats(), st.stats()["counters"]]
        trajectories.append(traj)
        with pytest.raises(ValueError):
            mod.GranulePrefetcher(st, max_per_tick=0)
        with pytest.raises(ValueError):
            mod.GranulePrefetcher(st, slack=0.0)
    assert trajectories[1] == trajectories[0]
    assert "ZeroDivisionError" in str(
        swallowed_snapshot()["serve.registry.prefetch_rates"])


def test_registry_granule_store_pages_the_logn_layout():
    table = _table(256, 4)
    for mod, kw in ((jregistry, {}), (registry, {"device": "cpu"})):
        reg = mod.TableRegistry(labels=("logn",), **kw)
        reg.register("big", table)
        store = reg.granule_store("big", granule=64, budget_bytes=2 * 64 * 16)
        assert store.n == 256 and store.granule == 64
        assert store.name == "big@v1"
        with store.lease(64) as lease:
            assert np.array_equal(np.asarray(lease.table),
                                  expand.permute_table(table)[64:128])
            held = lease.table
    assert isinstance(held, torch.Tensor) and held.device.type == "cpu"
    # a released lease no longer holds the granule's device buffer
    assert lease.table is None
