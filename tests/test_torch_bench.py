"""The port's benchmark harness on the CPU (``device="cpu"``): the
throughput, latency and contraction benchmarks run and check their
results, the ``"mxu"`` contraction equals ``dpf_tpu``'s
``dot_i32_mxu`` bit for bit, the reference sweep has its twelve
configurations with a yardstick for each, and ``benchmark.main`` routes
every mode of the root ``benchmark.py``, in its order, to the port's
module with the flag removed."""

import numpy as np
import pytest
import torch

from dpf_tpu.ops import matmul128 as jmatmul128
from dpf_tpu_torch import benchmark
from dpf_tpu_torch.ops import matmul128
from dpf_tpu_torch.utils import bench
from dpf_tpu_torch.utils.config import EvalConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("config", [{}, {"radix": 4}, {"scheme": "sqrtn"}],
                         ids=["binary", "radix4", "sqrtn"])
def test_dpf_perf_distinct_keys_on_cpu(config):
    r = bench.test_dpf_perf(N=1024, batch=8, entrysize=4, prf=2, reps=1,
                            check=True, quiet=True, device="cpu",
                            config=EvalConfig(**config))
    assert r["checked"] and r["keys_distinct"] == 8 and r["device"] == "cpu"
    assert r["keygen_s"] > 0 and r["dpfs_per_sec"] > 0
    assert r["keygen"] in ("native", "vectorized")
    tiled = bench.test_dpf_perf(N=1024, batch=8, entrysize=4, prf=0,
                                reps=1, keys_distinct=3, check=True,
                                quiet=True, device="cpu",
                                config=EvalConfig(**config))
    assert tiled["checked"] and tiled["keys_distinct"] == 3


@pytest.mark.parametrize("config", [{}, {"radix": 4}, {"scheme": "sqrtn"}],
                         ids=["binary", "radix4", "sqrtn"])
def test_dpf_latency_on_cpu(config, capsys):
    r = bench.test_dpf_latency(N=1024, entrysize=4, prf=2, reps=2,
                               device="cpu", config=EvalConfig(**config))
    assert r["mode"] == "latency" and r["checked"] and r["latency_ms"] > 0
    assert (r["scheme"], r["radix"]) == (config.get("scheme", "logn"),
                                         config.get("radix", 2))
    assert '"latency_ms"' in capsys.readouterr().out


def test_matmul_perf_on_cpu():
    res = bench.test_matmul_perf(B=8, K=256, E=4, reps=3, quiet=True,
                                 device="cpu")
    assert sorted(res) == sorted(matmul128.available_impls())
    for name, r in res.items():
        assert r["impl"] == name and (r["B"], r["K"], r["E"]) == (8, 256, 4)
        assert r["gops_per_sec"] > 0 and r["elapsed_s"] > 0
    big = bench.test_matmul_perf(B=3, K=1024, E=16, reps=1, quiet=True,
                                 device="cpu")
    assert all(r["gops_per_sec"] > 0 for r in big.values())


def test_matmul_perf_rejects_an_inexact_impl(monkeypatch):
    monkeypatch.setitem(matmul128.IMPLS, "off_by_one",
                        lambda a, b: matmul128.dot_i32_plain(a, b) + 1)
    with pytest.raises(AssertionError, match="off_by_one"):
        bench.test_matmul_perf(B=8, K=64, E=4, reps=1, quiet=True,
                               device="cpu")


@pytest.mark.parametrize("shape", [(1, 1, 1), (8, 256, 4), (3, 7, 5),
                                   (17, 24, 8), (33, 100, 17), (24, 64, 16),
                                   (64, 4096, 16)])
def test_mxu_matches_dpf_tpu(shape):
    """Ragged shapes are zero-padded to what ``torch._int_mm`` takes on
    CUDA (more than 16 rows, K and E multiples of 8); aligned ones are
    not.  INT32_MIN and -1 in both operands."""
    bsz, k, e = shape
    rng = np.random.default_rng(k)
    a = rng.integers(-2 ** 31, 2 ** 31, (bsz, k), dtype=np.int64).astype(
        np.int32)
    b = rng.integers(-2 ** 31, 2 ** 31, (k, e), dtype=np.int64).astype(
        np.int32)
    a[0, 0] = b[-1, -1] = np.iinfo(np.int32).min
    a[-1, -1] = b[0, 0] = -1
    want = np.asarray(jmatmul128.dot_i32_mxu(a, b))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for impl in ("mxu", "i32", None):
        assert (matmul128.dot(ta, tb, impl).numpy() == want).all(), impl
    assert (matmul128.dot_i32_mxu(ta[:, ::2], tb[::2]).numpy()
            == np.asarray(jmatmul128.dot_i32_mxu(a[:, ::2], b[::2]))).all()


def test_dot_impl_registry():
    assert matmul128.available_impls()[:2] == ("i32", "mxu")
    assert matmul128.default_impl() == "i32"
    with pytest.raises(KeyError):
        matmul128.set_dot_impl("nope")
    try:
        matmul128.set_dot_impl("mxu")
        assert matmul128.default_impl() == "mxu"
    finally:
        matmul128.set_dot_impl("i32")


def test_sweep_configurations():
    cfgs = benchmark.sweep_configs()
    assert len(cfgs) == 12 and len(set(cfgs)) == 12
    assert {n for n, _ in cfgs} == {1 << 14, 1 << 16, 1 << 18, 1 << 20}
    assert {p for _, p in cfgs} == {1, 2, 3}
    for c in cfgs:
        assert set(benchmark.BASELINE_DPFS[c]) == {"P100", "V100"}
    assert benchmark.BASELINE_DPFS[(1 << 16, 3)]["V100"] == 15392


def test_sweep_rows_on_cpu(capsys, monkeypatch):
    rows = benchmark.run_sweep([(1024, 1), (1024, 3)], batch=4, entrysize=2,
                               reps=1, device="cpu")
    assert [r["prf"] for r in rows] == ["SALSA20", "AES128"]
    assert all(r["checked"] and r["keys_distinct"] == 4 for r in rows)
    assert capsys.readouterr().out.count('"dpfs_per_sec"') == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert benchmark.main(["--n", "1024"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def _root_modes() -> list:
    """The root ``benchmark.py``'s mode flags, in its order."""
    import ast
    from pathlib import Path
    src = (Path(__file__).resolve().parent.parent / "benchmark.py")
    flags = []
    for node in ast.walk(ast.parse(src.read_text())):
        if (isinstance(node, ast.Compare) and len(node.ops) == 1
                and isinstance(node.ops[0], ast.In)
                and isinstance(node.left, ast.Constant)
                and str(node.left.value).startswith("--")):
            flags.append((node.lineno, node.left.value))
    return [f for _, f in sorted(flags)]


def test_modes_are_the_root_benchmarks():
    assert [f for f, _, _ in benchmark.MODES] == _root_modes()
    assert len(benchmark.MODES) == 13


@pytest.mark.parametrize("flag,target,added", benchmark.MODES)
def test_each_mode_reaches_its_main_without_the_flag(flag, target, added,
                                                     monkeypatch):
    import importlib
    calls = []
    mod = importlib.import_module(target, "dpf_tpu_torch")
    monkeypatch.setattr(mod, "main", calls.append)
    assert benchmark.main(["--dryrun", flag, "--device", "cpu"]) == 0
    assert calls == [["--dryrun", "--device", "cpu", *added]]


@pytest.mark.parametrize("flag,fn,kw", [
    ("--autotune", "autotune_sweep",
     dict(prf_method=3, entry_size=16, reps=2, serve=False, force=True,
          out=None, device="cpu", distinct=32)),
    ("--autotune-scheme", "scheme_sweep",
     dict(prf_method=3, entry_size=16, reps=2, force=True, out=None,
          device="cpu", distinct=32)),
    ("--autotune-kernel", "kernel_search_sweep",
     dict(prf_method=3, entry_size=16, reps=2, generations=3,
          population=6, family="sqrtn", force=True, dryrun=False,
          out=None, device="cpu")),
])
def test_autotune_mains_call_the_ports_sweeps(flag, fn, kw, monkeypatch):
    import importlib
    calls = []
    mod = importlib.import_module("dpf_tpu_torch.tune." + (
        "kernel_search" if fn == "kernel_search_sweep" else "search"))
    monkeypatch.setattr(mod, fn, lambda shapes, **k: calls.append(
        (shapes, k)))
    argv = [flag, "--shapes", "1024:8,4096:16", "--prf", "3", "--reps",
            "2", "--force", "--device", "cpu"]
    if flag == "--autotune":
        argv.append("--no-serve")
    assert benchmark.main(argv) == 0
    assert calls == [(((1024, 8), (4096, 16)), kw)]


def test_autotune_sweeps_default_to_the_roots_shapes(monkeypatch):
    from dpf_tpu.tune.search import DEFAULT_SWEEP as ROOT_SWEEP
    from dpf_tpu_torch.tune import search
    calls = []
    monkeypatch.setattr(search, "scheme_sweep",
                        lambda shapes, **k: calls.append(shapes))
    assert benchmark.main(["--autotune-scheme", "--device", "cpu"]) == 0
    assert calls == [search.DEFAULT_SWEEP] == [tuple(ROOT_SWEEP)]
