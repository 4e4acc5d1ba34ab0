"""The sqrt-N cell's pieces held on the CPU at small sizes: the frozen key
generator against the program's, the plain reference against the
program's shares and the row, a tiny sqrt-N cell run end to end through
the runner (``correct``), the control and the planted faults of
``test_pirbench_faults.py`` caught on the sqrt-N path, the frozen work
beside ``chip_smoke.py``'s count for K4, and the reader of
``key_upload_ms``.  On a card (``chip`` marker) the full-size cell runs
through the command and its control is caught."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from pirbench import control
from pirbench.harness import check, runner, spec
from pirbench.harness.runner import RunView

from .conftest import DATA, ROOT, make_tiny_bench
from .test_pirbench_faults import _plant
from .test_pirbench_frozen import _chip_smoke
from .test_pirbench_runner import DEVICE_ONLY

CELL = "sqrtn-chacha20-n2p20.bulk"
TINY = "sqrtn.bulk"


def make_sqrtn_bench() -> dict:
    """The tiny bench of ``conftest.make_tiny_bench`` with a tiny sqrt-N
    bulk cell (2^8 x 4 table, the 64-key bulk traffic) reporting what the
    full-size sqrt-N cell reports."""
    full = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = make_tiny_bench()
    bench["configs"].append(
        {"name": "tiny-sqrtn-chacha20",
         "file": "pirbench/tests/data/configs/tiny-sqrtn-chacha20.json"})
    bench["workloads"].append({"name": TINY, "config": "tiny-sqrtn-chacha20",
                               "traffic": "bulk", "chips": 1})
    for kind in ("end_to_end", "per_layer"):
        for m, f in zip(bench[kind], full[kind]):
            if CELL in f.get("workloads", ()):
                m["workloads"] = [TINY] + (
                    [] if f["name"].endswith(".sqrtn") else m["workloads"])
    return bench


def _cell():
    return spec.load_cell(make_sqrtn_bench(), TINY,
                          traffic_dir=DATA / "traffic")


# ------------------------------------------- keygen and the reference

@pytest.mark.parametrize("n, k, r", [(1 << 8, 16, 16), (1 << 9, 32, 16)])
def test_keygen_is_the_programs(n, k, r):
    from dpf_tpu_torch.core import sqrtn as port
    cons = spec.construction("sqrtn")
    assert cons.default_split(n) == port.default_split(n) == (k, r)
    alphas = np.array([0, n - 1, n // 3, 17])
    seeds = [b"frozen-sqrt-%d" % i for i in range(4)]
    a, b = cons.gen(alphas, n, seeds, spec.cipher("chacha20"))
    assert a.shape == (4, 4 * (4 + k + 2 * r))
    for i, (alpha, seed) in enumerate(zip(alphas, seeds)):
        k0, k1 = port.generate_sqrt_keys(int(alpha), n, seed, prf_method=2)
        assert np.array_equal(a[i], k0.serialize())
        assert np.array_equal(b[i], k1.serialize())


def test_reference_matches_program_and_recovers():
    from dpf_tpu_torch.api import DPF
    cons, c = spec.construction("sqrtn"), spec.cipher("chacha20")
    n = 1 << 9
    table = np.random.default_rng(2).integers(
        -2 ** 31, 2 ** 31, (n, 16)).astype(np.int32)
    alphas = np.array([3, 500, 77])
    k0, k1 = cons.gen(alphas, n, [b"r%d" % i for i in range(3)], c)
    ref0 = cons.shares(k0, torch.from_numpy(table), c, keys_per_block=2)
    ref1 = cons.shares(k1, torch.from_numpy(table), c)
    d = DPF(prf=2, scheme="sqrtn", device="cpu")
    d.eval_init(table)
    assert np.array_equal(ref0, d.eval_cpu(list(torch.from_numpy(k0)))
                          .numpy())
    rec = (ref0.astype(np.int64) - ref1) & 0xFFFFFFFF
    assert np.array_equal(rec, table[alphas].astype(np.int64) & 0xFFFFFFFF)
    ctl = cons.shares(k0, torch.from_numpy(table), c, control=True)
    assert (ctl != ref0).mean() > 0.9


# --------------------------------------------- the tiny cell, end to end

REHEARSE = r"""
import json, sys
sys.path.insert(0, %(root)r)
from pirbench.harness import runner, spec
from pirbench.tests import conftest
from pirbench.tests.test_pirbench_sqrtn import make_sqrtn_bench
cell = spec.load_cell(make_sqrtn_bench(), %(cell)r,
                      traffic_dir=conftest.DATA / "traffic")
out = runner.run_cell(cell, %(seed)d, 1.0, %(trace)r, device="cpu",
                      log=lambda s: None)
print(json.dumps({"line": out, "forbidden": runner.forbidden_modules()}))
"""


@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_line(trace):
    code = REHEARSE % {"root": str(ROOT), "cell": TINY, "trace": trace,
                       "seed": 2 ** 33 + 21}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    line = got["line"]
    assert got["forbidden"] == []
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"] for m in make_sqrtn_bench()[kind]
               if TINY in m.get("workloads", [TINY])}
    assert set(line["metrics"]) <= allowed
    assert not any(k.startswith(DEVICE_ONLY) for k in line["metrics"])
    if trace:
        # a CPU run has no device trace: the upload has nothing to read
        assert "key_upload_ms.sqrtn" not in line["metrics"]
        assert line["metrics"]["engine_host_ms.bulk"]["value"] > 0
    else:
        assert set(line["metrics"]) == {"dpfs_per_s", "setup_s"}
    for k, v in line["checks"].items():
        assert v == {"value": 0, "limit": 0}, k


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out",
                                   "rows_shifted"])
def test_planted_fault_is_not_correct(fault, monkeypatch):
    _plant(monkeypatch, fault)
    out = runner.run_cell(_cell(), 2 ** 32 + 5, 0.5, False, device="cpu",
                          log=lambda s: None)
    assert out["correct"] is False
    assert out["checks"]["share_words_wrong"]["value"] > 0


def test_control_is_caught():
    nums = control.control_numbers(_cell(), 2 ** 33 + 3, 1.0, device="cpu")
    assert not check.verdict(nums)
    assert nums["share_words_wrong"] > 0 and nums["rows_unrecovered"] > 0


# ------------------------------------------------- work and the reader

def test_work_against_the_programs_bound():
    """B = 512, N = 2^20, E = 16, one request: ``chip_smoke.py`` prices a
    K4 ChaCha20 cell at one core block, a select and add (3) and two
    instructions a table column; the frozen work counts one multiply-add
    a column, 2.5% fewer instructions."""
    cs = _chip_smoke()
    b, n, e = 512, 1 << 20, 16
    w = spec.work("sqrtn_chacha20").work(n, e, b, 1)
    k4_ops = b * n * (cs.OPS_CORE_BLOCK + 3 + 2 * e)
    assert w["ops"] == k4_ops - b * n * e
    assert 0.97 < w["ops"] / k4_ops < 1.0
    assert w["bytes"] == n * e * 4 + b * (49216 + e * 4)


OPS = [["sqrt_grid_kernel", 38.6], ["Memcpy HtoD (Pinned -> Device)", 1.2],
       ["Memcpy DtoH (Device -> Pinned)", 0.01]]


@pytest.mark.parametrize("stats, trace, value", [
    ({"dispatches": 2400}, {"device_ops": OPS}, 0.5),
    # a CPU or untraced run: no device trace
    ({"dispatches": 2400}, None, None),
    # nothing dispatched in the window
    ({"dispatches": 0}, {"device_ops": OPS}, None),
    # a trace without a host-to-device copy
    ({"dispatches": 2400}, {"device_ops": OPS[:1]}, None),
])
def test_key_upload_ms(stats, trace, value):
    got = spec.reader("key_upload_ms.sqrtn").read(RunView(stats=stats,
                                                          trace=trace))
    assert got == (None if value is None else pytest.approx(value))


# ------------------------------------------------------------- the card

@pytest.mark.chip
def test_cell_on_the_card_is_correct(chip):
    res = subprocess.run(
        [sys.executable, "pirbench/run.py", "--workload", CELL, "--seed",
         str(2 ** 31 + 79), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"


@pytest.mark.chip
def test_control_at_the_cells_size_is_caught(chip):
    nums = control.control_numbers(
        spec.load_cell(spec.load_benchmark(), CELL), 2 ** 32 + 11, 40.0,
        device="cuda")
    assert not check.verdict(nums)
    assert nums["share_words_wrong"] >= 3 and nums["rows_unrecovered"] >= 1
