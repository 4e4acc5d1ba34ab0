"""A CPU rehearsal of the runner: tiny cells of both traffic kinds run
end to end through the program's plain versions, in a fresh process
each (so that the check for JAX sees what a run loads), and the
command's refusals."""

import json
import shutil
import subprocess
import sys

import pytest

from pirbench.harness import runner

from .conftest import ROOT

REHEARSE = r"""
import json, sys
sys.path.insert(0, %(root)r)
from pirbench.harness import runner, spec
from pirbench.tests import conftest
bench = conftest.make_tiny_bench()
cell = spec.load_cell(bench, %(cell)r, traffic_dir=conftest.DATA / "traffic")
out = runner.run_cell(cell, %(seed)d, 1.0, %(trace)r, device="cpu",
                      log=lambda s: None)
print(json.dumps({"line": out, "forbidden": runner.forbidden_modules()}))
"""

DEVICE_ONLY = ("kernel_roofline", "window_mfu", "device_idle")


@pytest.mark.parametrize("cell", ["aes.bulk", "chacha.serve"])
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_line(cell, trace, tiny_bench):
    code = REHEARSE % {"root": str(ROOT), "cell": cell, "trace": trace,
                       "seed": 2 ** 33 + 11}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    line = got["line"]
    assert got["forbidden"] == []
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    assert "busy_s" not in line["device"]
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"] for m in tiny_bench[kind]
               if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= allowed
    assert not any(k.startswith(DEVICE_ONLY) for k in line["metrics"])
    if not trace:
        assert "setup_s" in line["metrics"]
        assert set(line["metrics"]) == allowed
    for k, v in line["checks"].items():
        assert v == {"value": 0, "limit": 0}, k


def _no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")


def test_command_without_a_card_prints_no_result():
    _no_card()
    res = subprocess.run(
        [sys.executable, "pirbench/run.py", "--workload",
         "aes128-n2p20.bulk", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "CUDA" in res.stderr


def test_checkout_without_the_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "pirbench", tmp_path / "pirbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "pirbench/run.py", "--workload",
         "aes128-n2p20.bulk", "--seed", "7", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert res.returncode != 0
    assert res.stdout == ""


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in ("dpf_tpu_torch", "dpf_tpu_torch.api", "jaxtyping_x"):
        monkeypatch.setitem(sys.modules, name, object())
    base = set(runner.forbidden_modules())
    assert not {"dpf_tpu_torch", "dpf_tpu_torch.api", "jaxtyping_x"} & base
    for name in ("jax", "jax.numpy", "dpf_tpu", "dpf_tpu.core", "flax",
                 "jaxlib"):
        monkeypatch.setitem(sys.modules, name, object())
    assert {"jax", "jax.numpy", "dpf_tpu", "dpf_tpu.core", "flax",
            "jaxlib"} <= set(runner.forbidden_modules())


def test_a_run_with_the_jax_package_loaded_stops(tiny_cell, monkeypatch):
    monkeypatch.setitem(sys.modules, "dpf_tpu", object())
    with pytest.raises(SystemExit, match="dpf_tpu"):
        runner.run_cell(tiny_cell("aes.bulk"), 3, 0.5, False, device="cpu",
                        log=lambda s: None)
