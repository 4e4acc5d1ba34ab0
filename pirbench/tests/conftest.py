"""Tests of the benchmark harness.  They run on the CPU at small sizes
and may import the program (``dpf_tpu_torch``) to hold the frozen copies
to their sources; the harness itself never does.  Tests that need the
card carry the ``chip`` marker and skip, from a fixture, where there is
none: ``python -m pytest pirbench/tests -q`` here, and on a machine with
an H100 the same command runs them too."""

import json
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("DPF_TPU_TORCH_TUNE_CACHE", "off")
# the tests run in several processes at once: one thread each keeps
# small CPU tensors from fighting over the cores
os.environ.setdefault("OMP_NUM_THREADS", "1")

DATA = Path(__file__).resolve().parent / "data"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card (skips without CUDA)")


@pytest.fixture
def chip():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def make_tiny_bench() -> dict:
    """BENCHMARK.json's metrics over two tiny cells (2^10 x 16 tables, a
    64-key bulk batch, an open loop of 1..64-key requests), with configs
    and traffic under ``tests/data``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [
        {"name": "tiny-aes128",
         "file": "pirbench/tests/data/configs/tiny-aes128.json"},
        {"name": "tiny-chacha20",
         "file": "pirbench/tests/data/configs/tiny-chacha20.json"}]
    bench["workloads"] = [
        {"name": "aes.bulk", "config": "tiny-aes128", "traffic": "bulk",
         "chips": 1},
        {"name": "chacha.serve", "config": "tiny-chacha20",
         "traffic": "serve", "chips": 1}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            bulk = any(w.endswith(".bulk") for w in m["workloads"])
            m["workloads"] = ["aes.bulk"] if bulk else ["chacha.serve"]
    return bench


@pytest.fixture
def tiny_bench():
    return make_tiny_bench()


@pytest.fixture
def tiny_cell(tiny_bench):
    from pirbench.harness import spec

    def load(name):
        return spec.load_cell(tiny_bench, name, traffic_dir=DATA / "traffic")
    return load
