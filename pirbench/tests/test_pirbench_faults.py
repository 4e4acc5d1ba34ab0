"""The comparison fails what it must: the control (the reference with a
float32 contraction in the program's place) and faults planted in the
program's timed path, driven through a whole tiny run with the look for
a card skipped (``device="cpu"``)."""

import numpy as np
import pytest
import torch

from pirbench import control
from pirbench.harness import check, runner


def _plant(monkeypatch, fault):
    from dpf_tpu_torch.api import DPF
    real = DPF._dispatch_packed

    def broken(self, pk):
        out = real(self, pk).clone()
        if fault == "answer_altered":
            out[:, 3] += 1                  # one word of every answer
        elif fault == "half_left_out":
            out[:out.shape[0] // 2] = 0     # half of the batch not computed
        elif fault == "rows_shifted":
            out = torch.roll(out, 1, dims=0)  # answers to the wrong keys
        return out

    monkeypatch.setattr(DPF, "_dispatch_packed", broken)


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out",
                                   "rows_shifted"])
@pytest.mark.parametrize("cell", ["aes.bulk", "chacha.serve"])
def test_planted_fault_is_not_correct(fault, cell, tiny_cell, monkeypatch):
    _plant(monkeypatch, fault)
    out = runner.run_cell(tiny_cell(cell), 2 ** 32 + 3, 0.5, False,
                          device="cpu", log=lambda s: None)
    assert out["correct"] is False
    assert out["checks"]["share_words_wrong"]["value"] > 0


def test_answers_that_never_come_are_not_correct(tiny_cell, monkeypatch):
    from dpf_tpu_torch.serve.engine import ServingEngine
    real = ServingEngine.submit
    calls = []

    def flaky(self, keys):
        calls.append(1)
        if len(calls) % 3 == 0:
            raise RuntimeError("dropped")
        return real(self, keys)

    monkeypatch.setattr(ServingEngine, "submit", flaky)
    out = runner.run_cell(tiny_cell("chacha.serve"), 5, 1.0, False,
                          device="cpu", log=lambda s: None)
    assert out["failed"] > 0 and out["correct"] is False
    assert out["checks"]["answers_missing"]["value"] == out["failed"]


@pytest.mark.parametrize("cell", ["aes.bulk", "chacha.serve"])
def test_control_is_caught(cell, tiny_cell):
    nums = control.control_numbers(tiny_cell(cell), 2 ** 33 + 1, 1.0,
                                   device="cpu")
    assert not check.verdict(nums)
    assert nums["share_words_wrong"] > 0 and nums["rows_unrecovered"] > 0


def test_sample_covers_every_bucket():
    from pirbench.harness.client import Request
    sizes = [1, 3, 64, 65, 100, 200, 511, 512, 7, 9]
    reqs = [Request(np.arange(k), 0.0) for k in sizes]
    for r in reqs:
        r.shares = np.zeros((r.keys, 16), np.int32)
    sample = check.draw_sample(reqs, [64, 128, 256, 512], 9, size=20)
    picked = {i for i, _ in sample}
    for lo, hi in ((0, 64), (64, 128), (128, 256), (256, 512)):
        assert any(lo < sizes[i] <= hi for i in picked)
        assert any(lo < sizes[i] <= hi and j == sizes[i] - 1
                   for i, j in sample)
    assert len(sample) == 20 and sample == sorted(set(sample))
