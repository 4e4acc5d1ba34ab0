"""On the card (``chip`` marker; skipped without CUDA): one full-size
cell through the command, and the control at the cell's own size."""

import json
import subprocess
import sys

import pytest

from pirbench import control
from pirbench.harness import check, spec

from .conftest import ROOT

pytestmark = pytest.mark.chip


@pytest.mark.parametrize("cell", ["aes128-n2p20.bulk",
                                  "chacha20-n2p20.serve"])
def test_cell_on_the_card_is_correct(chip, cell):
    res = subprocess.run(
        [sys.executable, "pirbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 77), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", ["aes128-n2p20.serve",
                                  "chacha20-n2p20.bulk"])
def test_control_at_the_cells_size_is_caught(chip, cell):
    nums = control.control_numbers(
        spec.load_cell(spec.load_benchmark(), cell), 2 ** 32 + 9, 40.0,
        device="cuda")
    assert not check.verdict(nums)
    assert nums["share_words_wrong"] >= 3 and nums["rows_unrecovered"] >= 1
