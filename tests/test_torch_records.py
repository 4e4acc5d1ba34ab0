"""The port's record readers (``utils/results.py``, ``utils/scrape.py``)
give dpf_tpu's outputs on the same fixture files: the results JSONL's
session and round scoping, and the last result line of each log scraped
into rows and a CSV."""

import json

import pytest

from dpf_tpu.utils import results as jresults
from dpf_tpu.utils import scrape as jscrape
from dpf_tpu_torch.utils import results, scrape


def _write_jsonl(path, rows, garbage=True):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
            if garbage:
                f.write("not json\n[1, 2]\n")


ROWS = [
    {"sid": "a", "t": 10, "stage": "point", "v": 1},
    {"sid": "a", "t": 11, "stage": "session", "done": True},
    {"sid": "b", "t": 20, "stage": "point", "v": 2},
    {"sid": "b", "t": 25, "stage": "point", "v": 3},
    {"sid": "b", "t": 30, "stage": "session", "done": True},
    {"sid": "c", "t": 40, "stage": "point", "v": 4},
    {"sid": "c", "t": "bad", "stage": "session", "done": False},
    {"sid": None, "t": 50, "stage": "session", "done": True},
]


def test_results_readers_match_dpf_tpu(tmp_path):
    path = tmp_path / "results.jsonl"
    _write_jsonl(path, ROWS)
    rows = results.load_rows(str(path))
    assert rows == jresults.load_rows(str(path)) == ROWS
    assert results.load_rows(str(tmp_path / "absent")) == []
    for since in (None, 0, 11, 12, 22, 31, 60):
        assert (results.latest_done_sid(rows, since=since)
                == jresults.latest_done_sid(rows, since=since))
        for sid in (None, "a", "b", "c", "zz"):
            assert (results.session_rows(rows, sid=sid, since=since)
                    == jresults.session_rows(rows, sid=sid, since=since))
    assert [r["v"] for r in results.session_rows(rows, since=22)
            if "v" in r] == [3]


@pytest.mark.parametrize("progress", [
    None, "", "garbage\n",
    '{"round": 1, "ts": 5.0}\n{"round": 2, "ts": 7.5}\n'
    '{"round": 2, "ts": 9.0}\n{"round": "x"}\n'])
def test_round_start_matches_dpf_tpu(tmp_path, progress):
    if progress is not None:
        (tmp_path / "PROGRESS.jsonl").write_text(progress)
    got = results.round_start_t(str(tmp_path))
    assert got == jresults.round_start_t(str(tmp_path))
    if progress and "round" in progress:
        assert got == 7.5
    else:
        assert got is None


def test_scrape_matches_dpf_tpu(tmp_path):
    logs = {
        "a.log": "warmup\n{'n': 1, 'prf': 'AES'}\nnoise\n"
                 '{"n": 2, "dpfs": 3.5}\n',
        "b.log": "no result here\n{broken\n",
        "c.log": "{'x': [1, 2], 'y': None}\n  {\"z\": true}  \n",
        "d.txt": "{'n': 9}\n",
    }
    for name, text in logs.items():
        (tmp_path / name).write_text(text)
    for line in ("{'a': 1}", '{"a": 1}', "[1]", "{1: 2", "  {}  ", "x"):
        assert (scrape.parse_result_line(line)
                == jscrape.parse_result_line(line))
    for name in logs:
        p = str(tmp_path / name)
        assert scrape.scrape_file(p) == jscrape.scrape_file(p)
    rows = scrape.scrape_dir(str(tmp_path / "*.log"))
    assert rows == jscrape.scrape_dir(str(tmp_path / "*.log"))
    assert [n for n, _ in rows] == ["a.log", "c.log"]
    mine = scrape.to_csv(rows, str(tmp_path / "mine.csv"))
    ref = jscrape.to_csv(rows, str(tmp_path / "ref.csv"))
    assert open(mine).read() == open(ref).read()
    assert open(mine).read().splitlines()[0] == "log,n,dpfs,z"
