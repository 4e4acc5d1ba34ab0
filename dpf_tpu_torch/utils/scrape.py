"""Scrape printed-dict benchmark lines from logs into rows / CSV (port of
``dpf_tpu/utils/scrape.py``: the same functions, standard library only).

Counterpart of the reference's ``paper/kernel/gpu/scripts/scrape.py``:
benchmark binaries/scripts print one python-dict (or JSON) result line per
run; this collects the *last* such line of each log into a table.
"""

from __future__ import annotations

import ast
import csv
import glob
import json
import os


def parse_result_line(line: str):
    """A result line is a dict literal (JSON or python repr) -> dict|None."""
    line = line.strip()
    if not (line.startswith("{") and line.endswith("}")):
        return None
    for parser in (json.loads, ast.literal_eval):
        try:
            d = parser(line)
            return d if isinstance(d, dict) else None
        except (ValueError, SyntaxError):
            continue
    return None


def scrape_file(path: str):
    """Last result-dict line of a log file, or None."""
    result = None
    with open(path) as f:
        for line in f:
            d = parse_result_line(line)
            if d is not None:
                result = d
    return result


def scrape_dir(pattern: str):
    """Glob logs -> list of (filename, result dict)."""
    rows = []
    for path in sorted(glob.glob(pattern)):
        d = scrape_file(path)
        if d is not None:
            rows.append((os.path.basename(path), d))
    return rows


def to_csv(rows, out_path: str):
    """Write scraped (name, dict) rows to CSV with the union of keys."""
    keys = []
    for _, d in rows:
        for k in d:
            if k not in keys:
                keys.append(k)
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["log"] + keys)
        for name, d in rows:
            w.writerow([name] + [d.get(k, "") for k in keys])
    return out_path
