"""What decides ``correct``: answers of the timed window held against
the plain reference, exactly.

After the window has closed, a sample of answered (request, row) pairs
is drawn from the run's seed: from every bucket size the window used at
least two requests (each with its last row, which sits next to the pad
rows, and one more), the rest drawn at random.  The reference expands
each sampled key over the whole table on its own and contracts it in
Z_2^32; a few keys also have the second server's key expanded, so that
the program's share minus that one must give the table row.

Numbers compared, each with its limit (an exact comparison: 0):

* ``answers_missing``: requests of the window that never got an answer;
* ``share_words_wrong``: int32 share words of the sample that differ
  from the reference's;
* ``rows_unrecovered``: sampled keys whose program share minus the
  reference's second-server share is not the table row.
"""

from __future__ import annotations

import numpy as np
import torch

LIMITS = {"answers_missing": 0, "share_words_wrong": 0,
          "rows_unrecovered": 0}
SAMPLE_KEYS = 64
RECOVERY_KEYS = 4


def draw_sample(requests, buckets, seed: int, size: int = SAMPLE_KEYS):
    """Sorted distinct (request index, row) pairs of answered requests."""
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 4])
    answered = [i for i, r in enumerate(requests) if r.shares is not None]
    if not answered:
        return []
    picked = set()
    lo = 0
    for b in sorted(buckets):
        band = [i for i in answered if lo < requests[i].keys <= b]
        lo = b
        for i in rng.permutation(band)[:2]:
            k = requests[int(i)].keys
            picked.add((int(i), k - 1))
            picked.add((int(i), int(rng.integers(k))))
    total = sum(requests[i].keys for i in answered)
    size = min(size, total)
    while len(picked) < size:
        i = answered[int(rng.integers(len(answered)))]
        picked.add((i, int(rng.integers(requests[i].keys))))
    return sorted(picked)


def compare(requests, sample, answers, pool, table, construction, cipher,
            *, control: bool = False) -> dict:
    """The compared numbers.  ``answers[(i, row)]`` is what the timed path
    returned for that pair; ``pool`` holds the keys ("wire0", "wire1",
    "alphas"); ``table`` is the [N, E] int32 table on the reference's
    device.  ``control`` runs the reference's float32 contraction in
    place of the answers (the control of the comparison)."""
    missing = sum(1 for r in requests if r.shares is None)
    if not sample:
        return {"answers_missing": missing, "share_words_wrong": None,
                "rows_unrecovered": None}
    rows = np.array([requests[i].rows[j] for i, j in sample])
    uniq, inv = np.unique(rows, return_inverse=True)
    want = construction.shares(pool["wire0"][uniq], table, cipher)[inv]
    if control:
        got = construction.shares(pool["wire0"][uniq], table, cipher,
                                  control=True)[inv]
    else:
        got = np.stack([answers[p] for p in sample])
    wrong = int((got != want).sum())
    first = np.unique(inv, return_index=True)[1][:RECOVERY_KEYS]
    other = construction.shares(pool["wire1"][rows[first]], table, cipher)
    rec = (got[first].astype(np.int64) - other) & 0xFFFFFFFF
    idx = torch.as_tensor(pool["alphas"][rows[first]], device=table.device)
    row = table[idx].cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    unrec = int((rec != row).any(axis=1).sum())
    return {"answers_missing": missing, "share_words_wrong": wrong,
            "rows_unrecovered": unrec}


def verdict(numbers: dict) -> bool:
    return all(numbers.get(k) is not None and numbers[k] <= lim
               for k, lim in LIMITS.items())


def listing(numbers: dict) -> dict:
    """{name: {"value", "limit"}} for the result line."""
    return {k: {"value": numbers.get(k), "limit": lim}
            for k, lim in LIMITS.items()}
