"""Example usage: private retrieval of table[42] from two servers.

The walkthrough of the root ``sample.py`` on the PyTorch port:

- a client wants one entry of a table replicated on two non-colluding
  servers without revealing which one;
- it builds a DPF for its secret index and sends one ~2 KB key to each
  server;
- each server expands its key on the GPU against the whole table and
  returns one additive share (``entry_size`` int32 words);
- the client subtracts the shares to recover the entry.

Run: ``python -m dpf_tpu_torch.sample`` (add ``--device cpu`` to run the
plain versions on the CPU).
"""

from __future__ import annotations

import argparse

import numpy as np

import dpf_tpu_torch

TABLE_SIZE = 16384
ENTRY_SIZE = 1
SECRET_INDEX = 42


def server(table, key, device):
    # server initializes the DPF with the table and evaluates the key
    dpf_ = dpf_tpu_torch.DPF(prf=dpf_tpu_torch.PRF_SALSA20, device=device)
    dpf_.eval_init(table)
    return dpf_.eval_gpu([key]).cpu().numpy()


def client(device=None):
    table = np.random.default_rng().integers(
        0, 2 ** 31, (TABLE_SIZE, ENTRY_SIZE), dtype=np.int32)
    table[SECRET_INDEX, :] = 42

    # two keys that represent the secret index; key generation runs on
    # the client's CPU whatever the servers' device
    dpf_ = dpf_tpu_torch.DPF(prf=dpf_tpu_torch.PRF_SALSA20, device="cpu")
    k1, k2 = dpf_.gen(SECRET_INDEX, TABLE_SIZE)

    # one key to each server; if they do not collude neither learns the
    # index
    a = int(server(table, k1, device)[0, 0])
    b = int(server(table, k2, device)[0, 0])
    rec = int(np.int32(np.uint32(a & 0xFFFFFFFF) - np.uint32(b & 0xFFFFFFFF)))
    print(a, b, rec)
    if rec != 42:
        raise SystemExit("recovery failed: got %d" % rec)
    print("Recovered table[42] privately.")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="server device (default: cuda)")
    client(ap.parse_args().device)
