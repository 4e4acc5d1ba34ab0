"""K2's time at full width and at short batches, for this tree's build of
``csrc/subtree.cu`` and, if given, another build with the same C entry
(for example a parent commit's).

Times the eight K2 instances (PRF ids 1, 2, 4 and 5 over the binary and
the radix-4 tree) at B = 512, N = 2^20, E = 16 and at E = 1 (the same
expansion, a sixteenth of the contraction), and binary ChaCha20 and
radix-4 ChaCha20-BLK at B = 1, 2 and 8 (the server pads a batch to a
power of two), all from the root at the 4096 leaves per block that the
API resolves.  Each library's result is held bit for bit against the
plain version before it is timed; with other libraries all are timed
in turns: the others, this tree's twice, the others again (every build
gets ``per_key`` 0 before the stream; a build that predates the
per-key mode reads that 0 as its stream, the default stream, which is
the current one here).  Needs one CUDA card and the toolkit:

    python -m dpf_tpu_torch.utils.k2_times [other subtree library ...]
"""

from __future__ import annotations

import ctypes
import json
import sys

import torch

from ..core import radix4
from ..ops import subtree
from .bench import held_ms, libraries_in_turns

N_LOG = 20
NAMES = {1: "Salsa20", 2: "ChaCha20", 4: "Salsa20-BLK", 5: "ChaCha20-BLK"}
SHORT = ((2, 2), (5, 4))            # (prf, radix) timed at short batches


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_times: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261017)

    def rnd(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int64,
                             device=dev, generator=gen).to(torch.int32)

    libs = libraries_in_turns("subtree", "subtree_contract_launch",
                              sys.argv[1:])
    n = 1 << N_LOG
    ars = radix4.arities(n)
    scheds = {2: subtree._binary_schedule(N_LOG),
              4: list(zip(ars, radix4.cw_offsets(ars)))}
    fr, cw1, cw2 = rnd(512, 1, 4), rnd(512, 64, 4), rnd(512, 64, 4)
    tbl = rnd(n, 16)
    tbl1 = tbl[:, :1].contiguous()
    rows = []

    def launch(fn, bsz, table, sched, prf):
        out = torch.zeros((bsz, table.shape[1]), dtype=torch.int32,
                          device=dev)
        lg = (ctypes.c_int * len(sched))(*(a.bit_length() - 1
                                           for a, _ in sched))
        off = (ctypes.c_int * len(sched))(*(o for _, o in sched))
        code = fn(fr.data_ptr(), cw1.data_ptr(), cw2.data_ptr(),
                  table.data_ptr(), out.data_ptr(), bsz, 1, len(sched), lg,
                  off, 0, 12, table.shape[1], prf, 0,
                  torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError("subtree_contract_launch: CUDA error %d"
                               % code)
        return out

    def plain(bsz, table, radix, prf):
        if radix == 2:
            return subtree.subtree_contract_plain(
                fr[:bsz], cw1[:bsz], cw2[:bsz], table, depth=N_LOG,
                f_levels=0, prf_method=prf, block_leaves=4096)
        return subtree.subtree_contract_mixed_plain(
            fr[:bsz], cw1[:bsz], cw2[:bsz], table, ars=ars, f_lv=0,
            prf_method=prf, block_leaves=4096)

    def measure(prf, radix, bsz, tables):
        name = "%s %s B=%d" % ("binary" if radix == 2 else "radix-4",
                               NAMES[prf], bsz)
        full = plain(bsz, tables[0], radix, prf)
        reps = 5 if bsz == 512 else 20
        mine = [{"instance": name, "library": label} for label, _ in libs]
        for t in tables:                            # tables[1:]: E = 1
            timed = held_ms(
                libs, lambda fn: launch(fn, bsz, t, scheds[radix], prf),
                full[:, :t.shape[1]], reps, "%s E=%d" % (name, t.shape[1]))
            for row, (_, ms) in zip(mine, timed):
                row["ms" if t.shape[1] == 16 else "e1_ms"] = ms
        for row in mine:
            rows.append(row)
            print("  %-28s %-8s ms %.4f%s  bit-equal" % (
                name, row["library"], row["ms"], "  E=1 ms %.4f"
                % row["e1_ms"] if "e1_ms" in row else ""), flush=True)

    for radix in (2, 4):
        for prf in sorted(NAMES):
            measure(prf, radix, 512, (tbl, tbl1))
    for prf, radix in SHORT:
        for bsz in (1, 2, 8):
            measure(prf, radix, bsz, (tbl,))
    print(json.dumps({"k2_times": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
