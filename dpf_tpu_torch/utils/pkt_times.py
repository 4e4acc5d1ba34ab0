"""The per-key modes of K2 and K4 at batch-PIR's bin shapes, for this
tree's build of ``csrc/subtree.cu`` and ``csrc/sqrt_grid.cu`` and, if
given, other builds with the same C entries (for example a parent
commit's).

One 2^20 x 16 int32 table cut into G bins of n rows, as
``PIRConfig(bin_fraction=1/G)`` cuts it, the same 64 MiB stack of
per-key tables at every point: (G, n) = (256, 4096), (16, 65536) and
(1024, 1024).  K2's per-key mode for binary ChaCha20, radix-4 ChaCha20
and radix-4 ChaCha20-BLK from the root; K4's for AES-128, ChaCha20 and
ChaCha20-BLK with K = R = sqrt(n).  Each library's result is held bit
for bit against the plain version, then timed as device time under
``torch.profiler`` (``bench.profiled_ms``, one session per library:
builds share their kernels' names).  This tree's build runs at the
geometry its wrappers pick (``subtree.pkt_block_leaves``,
``sqrt_grid.pkt_row_chunk``), another build at the geometry the wrappers
of a build whose per-key mode was a flag of the shared kernels picked
(K2: block subtrees of min(n, 4096) leaves; K4: ``sqrt_row_chunk`` of
``clamp_row_chunk``), in turns: the others, this tree's twice, the
others again.  An other library names its source by its file name's
stem (``subtree-<digest>.so``, ``sqrt_grid-<digest>.so``).
``--geometry`` times this tree's build at every legal K2 block size of
at least 256 leaves and every legal K4 row chunk instead; ``--entry-size
1`` takes tables of one column (the same expansion, a sixteenth of the
table's bytes), which shows what the contraction costs.  Needs one CUDA
card and the toolkit:

    python -m dpf_tpu_torch.utils.pkt_times [--geometry] [--entry-size E]
        [other library ...]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from ..core import radix4, sqrtn
from ..ops import cuda_build, sqrt_grid, subtree
from .bench import gpu_name_and_power, load_entry, profiled_ms

POINTS = ((256, 4096), (16, 65536), (1024, 1024))
K2_CASES = (("binary ChaCha20", 2, 2), ("radix-4 ChaCha20", 4, 2),
            ("radix-4 ChaCha20-BLK", 4, 5))
K4_CASES = (("AES-128", 3), ("ChaCha20", 2), ("ChaCha20-BLK", 5))
ENTRIES = {"subtree": "subtree_contract_launch",
           "sqrt_grid": "sqrt_grid_launch"}


def _schedule(n: int, radix: int) -> list:
    if radix == 2:
        return subtree._binary_schedule(n.bit_length() - 1)
    ars = radix4.arities(n)
    return list(zip(ars, radix4.cw_offsets(ars)))


def k2_legal_blocks(n: int, radix: int) -> list:
    """K2 block sizes of at least 256 leaves the per-key kernel takes."""
    out, c = [], 1
    for a, _ in reversed(_schedule(n, radix)):
        c *= a
        if subtree.PKT_MIN_BLOCK_LEAVES <= c <= subtree.MAX_BLOCK_LEAVES:
            out.append(c)
    return out


def k4_legal_chunks(r: int) -> list:
    return [rc for rc in range(1, r + 1)
            if r % rc == 0 and (rc == r or rc % sqrtn.ROW_CHUNK_FLOOR == 0)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--geometry", action="store_true")
    ap.add_argument("--entry-size", type=int, default=16)
    ap.add_argument("others", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pkt_times: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261017)

    def rnd(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int64,
                             device=dev, generator=gen).to(torch.int32)

    others = {name: [] for name in ENTRIES}
    for so in args.others:
        source = Path(so).name.split("-")[0]
        others[source].append(("other %d" % len(others[source]),
                               load_entry(so, source, ENTRIES[source])))
    smi = gpu_name_and_power()
    e = args.entry_size
    rows = []

    def timed(name, point, label, geometry, call, want, kernel):
        got = call()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("%s %s, %s library: differs from the plain "
                                 "version" % (name, point, label))
        ms = profiled_ms({name: (call, kernel)})[name]
        rows.append(dict(instance=name, point=point, entry_size=e,
                         library=label, geometry=geometry, ms=ms))
        print("  %-22s G=%-5d n=%-6d E=%-3d %-8s %-16s ms %.4f  bit-equal"
              % (name, point[0], point[1], e, label, geometry, ms),
              flush=True)

    for g, n in POINTS:
        tables = rnd(g, n, e)
        fr, cw1, cw2 = rnd(g, 1, 4), rnd(g, 64, 4), rnd(g, 64, 4)
        for name, radix, prf in K2_CASES:
            sched = _schedule(n, radix)
            lg = (ctypes.c_int * len(sched))(*(a.bit_length() - 1
                                               for a, _ in sched))
            off = (ctypes.c_int * len(sched))(*(o for _, o in sched))

            def k2(fn, cb, sched=sched, lg=lg, off=off, prf=prf):
                out = torch.zeros((g, e), dtype=torch.int32, device=dev)
                code = fn(fr.data_ptr(), cw1.data_ptr(), cw2.data_ptr(),
                          tables.data_ptr(), out.data_ptr(), g, 1,
                          len(sched), lg, off, 0, cb.bit_length() - 1, e,
                          prf, 1, torch.cuda.current_stream().cuda_stream)
                if code != 0:
                    raise RuntimeError("subtree_contract_launch: CUDA error "
                                       "%d" % code)
                return out
            ars = tuple(a for a, _ in sched)
            mine = subtree.pkt_block_leaves(g, ars)
            want = subtree._contract_plain(
                fr, cw1, cw2, tables, sched, 0,
                subtree._suffix_chunk(ars, mine)[0], mine, prf)
            this = getattr(cuda_build.library("subtree"),
                           ENTRIES["subtree"])
            if args.geometry:
                turns = [("this", this, cb) for cb in k2_legal_blocks(n,
                                                                      radix)]
            else:
                old = [(label, fn, min(n, subtree.MAX_BLOCK_LEAVES))
                       for label, fn in others["subtree"]]
                turns = old + [("this", this, mine)] * 2 + old[::-1]
            for label, fn, cb in turns:
                timed(name, (g, n), label, "block %d" % cb,
                      lambda fn=fn, cb=cb: k2(fn, cb), want, "subtree")
        k, r = sqrtn.default_split(n)
        seeds, c1, c2 = rnd(g, k, 4), rnd(g, r, 4), rnd(g, r, 4)
        for name, prf in K4_CASES:
            def k4(fn, rc, prf=prf):
                out = torch.zeros((g, e), dtype=torch.int32, device=dev)
                code = fn(seeds.data_ptr(), seeds.stride(0), c1.data_ptr(),
                          c2.data_ptr(), c1.stride(0), tables.data_ptr(),
                          out.data_ptr(), g, k, r, rc, e, 0, prf, 1,
                          torch.cuda.current_stream().cuda_stream)
                if code != 0:
                    raise RuntimeError("sqrt_grid_launch: CUDA error %d"
                                       % code)
                return out
            mine = sqrt_grid.pkt_row_chunk(r, k)
            want = sqrt_grid.sqrt_grid_contract_plain(
                seeds, c1, c2, tables, prf_method=prf, row_chunk=mine)
            this = getattr(cuda_build.library("sqrt_grid"),
                           ENTRIES["sqrt_grid"])
            if args.geometry:
                turns = [("this", this, rc) for rc in k4_legal_chunks(r)]
            else:
                rc_old = sqrt_grid.sqrt_row_chunk(
                    r, k, sqrtn.clamp_row_chunk(None, r, k, g))
                old = [(label, fn, rc_old)
                       for label, fn in others["sqrt_grid"]]
                turns = old + [("this", this, mine)] * 2 + old[::-1]
            for label, fn, rc in turns:
                timed(name, (g, n), label, "rows %d" % rc,
                      lambda fn=fn, rc=rc: k4(fn, rc), want, "sqrt_grid")
        del tables, fr, cw1, cw2, seeds, c1, c2
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"pkt_times": rows, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
