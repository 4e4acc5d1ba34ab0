"""K1's time at the main paths' widest levels, for this tree's build of
``csrc/aes_level.cu`` and, if given, other builds with the same C entry
(for example a parent commit's).

Times one level at B = 512: w = 2^17 -> 2^18 at arity 2 (the binary AES
path at N = 2^20) and w = 2^16 -> 2^18 at arity 4 (the radix-4 AES
path), each in the full store and the low-limb store (the last level of
a frontier group).  Each library's result is held bit for bit against
the plain version before it is timed; with other libraries all are
timed in turns, the others, this tree's twice, the others again, in
``ROUNDS`` rounds.  Needs one CUDA card and the toolkit:

    python -m dpf_tpu_torch.utils.k1_times [other aes_level library ...]
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from ..ops import aes_level
from .bench import held_ms, libraries_in_turns

SHAPES = ((512, 1 << 17, 2), (512, 1 << 16, 4))
ROUNDS = 3


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_times: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261018)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    def rnd(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int64,
                             device=dev, generator=gen).to(torch.int32)

    libs = libraries_in_turns("aes_level", "aes_level_launch", sys.argv[1:])

    def launch(fn, seeds, c1, c2, arity, low32):
        bsz, w, _ = seeds.shape
        shape = (bsz, arity * w) if low32 else (bsz, arity * w, 4)
        out = torch.empty(shape, dtype=torch.int32, device=dev)
        code = fn(seeds.data_ptr(), c1.data_ptr(), c2.data_ptr(),
                  c1.stride(0), out.data_ptr(), bsz, w, arity, int(low32),
                  torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError("aes_level_launch: CUDA error %d" % code)
        return out

    rows = []
    for bsz, w, arity in SHAPES:
        seeds = rnd(bsz, w, 4)
        cw1, cw2 = rnd(bsz, arity, 4), rnd(bsz, arity, 4)
        for low32 in (False, True):
            want = aes_level.aes_level_step_plain(seeds, cw1, cw2, arity,
                                                  low32=low32)
            form = "low32" if low32 else "full"
            for r in range(ROUNDS):
                for label, ms in held_ms(
                        libs, lambda fn: launch(fn, seeds, cw1, cw2, arity,
                                                low32),
                        want, 10, "arity %d %s" % (arity, form)):
                    rows.append({"shape": [bsz, w], "arity": arity,
                                 "form": form, "round": r,
                                 "library": label, "ms": ms})
                    print("  arity %d [%d, %d] %-5s round %d %-8s ms %.4f  "
                          "bit-equal" % (arity, bsz, w, form, r, label, ms),
                          flush=True)
            del want
        del seeds, cw1, cw2
    print(smi)
    print(json.dumps({"k1_times": rows, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
