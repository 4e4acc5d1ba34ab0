"""K3's time at the main paths' shapes, for this tree's build of
``csrc/contract.cu`` and, if given, other builds with the same C entry
(for example a parent commit's).

Times the contraction ``[B, K] x [K, 16]`` at B = 512 for K = 2^16
(N = 65536) and 2^18 (one frontier group at N = 2^20), on the contiguous
plane of low limbs the AES path hands it and on the strided low limbs
of ``[B, K, 4]`` leaves (DUMMY's binary path), and at the short batches
B = 1 and 8 at K = 2^18 (the server pads a batch to a power of two).
Each library's result is held bit for bit against the plain version
before it is timed; with other libraries all are timed in turns, the
others, this tree's twice, the others again.  Needs one CUDA card and
the toolkit:

    python -m dpf_tpu_torch.utils.k3_times [other contract library ...]
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from ..ops import matmul128
from .bench import held_ms, libraries_in_turns

SHAPES = ((512, 1 << 16), (512, 1 << 18), (1, 1 << 18), (8, 1 << 18))


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_times: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261017)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    def rnd(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int64,
                             device=dev, generator=gen).to(torch.int32)

    libs = libraries_in_turns("contract", "contract_i32_launch",
                              sys.argv[1:])

    def launch(fn, a, t):
        out = torch.zeros((a.shape[0], t.shape[1]), dtype=torch.int32,
                          device=dev)
        code = fn(a.data_ptr(), a.stride(0), a.stride(1), t.data_ptr(),
                  out.data_ptr(), a.shape[0], a.shape[1], t.shape[1], sms,
                  torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError("contract_i32_launch: CUDA error %d" % code)
        return out

    rows = []
    for bsz, k in SHAPES:
        leaves = rnd(bsz, k, 4)
        t = rnd(k, 16)
        forms = [("contiguous", leaves[..., 0].contiguous())]
        if bsz == 512:
            forms.append(("strided", leaves[..., 0]))
        want = matmul128.dot_i32_plain(forms[0][1], t)
        for form, a in forms:
            for label, ms in held_ms(libs, lambda fn: launch(fn, a, t), want,
                                     20, "[%d, %d] %s" % (bsz, k, form)):
                rows.append({"shape": [bsz, k], "form": form,
                             "library": label, "ms": ms})
                print("  [%d, %d] %-10s %-8s ms %.4f  bit-equal"
                      % (bsz, k, form, label, ms), flush=True)
        del leaves, t, forms, want
    print(smi)
    print(json.dumps({"k3_times": rows, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
