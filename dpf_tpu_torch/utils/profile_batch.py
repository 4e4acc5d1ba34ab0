"""Where one batch's time goes on the card: device time per kernel.

Runs one warm ``DPF.eval_gpu`` batch per configuration under
``torch.profiler`` (CPU + CUDA activities) and prints, per
configuration, the wall time of the batch, the device time summed per
kernel name, the device busy share (summed kernel time over wall time;
kernels do not overlap on one stream) and the host time (wall minus
device).  Needs a CUDA card:

    python -m dpf_tpu_torch.utils.profile_batch

Prints one JSON line per configuration and the card's name and power
limit; when the profiler records no device time it says so rather than
printing a number.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

# (prf id, N, radix, scheme): the full-width and headline configurations,
# the stream ciphers in both trees, and the sqrt-N grid
CONFIGS = (
    (3, 1 << 20, 2, "logn"), (2, 1 << 20, 2, "logn"),
    (3, 1 << 16, 2, "logn"), (5, 1 << 20, 2, "logn"),
    (3, 1 << 20, 4, "logn"), (2, 1 << 20, 4, "logn"),
    (5, 1 << 20, 4, "logn"), (3, 1 << 16, 4, "logn"),
    (3, 1 << 20, 2, "sqrtn"), (5, 1 << 20, 2, "sqrtn"),
    (2, 1 << 20, 2, "sqrtn"), (3, 1 << 16, 2, "sqrtn"))


def _device_us(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_config(prf: int, n: int, radix: int = 2, scheme: str = "logn",
                   batch: int = 512, entry: int = 16,
                   distinct: int = 16) -> dict:
    from ..api import DPF
    from .config import EvalConfig
    dpf = DPF(prf=prf, config=EvalConfig(radix=radix, scheme=scheme))
    table = np.random.default_rng(1).integers(0, 2 ** 31, (n, entry),
                                              dtype=np.int32)
    dpf.eval_init(table)
    keys = [dpf.gen((i * 0x9E3779B1) % n, n, seed=b"prof%d" % i)[0]
            for i in range(distinct)]
    keys = [keys[i % distinct] for i in range(batch)]
    dpf.eval_gpu(keys)              # warm: builds, first launches
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        dpf.eval_gpu(keys)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and getattr(evt, "device_type", None) is not None and \
                str(evt.device_type).endswith("CUDA"):
            kernels[evt.key] = {"ms": us / 1e3, "count": evt.count}
    device_ms = sum(k["ms"] for k in kernels.values())
    return {
        "prf": dpf.prf_method_string, "scheme": scheme, "radix": radix,
        "N": n, "E": entry,
        "B": batch,
        "wall_ms": wall_ms,
        "device_ms": device_ms if kernels else None,
        "host_ms": wall_ms - device_ms if kernels else None,
        "busy_share": device_ms / wall_ms if kernels else None,
        "kernels": dict(sorted(kernels.items(),
                               key=lambda kv: -kv[1]["ms"])),
        "note": None if kernels else "profiler recorded no device time",
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_batch needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    for prf, n, radix, scheme in CONFIGS:
        print(json.dumps(profile_config(prf, n, radix, scheme)), flush=True)
    print(smi)


if __name__ == "__main__":
    main()
