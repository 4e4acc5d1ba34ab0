"""Instructions per node of K1, counted from its SASS.

Runs ``cuobjdump -sass`` (CUDA toolkit) on the built ``aes_level``
library and reads each ``aes_level_kernel<A>`` instance: the
grid-stride loop (one node per iteration) and the AES rounds loop inside
it.  The rounds loop runs as often as makes the node's shared-memory
loads (LDS) equal the lookups AES-128 needs (a key schedule of 40 and A
blocks of 160), so the instructions a node issues are the grid-stride
body plus the rounds body times its further trips.  Static counts: both
sides of a branch inside the body are counted, so the result is a few
instructions high.  Needs the card's toolkit:

    python -m dpf_tpu_torch.utils.sass_count
"""

from __future__ import annotations

import json
import re
import subprocess
from pathlib import Path

from ..ops import cuda_build

_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA\s+(?:`\(\S+\)\s*)?0x([0-9a-f]+)")


def parse_sass(text: str) -> dict:
    """{function name: [(address, instruction text), ...]} of a
    ``cuobjdump -sass`` listing."""
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
        elif cur is not None:
            m = _INSTR.match(line)
            if m:
                cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def sass_functions(lib: Path) -> dict:
    """The functions of one built library, by ``cuobjdump -sass``."""
    cuobjdump = Path(cuda_build.nvcc_path()).parent / "cuobjdump"
    return parse_sass(subprocess.run(
        [str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
        check=True).stdout)


def loops(instrs) -> list:
    """(first, last) addresses of each backward branch's loop."""
    out = []
    for addr, text in instrs:
        m = _BRA.search(text)
        if m and int(m.group(1), 16) < addr:
            out.append((int(m.group(1), 16), addr))
    return out


def _body(instrs, lo, hi):
    body = [t for a, t in instrs if lo <= a <= hi]
    return len(body), sum(1 for t in body if re.search(r"\bLDS\b", t))


def per_node(instrs, lookups: int) -> dict:
    """Instructions and LDS per node of one K1 instance."""
    found = loops(instrs)
    if not found:
        raise ValueError("no loop in the listing")
    outer = max(found, key=lambda lp: lp[1] - lp[0])   # the grid-stride loop
    inner = [lp for lp in found if outer[0] < lp[0] and lp[1] < outer[1]]
    n_out, lds_out = _body(instrs, *outer)
    if not inner:
        return {"instructions": n_out, "lds": lds_out, "round_loop": None}
    n_in, lds_in = _body(instrs, *max(inner, key=lambda lp: lp[1] - lp[0]))
    extra = (lookups - lds_out) // lds_in if lds_in else 0
    return {"instructions": n_out + extra * n_in,
            "lds": lds_out + extra * lds_in,
            "round_loop": {"instructions": n_in, "lds": lds_in,
                           "trips": extra + 1}}


def k1_counts() -> dict:
    """Per-node counts of K1 at arity 2 and 4 from the built library."""
    cuda_build.build(("aes_level",))
    out = {}
    for name, instrs in sass_functions(
            cuda_build.library_path("aes_level")).items():
        m = re.search(r"aes_level_kernelILi(\d)E", name)
        if m:
            arity = int(m.group(1))
            out["arity %d" % arity] = per_node(instrs, 40 + 160 * arity)
    return out


if __name__ == "__main__":
    print(json.dumps(k1_counts()))
