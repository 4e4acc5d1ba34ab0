"""Instructions per node of K1, per leaf of K2 and per call of K7,
counted from SASS.

Runs ``cuobjdump -sass`` (CUDA toolkit) on a built library.

K1 (``aes_level``): each ``aes_level_kernel<A, kLow>`` instance's
grid-stride loop (one node per iteration) and the AES rounds loop inside
it, for the full store ("arity A") and the low-limb store ("arity A
low32").  The
rounds loop runs as often as makes the node's shared-memory loads (LDS)
equal the lookups AES-128 needs (a key schedule of 40 and A blocks of
160), so the instructions a node issues are the grid-stride body plus
the rounds body times its further trips.

K2 (``subtree``): each ``subtree_kernel<PRF, BIN>`` instance's
expansion and contraction.  The expansion's node is the depth-first
level loop, the last innermost loop that holds a cipher core (for the
radix-4 Salsa/ChaCha instances the child loop inside it, run a = 4
times); a binary tree expands one node per leaf, a radix-4 tree one per
3 leaves.  The contraction is the loop that loads table values (LDG) and
leaves (LDS) and multiplies them (IMAD); each leaf it loads (a 32-bit
word of an LDS) meets one table value, so its leaf words per trip are
its leaf-by-column products.  Each count is split by pipe: the INT32
pipe (``ALU_OPS``), half the issue rate, and the FMA pipe (every
``IMAD`` form), the other half.

K2's per-key kernel (``subtree_pkt_kernel<PRF, BIN>``, or a build's
``subtree_kernel<PRF, BIN, true>`` from when the per-key mode was a
flag of the shared kernel) counts under ``"prf P binary|radix-4
per-key"``; its contraction's leaf word meets a 16-byte quad of
columns, four products.

Static counts: both sides of a branch inside a body are counted, and
the loop bookkeeping around a node or a product is left out, so each
result is a few instructions off.

K7 (``prf_zoo``): each ``prf_zoo_kernel<C>`` instance's grid-stride
loop, one seed a trip.  Its cores are unrolled, so the loop is the whole
call (its loads and stores included): what the card executes for it.

``same_code(other)`` holds the shared-table instances of K2 and K4 in
this tree's build against another build of the same source (a parent
commit's): each must keep every instruction.  The other build's
instances may carry a last ``bool`` per-key flag (the builds in which
the per-key mode was a template flag of the shared kernels): its
``false`` instances are the shared ones, its ``true`` instances are
left out.  Needs the card's toolkit:

    python -m dpf_tpu_torch.utils.sass_count [subtree library]
    python -m dpf_tpu_torch.utils.sass_count --same-as LIBRARY [...]
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

from ..ops import cuda_build

_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA\s+(?:`\(\S+\)\s*)?0x([0-9a-f]+)")
# opcodes issued to the INT32 (ALU) pipe
ALU_OPS = frozenset(("IADD3", "LOP3", "SHF", "PRMT", "LEA", "ISETP", "SEL",
                     "IMNMX"))
# a loop whose body has this many funnel shifts (rotations) holds a
# cipher core: a Salsa/ChaCha-12 block rotates 192 words, ChaCha 96 of
# them by funnel shift
CORE_SHF = 64


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


def opcode(text: str) -> str:
    """``@!P0 IMAD.MOV.U32 R1, ...`` -> ``IMAD``."""
    return text.split()[1 if text.startswith("@") else 0].split(".")[0]


def _leaf_words(text: str) -> int:
    """32-bit words an LDS loads (LDS, LDS.64, LDS.128), else 0."""
    op = text.split()[1 if text.startswith("@") else 0].split(".")
    if op[0] != "LDS":
        return 0
    bits = [int(m) for m in op[1:] if m.isdigit()]
    return bits[0] // 32 if bits else 1


def pipe_mix(texts) -> dict:
    """Instructions and how many go to the ALU and the FMA pipe."""
    ops = [opcode(t) for t in texts]
    return {"instructions": len(ops),
            "alu": sum(o in ALU_OPS for o in ops),
            "fma": sum(o == "IMAD" for o in ops)}


def _scaled(mix: dict, by: float) -> dict:
    return {k: v * by for k, v in mix.items()}


def _sum(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def _with_shares(mix: dict) -> dict:
    n = mix["instructions"]
    return {**mix, "alu_share": mix["alu"] / n, "fma_share": mix["fma"] / n}


def subtree_per_leaf(instrs, child_loop: bool, arity: int,
                     columns: int = 1) -> dict:
    """Expansion instructions per node and per leaf, contraction
    instructions per leaf-by-column product, each with its pipe split,
    of one K2 instance.  ``child_loop``: the instance expands a node's
    children in a loop of one core block each (radix-4 Salsa/ChaCha);
    ``columns``: the columns a loaded leaf word meets."""
    found = loops(instrs)

    def body(lp):
        return [t for a, t in instrs if lp[0] <= a <= lp[1]]

    def has(lp, op):
        return any(opcode(t) == op for t in body(lp))

    con = [lp for lp in found
           if has(lp, "LDG") and has(lp, "LDS") and has(lp, "IMAD")
           and not has(lp, "STS") and not has(lp, "BAR")]
    cipher = [lp for lp in found
              if sum(opcode(t) == "SHF" for t in body(lp)) >= CORE_SHF]
    if not con or not cipher:
        raise ValueError("no contraction or no cipher loop in the listing")
    con = max(con, key=lambda lp: sum(map(_leaf_words, body(lp))))
    products = columns * sum(map(_leaf_words, body(con)))
    inner = [lp for lp in cipher
             if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1]
                        for o in cipher)]
    core = max(inner, key=lambda lp: lp[1])
    node = pipe_mix(body(core))
    if child_loop:
        level = min((lp for lp in found if lp != core and lp[0] <= core[0]
                     and core[1] <= lp[1]), key=lambda lp: lp[1] - lp[0])
        node = _sum(pipe_mix(body(level)), _scaled(node, arity - 1))
    return {"expansion_per_node": _with_shares(node),
            "expansion_per_leaf": _with_shares(_scaled(node,
                                                       1 / (arity - 1))),
            "contraction_per_product": _with_shares(
                _scaled(pipe_mix(body(con)), 1 / products)),
            "products_per_trip": products}


def k2_counts(lib: Path | None = None) -> dict:
    """Per-leaf counts of every K2 instance of a built ``subtree``
    library (this tree's by default), by ``"prf P binary|radix-4"``."""
    if lib is None:
        cuda_build.build(("subtree",))
        lib = cuda_build.library_path("subtree")
    out = {}
    for name, instrs in sass_functions(Path(lib)).items():
        m = re.search(r"subtree(_pkt)?_kernelILi(\d)ELb([01])E"
                      r"(?:Lb([01])E)?E", name)
        if m:
            prf, binary = int(m.group(2)), m.group(3) == "1"
            pkt = m.group(1) is not None
            key = "prf %d %s%s" % (prf, "binary" if binary else "radix-4",
                                   " per-key" if pkt or m.group(4) == "1"
                                   else "")
            out[key] = subtree_per_leaf(instrs, not binary and prf in (1, 2),
                                        2 if binary else 4, 4 if pkt else 1)
    return out


# a kernel's template argument list in a mangled name: I, then each
# argument as L<type letter><value>E, then E
_TEMPLATE_ARGS = re.compile(r"((?:subtree|sqrt_grid)_kernelI(?:L[a-z]\d+E)+)E")
# nvcc names an anonymous namespace after a digest of its source file,
# which changes with any edit of the file
_ANON_NS = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")


def same_code(other: Path, source: str | None = None) -> dict:
    """For each shared-table K2 or K4 kernel instance of ``other`` (a
    build of ``subtree.cu`` or ``sqrt_grid.cu``), this tree's instance
    of the same template arguments: ``{other's function name:
    {"instructions": n, "same": bool}}``, ``same`` when every
    instruction's text is equal.  A last per-key flag in ``other``'s
    arguments is dropped when false and its instance left out when true
    (see above).  ``source`` defaults to the stem of ``other``'s file
    name."""
    source = source or Path(other).name.split("-")[0]
    cuda_build.build((source,))
    mine = {_ANON_NS.sub("", name): instrs for name, instrs in
            sass_functions(cuda_build.library_path(source)).items()}
    out = {}
    for name, instrs in sass_functions(Path(other)).items():
        m = _TEMPLATE_ARGS.search(name)
        if not m:
            continue
        bare = _ANON_NS.sub("", name)
        args = m.group(1)
        flagless = bare.replace(args + "E", args[:-4] + "E", 1)
        twin = mine.get(bare)
        if twin is None and args.endswith(("Lb0E", "Lb1E")) and \
                flagless in mine:
            if args.endswith("Lb1E"):
                continue                 # a per-key instance of the flag
            twin = mine[flagless]
        out[name] = {"instructions": len(instrs),
                     "same": twin is not None
                     and [t for _, t in twin] == [t for _, t in instrs]}
    return out


def k1_counts() -> dict:
    """Per-node counts of K1 at arity 2 and 4, each store form, from the
    built library."""
    cuda_build.build(("aes_level",))
    out = {}
    for name, instrs in sass_functions(
            cuda_build.library_path("aes_level")).items():
        m = re.search(r"aes_level_kernelILi(\d)ELb([01])E", name)
        if m:
            arity = int(m.group(1))
            key = "arity %d%s" % (arity, " low32" if m.group(2) == "1"
                                  else "")
            out[key] = per_node(instrs, 40 + 160 * arity)
    return out


def k7_counts() -> dict:
    """Instructions of each K7 instance's grid-stride loop, one seed a
    trip (the whole call, its loads and stores included), with their
    pipe split, by candidate id, from the built library."""
    cuda_build.build(("prf_zoo",))
    out = {}
    for name, instrs in sass_functions(
            cuda_build.library_path("prf_zoo")).items():
        m = re.search(r"prf_zoo_kernelILi(\d+)E", name)
        if m:
            found = loops(instrs)
            if not found:
                raise ValueError("no loop in %s" % name)
            lo, hi = max(found, key=lambda lp: lp[1] - lp[0])
            out[int(m.group(1))] = pipe_mix(
                [t for a, t in instrs if lo <= a <= hi])
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == ["--same-as"]:
        res = {str(lib): same_code(Path(lib)) for lib in sys.argv[2:]}
        print(json.dumps(res))
        sys.exit(0 if all(r and all(v["same"] for v in r.values())
                          for r in res.values()) else 1)
    if len(sys.argv) > 1:
        print(json.dumps(k2_counts(Path(sys.argv[1]))))
    else:
        print(json.dumps({"K1": k1_counts(), "K2": k2_counts(),
                          "K7": k7_counts()}))
