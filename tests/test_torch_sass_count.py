"""``utils/sass_count``: K1's instructions per node and K2's per leaf
read from a SASS listing.  The listings here are small hand-made ones in
``cuobjdump -sass``'s format (no toolkit on the CPU); ``chip_smoke.py``
runs the same code on the card's build."""

import importlib.util
from pathlib import Path

import pytest

from dpf_tpu_torch.utils import sass_count

# a fill loop (0x10-0x30), then a grid-stride loop (0x40-0xd0) holding a
# rounds loop (0x60-0xa0) with 2 LDS an iteration and 1 LDS outside it
LISTING = """
	code for sm_90a
		Function : _ZN2k16aes_level_kernelILi2EEEvPK5uint4
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;  /* 0x0 */
        /*0010*/                   STS [R7], R6 ;  /* 0x0 */
        /*0020*/                   IADD3 R5, R5, 0x100, RZ ;  /* 0x0 */
        /*0030*/              @!P0 BRA 0x10 ;  /* 0x0 */
        /*0040*/                   LDG.E.128 R8, [R2.64] ;  /* 0x0 */
        /*0050*/                   LDS R11, [R11+UR6] ;  /* 0x0 */
        /*0060*/                   PRMT R12, R8, 0x5504, R10 ;  /* 0x0 */
        /*0070*/                   LDS R12, [R12+UR6] ;  /* 0x0 */
        /*0080*/                   LDS R13, [R13+UR6] ;  /* 0x0 */
        /*0090*/                   LOP3.LUT R8, R12, R13, RZ, 0x3c, !PT ;  /* 0x0 */
        /*00a0*/               @P1 BRA 0x60 ;  /* 0x0 */
        /*00b0*/                   STG.E.128 [R4.64], R8 ;  /* 0x0 */
        /*00c0*/                   IADD3 R0, R0, UR4, RZ ;  /* 0x0 */
        /*00d0*/               @P2 BRA 0x40 ;  /* 0x0 */
        /*00e0*/                   EXIT ;  /* 0x0 */
        /*00f0*/                   BRA 0xf0;  /* 0x0 */
		Function : other
        /*0000*/                   EXIT ;  /* 0x0 */
"""


def test_parse_sass_splits_functions():
    funcs = sass_count.parse_sass(LISTING)
    name = "_ZN2k16aes_level_kernelILi2EEEvPK5uint4"
    assert list(funcs) == [name, "other"]
    assert funcs[name][0] == (0, "LDC R1, c[0x0][0x28]")
    assert funcs[name][-1] == (0xf0, "BRA 0xf0")
    assert funcs["other"] == [(0, "EXIT")]


def test_loops_are_backward_branches_only():
    instrs = next(iter(sass_count.parse_sass(LISTING).values()))
    assert sass_count.loops(instrs) == [(0x10, 0x30), (0x60, 0xa0),
                                        (0x40, 0xd0)]


@pytest.mark.parametrize("lookups,trips", [(3, 1), (5, 2), (11, 5)])
def test_per_node_takes_rounds_trips_from_the_lookups(lookups, trips):
    instrs = next(iter(sass_count.parse_sass(LISTING).values()))
    got = sass_count.per_node(instrs, lookups)
    # grid-stride body: 10 instructions, 3 LDS; rounds body: 5 and 2
    assert got == {"instructions": 10 + 5 * (trips - 1),
                   "lds": 3 + 2 * (trips - 1),
                   "round_loop": {"instructions": 5, "lds": 2,
                                  "trips": trips}}


def test_per_node_needs_a_loop():
    instrs = sass_count.parse_sass(LISTING)["other"]
    with pytest.raises(ValueError):
        sass_count.per_node(instrs, 360)


# K2: a hand-made subtree_kernel listing.  A cipher core of 70 funnel
# shifts, 10 adds and 5 moves; a walk loop around one core; a depth-first
# level loop (3 instructions of its own, a store, a branch) around either
# a child loop of one core or one core inline; a contraction loop of one
# table load, two 16-byte leaf loads and 8 multiply-adds.
CORE = (["SHF.L.W.U32.HI R1, R1, 0x7, R1"] * 70
        + ["IADD3 R1, R1, R2, RZ"] * 10 + ["IMAD.MOV.U32 R3, RZ, RZ, R4"] * 5)
LEVEL = ["IADD3 R6, R6, 0x1, RZ", "LOP3.LUT R7, R7, 0x1, RZ, 0xc0, !PT",
         "IMAD.MOV.U32 R8, RZ, RZ, R9"]
CONTRACT = (["LDG.E.CONSTANT R4, desc[UR16][R2.64]", "LDS.128 R8, [R5]",
             "LDS.128 R12, [R5+0x10]"] + ["IMAD R20, R8, R4, R20"] * 8
            + ["IADD3 R5, R5, 0x20, RZ", "ISETP.GE.AND P0, PT, R5, R6, PT"])


def _k2_listing(name, child_loop):
    """cuobjdump-style text of one function; ("loop", body) entries close
    with a backward branch to their first instruction."""
    def loop(body):
        return [("start",)] + body + [("bra",)]

    core = loop(CORE) if child_loop else CORE
    parts = (["LDC R1, c[0x0][0x28]"] + loop(CORE)
             + loop(LEVEL + core + ["STL [R1], R2"]) + loop(CONTRACT)
             + ["EXIT"])
    lines, starts, addr = ["\t\tFunction : %s" % name], [], 0
    for t in parts:
        if t == ("start",):
            starts.append(addr)
            continue
        if t == ("bra",):
            t = "@P0 BRA 0x%x" % starts.pop()
        lines.append("        /*%04x*/                   %s ;  /* 0x0 */"
                     % (addr, t))
        addr += 16
    return "\n".join(lines) + "\n"


def test_opcode_strips_predicates_and_modifiers():
    assert sass_count.opcode("@!P0 IMAD.MOV.U32 R1, RZ, RZ, R2") == "IMAD"
    assert sass_count.opcode("SHF.L.W.U32.HI R1, R1, 0x7, R1") == "SHF"
    assert sass_count.pipe_mix(CONTRACT) == {"instructions": 13, "alu": 2,
                                             "fma": 8}


@pytest.mark.parametrize("child_loop", [False, True])
def test_subtree_per_leaf(child_loop):
    name = "_ZN2k214subtree_kernelILi%dELb0EEEvPKj" % (2 if child_loop
                                                         else 5)
    instrs = sass_count.parse_sass(_k2_listing(name, child_loop))[name]
    got = sass_count.subtree_per_leaf(instrs, child_loop, 4)
    # the level loop: its 3 + store + branch and one core (+ a branch
    # when the core is a loop of its own, run 3 more times)
    core = {"instructions": 85 + child_loop, "alu": 80, "fma": 5}
    node = {"instructions": 5 + core["instructions"], "alu": 82,
            "fma": 6}
    if child_loop:
        node = {k: node[k] + 3 * core[k] for k in node}
    assert {k: got["expansion_per_node"][k] for k in node} == node
    assert got["expansion_per_leaf"]["instructions"] == \
        pytest.approx(node["instructions"] / 3)
    # 14 instructions (with the branch) for 8 leaf words
    assert got["products_per_trip"] == 8
    assert got["contraction_per_product"]["instructions"] == 14 / 8
    assert got["contraction_per_product"]["alu_share"] == 2 / 14
    assert got["contraction_per_product"]["fma_share"] == 8 / 14


def test_subtree_per_leaf_needs_both_loops():
    instrs = sass_count.parse_sass(LISTING)["other"]
    with pytest.raises(ValueError):
        sass_count.subtree_per_leaf(instrs, False, 2)


def test_k2_counts_names_each_instance(monkeypatch):
    names = ["_ZN2k214subtree_kernelILi2ELb1EEEvPKj",
             "_ZN2k214subtree_kernelILi5ELb0EEEvPKj"]
    text = _k2_listing(names[0], False) + _k2_listing(names[1], False)
    monkeypatch.setattr(sass_count, "sass_functions",
                        lambda lib: sass_count.parse_sass(text))
    got = sass_count.k2_counts("lib.so")
    assert sorted(got) == ["prf 2 binary", "prf 5 radix-4"]
    # a binary tree expands one node per leaf, a radix-4 tree one per 3
    assert got["prf 2 binary"]["expansion_per_leaf"]["instructions"] == 90
    assert got["prf 5 radix-4"]["expansion_per_leaf"]["instructions"] == \
        pytest.approx(30)


def test_k1_counts_names_each_store_form(monkeypatch):
    """K1's full and low-limb instances are counted apart."""
    funcs = sass_count.parse_sass(LISTING)
    instrs = funcs["_ZN2k16aes_level_kernelILi2EEEvPK5uint4"]
    names = ["_ZN2k16aes_level_kernelILi2ELb0EEEvPK5uint4",
             "_ZN2k16aes_level_kernelILi4ELb1EEEvPK5uint4PKj", "other"]
    monkeypatch.setattr(sass_count.cuda_build, "build", lambda names: {})
    monkeypatch.setattr(sass_count, "sass_functions",
                        lambda lib: {n: instrs for n in names})
    got = sass_count.k1_counts()
    assert sorted(got) == ["arity 2", "arity 4 low32"]
    # the rounds loop runs until the LDS equal K1's lookups a node
    assert got["arity 2"]["lds"] == 3 + 2 * ((333 - 3) // 2)
    assert got["arity 4 low32"]["lds"] == 3 + 2 * ((599 - 3) // 2)


@pytest.mark.parametrize("arity,lookups", [(2, 333), (4, 599)])
def test_k1_lookups_share_rounds_one_and_two(arity, lookups):
    """A key schedule of 40 and A blocks of 160, less the 27 lookups of
    rounds 1 and 2 that each plaintext after the first shares."""
    assert sass_count.k1_lookups(arity) == lookups
    assert lookups == 40 + 160 * arity - 27 * (arity - 1)
    # chip_smoke.py prices K1's lookup floor with the same count
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.k1_node_work(arity)[1] == lookups


def test_k2_counts_names_the_per_key_instances(monkeypatch):
    """The per-key kernel, or the per-key flag of a build that had one as
    a third template argument: its instances count apart from the
    shared-table ones, a leaf word of the per-key kernel meeting four
    columns."""
    names = ["_ZN2k214subtree_kernelILi2ELb1ELb0EEEvPKj",
             "_ZN2k214subtree_kernelILi2ELb1ELb1EEEvPKj",
             "_ZN2k214subtree_kernelILi5ELb0ELb1EEEvPKj",
             "_ZN2k218subtree_pkt_kernelILi4ELb1EEEvPKj"]
    text = "".join(_k2_listing(n, False) for n in names)
    monkeypatch.setattr(sass_count, "sass_functions",
                        lambda lib: sass_count.parse_sass(text))
    got = sass_count.k2_counts("lib.so")
    assert sorted(got) == [
        "prf 2 binary", "prf 2 binary per-key", "prf 4 binary per-key",
        "prf 5 radix-4 per-key"]
    assert got["prf 4 binary per-key"]["products_per_trip"] == 4 * 8


def test_same_code_pairs_each_instance_with_its_shared_twin(monkeypatch):
    """Another build against this tree's: each of its shared-table K2 and
    K4 instances is held against this tree's instance of the same
    arguments, instruction for instruction, whatever digest of its
    source names the anonymous namespace.  A build whose shared kernels
    carried the per-key flag pairs its false instances and leaves its
    true ones out; a build without the flag pairs as it is."""
    instrs = sass_count.parse_sass(LISTING)[
        "_ZN2k16aes_level_kernelILi2EEEvPK5uint4"]
    old_ns = "_ZN43_GLOBAL__N__2051430a_10_subtree_cu_0123abcd"
    new_ns = "_ZN43_GLOBAL__N__5e1f0a2b_10_subtree_cu_f8e2f0de"
    other = {old_ns + "14subtree_kernelILi2ELb1ELb0EEEvPKj": instrs,
             old_ns + "14subtree_kernelILi2ELb1ELb1EEEvPKj": instrs[:3],
             "_ZN2k216sqrt_grid_kernelILi3ELb0EEEvPKj": instrs,
             "_ZN2k216sqrt_grid_kernelILi3ELb1EEEvPKj": instrs[:2],
             "_ZN2k216sqrt_grid_kernelILi5EEEvPKj": instrs,
             "other": instrs}
    mine = {new_ns + "14subtree_kernelILi2ELb1EEEvPKj": instrs,
            new_ns + "18subtree_pkt_kernelILi2ELb1EEEvPKj": instrs[:3],
            "_ZN2k216sqrt_grid_kernelILi3EEEvPKj": instrs,
            "_ZN2k216sqrt_grid_kernelILi5EEEvPKj": instrs[1:]}
    monkeypatch.setattr(sass_count.cuda_build, "build", lambda names: {})
    monkeypatch.setattr(sass_count, "sass_functions",
                        lambda lib: other if str(lib) == "old.so" else mine)
    got = sass_count.same_code("old.so", "subtree")
    assert got == {
        old_ns + "14subtree_kernelILi2ELb1ELb0EEEvPKj":
            {"instructions": len(instrs), "same": True},
        "_ZN2k216sqrt_grid_kernelILi3ELb0EEEvPKj":
            {"instructions": len(instrs), "same": True},
        "_ZN2k216sqrt_grid_kernelILi5EEEvPKj":
            {"instructions": len(instrs), "same": False}}


def test_k7_counts_the_grid_stride_loop(monkeypatch):
    """K7: each candidate's instance by its id, the whole grid-stride
    loop (one seed a trip) with its pipe split."""
    funcs = sass_count.parse_sass(LISTING)
    instrs = funcs["_ZN2k16aes_level_kernelILi2EEEvPK5uint4"]
    names = ["_ZN12_GLOBAL__N_114prf_zoo_kernelILi11EEEvPK5uint4PS1_xy",
             "_ZN12_GLOBAL__N_114prf_zoo_kernelILi3EEEvPK5uint4PS1_xy",
             "other"]
    monkeypatch.setattr(sass_count.cuda_build, "build", lambda names: {})
    monkeypatch.setattr(sass_count, "sass_functions",
                        lambda lib: {n: instrs for n in names})
    got = sass_count.k7_counts()
    assert sorted(got) == [3, 11]
    # 0x40-0xd0: ten instructions, PRMT LOP3 IADD3 on the INT32 pipe
    assert got[11] == {"instructions": 10, "alu": 3, "fma": 0}


def test_same_functions_holds_every_kernel_by_name(monkeypatch):
    """K1, K3, K5, K6 and K7 against another build: every kernel by its
    name, the anonymous namespace's digest left out."""
    instrs = sass_count.parse_sass(LISTING)[
        "_ZN2k16aes_level_kernelILi2EEEvPK5uint4"]
    ns_a = "_ZN43_GLOBAL__N__2051430a_10_contract_cu_0123abcd"
    ns_b = "_ZN43_GLOBAL__N__5e1f0a2b_10_contract_cu_f8e2f0de"
    other = {ns_a + "15contract_kernelEv": instrs, "gone": instrs,
             "changed": instrs}
    mine = {ns_b + "15contract_kernelEv": instrs, "changed": instrs[1:]}
    monkeypatch.setattr(sass_count.cuda_build, "build", lambda names: {})
    monkeypatch.setattr(sass_count, "sass_functions",
                        lambda lib: other if str(lib) == "old.so" else mine)
    got = sass_count.same_functions("old.so", "contract")
    assert {k: v["same"] for k, v in got.items()} == {
        ns_a + "15contract_kernelEv": True, "gone": False,
        "changed": False}
