"""``utils/sass_count``: K1's instructions per node read from a SASS
listing.  The listing here is a small hand-made one in ``cuobjdump
-sass``'s format (no toolkit on the CPU); ``chip_smoke.py`` runs the
same code on the card's build."""

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
