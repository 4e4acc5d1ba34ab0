"""The card's peaks that a roofline share is taken against (one NVIDIA
H100 SXM, NVIDIA's data sheet, at its 700 W limit; a run prints the
card's ``power.limit`` beside them).

* HBM bandwidth: 3.35e12 bytes/s.
* 32-bit integer instruction issue: 132 SMs x 4 schedulers x 32 lanes x
  the 1.98 GHz boost clock = 33.45e12 instructions/s.  The DPF's work is
  integer work (cipher rounds, 128-bit adds, one multiply-add a leaf and
  column); no floating-point peak applies.
"""

PEAK_BYTES_PER_S = 3.35e12
PEAK_INSTR_PER_S = 132 * 4 * 32 * 1.98e9


def least_seconds(work: dict) -> float:
    """The least time the card needs for ``work`` ({"ops", "bytes"}):
    the larger of its instruction and its memory bound."""
    return max(work["ops"] / PEAK_INSTR_PER_S,
               work["bytes"] / PEAK_BYTES_PER_S)
