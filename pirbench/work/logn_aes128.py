"""The least work of answering DPF keys with the binary GGM tree over
AES-128, frozen: it counts what the algorithm must do, not what a kernel
happens to do, so a later kernel that fuses or reorders steps meets the
same bound.

Per key over N leaves: N - 1 inner nodes, each one AES-128 key schedule
and two AES-128 blocks (one a child) and two 128-bit adds with their
codeword select; at the leaf level only each leaf's low 32 bits are
kept; then one multiply-add a leaf and table column.  Instructions per
unit are the T-table AES counts the program's bounds use today
(``chip_smoke.py``: a round 48, a schedule step 15, an add and select
10 a child, the low-limb leaf 3 x 12 + 9 fewer).  Bytes: each key's
codewords and start seed read once, the table read once a request (each
request is one pass over it), each share word written once.
"""

OPS_AES_BLOCK = 10 * 48
OPS_AES_SCHEDULE = 10 * 15
OPS_CHILD_ADD = 10
OPS_NODE_SELECT = 10
OPS_NODE = OPS_AES_SCHEDULE + 2 * OPS_AES_BLOCK + 2 * OPS_CHILD_ADD \
    + OPS_NODE_SELECT
OPS_LEAF_LOW_SAVED = 3 * 12 + 9
OPS_MULTIPLY_ADD = 1


def work(n: int, entry_words: int, keys: int, requests: int) -> dict:
    """{"ops", "bytes"} of answering ``keys`` keys in ``requests``
    requests over an [n, entry_words] int32 table."""
    depth = n.bit_length() - 1
    per_key = ((n - 1) * OPS_NODE - n * OPS_LEAF_LOW_SAVED
               + n * entry_words * OPS_MULTIPLY_ADD)
    key_bytes = (4 * depth + 1) * 16
    return {"ops": keys * per_key,
            "bytes": requests * n * entry_words * 4
            + keys * (key_bytes + entry_words * 4)}
