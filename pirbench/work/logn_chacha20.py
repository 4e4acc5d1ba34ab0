"""The least work of answering DPF keys with the binary GGM tree over
ChaCha20-12, frozen (see ``logn_aes128.py`` for what is counted).

Per key over N leaves: N - 1 inner nodes, each two ChaCha20-12 blocks
(one a child: 48 quarter rounds of 12 instructions and 16 feed-forward
adds, today's count) and two 128-bit adds with their codeword select
(12 a child); a leaf keeps its low 32 bits only (a 32-bit add and
select in place of the 128-bit one, and one feed-forward add in place
of four: 12 fewer); then one multiply-add a leaf and table column.
Bytes as for AES-128.
"""

OPS_CORE_BLOCK = 48 * 12 + 16
OPS_CHILD_ADD = 12
OPS_NODE = 2 * OPS_CORE_BLOCK + 2 * OPS_CHILD_ADD
OPS_LEAF_LOW_SAVED = 12
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
