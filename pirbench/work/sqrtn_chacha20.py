"""The least work of answering DPF keys with the sqrt-N grid over
ChaCha20-12, frozen (see ``logn_aes128.py`` for what is counted).

Per key over N = R x K cells: one ChaCha20-12 block a cell (the seed of
its column at its row; 48 quarter rounds of 12 instructions and 16
feed-forward adds, the count ``logn_chacha20.py`` uses), then the low
limb's add of the codeword its seed's LSB selects (3: ``chip_smoke.py``'s
"select + add"), then one multiply-add a cell and table column.  Bytes:
each key's wire read once ((4 + K + 2R) x 16: 49,216 at 2^20), the
table read once a request (each request is one pass over it), each
share word written once.
"""

OPS_CORE_BLOCK = 48 * 12 + 16
OPS_CELL_ADD_SELECT = 3
OPS_MULTIPLY_ADD = 1


def work(n: int, entry_words: int, keys: int, requests: int) -> dict:
    """{"ops", "bytes"} of answering ``keys`` keys in ``requests``
    requests over an [n, entry_words] int32 table."""
    d = n.bit_length() - 1
    k = 1 << ((d + 1) // 2)
    r = n // k
    per_key = n * (OPS_CORE_BLOCK + OPS_CELL_ADD_SELECT
                   + entry_words * OPS_MULTIPLY_ADD)
    key_bytes = (4 + k + 2 * r) * 16
    return {"ops": keys * per_key,
            "bytes": requests * n * entry_words * 4
            + keys * (key_bytes + entry_words * 4)}
