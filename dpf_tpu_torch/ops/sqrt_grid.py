"""Fused sqrt-N PRF grid + table contraction: plain version and K4.

Port of ``dpf_tpu/ops/pallas_sqrt.py::sqrt_grid_contract_pallas``.  For
each key ``b`` and cell ``x = r*K + c`` of the ``[R, K]`` grid the leaf
share is ``PRF(seeds[b, c], row0 + r) + (lsb(seeds[b, c]) ? cw2 : cw1)
[b, r]`` mod 2^128; its low 32 bits are contracted against the
natural-order table row ``x``:

    out[b, e] = sum_x leaf32[b, x] * table[x, e]   (mod 2^32)

seeds ``[B, K, 4]``, codewords ``[B, R, 4]`` (int32 limbs read as
uint32, any key stride), table ``[R*K, E]`` int32 -> ``[B, E]`` int32.
``row0`` is the absolute row of the table's first row (the per-shard
row base of the JAX launcher); positions are ``row0 + r``.  Only the low
limb is contracted and 128-bit adds carry upward only, so the codeword
add needs the low limb alone.

* ``sqrt_grid_contract_plain`` -- the plain version: the port of the
  JAX row-chunked scan (``sqrtn._eval_contract_batched_jit``), a
  ``[B, rc, K]`` slab of PRF values per step.
* ``sqrt_grid_contract`` -- the wrapper: CUDA tensors launch K4
  (``csrc/sqrt_grid.cu``) for every PRF id 0-5 (the TPU kernel takes
  ids 1, 2, 4, 5; JAX runs AES and DUMMY through the scan, which gives
  the same bits), CPU tensors take the plain version.

Per-key tables: both functions also take a ``[B, R*K, E]`` stack, one
natural-order table a key (batch-PIR's bins; the JAX package's
``sqrtn.eval_contract_per_key_tables`` runs the same grid and
contracts with a batched ``dot_general``): ``out[b] = sum_x leaf32[b,
x] * tables[b, x]``.  K4 runs its per-key kernel over items of one key
and ``pkt_row_chunk`` rows unless the caller names the row chunk (taken
as given, or refused by the row-chunk rules); its launches count in
``launches_pkt``.

The tuner moves K4's grid step: ``grid_rows`` names it exactly (the
row-chunk rules apply, with no halving to the cell cap) and
``row_chunk_candidates`` offers the steps around the heuristic's.  The
Mosaic-only variant knobs of the TPU launcher (``tb``, ``max_cells``,
``grid_order``, ``dim_semantics``, ``limbs``, ``cw_add``) have no
meaning on the card (``tune/kernel_search.variant_invalid`` refuses
them).
"""

from __future__ import annotations

import torch

from ..core import sqrtn
from ..core.prf import _BLK_WORDS
from ..core.prf_ref import PRF_NAMES
from . import cuda_build
from .matmul128 import dot_i32_per_key_plain, dot_i32_plain

# the TPU kernel's cell budget per row tile (PALLAS_SQRT_MAX_CELLS); here
# it sets the rows of K4's grid step, not a memory bound
MAX_CELLS = 2048
# K4's sub-tile: 4 rows x 256 columns, one quad of rows for each of a
# block's 256 threads (csrc/sqrt_grid.cu kTileCells)
PKT_TILE_CELLS = 1024


def sqrt_grid_unsupported(prf_method: int, r: int,
                          row0: int = 0) -> str | None:
    """Why the grid kernel cannot take this call (None = it can).

    The block-PRG ids evaluate one core block per four rows, so the
    four rows of a block must not straddle a call: ``row0`` must be a
    multiple of 4 for them.  K4's threads own whole quads of absolute
    rows and mask the rows past R, so the TPU kernel's ``R % 4`` rule
    (``pallas_sqrt_unsupported``) does not apply to the row count."""
    if prf_method not in PRF_NAMES:
        return "unknown PRF id %r" % (prf_method,)
    if prf_method in _BLK_WORDS and int(row0) % 4:
        return ("block-PRG sqrt-N grid kernel needs row0 (%d) to be a "
                "multiple of 4 (one core block serves 4 rows; R=%d)"
                % (int(row0), r))
    return None


def sqrt_row_chunk(r: int, k: int, row_chunk: int | None = None) -> int:
    """Grid rows per K4 grid step (port of ``pallas_sqrt_row_chunk``):
    explicit values obey the shared row-chunk rules
    (``sqrtn._resolve_row_chunk``) and are then halved down to the cell
    cap; None starts from R.  The bits do not depend on it."""
    rc = r if row_chunk is None else sqrtn._resolve_row_chunk(r, k, 1,
                                                              row_chunk)
    # halving preserves "divides R"; the %8 guard keeps rc a multiple of
    # 4 all the way down to the 4-row interleave floor
    while rc * k > MAX_CELLS and rc > sqrtn.ROW_CHUNK_FLOOR and rc % 8 == 0:
        rc //= 2
    return rc


def heuristic_grid_rows(r: int, k: int, batch: int) -> int:
    """K4's grid step when nothing is pinned: the plain scan's row
    chunk for this batch (``sqrtn.clamp_row_chunk``) halved to the cell
    cap (``sqrt_row_chunk``), what a shared-table dispatch runs."""
    return sqrt_row_chunk(r, k, sqrtn.clamp_row_chunk(None, r, k, batch))


def row_chunk_candidates(r: int, k: int, batch: int, span: int = 2) -> list:
    """K4 grid steps for the autotuner: the heuristic's
    (``heuristic_grid_rows``) and the legal row chunks (divisors of R,
    multiples of 4 unless R) within ``span`` octaves of it, each passed
    to K4 as ``grid_rows``.  Sorted ascending."""
    base = heuristic_grid_rows(r, k, batch)
    out = {base}
    for s in range(-span, span + 1):
        c = base << s if s >= 0 else base >> (-s)
        if (1 <= c <= r and r % c == 0
                and (c == r or c % sqrtn.ROW_CHUNK_FLOOR == 0)):
            out.add(c)
    return sorted(out)


def pkt_row_chunk(r: int, k: int) -> int:
    """Rows per item of K4's per-key mode over an ``[R, K]`` grid: the
    smallest legal row chunk (a divisor of R, a multiple of 4 unless it
    is R; ``sqrtn._resolve_row_chunk``) whose item fills a sub-tile of
    ``PKT_TILE_CELLS`` cells, so that every thread of a block has a quad
    of rows; R when none does.  The kernel's persistent blocks walk the
    items, so the smallest full items give the most of them, the best
    fill of the card and the least idle tail, whatever the number of
    keys.  No bit of the result depends on it."""
    legal = [rc for rc in range(1, r + 1)
             if r % rc == 0 and (rc == r or rc % sqrtn.ROW_CHUNK_FLOOR == 0)]
    return min(rc for rc in legal if rc == r or rc * k >= PKT_TILE_CELLS)


def _check(seeds, cw1, cw2, table, prf_method, row0) -> tuple:
    """Shapes, types, devices and layout -> (B, K, R, E); raises on what
    the kernel does not take, on every device."""
    for t in (seeds, cw1, cw2, table):
        if t.dtype != torch.int32:
            raise TypeError("sqrt_grid_contract takes int32 tensors")
        if t.device != seeds.device:
            raise ValueError("sqrt_grid_contract operands on different "
                             "devices")
    if seeds.dim() != 3 or seeds.shape[2] != 4:
        raise ValueError("seeds must be [B, K, 4], got %s"
                         % (tuple(seeds.shape),))
    bsz, k, _ = seeds.shape
    if cw1.dim() != 3 or cw1.shape[0] != bsz or cw1.shape[2] != 4 or \
            cw2.shape != cw1.shape:
        raise ValueError("codewords must be [B, R, 4], got %s and %s"
                         % (tuple(cw1.shape), tuple(cw2.shape)))
    r = cw1.shape[1]
    if table.shape[-2:-1] != (r * k,) or table.dim() not in (2, 3) or \
            (table.dim() == 3 and table.shape[0] != bsz):
        raise ValueError("table must be [R*K, E] or [B, R*K, E] with "
                         "R*K = %d, B = %d, got %s"
                         % (r * k, bsz, tuple(table.shape)))
    if not 0 <= int(row0) < 1 << 32:
        raise ValueError("row0 (%d) must be a uint32" % int(row0))
    reason = sqrt_grid_unsupported(prf_method, r, row0)
    if reason:
        raise ValueError(reason)
    # the kernel's layout, checked on every device so CPU runs catch it
    if seeds.stride()[1:] != (4, 1) or cw1.stride()[1:] != (4, 1) or \
            cw1.stride() != cw2.stride() or not table.is_contiguous():
        raise ValueError("sqrt_grid_contract: seeds and codewords need "
                         "contiguous (row, limb) axes and equal codeword "
                         "strides; the table must be contiguous")
    return bsz, k, r, table.shape[-1]


def sqrt_grid_contract_plain(seeds, cw1, cw2, table, *, prf_method: int,
                             row_chunk: int | None = None,
                             row0: int = 0) -> torch.Tensor:
    """Plain PyTorch: ``row_chunk`` rows at a time (None = the scan's
    ``choose_row_chunk``), the low limb of PRF + selected codeword, and
    the wrapping int32 product against the chunk's table rows (per-key
    tables: each key's own rows)."""
    bsz, k, r, e = _check(seeds, cw1, cw2, table, prf_method, row0)
    rc = sqrtn._resolve_row_chunk(r, k, bsz, row_chunk)
    sel = (seeds[:, None, :, 0] & 1).bool()                # [B, 1, K]
    acc = torch.zeros((bsz, e), dtype=torch.int32, device=seeds.device)
    for lo in range(0, r, rc):
        vals = sqrtn._grid_vals(
            prf_method, lambda nr: seeds[:, None].expand(bsz, nr, k, 4), rc,
            row0=int(row0) + lo, device=seeds.device)      # [B, rc, K, 4]
        cw = torch.where(sel, cw2[:, lo:lo + rc, None, 0],
                         cw1[:, lo:lo + rc, None, 0])      # [B, rc, K]
        leaves = (vals[..., 0] + cw).reshape(bsz, rc * k)
        rows = slice(lo * k, (lo + rc) * k)
        if table.dim() == 3:
            acc = acc + dot_i32_per_key_plain(leaves, table[:, rows])
        else:
            acc = acc + dot_i32_plain(leaves, table[rows])
    return acc


def sqrt_grid_contract(seeds, cw1, cw2, table, *, prf_method: int,
                       row_chunk: int | None = None,
                       row0: int = 0,
                       grid_rows: int | None = None) -> torch.Tensor:
    """Fused sqrt-N grid expand + contract; K4 on CUDA tensors, plain on
    CPU ones.  ``table``: one ``[R*K, E]`` table or ``[B, R*K, E]``, one
    a key (rows a per-key item: ``row_chunk`` under the row-chunk rules,
    ``pkt_row_chunk`` when None).  ``grid_rows`` (shared table only):
    K4's grid step taken as given under the row-chunk rules, in place of
    ``row_chunk``'s halving to the cell cap; the plain version scans at
    that step.  Returns [B, E] int32."""
    bsz, k, r, e = _check(seeds, cw1, cw2, table, prf_method, row0)
    per_key = table.dim() == 3
    if grid_rows is not None:
        if per_key:
            raise ValueError("grid_rows is the shared-table kernel's step; "
                             "per-key tables take row_chunk")
        row_chunk = sqrtn._resolve_row_chunk(r, k, bsz, grid_rows)
    if per_key:
        row_chunk = (pkt_row_chunk(r, k) if row_chunk is None else
                     sqrtn._resolve_row_chunk(r, k, bsz, row_chunk))
    if seeds.device.type == "cpu":
        return sqrt_grid_contract_plain(seeds, cw1, cw2, table,
                                        prf_method=prf_method,
                                        row_chunk=row_chunk, row0=row0)
    if seeds.device.type != "cuda":
        raise ValueError("sqrt_grid_contract: unsupported device %s"
                         % seeds.device)
    rc = (row_chunk if per_key or grid_rows is not None
          else sqrt_row_chunk(r, k, row_chunk))
    out = torch.zeros((bsz, e), dtype=torch.int32, device=seeds.device)
    with torch.cuda.device(seeds.device):
        cuda_build.launch(
            "sqrt_grid", "sqrt_grid_launch", seeds.data_ptr(),
            seeds.stride(0), cw1.data_ptr(), cw2.data_ptr(), cw1.stride(0),
            table.data_ptr(), out.data_ptr(), bsz, k, r, rc, e, int(row0),
            prf_method, int(per_key), torch.cuda.current_stream().cuda_stream)
    if per_key:
        sqrt_grid_contract.launches_pkt += 1
    else:
        sqrt_grid_contract.launches += 1
    return out


sqrt_grid_contract.launches = 0
sqrt_grid_contract.launches_pkt = 0
