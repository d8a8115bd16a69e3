"""Paged, in-memory columnar table with lightweight multi-versioning.

Port of ``repro.core.table`` (plain tables).  Same layout at the
public surface, held in torch tensors on one explicit device:

``data``      (n_pages, page_size, n_attrs) int32   -- attribute values
``begin_ts``  (n_pages, page_size) int32            -- MVCC begin timestamp
``end_ts``    (n_pages, page_size) int32            -- MVCC end timestamp
``n_rows``    int                                   -- append watermark

A *rid* is ``page_id * page_size + slot``; pages fill in rid order and
inserts / update versions append at the ``n_rows`` watermark.  A row
version is visible to snapshot ``ts`` iff ``begin_ts <= ts < end_ts``;
unoccupied slots have ``begin_ts == INT32_MAX``.

Two deliberate differences from the reference:

* The mutators write into the table's tensors in place and return a
  new ``Table`` with the new watermark (the reference copies the
  arrays; at the paper's 10M-row scale a copy per statement would move
  1.4 GB).  ``n_rows`` is host metadata, so a ``Table`` held from
  before a mutation keeps its old watermark.
* New rows are written as one contiguous slice at the watermark
  instead of scattering and parking masked-off writes on slot
  ``capacity - 1``.  The reference's parked writes can overwrite a
  real row in that slot (ROADMAP.md, queue 3 item 1); here the row is
  kept.  Everywhere else the two agree bit for bit
  (tests/test_torch_table_index.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.ref import i32_sum

INF_TS = 2**31 - 1  # "infinity" end timestamp (live version)
NEVER_TS = 2**31 - 1  # begin_ts for unoccupied slots


def resolve_device(device=None) -> torch.device:
    """The device an entry point puts its tensors on: ``cuda`` unless
    the caller names another.  Raises when no card is present and no
    device was named -- the port never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


class Table(NamedTuple):
    """Paged column store on one device."""

    data: torch.Tensor  # (n_pages, page_size, n_attrs) int32
    begin_ts: torch.Tensor  # (n_pages, page_size) int32
    end_ts: torch.Tensor  # (n_pages, page_size) int32
    n_rows: int  # append watermark

    @property
    def n_pages(self) -> int:
        return self.data.shape[0]

    @property
    def page_size(self) -> int:
        return self.data.shape[1]

    @property
    def n_attrs(self) -> int:
        return self.data.shape[2]

    @property
    def capacity(self) -> int:
        return self.n_pages * self.page_size

    @property
    def device(self) -> torch.device:
        return self.data.device


def make_table(n_pages: int, page_size: int, n_attrs: int,
               device=None) -> Table:
    """An empty table with fixed capacity."""
    dev = resolve_device(device)
    return Table(
        data=torch.zeros((n_pages, page_size, n_attrs), dtype=torch.int32,
                         device=dev),
        begin_ts=torch.full((n_pages, page_size), NEVER_TS,
                            dtype=torch.int32, device=dev),
        end_ts=torch.full((n_pages, page_size), INF_TS, dtype=torch.int32,
                          device=dev),
        n_rows=0,
    )


def load_table(values: np.ndarray, page_size: int, n_pages: int | None = None,
               ts: int = 0, device=None) -> Table:
    """Bulk-load ``values`` (n, n_attrs) into a fresh table at timestamp
    ts.  ``n_pages`` may reserve extra append room; it defaults to
    exactly fitting the data."""
    dev = resolve_device(device)
    values = np.asarray(values, np.int32)
    n, n_attrs = values.shape
    min_pages = -(-n // page_size)
    if n_pages is None:
        n_pages = min_pages
    if n_pages < min_pages:
        raise ValueError(f"n_pages={n_pages} cannot hold {n} rows")
    table = make_table(n_pages, page_size, n_attrs, device=dev)
    table.data.view(-1, n_attrs)[:n] = torch.from_numpy(values).to(dev)
    table.begin_ts.view(-1)[:n] = ts
    return table._replace(n_rows=n)


# ---------------------------------------------------------------------------
# Visibility & predicates
# ---------------------------------------------------------------------------

def visible_mask(table: Table, ts) -> torch.Tensor:
    """(n_pages, page_size) bool -- versions visible at snapshot ``ts``."""
    return (table.begin_ts <= ts) & (ts < table.end_ts)


def range_predicate_mask(table: Table, attr: int, lo, hi) -> torch.Tensor:
    """(n_pages, page_size) bool -- rows with lo <= a_attr <= hi."""
    col = table.data[:, :, attr]
    return (col >= lo) & (col <= hi)


def conj_predicate_mask(table: Table, attrs, los, his) -> torch.Tensor:
    """Conjunctive multi-attribute range predicate over ``attrs``
    (column indices) with per-attribute inclusive bounds."""
    mask = torch.ones(table.data.shape[:2], dtype=torch.bool,
                      device=table.device)
    for k, attr in enumerate(attrs):
        mask &= range_predicate_mask(table, attr, los[k], his[k])
    return mask


# ---------------------------------------------------------------------------
# Mutators (INSERT / UPDATE), in place
# ---------------------------------------------------------------------------

def insert_rows(table: Table, rows, ts, n_new: int,
                max_new: int | None = None) -> Table:
    """Append the first ``n_new`` of ``rows`` (max_new, n_attrs) at
    timestamp ts.  Appends past capacity are dropped; the watermark
    becomes ``min(n_rows + n_new, capacity)`` as in the reference."""
    del max_new  # the row count is the tensor's
    base = table.n_rows
    n_new = int(n_new)
    k = max(0, min(n_new, int(rows.shape[0]), table.capacity - base))
    if k:
        rows = torch.as_tensor(rows, dtype=torch.int32, device=table.device)
        table.data.view(-1, table.n_attrs)[base:base + k] = rows[:k]
        table.begin_ts.view(-1)[base:base + k] = int(ts)
        table.end_ts.view(-1)[base:base + k] = INF_TS
    return table._replace(n_rows=min(base + n_new, table.capacity))


def update_rows(table: Table, attrs: tuple, los, his, set_attrs, set_vals,
                ts, max_new: int):
    """MVCC UPDATE: terminate matching visible versions and append new
    ones with columns ``set_attrs`` set to ``set_vals``.  At most
    ``max_new`` versions per call, the first matches in rid order (the
    reference's stable argsort of the match mask picks the same rows).
    Returns (new_table, n_updated)."""
    ts = int(ts)
    match = conj_predicate_mask(table, attrs, los, his) & visible_mask(
        table, ts)
    rids = torch.nonzero(match.view(-1)).view(-1)[:max_new]  # rid order
    n_upd = int(rids.numel())
    if n_upd == 0:
        return table, 0
    table.end_ts.view(-1)[rids] = ts  # terminate the old versions
    new_rows = table.data.view(-1, table.n_attrs)[rids]  # a copy
    set_attrs = torch.as_tensor(set_attrs, dtype=torch.long,
                                device=table.device)
    new_rows[:, set_attrs] = torch.as_tensor(
        set_vals, dtype=torch.int32, device=table.device)
    return insert_rows(table, new_rows, ts, n_upd), n_upd


# ---------------------------------------------------------------------------
# Full table scan (the fallback access path)
# ---------------------------------------------------------------------------

def table_scan(table: Table, attrs: tuple, los, his, ts, agg_attr: int,
               from_page=0):
    """Scan pages >= from_page, returning (match_mask, sum, count) with
    int32 wraparound sums; the mask accounts for MVCC visibility."""
    mask = conj_predicate_mask(table, attrs, los, his) & visible_mask(
        table, ts)
    page_ids = torch.arange(table.n_pages, device=table.device)[:, None]
    mask &= page_ids >= from_page
    vals = table.data[:, :, agg_attr]
    return mask, i32_sum(torch.where(mask, vals, 0)), i32_sum(mask)
