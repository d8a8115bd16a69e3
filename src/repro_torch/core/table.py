"""Paged, in-memory columnar table with lightweight multi-versioning.

Port of ``repro.core.table``: plain tables and sharded storage.  Same
layout at the public surface, held in torch tensors on one explicit
device:

``data``      (n_pages, page_size, n_attrs) int32   -- attribute values
``begin_ts``  (n_pages, page_size) int32            -- MVCC begin timestamp
``end_ts``    (n_pages, page_size) int32            -- MVCC end timestamp
``n_rows``    int                                   -- append watermark

The attribute values are stored attribute-major behind that shape:
every table this module makes allocates its values as (n_attrs,
n_pages, page_size) -- (n_attrs, S, max_pages, page_size) when sharded
-- and exposes them permuted (``attribute_major``).  Each plane
``data[..., a]`` is then one unit-stride run, which the stream kernels
(K1, K4) read with 16-byte loads, and ``data.view(-1, n_attrs)`` is
still a view (the leading strides merge), so the mutators write rows in
place.  There is one layout and no switch; ``clone``, ``empty_like``
and ``.to(device)`` keep it (the permuted tensor is dense).
tests/test_torch_layout.py pins it on every path that makes or changes
a table.

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

Sharded storage (the second half of the module) keeps the reference's
page map -- global page ``p`` on shard ``p % S`` at local page
``p // S`` for tables this module shards -- but holds a
``ShardedTable`` as the stacked tensors themselves: every shard padded
to one local page grid on a leading shard axis, padding pages
invisible.  The reference caches such a stacked copy per shards tuple
and relies on its mutators returning fresh tuples; here the mutators
write in place, so the stacked tensors are the only copy and no cache
can go stale.  Each shard's ``Table`` is a view (``ShardedTable.
shard``).  The sharded INSERT / UPDATE write only real rows, so the
reference's parked writes on each shard's last slot (which can lose a
row there, ROADMAP.md queue 3 item 1) do not occur.
"""

from __future__ import annotations

import functools
import weakref
from typing import NamedTuple, Sequence

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


def attribute_major(lead: tuple, page_size: int, n_attrs: int,
                    device) -> torch.Tensor:
    """Zeroed (*lead, page_size, n_attrs) int32 attribute values stored
    attribute-major: allocated as (n_attrs, *lead, page_size) and
    exposed through a permutation."""
    store = torch.zeros((n_attrs, *lead, page_size), dtype=torch.int32,
                        device=device)
    return store.movedim(0, -1)


def is_attribute_major(data: torch.Tensor) -> bool:
    """True iff every plane ``data[..., a]`` is one unit-stride run."""
    return data[..., 0].is_contiguous()


@functools.lru_cache(maxsize=64)
def page_counts_tensor(pages: tuple, device: torch.device) -> torch.Tensor:
    """(S,) int32 tensor of the page counts ``pages`` on ``device``,
    made once per value: a table's page counts change only with a new
    table (INSERT and reshard return one with its own tuple), so the
    operand follows them.  Read-only: callers share it."""
    return torch.tensor(pages, dtype=torch.int32, device=device)


def rows_view(data: torch.Tensor) -> torch.Tensor:
    """``data`` as (rows, n_attrs), a view of the same storage: the
    leading strides of an attribute-major table merge, and ``view``
    raises rather than copy where they would not."""
    return data.view(-1, data.shape[-1])


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

    def local_pages_tensor(self) -> torch.Tensor:
        """(1,) int32 page count on the table's device: the table as
        one shard (``page_counts_tensor``, shared and read-only)."""
        return page_counts_tensor((self.n_pages,), self.device)


def make_table(n_pages: int, page_size: int, n_attrs: int,
               device=None) -> Table:
    """An empty table with fixed capacity."""
    dev = resolve_device(device)
    return Table(
        data=attribute_major((n_pages,), page_size, n_attrs, dev),
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
    rows_view(table.data)[:n] = torch.from_numpy(values).to(dev)
    table.begin_ts.view(-1)[:n] = ts
    return table._replace(n_rows=n)


def clone_table(t):
    """A copy of a ``Table`` or ``ShardedTable`` on its device, in the
    same attribute-major layout (``clone`` keeps a dense tensor's
    strides).  The mutators write in place, so a second engine over
    the same data (a replica) needs its own tensors; the host metadata
    (watermarks, page counts) is immutable and shared."""
    return t._replace(data=t.data.clone(), begin_ts=t.begin_ts.clone(),
                      end_ts=t.end_ts.clone())


# ---------------------------------------------------------------------------
# Visibility & predicates
# ---------------------------------------------------------------------------

# These take a ``Table`` or a ``ShardedTable``: masks have the shape of
# ``begin_ts``, (n_pages, page_size) or (S, max_pages, page_size).

def visible_mask(table: Table, ts) -> torch.Tensor:
    """(n_pages, page_size) bool -- versions visible at snapshot ``ts``."""
    return (table.begin_ts <= ts) & (ts < table.end_ts)


def range_predicate_mask(table: Table, attr: int, lo, hi) -> torch.Tensor:
    """(n_pages, page_size) bool -- rows with lo <= a_attr <= hi."""
    col = table.data[..., attr]
    return (col >= lo) & (col <= hi)


def conj_predicate_mask(table: Table, attrs, los, his) -> torch.Tensor:
    """Conjunctive multi-attribute range predicate over ``attrs``
    (column indices) with per-attribute inclusive bounds."""
    mask = torch.ones(table.data.shape[:-1], dtype=torch.bool,
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
        rows_view(table.data)[base:base + k] = rows[:k]
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
    new_rows = rows_view(table.data)[rids]  # a copy
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


# ---------------------------------------------------------------------------
# Sharded storage: pages partitioned over S shards, held stacked
# ---------------------------------------------------------------------------
#
# Round-robin partitioning (``shard_table``) puts global page p on shard
# p % S at local page p // S, so the in-order VAP build's global prefix
# maps to a local prefix on every shard.  Rows keep global rids; each
# shard fills its slots in local rid order and tracks a local append
# watermark.  Pre-sharded tables with another layout (``stack_shards``)
# are adopted as they are; the planner then stitches hybrid scans per
# shard.  Results and accounting equal the single-shard engine's for
# any shard count (tests/test_torch_sharded.py).


class ShardedTable(NamedTuple):
    """S shards stacked on a leading axis, padded to one page grid.

    ``data`` (S, max_pages, page_size, n_attrs), ``begin_ts`` /
    ``end_ts`` (S, max_pages, page_size) int32 on one device; padding
    pages (local page >= ``local_pages[s]``) carry ``begin_ts ==
    NEVER_TS`` and so are invisible to every snapshot.  ``local_pages``
    and ``local_rows`` (each shard's real page count and append
    watermark) and the global watermark ``n_rows`` are host ints.  The
    geometry properties report global values, so cost code written
    against ``Table`` works on either storage.
    """

    data: torch.Tensor
    begin_ts: torch.Tensor
    end_ts: torch.Tensor
    local_pages: tuple
    local_rows: tuple
    n_rows: int

    @property
    def n_shards(self) -> int:
        return self.data.shape[0]

    @property
    def max_pages(self) -> int:
        return self.data.shape[1]

    @property
    def page_size(self) -> int:
        return self.data.shape[2]

    @property
    def n_attrs(self) -> int:
        return self.data.shape[3]

    @property
    def n_pages(self) -> int:
        return sum(self.local_pages)

    @property
    def capacity(self) -> int:
        return self.n_pages * self.page_size

    @property
    def device(self) -> torch.device:
        return self.data.device

    def shard(self, s: int) -> Table:
        """Shard ``s`` as a ``Table`` of views (no copy)."""
        lp = self.local_pages[s]
        return Table(self.data[s, :lp], self.begin_ts[s, :lp],
                     self.end_ts[s, :lp], self.local_rows[s])

    @property
    def shards(self) -> tuple:
        return tuple(self.shard(s) for s in range(self.n_shards))

    def local_pages_tensor(self) -> torch.Tensor:
        """(S,) int32 ``local_pages`` on the table's device
        (``page_counts_tensor``, shared and read-only)."""
        return page_counts_tensor(tuple(self.local_pages), self.device)

    def global_page_ids(self) -> torch.Tensor:
        """(S, max_pages) int64 round-robin global page id of every
        stacked page (``lp * S + s``)."""
        S = self.n_shards
        lp = torch.arange(self.max_pages, device=self.device)
        return lp[None, :] * S + torch.arange(S, device=self.device)[:, None]


def local_n_rows(n_rows: int, shard: int, n_shards: int, page_size: int,
                 local_pages: int) -> int:
    """Local append watermark implied by the global watermark: the
    shard's pages fully below the global watermark page, plus that
    page's partial fill if this shard owns it."""
    watermark, partial = divmod(int(n_rows), page_size)
    full_local = min(max((watermark - shard + n_shards - 1) // n_shards, 0),
                     local_pages)
    owns = (watermark % n_shards == shard
            and watermark // n_shards < local_pages)
    return full_local * page_size + (partial if owns else 0)


def global_rids(local_pages: int, shard: int, n_shards: int,
                page_size: int, device=None) -> torch.Tensor:
    """(local_pages * page_size,) int64 global rid of each local slot."""
    dev = resolve_device(device)
    pages = torch.arange(local_pages, device=dev) * n_shards + shard
    slots = torch.arange(page_size, device=dev)
    return (pages[:, None] * page_size + slots[None, :]).reshape(-1)


# Device slices (the mesh's placement): shards [a, b) of the stacked
# tensors on one device.  On the tensors' own device a slice is a view;
# on another it is a copy, made once per source tensor and kept in
# ``_PLACED`` until a mutator writes the tensor in place
# (``drop_placed``) or the tensor dies.  Index arrays and coverage
# words are never written in place (a new state is a new tensor), so
# their copies need no dropping.

_PLACED: dict = {}  # id(source tensor) -> {(a, b, device): copy}


def place_rows(x: torch.Tensor, a: int, b: int,
               device: torch.device) -> torch.Tensor:
    """Rows [a, b) of ``x``'s leading axis on ``device``: a view where
    ``x`` lies, else a cached copy with the same stride order (an
    attribute-major plane stays one unit-stride run)."""
    part = x[a:b]
    if part.device == device:
        return part
    key = id(x)
    per = _PLACED.get(key)
    if per is None:
        per = _PLACED[key] = {}
        weakref.finalize(x, _PLACED.pop, key, None)
    hit = per.get((a, b, device))
    if hit is None:
        order = sorted(range(part.dim()), key=lambda d: -part.stride(d))
        back = [order.index(d) for d in range(part.dim())]
        hit = per[(a, b, device)] = part.permute(order).contiguous().to(
            device).permute(back)
    return hit


def drop_placed(*tensors) -> None:
    """Forget the device copies of tensors just written in place."""
    for x in tensors:
        _PLACED.pop(id(x), None)


def slice_shards(st: "ShardedTable", a: int, b: int,
                 device: torch.device) -> "ShardedTable":
    """Shards [a, b) of ``st`` as a ``ShardedTable`` on ``device``
    (``place_rows``).  Its ``n_rows`` stays the GLOBAL watermark; the
    caller keeps the slice's first shard id and the global shard count
    (local page ``pg`` of shard s is global page ``pg * S + s``)."""
    return ShardedTable(place_rows(st.data, a, b, device),
                        place_rows(st.begin_ts, a, b, device),
                        place_rows(st.end_ts, a, b, device),
                        st.local_pages[a:b], st.local_rows[a:b], st.n_rows)


def stack_shards(shards: Sequence[Table], n_rows: int) -> ShardedTable:
    """Stack per-shard ``Table``s (a pre-sharded layout, as the
    reference's ``ShardedTable(shards, n_rows)``) into one padded
    ``ShardedTable``; the shards' own watermarks are kept."""
    shards = list(shards)
    if not shards:
        raise ValueError("a sharded table needs at least one shard")
    t0 = shards[0]
    dev = t0.device
    max_pages = max(t.n_pages for t in shards)
    S = len(shards)
    psz, n_attrs = t0.page_size, t0.n_attrs
    data = attribute_major((S, max_pages), psz, n_attrs, dev)
    begin = torch.full((S, max_pages, psz), NEVER_TS, dtype=torch.int32,
                       device=dev)
    end = torch.full((S, max_pages, psz), INF_TS, dtype=torch.int32,
                     device=dev)
    for s, t in enumerate(shards):
        if (t.page_size, t.n_attrs) != (psz, n_attrs):
            raise ValueError("shards must share page size and width")
        data[s, : t.n_pages] = t.data
        begin[s, : t.n_pages] = t.begin_ts
        end[s, : t.n_pages] = t.end_ts
    return ShardedTable(data, begin, end,
                        tuple(t.n_pages for t in shards),
                        tuple(int(t.n_rows) for t in shards), int(n_rows))


def shard_table(table: Table, num_shards: int) -> ShardedTable:
    """Partition ``table`` round-robin by page id into ``num_shards``."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if table.n_pages < num_shards:
        raise ValueError(f"cannot spread {table.n_pages} pages over "
                         f"{num_shards} shards")
    S, psz = num_shards, table.page_size
    shards = []
    for s in range(S):
        n = len(range(s, table.n_pages, S))
        shards.append(Table(table.data[s::S], table.begin_ts[s::S],
                            table.end_ts[s::S],
                            local_n_rows(table.n_rows, s, S, psz, n)))
    return stack_shards(shards, table.n_rows)


def round_robin_layout(st: ShardedTable) -> bool:
    """True iff the occupied pages follow the round-robin page map (the
    layout ``shard_table`` produces): each shard's fully populated
    pages are exactly its share of one global page prefix, and at most
    the global watermark page is partially filled."""
    S, psz = st.n_shards, st.page_size
    full = [r // psz for r in st.local_rows]
    total_full = sum(full)
    for s, f in enumerate(full):
        if f != max(0, -(-(total_full - s) // S)):
            return False
    partial = [s for s, r in enumerate(st.local_rows) if r % psz]
    return not partial or partial == [total_full % S]


def unshard_table(st: ShardedTable) -> Table:
    """Reassemble the logical table of a round-robin layout (test
    oracle and resharding)."""
    S, n_pages = st.n_shards, st.n_pages
    for s, lp in enumerate(st.local_pages):
        if lp != len(range(s, n_pages, S)):
            raise ValueError("only a round-robin page map can be unsharded")
    shape = (n_pages, st.page_size)
    data = attribute_major((n_pages,), st.page_size, st.n_attrs, st.device)
    begin = torch.empty(shape, dtype=torch.int32, device=st.device)
    end = torch.empty(shape, dtype=torch.int32, device=st.device)
    for s, lp in enumerate(st.local_pages):
        data[s::S] = st.data[s, :lp]
        begin[s::S] = st.begin_ts[s, :lp]
        end[s::S] = st.end_ts[s, :lp]
    return Table(data, begin, end, st.n_rows)


def _stacked_slots(st: ShardedTable, rids: torch.Tensor) -> torch.Tensor:
    """Flat index into the stacked (S * max_pages * page_size) slots of
    global rids under the round-robin page map."""
    psz, S = st.page_size, st.n_shards
    gp, sl = rids // psz, rids % psz
    return ((gp % S) * st.max_pages + gp // S) * psz + sl


def sharded_insert_rows(st: ShardedTable, rows, ts, n_new: int,
                        max_new: int | None = None) -> ShardedTable:
    """Sharded INSERT, in place: the first ``n_new`` of ``rows`` append
    at the global watermark, each row on the shard owning its global
    page.  As in the reference, appends past the capacity, or onto a
    local page the owning shard does not have (a layout that is not
    round-robin), are dropped, and the local watermarks are re-derived
    from the global one.  Masked-off writes are not parked anywhere."""
    del max_new  # the row count is the tensor's
    base, n_new = st.n_rows, int(n_new)
    S, psz = st.n_shards, st.page_size
    k = max(0, min(n_new, int(rows.shape[0]), st.capacity - base))
    if k:
        dev = st.device
        rows = torch.as_tensor(rows, dtype=torch.int32, device=dev)[:k]
        rids = base + torch.arange(k, device=dev)
        gp = rids // psz
        ok = gp // S < torch.tensor(st.local_pages, device=dev)[gp % S]
        slots = _stacked_slots(st, rids[ok])
        rows_view(st.data)[slots] = rows[ok]
        st.begin_ts.view(-1)[slots] = int(ts)
        st.end_ts.view(-1)[slots] = INF_TS
        drop_placed(st.data, st.begin_ts, st.end_ts)
    n_rows = min(base + n_new, st.capacity)
    local = tuple(local_n_rows(n_rows, s, S, psz, lp)
                  for s, lp in enumerate(st.local_pages))
    return st._replace(local_rows=local, n_rows=n_rows)


def sharded_update_rows(st: ShardedTable, attrs: tuple, los, his, set_attrs,
                        set_vals, ts, max_new: int):
    """Sharded MVCC UPDATE, bit-identical to ``update_rows`` on the
    unsharded table: the first ``max_new`` matches in GLOBAL rid order
    are terminated and re-appended.  Matches whose global rid falls at
    or past the capacity (only on a layout that is not round-robin) are
    not selectable, as in the reference.  Returns (new_table,
    n_updated)."""
    ts = int(ts)
    match = conj_predicate_mask(st, attrs, los, his) & visible_mask(st, ts)
    psz = st.page_size
    gpage = st.global_page_ids()[:, :, None]
    slot = torch.arange(psz, device=st.device)
    rids = (gpage * psz + slot)[match]
    rids = torch.sort(rids[rids < st.capacity]).values[:max_new]
    n_upd = int(rids.numel())
    if n_upd == 0:
        return st, 0
    slots = _stacked_slots(st, rids)
    st.end_ts.view(-1)[slots] = ts  # terminate the old versions
    drop_placed(st.end_ts)
    new_rows = rows_view(st.data)[slots]  # a copy
    set_attrs = torch.as_tensor(set_attrs, dtype=torch.long,
                                device=st.device)
    new_rows[:, set_attrs] = torch.as_tensor(
        set_vals, dtype=torch.int32, device=st.device)
    return sharded_insert_rows(st, new_rows, ts, n_upd), n_upd
