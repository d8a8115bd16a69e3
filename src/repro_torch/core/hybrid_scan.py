"""The value-agnostic hybrid scan operator (paper Section III).

Port of ``repro.core.hybrid_scan`` on plain tables.  A hybrid scan is
an index scan over the fully-indexed page prefix stitched to a table
scan over the remainder:

1. Range-scan the partial index; re-check the full predicate and MVCC
   visibility on the fetched rows (index keys may be stale after
   updates -- the table is the source of truth).
2. rho_m = largest page id holding an index-scan match; rho_i = largest
   fully indexed page id (= built_pages - 1).
3. The table scan starts at start_page = max(rho_m, rho_i + 1).
4. Index matches on pages >= start_page are dropped (the table scan
   finds them again).

The masked forms (``*_masked``, coverage bitmaps) stitch by a
built-page bitmap ``covered`` (n_pages,) bool instead: covered pages
answer from the index, exactly the uncovered pages are table-scanned
-- no rho, no dedup window -- and ``start_page`` reports the bitmap's
leading built run ``prefix_len``.

Index side: the reference evaluates the predicate over the whole table
and gathers it at every entry's rid.  Here the sorted entry array is
binary-searched for each query's key range (``index_range_bounds``,
the same positions as ``index_range_scan``'s mask) and only the probed
entries' own columns are gathered, so a burst of B queries reads the
probed rows instead of B whole-table masks.  int32 sums are taken in
int64 and cast back, so the bits equal the reference's.

``batched_*`` forms take per-query bounds ``los``/``his`` of shape
(B, len(attrs)) and snapshots ``tss`` (B,), and are per query
bit-identical to the single-query operators.  The table side of the
batched forms here is plain PyTorch (the engine's ``use_kernel=False``
path); with ``use_kernel`` the engine runs it on kernel K1 instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.index import (
    I32_MAX,
    I32_MIN,
    AdHocIndex,
    ShardedIndex,
    index_range_bounds,
    packed_keys,
)
from repro_torch.core.table import (
    ShardedTable,
    Table,
    conj_predicate_mask,
    rows_view,
    visible_mask,
)
from repro_torch.kernels.ref import i32_sum

# Profiler range around the index half's gathers (the probed entries'
# rids, and their rows' key, aggregate and MVCC planes), so that a
# trace can add up their device time apart from the rest of a burst.
GATHER_RANGE = "hybrid_scan.index_gathers"


class ScanResult(NamedTuple):
    """Aggregates + accounting from one scan execution (0-d int32,
    ``contrib`` (n_pages, page_size) int32: times each row was
    returned, 0 or 1)."""

    agg_sum: torch.Tensor
    count: torch.Tensor
    contrib: torch.Tensor
    pages_scanned: torch.Tensor
    entries_probed: torch.Tensor
    start_page: torch.Tensor


class BatchScanResult(NamedTuple):
    """Per-query aggregates + accounting, every field (B,) int32."""

    agg_sum: torch.Tensor
    count: torch.Tensor
    pages_scanned: torch.Tensor
    entries_probed: torch.Tensor
    start_page: torch.Tensor


class HybridPrefixResult(NamedTuple):
    """Per-query index-prefix portion of a batched hybrid scan: the
    deduplicated index matches on pages < ``start_page``.  Adding the
    table suffix from ``start_page`` (K1 or plain) gives the full
    hybrid result."""

    agg_sum: torch.Tensor  # (B,) int32
    count: torch.Tensor  # (B,) int32
    entries_probed: torch.Tensor  # (B,) int32
    start_page: torch.Tensor  # (B,) int32


def add_i32(a, b):
    """int32 addition with wraparound."""
    return (a.to(torch.int64) + b.to(torch.int64)).to(torch.int32)


def _bounds(x, n_attrs, device):
    """Per-query bounds as a (B, n_attrs) int32 tensor."""
    return torch.as_tensor(x, dtype=torch.int32, device=device).reshape(
        -1, n_attrs)


def _predicate_key_bounds(key_attrs: tuple, attrs: tuple, los, his):
    """Packed-key range implied by (B, len(attrs)) predicate bounds for
    an index keyed on ``key_attrs``; (lo, hi), (B,) int64 each.  The
    index's leading attribute must appear in the predicate; a missing
    trailing attribute widens to the full domain."""
    pmap = {a: k for k, a in enumerate(attrs)}
    if key_attrs[0] not in pmap:
        raise ValueError(
            "index leading attribute not constrained by predicate"
        )
    lo0, hi0 = los[:, pmap[key_attrs[0]]], his[:, pmap[key_attrs[0]]]
    if len(key_attrs) == 1:
        lo1 = hi1 = torch.zeros_like(lo0)
    elif key_attrs[1] in pmap:
        lo1, hi1 = los[:, pmap[key_attrs[1]]], his[:, pmap[key_attrs[1]]]
    else:
        lo1 = torch.full_like(lo0, I32_MIN)
        hi1 = torch.full_like(hi0, I32_MAX)
    return packed_keys(lo0, lo1), packed_keys(hi0, hi1)


class _Probe(NamedTuple):
    """The probed index entries of a batch of B queries over S stacked
    shards (a plain table is S = 1), flattened segment by segment:
    segment ``s * B + q`` holds query q's entries in shard s's index,
    the contiguous range [bounds[seg], bounds[seg + 1])."""

    seg: torch.Tensor  # (E,) int64 segment of each entry
    qid: torch.Tensor  # (E,) int64 query of each entry
    bounds: torch.Tensor  # (S * B + 1,) int64 segment boundaries
    spans: list  # the same boundaries as host ints
    rids: torch.Tensor  # (E,) int64 stacked row (== local rid at S = 1)
    page: torch.Tensor  # (E,) int64 local page
    match: torch.Tensor  # (E,) bool: predicate and visibility hold
    vals: torch.Tensor  # (E,) int32 aggregate column
    entries_probed: torch.Tensor  # (S * B,) int32


def _probe_stacked(st: ShardedTable, index: ShardedIndex, key_attrs,
                   attrs, los, his, tss, agg_attr) -> _Probe:
    """Probe the S stacked indexes of a sharded table at once (local
    rids).  Each shard's entries in a query's key range are found by
    binary search (``index_range_bounds``)."""
    data = st.data
    dev = data.device
    S, B = data.shape[0], los.shape[0]
    psz = data.shape[2]
    start, stop = index_range_bounds(
        index, *_predicate_key_bounds(key_attrs, attrs, los, his))
    cnt = (stop - start).reshape(-1)
    bounds = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(cnt, 0)])
    spans = bounds.tolist()
    total = spans[-1]
    seg = torch.repeat_interleave(torch.arange(S * B, device=dev), cnt,
                                  output_size=total)
    pos = start.reshape(-1)[seg] + torch.arange(total, device=dev) - \
        bounds[seg]
    shard = seg // B
    flat = rows_view(data)  # attribute-major: flat[:, a] is one plane
    with torch.profiler.record_function(GATHER_RANGE):
        local = index.rids.reshape(-1)[shard * index.rids.shape[1] + pos].to(
            torch.int64)
        rows = shard * (data.shape[1] * psz) + local
        cols = [flat[:, a][rows] for a in attrs]
        begin = st.begin_ts.reshape(-1)[rows]
        end = st.end_ts.reshape(-1)[rows]
        vals = flat[:, agg_attr][rows]
    qid = seg % B
    match = torch.ones(total, dtype=torch.bool, device=dev)
    for k, col in enumerate(cols):
        match &= (col >= los[qid, k]) & (col <= his[qid, k])
    ts = tss[qid]
    match &= (begin <= ts) & (ts < end)
    return _Probe(seg, qid, bounds, spans, rows, local // psz, match, vals,
                  cnt.to(torch.int32))


def _probe(table: Table, index: AdHocIndex, key_attrs, attrs, los, his,
           tss, agg_attr) -> _Probe:
    """``_probe_stacked`` for one plain table and its index, viewed as
    one shard (segments are queries, rows are rids)."""
    st = ShardedTable(table.data[None], table.begin_ts[None],
                      table.end_ts[None], (table.n_pages,),
                      (table.n_rows,), table.n_rows)
    six = ShardedIndex(index.key_hi[None], index.key_lo[None],
                       index.rids[None], (index.n_entries,),
                       (index.built_pages,), (index.capacity,))
    return _probe_stacked(st, six, key_attrs, attrs, los, his, tss,
                          agg_attr)


def _segment_sums(pr: _Probe, keep):
    """Per-segment int32 (sum, count) of the kept entries, as
    differences of running int64 sums at the segment boundaries (no
    atomics: a burst's entries fall into only S * B segments)."""
    zero = torch.zeros(1, dtype=torch.int64, device=keep.device)
    vals = torch.where(keep, pr.vals, 0).to(torch.int64)
    csum = torch.cat([zero, torch.cumsum(vals, 0)])
    ccnt = torch.cat([zero, torch.cumsum(keep.to(torch.int64), 0)])
    lo, hi = pr.bounds[:-1], pr.bounds[1:]
    return ((csum[hi] - csum[lo]).to(torch.int32),
            (ccnt[hi] - ccnt[lo]).to(torch.int32))


def _segment_max_page(pr: _Probe, page=None):
    """Per segment: the largest page (``pr.page``, or the given per-entry
    page ids) holding a matching entry, else -1 (rho_m) -- one
    reduction over each segment."""
    marked = torch.where(pr.match, pr.page if page is None else page, -1)
    parts = [marked[a:b].amax() if b > a else marked.new_tensor(-1)
             for a, b in zip(pr.spans[:-1], pr.spans[1:])]
    return torch.stack(parts) if parts else marked.new_empty(0)


def _hybrid_prefix(table, index, key_attrs, attrs, los, his, tss,
                   agg_attr):
    """Index half of B hybrid scans: (HybridPrefixResult, probe, keep)."""
    pr = _probe(table, index, key_attrs, attrs, los, his, tss, agg_attr)
    rho_m = _segment_max_page(pr)
    start_page = torch.clamp(rho_m, min=index.built_pages)  # rho_i + 1
    keep = pr.match & (pr.page < start_page[pr.seg])
    s, c = _segment_sums(pr, keep)
    res = HybridPrefixResult(s, c, pr.entries_probed,
                             start_page.to(torch.int32))
    return res, pr, keep


def _table_suffix(table: Table, attrs, los, his, tss, agg_attr, start_pages):
    """Plain table side of B scans: (sums, counts, masks) over pages >=
    start_pages[q] (``masks`` is the list of per-query row masks)."""
    page_ids = torch.arange(table.n_pages, device=table.device)
    return _table_side(table, attrs, los, his, tss, agg_attr,
                       page_ids[None, :] >= start_pages[:, None])


def _table_side(table, attrs, los, his, tss, agg_attr, page_ok):
    """Plain table side of B scans over the pages ``page_ok`` selects
    for each query: (B, n_pages) bool on a ``Table``, (B, S,
    max_pages) on a ``ShardedTable`` (summed over shards).  Returns
    (sums, counts, masks)."""
    vals = table.data[..., agg_attr]
    sums, cnts, masks = [], [], []
    for q in range(los.shape[0]):
        mask = conj_predicate_mask(table, attrs, los[q], his[q])
        mask &= visible_mask(table, tss[q])
        mask &= page_ok[q][..., None]
        sums.append(i32_sum(torch.where(mask, vals, 0)))
        cnts.append(i32_sum(mask))
        masks.append(mask)
    if not sums:
        z = torch.zeros((0,), dtype=torch.int32, device=table.device)
        return z, z.clone(), masks
    return torch.stack(sums), torch.stack(cnts), masks


def _used_pages(table) -> int:
    """Global pages up to the append watermark (headroom pages beyond
    it hold no tuples and are not charged); either storage."""
    return -(-table.n_rows // table.page_size)


def _pages_after(table, start_page):
    return torch.clamp(_used_pages(table) - start_page.to(torch.int64),
                       min=0).to(torch.int32)


def _single(table, attrs, los, his, ts):
    dev = table.device
    k = len(attrs)
    return (_bounds(los, k, dev), _bounds(his, k, dev),
            torch.as_tensor([int(ts)], dtype=torch.int32, device=dev))


def _contrib(table, rids, keep, tbl_mask):
    contrib = torch.zeros(table.capacity, dtype=torch.int32,
                          device=table.device)
    contrib.index_add_(0, rids, keep.to(torch.int32))
    contrib = contrib.view(table.n_pages, table.page_size)
    if tbl_mask is not None:
        contrib = contrib + tbl_mask.to(torch.int32)
    return contrib


# ---------------------------------------------------------------------------
# Single-query operators
# ---------------------------------------------------------------------------

def hybrid_scan(table: Table, index: AdHocIndex, key_attrs: tuple,
                attrs: tuple, los, his, ts, agg_attr: int) -> ScanResult:
    """Value-agnostic hybrid scan: index prefix + table suffix."""
    los, his, tss = _single(table, attrs, los, his, ts)
    pre, pr, keep = _hybrid_prefix(table, index, key_attrs, attrs, los, his,
                                   tss, agg_attr)
    tbl_s, tbl_c, masks = _table_suffix(table, attrs, los, his, tss,
                                        agg_attr, pre.start_page)
    return ScanResult(
        add_i32(pre.agg_sum, tbl_s)[0],
        add_i32(pre.count, tbl_c)[0],
        _contrib(table, pr.rids, keep, masks[0]),
        _pages_after(table, pre.start_page)[0],
        pre.entries_probed[0],
        pre.start_page[0],
    )


def pure_index_scan(table: Table, index: AdHocIndex, key_attrs: tuple,
                    attrs: tuple, los, his, ts, agg_attr: int) -> ScanResult:
    """Index-only scan -- legal only when the index covers the predicate
    (FULL scheme with a complete index)."""
    los, his, tss = _single(table, attrs, los, his, ts)
    pr = _probe(table, index, key_attrs, attrs, los, his, tss, agg_attr)
    s, c = _segment_sums(pr, pr.match)
    dev = table.device
    return ScanResult(
        s[0],
        c[0],
        _contrib(table, pr.rids, pr.match, None),
        torch.zeros((), dtype=torch.int32, device=dev),
        pr.entries_probed[0],
        torch.tensor(table.n_pages, dtype=torch.int32, device=dev),
    )


def full_table_scan(table: Table, attrs: tuple, los, his, ts,
                    agg_attr: int) -> ScanResult:
    """Plain table scan (no usable index)."""
    dev = table.device
    tbl_mask = conj_predicate_mask(table, attrs, los, his)
    tbl_mask &= visible_mask(table, ts)
    vals = table.data[:, :, agg_attr]
    z = torch.zeros((), dtype=torch.int32, device=dev)
    return ScanResult(
        i32_sum(torch.where(tbl_mask, vals, 0)),
        i32_sum(tbl_mask),
        tbl_mask.to(torch.int32),
        torch.tensor(_used_pages(table), dtype=torch.int32, device=dev),
        z,
        z.clone(),
    )


# ---------------------------------------------------------------------------
# Batched multi-query scans (the executor's read-burst substrate)
# ---------------------------------------------------------------------------

def batched_full_table_scan(table: Table, attrs: tuple, los, his, tss,
                            agg_attr: int) -> BatchScanResult:
    """B plain table scans."""
    dev = table.device
    los, his = _bounds(los, len(attrs), dev), _bounds(his, len(attrs), dev)
    tss = torch.as_tensor(tss, dtype=torch.int32, device=dev)
    B = los.shape[0]
    z = torch.zeros((B,), dtype=torch.int32, device=dev)
    s, c, _ = _table_suffix(table, attrs, los, his, tss, agg_attr, z)
    used = torch.full((B,), _used_pages(table), dtype=torch.int32,
                      device=dev)
    return BatchScanResult(s, c, used, z, z.clone())


def batched_hybrid_index_prefix(table: Table, index: AdHocIndex,
                                key_attrs: tuple, attrs: tuple, los, his,
                                tss, agg_attr: int) -> HybridPrefixResult:
    """B hybrid-scan index prefixes + stitch points."""
    dev = table.device
    los, his = _bounds(los, len(attrs), dev), _bounds(his, len(attrs), dev)
    tss = torch.as_tensor(tss, dtype=torch.int32, device=dev)
    return _hybrid_prefix(table, index, key_attrs, attrs, los, his, tss,
                          agg_attr)[0]


def batched_hybrid_scan(table: Table, index: AdHocIndex, key_attrs: tuple,
                        attrs: tuple, los, his, tss,
                        agg_attr: int) -> BatchScanResult:
    """B hybrid scans over one shared partial index, table side plain."""
    dev = table.device
    los, his = _bounds(los, len(attrs), dev), _bounds(his, len(attrs), dev)
    tss = torch.as_tensor(tss, dtype=torch.int32, device=dev)
    pre = _hybrid_prefix(table, index, key_attrs, attrs, los, his, tss,
                         agg_attr)[0]
    s, c, _ = _table_suffix(table, attrs, los, his, tss, agg_attr,
                            pre.start_page)
    return BatchScanResult(
        add_i32(pre.agg_sum, s),
        add_i32(pre.count, c),
        _pages_after(table, pre.start_page),
        pre.entries_probed,
        pre.start_page,
    )


def batched_pure_index_scan(table: Table, index: AdHocIndex,
                            key_attrs: tuple, attrs: tuple, los, his, tss,
                            agg_attr: int) -> BatchScanResult:
    """B index-only scans (same legality as ``pure_index_scan``)."""
    dev = table.device
    los, his = _bounds(los, len(attrs), dev), _bounds(his, len(attrs), dev)
    tss = torch.as_tensor(tss, dtype=torch.int32, device=dev)
    B = los.shape[0]
    pr = _probe(table, index, key_attrs, attrs, los, his, tss, agg_attr)
    s, c = _segment_sums(pr, pr.match)
    return BatchScanResult(
        s,
        c,
        torch.zeros((B,), dtype=torch.int32, device=dev),
        pr.entries_probed,
        torch.full((B,), table.n_pages, dtype=torch.int32, device=dev),
    )


# ---------------------------------------------------------------------------
# Masked (coverage-bitmap) stitch
# ---------------------------------------------------------------------------

def _masked_index_side(table, index, key_attrs, attrs, los, his, tss,
                       agg_attr, covered, prefix_len):
    """Index half of B masked scans: matches on covered pages only.
    Returns (HybridPrefixResult, probe, keep)."""
    pr = _probe(table, index, key_attrs, attrs, los, his, tss, agg_attr)
    keep = pr.match & covered[pr.page]
    s, c = _segment_sums(pr, keep)
    B = los.shape[0]
    start = torch.full((B,), int(prefix_len), dtype=torch.int32,
                       device=table.device)
    return HybridPrefixResult(s, c, pr.entries_probed, start), pr, keep


def _masked_pages_scanned(table: Table, covered) -> int:
    """Uncovered pages up to the append watermark."""
    return int((~covered[: _used_pages(table)]).sum())


def _masked_scan_core(table, index, key_attrs, attrs, los, his, tss,
                      agg_attr, covered, prefix_len):
    """Shared masked-stitch body for B queries: (BatchScanResult,
    probe, keep, per-query table masks)."""
    pre, pr, keep = _masked_index_side(table, index, key_attrs, attrs, los,
                                       his, tss, agg_attr, covered,
                                       prefix_len)
    B = los.shape[0]
    s, c, masks = _table_side(table, attrs, los, his, tss, agg_attr,
                              (~covered)[None, :].expand(B, -1))
    pages = torch.full((B,), _masked_pages_scanned(table, covered),
                       dtype=torch.int32, device=table.device)
    res = BatchScanResult(add_i32(pre.agg_sum, s), add_i32(pre.count, c),
                          pages, pre.entries_probed, pre.start_page)
    return res, pr, keep, masks


def hybrid_scan_masked(table: Table, index: AdHocIndex, key_attrs: tuple,
                       attrs: tuple, los, his, ts, agg_attr: int, covered,
                       prefix_len) -> ScanResult:
    """Bitmap-stitched hybrid scan: index over covered pages, table
    scan over exactly the uncovered ones.  ``covered`` is (n_pages,)
    bool, ``prefix_len`` the leading built run reported as
    ``start_page``."""
    los, his, tss = _single(table, attrs, los, his, ts)
    res, pr, keep, masks = _masked_scan_core(
        table, index, key_attrs, attrs, los, his, tss, agg_attr, covered,
        prefix_len)
    return ScanResult(res.agg_sum[0], res.count[0],
                      _contrib(table, pr.rids, keep, masks[0]),
                      res.pages_scanned[0], res.entries_probed[0],
                      res.start_page[0])


def batched_hybrid_scan_masked(table: Table, index: AdHocIndex,
                               key_attrs: tuple, attrs: tuple, los, his,
                               tss, agg_attr: int, covered,
                               prefix_len) -> BatchScanResult:
    """B bitmap-stitched hybrid scans (the coverage mask is shared:
    it is index state, not query state); table side plain."""
    dev = table.device
    los, his = _bounds(los, len(attrs), dev), _bounds(his, len(attrs), dev)
    tss = torch.as_tensor(tss, dtype=torch.int32, device=dev)
    return _masked_scan_core(table, index, key_attrs, attrs, los, his, tss,
                             agg_attr, covered, prefix_len)[0]


def batched_masked_index_side(table: Table, index: AdHocIndex,
                              key_attrs: tuple, attrs: tuple, los, his, tss,
                              agg_attr: int, covered,
                              prefix_len) -> HybridPrefixResult:
    """Index side of B masked hybrid scans: the companion of the masked
    table suffix on K3 (``ops.scan_table_batched_masked``).  Adding
    K3's uncovered-page aggregates gives ``batched_hybrid_scan_masked``
    bit for bit."""
    dev = table.device
    los, his = _bounds(los, len(attrs), dev), _bounds(his, len(attrs), dev)
    tss = torch.as_tensor(tss, dtype=torch.int32, device=dev)
    return _masked_index_side(table, index, key_attrs, attrs, los, his, tss,
                              agg_attr, covered, prefix_len)[0]
