"""Plain PyTorch oracles for the scan kernels.

The semantics contracts, ported from ``repro.kernels.ref`` (K3 and K4
follow the reference kernels' docstrings): every
kernel of this package must equal these exactly (integer results)
across the shapes in tests/test_torch_kernels.py.  Sums are taken in
int64 and cast back to int32, which wraps exactly like the
reference's int32 accumulation.
"""

from __future__ import annotations

import torch


def i32_sum(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Sum of an int32 or bool tensor with int32 wraparound."""
    s = x.sum(dtype=torch.int64) if dim is None else x.sum(
        dim=dim, dtype=torch.int64)
    return s.to(torch.int32)


def filter_agg_ref(
    pred0, pred1, agg, begin_ts, end_ts, lo0, hi0, lo1, hi1, ts
):
    """Predicate-filter + aggregate over a paged column layout.

    pred0/pred1/agg/begin_ts/end_ts : (n_pages, page_size) int32
    bounds, ts                      : scalars (int32)

    Returns (sum, count) int32 -- SUM(agg) and COUNT(*) over rows with
    lo0 <= pred0 <= hi0  AND  lo1 <= pred1 <= hi1  visible at ``ts``.
    Single-attribute predicates pass lo1 = INT32_MIN, hi1 = INT32_MAX.
    """
    mask = (pred0 >= lo0) & (pred0 <= hi0) & (pred1 >= lo1) & (pred1 <= hi1)
    mask &= (begin_ts <= ts) & (ts < end_ts)
    return i32_sum(torch.where(mask, agg, 0)), i32_sum(mask)


def masked_filter_agg_ref(
    pred0, pred1, agg, begin_ts, end_ts, lo0, hi0, lo1, hi1, ts, start_page
):
    """The hybrid scan's table-scan suffix: same as ``filter_agg_ref``
    but only pages >= start_page contribute."""
    n_pages = pred0.shape[0]
    page_ids = torch.arange(n_pages, device=pred0.device)[:, None]
    mask = (pred0 >= lo0) & (pred0 <= hi0) & (pred1 >= lo1) & (pred1 <= hi1)
    mask &= (begin_ts <= ts) & (ts < end_ts)
    mask &= page_ids >= start_page
    return i32_sum(torch.where(mask, agg, 0)), i32_sum(mask)


def batched_filter_agg_ref(
    pred0,
    pred1,
    agg,
    begin_ts,
    end_ts,
    los0,
    his0,
    los1,
    his1,
    tss,
    start_pages,
):
    """Multi-query scan: per query q identical to
    ``masked_filter_agg_ref`` with that query's bounds, snapshot and
    start_page.  Per-query operands are (n_queries,); returns
    (sums, counts), each (n_queries,) int32."""
    sums, cnts = [], []
    for q in range(los0.shape[0]):
        s, c = masked_filter_agg_ref(
            pred0,
            pred1,
            agg,
            begin_ts,
            end_ts,
            los0[q],
            his0[q],
            los1[q],
            his1[q],
            tss[q],
            start_pages[q],
        )
        sums.append(s)
        cnts.append(c)
    return torch.stack(sums), torch.stack(cnts)


def sharded_batched_filter_agg_ref(
    pred0,
    pred1,
    agg,
    begin_ts,
    end_ts,
    los0,
    his0,
    los1,
    his1,
    tss,
    start_pages,
    local_pages,
):
    """Multi-shard multi-query scan (kernel K4).

    Planes are (S, n_pages, page_size) int32 stacked per shard;
    per-query operands (n_queries,); ``start_pages`` (S, n_queries) the
    per-(shard, query) LOCAL stitch points; ``local_pages`` (S,) each
    shard's real page count.  Per query, the rows of
    ``filter_agg_ref`` summed over shards s and local pages p with
    ``start_pages[s, q] <= p < local_pages[s]`` (padding pages past
    ``local_pages`` contribute nothing).  Returns (sums, counts), each
    (n_queries,) int32.
    """
    S, n_pages, _ = pred0.shape
    page = torch.arange(n_pages, device=pred0.device)
    real = (page[None, :] < local_pages[:, None])[:, :, None]
    sums, cnts = [], []
    for q in range(los0.shape[0]):
        mask = (pred0 >= los0[q]) & (pred0 <= his0[q])
        mask &= (pred1 >= los1[q]) & (pred1 <= his1[q])
        mask &= (begin_ts <= tss[q]) & (tss[q] < end_ts)
        mask &= real & (page[None, :, None] >= start_pages[:, q, None, None])
        sums.append(i32_sum(torch.where(mask, agg, 0)))
        cnts.append(i32_sum(mask))
    if not sums:
        z = torch.zeros((0,), dtype=torch.int32, device=pred0.device)
        return z, z.clone()
    return torch.stack(sums), torch.stack(cnts)


def sharded_batched_filter_agg_masked_ref(
    pred0,
    pred1,
    agg,
    begin_ts,
    end_ts,
    los0,
    his0,
    los1,
    his1,
    tss,
    words,
    local_pages,
):
    """Multi-shard multi-query scan of the UNCOVERED pages (kernel K3).

    Planes are (S, n_pages, page_size) int32; per-query operands
    (n_queries,); ``words`` (S, W) int32 packed little-endian coverage
    words (bit ``p & 31`` of word ``p >> 5`` is local page p's built
    flag) with W * 32 >= n_pages; ``local_pages`` (S,) each shard's
    real page count.  Per query and shard, one whole-table mask: rows
    of ``filter_agg_ref`` whose page p has ``covered[p] == 0`` and
    ``p < local_pages[s]``.  Returns (sums, counts), each (n_queries,)
    int32, summed over shards.
    """
    S, n_pages, _ = pred0.shape
    W = words.shape[1]
    if W * 32 < n_pages:
        raise ValueError(f"{W} coverage words cannot cover {n_pages} pages")
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = ((words[:, :, None] >> shifts) & 1).reshape(S, W * 32)
    page = torch.arange(n_pages, device=words.device)
    open_page = (bits[:, :n_pages] == 0) & (page[None, :]
                                            < local_pages[:, None])
    open_page = open_page[:, :, None]
    sums, cnts = [], []
    for q in range(los0.shape[0]):
        mask = (pred0 >= los0[q]) & (pred0 <= his0[q])
        mask &= (pred1 >= los1[q]) & (pred1 <= his1[q])
        mask &= (begin_ts <= tss[q]) & (tss[q] < end_ts)
        mask &= open_page
        sums.append(i32_sum(torch.where(mask, agg, 0)))
        cnts.append(i32_sum(mask))
    if not sums:
        z = torch.zeros((0,), dtype=torch.int32, device=pred0.device)
        return z, z.clone()
    return torch.stack(sums), torch.stack(cnts)
