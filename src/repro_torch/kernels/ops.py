"""Table adapters around the scan kernels.

Port of ``repro.kernels.ops``: ``scan_table`` /
``scan_table_hybrid`` (K2), ``scan_table_batched`` (K1) and
``scan_table_batched_masked`` (K3, one shard) adapt the engine's Table
layout -- columns stacked in one (n_pages, page_size, n_attrs) array
-- to the kernels' column-plane interface.  The planes are views of
``table.data``, which the port stores attribute-major, so each plane
is one unit-stride run; nothing is copied.  The K1, K2 and K4
adapters take an optional ``block_pages`` tile; results do not depend
on it.  The page-count operand of K3 and K4 is made once per table
state (``Table.local_pages_tensor``), not on every launch.

``scan_shards_batched`` (K4) and ``scan_shards_batched_masked`` (K3)
adapt a ``ShardedTable`` -- already the stacked (S, max_pages,
page_size, n_attrs) layout, padding pages invisible -- the same way.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import batched_filter_agg as _bfa
from repro_torch.kernels import filter_agg as _fa

I32_MIN = _fa.I32_MIN
I32_MAX = _fa.I32_MAX


def _single_bounds(table, attrs, los, his):
    """Predicate planes + widened bounds for a single-query scan."""
    pred0 = table.data[:, :, attrs[0]]
    lo0, hi0 = los[0], his[0]
    if len(attrs) == 2:
        pred1 = table.data[:, :, attrs[1]]
        lo1, hi1 = los[1], his[1]
    else:
        pred1 = pred0
        lo1, hi1 = I32_MIN, I32_MAX
    return pred0, pred1, lo0, hi0, lo1, hi1


def _batch_bounds(data, attrs, los, his):
    """Split per-query (B, len(attrs)) bounds into the kernels' two
    predicate-plane/bounds pairs (1-attr queries widen the second)."""
    los = torch.as_tensor(los, dtype=torch.int32, device=data.device)
    his = torch.as_tensor(his, dtype=torch.int32, device=data.device)
    n_queries = los.shape[0]
    pred0 = data[..., attrs[0]]
    los0, his0 = los[:, 0].contiguous(), his[:, 0].contiguous()
    if len(attrs) == 2:
        pred1 = data[..., attrs[1]]
        los1, his1 = los[:, 1].contiguous(), his[:, 1].contiguous()
    else:
        pred1 = pred0
        los1 = torch.full((n_queries,), I32_MIN, dtype=torch.int32,
                          device=data.device)
        his1 = torch.full((n_queries,), I32_MAX, dtype=torch.int32,
                          device=data.device)
    return pred0, pred1, los0, his0, los1, his1


def _check_attrs(attrs):
    if len(attrs) not in (1, 2):
        raise ValueError(
            f"kernel scans support 1 or 2 predicate attributes, "
            f"got {attrs!r}"
        )


def scan_table(table, attrs, los, his, ts, agg_attr, block_pages=None):
    """Full-table filter+aggregate of one query via K2."""
    _check_attrs(attrs)
    pred0, pred1, lo0, hi0, lo1, hi1 = _single_bounds(table, attrs, los, his)
    return _fa.filter_agg(
        pred0,
        pred1,
        table.data[:, :, agg_attr],
        table.begin_ts,
        table.end_ts,
        lo0,
        hi0,
        lo1,
        hi1,
        ts,
        block_pages=block_pages,
    )


def scan_table_hybrid(
    table, attrs, los, his, ts, agg_attr, start_page, block_pages=None
):
    """The hybrid scan's table-scan suffix via K2: pages >= start_page
    only; tiles wholly inside the indexed prefix load nothing."""
    _check_attrs(attrs)
    pred0, pred1, lo0, hi0, lo1, hi1 = _single_bounds(table, attrs, los, his)
    return _fa.filter_agg(
        pred0,
        pred1,
        table.data[:, :, agg_attr],
        table.begin_ts,
        table.end_ts,
        lo0,
        hi0,
        lo1,
        hi1,
        ts,
        start_page=int(start_page),
        block_pages=block_pages,
    )


def scan_table_batched(
    table, attrs, los, his, tss, agg_attr, start_pages=None, block_pages=None
):
    """Batched multi-query filter+aggregate via K1.

    All queries share the table, the constrained ``attrs`` (1 or 2
    columns) and ``agg_attr``; ``los``/``his`` are (n_queries,
    len(attrs)) per-query inclusive bounds, ``tss`` (n_queries,)
    snapshot timestamps, ``start_pages`` (n_queries,) hybrid-scan
    stitch points (None = full scans).  Returns (sums, counts), each
    (n_queries,) int32.
    """
    _check_attrs(attrs)
    dev = table.data.device
    pred0, pred1, los0, his0, los1, his1 = _batch_bounds(
        table.data, attrs, los, his
    )
    n_queries = los0.shape[0]
    if start_pages is None:
        start_pages = torch.zeros((n_queries,), dtype=torch.int32,
                                  device=dev)
    return _bfa.batched_filter_agg(
        pred0,
        pred1,
        table.data[..., agg_attr],
        table.begin_ts,
        table.end_ts,
        los0,
        his0,
        los1,
        his1,
        torch.as_tensor(tss, dtype=torch.int32, device=dev),
        torch.as_tensor(start_pages, dtype=torch.int32, device=dev),
        block_pages=block_pages,
    )


def scan_table_batched_masked(table, attrs, los, his, tss, agg_attr, words):
    """Masked-stitch table suffix over a plain Table via K3: scans
    exactly the UNCOVERED pages of the coverage bitmap whose packed
    words are ``words`` ((1, W) int32, ``PageCoverage.packed_words``).
    Returns (sums, counts), each (n_queries,) int32 -- the caller adds
    the covered-page index half (``hybrid_scan.
    batched_masked_index_side``).  A one-shard launch of K3."""
    _check_attrs(attrs)
    dev = table.data.device
    pred0, pred1, los0, his0, los1, his1 = _batch_bounds(
        table.data, attrs, los, his
    )
    return _bfa.sharded_batched_filter_agg_masked(
        pred0[None],
        pred1[None],
        table.data[..., agg_attr][None],
        table.begin_ts[None],
        table.end_ts[None],
        los0,
        his0,
        los1,
        his1,
        torch.as_tensor(tss, dtype=torch.int32, device=dev),
        torch.as_tensor(words, dtype=torch.int32, device=dev),
        table.local_pages_tensor(),
    )


def scan_shards_batched(
    st, attrs, los, his, tss, agg_attr, start_pages, block_pages=None
):
    """Multi-shard multi-query filter+aggregate via K4.

    ``st`` is a ``ShardedTable``; queries share the constrained
    ``attrs`` (1 or 2 columns) and ``agg_attr``; ``los``/``his`` are
    (n_queries, len(attrs)) per-query inclusive bounds, ``tss``
    (n_queries,) snapshot timestamps and ``start_pages`` the (n_shards,
    n_queries) table of per-shard LOCAL stitch points (zeros = full
    scans).  Returns (sums, counts), each (n_queries,) int32, summed
    over shards.
    """
    _check_attrs(attrs)
    dev = st.data.device
    pred0, pred1, los0, his0, los1, his1 = _batch_bounds(
        st.data, attrs, los, his
    )
    return _bfa.sharded_batched_filter_agg(
        pred0,
        pred1,
        st.data[..., agg_attr],
        st.begin_ts,
        st.end_ts,
        los0,
        his0,
        los1,
        his1,
        torch.as_tensor(tss, dtype=torch.int32, device=dev),
        torch.as_tensor(start_pages, dtype=torch.int32, device=dev),
        st.local_pages_tensor(),
        block_pages=block_pages,
    )


def scan_shards_batched_masked(st, attrs, los, his, tss, agg_attr, words):
    """Masked-stitch table half over every shard of a ``ShardedTable``
    in one K3 launch: exactly the UNCOVERED pages of each shard's
    packed coverage words ``words`` (S, W) int32
    (``PageCoverage.packed_words(S, max_pages)``).  Same operands as
    ``scan_shards_batched`` with the start pages replaced by the
    words."""
    _check_attrs(attrs)
    dev = st.data.device
    pred0, pred1, los0, his0, los1, his1 = _batch_bounds(
        st.data, attrs, los, his
    )
    return _bfa.sharded_batched_filter_agg_masked(
        pred0,
        pred1,
        st.data[..., agg_attr],
        st.begin_ts,
        st.end_ts,
        los0,
        his0,
        los1,
        his1,
        torch.as_tensor(tss, dtype=torch.int32, device=dev),
        torch.as_tensor(words, dtype=torch.int32, device=dev),
        st.local_pages_tensor(),
    )
