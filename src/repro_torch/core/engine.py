"""Scan engine: turns planned scans into dispatches.

Port of ``repro.core.engine.ScanEngine`` without the mesh.  The engine
receives an access path, raw index state and per-query bounds, and
owns the dispatch strategy:

* ``scan`` -- one query through the single-query operators of
  ``hybrid_scan`` (plain PyTorch; no kernel, as in the reference).
* ``scan_batch`` -- one dispatch per plan group of a read burst.  With
  ``use_kernel`` the table scans and the table half of hybrid scans run
  on the hand-written multi-query CUDA kernel K1
  (``kernels.ops.scan_table_batched``); the hybrid path stitches K1's
  per-query ``start_pages`` suffix to the index prefix.  The masked
  (coverage-bitmap) path runs its uncovered-page table half on kernel
  K3 (``kernels.ops.scan_table_batched_masked``, one shard) beside the
  covered-page index half.  Without ``use_kernel`` they run the plain
  PyTorch batched forms.

On a ``ShardedTable`` every batched family is ONE dispatch over the
stacked shard axis (the table and its ``ShardedIndex`` are stacked
already): the index half probes all shards' indexes in one pass
(``hybrid_scan._probe_stacked``, segments per (shard, query)), the
table half masks the stacked planes, and per-shard partials are
summed with int32 wraparound, which is exact in any order.  With
``use_kernel`` the table half runs on kernel K4 (``kernels.ops.
scan_shards_batched``) from one (S, B) table of LOCAL start pages --
zeros for full scans, the global stitch point mapped to each shard's
local pages for ``hybrid``, each shard's own stitch point for
``hybrid_ps`` -- and the masked half on K3 over all shards.  The
global stitch point is ``max(rho_m, built)`` with rho_m the largest
matched GLOBAL page (local page ``pg`` of shard s is global page
``pg * S + s``); shard s's local start is ``ceil((g - s) / S)``
clipped at 0.  The per-shard stitch (``hybrid_ps``, planned for
shard-targeted builds and layouts that are not round-robin) needs no
cross-shard reduction: each shard stitches on its own prefix, and
``start_page`` reports the smallest ``lstart * S + s``.

Every dispatch records its execution tier in ``last_tier`` (vocabulary
``TIERS``): ``kernel`` for a kernel dispatch; otherwise ``single`` on
a plain table, ``vmap-stacked`` for a sharded batch and ``loop`` for
a sharded single-query scan, as in the reference.  One card has no
mesh (the reference's ``make_scan_mesh`` returns None below two
devices), so no dispatch here takes the mesh tiers.

A pure VBP scan (``pure_vbp``) runs the pure index scan's operators on
the VBP index's entries, as ``pure_vap`` does, on every path.  A
join's outer scan over sharded storage also returns each shard's
contrib plane (``ShardScanResult.contribs``): the join reads the
outer rows from them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.hybrid_scan import (
    BatchScanResult,
    HybridPrefixResult,
    _bounds,
    _pages_after,
    _probe_stacked,
    _segment_max_page,
    _segment_sums,
    _table_side,
    _used_pages,
    add_i32,
    batched_full_table_scan,
    batched_hybrid_index_prefix,
    batched_hybrid_scan,
    batched_hybrid_scan_masked,
    batched_masked_index_side,
    batched_pure_index_scan,
    full_table_scan,
    hybrid_scan,
    hybrid_scan_masked,
    pure_index_scan,
)
from repro_torch.core.index import AdHocIndex, ShardedIndex
from repro_torch.core.table import ShardedTable, Table
from repro_torch.kernels import ops as _kops
from repro_torch.kernels.ref import i32_sum


PURE_INDEX_PATHS = ("pure_vbp", "pure_vap")


def _check(table) -> None:
    if not isinstance(table, (Table, ShardedTable)):
        raise TypeError(f"no scan over {type(table).__name__}")


class ShardScanResult(NamedTuple):
    """Single-query aggregates + accounting over sharded storage: the
    scalar fields are 0-d int32 and bit-identical to the single-shard
    ``ScanResult``'s.  ``contribs``, built only for a join's outer scan
    (None otherwise), holds one (local_pages, page_size) int32 plane
    per shard -- times each row was returned, 0 or 1 -- stacked as (S,
    max_pages, page_size) with zero padding pages (shard s's plane is
    ``contribs[s, :local_pages[s]]``)."""

    agg_sum: torch.Tensor
    count: torch.Tensor
    contribs: Optional[torch.Tensor]
    pages_scanned: torch.Tensor
    entries_probed: torch.Tensor
    start_page: torch.Tensor


# ---------------------------------------------------------------------------
# Stacked batched scans over sharded storage: ONE dispatch for any S
# ---------------------------------------------------------------------------

def _fold(x, n_shards: int):
    """(S * B,) per-(shard, query) partials -> (B,) int32 sums with
    int32 wraparound."""
    return i32_sum(x.reshape(n_shards, -1), dim=0)


def _prefix_result(st, pr, keep, start_page):
    """Fold the kept entries' segment sums over shards."""
    S = st.n_shards
    s, c = _segment_sums(pr, keep)
    return HybridPrefixResult(_fold(s, S), _fold(c, S),
                              _fold(pr.entries_probed, S),
                              start_page.to(torch.int32))


def _stacked_hybrid_prefix(st, six, key_attrs, attrs, los, his, tss,
                           agg_attr):
    """Global-stitch index half of B hybrid scans: the per-query stitch
    point ``max(rho_m, built)`` over global page ids, the index matches
    below it, and each shard's LOCAL start ``ceil((g - s) / S)``
    clipped at 0.  Returns (HybridPrefixResult, local_starts (S, B),
    probe, kept entries)."""
    S, B = st.n_shards, los.shape[0]
    pr = _probe_stacked(st, six, key_attrs, attrs, los, his, tss, agg_attr)
    gpage = pr.page * S + pr.seg // B
    rho_m = _segment_max_page(pr, gpage).reshape(S, B).amax(0)
    start = torch.clamp(rho_m, min=six.built_pages)  # rho_i + 1
    keep = pr.match & (gpage < start[pr.qid])
    sid = torch.arange(S, device=st.device)[:, None]
    local = torch.div(start[None, :] - sid + S - 1, S, rounding_mode="floor")
    local = torch.clamp(local, min=0).to(torch.int32)
    return _prefix_result(st, pr, keep, start), local, pr, keep


def _stacked_hybrid_prefix_ps(st, six, key_attrs, attrs, los, his, tss,
                              agg_attr):
    """Per-shard-stitch index half of B hybrid scans: each shard's
    local stitch point ``max(local rho_m, shard built)``.  Returns
    (HybridPrefixResult with start_page = min over shards of ``lstart
    * S + s``, local_starts (S, B), pages_scanned (B,), probe, kept
    entries)."""
    S, B = st.n_shards, los.shape[0]
    dev = st.device
    pr = _probe_stacked(st, six, key_attrs, attrs, los, his, tss, agg_attr)
    lrho = _segment_max_page(pr).reshape(S, B)
    built = torch.tensor(six.shard_built, device=dev)[:, None]
    lstart = torch.maximum(lrho, built)
    keep = pr.match & (pr.page < lstart.reshape(-1)[pr.seg])
    psz = st.page_size
    lused = torch.tensor([-(-r // psz) for r in st.local_rows],
                         device=dev)[:, None]
    pages = torch.clamp(lused - lstart, min=0).sum(0).to(torch.int32)
    sid = torch.arange(S, device=dev)[:, None]
    gstart = (lstart * S + sid).amin(0)
    return (_prefix_result(st, pr, keep, gstart), lstart.to(torch.int32),
            pages, pr, keep)


def _local_page_ok(st, local_starts):
    """(B, S, max_pages) bool: local page >= the (shard, query) start."""
    lp = torch.arange(st.max_pages, device=st.device)
    return lp[None, None, :] >= local_starts.T[:, :, None]


def _hybrid_result(pre, sums, cnts, pages):
    return BatchScanResult(add_i32(pre.agg_sum, sums),
                           add_i32(pre.count, cnts), pages,
                           pre.entries_probed, pre.start_page)


# Each family below returns the BatchScanResult, and with ``planes``
# also the (S, max_pages, page_size) contrib planes of its one query
# (``_contrib_planes``): only a join reads them.

def _contrib_planes(st, pr, keep, masks):
    """Times each stacked row was returned by one query: the kept index
    entries scattered at their rows (``pr`` None: no index half) plus
    the table half's row mask (``masks`` None: no table half)."""
    contribs = torch.zeros(st.begin_ts.numel(), dtype=torch.int32,
                           device=st.device)
    if pr is not None:
        contribs.index_add_(0, pr.rids, keep.to(torch.int32))
    contribs = contribs.view(st.begin_ts.shape)
    if masks is not None:
        contribs += masks[0].to(torch.int32)
    return contribs


def _stacked_batched_full(st, attrs, los, his, tss, agg_attr, planes=False):
    B = los.shape[0]
    dev = st.device
    ok = torch.ones((1, st.n_shards, st.max_pages), dtype=torch.bool,
                    device=dev).expand(B, -1, -1)
    s, c, masks = _table_side(st, attrs, los, his, tss, agg_attr, ok)
    z = torch.zeros((B,), dtype=torch.int32, device=dev)
    used = torch.full((B,), _used_pages(st), dtype=torch.int32, device=dev)
    r = BatchScanResult(s, c, used, z, z.clone())
    return (r, _contrib_planes(st, None, None, masks)) if planes else r


def _stacked_batched_hybrid(st, six, key_attrs, attrs, los, his, tss,
                            agg_attr, planes=False):
    pre, local, pr, keep = _stacked_hybrid_prefix(
        st, six, key_attrs, attrs, los, his, tss, agg_attr)
    s, c, masks = _table_side(st, attrs, los, his, tss, agg_attr,
                              _local_page_ok(st, local))
    r = _hybrid_result(pre, s, c, _pages_after(st, pre.start_page))
    return (r, _contrib_planes(st, pr, keep, masks)) if planes else r


def _stacked_batched_hybrid_ps(st, six, key_attrs, attrs, los, his, tss,
                               agg_attr, planes=False):
    pre, local, pages, pr, keep = _stacked_hybrid_prefix_ps(
        st, six, key_attrs, attrs, los, his, tss, agg_attr)
    s, c, masks = _table_side(st, attrs, los, his, tss, agg_attr,
                              _local_page_ok(st, local))
    r = _hybrid_result(pre, s, c, pages)
    return (r, _contrib_planes(st, pr, keep, masks)) if planes else r


def _stacked_batched_pure_index(st, six, key_attrs, attrs, los, his, tss,
                                agg_attr, planes=False):
    B = los.shape[0]
    pr = _probe_stacked(st, six, key_attrs, attrs, los, his, tss, agg_attr)
    start = torch.full((B,), st.n_pages, device=st.device)
    pre = _prefix_result(st, pr, pr.match, start)
    z = torch.zeros((B,), dtype=torch.int32, device=st.device)
    r = BatchScanResult(pre.agg_sum, pre.count, z, pre.entries_probed,
                        pre.start_page)
    return (r, _contrib_planes(st, pr, pr.match, None)) if planes else r


def _stacked_masked_prefix(st, six, key_attrs, attrs, los, his, tss,
                           agg_attr, cov):
    """Index half of B masked stitches: matches on covered pages only
    (``cov.mask`` (S, max_pages) over local page ids); ``start_page``
    reports the bitmap's leading built run.  Returns
    (HybridPrefixResult, probe, kept entries)."""
    B = los.shape[0]
    pr = _probe_stacked(st, six, key_attrs, attrs, los, his, tss, agg_attr)
    keep = pr.match & cov.mask[pr.seg // B, pr.page]
    start = torch.full((B,), cov.prefix_len, device=st.device)
    return _prefix_result(st, pr, keep, start), pr, keep


def _masked_pages(st, cov, B):
    """(B,) pages_scanned of a masked stitch, from the pinned coverage
    view: the uncovered pages below the global watermark."""
    pages = int((~cov.built_host[: _used_pages(st)]).sum())
    return torch.full((B,), pages, dtype=torch.int32, device=st.device)


def _stacked_batched_masked(st, six, key_attrs, attrs, los, his, tss,
                            agg_attr, cov, planes=False):
    B = los.shape[0]
    pre, pr, keep = _stacked_masked_prefix(st, six, key_attrs, attrs, los,
                                           his, tss, agg_attr, cov)
    s, c, masks = _table_side(st, attrs, los, his, tss, agg_attr,
                              (~cov.mask)[None].expand(B, -1, -1))
    r = _hybrid_result(pre, s, c, _masked_pages(st, cov, B))
    return (r, _contrib_planes(st, pr, keep, masks)) if planes else r


_STACKED = {
    "hybrid": _stacked_batched_hybrid,
    "hybrid_ps": _stacked_batched_hybrid_ps,
    "pure_vbp": _stacked_batched_pure_index,
    "pure_vap": _stacked_batched_pure_index,
}


def sharded_batched_scan(st: ShardedTable, path: str, index, key_attrs,
                         attrs, los, his, tss, agg_attr: int,
                         coverage=None, planes: bool = False):
    """B scans of one access path over sharded storage in ONE plain
    PyTorch dispatch (the stacked fan-out) -> BatchScanResult, or
    (BatchScanResult, contrib planes) of a single query with
    ``planes``."""
    dev = st.device
    los, his = _bounds(los, len(attrs), dev), _bounds(his, len(attrs), dev)
    tss = torch.as_tensor(tss, dtype=torch.int32, device=dev)
    if path == "table":
        return _stacked_batched_full(st, attrs, los, his, tss, agg_attr,
                                     planes)
    if path == "hybrid_masked":
        return _stacked_batched_masked(st, index, key_attrs, attrs, los,
                                       his, tss, agg_attr, coverage, planes)
    return _STACKED[path](st, index, key_attrs, attrs, los, his, tss,
                          agg_attr, planes)


def sharded_scan(st: ShardedTable, path: str, index, key_attrs, attrs, los,
                 his, ts, agg_attr: int, coverage=None,
                 contribs: bool = False) -> ShardScanResult:
    """One query over sharded storage: the batched form at B = 1 (the
    reference's single-query sharded operators compute the same
    scalars shard by shard).  With ``contribs`` (a join's outer scan)
    it also returns the per-shard contrib planes, else None."""
    args = (st, path, index, key_attrs, attrs, los, his, [int(ts)],
            agg_attr, coverage)
    if contribs:
        r, planes = sharded_batched_scan(*args, planes=True)
    else:
        r, planes = sharded_batched_scan(*args), None
    return ShardScanResult(r.agg_sum[0], r.count[0], planes,
                           *(x[0] for x in r[2:]))


class ScanEngine:
    """Dispatch strategy for planned scans over either storage.

    ``after_dispatch``, when set, is invoked after every batched group
    dispatch (the build lane's drain point, ``dispatch_complete``).
    """

    #: dispatch-strategy vocabulary recorded in ``last_tier``
    TIERS = ("loop", "vmap-stacked", "kernel", "pmap", "shard_map")

    def __init__(self):
        self.after_dispatch = None
        self.last_tier = None

    def scan(self, table, plan, attrs: tuple, los, his, ts, agg_attr: int,
             contribs: bool = False):
        """Single planned scan -> ScanResult | ShardScanResult.  A plain
        table's result always carries its contrib plane; a sharded one
        carries its per-shard planes only with ``contribs``."""
        path = plan.path
        _check(table)
        if isinstance(table, ShardedTable):
            self.last_tier = "loop"  # single query, as in the reference
            return sharded_scan(table, path, plan.index_state,
                                plan.key_attrs, attrs, los, his, ts,
                                agg_attr, plan.pinned_coverage, contribs)
        self.last_tier = "single"
        if path == "table":
            return full_table_scan(table, attrs, los, his, ts, agg_attr)
        if path in PURE_INDEX_PATHS:
            return pure_index_scan(
                table, plan.index_state, plan.key_attrs, attrs, los, his,
                ts, agg_attr,
            )
        if path == "hybrid_masked":
            cov = plan.pinned_coverage
            return hybrid_scan_masked(
                table, plan.index_state, plan.key_attrs, attrs, los, his,
                ts, agg_attr, cov.mask[0], cov.prefix_len,
            )
        return hybrid_scan(
            table, plan.index_state, plan.key_attrs, attrs, los, his, ts,
            agg_attr,
        )

    def dispatch_complete(self) -> None:
        """Between-dispatch drain point (outside the timed region)."""
        if self.after_dispatch is not None:
            self.after_dispatch()

    def scan_batch(
        self,
        table,
        path: str,
        index_state,
        key_attrs: tuple,
        attrs: tuple,
        los,
        his,
        tss,
        agg_attr: int,
        use_kernel: bool = False,
        coverage=None,
    ) -> BatchScanResult:
        """One batched dispatch for a plan group.  ``coverage`` is the
        plan-pinned ``CoverageView`` of the ``hybrid_masked`` path
        (None for every other path)."""
        _check(table)
        # The kernel evaluates at most 2 predicate columns; wider
        # conjunctions take the plain batched forms.
        kernel_ok = use_kernel and 1 <= len(attrs) <= 2
        if isinstance(table, ShardedTable):
            return self._scan_batch_sharded(
                table, path, index_state, key_attrs, attrs, los, his, tss,
                agg_attr, kernel_ok, coverage)
        self.last_tier = "single"
        if path == "table":
            if kernel_ok:
                self.last_tier = "kernel"
                return self._kernel_full_scan(
                    table, attrs, los, his, tss, agg_attr
                )
            return batched_full_table_scan(
                table, attrs, los, his, tss, agg_attr
            )
        if path in ("hybrid", "hybrid_ps"):  # a plain table has no shards
            if kernel_ok:
                self.last_tier = "kernel"
                return self._kernel_hybrid_scan(
                    table, index_state, key_attrs, attrs, los, his, tss,
                    agg_attr,
                )
            return batched_hybrid_scan(
                table, index_state, key_attrs, attrs, los, his, tss, agg_attr
            )
        if path == "hybrid_masked":
            if kernel_ok:
                self.last_tier = "kernel"
                return self._kernel_hybrid_scan_masked(
                    table, index_state, key_attrs, attrs, los, his, tss,
                    agg_attr, coverage,
                )
            return batched_hybrid_scan_masked(
                table, index_state, key_attrs, attrs, los, his, tss,
                agg_attr, coverage.mask[0], coverage.prefix_len,
            )
        return batched_pure_index_scan(
            table, index_state, key_attrs, attrs, los, his, tss, agg_attr
        )

    # -- kernel paths -----------------------------------------------------
    @staticmethod
    def _kernel_full_scan(
        table: Table, attrs, los, his, tss, agg_attr: int
    ) -> BatchScanResult:
        sums, cnts = _kops.scan_table_batched(
            table, attrs, los, his, tss, agg_attr
        )
        B = sums.shape[0]
        z = torch.zeros((B,), dtype=torch.int32, device=table.device)
        used = torch.full((B,), _used_pages(table), dtype=torch.int32,
                          device=table.device)
        return BatchScanResult(sums, cnts, used, z, z.clone())

    @staticmethod
    def _kernel_hybrid_scan(
        table: Table,
        index: AdHocIndex,
        key_attrs,
        attrs,
        los,
        his,
        tss,
        agg_attr: int,
    ) -> BatchScanResult:
        """Hybrid scans with the table suffix on K1: the index prefix
        pass yields per-query stitch points, which the kernel takes as
        ``start_pages`` so tiles inside every query's prefix load
        nothing."""
        pre = batched_hybrid_index_prefix(
            table, index, key_attrs, attrs, los, his, tss, agg_attr
        )
        tbl_sums, tbl_cnts = _kops.scan_table_batched(
            table, attrs, los, his, tss, agg_attr, start_pages=pre.start_page
        )
        return BatchScanResult(
            add_i32(pre.agg_sum, tbl_sums),
            add_i32(pre.count, tbl_cnts),
            _pages_after(table, pre.start_page),
            pre.entries_probed,
            pre.start_page,
        )

    @staticmethod
    def _kernel_hybrid_scan_masked(
        table: Table,
        index: AdHocIndex,
        key_attrs,
        attrs,
        los,
        his,
        tss,
        agg_attr: int,
        cov,
    ) -> BatchScanResult:
        """Masked hybrid scans with the uncovered-page table half on K3:
        the packed coverage words go to the kernel, whose tiles of
        covered pages load nothing."""
        pre = batched_masked_index_side(
            table, index, key_attrs, attrs, los, his, tss, agg_attr,
            cov.mask[0], cov.prefix_len,
        )
        tbl_sums, tbl_cnts = _kops.scan_table_batched_masked(
            table, attrs, los, his, tss, agg_attr, cov.words
        )
        used = _used_pages(table)
        pages = int((~cov.built_host[:used]).sum())
        B = tbl_sums.shape[0]
        return BatchScanResult(
            add_i32(pre.agg_sum, tbl_sums),
            add_i32(pre.count, tbl_cnts),
            torch.full((B,), pages, dtype=torch.int32, device=table.device),
            pre.entries_probed,
            pre.start_page,
        )

    @staticmethod
    def _kernel_sharded_full_scan(st: ShardedTable, attrs, los, his, tss,
                                  agg_attr: int) -> BatchScanResult:
        """Full scans of every shard in one K4 launch, local starts all
        zero."""
        B = los.shape[0]
        starts = torch.zeros((st.n_shards, B), dtype=torch.int32,
                             device=st.device)
        sums, cnts = _kops.scan_shards_batched(st, attrs, los, his, tss,
                                               agg_attr, starts)
        z = torch.zeros((B,), dtype=torch.int32, device=st.device)
        used = torch.full((B,), _used_pages(st), dtype=torch.int32,
                          device=st.device)
        return BatchScanResult(sums, cnts, used, z, z.clone())

    @staticmethod
    def _kernel_sharded_hybrid_scan(st: ShardedTable, six: ShardedIndex,
                                    key_attrs, attrs, los, his, tss,
                                    agg_attr: int,
                                    pershard: bool) -> BatchScanResult:
        """Hybrid scans with every shard's table suffix in one K4
        launch: the index pass emits ONE (S, B) table of local start
        pages (per-shard stitch points under ``hybrid_ps``, the global
        stitch point mapped to local pages otherwise)."""
        if pershard:
            pre, local, pages, _, _ = _stacked_hybrid_prefix_ps(
                st, six, key_attrs, attrs, los, his, tss, agg_attr)
        else:
            pre, local, _, _ = _stacked_hybrid_prefix(
                st, six, key_attrs, attrs, los, his, tss, agg_attr)
            pages = _pages_after(st, pre.start_page)
        sums, cnts = _kops.scan_shards_batched(st, attrs, los, his, tss,
                                               agg_attr, local)
        return _hybrid_result(pre, sums, cnts, pages)

    @staticmethod
    def _kernel_sharded_hybrid_scan_masked(st: ShardedTable,
                                           six: ShardedIndex, key_attrs,
                                           attrs, los, his, tss,
                                           agg_attr: int,
                                           cov) -> BatchScanResult:
        """Masked hybrid scans: the stacked index half plus one K3
        launch over every shard's uncovered pages."""
        pre, _, _ = _stacked_masked_prefix(st, six, key_attrs, attrs, los,
                                           his, tss, agg_attr, cov)
        sums, cnts = _kops.scan_shards_batched_masked(
            st, attrs, los, his, tss, agg_attr, cov.words)
        return _hybrid_result(pre, sums, cnts,
                              _masked_pages(st, cov, los.shape[0]))

    def _scan_batch_sharded(self, st: ShardedTable, path: str, index_state,
                            key_attrs, attrs, los, his, tss, agg_attr: int,
                            kernel_ok: bool,
                            coverage=None) -> BatchScanResult:
        """One dispatch for a plan group over sharded storage (no mesh
        on one card: the reference's stacked branch)."""
        if not kernel_ok or path in PURE_INDEX_PATHS:
            self.last_tier = "kernel" if kernel_ok else "vmap-stacked"
            return sharded_batched_scan(st, path, index_state, key_attrs,
                                        attrs, los, his, tss, agg_attr,
                                        coverage)
        self.last_tier = "kernel"
        dev = st.device
        los, his = _bounds(los, len(attrs), dev), _bounds(his, len(attrs),
                                                          dev)
        tss = torch.as_tensor(tss, dtype=torch.int32, device=dev)
        if path == "table":
            return self._kernel_sharded_full_scan(st, attrs, los, his, tss,
                                                  agg_attr)
        if path == "hybrid_masked":
            return self._kernel_sharded_hybrid_scan_masked(
                st, index_state, key_attrs, attrs, los, his, tss, agg_attr,
                coverage)
        return self._kernel_sharded_hybrid_scan(
            st, index_state, key_attrs, attrs, los, his, tss, agg_attr,
            pershard=path == "hybrid_ps")
