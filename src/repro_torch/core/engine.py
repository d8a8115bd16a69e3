"""Scan engine: turns planned scans into dispatches.

Port of the plain-``Table`` half of ``repro.core.engine.ScanEngine``.
The engine receives an access path, raw index state and per-query
bounds, and owns the dispatch strategy:

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

Every dispatch records its execution tier in ``last_tier`` (vocabulary
``TIERS``): ``kernel`` for a kernel dispatch, ``single`` otherwise.
Sharded storage, meshes, the per-shard stitch and VBP scans are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from repro_torch.core.hybrid_scan import (
    BatchScanResult,
    _pages_after,
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
from repro_torch.core.index import AdHocIndex
from repro_torch.core.table import Table
from repro_torch.kernels import ops as _kops

_UNPORTED_PATHS = ("hybrid_ps", "pure_vbp")


def _check(table, path: str) -> None:
    if not isinstance(table, Table):
        raise NotImplementedError(
            f"sharded storage is not ported yet (got {type(table).__name__})"
        )
    if path in _UNPORTED_PATHS:
        raise NotImplementedError(f"access path {path!r} is not ported yet")


class ScanEngine:
    """Dispatch strategy for planned scans over plain tables.

    ``after_dispatch``, when set, is invoked after every batched group
    dispatch (the build lane's drain point, ``dispatch_complete``).
    """

    #: dispatch-strategy vocabulary recorded in ``last_tier``
    TIERS = ("loop", "vmap-stacked", "kernel", "pmap", "shard_map")

    def __init__(self):
        self.after_dispatch = None
        self.last_tier = None

    def scan(self, table, plan, attrs: tuple, los, his, ts, agg_attr: int):
        """Single planned scan -> ScanResult."""
        path = plan.path
        _check(table, path)
        self.last_tier = "single"
        if path == "table":
            return full_table_scan(table, attrs, los, his, ts, agg_attr)
        if path == "pure_vap":
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
        _check(table, path)
        # The kernel evaluates at most 2 predicate columns; wider
        # conjunctions take the plain batched forms.
        kernel_ok = use_kernel and 1 <= len(attrs) <= 2
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
        if path == "hybrid":
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
