"""Query planner: access-path selection, selectivity estimation and
cost accounting -- pure Python, no tensor dispatch.

Port of ``repro.core.planner`` for plain tables and VAP / FULL
indexes.  For a scan, consider each built index whose leading key
attribute is constrained by the predicate, estimate selectivity, and
pick a hybrid scan for selective queries -- falling back to a table
scan when the predicate is not selective or no index matches.  FULL
indexes are usable only when complete (then as a pure index scan).
A VAP index with a coverage bitmap that is not the legacy prefix
plans the masked stitch (``hybrid_masked``) with the bitmap's view
pinned into the plan.  On sharded storage a hybrid scan stitches per
shard (``hybrid_ps``) once shard-targeted builds have diverged from
the global round-robin prefix or the table's layout is not
round-robin.

Value-based (VBP) indexes are not ported yet: a VBP index in the
catalog raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.core import cost_model as cm
from repro_torch.core.cost_model import IndexDescriptor
from repro_torch.core.index import ShardedIndex
from repro_torch.core.layout import LayoutState, scan_width_factor
from repro_torch.core.table import ShardedTable

HYBRID_SELECTIVITY_CUTOFF = 0.20  # optimizer switches to table scan above


def _vbp_not_ported():
    raise NotImplementedError("VBP indexes are not ported yet")


def built_fraction_of(scheme: str, vap, vbp, table) -> float:
    """Built fraction from raw index state."""
    if scheme in ("vap", "full"):
        full_pages = max(table.n_rows // table.page_size, 1)
        return min(vap.built_pages / full_pages, 1.0)
    _vbp_not_ported()


@dataclass
class BuiltIndex:
    """Catalog entry for one built (or building) index.

    ``coverage`` (a ``core.index.PageCoverage``) is None unless the
    crack-on-scan / decay options attached one; when present it is the
    coverage authority: built fraction and size read the bitmap, the
    planner routes non-prefix shapes to the masked path, and builds go
    through explicit page lists.
    """

    desc: IndexDescriptor
    scheme: str  # 'vap' | 'full'
    vap: Optional[object] = None  # AdHocIndex | ShardedIndex
    vbp: Optional[object] = None  # VBP state (not ported)
    complete: bool = False  # FULL usable flag
    building: bool = True  # under construction (VAP/FULL)
    created_ms: float = 0.0
    last_used_ms: float = 0.0
    coverage: Optional[object] = None  # PageCoverage (bitmap mode)

    def built_fraction(self, table) -> float:
        if self.coverage is not None and self.scheme in ("vap", "full"):
            full_pages = max(table.n_rows // table.page_size, 1)
            return min(self.coverage.count() / full_pages, 1.0)
        return built_fraction_of(self.scheme, self.vap, self.vbp, table)

    def size_bytes(self) -> float:
        if self.coverage is not None and self.scheme in ("vap", "full"):
            # Decay clears bits without compacting the entries, so the
            # bitmap is what the memory cap governs.
            return 12.0 * float(
                self.coverage.count() * self.coverage.page_size
            )
        if self.scheme in ("vap", "full"):
            return 12.0 * float(self.vap.n_entries)
        _vbp_not_ported()


@dataclass(frozen=True)
class IndexSnapshot:
    """Frozen view of one BuiltIndex's usable state (index states are
    immutable, so a snapshot is a reference capture)."""

    vap: Optional[object]
    vbp: Optional[object]
    complete: bool


@dataclass(frozen=True)
class ScanPlan:
    """One planned scan: the access path plus the index serving it.

    ``path`` is 'table' | 'hybrid' | 'hybrid_ps' | 'hybrid_masked' |
    'pure_vap'.
    ``pinned_state`` is the index state the plan was minted against;
    ``pinned_coverage`` the frozen ``CoverageView`` of the masked path
    (every plan of a burst is minted before any dispatch, so the view
    holds for the whole burst while crack adoption mutates the live
    bitmap).
    """

    path: str
    index: Optional[BuiltIndex] = None
    pinned_state: Optional[object] = None
    pinned_coverage: Optional[object] = None

    @property
    def key_attrs(self) -> Tuple[int, ...]:
        return self.index.desc.key_attrs if self.index is not None else ()

    @property
    def index_state(self):
        """Raw sorted-entry state for the engine (None for table scans)."""
        bi = self.index
        if bi is None:
            return None
        if self.pinned_state is not None:
            return self.pinned_state
        return bi.vap

    @property
    def group_key(self):
        """Batch-compatibility key fragment (path + serving index)."""
        return (self.path, self.index.desc.name if self.index else None)


class QueryPlanner:
    """Access-path planner over a Database's catalog (host-side)."""

    def __init__(self, db):
        self.db = db
        self._snap: Optional[dict] = None  # name -> IndexSnapshot

    # -- catalog double buffering ----------------------------------------
    def begin_snapshot(self) -> None:
        """Freeze the catalog: plans minted until ``end_snapshot``
        resolve against the index states captured here."""
        self._snap = {
            name: IndexSnapshot(bi.vap, bi.vbp, bi.complete)
            for name, bi in self.db.indexes.items()
        }

    def end_snapshot(self) -> None:
        self._snap = None

    def _states(self, bi: BuiltIndex):
        """(vap, vbp, complete) from the active snapshot, else live."""
        if self._snap is not None:
            snap = self._snap.get(bi.desc.name)
            if snap is not None:
                return snap.vap, snap.vbp, snap.complete
        return bi.vap, bi.vbp, bi.complete

    # -- selectivity -----------------------------------------------------
    @staticmethod
    def estimate_selectivity(q) -> float:
        """Uniform-assumption estimate from predicate ranges over the
        TUNER attribute domain [1, 1m]; used only for plan choice."""
        sel = 1.0
        for lo, hi in zip(q.los, q.his):
            width = max(float(hi) - float(lo) + 1.0, 0.0)
            sel *= min(width / 1_000_000.0, 1.0)
        return sel

    # -- index choice ----------------------------------------------------
    def choose_index(self, q) -> Optional[BuiltIndex]:
        best, best_key = None, (-1, -1.0)
        for bi in self.db.indexes.values():
            if not cm.index_matches(bi.desc, q.table, q.attrs):
                continue
            vap, vbp, complete = self._states(bi)
            if bi.scheme == "full" and not complete:
                continue
            if bi.scheme == "vbp":
                _vbp_not_ported()
            covered = len(set(bi.desc.key_attrs) & set(q.attrs))
            frac = built_fraction_of(
                bi.scheme, vap, vbp, self.db.tables[q.table]
            )
            key = (covered, frac)
            if key > best_key:
                best, best_key = bi, key
        return best

    def plan_scan(self, q) -> ScanPlan:
        bi = None
        if self.estimate_selectivity(q) <= HYBRID_SELECTIVITY_CUTOFF:
            bi = self.choose_index(q)
        if bi is None:
            return ScanPlan("table")
        vap, _vbp, complete = self._states(bi)
        if bi.scheme == "full" and complete:
            return ScanPlan("pure_vap", bi, pinned_state=vap)
        cov = bi.coverage
        if cov is not None and not self._coverage_is_legacy(cov, vap):
            return ScanPlan(
                "hybrid_masked",
                bi,
                pinned_state=vap,
                pinned_coverage=self._pin_coverage(bi, cov),
            )
        path = "hybrid"  # VAP, or FULL still building
        if self._needs_pershard_stitch(bi, vap):
            path = "hybrid_ps"
        return ScanPlan(path, bi, pinned_state=vap)

    @staticmethod
    def _coverage_is_legacy(cov, vap) -> bool:
        """A bitmap that IS the prefix the index watermark claims (with
        no entries beyond it) takes the legacy start_page path, bit for
        bit -- routing is a fast-path choice only.  A sharded index's
        watermark is the sum of its local prefixes."""
        return cov.legacy_prefix_ok(vap.built_pages)

    def _pin_coverage(self, bi: BuiltIndex, cov):
        """Freeze the live bitmap into the view the burst pins: one row
        per shard over local page ids (``cov.view(S, max_pages)``; a
        plain table is one shard)."""
        t = self.db.tables[bi.desc.table]
        if isinstance(t, ShardedTable):
            return cov.view(t.n_shards, t.max_pages)
        return cov.view(1, t.n_pages)

    def _needs_pershard_stitch(self, bi: BuiltIndex, vap) -> bool:
        """The global hybrid stitch is sound only while the shard-local
        built prefixes partition one global page prefix under the
        round-robin page map.  Shard-targeted build quanta and adopted
        layouts that are not round-robin both break that, so those
        scans stitch per shard."""
        if not isinstance(vap, ShardedIndex):
            return False
        if bi.desc.name in self.db.pershard_built:
            return True
        return not self.db.table_is_round_robin(bi.desc.table)


def scan_cost(
    layout: LayoutState,
    accessed_attrs,
    page_size: int,
    pages_scanned: int,
    entries_probed: float,
    start_page: int,
) -> float:
    """Tuple-touch cost of one executed scan: table-scan units scale
    with the layout's effective width; index probes are narrow."""
    width = scan_width_factor(layout, accessed_attrs, from_page=start_page)
    cost = float(pages_scanned) * page_size * (width / layout.n_attrs)
    return cost + float(entries_probed) * cm.INDEX_PROBE_COST
