"""Query planner: access-path selection, selectivity estimation and
cost accounting -- pure Python, no tensor dispatch.

Port of ``repro.core.planner``.  For a scan, consider each built
index whose leading key attribute is constrained by the predicate,
estimate selectivity, and pick a hybrid scan for selective queries --
falling back to a table scan when the predicate is not selective or no
index matches.  FULL indexes are usable only when complete (then as a
pure index scan); VBP indexes only when the query's sub-domain lies
inside the merged interval set the planner keeps per VBP index
(``IntervalUnion``), and then as a pure index scan (``pure_vbp``).
A VAP index with a coverage bitmap that is not the legacy prefix
plans the masked stitch (``hybrid_masked``) with the bitmap's view
pinned into the plan.  On sharded storage a hybrid scan stitches per
shard (``hybrid_ps``) once shard-targeted builds have diverged from
the global round-robin prefix or the table's layout is not
round-robin.

``estimate_scan_cost`` is the replica router's what-if cost
(``core.replica``): the reference's arithmetic, decided from host
metadata alone -- it pins no coverage view and touches no catalog
state, so routing a burst reads nothing from the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.core import cost_model as cm
from repro_torch.core.cost_model import IndexDescriptor
from repro_torch.core.index import ShardedIndex, key_range, vbp_n_entries
from repro_torch.core.layout import LayoutState, scan_width_factor
from repro_torch.core.table import ShardedTable

HYBRID_SELECTIVITY_CUTOFF = 0.20  # optimizer switches to table scan above


class IntervalUnion:
    """Host-side merged interval set over composite keys.

    The VBP state tracks exact-interval coverage; two overlapping
    populated sub-domains also jointly cover their union, so the planner
    keeps this merged view per VBP index for its access-path choice."""

    def __init__(self):
        self.ivs: list = []  # sorted disjoint [(lo, hi)] of key tuples

    def add(self, lo, hi) -> None:
        ivs = sorted(self.ivs + [(lo, hi)])
        merged = [ivs[0]]
        for a, b in ivs[1:]:
            la, lb = merged[-1]
            if a <= lb:  # touching or overlapping (tuple compare)
                if b > lb:
                    merged[-1] = (la, b)
            else:
                merged.append((a, b))
        self.ivs = merged

    def covers(self, lo, hi) -> bool:
        for a, b in self.ivs:
            if a <= lo and hi <= b:
                return True
            if a > lo:
                break
        return False

    def clear(self) -> None:
        self.ivs = []


def built_fraction_of(scheme: str, vap, vbp, table) -> float:
    """Built fraction from raw index state."""
    if scheme in ("vap", "full"):
        full_pages = max(table.n_rows // table.page_size, 1)
        return min(vap.built_pages / full_pages, 1.0)
    return min(vbp_n_entries(vbp) / max(table.n_rows, 1), 1.0)


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
    scheme: str  # 'vap' | 'vbp' | 'full'
    vap: Optional[object] = None  # AdHocIndex | ShardedIndex
    vbp: Optional[object] = None  # VbpState | ShardedVbpState
    cov_union: Optional[IntervalUnion] = None  # VBP merged coverage
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
        return 12.0 * float(vbp_n_entries(self.vbp))


@dataclass(frozen=True)
class IndexSnapshot:
    """Frozen view of one BuiltIndex's usable state (index states are
    immutable, so a snapshot is a reference capture)."""

    vap: Optional[object]
    vbp: Optional[object]
    complete: bool


def _engine_state(path: str, vap, vbp):
    """Raw sorted-entry state for the engine given an access path: the
    pure VBP scan needs only the entries (an ``AdHocIndex``, or the
    stacked ``ShardedIndex`` on sharded storage), not the covering
    metadata."""
    if path == "pure_vbp":
        return vbp.index
    return vap


@dataclass(frozen=True)
class ScanPlan:
    """One planned scan: the access path plus the index serving it.

    ``path`` is 'table' | 'hybrid' | 'hybrid_ps' | 'hybrid_masked' |
    'pure_vbp' | 'pure_vap'.
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
        return _engine_state(self.path, bi.vap, bi.vbp)

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
            covered = len(set(bi.desc.key_attrs) & set(q.attrs))
            frac = built_fraction_of(
                bi.scheme, vap, vbp, self.db.tables[q.table]
            )
            if bi.scheme == "vbp":
                lo, hi = self.vbp_host_key_bounds(bi, q)
                if not bi.cov_union.covers(lo, hi):
                    continue
            key = (covered, frac)
            if key > best_key:
                best, best_key = bi, key
        return best

    def _scan_index(self, q) -> Optional[BuiltIndex]:
        """The index a scan would use: none for an unselective
        predicate, else ``choose_index``."""
        if self.estimate_selectivity(q) <= HYBRID_SELECTIVITY_CUTOFF:
            return self.choose_index(q)
        return None

    def plan_scan(self, q) -> ScanPlan:
        bi = self._scan_index(q)
        if bi is None:
            return ScanPlan("table")
        vap, vbp, complete = self._states(bi)
        if bi.scheme == "vbp":
            return ScanPlan("pure_vbp", bi,
                            pinned_state=_engine_state("pure_vbp", vap, vbp))
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

    # -- what-if cost (replica routing) ----------------------------------
    def estimate_scan_cost(self, q) -> float:
        """What-if cost of serving ``q`` under the current catalog, in
        the engine's tuple-touch units: ``scan_cost`` fed with estimated
        pages and probes, as in the reference.  Host-only and free of
        side effects: the access path is decided without minting a
        plan (``plan_scan`` would pin a coverage view), every hybrid
        flavour costs alike, and the built fraction reads host
        metadata (watermarks, the host bitmap's count).  No dispatch,
        no ``last_used_ms`` touch, no monitor record."""
        t = self.db.tables[q.table]
        layout = self.db.layouts[q.table]
        psz = t.page_size
        n_rows = int(t.n_rows)
        if isinstance(t, ShardedTable):
            used_pages = sum(-(-int(r) // psz) for r in t.local_rows)
        else:
            used_pages = -(-n_rows // psz)
        bi = self._scan_index(q)
        sel = self.estimate_selectivity(q)
        if bi is None:
            cost = scan_cost(layout, q.accessed_attrs, psz, used_pages, 0.0, 0)
        elif bi.scheme == "vbp" or (bi.scheme == "full"
                                    and self._states(bi)[2]):
            # pure_vbp / pure_vap: the index answers alone
            cost = scan_cost(layout, q.accessed_attrs, psz, 0, sel * n_rows,
                             t.n_pages)
        else:  # hybrid flavours: indexed prefix probes + table suffix
            frac = bi.built_fraction(t)
            start = int(frac * used_pages)
            cost = scan_cost(layout, q.accessed_attrs, psz,
                             used_pages - start, sel * frac * n_rows, start)
        if q.join_table is not None:
            n_inner = int(self.db.tables[q.join_table].n_rows)
            has_idx = any(
                b.scheme in ("vap", "full")
                and not b.building
                and cm.index_matches(b.desc, q.join_table,
                                     (q.join_inner_attr,))
                for b in self.db.indexes.values()
            )
            cost += (n_inner * cm.INDEX_PROBE_COST if has_idx
                     else float(n_inner))
        return cost

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

    # -- VBP key bounds --------------------------------------------------
    @staticmethod
    def vbp_host_key_bounds(bi: BuiltIndex, q):
        """Host-side composite-key bounds ((hi, lo) int tuples); a
        2-attribute index whose second attribute the predicate leaves
        open spans that attribute's whole domain."""
        pmap = {a: k for k, a in enumerate(q.attrs)}
        ka = bi.desc.key_attrs
        lo0, hi0 = int(q.los[pmap[ka[0]]]), int(q.his[pmap[ka[0]]])
        if len(ka) == 2 and ka[1] in pmap:
            lo1, hi1 = int(q.los[pmap[ka[1]]]), int(q.his[pmap[ka[1]]])
        elif len(ka) == 2:
            lo1, hi1 = -(2**31) + 1, 2**31 - 2
        else:
            lo1, hi1 = 0, 0
        return (lo0, lo1), (hi0, hi1)

    @classmethod
    def vbp_bounds(cls, bi: BuiltIndex, q):
        (lo0, lo1), (hi0, hi1) = cls.vbp_host_key_bounds(bi, q)
        if len(bi.desc.key_attrs) == 2:
            return key_range(lo0, hi0, lo1, hi1)
        return key_range(lo0, hi0)


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
