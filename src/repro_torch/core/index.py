"""Ad-hoc secondary indexes with partial, incremental construction.

Port of ``repro.core.index``.  The index is a lexicographically
sorted (key_hi, key_lo, rid) array with fixed capacity; invalid slots
hold (INT32_MAX, INT32_MAX), which sorts after every real key (the
TUNER domain is [1, 1m]).

* ``FULL`` -- usable only once every page is indexed.
* ``VBP``  -- value-based partial (cracking / SMIX / holistic): each
  query's predicate sub-domain is populated on demand, and a covering
  interval set says which sub-domains are complete.
* ``VAP``  -- value-agnostic partial (the paper's scheme): each tuning
  cycle indexes the next ``pages_per_cycle`` fully populated pages in
  ascending page order; the only metadata is ``built_pages``.

Ordering: the reference merges with ``jnp.lexsort((kl, kh))``, a
stable sort whose ties keep concatenation order (old entries before
new ones).  Here the pair is packed into one int64 key
``kh * 2**32 + (kl + 2**31)``, which orders exactly like the pair, and
sorted once with ``stable=True`` -- the same permutation.

``n_entries`` and ``built_pages`` are host ints; the key and rid
arrays live on the table's device.

Coverage bitmaps (``PageCoverage``) generalise the built prefix to a
built-page bitmap, as in the reference: crack-on-scan adoption,
hot-range-first page lists and cold-page decay become bit flips plus
``build_pages_at`` merges.  A set bit means the page is fully indexed;
entries may exist for uncovered pages (decay clears bits without
compacting), and masked scans drop those on the index side and scan
every uncovered page.  A bitmap that is exactly the ``built_pages``
prefix with no entries beyond it (``legacy_prefix_ok``) keeps the
legacy ``start_page`` paths.  On a plain table the global page ids
are the local ones; on a round-robin ``ShardedTable`` global page p is
local page p // S of shard p % S.

Sharded storage keeps one local index per shard (local rids, a local
``built_pages`` prefix), as in the reference.  A ``ShardedIndex`` holds
them stacked on a leading shard axis, padded to the largest shard's
capacity with invalid keys past each shard's own capacity (the
``n_entries`` guard masks them off), which is the layout the engine
probes in one pass.  Build quanta return a new ``ShardedIndex`` with
new arrays; none is ever written in place, so a plan's pinned state
stays what it was when the plan was made.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.table import INF_TS, ShardedTable, Table

I32_MAX = 2**31 - 1
I32_MIN = -(2**31)

KeyPair = Tuple[object, object]  # (hi, lo) ints or tensors


class AdHocIndex(NamedTuple):
    """Sorted partial index over one or two attributes of a Table."""

    key_hi: torch.Tensor  # (capacity,) int32 leading key component
    key_lo: torch.Tensor  # (capacity,) int32 secondary (0 if 1-attr)
    rids: torch.Tensor  # (capacity,) int32
    n_entries: int
    built_pages: int  # == rho_i + 1 (fully indexed prefix)

    @property
    def capacity(self) -> int:
        return self.key_hi.shape[0]


def make_index(capacity: int, device) -> AdHocIndex:
    return AdHocIndex(
        key_hi=torch.full((capacity,), I32_MAX, dtype=torch.int32,
                          device=device),
        key_lo=torch.full((capacity,), I32_MAX, dtype=torch.int32,
                          device=device),
        rids=torch.zeros((capacity,), dtype=torch.int32, device=device),
        n_entries=0,
        built_pages=0,
    )


def make_keys(cols: Sequence[torch.Tensor]):
    """Composite key components from 1 or 2 int32 columns."""
    if len(cols) == 1:
        return cols[0].to(torch.int32), torch.zeros_like(
            cols[0], dtype=torch.int32)
    if len(cols) == 2:
        return cols[0].to(torch.int32), cols[1].to(torch.int32)
    raise ValueError("indexes support 1 or 2 key attributes")


def key_range(lo0, hi0, lo1=None, hi1=None) -> Tuple[KeyPair, KeyPair]:
    """Inclusive lexicographic key range for a range predicate (for a
    2-attribute index the leading interval; the scan re-checks the
    second attribute)."""
    if lo1 is None:
        return (lo0, 0), (hi0, 0)
    return (lo0, lo1), (hi0, hi1)


def keys_geq(kh, kl, b: KeyPair):
    return (kh > b[0]) | ((kh == b[0]) & (kl >= b[1]))


def keys_leq(kh, kl, b: KeyPair):
    return (kh < b[0]) | ((kh == b[0]) & (kl <= b[1]))


def keys_in_range(kh, kl, lo: KeyPair, hi: KeyPair):
    return keys_geq(kh, kl, lo) & keys_leq(kh, kl, hi)


def packed_keys(kh, kl) -> torch.Tensor:
    """int64 key ordering exactly like the (kh, kl) pair."""
    return kh.to(torch.int64) * (2**32) + (kl.to(torch.int64) + 2**31)


def _lexsort_merge(kh, kl, rids, capacity: int):
    """Sort (key_hi, key_lo, rid) triples lexicographically (stable:
    ties keep concatenation order), keep the first ``capacity``
    (padding keys sort last)."""
    order = torch.sort(packed_keys(kh, kl), stable=True).indices[:capacity]
    return kh[order], kl[order], rids[order]


# ---------------------------------------------------------------------------
# VAP: value-agnostic page-wise population (the paper's scheme)
# ---------------------------------------------------------------------------

def build_pages_vap(index: AdHocIndex, table: Table, key_attrs: tuple,
                    pages_per_cycle: int) -> AdHocIndex:
    """One VAP tuning-cycle step: index the next ``pages_per_cycle``
    pages (only fully populated ones count as built)."""
    psz = table.page_size
    dev = table.device
    start = index.built_pages
    full_pages = table.n_rows // psz
    pages = start + torch.arange(pages_per_cycle, device=dev)
    in_range = pages < full_pages
    pages_c = torch.clamp(pages, 0, table.n_pages - 1)

    cols = [table.data[pages_c, :, a] for a in key_attrs]  # (P, psz)
    kh, kl = make_keys(cols)
    kh, kl = kh.reshape(-1), kl.reshape(-1)
    slot = torch.arange(psz, device=dev)[None, :]
    new_rids = (pages_c[:, None] * psz + slot).reshape(-1)
    # Only slots that ever held a row are indexed; dead versions stay
    # indexed (the scan re-checks MVCC visibility).
    occupied = (table.begin_ts[pages_c] < INF_TS).reshape(-1)
    valid = occupied & torch.repeat_interleave(in_range, psz)
    kh = torch.where(valid, kh, I32_MAX)
    kl = torch.where(valid, kl, I32_MAX)

    mh = torch.cat([index.key_hi, kh])
    ml = torch.cat([index.key_lo, kl])
    mr = torch.cat([index.rids, new_rids.to(torch.int32)])
    mh, ml, mr = _lexsort_merge(mh, ml, mr, index.capacity)
    n_entries = index.n_entries + int(valid.sum())
    built = max(min(start + pages_per_cycle, full_pages), start)
    return AdHocIndex(mh, ml, mr, n_entries, built)


def build_full(index: AdHocIndex, table: Table, key_attrs: tuple
               ) -> AdHocIndex:
    """FULL scheme: index every page in one (expensive) shot."""
    return build_pages_vap(index, table, key_attrs,
                           pages_per_cycle=table.n_pages)


# ---------------------------------------------------------------------------
# Sharded VAP / FULL: one local index per table shard, stacked
# ---------------------------------------------------------------------------

class ShardedIndex(NamedTuple):
    """Per-shard ``AdHocIndex`` states over a ``ShardedTable``.

    ``key_hi`` / ``key_lo`` / ``rids`` are (S, max_capacity) int32 with
    shard s's sorted entries in row s (local rids) and invalid keys
    past its own capacity; ``shard_entries``, ``shard_built`` and
    ``capacities`` are per-shard host ints.  ``shard(s)`` is shard s's
    ``AdHocIndex`` (views).  Under the in-order build the union of the
    local prefixes is the global prefix [0, ``built_pages``).
    """

    key_hi: torch.Tensor
    key_lo: torch.Tensor
    rids: torch.Tensor
    shard_entries: tuple
    shard_built: tuple
    capacities: tuple

    @property
    def n_shards(self) -> int:
        return len(self.capacities)

    @property
    def built_pages(self) -> int:
        """Global fully-indexed page prefix length (== rho_i + 1)."""
        return sum(self.shard_built)

    @property
    def n_entries(self) -> int:
        return sum(self.shard_entries)

    @property
    def capacity(self) -> int:
        return sum(self.capacities)

    def shard(self, s: int) -> AdHocIndex:
        cap = self.capacities[s]
        return AdHocIndex(self.key_hi[s, :cap], self.key_lo[s, :cap],
                          self.rids[s, :cap], self.shard_entries[s],
                          self.shard_built[s])

    @property
    def shards(self) -> tuple:
        return tuple(self.shard(s) for s in range(self.n_shards))

    def replace_shards(self, new: dict) -> "ShardedIndex":
        """A new ``ShardedIndex`` with the shards ``{s: AdHocIndex}``
        replaced (new arrays; ``self`` is left as it was)."""
        if not new:
            return self
        arrays = [self.key_hi.clone(), self.key_lo.clone(),
                  self.rids.clone()]
        entries, built = list(self.shard_entries), list(self.shard_built)
        for s, ix in new.items():
            for out, x in zip(arrays, ix[:3]):
                out[s, : self.capacities[s]] = x
            entries[s], built[s] = ix.n_entries, ix.built_pages
        return ShardedIndex(*arrays, tuple(entries), tuple(built),
                            self.capacities)


def stack_indexes(shards: Sequence[AdHocIndex]) -> ShardedIndex:
    """Stack per-shard indexes (padding past each shard's capacity
    holds invalid keys and rid 0)."""
    caps = tuple(ix.capacity for ix in shards)
    empty = make_index(max(caps), shards[0].key_hi.device)
    S = len(caps)
    out = ShardedIndex(*(x[None].repeat(S, 1) for x in empty[:3]),
                       (0,) * S, (0,) * S, caps)
    return out.replace_shards(dict(enumerate(shards)))


def make_sharded_index(table: ShardedTable) -> ShardedIndex:
    """Empty per-shard indexes, one slot per local row slot."""
    return stack_indexes([make_index(lp * table.page_size, table.device)
                          for lp in table.local_pages])


def _count_owned_below(bound: int, shard: int, n_shards: int) -> int:
    """#{global page p < bound : p % n_shards == shard}."""
    return max(0, -(-(bound - shard) // n_shards))


def sharded_build_pages_vap(index: ShardedIndex, table: ShardedTable,
                            key_attrs: tuple,
                            pages_per_cycle: int) -> ShardedIndex:
    """One VAP cycle over sharded storage: index the next
    ``pages_per_cycle`` pages in GLOBAL page order (global page p
    extends shard p % S), so the built pages equal the single-shard
    build's at the same cumulative budget."""
    S = index.n_shards
    built = index.built_pages
    new = {}
    for s in range(S):
        step = (_count_owned_below(built + pages_per_cycle, s, S)
                - _count_owned_below(built, s, S))
        if step > 0:
            new[s] = build_pages_vap(index.shard(s), table.shard(s),
                                     key_attrs, pages_per_cycle=step)
    return index.replace_shards(new)


# ---------------------------------------------------------------------------
# VBP: value-based partial population (cracking / SMIX / holistic style)
# ---------------------------------------------------------------------------
#
# The covering metadata is host state, as ``n_entries`` is: four small
# numpy int32 interval arrays and a host ``n_cov``, so the coverage test
# costs no device round trip.  The entries and the ``in_index`` dedup
# bitmap live on the table's device.
#
# A population merges only the wanted rows.  The reference also merges
# ``max_add - n_added`` padding entries (invalid keys carrying the rids
# of unwanted rows); they sort after every real key and after the old
# index's own invalid tail, so they never survive the capacity cut (the
# kept tail is a prefix of the old one) and the arrays come out the
# same.

MAX_INTERVALS = 64


class VbpState(NamedTuple):
    """VBP index + covering metadata.

    ``cov_*`` is a fixed-capacity interval set over the composite key
    domain (SMIX's covering tree): an interval means every tuple whose
    key falls inside it is in the index.  ``in_index`` marks the rids
    already indexed, so overlapping populations never duplicate an
    entry."""

    index: AdHocIndex
    cov_lo_hi: np.ndarray  # (max_intervals,) int32 lower bound, hi comp
    cov_lo_lo: np.ndarray  # (max_intervals,) int32 lower bound, lo comp
    cov_hi_hi: np.ndarray  # (max_intervals,) int32 upper bound, hi comp
    cov_hi_lo: np.ndarray  # (max_intervals,) int32 upper bound, lo comp
    n_cov: int
    in_index: torch.Tensor  # (row_capacity,) bool


def _empty_cov(max_intervals: int) -> tuple:
    return (np.full(max_intervals, I32_MAX, np.int32),
            np.full(max_intervals, I32_MAX, np.int32),
            np.full(max_intervals, I32_MIN, np.int32),
            np.full(max_intervals, I32_MIN, np.int32))


def make_vbp(capacity: int, device,
             max_intervals: int = MAX_INTERVALS) -> VbpState:
    return VbpState(make_index(capacity, device), *_empty_cov(max_intervals),
                    0, torch.zeros(capacity, dtype=torch.bool, device=device))


def vbp_is_covered(state, lo: KeyPair, hi: KeyPair) -> bool:
    """True iff [lo, hi] lies inside one covered interval (either VBP
    state type)."""
    inside = keys_leq(state.cov_lo_hi, state.cov_lo_lo, lo)  # cov_lo <= lo
    inside &= keys_geq(state.cov_hi_hi, state.cov_hi_lo, hi)  # hi <= cov_hi
    inside &= np.arange(state.cov_lo_hi.shape[0]) < state.n_cov
    return bool(inside.any())


def _record_coverage(state, fits: bool, lo: KeyPair, hi: KeyPair) -> tuple:
    """(cov_lo_hi, cov_lo_lo, cov_hi_hi, cov_hi_lo, n_cov) with [lo, hi]
    written into slot ``min(n_cov, max_intervals - 1)`` when ``fits``:
    past the last slot each new interval overwrites it while ``n_cov``
    keeps counting, as in the reference."""
    arrays = (state.cov_lo_hi, state.cov_lo_lo, state.cov_hi_hi,
              state.cov_hi_lo)
    if not fits:
        return arrays + (state.n_cov,)
    slot = min(state.n_cov, arrays[0].shape[0] - 1)
    out = tuple(a.copy() for a in arrays)
    for a, v in zip(out, (lo[0], lo[1], hi[0], hi[1])):
        a[slot] = int(v)
    return out + (state.n_cov + 1,)


def vbp_invalidate_coverage(state):
    """Drop coverage claims after table mutations (inserted rows are
    unknown to the covering intervals).  Entries stay -- scans re-check
    visibility -- but pure index scans are illegal until sub-domains are
    populated again.  Either VBP state type."""
    return state._replace(n_cov=0)


def _merge_new(index: AdHocIndex, kh, kl, rids) -> AdHocIndex:
    """Merge new entries (in rid order) into ``index``: old entries
    before new ones on equal keys, as the reference's stable merge."""
    n = int(rids.numel())
    if n == 0:
        return index
    mh, ml, mr = _lexsort_merge(torch.cat([index.key_hi, kh]),
                                torch.cat([index.key_lo, kl]),
                                torch.cat([index.rids, rids.to(torch.int32)]),
                                index.capacity)
    return AdHocIndex(mh, ml, mr, index.n_entries + n, index.built_pages)


def _marked(in_index: torch.Tensor, rids) -> torch.Tensor:
    """``in_index`` with ``rids`` set (a new tensor when any is)."""
    if rids.numel() == 0:
        return in_index
    out = in_index.clone()
    out[rids] = True
    return out


def vbp_populate_subdomain(state: VbpState, table: Table, key_attrs: tuple,
                           lo: KeyPair, hi: KeyPair, ts,
                           max_add: int) -> Tuple[VbpState, int]:
    """Add index entries for every tuple whose key is in [lo, hi]: the
    first ``max_add`` wanted rows in rid order (the reference's stable
    argsort of the unwanted mask puts exactly these first).  The
    interval is recorded as covered only if the whole sub-domain fit.
    Returns (state, n_added); a sub-domain already covered changes
    nothing."""
    del ts
    if vbp_is_covered(state, lo, hi):
        return state, 0
    kh, kl = make_keys([table.data[:, :, a] for a in key_attrs])
    kh, kl = kh.reshape(-1), kl.reshape(-1)
    want = (table.begin_ts < INF_TS).reshape(-1)  # occupied
    want &= keys_in_range(kh, kl, lo, hi) & ~state.in_index
    rids = torch.nonzero(want).view(-1)  # rid order
    n_want = int(rids.numel())
    take = rids[:max_add]
    index = _merge_new(state.index, kh[take], kl[take], take)
    cov = _record_coverage(state, n_want <= max_add, lo, hi)
    return (VbpState(index, *cov, _marked(state.in_index, take)),
            int(take.numel()))


class ShardedVbpState(NamedTuple):
    """VBP over sharded storage.

    The entries are per shard (local rids), held as one stacked
    ``ShardedIndex`` (``index``), so shard-local scans need no
    cross-shard gathers; the covering intervals and the ``in_index``
    dedup bitmap live on the GLOBAL key / rid space: an interval claims
    every tuple of the sub-domain whichever shard holds it, and the
    "first ``max_add`` wanted rows in rid order" budget is a global
    selection."""

    index: ShardedIndex
    cov_lo_hi: np.ndarray
    cov_lo_lo: np.ndarray
    cov_hi_hi: np.ndarray
    cov_hi_lo: np.ndarray
    n_cov: int
    in_index: torch.Tensor  # (global row capacity,) bool

    @property
    def n_entries(self) -> int:
        return self.index.n_entries


def make_sharded_vbp(table: ShardedTable,
                     max_intervals: int = MAX_INTERVALS) -> ShardedVbpState:
    return ShardedVbpState(
        make_sharded_index(table), *_empty_cov(max_intervals), 0,
        torch.zeros(table.capacity, dtype=torch.bool, device=table.device))


def sharded_vbp_populate_subdomain(state: ShardedVbpState,
                                   table: ShardedTable, key_attrs: tuple,
                                   lo: KeyPair, hi: KeyPair, ts,
                                   max_add: int
                                   ) -> Tuple[ShardedVbpState, int]:
    """Sharded value-based population, equal to
    ``vbp_populate_subdomain`` on the unsharded table: the wanted set
    and the ``max_add`` budget are chosen in GLOBAL rid order (local
    page lp of shard s is global page ``lp * S + s``), and each chosen
    row merges into its owning shard's sorted entries.  As in the
    reference, a slot whose global rid falls at or past the capacity
    (only on a layout that is not round-robin) is not selectable."""
    del ts
    if vbp_is_covered(state, lo, hi):
        return state, 0
    S, psz, cap = table.n_shards, table.page_size, table.capacity
    dev = table.device
    kh, kl = make_keys([table.data[..., a] for a in key_attrs])
    grid = (table.global_page_ids()[:, :, None] * psz
            + torch.arange(psz, device=dev)).reshape(-1)
    # Padding pages are never occupied (begin_ts == NEVER_TS).
    want = (table.begin_ts < INF_TS) & keys_in_range(kh, kl, lo, hi)
    cand = grid[want.reshape(-1)]
    cand = cand[cand < cap]
    cand = torch.sort(cand[~state.in_index[cand]]).values
    n_want = int(cand.numel())
    take = cand[:max_add]
    gp, sl = take // psz, take % psz
    owner, lp = gp % S, gp // S
    slots = (owner * table.max_pages + lp) * psz + sl
    nkh, nkl = kh.reshape(-1)[slots], kl.reshape(-1)[slots]
    local = lp * psz + sl
    new = {}
    for s, n in enumerate(torch.bincount(owner, minlength=S).tolist()):
        if n:
            mine = owner == s
            new[s] = _merge_new(state.index.shard(s), nkh[mine], nkl[mine],
                                local[mine])
    cov = _record_coverage(state, n_want <= max_add, lo, hi)
    return (ShardedVbpState(state.index.replace_shards(new), *cov,
                            _marked(state.in_index, take)),
            int(take.numel()))


def vbp_n_entries(state) -> int:
    """Entry count of a ``VbpState`` or ``ShardedVbpState``."""
    return state.index.n_entries


# ---------------------------------------------------------------------------
# Resumable build quanta
# ---------------------------------------------------------------------------

def advance_build(state, table, key_attrs: tuple, pages: int):
    """One resumable build quantum: advance the built prefix by up to
    ``pages`` pages (``build_pages_vap``, or ``sharded_build_pages_vap``
    on sharded storage); returns ``(state, pages_done)``.  A cycle's
    budget applied as one call or as any sequence of smaller quanta
    yields the same entries and watermark."""
    before = state.built_pages
    if isinstance(state, ShardedIndex):
        state = sharded_build_pages_vap(state, table, key_attrs,
                                        pages_per_cycle=int(pages))
    else:
        state = build_pages_vap(state, table, key_attrs,
                                pages_per_cycle=int(pages))
    return state, state.built_pages - before


def build_pages_remaining(state, table) -> int:
    """Fully-populated pages not yet covered by the built prefix."""
    full_pages = table.n_rows // table.page_size
    return max(full_pages - state.built_pages, 0)


# Per-shard build quanta: each shard's local prefix advances on its
# own, so the union of the local prefixes need not be a global prefix
# any more; the planner then stitches hybrid scans per shard.  Every
# shard still builds its own pages in order.

def shard_full_pages(table: ShardedTable) -> list:
    """Fully-populated (indexable) page count per shard."""
    return [r // table.page_size for r in table.local_rows]


def shard_remaining_pages(state: ShardedIndex, table: ShardedTable) -> list:
    """Unbuilt fully-populated pages per shard."""
    return [max(f - b, 0)
            for f, b in zip(shard_full_pages(table), state.shard_built)]


def prefix_is_round_robin(state: ShardedIndex) -> bool:
    """True iff the shard-local prefixes still partition one global
    page prefix under the round-robin page map (the global stitch is
    sound for this state)."""
    S, total = state.n_shards, state.built_pages
    return all(b == _count_owned_below(total, s, S)
               for s, b in enumerate(state.shard_built))


def advance_build_shard(state: ShardedIndex, table: ShardedTable,
                        key_attrs: tuple, shard: int, pages: int):
    """One shard-targeted build quantum: advance ``shard``'s local
    prefix by up to ``pages`` pages, clamped at that shard's full-page
    watermark.  Returns (state, pages_done)."""
    before = state.shard_built[shard]
    ix = build_pages_vap(state.shard(shard), table.shard(shard), key_attrs,
                         pages_per_cycle=int(pages))
    return state.replace_shards({shard: ix}), ix.built_pages - before


def split_build_pages(pages: int, quantum_pages: int | None):
    """Slice one cycle's page budget into resumable build quanta
    (``None`` or a quantum at least as large as the budget keeps one
    quantum)."""
    if pages <= 0:
        return []
    if quantum_pages is None or quantum_pages <= 0 or quantum_pages >= pages:
        return [pages]
    out = []
    left = pages
    while left > 0:
        step = min(quantum_pages, left)
        out.append(step)
        left -= step
    return out


# ---------------------------------------------------------------------------
# Index range scan
# ---------------------------------------------------------------------------

def index_range_scan(index: AdHocIndex, lo: KeyPair, hi: KeyPair):
    """Return (entry_mask, rids) for composite keys in [lo, hi] over the
    sorted entry array (callers re-check predicate and visibility)."""
    ar = torch.arange(index.capacity, device=index.key_hi.device)
    mask = keys_in_range(index.key_hi, index.key_lo, lo, hi)
    mask &= ar < index.n_entries
    return mask, index.rids


def index_range_bounds(index, lo_packed, hi_packed):
    """Batched form of ``index_range_scan`` by binary search.

    The entries are sorted, so the entries with keys in [lo, hi] and
    position < n_entries are exactly the positions [start, stop).
    ``lo_packed``/``hi_packed`` are (B,) int64 ``packed_keys`` bounds;
    returns (start, stop), (B,) int64 each, stop >= start -- or, for a
    ``ShardedIndex``, (S, B) each: query q's range in shard s's index.
    """
    keys = packed_keys(index.key_hi, index.key_lo)
    if isinstance(index, ShardedIndex):
        shape = (index.n_shards, lo_packed.shape[0])
        lo_packed = lo_packed.expand(shape).contiguous()
        hi_packed = hi_packed.expand(shape).contiguous()
        n = torch.tensor(index.shard_entries, device=keys.device)[:, None]
    else:
        n = torch.tensor(index.n_entries, device=keys.device)
    start = torch.searchsorted(keys, lo_packed, right=False)
    stop = torch.searchsorted(keys, hi_packed, right=True)
    start = torch.minimum(start, n)
    stop = torch.maximum(torch.minimum(stop, n), start)
    return start, stop


# ---------------------------------------------------------------------------
# Page-coverage bitmap (crack-on-scan / hot-range builds / decay)
# ---------------------------------------------------------------------------

COVERAGE_WORD_BITS = 32


class PageCoverage:
    """Host-managed built-page bitmap over global page ids.

    Mutations (crack adoption, hot-range quanta, decay) are host-side
    numpy bit flips between dispatches; each bumps ``version``.  The
    device views (``global_mask``, ``stacked_mask``, ``packed_words``,
    ``view``) are torch tensors on ``device``, memoised per version, so
    a bitmap is uploaded once per mutation, not once per scan.
    """

    __slots__ = ("built", "version", "max_entry_page", "page_size",
                 "device", "_cache")

    def __init__(self, n_pages: int, page_size: int = 0, device="cpu"):
        self.built = np.zeros(int(n_pages), bool)
        self.version = 0
        self.page_size = int(page_size)  # size accounting (decay cap)
        self.device = torch.device(device)
        # Highest page id entries were ever emitted for (-1: none).
        # The legacy prefix routes are sound only when no entry lies
        # beyond the prefix.
        self.max_entry_page = -1
        self._cache: dict = {}

    @classmethod
    def from_prefix(cls, n_pages: int, prefix: int, page_size: int = 0,
                    device="cpu") -> "PageCoverage":
        cov = cls(n_pages, page_size, device)
        prefix = int(prefix)
        if prefix > 0:
            cov.built[:prefix] = True
            cov.max_entry_page = prefix - 1
        return cov

    @property
    def n_pages(self) -> int:
        return self.built.shape[0]

    def count(self) -> int:
        return int(self.built.sum())

    def prefix_len(self) -> int:
        """Length of the leading all-built run."""
        unbuilt = np.flatnonzero(~self.built)
        return int(unbuilt[0]) if unbuilt.size else self.n_pages

    def is_prefix(self) -> bool:
        """True iff the built pages are exactly [0, prefix_len)."""
        return self.count() == self.prefix_len()

    def legacy_prefix_ok(self, built_pages: int) -> bool:
        """May scans take the legacy ``start_page`` paths?  Only when
        the bitmap is exactly the prefix ``built_pages`` claims and no
        entry lies beyond it."""
        built_pages = int(built_pages)
        return (self.is_prefix()
                and self.prefix_len() == built_pages
                and self.max_entry_page < built_pages)

    def set_pages(self, pages) -> None:
        pages = np.asarray(pages, np.int64)
        if pages.size:
            self.built[pages] = True
            self.max_entry_page = max(self.max_entry_page,
                                      int(pages.max()))
            self.version += 1

    def clear_pages(self, pages) -> None:
        pages = np.asarray(pages, np.int64)
        if pages.size:
            self.built[pages] = False
            self.version += 1

    def uncovered_pages(self, full_pages: int) -> np.ndarray:
        """Unbuilt pages among the fully populated [0, full_pages)."""
        return np.flatnonzero(~self.built[: int(full_pages)])

    def _memo(self, key, build):
        hit = self._cache.get(key)
        if hit is not None and hit[0] == self.version:
            return hit[1]
        val = build()
        self._cache[key] = (self.version, val)
        return val

    def global_mask(self) -> torch.Tensor:
        """(n_pages,) bool mask over global page ids on ``device``."""
        return self._memo(("global",), lambda: torch.from_numpy(
            self.built.copy()).to(self.device))

    def local_built(self, n_shards: int, max_pages: int) -> np.ndarray:
        """(S, max_pages) bool host bitmap over round-robin local page
        ids (global page p -> shard p % S, local page p // S), padded
        with False."""
        S = int(n_shards)
        out = np.zeros((S, int(max_pages)), bool)
        for s in range(S):
            loc = self.built[s::S]
            out[s, : loc.shape[0]] = loc
        return out

    def stacked_mask(self, n_shards: int, max_pages: int) -> torch.Tensor:
        """(S, max_pages) bool mask (stacked-shard layout)."""
        return self._memo(
            ("stacked", n_shards, max_pages),
            lambda: torch.from_numpy(
                self.local_built(n_shards, max_pages)).to(self.device))

    def packed_words(self, n_shards: int, max_pages: int) -> torch.Tensor:
        """(S, W) int32 packed little-endian coverage words over local
        page ids, W = ceil(max_pages / 32): bit ``p & 31`` of word
        ``p >> 5`` is page p's built flag (the sign bit carries page 31
        of each word) -- kernel K3's coverage operand."""

        def build():
            loc = self.local_built(n_shards, max_pages)
            W = -(-loc.shape[1] // COVERAGE_WORD_BITS)
            pad = W * COVERAGE_WORD_BITS - loc.shape[1]
            bits = np.pad(loc, ((0, 0), (0, pad))).astype(np.uint32)
            words = bits.reshape(loc.shape[0], W, COVERAGE_WORD_BITS)
            weights = np.uint32(1) << np.arange(COVERAGE_WORD_BITS,
                                                dtype=np.uint32)
            packed = (words * weights).sum(axis=2, dtype=np.uint32)
            return torch.from_numpy(packed.view(np.int32)).to(self.device)

        return self._memo(("words", n_shards, max_pages), build)

    def view(self, n_shards: int, max_pages: int) -> "CoverageView":
        """Freeze the bitmap into the immutable bundle plans pin
        (``built_host`` is a copy: ``set_pages`` mutates the live array
        between bursts)."""
        return self._memo(
            ("view", n_shards, max_pages),
            lambda: CoverageView(
                prefix_len=self.prefix_len(),
                count=self.count(),
                built_host=self.built.copy(),
                mask=self.stacked_mask(n_shards, max_pages),
                words=self.packed_words(n_shards, max_pages)))


class CoverageView(NamedTuple):
    """Immutable coverage snapshot pinned into a ``ScanPlan``: every
    plan of a burst is minted before any dispatch, so the view stays
    consistent while crack adoption mutates the live bitmap during the
    burst's accounting replay."""

    prefix_len: int  # leading all-built run (start_page report)
    count: int  # total built pages
    built_host: np.ndarray  # (n_pages_global,) bool, host copy
    mask: torch.Tensor  # (S, max_pages) bool, local page ids
    words: torch.Tensor  # (S, W) int32 packed coverage words


def eligible_global_pages(table) -> np.ndarray:
    """Global ids of the fully populated pages -- the only pages
    eligible for a coverage bit (the watermark page is always
    table-scanned).  Plain table: ``[0, n_rows // page_size)``; sharded
    storage: each shard's local full prefix as global ids
    ``s + S * l``, sorted."""
    psz = table.page_size
    if isinstance(table, ShardedTable):
        S = table.n_shards
        out = np.concatenate([
            s + S * np.arange(r // psz, dtype=np.int64)
            for s, r in enumerate(table.local_rows)])
        out.sort()
        return out
    return np.arange(table.n_rows // psz, dtype=np.int64)


def coverage_from_state(state, table) -> PageCoverage:
    """A bitmap equivalent to an index state's built pages.  Per-shard
    prefixes map each shard's local run to global ids ``s + S * l``;
    the sharded bitmap spans ``S * max_pages`` global ids (padding
    bits stay unbuilt)."""
    if isinstance(state, ShardedIndex):
        S = state.n_shards
        cov = PageCoverage(S * table.max_pages, table.page_size,
                           table.device)
        pages = [s + S * np.arange(b, dtype=np.int64)
                 for s, b in enumerate(state.shard_built) if b > 0]
        if pages:
            cov.set_pages(np.concatenate(pages))
        return cov
    return PageCoverage.from_prefix(table.n_pages, state.built_pages,
                                    table.page_size, table.device)


def build_pages_at(index: AdHocIndex, table: Table, key_attrs: tuple,
                   page_ids) -> AdHocIndex:
    """Index an explicit page list (any order), leaving the
    ``built_pages`` watermark untouched.

    Callers pass only fully populated, not yet covered pages (the
    coverage bitmap is the dedup authority).  Same extraction and
    stable merge as ``build_pages_vap``.  The reference pads the list
    to a power of two to bound its jit cache; padding entries are
    invalid keys that never survive the capacity cut (the merged tail
    is a prefix of the old invalid tail), so the unpadded merge gives
    the same arrays.
    """
    psz = table.page_size
    dev = table.device
    pages = torch.as_tensor(np.asarray(page_ids, np.int64), device=dev)
    cols = [table.data[pages, :, a] for a in key_attrs]  # (P, psz)
    kh, kl = make_keys(cols)
    kh, kl = kh.reshape(-1), kl.reshape(-1)
    slot = torch.arange(psz, device=dev)[None, :]
    new_rids = (pages[:, None] * psz + slot).reshape(-1)
    valid = (table.begin_ts[pages] < INF_TS).reshape(-1)
    kh = torch.where(valid, kh, I32_MAX)
    kl = torch.where(valid, kl, I32_MAX)

    mh = torch.cat([index.key_hi, kh])
    ml = torch.cat([index.key_lo, kl])
    mr = torch.cat([index.rids, new_rids.to(torch.int32)])
    mh, ml, mr = _lexsort_merge(mh, ml, mr, index.capacity)
    n_entries = index.n_entries + int(valid.sum())
    return AdHocIndex(mh, ml, mr, n_entries, index.built_pages)


def build_page_list(state, table, key_attrs: tuple, global_pages):
    """Build entries for an explicit GLOBAL page list; returns the new
    index state.  Sharded storage routes each page to its round-robin
    owner (shard p % S, local page p // S).  The caller flips the
    coverage bits."""
    pages = [int(p) for p in global_pages]
    if not pages:
        return state
    if isinstance(state, ShardedIndex):
        S = state.n_shards
        new = {}
        for s in range(S):
            local = [p // S for p in pages if p % S == s]
            if local:
                new[s] = build_pages_at(state.shard(s), table.shard(s),
                                        key_attrs, local)
        return state.replace_shards(new)
    return build_pages_at(state, table, key_attrs, pages)
