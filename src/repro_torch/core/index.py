"""Ad-hoc secondary indexes with partial, incremental construction.

Port of the VAP / FULL half of ``repro.core.index`` (the value-based
VBP scheme lands with the baselines slice).  The index is a
lexicographically sorted (key_hi, key_lo, rid) array with fixed
capacity; invalid slots hold (INT32_MAX, INT32_MAX), which sorts after
every real key (the TUNER domain is [1, 1m]).

* ``FULL`` -- usable only once every page is indexed.
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
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.core.table import INF_TS, Table

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
# Resumable build quanta
# ---------------------------------------------------------------------------

def advance_build(state: AdHocIndex, table: Table, key_attrs: tuple,
                  pages: int):
    """One resumable build quantum: advance the built prefix by up to
    ``pages`` pages; returns ``(state, pages_done)``.  A cycle's budget
    applied as one call or as any sequence of smaller quanta yields the
    same entries and watermark."""
    before = state.built_pages
    state = build_pages_vap(state, table, key_attrs,
                            pages_per_cycle=int(pages))
    return state, state.built_pages - before


def build_pages_remaining(state: AdHocIndex, table: Table) -> int:
    """Fully-populated pages not yet covered by the built prefix."""
    full_pages = table.n_rows // table.page_size
    return max(full_pages - state.built_pages, 0)


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


def index_range_bounds(index: AdHocIndex, lo_packed, hi_packed):
    """Batched form of ``index_range_scan`` by binary search.

    The entries are sorted, so the entries with keys in [lo, hi] and
    position < n_entries are exactly the positions [start, stop).
    ``lo_packed``/``hi_packed`` are (B,) int64 ``packed_keys`` bounds;
    returns (start, stop), (B,) int64 each, stop >= start.
    """
    keys = packed_keys(index.key_hi, index.key_lo)
    start = torch.searchsorted(keys, lo_packed, right=False)
    stop = torch.searchsorted(keys, hi_packed, right=True)
    start = torch.clamp(start, max=index.n_entries)
    stop = torch.maximum(torch.clamp(stop, max=index.n_entries), start)
    return start, stop
