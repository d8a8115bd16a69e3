"""Scan engine: turns planned scans into dispatches.

Port of ``repro.core.engine.ScanEngine``.  The engine receives an
access path, raw index state and per-query bounds, and owns the
dispatch strategy:

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

A batched dispatch over sharded storage takes the device mesh first
(``mesh_mode``: None = whenever ``parallel.mesh.make_scan_mesh``
places a grid, False = never, True = required, raising without a
placement): the ``mesh_*`` forms split the stacked shard axis -- and,
with ``mesh_query_axis > 1``, the burst's queries -- over a grid of
devices, run the stacked bodies per device slice (with the kernel
path, one K4 or K3 launch per slice) and reduce the partials on the
first device.  One card places no grid (the reference's rule needs
two devices), so there the stacked dispatch runs; a device list
forced by ``parallel.mesh.force_local_devices`` (d entries naming one
device) runs the mesh forms on one card or on the CPU.

Every dispatch records its execution tier in ``last_tier`` (vocabulary
``TIERS``): ``shard_map`` for a mesh dispatch, ``kernel`` for a kernel
dispatch; otherwise ``single`` on a plain table, ``vmap-stacked`` for
a sharded batch and ``loop`` for a sharded single-query scan, as in
the reference.  Plain tables and single-query scans never take the
mesh.

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
from repro_torch.core.index import (
    AdHocIndex,
    ShardedIndex,
    slice_coverage,
    slice_shard_indexes,
)
from repro_torch.core.table import ShardedTable, Table, slice_shards
from repro_torch.kernels import ops as _kops
from repro_torch.kernels.ref import i32_sum
from repro_torch.parallel.mesh import local_devices, make_scan_mesh


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

def _operands(st, attrs, los, his, tss):
    """A burst's bounds and snapshots as int32 tensors on ``st``'s
    device: (B, len(attrs)), (B, len(attrs)), (B,)."""
    dev = st.device
    return (_bounds(los, len(attrs), dev), _bounds(his, len(attrs), dev),
            torch.as_tensor(tss, dtype=torch.int32, device=dev))


def _fold(x, n_shards: int):
    """(S * B,) per-(shard, query) partials -> (B,) int32 sums with
    int32 wraparound."""
    return i32_sum(x.reshape(n_shards, -1), dim=0)


def _folded_sums(st, pr, keep):
    """(sum, count, entries_probed) of the kept entries, each (B,)
    int32, folded over the stacked shards."""
    S = st.n_shards
    s, c = _segment_sums(pr, keep)
    return _fold(s, S), _fold(c, S), _fold(pr.entries_probed, S)


def _prefix_result(st, pr, keep, start_page):
    return HybridPrefixResult(*_folded_sums(st, pr, keep),
                              start_page.to(torch.int32))


# The stitch helpers below also run on one device's slice of the
# shards (the mesh forms): ``st`` / ``six`` then hold shards [shard0,
# shard0 + st.n_shards) of a table of ``S`` shards, and page ids stay
# GLOBAL -- local page ``pg`` of shard s is global page ``pg * S + s``.

def _shard_ids(st, shard0):
    """(S_local, 1) global shard id of each stacked shard."""
    return shard0 + torch.arange(st.n_shards, device=st.device)[:, None]


def _hybrid_rho(st, pr, B, shard0, S):
    """Pass 1 of the global stitch: each entry's global page and the
    per-query rho_m, the largest global page holding a match (-1 for
    none), over the probed shards."""
    gpage = pr.page * S + shard0 + pr.seg // B
    rho = _segment_max_page(pr, gpage).reshape(st.n_shards, B).amax(0)
    return gpage, rho


def _hybrid_stitch(st, pr, gpage, start, shard0, S):
    """Pass 2 of the global stitch at the per-query global start
    ``start``: the index matches below it and each shard's LOCAL start
    ``ceil((g - s) / S)`` clipped at 0.  Returns (HybridPrefixResult,
    local_starts (S_local, B), kept entries)."""
    keep = pr.match & (gpage < start[pr.qid])
    local = torch.div(start[None, :] - _shard_ids(st, shard0) + S - 1, S,
                      rounding_mode="floor")
    local = torch.clamp(local, min=0).to(torch.int32)
    return _prefix_result(st, pr, keep, start), local, keep


def _stacked_hybrid_prefix(st, six, key_attrs, attrs, los, his, tss,
                           agg_attr):
    """Global-stitch index half of B hybrid scans: the per-query stitch
    point ``max(rho_m, built)`` over global page ids, the index matches
    below it, and each shard's LOCAL start.  Returns
    (HybridPrefixResult, local_starts (S, B), probe, kept entries)."""
    S, B = st.n_shards, los.shape[0]
    pr = _probe_stacked(st, six, key_attrs, attrs, los, his, tss, agg_attr)
    gpage, rho_m = _hybrid_rho(st, pr, B, 0, S)
    start = torch.clamp(rho_m, min=six.built_pages)  # rho_i + 1
    pre, local, keep = _hybrid_stitch(st, pr, gpage, start, 0, S)
    return pre, local, pr, keep


def _stacked_hybrid_prefix_ps(st, six, key_attrs, attrs, los, his, tss,
                              agg_attr, shard0=0, S=None):
    """Per-shard-stitch index half of B hybrid scans: each shard's
    local stitch point ``max(local rho_m, shard built)``.  Returns
    (HybridPrefixResult with start_page = min over shards of ``lstart
    * S + s``, local_starts (S, B), pages_scanned (B,), probe, kept
    entries)."""
    S = st.n_shards if S is None else S
    B = los.shape[0]
    dev = st.device
    pr = _probe_stacked(st, six, key_attrs, attrs, los, his, tss, agg_attr)
    lrho = _segment_max_page(pr).reshape(st.n_shards, B)
    built = torch.tensor(six.shard_built, device=dev)[:, None]
    lstart = torch.maximum(lrho, built)
    keep = pr.match & (pr.page < lstart.reshape(-1)[pr.seg])
    psz = st.page_size
    lused = torch.tensor([-(-r // psz) for r in st.local_rows],
                         device=dev)[:, None]
    pages = torch.clamp(lused - lstart, min=0).sum(0).to(torch.int32)
    gstart = (lstart * S + _shard_ids(st, shard0)).amin(0)
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
    los, his, tss = _operands(st, attrs, los, his, tss)
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


# ---------------------------------------------------------------------------
# Mesh forms: the stacked shard axis split over a device grid
# ---------------------------------------------------------------------------
#
# One controller runs every slice of the grid (``parallel.mesh``):
# device i of the shard axis owns shards [i * S / d, (i + 1) * S / d),
# device j of the query axis owns queries [j * B / q, (j + 1) * B / q).
# Each slice runs the stacked bodies above on its own shards
# (``table.slice_shards``: a view on the table's own device) with
# GLOBAL shard ids and the global S, and its partials are reduced on
# the grid's first device: int32 sums (int64 cast back), max, min.
# The reference's collectives become explicit passes: ``hybrid`` takes
# rho_m as the max over slices (pass 1), then runs every slice at the
# global stitch point ``max(rho_m, built)`` with ``built`` the global
# built prefix (pass 2); ``hybrid_ps`` reduces only its outputs
# (``start_page`` is the min over slices); the masked form slices the
# coverage mask and words by shard; the pure index forms sum.
#
# With ``use_kernel`` the table suffix of each slice is ONE launch over
# the slice's shards -- K4 (``kernels.ops.scan_shards_batched``) from
# the slice's (S_local, B) local starts, K3
# (``scan_shards_batched_masked``) from its (S_local, W) coverage
# words.  The reference launches its single-shard kernel once per
# local shard; the sums are the same bits in any grouping (int32
# additions wrap associatively), and one launch per device is the
# port's design.  On CPU tensors the wrappers run their plain
# versions, as the reference's CPU meshes run jnp bodies.


class _Slice(NamedTuple):
    """One grid cell's operands: shards [shard0, shard0 + table.n_shards)
    and one block of the burst's queries, on ``device``."""

    device: torch.device
    shard0: int
    table: ShardedTable
    index: Optional[ShardedIndex]
    los: torch.Tensor
    his: torch.Tensor
    tss: torch.Tensor


def _mesh_rows(mesh, st, index, los, his, tss):
    """The grid's slices, one list (over the shard axis) per query
    block."""
    d, q = len(mesh.devices), len(mesh.devices[0])
    S, B = st.n_shards, los.shape[0]
    if S % d or B % q:
        raise ValueError(f"a {d} x {q} mesh cannot split {S} shards and "
                         f"{B} queries evenly")
    per_dev, per_q = S // d, B // q
    for j in range(q):
        qs = slice(j * per_q, (j + 1) * per_q)
        row = []
        for i in range(d):
            dev = mesh.devices[i][j]
            a, b = i * per_dev, (i + 1) * per_dev
            row.append(_Slice(
                dev, a, slice_shards(st, a, b, dev),
                None if index is None else slice_shard_indexes(index, a, b,
                                                               dev),
                los[qs].to(dev), his[qs].to(dev), tss[qs].to(dev)))
        yield row


def _first_device(mesh) -> torch.device:
    return mesh.devices[0][0]


def _reduce(parts, dev0, op="sum"):
    """Per-slice (B,) partials -> one (B,) tensor on ``dev0``: their
    int32 sum (wrapping), max or min."""
    x = torch.stack([p.to(dev0) for p in parts])
    if op == "max":
        return x.amax(0)
    if op == "min":
        return x.amin(0)
    return i32_sum(x, dim=0)


def _slice_suffix(sl, attrs, agg_attr, local_starts, use_kernel):
    """Table suffix of one slice from its (S_local, B) local starts: one
    K4 launch, or the plain stacked mask."""
    if use_kernel:
        return _kops.scan_shards_batched(sl.table, attrs, sl.los, sl.his,
                                         sl.tss, agg_attr, local_starts)
    s, c, _ = _table_side(sl.table, attrs, sl.los, sl.his, sl.tss, agg_attr,
                          _local_page_ok(sl.table, local_starts))
    return s, c


def _zero_starts(sl):
    return torch.zeros((sl.table.n_shards, sl.los.shape[0]),
                       dtype=torch.int32, device=sl.device)


def mesh_batched_full_table_scan(st: ShardedTable, attrs: tuple, los, his,
                                 tss, agg_attr: int, mesh,
                                 use_kernel: bool = False
                                 ) -> BatchScanResult:
    """B plain table scans over every shard, split over ``mesh``."""
    los, his, tss = _operands(st, attrs, los, his, tss)
    dev0 = _first_device(mesh)
    sums, cnts = [], []
    for row in _mesh_rows(mesh, st, None, los, his, tss):
        parts = [_slice_suffix(sl, attrs, agg_attr, _zero_starts(sl),
                               use_kernel) for sl in row]
        sums.append(_reduce([p[0] for p in parts], dev0))
        cnts.append(_reduce([p[1] for p in parts], dev0))
    B = los.shape[0]
    z = torch.zeros((B,), dtype=torch.int32, device=dev0)
    used = torch.full((B,), _used_pages(st), dtype=torch.int32, device=dev0)
    return BatchScanResult(torch.cat(sums), torch.cat(cnts), used, z,
                           z.clone())


def mesh_batched_hybrid_scan(st: ShardedTable, index: ShardedIndex,
                             key_attrs: tuple, attrs: tuple, los, his, tss,
                             agg_attr: int, mesh,
                             use_kernel: bool = False) -> BatchScanResult:
    """B hybrid scans (global stitch) split over ``mesh``: pass 1
    reduces rho_m (max over slices), pass 2 runs every slice at the
    global stitch point."""
    los, his, tss = _operands(st, attrs, los, his, tss)
    dev0, S = _first_device(mesh), st.n_shards
    cols, starts = [[] for _ in range(3)], []
    for row in _mesh_rows(mesh, st, index, los, his, tss):
        Bq = row[0].los.shape[0]
        probes = [_probe_stacked(sl.table, sl.index, key_attrs, attrs,
                                 sl.los, sl.his, sl.tss, agg_attr)
                  for sl in row]
        rhos = [_hybrid_rho(sl.table, pr, Bq, sl.shard0, S)
                for sl, pr in zip(row, probes)]
        rho_m = _reduce([r for _, r in rhos], dev0, "max")
        start = torch.clamp(rho_m, min=index.built_pages)  # rho_i + 1
        parts = []
        for sl, pr, (gpage, _) in zip(row, probes, rhos):
            pre, local, _ = _hybrid_stitch(sl.table, pr, gpage,
                                           start.to(sl.device), sl.shard0, S)
            s, c = _slice_suffix(sl, attrs, agg_attr, local, use_kernel)
            parts.append((add_i32(pre.agg_sum, s), add_i32(pre.count, c),
                          pre.entries_probed))
        for k in range(3):
            cols[k].append(_reduce([p[k] for p in parts], dev0))
        starts.append(start.to(torch.int32))
    start = torch.cat(starts)
    return BatchScanResult(torch.cat(cols[0]), torch.cat(cols[1]),
                           _pages_after(st, start), torch.cat(cols[2]),
                           start)


def mesh_batched_hybrid_scan_pershard(st: ShardedTable,
                                      index: ShardedIndex, key_attrs: tuple,
                                      attrs: tuple, los, his, tss,
                                      agg_attr: int, mesh,
                                      use_kernel: bool = False
                                      ) -> BatchScanResult:
    """B hybrid scans with shard-local stitch points split over
    ``mesh``: no stitch reduction, only the outputs (``start_page`` is
    the min over slices)."""
    los, his, tss = _operands(st, attrs, los, his, tss)
    dev0, S = _first_device(mesh), st.n_shards
    cols = [[] for _ in range(5)]
    for row in _mesh_rows(mesh, st, index, los, his, tss):
        parts = []
        for sl in row:
            pre, local, pages, _, _ = _stacked_hybrid_prefix_ps(
                sl.table, sl.index, key_attrs, attrs, sl.los, sl.his,
                sl.tss, agg_attr, shard0=sl.shard0, S=S)
            s, c = _slice_suffix(sl, attrs, agg_attr, local, use_kernel)
            parts.append((add_i32(pre.agg_sum, s), add_i32(pre.count, c),
                          pages, pre.entries_probed, pre.start_page))
        for k, op in enumerate(("sum", "sum", "sum", "sum", "min")):
            cols[k].append(_reduce([p[k] for p in parts], dev0, op))
    return BatchScanResult(*(torch.cat(c).to(torch.int32) for c in cols))


def mesh_batched_hybrid_scan_masked(st: ShardedTable, index: ShardedIndex,
                                    key_attrs: tuple, attrs: tuple, los,
                                    his, tss, agg_attr: int, cov_view,
                                    mesh, use_kernel: bool = False
                                    ) -> BatchScanResult:
    """B masked hybrid scans split over ``mesh``: each slice takes its
    shards' rows of the coverage mask and words; the accounting comes
    from the pinned view, as in the stacked form."""
    los, his, tss = _operands(st, attrs, los, his, tss)
    dev0 = _first_device(mesh)
    cols = [[] for _ in range(3)]
    for row in _mesh_rows(mesh, st, index, los, his, tss):
        parts = []
        for sl in row:
            n = sl.table.n_shards
            cov = slice_coverage(cov_view, sl.shard0, sl.shard0 + n,
                                 sl.device)
            pre, _, _ = _stacked_masked_prefix(
                sl.table, sl.index, key_attrs, attrs, sl.los, sl.his,
                sl.tss, agg_attr, cov)
            if use_kernel:
                s, c = _kops.scan_shards_batched_masked(
                    sl.table, attrs, sl.los, sl.his, sl.tss, agg_attr,
                    cov.words)
            else:
                Bq = sl.los.shape[0]
                s, c, _ = _table_side(sl.table, attrs, sl.los, sl.his,
                                      sl.tss, agg_attr,
                                      (~cov.mask)[None].expand(Bq, -1, -1))
            parts.append((add_i32(pre.agg_sum, s), add_i32(pre.count, c),
                          pre.entries_probed))
        for k in range(3):
            cols[k].append(_reduce([p[k] for p in parts], dev0))
    B = los.shape[0]
    start = torch.full((B,), cov_view.prefix_len, dtype=torch.int32,
                       device=dev0)
    return BatchScanResult(torch.cat(cols[0]), torch.cat(cols[1]),
                           _masked_pages(st, cov_view, B).to(dev0),
                           torch.cat(cols[2]), start)


def mesh_batched_pure_index_scan(st: ShardedTable, index: ShardedIndex,
                                 key_attrs: tuple, attrs: tuple, los, his,
                                 tss, agg_attr: int,
                                 mesh) -> BatchScanResult:
    """B index-only scans split over ``mesh``."""
    los, his, tss = _operands(st, attrs, los, his, tss)
    dev0 = _first_device(mesh)
    cols = [[] for _ in range(3)]
    for row in _mesh_rows(mesh, st, index, los, his, tss):
        parts = []
        for sl in row:
            pr = _probe_stacked(sl.table, sl.index, key_attrs, attrs,
                                sl.los, sl.his, sl.tss, agg_attr)
            parts.append(_folded_sums(sl.table, pr, pr.match))
        for k in range(3):
            cols[k].append(_reduce([p[k] for p in parts], dev0))
    B = los.shape[0]
    return BatchScanResult(
        torch.cat(cols[0]), torch.cat(cols[1]),
        torch.zeros((B,), dtype=torch.int32, device=dev0),
        torch.cat(cols[2]),
        torch.full((B,), st.n_pages, dtype=torch.int32, device=dev0))




class ScanEngine:
    """Dispatch strategy for planned scans over either storage.

    ``after_dispatch``, when set, is invoked after every batched group
    dispatch (the build lane's drain point, ``dispatch_complete``).
    """

    #: dispatch-strategy vocabulary recorded in ``last_tier``
    TIERS = ("loop", "vmap-stacked", "kernel", "pmap", "shard_map")

    def __init__(self):
        self.after_dispatch = None
        # Mesh execution: None = auto (a mesh whenever the local
        # devices can place one), False = never, True = required (no
        # placement raises instead of falling back).
        self.mesh_mode = None
        self.mesh_query_axis = 1  # > 1 folds the 2-D query axis
        self.last_tier = None

    def _scan_mesh(self, n_shards: int, batch: int,
                   device_type: str = "cuda"):
        """The grid for this dispatch, or None (stacked fallback)."""
        if self.mesh_mode is False:
            return None
        mesh = None
        q = self.mesh_query_axis
        if q > 1 and batch % q == 0:
            mesh = make_scan_mesh(n_shards, q, device_type)
        if mesh is None:
            mesh = make_scan_mesh(n_shards, 1, device_type)
        if mesh is None and self.mesh_mode is True:
            n = len(local_devices(device_type))
            raise RuntimeError(
                f"mesh execution required but {n_shards} shards cannot "
                f"be placed on {n} local devices")
        return mesh

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
        """One dispatch for a plan group over sharded storage: the mesh
        forms when the local devices place a grid (every family; tier
        ``shard_map``), else the stacked dispatch."""
        B = len(tss)
        mesh = self._scan_mesh(st.n_shards, B, st.device.type)
        if mesh is not None:
            self.last_tier = "shard_map"
            if path in PURE_INDEX_PATHS:
                return mesh_batched_pure_index_scan(
                    st, index_state, key_attrs, attrs, los, his, tss,
                    agg_attr, mesh)
            if path == "table":
                return mesh_batched_full_table_scan(
                    st, attrs, los, his, tss, agg_attr, mesh, kernel_ok)
            if path == "hybrid_masked":
                return mesh_batched_hybrid_scan_masked(
                    st, index_state, key_attrs, attrs, los, his, tss,
                    agg_attr, coverage, mesh, kernel_ok)
            fn = (mesh_batched_hybrid_scan_pershard if path == "hybrid_ps"
                  else mesh_batched_hybrid_scan)
            return fn(st, index_state, key_attrs, attrs, los, his, tss,
                      agg_attr, mesh, kernel_ok)
        if not kernel_ok or path in PURE_INDEX_PATHS:
            self.last_tier = "kernel" if kernel_ok else "vmap-stacked"
            return sharded_batched_scan(st, path, index_state, key_attrs,
                                        attrs, los, his, tss, agg_attr,
                                        coverage)
        self.last_tier = "kernel"
        los, his, tss = _operands(st, attrs, los, his, tss)
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
