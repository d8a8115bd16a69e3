"""Parity of the port's coverage bitmaps (slice D) with the reference.

The cases of tests/test_coverage_bitmap.py on a plain table, each run
in both packages from one state (``from_reference``) and compared
field by field: the flag off keeps the legacy paths; a prefix bitmap
is bit-identical to the legacy path; page-list quanta give scattered
coverage; crack-on-scan adopts pages and stays exact; decay clears
cold pages and reopens the index.  A burst loop with ``crack_on_scan``
and ``index_decay`` through ``execute_batch(use_kernel=True)`` and
``execute`` holds every ``ExecStats`` field but ``wall_s`` / ``tier``,
the clock, the coverage bits, the index arrays and the tuner's quanta
(page lists included) equal.  Kernel K3's plain version is held to the
Pallas kernel in interpret mode, bit for bit, and to K1 on prefix
bitmaps.
"""

import _torch_threads  # noqa: F401  (first: pins torch's threads)

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as R
from repro.core import build_service as R_bs
from repro.core import index as R_ix
from repro.core import table as R_tb
from repro.kernels import ops as R_ops
from repro.kernels.batched_filter_agg import (
    batched_filter_agg as ref_k1,
    sharded_batched_filter_agg_masked as ref_k3,
)
from repro_torch import api as P
from repro_torch.core import build_service as P_bs
from repro_torch.core import hybrid_scan as P_hs
from repro_torch.core import index as P_ix
from repro_torch.core.convert import coverage_from_reference, from_reference
from repro_torch.core.executor import Query as PQuery
from repro_torch.kernels import batched_filter_agg as bfa
from repro_torch.kernels import ops as P_ops

R_hs = importlib.import_module("repro.core.hybrid_scan")

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
N_ROWS, PSZ = 3_000, 128
FULL_PAGES = N_ROWS // PSZ  # fully populated pages of 'narrow' (23)
STAT_FIELDS = ("cost_units", "latency_ms", "used_index", "agg_sum", "count",
               "rows_modified", "populate_units", "shard_pages")


def _stats(s):
    return tuple(getattr(s, f) for f in STAT_FIELDS)


def _port_query(q):
    return PQuery(**{f.name: getattr(q, f.name)
                     for f in dataclasses.fields(q)})


def _scan(lo, width, attr=1):
    return R.Query(kind="scan", table="narrow", attrs=(attr,), los=(lo,),
                   his=(lo + width,), agg_attr=2, template="cov")


def _twin(seed=7, **flags):
    """A reference and a port Database over one TUNER table, with the
    given Database options set on both."""
    src = R.make_tuner_db(n_rows=N_ROWS, page_size=PSZ, seed=seed)
    tables, _ = from_reference(
        tables={k: [np.asarray(x) for x in t] for k, t in src.tables.items()},
        device="cpu")
    rdb, pdb = R.Database(dict(src.tables)), P.Database(tables)
    for db in (rdb, pdb):
        for k, v in flags.items():
            setattr(db, k, v)
    return src, rdb, pdb


def _create(rdb, pdb, key=(1,)):
    rb = rdb.create_index(R.IndexDescriptor("narrow", key), "vap")
    pb = pdb.create_index(P.IndexDescriptor("narrow", key), "vap")
    return rb, pb


def _assert_same_index(rb, pb):
    """Whole index arrays (the tail past n_entries too), watermark,
    flags and coverage bitmap."""
    for f in ("key_hi", "key_lo", "rids"):
        np.testing.assert_array_equal(getattr(pb.vap, f).numpy(),
                                      np.asarray(getattr(rb.vap, f)))
    assert (int(rb.vap.n_entries), int(rb.vap.built_pages)) == (
        pb.vap.n_entries, pb.vap.built_pages)
    assert (rb.complete, rb.building) == (pb.complete, pb.building)
    assert (rb.coverage is None) == (pb.coverage is None)
    if rb.coverage is not None:
        np.testing.assert_array_equal(pb.coverage.built, rb.coverage.built)
        assert pb.coverage.max_entry_page == rb.coverage.max_entry_page
        assert pb.size_bytes() == rb.size_bytes()


def _run_both(rdb, pdb, queries, batch=False, use_kernel=False):
    if batch:
        rs = rdb.execute_batch(queries, use_kernel=use_kernel)
        ps = pdb.execute_batch([_port_query(q) for q in queries],
                               use_kernel=use_kernel)
    else:
        rs = [rdb.execute(q) for q in queries]
        ps = [pdb.execute(_port_query(q)) for q in queries]
    for i, (a, b) in enumerate(zip(rs, ps)):
        assert _stats(a) == _stats(b), (i, a, b)
    assert rdb.clock_ms == pdb.clock_ms
    assert [dataclasses.astuple(r) for r in rdb.monitor.records] == [
        dataclasses.astuple(r) for r in pdb.monitor.records]
    return rs, ps


# ---------------------------------------------------------------------------
# PageCoverage and the explicit-page build
# ---------------------------------------------------------------------------

def test_page_coverage_matches_reference():
    rng = np.random.default_rng(3)
    for n_pages in (1, 31, 32, 45, 70):
        bits = rng.random(n_pages) < 0.5
        bits[min(31, n_pages - 1)] = True  # the sign bit of word 0
        rc = R_ix.PageCoverage(n_pages, PSZ)
        pc = P_ix.PageCoverage(n_pages, PSZ, device="cpu")
        for cov in (rc, pc):
            cov.set_pages(np.flatnonzero(bits))
            cov.clear_pages(np.flatnonzero(bits)[:1])
        for S in (1, 3):
            mp = -(-n_pages // S)
            np.testing.assert_array_equal(pc.packed_words(S, mp).numpy(),
                                          np.asarray(rc.packed_words(S, mp)))
            np.testing.assert_array_equal(pc.stacked_mask(S, mp).numpy(),
                                          np.asarray(rc.stacked_mask(S, mp)))
        assert pc.packed_words(1, n_pages).dtype == torch.int32
        np.testing.assert_array_equal(pc.global_mask().numpy(),
                                      np.asarray(rc.global_mask()))
        for f in ("count", "prefix_len", "is_prefix"):
            assert getattr(pc, f)() == getattr(rc, f)()
        for built in (0, 3, n_pages):
            assert pc.legacy_prefix_ok(built) == rc.legacy_prefix_ok(built)
        np.testing.assert_array_equal(pc.uncovered_pages(n_pages - 1),
                                      rc.uncovered_pages(n_pages - 1))
        rv, pv = rc.view(1, n_pages), pc.view(1, n_pages)
        assert (pv.prefix_len, pv.count) == (rv.prefix_len, rv.count)
        np.testing.assert_array_equal(pv.built_host, rv.built_host)
        assert pc.view(1, n_pages) is pv  # memoised per version
        pc.set_pages([0])
        assert pc.view(1, n_pages) is not pv
    carried = coverage_from_reference(
        (rc.built, rc.max_entry_page, rc.page_size), device="cpu")
    np.testing.assert_array_equal(carried.built, rc.built)
    assert (carried.max_entry_page, carried.page_size) == (
        rc.max_entry_page, rc.page_size)


def test_build_page_list_matches_reference():
    """Out-of-order page lists merge to the reference's arrays,
    including the tail past n_entries (which the reference's padding of
    the list to a power of two never reaches)."""
    rng = np.random.default_rng(5)
    vals = rng.integers(1, 500, size=(1100, 4)).astype(np.int32)
    rt = R_tb.load_table(vals, page_size=64, n_pages=24)
    ri = R_ix.build_pages_vap(R_ix.make_index(rt.capacity), rt, (1, 2),
                              pages_per_cycle=3)
    tables, indexes = from_reference(
        tables={"t": [np.asarray(x) for x in rt]},
        indexes={"i": [np.asarray(x) for x in ri]}, device="cpu")
    pt, pi = tables["t"], indexes["i"]
    for pages in ([9, 4, 16], [5], [15, 7, 11, 12, 6]):
        ri = R_ix.build_page_list(ri, rt, (1, 2), pages)
        pi = P_ix.build_page_list(pi, pt, (1, 2), pages)
        for a, b in zip(ri, pi):
            np.testing.assert_array_equal(
                b.numpy() if isinstance(b, torch.Tensor) else b,
                np.asarray(a))
    assert P_ix.build_page_list(pi, pt, (1, 2), []) is pi
    np.testing.assert_array_equal(P_ix.eligible_global_pages(pt),
                                  R_ix.eligible_global_pages(rt))


# ---------------------------------------------------------------------------
# The masked hybrid-scan forms
# ---------------------------------------------------------------------------

COVERS = {
    "empty": lambda n, rng: np.zeros(n, bool),
    "prefix": lambda n, rng: np.arange(n) < n // 3,
    "scattered": lambda n, rng: rng.random(n) < 0.5,
}


@pytest.mark.parametrize("cover", sorted(COVERS))
@pytest.mark.parametrize("key_attrs,attrs", [((1,), (1,)), ((1, 2), (1, 2)),
                                             ((1,), (1, 3))])
def test_masked_scans_match_reference(cover, key_attrs, attrs):
    """Single, batched and index-side masked forms on an index whose
    entries reach past the covered pages (stale entries dropped)."""
    rng = np.random.default_rng(len(attrs) * 7 + len(cover))
    vals = rng.integers(1, 500, size=(1100, 4)).astype(np.int32)
    rt = R_tb.load_table(vals, page_size=64, n_pages=24)
    ri = R_ix.build_pages_vap(R_ix.make_index(rt.capacity), rt, key_attrs,
                              pages_per_cycle=12)
    rt, _ = R_tb.update_rows(rt, (1,), jnp.array([100]), jnp.array([180]),
                             jnp.array([1, 2]), jnp.array([150, 9]), ts=3,
                             max_new=50)
    tables, indexes = from_reference(
        tables={"t": [np.asarray(x) for x in rt]},
        indexes={"i": [np.asarray(x) for x in ri]}, device="cpu")
    pt, pi = tables["t"], indexes["i"]
    covered = COVERS[cover](24, rng)
    prefix = int(np.argmin(covered)) if not covered.all() else 24
    B = 5
    los = rng.integers(1, 450, size=(B, len(attrs))).astype(np.int32)
    his = (los + rng.integers(0, 150, size=(B, len(attrs)))).astype(np.int32)
    tss = rng.choice([2, 4, 6], size=B).astype(np.int32)
    rc, pc = jnp.asarray(covered), torch.from_numpy(covered)
    r = R_hs.batched_hybrid_scan_masked(rt, ri, key_attrs, attrs, los, his,
                                        tss, 2, rc, prefix)
    p = P_hs.batched_hybrid_scan_masked(pt, pi, key_attrs, attrs, los, his,
                                        tss, 2, pc, prefix)
    for a, b in zip(r, p):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    r = R_hs.batched_masked_index_side(rt, ri, key_attrs, attrs, los, his,
                                       tss, 2, rc, prefix)
    p = P_hs.batched_masked_index_side(pt, pi, key_attrs, attrs, los, his,
                                       tss, 2, pc, prefix)
    for a, b in zip(r, p):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    r = R_hs.hybrid_scan_masked(rt, ri, key_attrs, attrs, los[0], his[0],
                                int(tss[0]), 2, rc, prefix)
    p = P_hs.hybrid_scan_masked(pt, pi, key_attrs, attrs, los[0], his[0],
                                int(tss[0]), 2, pc, prefix)
    for a, b in zip(r, p):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---------------------------------------------------------------------------
# The database cases of tests/test_coverage_bitmap.py, in both packages
# ---------------------------------------------------------------------------

def test_flag_off_keeps_legacy_paths():
    _, rdb, pdb = _twin()
    rb, pb = _create(rdb, pdb)
    assert rb.coverage is None and pb.coverage is None
    for db, bi in ((rdb, rb), (pdb, pb)):
        db.vap_build_step(bi, pages=5)
    q = _scan(100_000, 30_000)
    rp, pp = rdb.planner.plan_scan(q), pdb.planner.plan_scan(_port_query(q))
    assert rp.path == pp.path == "hybrid"
    assert pp.pinned_coverage is None
    _run_both(rdb, pdb, [q, _scan(500_000, 40_000)], batch=True,
              use_kernel=True)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("build_pages,lo,width", [
    (1, 5_000, 2_000), (7, 300_000, 60_000), (FULL_PAGES, 120_000, 90_000),
    (12, 777_000, 120_000)])
def test_prefix_bitmap_bit_identical_to_legacy(build_pages, lo, width,
                                               use_kernel):
    """A prefix-shaped bitmap (crack adoption off) plans the masked
    path and matches the legacy start_page path in results and
    cost / clock / monitor accounting -- and the reference -- through
    ``execute`` and ``execute_batch``."""
    queries = [_scan(lo, width), _scan(max(lo - width, 1), width),
               _scan(lo + width // 2 + 1, width)]
    _, legacy, _ = _twin()
    bi = legacy.create_index(R.IndexDescriptor("narrow", (1,)), "vap")
    legacy.vap_build_step(bi, pages=build_pages)
    want = [_stats(legacy.execute(q)) for q in queries]
    for batch in (False, True):
        _, rdb, pdb = _twin(crack_on_scan=True, crack_pages_per_scan=0)
        rb, pb = _create(rdb, pdb)
        assert pb.coverage is not None
        for db, b in ((rdb, rb), (pdb, pb)):
            db.vap_build_step(b, pages=build_pages)
        assert pb.coverage.is_prefix()
        assert pb.coverage.count() == min(build_pages, FULL_PAGES)
        plan = pdb.planner.plan_scan(_port_query(queries[0]))
        if plan.index is not None:
            assert plan.path == "hybrid_masked"
            assert plan.pinned_coverage.count == pb.coverage.count()
        _, ps = _run_both(rdb, pdb, queries, batch=batch,
                          use_kernel=use_kernel)
        assert [_stats(s) for s in ps] == want
        assert pdb.clock_ms == legacy.clock_ms
        _assert_same_index(rb, pb)


def test_page_list_quantum_scattered_coverage():
    """Out-of-order page-list quanta give a non-prefix bitmap whose
    masked scans match the reference and the no-index oracle; replaying
    the list is a no-op, never a duplicate."""
    src, rdb, pdb = _twin(index_decay=True)
    rb, pb = _create(rdb, pdb)
    picks = [int(p) for p in P.eligible_global_pages(
        pdb.tables["narrow"])[::3]]
    works = [db.vap_build_step(b, pages=len(picks), page_list=picks)
             for db, b in ((rdb, rb), (pdb, pb))]
    assert works[0] == works[1] > 0
    assert not pb.coverage.is_prefix()
    assert pb.coverage.count() == len(picks)
    _assert_same_index(rb, pb)
    assert pdb.planner.plan_scan(
        _port_query(_scan(300_000, 50_000))).path == "hybrid_masked"
    queries = [_scan(300_000, 50_000), _scan(100_000, 30_000),
               _scan(600_000, 30_000)]
    oracle = R.Database(dict(src.tables))
    want = [(s.agg_sum, s.count) for s in map(oracle.execute, queries)]
    for use_kernel in (False, True):
        _, ps = _run_both(rdb, pdb, queries, batch=True,
                          use_kernel=use_kernel)
        assert [(s.agg_sum, s.count) for s in ps] == want
    before = pb.coverage.count()
    assert pdb.vap_build_step(pb, pages=len(picks), page_list=picks) == 0.0
    assert pb.coverage.count() == before


def test_crack_on_scan_adopts_and_stays_exact():
    """Crack adoption grows coverage as scans run, charges its work as
    populate_units, never changes results, and converges: once every
    page is covered the index closes."""
    src, rdb, pdb = _twin(crack_on_scan=True, crack_pages_per_scan=4)
    rb, pb = _create(rdb, pdb)
    oracle = R.Database(dict(src.tables))
    adopted = 0.0
    for lo in (700_000, 50_000, 400_000, 700_000, 50_000, 400_000):
        q = _scan(lo, 40_000)
        _, (p,) = _run_both(rdb, pdb, [q])
        o = oracle.execute(q)
        assert (o.agg_sum, o.count) == (p.agg_sum, p.count)
        adopted += p.populate_units
        _assert_same_index(rb, pb)
    assert pb.coverage.count() > 0 and adopted > 0.0
    while pb.building:
        _run_both(rdb, pdb, [_scan(1, 999_999)])
    assert pb.complete and rb.complete
    assert pb.coverage.count() == FULL_PAGES
    _assert_same_index(rb, pb)


def test_decay_clears_cold_pages_and_reopens():
    """The decay pass drops the coldest covered pages under the
    storage cap, reopens the index, and masked scans stay exact."""
    src, rdb, pdb = _twin(index_decay=True)
    rb, pb = _create(rdb, pdb)
    for db, b in ((rdb, rb), (pdb, pb)):
        db.vap_build_step(b, pages=FULL_PAGES)
    assert pb.complete and not pb.building
    before = pb.coverage.count()
    assert before == FULL_PAGES
    # Budget for ~10 built pages: 12 bytes/entry * page_size rows.
    budget = 12.0 * 10 * PSZ
    rtun = R.PredictiveTuner(rdb, R.TunerConfig(storage_budget_bytes=budget))
    ptun = P.PredictiveTuner(pdb, P.TunerConfig(storage_budget_bytes=budget))
    _run_both(rdb, pdb, [_scan(450_000, 30_000)])  # a hot range
    rtun._decay_cold_pages()
    ptun._decay_cold_pages()
    assert pb.coverage.count() < before
    assert pb.building and not pb.complete
    assert pdb.total_index_bytes() <= budget + 1e-9
    _assert_same_index(rb, pb)
    oracle = R.Database(dict(src.tables))
    for lo in (100_000, 450_000, 800_000):
        q = _scan(lo, 30_000)
        _, (p,) = _run_both(rdb, pdb, [q])
        o = oracle.execute(q)
        assert (o.agg_sum, o.count) == (p.agg_sum, p.count)


def test_coverage_burst_loop_matches_reference():
    """Read bursts with crack-on-scan and decay through
    ``execute_batch(use_kernel=True)`` and ``execute``, with updates,
    inserts and one decide / apply cycle per burst: every accounting
    field, the clock, the coverage bits, the index arrays and the
    quanta (page lists included) match.  The hot windows move over
    attribute 0, the row id (clustered, so zone maps prune and a hot
    window is a hot page range); halfway the storage budget shrinks
    below the built footprint, so decay clears pages of the index the
    updates keep.  The masked path is planned with bitmaps that are not
    a prefix."""
    src, rdb, pdb = _twin(seed=9, crack_on_scan=True, index_decay=True,
                          crack_pages_per_scan=2)
    cfg = dict(storage_budget_bytes=50e3, pages_per_cycle=3,
               max_build_pages_per_cycle=3, candidate_min_count=2)
    rtun = R.PredictiveTuner(rdb, R.TunerConfig(**cfg))
    ptun = P.PredictiveTuner(pdb, P.TunerConfig(**cfg))
    gen = R.QueryGen(src, selectivity=0.03, seed=4)
    rng = np.random.default_rng(2)
    phases = rng.permutation(6)
    page_lists = masked_non_prefix = decayed = 0
    for burst in range(10):
        if burst == 5:  # below one index's footprint: decay must run
            for tun in (rtun, ptun):
                tun.cfg.storage_budget_bytes = 12.0 * 8 * PSZ
        hot = 1 + int(phases[burst // 2 % 6]) * 480 + int(
            rng.integers(0, 300))
        qs = [_scan(hot + 7 * k, 60, attr=0) for k in range(5)]
        qs += [gen.low_s(attr=3),
               R.Query(kind="update", table="narrow", attrs=(0,),
                       los=(hot,), his=(hot + 3,), set_attrs=(3,),
                       set_vals=(77,), template="upd"),
               _scan(hot, 60, attr=0), gen.ins(n=4)]
        plans = [pdb.planner.plan_scan(_port_query(q)) for q in qs
                 if q.kind == "scan"]
        masked_non_prefix += sum(
            p.path == "hybrid_masked" and not p.index.coverage.is_prefix()
            for p in plans)
        _run_both(rdb, pdb, qs, batch=True, use_kernel=True)
        _run_both(rdb, pdb, [_scan(hot + 5, 60, attr=0)])
        counts = {n: b.coverage.count() for n, b in pdb.indexes.items()}
        rp, pp = rtun.decide(), ptun.decide()
        decayed += any(b.coverage.count() < counts.get(n, 0)
                       for n, b in pdb.indexes.items())
        assert [(q.index_name, q.pages, q.page_list, q.utility)
                for q in rp.quanta] == [
            (q.index_name, q.pages, q.page_list, q.utility)
            for q in pp.quanta]
        assert rtun.forecasts == ptun.forecasts
        page_lists += sum(bool(q.page_list) for q in pp.quanta)
        rw = sum(R_bs.apply_quantum(rdb, q) for q in rp.quanta)
        pw = sum(P_bs.apply_quantum(pdb, q) for q in pp.quanta)
        assert rw == pw
        assert sorted(rdb.indexes) == sorted(pdb.indexes)
        for name, rb in rdb.indexes.items():
            _assert_same_index(rb, pdb.indexes[name])
    assert page_lists > 0 and masked_non_prefix > 0 and decayed > 0


# ---------------------------------------------------------------------------
# Kernel K3: plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

K3_PAGES, K3_PSZ, K3_ATTRS, K3_BLOCK = 45, 16, 4, 8  # 45: not /32, not /8


def _k3_inputs(S, cover, seed):
    """Stacked planes (S, 45, 16) with ragged real page counts (padding
    pages invisible, as the reference's contract requires), query
    operands and packed words for one bitmap shape."""
    rng = np.random.default_rng(seed)
    data = rng.integers(2**29, I32_MAX, size=(S, K3_PAGES, K3_PSZ,
                                              K3_ATTRS)).astype(np.int32)
    begin = rng.integers(0, 20, size=(S, K3_PAGES, K3_PSZ)).astype(np.int32)
    end = np.where(rng.random((S, K3_PAGES, K3_PSZ)) < 0.2,
                   rng.integers(5, 30, size=(S, K3_PAGES, K3_PSZ)),
                   I32_MAX).astype(np.int32)
    local = np.array([K3_PAGES, 40, 33][:S], np.int32)
    for s in range(S):
        begin[s, local[s]:] = I32_MAX
    B = 6
    lo = rng.integers(2**29, I32_MAX - 2**29, size=(B, 2))
    q = [lo[:, 0], lo[:, 0] + 2**29, lo[:, 1], lo[:, 1] + 2**29,
         rng.integers(0, 30, size=B)]
    q = [np.asarray(x, np.int32) for x in q]
    built = np.zeros((S, K3_PAGES), bool)
    prefix = 17
    if cover == "prefix":
        built[:, :prefix] = True
    elif cover == "scattered":
        built = rng.random((S, K3_PAGES)) < 0.5
    elif cover == "full":
        built[:] = True
    W = -(-K3_PAGES // 32)
    bits = np.pad(built, ((0, 0), (0, W * 32 - K3_PAGES))).astype(np.uint32)
    words = (bits.reshape(S, W, 32) << np.arange(32, dtype=np.uint32)).sum(
        axis=2, dtype=np.uint32).view(np.int32)
    return data, begin, end, q, words, local, prefix


def _k3_planes(data, begin, end, as_torch):
    conv = torch.from_numpy if as_torch else jnp.asarray
    d = conv(data)
    return d[..., 1], d[..., 3], d[..., 2], conv(begin), conv(end)


@pytest.mark.parametrize("cover", ["empty", "prefix", "scattered", "full"])
@pytest.mark.parametrize("S", [1, 3])
def test_k3_plain_matches_pallas(S, cover):
    data, begin, end, q, words, local, _ = _k3_inputs(S, cover, seed=S)
    ref = ref_k3(*_k3_planes(data, begin, end, False),
                 *[jnp.asarray(x) for x in q], jnp.asarray(words),
                 jnp.asarray(local), block_pages=K3_BLOCK, interpret=True)
    args = (*_k3_planes(data, begin, end, True),
            *[torch.from_numpy(x) for x in q], torch.from_numpy(words),
            torch.from_numpy(local))
    before = bfa.masked_launches
    out = bfa.sharded_batched_filter_agg_masked(*args)
    plain = bfa.sharded_batched_filter_agg_masked_plain(*args)
    assert bfa.masked_launches == before  # CPU tensors: the plain version
    for r, o, p in zip(ref, out, plain):
        assert o.dtype == torch.int32
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    if cover == "full":
        assert not out[1].any()


@pytest.mark.parametrize("S", [1, 3])
def test_k3_prefix_bitmap_equals_k1(S):
    """The reference's identity: a prefix bitmap of length L gives K1's
    result with start_pages = L (per shard, summed), in both packages."""
    data, begin, end, q, words, local, L = _k3_inputs(S, "prefix", seed=11)
    k3 = bfa.sharded_batched_filter_agg_masked(
        *_k3_planes(data, begin, end, True), *[torch.from_numpy(x) for x in q],
        torch.from_numpy(words), torch.from_numpy(local))
    starts = torch.full((len(q[0]),), L, dtype=torch.int32)
    sums = torch.zeros_like(k3[0], dtype=torch.int64)
    cnts = torch.zeros_like(sums)
    rsums = np.zeros(len(q[0]), np.int64)
    for s in range(S):
        planes = [x[s] for x in _k3_planes(data, begin, end, True)]
        k1 = bfa.batched_filter_agg(*planes,
                                    *[torch.from_numpy(x) for x in q],
                                    starts)
        sums += k1[0]
        cnts += k1[1]
        r1 = ref_k1(*[x[s] for x in _k3_planes(data, begin, end, False)],
                    *[jnp.asarray(x) for x in q], jnp.asarray(starts.numpy()),
                    block_pages=K3_BLOCK, interpret=True)
        rsums += np.asarray(r1[0], np.int64)
    assert torch.equal(k3[0], sums.to(torch.int32))
    assert torch.equal(k3[1], cnts.to(torch.int32))
    np.testing.assert_array_equal(k3[0].numpy(), rsums.astype(np.int32))


def test_k3_wrapper_rejects_short_coverage_words():
    data, begin, end, q, words, local, _ = _k3_inputs(1, "empty", seed=2)
    before = bfa.masked_launches
    with pytest.raises(ValueError, match="W \\* 32 >= n_pages"):
        bfa.sharded_batched_filter_agg_masked(
            *_k3_planes(data, begin, end, True),
            *[torch.from_numpy(x) for x in q],
            torch.from_numpy(words[:, :1]), torch.from_numpy(local))
    with pytest.raises(ValueError, match="no K3 kernel"):
        meta = [torch.empty((1, 4, 8), dtype=torch.int32, device="meta")] * 5
        bfa.sharded_batched_filter_agg_masked(
            *meta, *[torch.zeros((2,), dtype=torch.int32, device="meta")] * 5,
            torch.zeros((1, 1), dtype=torch.int32, device="meta"),
            torch.zeros((1,), dtype=torch.int32, device="meta"))
    assert bfa.masked_launches == before


def test_masked_ops_adapter_matches_reference():
    rng = np.random.default_rng(21)
    vals = rng.integers(0, 1000, size=(900, 5)).astype(np.int32)
    rt = R_tb.load_table(vals, page_size=64, n_pages=18)
    pt = from_reference(tables={"t": [np.asarray(x) for x in rt]},
                        device="cpu")[0]["t"]
    cov = R_ix.PageCoverage(18, 64)
    cov.set_pages([1, 2, 5, 11, 17])
    words = cov.packed_words(1, 18)
    for attrs in ((1,), (1, 3)):
        los = np.array([[100 + 50 * i] * len(attrs) for i in range(4)],
                       np.int32)
        his, tss = los + 300, np.zeros(4, np.int32)
        r = R_ops.scan_table_batched_masked(rt, attrs, jnp.asarray(los),
                                            jnp.asarray(his),
                                            jnp.asarray(tss), 2, words)
        p = P_ops.scan_table_batched_masked(pt, attrs, torch.from_numpy(los),
                                            torch.from_numpy(his),
                                            torch.from_numpy(tss), 2,
                                            torch.from_numpy(
                                                np.asarray(words)))
        for a, b in zip(r, p):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
