"""Parity of the port's sharded storage (slice E) with the reference.

Sharded tables, indexes, builds and mutators; every batched scan
family over uniform round-robin and skewed 36/4/4/4 pre-sharded
layouts, with the port's kernel path (K4 / K3 plain versions on the
CPU) and its plain path against the reference's stacked path; the
database cases of ``test_sharded_engine.py`` (joins and VBP are in
tests/test_torch_joins.py and tests/test_torch_vbp.py, the runner in
tests/test_torch_runner.py) and of ``test_coverage_bitmap.py`` at 4 shards; and a
burst loop with tuning on 4 shards.  Tolerance 0 everywhere: every
int32 aggregate and every cost, clock and monitor field is compared
for equality.

The reference's sharded INSERT parks masked-off writes on each shard's
last slot and can lose a real row there (ROADMAP.md, queue 3 item 1).
The port does not, so its database runs are held against the
reference's 1-shard run -- the reference's own shard-invariance
contract -- and ``test_port_keeps_the_row_the_reference_sharded_insert
_loses`` pins the divergence.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as R
from benchmarks.shard_tuning import make_skewed_db
from repro.core import build_service as R_bs
from repro.core import engine as R_eng
from repro.core import index as R_ix
from repro.core import table as R_tb
from repro_torch import api as P
from repro_torch.core import build_service as P_bs
from repro_torch.core import engine as P_eng
from repro_torch.core import index as P_ix
from repro_torch.core import table as P_tb
from repro_torch.core.convert import from_reference
from repro_torch.core.executor import Query as PQuery

N_ROWS, PSZ = 3_000, 128
SRC = R.make_tuner_db(n_rows=N_ROWS, page_size=PSZ)
N_PAGES = SRC.tables["narrow"].n_pages  # 36 (headroom 1.5)
STAT_FIELDS = ("cost_units", "latency_ms", "used_index", "agg_sum", "count",
               "rows_modified", "populate_units", "shard_pages")
FAMILIES = ("table", "hybrid", "hybrid_ps", "pure_vap")


def _stats(s):
    return tuple(getattr(s, f) for f in STAT_FIELDS)


def _port_query(q):
    return PQuery(**{f.name: getattr(q, f.name)
                     for f in dataclasses.fields(q)})


def _fields(x):
    """A reference record as the nested numpy fields ``from_reference``
    takes (plain or sharded tables and indexes)."""
    if isinstance(x, R_tb.ShardedTable):
        return ([_fields(t) for t in x.shards], np.asarray(x.n_rows))
    if isinstance(x, R_ix.ShardedIndex):
        return ([_fields(ix) for ix in x.shards],)
    return [np.asarray(f) for f in x]


def _port_table(rt):
    return from_reference(tables={"t": _fields(rt)}, device="cpu")[0]["t"]


def _port_index(ri):
    return from_reference(indexes={"i": _fields(ri)}, device="cpu")[1]["i"]


def _port_tables(tables):
    return from_reference(
        tables={k: _fields(t) for k, t in tables.items()}, device="cpu")[0]


def _assert_table_equal(ref, port):
    """Shard by shard (a plain reference table against a plain port
    table, or unsharded)."""
    if isinstance(ref, R_tb.ShardedTable):
        assert isinstance(port, P_tb.ShardedTable)
        assert port.n_rows == int(ref.n_rows)
        assert len(ref.shards) == port.n_shards
        pairs = zip(ref.shards, port.shards)
    else:
        pairs = [(ref, port)]
    for r, p in pairs:
        for name in ("data", "begin_ts", "end_ts"):
            np.testing.assert_array_equal(getattr(p, name).numpy(),
                                          np.asarray(getattr(r, name)),
                                          err_msg=name)
        assert p.n_rows == int(r.n_rows)


def _assert_index_equal(ref, port):
    """Whole per-shard arrays (tails included) and watermarks."""
    assert len(ref.shards) == port.n_shards
    for r, p in zip(ref.shards, port.shards):
        for name in ("key_hi", "key_lo", "rids"):
            np.testing.assert_array_equal(getattr(p, name).numpy(),
                                          np.asarray(getattr(r, name)),
                                          err_msg=name)
        assert (p.n_entries, p.built_pages) == (int(r.n_entries),
                                                int(r.built_pages))


def _assert_result_equal(ref, port, label=""):
    for field in port._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(port, field)),
            np.asarray(getattr(ref, field)), err_msg=f"{label}.{field}")


def _bounds(n_queries, seed=0, width=20_000, two_attr=False):
    """Per-query bounds as in test_fused_shard_scan.py (numpy)."""
    rng = np.random.default_rng(seed)
    los = rng.integers(1, 5 * 10**5, size=(n_queries, 1)).astype(np.int32)
    his = los + width
    if two_attr:
        los = np.concatenate(
            [los, np.zeros((n_queries, 1), np.int32)], axis=1)
        his = np.concatenate(
            [his, np.full((n_queries, 1), 10**6, np.int32)], axis=1)
    tss = np.full((n_queries,), 5, np.int32)
    return los, his, tss


# ---------------------------------------------------------------------------
# Storage: partition, watermarks, mutators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_shard_table_roundtrip_ragged(S):
    """25 pages over S shards (unequal local page counts): the same
    shards as the reference, padding invisible, and a round trip."""
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 100, size=(300, 4)).astype(np.int32)
    rt = R_tb.load_table(vals, page_size=16, n_pages=25)
    pt = P_tb.load_table(vals, page_size=16, n_pages=25, device="cpu")
    rst, pst = R_tb.shard_table(rt, S), P_tb.shard_table(pt, S)
    _assert_table_equal(rst, pst)
    assert pst.n_pages == rst.n_pages == 25
    assert pst.local_pages == tuple(t.n_pages for t in rst.shards)
    for s, lp in enumerate(pst.local_pages):
        assert (pst.begin_ts[s, lp:] == P_tb.NEVER_TS).all()
    assert P_tb.round_robin_layout(pst) == R_tb.round_robin_layout(rst)
    back = P_tb.unshard_table(pst)
    _assert_table_equal(R_tb.unshard_table(rst), back)
    for s, lp in enumerate(pst.local_pages):
        for n_rows in (0, 17, 160, 400):
            assert P_tb.local_n_rows(n_rows, s, S, 16, lp) == int(
                R_tb.local_n_rows(n_rows, s, S, 16, lp))
        np.testing.assert_array_equal(
            P_tb.global_rids(lp, s, S, 16, device="cpu").numpy(),
            np.asarray(R_tb.global_rids(lp, s, S, 16)))


def test_skewed_layout_adopted_as_is():
    src = make_skewed_db()
    rst = src.tables["narrow"]
    pst = _port_table(rst)
    _assert_table_equal(rst, pst)
    assert pst.local_pages == (36, 4, 4, 4) and pst.max_pages == 36
    assert not P_tb.round_robin_layout(pst)
    assert not R_tb.round_robin_layout(rst)
    with pytest.raises(ValueError, match="round-robin"):
        P_tb.unshard_table(pst)


@pytest.mark.parametrize("S", [2, 3, 4])
def test_sharded_insert_and_update_match_reference(S):
    """INSERT and UPDATE (more matches than max_new: the first in
    GLOBAL rid order) far from any shard's last slot."""
    rng = np.random.default_rng(S)
    vals = rng.integers(1, 20, size=(700, 4)).astype(np.int32)
    rst = R_tb.shard_table(
        R_tb.load_table(vals, page_size=16, n_pages=90), S)
    pst = _port_table(rst)
    for ts, (lo, hi), set_attrs, set_vals, max_new in (
        (4, (3, 9), (2, 3), (77, 88), 40),
        (9, (5, 5), (3, 0), (1, 2), 8),
    ):
        rst, rn = R_tb.sharded_update_rows(
            rst, (1,), jnp.array([lo]), jnp.array([hi]),
            jnp.array(set_attrs), jnp.array(set_vals), ts, max_new=max_new)
        pst, pn = P_tb.sharded_update_rows(pst, (1,), (lo,), (hi,),
                                           set_attrs, set_vals, ts,
                                           max_new=max_new)
        assert pn == int(rn)
        _assert_table_equal(rst, pst)
        rows = rng.integers(1, 20, size=(7, 4)).astype(np.int32)
        rst = R_tb.sharded_insert_rows(rst, jnp.asarray(rows), ts + 1, 5,
                                       max_new=7)
        pst = P_tb.sharded_insert_rows(pst, torch.from_numpy(rows), ts + 1,
                                       5)
        _assert_table_equal(rst, pst)


def test_sharded_mutators_on_skewed_layout():
    """A skewed layout with append room: INSERT drops rows whose global
    page the owning shard lacks, UPDATE cannot select rids at or past
    the capacity -- both as the reference."""
    rng = np.random.default_rng(3)
    shards = [R_tb.load_table(
        rng.integers(1, 30, size=(n, 3)).astype(np.int32), page_size=8,
        n_pages=p) for n, p in ((60, 10), (10, 2), (8, 3))]
    rst = R_tb.ShardedTable(tuple(shards), jnp.asarray(78, jnp.int32))
    pst = _port_table(rst)
    rst, rn = R_tb.sharded_update_rows(
        rst, (1,), jnp.array([1]), jnp.array([12]), jnp.array([2]),
        jnp.array([99]), 4, max_new=32)
    pst, pn = P_tb.sharded_update_rows(pst, (1,), (1,), (12,), (2,), (99,),
                                       4, max_new=32)
    assert pn == int(rn) > 0
    _assert_table_equal(rst, pst)
    rows = rng.integers(1, 30, size=(20, 3)).astype(np.int32)
    rst = R_tb.sharded_insert_rows(rst, jnp.asarray(rows), 6, 20, max_new=20)
    pst = P_tb.sharded_insert_rows(pst, torch.from_numpy(rows), 6, 20)
    _assert_table_equal(rst, pst)


def _mutation_mix(seed):
    """The query mix of the reference's randomized shard-invariance
    test for one seed."""
    rng = np.random.default_rng(seed)
    gen = R.QueryGen(SRC, selectivity=float(rng.choice([0.005, 0.05, 0.5])),
                     seed=seed)
    queries = []
    for _ in range(10):
        r = int(rng.integers(5))
        if r == 0:
            queries.append(gen.mod_s())
        elif r == 1:
            queries.append(gen.low_u(attr=int(rng.integers(1, 4))))
        elif r == 2:
            queries.append(gen.ins(n=int(rng.integers(1, 9))))
        else:
            queries.append(gen.low_s(attr=int(rng.integers(1, 4))))
    return queries


def _db_pair(S, scheme=None, build_pages=0, tables=None):
    """The reference at 1 shard and the port at ``S`` shards, from one
    state, with an optional index on attr 1 built ``build_pages``."""
    tables = dict(SRC.tables if tables is None else tables)
    rdb = R.Database(dict(tables))
    pdb = P.Database(_port_tables(tables), num_shards=S)
    for db in (rdb, pdb):
        if scheme is not None:
            bi = db.create_index(_desc(db), scheme)
            if build_pages:
                db.vap_build_step(bi, pages=build_pages)
    return rdb, pdb


def _desc(db, key=(1,)):
    mod = R if isinstance(db, R.Database) else P
    return mod.IndexDescriptor("narrow", key)


def _assert_db_invariant(rdb, pdb, queries, use_kernel=False):
    """The reference's per-query loop at 1 shard against the port's
    batched run: every stats field, clock, monitor and table."""
    ref = [rdb.execute(q) for q in queries]
    got = pdb.execute_batch([_port_query(q) for q in queries],
                            use_kernel=use_kernel)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert _stats(a) == _stats(b), (i, queries[i].template, a, b)
        if queries[i].kind == "scan":
            assert b.tier == ("kernel" if use_kernel else "vmap-stacked")
    assert pdb.clock_ms == rdb.clock_ms
    assert [dataclasses.astuple(r) for r in rdb.monitor.records] == [
        dataclasses.astuple(r) for r in pdb.monitor.records]
    for name, t in pdb.tables.items():
        _assert_table_equal(rdb.tables[name], P_tb.unshard_table(t))
    return got


def test_port_keeps_the_row_the_reference_sharded_insert_loses():
    """The reference's randomized shard-invariance test fails at
    seed=8168, num_shards=4, built_frac=0: after the mix, its 4-shard
    table lost the row at global page 32, slot 127 (shard 0's last
    slot) to a parked write.  The port at 4 shards keeps that row and
    equals the reference's 1-shard run everywhere, stats included."""
    queries = _mutation_mix(8168)
    rdb4 = R.Database(dict(SRC.tables), num_shards=4)
    for q in queries:
        rdb4.execute_batch([q])
    rdb, pdb = _db_pair(4)
    _assert_db_invariant(rdb, pdb, queries)
    ref1 = rdb.tables["narrow"]
    ref4 = R_tb.unshard_table(rdb4.tables["narrow"])
    port = P_tb.unshard_table(pdb.tables["narrow"])
    diff = np.flatnonzero((np.asarray(ref4.begin_ts)
                           != np.asarray(ref1.begin_ts)).reshape(-1))
    assert diff.tolist() == [32 * PSZ + 127]
    assert int(np.asarray(ref4.begin_ts)[32, 127]) == R_tb.NEVER_TS
    assert int(port.begin_ts[32, 127]) == int(
        np.asarray(ref1.begin_ts)[32, 127]) != P_tb.NEVER_TS
    np.testing.assert_array_equal(port.data[32, 127].numpy(),
                                  np.asarray(ref1.data)[32, 127])


@pytest.mark.parametrize("seed,S,built_frac", [
    (0, 2, 0), (1, 3, 1), (2, 4, 2), (3, 4, 3), (77, 2, 3), (8168, 3, 1)])
def test_shard_invariance_with_mutations(seed, S, built_frac):
    """The reference's randomized mixes at fixed seeds: scans, updates
    and inserts through ``execute_batch``, kernel path on odd seeds."""
    build = (N_PAGES * built_frac) // 3
    rdb, pdb = _db_pair(S, "vap" if built_frac else None, build)
    _assert_db_invariant(rdb, pdb, _mutation_mix(seed),
                         use_kernel=bool(seed % 2))


# ---------------------------------------------------------------------------
# Indexes: global-page-order builds, per-shard builds, coverage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [2, 4])
def test_sharded_vap_build_matches_reference(S):
    """Stepped budgets give the reference's per-shard entry arrays; the
    local prefixes partition the global prefix."""
    rst = R_tb.shard_table(SRC.tables["narrow"], S)
    pst = _port_table(rst)
    rx, px = R_ix.make_sharded_index(rst), P_ix.make_sharded_index(pst)
    _assert_index_equal(rx, px)
    for budget in (3, 5, 1, 7, 40):
        rx, rd = R_ix.advance_build(rx, rst, (1,), budget)
        px, pd = P_ix.advance_build(px, pst, (1,), budget)
        assert pd == rd
        _assert_index_equal(rx, px)
        assert P_ix.prefix_is_round_robin(px)
        assert P_ix.build_pages_remaining(px, pst) == \
            R_ix.build_pages_remaining(rx, rst)


def test_per_shard_builds_match_reference():
    rst = R_tb.shard_table(SRC.tables["narrow"], 4)
    pst = _port_table(rst)
    rx, px = R_ix.make_sharded_index(rst), P_ix.make_sharded_index(pst)
    for shard, pages in ((0, 5), (3, 2), (0, 20), (2, 1)):
        before = px
        rx, rd = R_ix.advance_build_shard(rx, rst, (1, 2), shard, pages)
        px, pd = P_ix.advance_build_shard(px, pst, (1, 2), shard, pages)
        assert pd == rd
        _assert_index_equal(rx, px)
        assert before.key_hi is not px.key_hi  # new arrays, never in place
        assert P_ix.prefix_is_round_robin(px) == \
            R_ix.prefix_is_round_robin(rx)
        assert P_ix.shard_remaining_pages(px, pst) == \
            R_ix.shard_remaining_pages(rx, rst)
        assert P_ix.shard_full_pages(pst) == R_ix.shard_full_pages(rst)
        rc = R_ix.coverage_from_state(rx, rst)
        pc = P_ix.coverage_from_state(px, pst)
        np.testing.assert_array_equal(pc.built, rc.built)
        assert pc.max_entry_page == rc.max_entry_page
    np.testing.assert_array_equal(P_ix.eligible_global_pages(pst),
                                  R_ix.eligible_global_pages(rst))


def test_build_page_list_matches_reference():
    rst = R_tb.shard_table(SRC.tables["narrow"], 4)
    pst = _port_table(rst)
    rx, px = R_ix.make_sharded_index(rst), P_ix.make_sharded_index(pst)
    pages = [int(p) for p in P_ix.eligible_global_pages(pst)[::3]]
    for chunk in (pages[:3], pages[3:], [1, 2]):
        rx = R_ix.build_page_list(rx, rst, (1,), chunk)
        px = P_ix.build_page_list(px, pst, (1,), chunk)
        _assert_index_equal(rx, px)


# ---------------------------------------------------------------------------
# Engine: every batched family, plain and kernel paths, single queries
# ---------------------------------------------------------------------------

def _engine_state(S=4, build_pages=9, shard_builds=(), skewed=False):
    """Reference and port sharded table + VAP index on attr 1."""
    if skewed:
        rdb = R.Database(dict(make_skewed_db().tables))
    else:
        rdb = R.Database(dict(SRC.tables), num_shards=S)
    bi = rdb.create_index(R.IndexDescriptor("narrow", (1,)), "vap")
    if build_pages:
        rdb.vap_build_step(bi, pages=build_pages)
    for shard, pages in shard_builds:
        rdb.vap_build_step(bi, pages=pages, shard=shard)
    rst = rdb.tables["narrow"]
    return rst, bi.vap, _port_table(rst), _port_index(bi.vap)


def _both_batches(rst, rix, pst, pix, path, attrs, los, his, tss, agg,
                  coverage=None):
    """The reference's stacked path against the port's plain and
    kernel paths; returns the port's kernel-path result."""
    ref = R_eng.ScanEngine().scan_batch(
        rst, path, rix, (1,), attrs, jnp.asarray(los), jnp.asarray(his),
        jnp.asarray(tss), agg, use_kernel=False,
        coverage=coverage[0] if coverage else None)
    out = None
    for use_kernel, tier in ((False, "vmap-stacked"), (True, "kernel")):
        eng = P_eng.ScanEngine()
        got = eng.scan_batch(
            pst, path, pix, (1,), attrs, torch.from_numpy(los),
            torch.from_numpy(his), torch.from_numpy(tss), agg,
            use_kernel=use_kernel,
            coverage=coverage[1] if coverage else None)
        _assert_result_equal(ref, got, f"{path}.kernel={use_kernel}")
        assert eng.last_tier == tier
        out = got
    return out


@pytest.mark.parametrize("two_attr", [False, True])
@pytest.mark.parametrize("S", [2, 3, 4])
@pytest.mark.parametrize("path", FAMILIES)
def test_families_match_reference_uniform(path, S, two_attr):
    rst, rix, pst, pix = _engine_state(S=S)
    attrs, agg = ((1, 2), 3) if two_attr else ((1,), 2)
    los, his, tss = _bounds(6, seed=S, two_attr=two_attr)
    _both_batches(rst, rix, pst, pix, path, attrs, los, his, tss, agg)


@pytest.mark.parametrize("path", FAMILIES)
def test_families_match_reference_skewed(path):
    """The 36/4/4/4 pre-sharded layout with divergent per-shard
    prefixes: padding pages stay invisible, K4's padding-tile skip and
    per-shard local starts give the reference's bits."""
    rst, rix, pst, pix = _engine_state(
        build_pages=0, shard_builds=((0, 10), (2, 4)), skewed=True)
    assert pst.max_pages == 36 and len(set(pst.local_pages)) > 1
    los, his, tss = _bounds(5, seed=11, width=40_000)
    _both_batches(rst, rix, pst, pix, path, (1,), los, his, tss, 2)


def test_hybrid_ps_divergent_prefixes():
    rst, rix, pst, pix = _engine_state(build_pages=0,
                                       shard_builds=((0, 5), (3, 2)))
    assert not P_ix.prefix_is_round_robin(pix)
    los, his, tss = _bounds(8, seed=23)
    r = _both_batches(rst, rix, pst, pix, "hybrid_ps", (1,), los, his, tss,
                      2)
    assert (r.start_page < 4 * 5).all()


@pytest.mark.parametrize("skewed", [False, True])
def test_kernel_path_matches_reference_kernel_path(skewed):
    """Through the reference's own kernel path (K4 in Pallas interpret
    mode) as well: the port's K4 plain version agrees."""
    rst, rix, pst, pix = _engine_state(
        build_pages=0 if skewed else 9, skewed=skewed,
        shard_builds=((0, 6), (1, 1)) if skewed else ())
    los, his, tss = _bounds(5, seed=4, width=40_000)
    for path in ("table", "hybrid", "hybrid_ps"):
        ref = R_eng.ScanEngine().scan_batch(
            rst, path, rix, (1,), (1,), jnp.asarray(los), jnp.asarray(his),
            jnp.asarray(tss), 2, use_kernel=True)
        got = P_eng.ScanEngine().scan_batch(
            pst, path, pix, (1,), (1,), torch.from_numpy(los),
            torch.from_numpy(his), torch.from_numpy(tss), 2,
            use_kernel=True)
        _assert_result_equal(ref, got, path)


def _coverage_pair(rst, pages):
    """A reference and a port bitmap over the same global pages and
    their pinned views."""
    S, max_pages = len(rst.shards), max(t.n_pages for t in rst.shards)
    rc = R_ix.PageCoverage(S * max_pages, PSZ)
    pc = P_ix.PageCoverage(S * max_pages, PSZ, "cpu")
    for c in (rc, pc):
        c.set_pages(pages)
    return rc.view(S, max_pages), pc.view(S, max_pages)


@pytest.mark.parametrize("cover", ["prefix", "scattered"])
def test_masked_family_matches_reference(cover):
    rst, rix, pst, pix = _engine_state(build_pages=0)
    eligible = P_ix.eligible_global_pages(pst)
    pages = eligible[:10] if cover == "prefix" else eligible[1::3]
    rix = R_ix.build_page_list(rix, rst, (1,), pages)
    pix = P_ix.build_page_list(pix, pst, (1,), pages)
    views = _coverage_pair(rst, pages)
    los, his, tss = _bounds(6, seed=5, width=50_000)
    _both_batches(rst, rix, pst, pix, "hybrid_masked", (1,), los, his, tss,
                  2, coverage=views)


@pytest.mark.parametrize("path", FAMILIES + ("hybrid_masked",))
def test_single_query_scans_match_reference(path):
    """``ScanEngine.scan`` on sharded storage (tier ``loop``) against
    the reference's single-query sharded operators, the per-shard
    contrib planes (which the join reads) included."""
    rst, rix, pst, pix = _engine_state(shard_builds=((1, 3),))
    views = _coverage_pair(rst, P_ix.eligible_global_pages(pst)[::2])
    rdesc = R.IndexDescriptor("narrow", (1,))
    rbi = R.Database(dict(SRC.tables)).create_index(rdesc, "vap")
    pbi = P.Database(_port_tables(SRC.tables)).create_index(
        P.IndexDescriptor("narrow", (1,)), "vap")
    from repro.core.planner import ScanPlan as RPlan
    from repro_torch.core.planner import ScanPlan as PPlan

    for lo, width in ((100_000, 30_000), (400_000, 80_000)):
        rplan = RPlan(path, rbi if path != "table" else None,
                      pinned_state=rix, pinned_coverage=views[0])
        pplan = PPlan(path, pbi if path != "table" else None,
                      pinned_state=pix, pinned_coverage=views[1])
        ref = R_eng.ScanEngine().scan(rst, rplan, (1,),
                                      jnp.asarray([lo]),
                                      jnp.asarray([lo + width]), 7, 2)
        eng = P_eng.ScanEngine()
        got = eng.scan(pst, pplan, (1,), (lo,), (lo + width,), 7, 2,
                       contribs=True)
        assert eng.last_tier == "loop"
        for f in got._fields:
            if f == "contribs":
                continue
            assert int(getattr(got, f)) == int(getattr(ref, f)), (path, f)
        assert len(ref.contribs) == pst.n_shards
        for s, (lp, plane) in enumerate(zip(pst.local_pages, ref.contribs)):
            np.testing.assert_array_equal(got.contribs[s, :lp].numpy(),
                                          np.asarray(plane))
            assert not got.contribs[s, lp:].any()
        assert int(got.contribs.sum()) == int(got.count) > 0
        # Only a join's outer scan asks for the planes.
        bare = eng.scan(pst, pplan, (1,), (lo,), (lo + width,), 7, 2)
        assert bare.contribs is None
        assert [int(x) for x in bare[:2] + bare[3:]] == [
            int(x) for x in got[:2] + got[3:]]


def test_mutation_then_kernel_scan_sees_the_new_rows():
    """The stale-stack trap: the port's sharded table IS the stacked
    layout the kernel path reads, so a scan after INSERT / UPDATE sees
    the new versions (against the reference's 1-shard run)."""
    gen = R.QueryGen(SRC, selectivity=0.05, seed=31)
    rdb, pdb = _db_pair(4, "vap", build_pages=12)
    data_ptr = pdb.tables["narrow"].data.data_ptr()
    queries = [gen.low_s(attr=1), gen.ins(n=8), gen.low_s(attr=1),
               R.Query(kind="update", table="narrow", attrs=(1,),
                       los=(1,), his=(400_000,), set_attrs=(2,),
                       set_vals=(12_345,), template="upd"),
               gen.low_s(attr=1), gen.mod_s()]
    got = _assert_db_invariant(rdb, pdb, queries, use_kernel=True)
    assert got[3].rows_modified > 0
    assert pdb.tables["narrow"].data.data_ptr() == data_ptr  # in place


# ---------------------------------------------------------------------------
# Database: the cases of test_sharded_engine.py
# ---------------------------------------------------------------------------

def test_database_adopts_presharded_tables_and_reshards():
    tables = {k: R_tb.shard_table(t, 4) for k, t in SRC.tables.items()}
    ptables = _port_tables(tables)
    db = P.Database(dict(ptables))
    assert db.num_shards == 4
    assert all(isinstance(t, P.ShardedTable) and t.n_shards == 4
               for t in db.tables.values())
    db2 = P.Database(dict(ptables), num_shards=2)
    assert db2.num_shards == 2
    assert all(t.n_shards == 2 for t in db2.tables.values())
    bi = db2.create_index(P.IndexDescriptor("narrow", (1,)), "vap")
    db2.vap_build_step(bi, pages=4, shard=1)
    assert db2.pershard_built == {bi.desc.name}
    db2.reshard(3)
    assert db2.indexes == {} and db2.pershard_built == set()
    _assert_table_equal(SRC.tables["narrow"],
                        P_tb.unshard_table(db2.tables["narrow"]))
    db2.reshard(1)
    assert isinstance(db2.tables["narrow"], P.Table)
    skew = P.Database(_port_tables(make_skewed_db().tables))
    assert skew.num_shards == 4 and not skew.table_is_round_robin("narrow")


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("path,scheme,build", [
    ("table", None, 0), ("hybrid", "vap", N_PAGES // 3),
    ("pure_vap", "full", N_PAGES)])
def test_shard_invariance_paths(path, scheme, build, use_kernel):
    gen = R.QueryGen(SRC, selectivity=0.01, seed={"table": 3, "hybrid": 5,
                                                  "pure_vap": 7}[path])
    queries = [gen.low_s(attr=1) if i % 3 or path != "table"
               else gen.mod_s() for i in range(12)]
    for S in (2, 4):
        rdb, pdb = _db_pair(S, scheme, build)
        plan = pdb.planner.plan_scan(_port_query(queries[0]))
        assert plan.path == path
        got = _assert_db_invariant(rdb, pdb, queries, use_kernel)
        if scheme:
            assert all(s.used_index for s in got)


def test_skewed_database_plans_hybrid_ps_and_matches_reference():
    """Adopted skewed tables plan ``hybrid_ps``; per-shard builds, scans
    through both paths, and the same answers as the reference at the
    same layout (read-only: the reference's parked writes never run)."""
    src = make_skewed_db()
    rdb = R.Database(dict(src.tables))
    pdb = P.Database(_port_tables(src.tables))
    gen = R.QueryGen(src, selectivity=0.02, seed=8)
    for db in (rdb, pdb):
        bi = db.create_index(_desc(db), "vap")
        db.vap_build_step(bi, pages=12, shard=0)
        db.vap_build_step(bi, pages=2, shard=2)
    queries = [gen.low_s(attr=1) for _ in range(6)]
    assert pdb.planner.plan_scan(_port_query(queries[0])).path == \
        "hybrid_ps"
    for use_kernel in (False, True):
        a = rdb.execute_batch(queries, use_kernel=use_kernel)
        b = pdb.execute_batch([_port_query(q) for q in queries],
                              use_kernel=use_kernel)
        assert [_stats(x) for x in a] == [_stats(x) for x in b]
    _assert_index_equal(rdb.indexes["narrow:1"].vap,
                        pdb.indexes["narrow:1"].vap)


# ---------------------------------------------------------------------------
# Coverage bitmaps at 4 shards: the cases of test_coverage_bitmap.py
# ---------------------------------------------------------------------------

def _scan(lo, width, attr=1):
    return R.Query(kind="scan", table="narrow", attrs=(attr,), los=(lo,),
                   his=(lo + width,), agg_attr=2, template="cov")


def _twin4(**flags):
    """Reference and port databases at 4 shards with the options set
    (read-only cases: both hold the same sharded layout)."""
    rdb = R.Database(dict(SRC.tables), num_shards=4)
    pdb = P.Database(_port_tables(SRC.tables), num_shards=4)
    for db in (rdb, pdb):
        for k, v in flags.items():
            setattr(db, k, v)
    rb = rdb.create_index(R.IndexDescriptor("narrow", (1,)), "vap")
    pb = pdb.create_index(P.IndexDescriptor("narrow", (1,)), "vap")
    return rdb, pdb, rb, pb


def _run_both(rdb, pdb, queries, batch=False, use_kernel=False):
    if batch:
        rs = rdb.execute_batch(queries, use_kernel=use_kernel)
        ps = pdb.execute_batch([_port_query(q) for q in queries],
                               use_kernel=use_kernel)
    else:
        rs = [rdb.execute(q) for q in queries]
        ps = [pdb.execute(_port_query(q)) for q in queries]
    assert [_stats(a) for a in rs] == [_stats(b) for b in ps]
    assert rdb.clock_ms == pdb.clock_ms
    assert [dataclasses.astuple(r) for r in rdb.monitor.records] == [
        dataclasses.astuple(r) for r in pdb.monitor.records]
    return ps


def _assert_same_coverage(rb, pb):
    _assert_index_equal(rb.vap, pb.vap)
    assert (rb.complete, rb.building) == (pb.complete, pb.building)
    np.testing.assert_array_equal(pb.coverage.built, rb.coverage.built)
    assert pb.coverage.max_entry_page == rb.coverage.max_entry_page


def test_flag_off_keeps_legacy_paths_4_shards():
    rdb, pdb, rb, pb = _twin4()
    assert pb.coverage is None
    for db, b in ((rdb, rb), (pdb, pb)):
        db.vap_build_step(b, pages=5)
    plan = pdb.planner.plan_scan(_port_query(_scan(100_000, 30_000)))
    assert plan.path == "hybrid" and plan.pinned_coverage is None
    _run_both(rdb, pdb, [_scan(100_000, 30_000), _scan(500_000, 40_000)],
              batch=True, use_kernel=True)


@pytest.mark.parametrize("build_pages,lo,width", [
    (1, 5_000, 2_000), (7, 300_000, 60_000), (23, 120_000, 90_000)])
def test_prefix_bitmap_bit_identical_to_legacy_4_shards(build_pages, lo,
                                                        width):
    queries = [_scan(lo, width), _scan(max(lo - width, 1), width),
               _scan(lo + width // 2 + 1, width)]
    legacy = R.Database(dict(SRC.tables), num_shards=4)
    bi = legacy.create_index(R.IndexDescriptor("narrow", (1,)), "vap")
    legacy.vap_build_step(bi, pages=build_pages)
    want = [_stats(legacy.execute(q)) for q in queries]
    for batch, use_kernel in ((False, False), (True, True)):
        rdb, pdb, rb, pb = _twin4(crack_on_scan=True,
                                  crack_pages_per_scan=0)
        for db, b in ((rdb, rb), (pdb, pb)):
            db.vap_build_step(b, pages=build_pages)
        assert pb.coverage.is_prefix()
        plan = pdb.planner.plan_scan(_port_query(queries[0]))
        if plan.index is not None:
            assert plan.path == "hybrid_masked"
        ps = _run_both(rdb, pdb, queries, batch, use_kernel)
        assert [_stats(s) for s in ps] == want
        _assert_same_coverage(rb, pb)


def test_page_list_quantum_scattered_coverage_4_shards():
    rdb, pdb, rb, pb = _twin4(index_decay=True)
    picks = [int(p) for p in P.eligible_global_pages(
        pdb.tables["narrow"])[::3]]
    works = [db.vap_build_step(b, pages=len(picks), page_list=picks)
             for db, b in ((rdb, rb), (pdb, pb))]
    assert works[0] == works[1] > 0 and not pb.coverage.is_prefix()
    _assert_same_coverage(rb, pb)
    queries = [_scan(300_000, 50_000), _scan(100_000, 30_000),
               _scan(600_000, 30_000)]
    assert pdb.planner.plan_scan(_port_query(queries[0])).path == \
        "hybrid_masked"
    oracle = R.Database(dict(SRC.tables))
    want = [(s.agg_sum, s.count) for s in map(oracle.execute, queries)]
    for use_kernel in (False, True):
        ps = _run_both(rdb, pdb, queries, batch=True, use_kernel=use_kernel)
        assert [(s.agg_sum, s.count) for s in ps] == want
    assert pdb.vap_build_step(pb, pages=len(picks), page_list=picks) == 0.0
    for db, b in ((rdb, rb), (pdb, pb)):  # a shard-targeted quantum
        db.vap_build_step(b, pages=3, shard=2)
    _assert_same_coverage(rb, pb)


def test_crack_on_scan_adopts_and_stays_exact_4_shards():
    rdb, pdb, rb, pb = _twin4(crack_on_scan=True, crack_pages_per_scan=4)
    oracle = R.Database(dict(SRC.tables))
    adopted = 0.0
    for lo in (700_000, 50_000, 400_000, 700_000, 50_000, 400_000):
        q = _scan(lo, 40_000)
        (p,) = _run_both(rdb, pdb, [q])
        o = oracle.execute(q)
        assert (o.agg_sum, o.count) == (p.agg_sum, p.count)
        adopted += p.populate_units
        _assert_same_coverage(rb, pb)
    assert pb.coverage.count() > 0 and adopted > 0.0
    while pb.building:
        _run_both(rdb, pdb, [_scan(1, 999_999)], batch=True,
                  use_kernel=True)
    assert pb.complete and rb.complete
    _assert_same_coverage(rb, pb)


def test_decay_clears_cold_pages_and_reopens_4_shards():
    rdb, pdb, rb, pb = _twin4(index_decay=True)
    for db, b in ((rdb, rb), (pdb, pb)):
        db.vap_build_step(b, pages=N_ROWS // PSZ)
    assert pb.complete
    budget = 12.0 * 10 * PSZ
    rtun = R.PredictiveTuner(rdb, R.TunerConfig(storage_budget_bytes=budget))
    ptun = P.PredictiveTuner(pdb, P.TunerConfig(storage_budget_bytes=budget))
    _run_both(rdb, pdb, [_scan(450_000, 30_000)])
    rtun._decay_cold_pages()
    ptun._decay_cold_pages()
    assert pb.building and pdb.total_index_bytes() <= budget + 1e-9
    _assert_same_coverage(rb, pb)
    np.testing.assert_array_equal(pdb.zone_map("narrow", 1)[0],
                                  rdb.zone_map("narrow", 1)[0])
    np.testing.assert_array_equal(pdb.zone_map("narrow", 1)[1],
                                  rdb.zone_map("narrow", 1)[1])
    oracle = R.Database(dict(SRC.tables))
    for lo in (100_000, 450_000, 800_000):
        q = _scan(lo, 30_000)
        (p,) = _run_both(rdb, pdb, [q], batch=True, use_kernel=True)
        o = oracle.execute(q)
        assert (o.agg_sum, o.count) == (p.agg_sum, p.count)


# ---------------------------------------------------------------------------
# The loop: bursts, mutations and tuning on 4 shards
# ---------------------------------------------------------------------------

def test_burst_loop_with_tuning_on_4_shards():
    """LOW-S / MOD-S bursts through ``execute_batch(use_kernel=True)``
    and ``execute``, UPDATE / INSERT / scan, one tuning cycle per
    burst: the
    port at 4 shards against the reference at 1 shard (its own
    shard-invariance contract) -- every stats field, the clock, the
    monitor, the tables and the tuner's decisions."""
    rdb, pdb = _db_pair(4)
    cfg = dict(storage_budget_bytes=200e3, pages_per_cycle=4,
               max_build_pages_per_cycle=4)
    rtun = R.PredictiveTuner(rdb, R.TunerConfig(**cfg))
    ptun = P.PredictiveTuner(pdb, P.TunerConfig(**cfg))
    gen = R.QueryGen(SRC, selectivity=0.01, seed=17)
    kernel_hybrid = 0
    for burst in range(8):
        scans = [gen.low_s(attr=1 + burst % 3) for _ in range(5)] + [
            gen.mod_s() for _ in range(2)]
        kernel_hybrid += sum(
            pdb.planner.plan_scan(_port_query(q)).path == "hybrid"
            for q in scans)
        ref = [rdb.execute(q) for q in scans]
        got = pdb.execute_batch([_port_query(q) for q in scans],
                                use_kernel=True)
        assert [_stats(a) for a in ref] == [_stats(b) for b in got]
        # Narrow updates (row-id ranges): the run stays far from the
        # capacity, where the reference's parked writes lose rows.
        lo = 1 + 300 * burst
        muts = [R.Query(kind="update", table="narrow", attrs=(0,),
                        los=(lo,), his=(lo + 15,), set_attrs=(1,),
                        set_vals=(500_000 + burst,), template="upd"),
                gen.ins(n=6), gen.low_s(attr=1)]
        ref = [rdb.execute(q) for q in muts]
        got = [pdb.execute(_port_query(q)) for q in muts]
        assert [_stats(a) for a in ref] == [_stats(b) for b in got]
        assert rdb.clock_ms == pdb.clock_ms
        rp, pp = rtun.decide(), ptun.decide()
        assert [(q.index_name, q.pages, q.shard, q.utility)
                for q in rp.quanta] == [
            (q.index_name, q.pages, q.shard, q.utility) for q in pp.quanta]
        assert rtun.forecasts == ptun.forecasts
        rw = sum(R_bs.apply_quantum(rdb, q) for q in rp.quanta)
        pw = sum(P_bs.apply_quantum(pdb, q) for q in pp.quanta)
        assert rw == pw
        assert sorted(rdb.indexes) == sorted(pdb.indexes)
        for name, rb in rdb.indexes.items():
            pb = pdb.indexes[name]
            assert (rb.vap.built_pages, rb.vap.n_entries) == (
                pb.vap.built_pages, pb.vap.n_entries)
    assert [dataclasses.astuple(r) for r in rdb.monitor.records] == [
        dataclasses.astuple(r) for r in pdb.monitor.records]
    _assert_table_equal(rdb.tables["narrow"],
                        P_tb.unshard_table(pdb.tables["narrow"]))
    assert kernel_hybrid > 0


def test_shard_aware_tuning_and_faults_still_raise():
    """Shard-aware tuning is ported (tests/test_torch_shard_tuning.py):
    a scan on 4 shards reports its per-shard pages and a cycle runs.
    Fault injection still raises."""
    pdb = P.Database(_port_tables(SRC.tables), num_shards=4)
    pdb.shard_aware_tuning = True
    got = pdb.execute_batch([_port_query(_scan(1, 1000))])[0]
    assert len(got.shard_pages) == 4 and sum(got.shard_pages) > 0
    P.PredictiveTuner(pdb).decide()
    pdb.shard_aware_tuning = False
    pdb.fault_injector = object()
    with pytest.raises(NotImplementedError):
        pdb.execute(_port_query(_scan(1, 1000)))
