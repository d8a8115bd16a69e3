"""Parity of the port's value-based partial (VBP) indexes with the
reference.

``vbp_populate_subdomain`` and its sharded form state for state
(entries, tails included, covering intervals, ``n_cov`` and the
``in_index`` bitmap), among them overlapping populations, more than 64
intervals, ``max_add`` below the wanted rows and populations that want
nothing; the planner's ``IntervalUnion``; ``pure_vbp`` scans, single
and batched, on 1, 2 and 4 shards through the ``Database``; and
``convert.vbp_from_reference``.  Tolerance 0: every int32 array,
count, cost and clock field is compared for equality.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import repro.api as R
from benchmarks.shard_tuning import make_skewed_db
from repro.core import index as R_ix
from repro.core import planner as R_pl
from repro.core import table as R_tb
from repro_torch import api as P
from repro_torch.core import hybrid_scan as P_hs
from repro_torch.core import index as P_ix
from repro_torch.core import planner as P_pl
from repro_torch.core import table as P_tb
from repro_torch.core.convert import from_reference, vbp_from_reference
from repro_torch.core.executor import Query as PQuery

PSZ = 64
SRC = R.make_tuner_db(n_rows=600, page_size=PSZ)
STAT_FIELDS = ("cost_units", "latency_ms", "used_index", "agg_sum", "count",
               "rows_modified", "populate_units", "shard_pages")


def _np(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def _fields(x):
    """A reference record as the nested numpy fields ``from_reference``
    takes (tables, indexes and VBP states, plain or sharded)."""
    if isinstance(x, R_tb.ShardedTable):
        return ([_fields(t) for t in x.shards], np.asarray(x.n_rows))
    if isinstance(x, R_ix.ShardedVbpState):
        return [([_fields(ix) for ix in x.shards],)] + [
            np.asarray(f) for f in x[1:]]
    if isinstance(x, R_ix.VbpState):
        return [_fields(x.index)] + [np.asarray(f) for f in x[1:]]
    return [np.asarray(f) for f in x]


def _port_table(rt):
    return from_reference(tables={"t": _fields(rt)}, device="cpu")[0]["t"]


def _port_tables(tables):
    return from_reference(
        tables={k: _fields(t) for k, t in tables.items()}, device="cpu")[0]


def _port_query(q):
    return PQuery(**{f.name: getattr(q, f.name)
                     for f in dataclasses.fields(q)})


def assert_vbp_equal(ref, port):
    """Entries (whole arrays, tails included, per shard when sharded),
    watermarks, covering intervals, n_cov and in_index."""
    if isinstance(ref, R_ix.ShardedVbpState):
        assert isinstance(port, P_ix.ShardedVbpState)
        pairs = zip(ref.shards, port.index.shards)
    else:
        assert isinstance(port, P_ix.VbpState)
        pairs = [(ref.index, port.index)]
    for r, p in pairs:
        for name in ("key_hi", "key_lo", "rids"):
            np.testing.assert_array_equal(_np(getattr(p, name)),
                                          _np(getattr(r, name)),
                                          err_msg=name)
        assert (p.n_entries, p.built_pages) == (int(r.n_entries),
                                                int(r.built_pages))
    for name in ("cov_lo_hi", "cov_lo_lo", "cov_hi_hi", "cov_hi_lo",
                 "in_index"):
        np.testing.assert_array_equal(_np(getattr(port, name)),
                                      _np(getattr(ref, name)), err_msg=name)
    assert port.n_cov == int(ref.n_cov)
    assert P_ix.vbp_n_entries(port) == int(R_ix.vbp_n_entries(ref))


def _vals(seed, n=300, n_attrs=4, vmax=100):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vmax, size=(n, n_attrs)).astype(np.int32)


# Population scripts: (key_attrs, [(lo, hi, max_add or None), ...]) with
# 1-attribute bounds (lo, hi) or 2-attribute ((lo0, lo1), (hi0, hi1));
# None means the table's capacity (the baselines' budget).  "insert"
# appends rows and drops the coverage claims, as the executor does.
SCRIPTS = {
    # test_core_components.py::test_vbp_overlapping_populates_never_duplicate
    "overlapping": ((1,), [(10, 40, None), (30, 60, None), (0, 50, None),
                           (45, 80, None)]),
    "max_add_below_n_want": ((1,), [(0, 60, 25), (0, 60, 25), (0, 60, 300),
                                    (20, 30, 7), (50, 99, 9)]),
    "n_want_zero": ((1,), [(200, 300, None), (10, 20, None), (10, 20, None),
                           (12, 18, None), "insert", (10, 20, None),
                           (5, 5, None)]),
    "more_than_64_intervals": ((1,), [(i, i, None) for i in range(70)]
                               + [(3, 3, None), (68, 68, None)]),
    "two_attrs": ((1, 2), [((10, 0), (40, 99), None),
                           ((20, 50), (20, 60), None),
                           ((30, 10), (35, 20), 3),
                           ((0, -(2**31) + 1), (99, 2**31 - 2), None)]),
}


def _run_script(name, rt, pt, populate_ref, populate_port, make_ref,
                make_port, insert_ref, insert_port):
    key_attrs, steps = SCRIPTS[name]
    rv, pv = make_ref(rt), make_port(pt)
    assert_vbp_equal(rv, pv)
    rng = np.random.default_rng(5)
    for step in steps:
        if step == "insert":
            rows = rng.integers(0, 100, size=(9, rt.n_attrs)).astype(np.int32)
            rt, pt = insert_ref(rt, rows), insert_port(pt, rows)
            rv = R_ix.vbp_invalidate_coverage(rv)
            pv = P_ix.vbp_invalidate_coverage(pv)
            continue
        lo, hi, max_add = step
        if len(key_attrs) == 1:
            lo, hi = P_ix.key_range(lo, hi)
        max_add = rt.capacity if max_add is None else max_add
        rv, rn = populate_ref(rv, rt, key_attrs, lo, hi, 0, max_add=max_add)
        pv, pn = populate_port(pv, pt, key_attrs, lo, hi, 0, max_add=max_add)
        assert pn == int(rn), step
        assert_vbp_equal(rv, pv)
        assert P_ix.vbp_is_covered(pv, lo, hi) == bool(
            R_ix.vbp_is_covered(rv, lo, hi))
    return rt, rv, pt, pv


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_vbp_populate_matches_reference(name):
    vals = _vals(3)
    rt = R_tb.load_table(vals, page_size=8, n_pages=40)
    pt = _port_table(rt)
    rt, rv, pt, pv = _run_script(
        name, rt, pt, R_ix.vbp_populate_subdomain,
        P_ix.vbp_populate_subdomain,
        lambda t: R_ix.make_vbp(t.capacity),
        lambda t: P_ix.make_vbp(t.capacity, "cpu"),
        lambda t, rows: R_tb.insert_rows(t, jnp.asarray(rows), 1, len(rows),
                                         max_new=len(rows)),
        lambda t, rows: P_tb.insert_rows(t, rows, 1, len(rows)))
    if name == "overlapping":
        # The oracle's check: every covered sub-domain answers from the
        # index alone, each row once.
        for lo, hi, _ in SCRIPTS[name][1]:
            r = P_hs.pure_index_scan(pt, pv.index, (1,), (1,), (lo,), (hi,),
                                     0, 2)
            assert int(r.contrib.max()) <= 1
            m = (vals[:, 1] >= lo) & (vals[:, 1] <= hi)
            assert int(r.count) == int(m.sum())


def _sharded_insert(kind):
    def ref(t, rows):
        return R_tb.sharded_insert_rows(t, jnp.asarray(rows), 1, len(rows),
                                        max_new=len(rows))

    def port(t, rows):
        return P_tb.sharded_insert_rows(t, rows, 1, len(rows))

    return ref if kind == "ref" else port


@pytest.mark.parametrize("name", sorted(SCRIPTS))
@pytest.mark.parametrize("S", [2, 4])
def test_sharded_vbp_populate_matches_reference(name, S):
    """Per-shard entries against the reference's sharded population;
    the global metadata (intervals, in_index) also equals the
    single-table population's."""
    vals = _vals(3)
    base = R_tb.load_table(vals, page_size=8, n_pages=40)
    rt = R_tb.shard_table(base, S)
    pt = _port_table(rt)
    _, rv, _, pv = _run_script(
        name, rt, pt, R_ix.sharded_vbp_populate_subdomain,
        P_ix.sharded_vbp_populate_subdomain, R_ix.make_sharded_vbp,
        P_ix.make_sharded_vbp, _sharded_insert("ref"), _sharded_insert("port"))
    if "insert" not in SCRIPTS[name][1]:
        _, single, _, _ = _run_script(
            name, base, _port_table(base), R_ix.vbp_populate_subdomain,
            P_ix.vbp_populate_subdomain,
            lambda t: R_ix.make_vbp(t.capacity),
            lambda t: P_ix.make_vbp(t.capacity, "cpu"), None, None)
        np.testing.assert_array_equal(pv.in_index.numpy(),
                                      np.asarray(single.in_index))
        assert pv.n_entries == int(single.index.n_entries)


def test_sharded_vbp_on_skewed_layout_matches_reference():
    """A layout that is not round-robin (36/4/4/4): slots whose global
    rid lies past the capacity are not selectable, as in the
    reference."""
    rst = make_skewed_db().tables["narrow"]
    pst = _port_table(rst)
    rv, pv = R_ix.make_sharded_vbp(rst), P_ix.make_sharded_vbp(pst)
    for lo, hi, max_add in ((100_000, 400_000, rst.capacity),
                            (1, 1_000_000, 500), (1, 1_000_000, rst.capacity)):
        klo, khi = P_ix.key_range(lo, hi)
        rv, rn = R_ix.sharded_vbp_populate_subdomain(rv, rst, (1,), klo, khi,
                                                     0, max_add=max_add)
        pv, pn = P_ix.sharded_vbp_populate_subdomain(pv, pst, (1,), klo, khi,
                                                     0, max_add=max_add)
        assert pn == int(rn)
        assert_vbp_equal(rv, pv)


def test_interval_union_matches_reference():
    rng = np.random.default_rng(0)
    ru, pu = R_pl.IntervalUnion(), P_pl.IntervalUnion()
    for _ in range(60):
        a, b = sorted(int(x) for x in rng.integers(0, 200, 2))
        c, d = (int(x) for x in rng.integers(-3, 3, 2))
        ru.add((a, c), (b, d))
        pu.add((a, c), (b, d))
        assert pu.ivs == ru.ivs
        for _ in range(5):
            x, y = sorted(int(v) for v in rng.integers(0, 200, 2))
            e = int(rng.integers(-3, 3))
            assert pu.covers((x, e), (y, e)) == ru.covers((x, e), (y, e))
    pu.clear()
    assert pu.ivs == [] and not pu.covers((0, 0), (0, 0))


def _stats(s):
    return tuple(getattr(s, f) for f in STAT_FIELDS)


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_pure_vbp_scans_match_reference(S, use_kernel):
    """The ports of ``test_batch_exec.py::test_batch_vbp_covered_subdomain``
    and ``test_sharded_engine.py::test_shard_invariance_vbp_covered``: a
    VBP index populated for one sub-domain serves the burst through the
    batched pure index scan, and single queries through the
    single-query one; every stats field, the clock and the monitor
    equal the reference's 1-shard database (the kernel path's table
    groups run their plain versions on the CPU)."""
    gen = R.QueryGen(SRC, selectivity=0.01, seed=11)
    queries = [gen.low_s(attr=1, pos=0.3) for _ in range(8)] + [
        gen.low_s(attr=1, pos=0.6) for _ in range(2)]
    cap = SRC.tables["narrow"].capacity

    rdb = R.Database(dict(SRC.tables))
    rbi = rdb.create_index(R.IndexDescriptor("narrow", (1,)), "vbp")
    r_pop = rdb.vbp_populate(rbi, queries[0], max_add=cap)
    ref = rdb.execute_batch(queries) + [rdb.execute(q) for q in queries]

    pdb = P.Database(_port_tables(SRC.tables), num_shards=S)
    pbi = pdb.create_index(P.IndexDescriptor("narrow", (1,)), "vbp")
    assert isinstance(pbi.vbp, P_ix.ShardedVbpState if S > 1
                      else P_ix.VbpState)
    p_pop = pdb.vbp_populate(pbi, _port_query(queries[0]), max_add=cap)
    assert p_pop == r_pop
    pq = [_port_query(q) for q in queries]
    got = pdb.execute_batch(pq, use_kernel=use_kernel) + [
        pdb.execute(q) for q in pq]
    assert [_stats(s) for s in got] == [_stats(s) for s in ref]
    assert sum(s.used_index for s in got) == 16  # the covered sub-domain
    assert pdb.clock_ms == rdb.clock_ms
    assert [dataclasses.astuple(r) for r in pdb.monitor.records] == [
        dataclasses.astuple(r) for r in rdb.monitor.records]
    plan = pdb.planner.plan_scan(pq[0])
    assert plan.path == "pure_vbp"
    assert isinstance(plan.index_state, P_ix.ShardedIndex if S > 1
                      else P_ix.AdHocIndex)
    assert pbi.size_bytes() == rbi.size_bytes()
    assert pbi.built_fraction(pdb.tables["narrow"]) == rbi.built_fraction(
        rdb.tables["narrow"])
    # An INSERT drops the coverage claims: the sub-domain plans a table
    # scan again in both packages.
    ins = gen.ins(n=4)
    rdb.execute(ins)
    pdb.execute(_port_query(ins))
    assert pbi.vbp.n_cov == 0 and pbi.cov_union.ivs == []
    assert pdb.planner.plan_scan(pq[0]).path == rdb.planner.plan_scan(
        queries[0]).path == "table"


@pytest.mark.parametrize("S", [1, 4])
def test_vbp_from_reference(S):
    """A reference VBP state carried across equals the port's own
    population, and both packages go on populating it alike."""
    rt = SRC.tables["narrow"]
    if S > 1:
        rt = R_tb.shard_table(rt, S)
    make = (R_ix.make_sharded_vbp if S > 1
            else lambda t: R_ix.make_vbp(t.capacity))
    populate_r = (R_ix.sharded_vbp_populate_subdomain if S > 1
                  else R_ix.vbp_populate_subdomain)
    populate_p = (P_ix.sharded_vbp_populate_subdomain if S > 1
                  else P_ix.vbp_populate_subdomain)
    pt = _port_table(rt)
    rv = make(rt)
    for lo, hi in ((100_000, 300_000), (250_000, 600_000)):
        rv, _ = populate_r(rv, rt, (1,), *P_ix.key_range(lo, hi), 0,
                           max_add=rt.capacity)
    pv = vbp_from_reference(_fields(rv), device="cpu")
    assert_vbp_equal(rv, pv)
    via = from_reference(indexes={"v": _fields(rv)}, device="cpu")[1]["v"]
    assert_vbp_equal(rv, via)
    for lo, hi, max_add in ((50_000, 700_000, 40), (1, 1_000_000, 700)):
        klo, khi = P_ix.key_range(lo, hi)
        rv, rn = populate_r(rv, rt, (1,), klo, khi, 0, max_add=max_add)
        pv, pn = populate_p(pv, pt, (1,), klo, khi, 0, max_add=max_add)
        assert pn == int(rn)
        assert_vbp_equal(rv, pv)
