"""Parity of the port's HIGH-S equi-joins with the reference.

``Database._exec_join`` on 1, 2 and 4 shards against the reference's
1-shard database (the reference's own ``test_shard_invariance_joins``
contract), with and without an index on the inner join attribute;
``test_tuner_system.py::test_join_queries_drive_inner_index`` in both
packages; whole ``run_workload`` runs of ``affinity_workload(
template="high_s")``; and the per-shard contrib planes of every
sharded single-query family (the join's outer rows) against the
reference's ``ShardScanResult.contribs``, on round-robin and skewed
layouts.  Tolerance 0: pair counts, costs, the clock and the monitor
window (the inner-table ``:join`` records included) are compared for
equality.
"""

import _torch_threads  # noqa: F401  (first: pins torch's threads)

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

import repro.api as R
from benchmarks.shard_tuning import make_skewed_db
from repro.core import engine as R_eng
from repro.core import index as R_ix
from repro.core import planner as R_pl
from repro_torch import api as P
from repro_torch.core import engine as P_eng
from repro_torch.core import index as P_ix
from repro_torch.core import planner as P_pl
from repro_torch.core.convert import from_reference
from repro_torch.core.executor import Query as PQuery

SRC = R.make_tuner_db(n_rows=3_000, page_size=128)
STAT_FIELDS = ("cost_units", "latency_ms", "used_index", "agg_sum", "count",
               "rows_modified", "populate_units", "shard_pages")
EXEMPT = ("wall_s", "execution_tiers")


def _fields(x):
    if hasattr(x, "shards"):
        if hasattr(x, "n_rows"):
            return ([_fields(t) for t in x.shards], np.asarray(x.n_rows))
        return ([_fields(ix) for ix in x.shards],)
    return [np.asarray(f) for f in x]


def _port_tables(tables):
    return from_reference(
        tables={k: _fields(t) for k, t in tables.items()}, device="cpu")[0]


def _port_index(ri):
    return from_reference(indexes={"i": _fields(ri)}, device="cpu")[1]["i"]


def _port_query(q):
    return PQuery(**{f.name: getattr(q, f.name)
                     for f in dataclasses.fields(q)})


def _stats(s):
    return tuple(getattr(s, f) for f in STAT_FIELDS)


def _records(db):
    return [dataclasses.astuple(r) for r in db.monitor.records]


def _statements(seed=13):
    """HIGH-S joins (the join attribute 4 of the narrow table against
    itself), a plain scan, an UPDATE and an INSERT between them."""
    gen = R.QueryGen(SRC, selectivity=0.01, seed=seed)
    out = [gen.high_s() for _ in range(4)]
    out += [gen.low_s(attr=4), gen.low_u(attr=4), gen.high_s(pos=0.2),
            gen.ins(n=12), gen.high_s(attrs=(2, 3)),
            gen.high_s(pos=0.5, join_attr=3, join_inner_attr=4)]
    return out


@pytest.mark.parametrize("inner_index", [None, "vap", "full", "vbp"])
@pytest.mark.parametrize("S", [1, 2, 4])
def test_high_s_joins_match_reference(S, inner_index):
    """The port of ``test_sharded_engine.py::test_shard_invariance_joins``
    against the reference's 1-shard database: only a VAP or FULL index
    leading with the inner join attribute turns the hash join into an
    index nested loop (a VBP index does not)."""
    queries = _statements()
    rdb = R.Database(dict(SRC.tables))
    pdb = P.Database(_port_tables(SRC.tables), num_shards=S)
    if inner_index is not None:
        rbi = rdb.create_index(R.IndexDescriptor("narrow", (4,)), inner_index)
        pbi = pdb.create_index(P.IndexDescriptor("narrow", (4,)), inner_index)
        if inner_index == "vbp":
            cap = SRC.tables["narrow"].capacity
            rdb.vbp_populate(rbi, queries[4], max_add=cap)
            pdb.vbp_populate(pbi, _port_query(queries[4]), max_add=cap)
        else:
            pages = 7 if inner_index == "vap" else 40
            rdb.vap_build_step(rbi, pages)
            pdb.vap_build_step(pbi, pages)
    ref = [rdb.execute(q) for q in queries]
    got = [pdb.execute(_port_query(q)) for q in queries]
    assert [_stats(s) for s in got] == [_stats(s) for s in ref]
    joins = [s for s, q in zip(got, queries) if q.join_table is not None]
    assert all(s.count > 0 for s in joins)
    assert any(s.used_index for s in joins) == (inner_index in ("vap",
                                                                "full"))
    assert pdb.clock_ms == rdb.clock_ms
    assert _records(pdb) == _records(rdb)
    assert sum(r.template.endswith(":join") for r in pdb.monitor.records) \
        == len(joins)


def test_joins_flush_read_bursts_like_the_reference():
    """``execute_batch`` sends a join to ``execute``: the scans around it
    form bursts of their own."""
    gen = R.QueryGen(SRC, selectivity=0.01, seed=5)
    queries = [gen.low_s(attr=1), gen.low_s(attr=1), gen.high_s(),
               gen.low_s(attr=1), gen.high_s(pos=0.4), gen.low_s(attr=4)]
    rdb = R.Database(dict(SRC.tables))
    ref = rdb.execute_batch(queries)
    for S, use_kernel in ((1, True), (4, False), (4, True)):
        pdb = P.Database(_port_tables(SRC.tables), num_shards=S)
        got = pdb.execute_batch([_port_query(q) for q in queries],
                                use_kernel=use_kernel)
        assert [_stats(s) for s in got] == [_stats(s) for s in ref]
        assert _records(pdb) == _records(rdb)


@pytest.mark.parametrize("S", [1, 4])
def test_join_queries_drive_inner_index(S):
    """``test_tuner_system.py::test_join_queries_drive_inner_index`` in
    both packages: the join's inner-table records lead the predictive
    tuner to an index on the join attribute 4; every statement, cycle
    and index build state equals the reference's 1-shard run."""
    cfg = dict(storage_budget_bytes=1e8, candidate_min_count=2,
               pages_per_cycle=64, max_build_pages_per_cycle=128)
    rdb = R.Database(dict(SRC.tables))
    pdb = P.Database(_port_tables(SRC.tables), num_shards=S)
    rt = R.PredictiveTuner(rdb, R.TunerConfig(**cfg))
    pt = P.PredictiveTuner(pdb, P.TunerConfig(**cfg))
    gen = R.QueryGen(SRC, selectivity=0.01, seed=11)
    for i in range(30):
        q = gen.high_s()
        a, b = rdb.execute(q), pdb.execute(_port_query(q))
        assert _stats(b) == _stats(a), i
        if i % 5 == 4:
            assert pt.tuning_cycle() == rt.tuning_cycle()
    assert any(b.desc.key_attrs[0] == 4 for b in pdb.indexes.values())
    assert sorted(pdb.indexes) == sorted(rdb.indexes)
    for name, rb in rdb.indexes.items():
        pb = pdb.indexes[name]
        assert pb.vap.built_pages == int(rb.vap.built_pages)
        assert (pb.complete, pb.building) == (rb.complete, rb.building)
    assert pdb.clock_ms == rdb.clock_ms
    assert _records(pdb) == _records(rdb)


def _cfg(pkg, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return pkg.RunConfig(**kw)


@pytest.mark.parametrize("S,batch", [(1, 1), (1, 6), (2, 6), (4, 1)])
def test_high_s_workload_run_matches_reference(S, batch):
    """A whole closed-loop run of ``affinity_workload(template=
    "high_s")`` under the predictive tuner: every RunResult field but
    wall_s / execution_tiers equals the reference's 1-shard run."""
    out = []
    for pkg, src in ((R, SRC), (P, P.TunerDB(
            tables=_port_tables(SRC.tables), quantiles=SRC.quantiles,
            n_rows=SRC.n_rows, rng=None))):
        gen = pkg.QueryGen(src, selectivity=0.01, seed=21)
        wl = pkg.affinity_workload(gen, total=60, phase_len=30,
                                   template="high_s")
        db = pkg.Database(dict(src.tables))
        tuner = pkg.PredictiveTuner(db, pkg.TunerConfig(
            storage_budget_bytes=1e8, candidate_min_count=2,
            pages_per_cycle=8, max_build_pages_per_cycle=16))
        res = pkg.run_workload(db, tuner, wl, _cfg(
            pkg, tuning_interval_ms=0.5, read_batch_size=batch,
            num_shards=S if pkg is P else 1, use_kernel=pkg is P))
        out += [res, db]
    ref, rdb, got, pdb = out
    for f in dataclasses.fields(ref):
        if f.name not in EXEMPT:
            assert getattr(got, f.name) == getattr(ref, f.name), f.name
    assert pdb.clock_ms == rdb.clock_ms
    assert _records(pdb) == _records(rdb)
    assert sorted(pdb.indexes) == sorted(rdb.indexes)
    assert any(b.desc.key_attrs[0] == 4 for b in pdb.indexes.values())


def _sharded_state(layout):
    """Reference database on sharded storage with a VAP index on attr 1
    (global and per-shard builds) and a VBP index on attr 2 (one
    populated sub-domain); returns (rdb, port table, port VAP index,
    port VBP entries)."""
    if layout == "skewed":
        rdb = R.Database(dict(make_skewed_db().tables))
    else:
        rdb = R.Database(dict(SRC.tables), num_shards=layout)
    vap = rdb.create_index(R.IndexDescriptor("narrow", (1,)), "vap")
    rdb.vap_build_step(vap, pages=5)
    rdb.vap_build_step(vap, pages=2, shard=1)
    vbp = rdb.create_index(R.IndexDescriptor("narrow", (2,)), "vbp")
    q = R.Query(kind="scan", table="narrow", attrs=(2,), los=(200_000,),
                his=(450_000,), agg_attr=3)
    rdb.vbp_populate(vbp, q, max_add=rdb.tables["narrow"].capacity)
    rst = rdb.tables["narrow"]
    return rdb, vap, vbp, _port_tables({"narrow": rst})["narrow"]


@pytest.mark.parametrize("layout", [2, 4, "skewed"])
def test_sharded_contrib_planes_match_reference(layout):
    """Every sharded single-query family -- table, hybrid, hybrid_ps,
    hybrid_masked, pure_vap and pure_vbp -- returns the reference's
    per-shard contrib planes and scalars."""
    rdb, rvap, rvbp, pst = _sharded_state(layout)
    rst = rdb.tables["narrow"]
    pvap_state = _port_index(rvap.vap)
    pvbp_state = from_reference(indexes={"v": [
        ([_fields(ix) for ix in rvbp.vbp.shards],)] + [
        np.asarray(f) for f in rvbp.vbp[1:]]}, device="cpu")[1]["v"]
    S = len(rst.shards)
    max_pages = max(t.n_pages for t in rst.shards)
    rcov = R_ix.PageCoverage(S * max_pages, rst.page_size)
    pcov = P_ix.PageCoverage(S * max_pages, rst.page_size, "cpu")
    pages = P_ix.eligible_global_pages(pst)[1::3]
    for c in (rcov, pcov):
        c.set_pages(pages)
    rview, pview = rcov.view(S, max_pages), pcov.view(S, max_pages)
    cases = [("table", (1,), None, None, None),
             ("hybrid", (1,), rvap, rvap.vap, pvap_state),
             ("hybrid_ps", (1,), rvap, rvap.vap, pvap_state),
             ("hybrid_masked", (1,), rvap, rvap.vap, pvap_state),
             ("pure_vap", (1,), rvap, rvap.vap, pvap_state),
             ("pure_vbp", (2,), rvbp, R_pl._engine_state(
                 "pure_vbp", None, rvbp.vbp), pvbp_state.index)]
    pbis = {}
    for path, attrs, rbi, rstate, pstate in cases:
        if layout == "skewed" and path in ("hybrid", "hybrid_masked"):
            continue  # planned only on round-robin layouts
        pbi = None
        if rbi is not None:
            pbi = pbis.setdefault(rbi.desc.name, P_pl.BuiltIndex(
                desc=P.IndexDescriptor("narrow", rbi.desc.key_attrs),
                scheme=rbi.scheme))
        rplan = R_pl.ScanPlan(path, rbi, pinned_state=rstate,
                              pinned_coverage=rview)
        pplan = P_pl.ScanPlan(path, pbi, pinned_state=pstate,
                              pinned_coverage=pview)
        for lo, width in ((210_000, 40_000), (300_000, 140_000)):
            ref = R_eng.ScanEngine().scan(rst, rplan, attrs,
                                          jnp.asarray([lo]),
                                          jnp.asarray([lo + width]), 7, 3)
            got = P_eng.ScanEngine().scan(pst, pplan, attrs, (lo,),
                                          (lo + width,), 7, 3, contribs=True)
            for f in got._fields:
                if f != "contribs":
                    assert int(getattr(got, f)) == int(getattr(ref, f)), (
                        path, f)
            for s, (lp, plane) in enumerate(zip(pst.local_pages,
                                                ref.contribs)):
                np.testing.assert_array_equal(got.contribs[s, :lp].numpy(),
                                              np.asarray(plane),
                                              err_msg=f"{path} shard {s}")
            assert int(got.contribs.sum()) == int(got.count) > 0, path
