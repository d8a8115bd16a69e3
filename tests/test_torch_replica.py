"""Parity of the port's replica tier (``repro_torch.core.replica``) with
the reference's (``repro.core.replica``).

The cases of tests/test_replica.py, each held against the reference on
the same numpy inputs: mirrored replicas equal the single engine in
every async mode; ``ReplicaSet.execute`` is a drop-in
``Database.execute``; a set refuses a database that has indexes;
routing replays across ``PYTHONHASHSEED`` values; ``cluster_assignments``
groups a window by attribute family; divergent catalogs differ while
results stay exact.  On top of those: whole divergent ``run_workload``
runs (read batch 1 / 6, kernel path off / on, 1 and 4 shards) against
the reference's; the in-place fan-out (the port's mutators write into
a table's tensors, so each replica owns a copy); and the router's
``estimate_scan_cost`` against the reference's on every access path,
with no side effect on the catalog.

Tolerance: none.  Every ``RunResult`` field but ``wall_s``,
``execution_tiers`` and ``build_pages_per_ms`` is equal, and so are
the clock, the monitor windows and every replica's index build state.
"""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

import repro.api as R
from repro.core import replica as R_rep
from repro_torch import api as P
from repro_torch.core import replica as P_rep
from repro_torch.core.cost_model import index_size_bytes
from test_torch_build_service import assert_same_run
from test_torch_runner import assert_same_db, port_src

N_ROWS = 4_000
SRC = R.make_tuner_db(n_rows=N_ROWS)
BUDGET = index_size_bytes(N_ROWS) * 1.25


def families_workload(pkg, dbt, total=90, tenants=3, seed=29,
                      update_every=9):
    """Interleaved per-tenant scans (tenant t probes attribute 1 + t),
    with an UPDATE every ``update_every`` statements."""
    gen = pkg.QueryGen(dbt, seed=seed)
    items = []
    for i in range(total):
        if update_every and i % update_every == update_every - 1:
            items.append((0, gen.low_u()))
        else:
            items.append((0, gen.low_s(attr=1 + (i % tenants))))
    return pkg.Workload(items, "tenant families")


def run_once(pkg, tsrc, n_replicas, divergent=False, async_tuning=None,
             total=90, update_every=9, batch=1, use_kernel=False,
             num_shards=1):
    """tests/test_replica.py's ``run_once`` in package ``pkg``; returns
    the result and the wrapped database (replica 0)."""
    db = pkg.Database(dict(tsrc.tables))
    tuner = pkg.PredictiveTuner(db, pkg.TunerConfig(
        storage_budget_bytes=BUDGET))
    cfg = pkg.RunConfig(
        execution=pkg.ExecOptions(read_batch_size=batch,
                                  num_shards=num_shards,
                                  use_kernel=use_kernel and pkg is P),
        tuning=pkg.TuningOptions(tuning_interval_ms=10.0,
                                 async_tuning=async_tuning),
        replica=pkg.ReplicaOptions(n_replicas=n_replicas,
                                   divergent_tuning=divergent))
    wl = families_workload(pkg, tsrc, total=total, update_every=update_every)
    return pkg.run_workload(db, tuner, wl, cfg), db


def run_pair(n_replicas, **kw):
    """The same run in both packages, asserted equal field for field;
    returns the port's result and database."""
    ref, rdb = run_once(R, SRC, n_replicas, **kw)
    port, pdb = run_once(P, port_src(SRC), n_replicas, **kw)
    assert port.build_escalations == ref.build_escalations == 0
    assert_same_run(ref, port)
    assert_same_db(rdb, pdb)
    return port, pdb


def fingerprint(res):
    return (res.latencies_ms, res.cumulative_ms, res.tuner_work_units,
            res.tuner_charged_ms, res.index_counts, res.built_fraction,
            res.results)


# ---------------------------------------------------------------------------
# Mirrored replicas are the single engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("async_tuning", [None, "deterministic", "overlap"])
def test_mirrored_replicas_equal_single_engine_and_reference(async_tuning):
    """1 and 3 mirrored replicas reproduce the single engine bit for bit
    (results and cost / clock accounting) in every async mode, the
    3-replica run equals the reference's, and the router's tie-break
    pins every burst to replica 0."""
    single, _ = run_pair(1, async_tuning=async_tuning)
    three, _ = run_pair(3, async_tuning=async_tuning)
    assert fingerprint(three) == fingerprint(single)
    for f in dataclasses.fields(P.RunResult):
        if f.name not in ("wall_s", "execution_tiers", "build_pages_per_ms",
                          "replica_routing"):
            assert getattr(three, f.name) == getattr(single, f.name), f.name
    assert set(three.replica_routing) == {0}
    assert single.replica_routing == []


def _query_mix(pkg, seed=5, n=36):
    gen = pkg.QueryGen(SRC if pkg is R else PORT_SRC, seed=seed)
    out = []
    for i in range(n):
        if i % 9 == 8:
            out.append(gen.ins(n=8))
        elif i % 5 == 4:
            out.append(gen.low_u())
        else:
            out.append(gen.low_s(attr=1 + (i % 3)))
    return out


PORT_SRC = port_src(SRC)


def _stats(s):
    return tuple(getattr(s, f) for f in (
        "cost_units", "latency_ms", "used_index", "agg_sum", "count",
        "rows_modified"))


def _records(db):
    return [dataclasses.astuple(r) for r in db.monitor.records]


def test_replicaset_execute_matches_database_and_reference():
    """Drop-in check at ``execute``: scans, UPDATEs and INSERTs through a
    3-replica set give the single engine's ExecStats and clock, every
    replica holds the same global monitor window, and the reference's
    set gives the same."""
    oracle = P.Database(dict(port_src(SRC).tables))
    rs = P.ReplicaSet(P.Database(dict(port_src(SRC).tables)), 3)
    ref = R.ReplicaSet(R.Database(dict(SRC.tables)), 3)
    for qo, qp, qr in zip(_query_mix(P), _query_mix(P), _query_mix(R)):
        so, sp, sr = oracle.execute(qo), rs.execute(qp), ref.execute(qr)
        assert _stats(sp) == _stats(so) == _stats(sr)
        assert sp.tier == so.tier
        assert rs.clock_ms == oracle.clock_ms == ref.clock_ms
    recs = _records(rs.dbs[0])
    assert recs == _records(oracle) == _records(ref.dbs[0])
    for d in rs.dbs[1:]:
        assert _records(d) == recs
    assert rs.routed_queries == ref.routed_queries
    assert rs.device == rs.dbs[0].device == torch.device("cpu")


def test_replicaset_rejects_existing_indexes():
    db = P.Database(dict(port_src(SRC).tables))
    db.create_index(P.IndexDescriptor("narrow", (1,)), scheme="vap")
    with pytest.raises(ValueError):
        P.ReplicaSet(db, 2)
    with pytest.raises(ValueError):
        P.ReplicaSet(P.Database(dict(port_src(SRC).tables)), 0)


# ---------------------------------------------------------------------------
# Storage: each replica owns its tensors
# ---------------------------------------------------------------------------

def _table_state(t):
    return (t.data, t.begin_ts, t.end_ts)


def _fan_out_statements(pkg_src, seed):
    """UPDATEs whose new versions match their own predicate (attribute 1
    set to the range's low end) and exceed the update cap, UPDATEs that
    move rows out of their range, and INSERTs, with scans between."""
    gen = P.QueryGen(pkg_src, seed=seed)
    lo, hi = gen._bounds(0.05, 0.4)
    out = []
    for i in range(24):
        k = i % 4
        if k == 0:
            out.append(P.Query(kind="update", table="narrow", attrs=(1,),
                               los=(lo,), his=(hi,), set_attrs=(1, 5),
                               set_vals=(lo, 1000 + i)))
        elif k == 1:
            out.append(gen.ins(n=8))
        elif k == 2:
            out.append(gen.low_u())
        else:
            out.append(gen.low_s(attr=1))
    return out


@pytest.mark.parametrize("num_shards", [1, 4])
def test_fan_out_writes_each_replicas_own_tensors(num_shards):
    """A 3-replica set takes UPDATEs that re-match their own new
    versions past the update cap, UPDATEs and INSERTs: every replica's
    tables stay bit-equal to a single engine's and answer its scans.
    Replicas sharing tensors would apply each write once per replica
    (the second application ends other rows and misplaces the
    watermark), so this fails on shared storage."""
    src = port_src(SRC)
    single = P.Database(dict(port_src(SRC).tables), num_shards=num_shards)
    db = P.Database(dict(src.tables), num_shards=num_shards)
    single.update_cap = db.update_cap = 16
    rs = P.ReplicaSet(db, 3)
    assert len({d.tables["narrow"].data.data_ptr() for d in rs.dbs}) == 3
    stmts = _fan_out_statements(src, seed=3)
    for qs, qr in zip(stmts, _fan_out_statements(src, seed=3)):
        assert _stats(rs.execute(qr)) == _stats(single.execute(qs))
    assert sum(q.kind == "update" for q in stmts) == 12
    want = single.tables["narrow"]
    for d in rs.dbs:
        t = d.tables["narrow"]
        assert t.n_rows == want.n_rows
        for a, b in zip(_table_state(t), _table_state(want)):
            assert torch.equal(a, b)
    probe = P.QueryGen(src, seed=11)
    for _ in range(6):
        q = probe.low_s(attr=1)
        want_s = single.execute(q, observe=False)
        for d in rs.dbs:
            got = d.execute(q, observe=False)
            assert (got.agg_sum, got.count) == (want_s.agg_sum, want_s.count)


# ---------------------------------------------------------------------------
# Determinism and clustering
# ---------------------------------------------------------------------------

_HASHSEED_SCRIPT = """
import warnings
warnings.simplefilter("ignore")
from repro_torch import api as P
from repro_torch.core.cost_model import index_size_bytes
src = P.make_tuner_db(n_rows=4000, device="cpu")
gen = P.QueryGen(src, seed=29)
wl = P.Workload([(0, gen.low_u() if i % 9 == 8 else gen.low_s(attr=1 + i % 3))
                 for i in range(90)], "families")
db = P.Database(dict(src.tables))
tuner = P.PredictiveTuner(db, P.TunerConfig(
    storage_budget_bytes=index_size_bytes(4000) * 1.25))
res = P.run_workload(db, tuner, wl, P.RunConfig(
    tuning=P.TuningOptions(tuning_interval_ms=10.0),
    replica=P.ReplicaOptions(n_replicas=3, divergent_tuning=True)))
print(res.replica_routing)
print([round(x, 9) for x in res.latencies_ms[-10:]])
print(res.index_counts[-1], round(res.cumulative_ms, 6))
"""


def test_divergent_routing_deterministic_across_hash_seeds():
    """Routing, catalogs and accounting replay bit for bit under
    different PYTHONHASHSEED values (the script imports only the
    port)."""
    outs = []
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    for seed in ("0", "1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=seed, PYTHONPATH=src)
        out = subprocess.run([sys.executable, "-c", _HASHSEED_SCRIPT],
                             capture_output=True, text=True, env=env,
                             check=True)
        outs.append(out.stdout)
    assert outs[0] == outs[1] == outs[2]
    assert len(set(eval(outs[0].splitlines()[0]))) > 1


def test_cluster_assignments_equal_reference_and_group_families():
    """A fixed window clusters repeatably and as the reference's does:
    one cluster per attribute family, mutations broadcast (-1)."""
    gen_r, gen_p = R.QueryGen(SRC, seed=3), P.QueryGen(PORT_SRC, seed=3)
    rdb = R.Database(dict(SRC.tables))
    pdb = P.Database(dict(port_src(SRC).tables))
    for i in range(30):
        for gen, db in ((gen_r, rdb), (gen_p, pdb)):
            db.execute(gen.low_u() if i % 10 == 9
                       else gen.low_s(attr=1 + (i % 3)))
    records = list(pdb.monitor.records)
    assign = P_rep.cluster_assignments(records, 3)
    assert assign == P_rep.cluster_assignments(records, 3)
    assert assign == R_rep.cluster_assignments(list(rdb.monitor.records), 3)
    for n in (1, 2, 5):
        assert P_rep.cluster_assignments(records, n) == \
            R_rep.cluster_assignments(list(rdb.monitor.records), n)
    assert [P_rep.candidate_signature(r) for r in records] == [
        R_rep.candidate_signature(r) for r in rdb.monitor.records]
    assert set(assign) == {-1, 0, 1, 2}
    by_family = {}
    for rec, a in zip(records, assign):
        if a >= 0:
            assert by_family.setdefault(tuple(rec.pred_attrs), a) == a
    assert len(set(by_family.values())) == 3


# ---------------------------------------------------------------------------
# Divergence
# ---------------------------------------------------------------------------

def _divergent_mix(pkg):
    gen = pkg.QueryGen(SRC if pkg is R else PORT_SRC, seed=29)
    return [gen.low_u() if i % 30 == 29 else gen.low_s(attr=1 + (i % 3))
            for i in range(90)]


def _built(rs):
    return [tuple(sorted((n, b.built_fraction(d.tables[b.desc.table]))
                         for n, b in d.indexes.items())) for d in rs.dbs]


def test_divergent_catalogs_differ_results_exact():
    """Divergent tuning specialises the catalogs (index sets and built
    pages differ per replica, each equal to the reference's replica)
    while every result stays the single engine's."""
    oracle = P.Database(dict(port_src(SRC).tables))
    rs = P.ReplicaSet(P.Database(dict(port_src(SRC).tables)), 3,
                      divergent=True)
    tuner = P.ReplicaSetTuner(rs, P.PredictiveTuner(rs.dbs[0], P.TunerConfig(
        storage_budget_bytes=BUDGET)))
    ref = R.ReplicaSet(R.Database(dict(SRC.tables)), 3, divergent=True)
    rtuner = R.ReplicaSetTuner(ref, R.PredictiveTuner(
        ref.dbs[0], R.TunerConfig(storage_budget_bytes=BUDGET)))
    for i, (qo, qp, qr) in enumerate(zip(_divergent_mix(P), _divergent_mix(P),
                                         _divergent_mix(R))):
        so, sp, sr = oracle.execute(qo), rs.execute(qp), ref.execute(qr)
        tuner.on_query(qp, sp)
        rtuner.on_query(qr, sr)
        assert (sp.agg_sum, sp.count, sp.rows_modified) == (
            so.agg_sum, so.count, so.rows_modified), i
        assert _stats(sp) == _stats(sr), i
        if i % 10 == 9:
            assert tuner.tuning_cycle() == rtuner.tuning_cycle()
    summary = P_rep.replica_index_summary(rs)
    assert summary == R_rep.replica_index_summary(ref)
    catalogs = [names for _, names in summary]
    assert all(catalogs), summary
    assert len({tuple(c) for c in catalogs}) > 1, summary
    pages = _built(rs)
    assert len(set(pages)) > 1 and pages == _built(ref)
    assert rs.routed_queries == ref.routed_queries
    assert sorted(set(rs.routed_queries)) == [0, 1, 2]
    for pd, rd in zip(rs.dbs, ref.dbs):
        assert _records(pd) == _records(rd)


@pytest.mark.parametrize("num_shards", [1, 4])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("batch", [1, 6])
def test_divergent_run_matches_reference(batch, use_kernel, num_shards):
    """A whole divergent ``run_workload`` held field for field against
    the reference's: routing, results, latencies and accounting."""
    port, _ = run_pair(3, divergent=True, batch=batch, use_kernel=use_kernel,
                       num_shards=num_shards)
    assert len(set(port.replica_routing)) > 1


# ---------------------------------------------------------------------------
# The router's what-if cost
# ---------------------------------------------------------------------------

def _probe_queries(pkg, tsrc):
    """Scans over every attribute family and selectivity, two-attribute
    scans and HIGH-S joins."""
    out = []
    for sel in (0.002, 0.01, 0.05, 0.3):
        gen = pkg.QueryGen(tsrc, selectivity=sel, seed=41)
        for attr in (1, 2, 3, 4):
            out.append(gen.low_s(attr=attr))
            out.append(gen.low_s(attr=attr, pos=0.9))
        out.append(gen.mod_s())
        out.append(gen.mod_s(attrs=(2, 1)))
        out.append(gen.high_s())
        out.append(gen.high_s(join_attr=1, join_inner_attr=1))
    return out


def _catalog_state(db):
    """Everything ``estimate_scan_cost`` must leave alone."""
    out = [db.clock_ms, len(db.monitor.records), sorted(db.indexes)]
    for name, bi in sorted(db.indexes.items()):
        out.append((name, bi.building, bi.complete, bi.last_used_ms,
                    id(bi.vap), id(bi.vbp)))
        cov = bi.coverage
        if cov is not None:
            out.append((cov.version, cov.built.tobytes(), len(cov._cache),
                        cov.max_entry_page))
    return out


def _cost_case(pkg, tsrc, case):
    """A database left in ``case``'s catalog state by a short run, and
    the run's scans (a VBP index covers the sub-domains it saw)."""
    from repro.core import baselines as R_bl
    from repro_torch.core import baselines as P_bl

    gen = pkg.QueryGen(tsrc, selectivity=0.01, seed=23)
    if case == "join":
        wl = pkg.affinity_workload(gen, total=60, phase_len=30,
                                   template="high_s")
    else:
        wl = pkg.hybrid_workload(
            gen, "read_only" if case in ("sharded", "vbp") else "read_heavy",
            total=72, phase_len=24, seed=2)
    db = pkg.Database(dict(tsrc.tables))
    bl = R_bl if pkg is R else P_bl
    tuner = {"vbp": lambda: bl.AdaptiveTuner(db),
             "full": lambda: bl.OnlineTuner(db)}.get(
        case, lambda: pkg.make_dl_tuner(db, "predictive"))()
    cfg = pkg.RunConfig(
        execution=pkg.ExecOptions(
            read_batch_size=6, num_shards=4 if case == "sharded" else 1),
        tuning=pkg.TuningOptions(
            tuning_interval_ms=2.0, crack_on_scan=case == "coverage",
            index_decay=case == "coverage",
            shard_aware_tuning=case == "sharded"))
    pkg.run_workload(db, tuner, wl, cfg)
    return db, [q for _, q in wl if q.kind == "scan"][-12:]


# case -> the access path at least one probe must plan
COST_CASES = {"plain": "hybrid", "coverage": "hybrid_masked",
              "vbp": "pure_vbp", "full": "pure_vap", "sharded": "hybrid_ps",
              "join": "hybrid"}


@pytest.mark.parametrize("case", list(COST_CASES))
def test_estimate_scan_cost_equals_reference_without_side_effects(case):
    """``estimate_scan_cost`` equals the reference's bit for bit on every
    access path (table, hybrid, masked, per-shard stitch, pure VBP,
    pure FULL, joins with and without an inner index) and leaves the
    catalog, the coverage bitmaps (no view pinned) and ``last_used_ms``
    untouched."""
    rdb, seen_r = _cost_case(R, SRC, case)
    psrc = port_src(SRC)
    pdb, seen_p = _cost_case(P, psrc, case)
    assert sorted(pdb.indexes) == sorted(rdb.indexes) and pdb.indexes
    probes_p = _probe_queries(P, psrc) + seen_p
    probes_r = _probe_queries(R, SRC) + seen_r
    before = _catalog_state(pdb)
    got = [pdb.planner.estimate_scan_cost(q) for q in probes_p]
    assert _catalog_state(pdb) == before
    want = [rdb.planner.estimate_scan_cost(q) for q in probes_r]
    assert got == want
    paths = {pdb.planner.plan_scan(q).path for q in probes_p}
    assert {"table", COST_CASES[case]} <= paths, paths
    if case == "join":
        assert any(q.join_table is not None for q in probes_p)
