"""Whole-run parity of the port's closed-loop runner with the reference.

``repro_torch.bench_db.runner.run_workload`` against
``repro.bench_db.runner.run_workload`` on the same numpy inputs: the
reference's TUNER state carried across with ``repro_torch.core.convert``,
and each package's own workload generators from the same seed.  Every
``RunResult`` field except ``wall_s`` and ``execution_tiers`` (which
tier served each query) must be equal, with no tolerance, and so must
the simulated clock, the monitor window and each index's build state.

The port's kernel path runs its plain versions on the CPU; the
reference runs its vmap tier, which it holds bit-equal to its kernel
tier.
"""

import _torch_threads  # noqa: F401  (first: pins torch's threads)

import dataclasses
import warnings

import numpy as np
import pytest

import repro.api as R
from repro.bench_db import runner as R_run
from repro.core import table as R_tb
from repro.core.baselines import DisabledTuner as RDisabledTuner
from repro_torch import api as P
from repro_torch.bench_db import runner as P_run
from repro_torch.core import index as P_ix
from repro_torch.core import table as P_tb
from repro_torch.core.convert import from_reference

SRC = R.make_tuner_db(n_rows=3_000, page_size=128)
EXEMPT = ("wall_s", "execution_tiers")


def port_src(src=SRC):
    """The reference's TUNER database as the port's, on the CPU (fresh
    tables: the port's mutators write in place)."""
    tables, _ = from_reference(
        tables={k: [np.asarray(x) for x in t] for k, t in src.tables.items()},
        device="cpu")
    return P.TunerDB(tables=tables, quantiles=src.quantiles,
                     n_rows=src.n_rows, rng=None)


def _cfg(pkg, **kw):
    """A RunConfig built from flat kwargs (the deprecation shim)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return pkg.RunConfig(**kw)


def _tuner(pkg, db, kind, config=None):
    if kind == "disabled":
        return (RDisabledTuner if pkg is R else P.DisabledTuner)(db)
    return pkg.make_dl_tuner(db, kind, None if config is None
                             else pkg.TunerConfig(**config))


def run_pair(make_workload, tuner="predictive", src=SRC, tuner_cfg=None,
             db_kw=None, use_kernel=False, **cfg):
    """One run in each package: (reference result, reference db, port
    result, port db).  The reference always runs its vmap tier; the
    port runs its kernel path when ``use_kernel``."""
    out = []
    for pkg, tsrc in ((R, src), (P, port_src(src))):
        wl = make_workload(pkg, tsrc)
        db = pkg.Database(dict(tsrc.tables), **(db_kw or {}))
        t = _tuner(pkg, db, tuner, tuner_cfg)
        res = pkg.run_workload(db, t, wl, _cfg(
            pkg, use_kernel=use_kernel and pkg is P, **cfg))
        out += [res, db]
    return tuple(out)


def hybrid(mixture, total=72, phase_len=24, seed=2, gen_seed=23):
    def make(pkg, src):
        gen = pkg.QueryGen(src, selectivity=0.01, seed=gen_seed)
        return pkg.hybrid_workload(gen, mixture, total=total,
                                   phase_len=phase_len, seed=seed)
    return make


def assert_same_result(ref, port):
    """Every RunResult field but the exempt ones, element by element."""
    for f in dataclasses.fields(R_run.RunResult):
        if f.name not in EXEMPT:
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.summary().keys() == ref.summary().keys()


def _unsharded(db, tb):
    t = db.tables["narrow"]
    return tb.unshard_table(t) if isinstance(t, tb.ShardedTable) else t


def lost_slots(rdb, pdb):
    """Global row slots the reference lost to a parked write (ROADMAP.md
    queue 3 item 1): its slot reads NEVER_TS where the port holds a
    real row.  Everywhere else the two tables are equal."""
    rt, pt = _unsharded(rdb, R_tb), _unsharded(pdb, P_tb)
    assert pt.n_rows == int(rt.n_rows)
    rb, pb = np.asarray(rt.begin_ts).reshape(-1), pt.begin_ts.numpy().reshape(
        -1)
    lost = np.flatnonzero((rb == R_tb.NEVER_TS) & (pb != P_tb.NEVER_TS))
    keep = np.ones(rb.size, bool)
    keep[lost] = False
    np.testing.assert_array_equal(pb[keep], rb[keep])
    np.testing.assert_array_equal(pt.end_ts.numpy().reshape(-1)[keep],
                                  np.asarray(rt.end_ts).reshape(-1)[keep])
    rows = pt.data.shape[-1]
    np.testing.assert_array_equal(pt.data.numpy().reshape(-1, rows)[keep],
                                  np.asarray(rt.data).reshape(-1, rows)[keep])
    return lost


def covered_pages(vap):
    """Global pages an index's built prefix covers (per shard for a
    round-robin ``ShardedIndex``)."""
    if isinstance(vap, P_ix.ShardedIndex):
        S = vap.n_shards
        return {s + S * k for s, b in enumerate(vap.shard_built)
                for k in range(b)}
    return set(range(vap.built_pages))


def assert_same_db(rdb, pdb):
    """Clock, monitor window, index build state and table equal; an
    index whose built pages hold a row the reference lost has one
    entry more per such row.  Returns the lost slots."""
    assert pdb.clock_ms == rdb.clock_ms
    assert [dataclasses.astuple(r) for r in pdb.monitor.records] == [
        dataclasses.astuple(r) for r in rdb.monitor.records]
    assert sorted(pdb.indexes) == sorted(rdb.indexes)
    lost = lost_slots(rdb, pdb)
    psz = pdb.tables["narrow"].page_size
    for name, rb in rdb.indexes.items():
        pb = pdb.indexes[name]
        pages = covered_pages(pb.vap)
        extra = sum(int(s) // psz in pages for s in lost)
        assert (pb.vap.built_pages, pb.vap.n_entries) == (
            int(rb.vap.built_pages), int(rb.vap.n_entries) + extra), name
        assert (pb.building, pb.complete) == (rb.building, rb.complete)
    assert pdb.pershard_built == rdb.pershard_built
    return lost


# ---------------------------------------------------------------------------
# Whole runs: mixture x read batch x kernel path x tuner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("batch", [1, 6])
@pytest.mark.parametrize("mixture", ["read_heavy", "write_heavy"])
@pytest.mark.parametrize("tuner", ["predictive", "disabled"])
def test_run_matches_reference(tuner, mixture, batch, use_kernel):
    ref, rdb, port, pdb = run_pair(hybrid(mixture), tuner,
                                   use_kernel=use_kernel,
                                   tuning_interval_ms=2.0,
                                   read_batch_size=batch)
    assert_same_result(ref, port)
    lost = assert_same_db(rdb, pdb)
    assert len(port.latencies_ms) == 72
    # Only write_heavy fills the table, up to the slot the reference
    # loses (test_write_heavy_run_keeps_the_row_the_reference_loses).
    assert lost.size == (mixture == "write_heavy")
    if tuner == "predictive":
        assert port.tuner_work_units > 0.0 and pdb.indexes
    else:
        assert port.tuner_work_units == 0.0 and not pdb.indexes
    n_scans = sum(1 for _, q in hybrid(mixture)(P, port_src()) if
                  q.kind == "scan")
    tier = "kernel" if use_kernel and batch > 1 else "single"
    assert port.execution_tiers == {tier: n_scans}


def test_write_heavy_run_keeps_the_row_the_reference_loses():
    """write_heavy's updates fill the 36-page table to its last slot.
    The reference parks masked-off writes on slot capacity - 1 and so
    overwrites the real row that lands there (ROADMAP.md queue 3 item
    1); the port keeps it.  No statement reads that row, so every
    RunResult field still agrees, but an index built over page 35
    holds one more entry in the port."""
    ref, rdb, port, pdb = run_pair(hybrid("write_heavy"),
                                   tuning_interval_ms=2.0)
    assert_same_result(ref, port)
    lost = assert_same_db(rdb, pdb)
    rt, pt = rdb.tables["narrow"], pdb.tables["narrow"]
    cap = pt.capacity
    assert lost.tolist() == [cap - 1] and pt.n_rows == cap
    assert int(np.asarray(rt.begin_ts)[35, 127]) == R_tb.NEVER_TS
    assert not np.asarray(rt.data)[35, 127].any()
    assert int(pt.begin_ts[35, 127]) != P_tb.NEVER_TS
    assert pt.data[35, 127].any()
    full = [n for n, b in pdb.indexes.items() if b.vap.built_pages == 36]
    assert full and all(
        pdb.indexes[n].vap.n_entries == int(rdb.indexes[n].vap.n_entries) + 1
        for n in full)


def test_fig6_decision_logics_match_reference():
    """make_dl_tuner's three decision logics on one fig6-shaped
    workload (benchmarks/fig6_decision_logic.py at a quick size):
    diurnal index drops, throttled phase starts whose idle credit
    absorbs tuning work, a time-horizoned monitor, 1% noise queries."""
    phase_len = 60

    def make(pkg, src):
        gen = pkg.QueryGen(src, selectivity=0.01)
        return pkg.affinity_workload(gen, total=180, phase_len=phase_len,
                                     n_subdomains=6, template="mod_s",
                                     noise_frac=0.01)

    cum = {}
    for dl in ("immediate", "retrospective", "predictive"):
        tcfg = dict(storage_budget_bytes=50e6, pages_per_cycle=4,
                    max_build_pages_per_cycle=12,
                    candidate_min_count=3 if dl != "immediate" else 1,
                    season_len=4)
        ref, rdb, port, pdb = run_pair(
            make, dl, tuner_cfg=tcfg, db_kw=dict(monitor_max_age_ms=60.0),
            tuning_interval_ms=2.0, idle_at_phase_start_ms=6.0,
            drop_indexes_at_phase_end=True, read_batch_size=4)
        assert_same_result(ref, port)
        assert_same_db(rdb, pdb)
        assert port.tuner_work_units > 0.0
        cum[dl] = port.cumulative_ms
    # k = 1 decides on other candidates than the window-based logics
    assert cum["immediate"] not in (cum["retrospective"], cum["predictive"])


def test_client_cadence_matches_reference():
    """A closed-loop client cadence (``arrival_ms``): a query faster
    than the cadence leaves an idle gap whose credit absorbs tuning
    work, so part of the cycle work is not charged."""
    ref, rdb, port, pdb = run_pair(hybrid("read_heavy"), arrival_ms=0.35,
                                   tuning_interval_ms=1.0)
    assert_same_result(ref, port)
    assert_same_db(rdb, pdb)
    assert 0.0 < port.tuner_charged_ms < (
        port.tuner_work_units * P.RunConfig().time_per_unit_ms)


# ---------------------------------------------------------------------------
# The reference's runner oracles, held to the reference as well
# ---------------------------------------------------------------------------

def test_runner_read_batch_matches_unbatched():
    """tests/test_batch_exec.py's oracle: with tuning disabled, the
    batched runner gives the per-query runner's latencies."""
    src = R.make_tuner_db(n_rows=4_000, page_size=128)
    make = hybrid("read_heavy", total=60, phase_len=30)
    out = {}
    for bs in (1, 16):
        ref, _, port, _ = run_pair(make, "disabled", src=src,
                                   tuning_interval_ms=None,
                                   read_batch_size=bs, use_kernel=True)
        assert_same_result(ref, port)
        out[bs] = port
    assert len(out[1].latencies_ms) == len(out[16].latencies_ms) == 60
    np.testing.assert_allclose(out[1].latencies_ms, out[16].latencies_ms,
                               rtol=0, atol=1e-12)
    assert out[1].phases == out[16].phases


def test_tuning_beats_disabled_on_stable_read_workload():
    """tests/test_tuner_system.py's oracle: predictive tuning beats DIS
    by more than 30% on a stable read workload."""
    src = R.make_tuner_db(n_rows=8_000, page_size=128)

    def make(pkg, tsrc):
        gen = pkg.QueryGen(tsrc, selectivity=0.01)
        return pkg.affinity_workload(gen, total=150, phase_len=150,
                                     n_subdomains=4, template="low_s")

    tcfg = dict(storage_budget_bytes=1e8, candidate_min_count=2,
                pages_per_cycle=32, max_build_pages_per_cycle=64)
    r_dis, _, p_dis, _ = run_pair(make, "disabled", src=src,
                                  tuning_interval_ms=25.0)
    r_pred, _, p_pred, _ = run_pair(make, "predictive", src=src,
                                    tuner_cfg=tcfg, tuning_interval_ms=25.0)
    assert_same_result(r_dis, p_dis)
    assert_same_result(r_pred, p_pred)
    assert p_pred.cumulative_ms < 0.7 * p_dis.cumulative_ms


# ---------------------------------------------------------------------------
# Options: an unknown async mode raises; the flat-kwarg shim
# ---------------------------------------------------------------------------

def test_unknown_async_mode_is_rejected():
    db = P.Database(dict(port_src().tables))
    with pytest.raises(ValueError):
        P.run_workload(db, P.DisabledTuner(db), hybrid("read_only")(
            P, port_src()), P.RunConfig(tuning=P.TuningOptions(
                async_tuning="eventually")))


def test_option_groups_and_flat_kwargs_match_reference():
    """The five groups carry the reference's fields and defaults; a flat
    kwarg warns and lands on its group, and flat attributes alias the
    group fields in both directions."""
    groups = ("ExecOptions", "TuningOptions", "ServingOptions",
              "ReplicaOptions", "FaultOptions")
    for name in groups:
        rf = {f.name: f.default for f in dataclasses.fields(
            getattr(R_run, name))}
        pf = {f.name: f.default for f in dataclasses.fields(
            getattr(P_run, name))}
        assert pf == rf, name
    assert P_run._FLAT_TO_GROUP == R_run._FLAT_TO_GROUP
    assert P.TUNING_FREQ_MS == R_run.TUNING_FREQ_MS
    assert P.RunConfig().time_per_unit_ms == R.RunConfig().time_per_unit_ms
    for name, group in P_run._FLAT_TO_GROUP.items():
        value = 7 if name != "fault_schedule" else object()
        with pytest.warns(DeprecationWarning, match=name):
            cfg = P.RunConfig(**{name: value})
        assert getattr(getattr(cfg, group), name) is value
        assert getattr(cfg, name) is value
        setattr(cfg, name, 3)
        assert getattr(getattr(cfg, group), name) == 3
    with pytest.raises(TypeError):
        P.RunConfig(not_an_option=1)


def test_summary_forms_and_percentiles():
    ref, _, port, _ = run_pair(hybrid("read_heavy"), tuning_interval_ms=2.0)
    a, b = port.summary(), ref.summary()
    assert {k: v for k, v in a.items() if k != "wall_s"} == {
        k: v for k, v in b.items() if k != "wall_s"}
    for p in (50, 99, 99.9):
        assert port.percentile(p) == ref.percentile(p)
    assert (port.mean_latency_ms, port.p99_latency_ms,
            port.p999_latency_ms) == (ref.mean_latency_ms,
                                      ref.p99_latency_ms,
                                      ref.p999_latency_ms)
    assert P.RunResult().percentile(99) == 0.0
    port.slo_report = ref.slo_report = object()
    assert port.summary().keys() == ref.summary().keys()


# ---------------------------------------------------------------------------
# The workload generators: the reference's query sequence from one seed
# ---------------------------------------------------------------------------

def _query_fields(q):
    return [(f.name, np.asarray(getattr(q, f.name)).tolist()
             if f.name == "rows" and q.rows is not None
             else getattr(q, f.name)) for f in dataclasses.fields(q)]


GENERATOR_CASES = [
    ("affinity_workload", dict(total=120, phase_len=40, n_subdomains=3)),
    ("affinity_workload", dict(total=90, phase_len=30, template="high_s",
                               noise_frac=0.3, seed=5)),
    ("affinity_workload", dict(total=60, template="low_s", n_subdomains=2)),
    ("shifting_workload", dict(total=120, phase_len=25)),
    ("shifting_workload", dict(total=80, complexity="mod", seed=9)),
    ("hybrid_workload", dict(mixture="balanced", total=150, phase_len=20)),
    ("hybrid_workload", dict(mixture="write_heavy", total=100)),
    ("segments_workload", dict(seg_len=40)),
]


@pytest.mark.parametrize("name,kw", GENERATOR_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(GENERATOR_CASES)])
def test_generator_matches_reference(name, kw):
    psrc = port_src()
    rgen = R.QueryGen(SRC, selectivity=0.01, seed=4)
    pgen = P.QueryGen(psrc, selectivity=0.01, seed=4)
    rwl = getattr(R, name)(rgen, **kw)
    pwl = getattr(P, name)(pgen, **kw)
    assert (len(pwl), pwl.n_phases, pwl.description) == (
        len(rwl), rwl.n_phases, rwl.description)
    for (rp, rq), (pp, pq) in zip(rwl, pwl):
        assert pp == rp
        assert _query_fields(pq) == _query_fields(rq)
    assert pgen.selectivity == rgen.selectivity
    # Both generators are left at the same point of their streams.
    assert _query_fields(pgen.low_s()) == _query_fields(rgen.low_s())
