"""Shard-aware tuning in the port, held to the reference.

The cases of ``tests/test_shard_tuning.py`` that need no
``BuildService``, each run in both packages through ``run_workload``
from one state: with ``shard_aware_tuning`` off every shard count
equals the single-shard engine; on one shard the flag changes nothing;
on four shards scans record per-shard heat and shard-targeted quanta
relax the prefix, and the port's run equals the reference's 4-shard
run field for field; per-shard prefixes keep scans exact; and the
skewed benchmark converges at least 1.2x faster.  ``ShardHeatForecaster``
is bit-equal to the reference's jitted ``vmap`` forms.

The reference's sharded writes park on each shard's last slot and can
lose a real row there (ROADMAP.md, queue 3 item 1).  Runs with writes
on sharded storage are therefore held to the reference's 1-shard run,
and where shard-aware tuning leaves no 1-shard oracle the divergence is
pinned by a named test (``test_shard_aware_write_heavy_run_keeps_the_rows
_the_reference_loses``).
"""

import _torch_threads  # noqa: F401  (first: pins torch's threads)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as R
from benchmarks import shard_tuning as bench
from repro.core import forecaster as R_hw
from repro.core import table as R_tb
from repro_torch import api as P
from repro_torch.core import forecaster as P_hw
from repro_torch.core import table as P_tb
from repro_torch.core.convert import from_reference
from repro_torch.core.index import prefix_is_round_robin
from test_torch_forecaster import UPDATE_CASES
from test_torch_runner import (
    SRC,
    assert_same_db,
    assert_same_result,
    hybrid,
    port_src,
    run_pair,
)

def _run(num_shards, aware, mixture="read_heavy", use_kernel=False):
    """tests/test_shard_tuning.py's ``_run`` (serialized tuning) in both
    packages: (ref result, ref db, port result, port db)."""
    return run_pair(hybrid(mixture), "predictive", use_kernel=use_kernel,
                    tuning_interval_ms=2.0, num_shards=num_shards,
                    read_batch_size=6, shard_aware_tuning=aware)


@pytest.fixture(scope="module")
def one_shard():
    """The reference's and the port's 1-shard runs, flag off, per
    mixture."""
    return {m: _run(1, False, m) for m in ("read_heavy", "write_heavy")}


# ---------------------------------------------------------------------------
# Flag off: every shard count is the single-shard engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mixture", ["read_heavy", "write_heavy"])
@pytest.mark.parametrize("S", [2, 4])
def test_flag_off_bit_identical_across_shard_counts(S, mixture, one_shard):
    """The port on S shards, flag off, against the reference's 1-shard
    run: every RunResult field, the clock, the monitor records (no
    per-shard counters) and the build state.  (The reference's own
    S-shard write_heavy run loses rows; its read_heavy run is equal.)"""
    ref, rdb, _, _ = one_shard[mixture]
    _, _, port, pdb = _run(S, False, mixture, use_kernel=S == 4)
    assert ref.tuner_work_units > 0.0
    assert_same_result(ref, port)
    assert_same_db(rdb, pdb)
    assert pdb.num_shards == S and not pdb.pershard_built
    assert all(r.shard_pages == () for r in pdb.monitor.records)


def test_shard_aware_single_shard_degenerates_to_legacy(one_shard):
    """On unsharded storage the flag is a no-op: the reference's and the
    port's flag-on runs equal the flag-off run."""
    ref_off, _, port_off, _ = one_shard["read_heavy"]
    ref, rdb, port, pdb = _run(1, True)
    assert_same_result(ref, port)
    assert_same_db(rdb, pdb)
    assert_same_result(port_off, port)
    assert_same_result(ref_off, ref)
    assert not pdb.pershard_built


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_shard_aware_four_shards_records_heat_and_diverges(use_kernel):
    """Flag on over 4 shards: scans record per-shard page counters and
    shard-targeted quanta relax the prefix -- and the port's run equals
    the reference's 4-shard run field for field: results, accounting,
    monitor records (their ``shard_pages`` included), per-shard build
    state, and the tuner's heat forecasts."""
    ref, rdb, port, pdb = _run(4, True, use_kernel=use_kernel)
    assert port.tuner_work_units > 0.0
    assert_same_result(ref, port)
    assert_same_db(rdb, pdb)
    scans = [r for r in pdb.monitor.records if r.kind == "scan"]
    assert any(len(r.shard_pages) == 4 for r in scans)
    assert pdb.pershard_built  # at least one index built per shard
    for name, rb in rdb.indexes.items():
        pb = pdb.indexes[name]
        assert pb.vap.shard_built == tuple(
            int(ix.built_pages) for ix in rb.vap.shards)
        assert pb.vap.shard_entries == tuple(
            int(ix.n_entries) for ix in rb.vap.shards)
    if use_kernel:
        assert port.execution_tiers == {"kernel": len(scans)}


def test_shard_aware_write_heavy_run_keeps_the_rows_the_reference_loses(
        one_shard):
    """write_heavy on 4 shards with the flag on: the reference's sharded
    UPDATE parks on each shard's last slot and loses the real rows at
    global pages 32, 33 and 34, slot 127 (shards 0, 1 and 2's last
    slots), so its statement 28 modifies 112 rows where the 1-shard
    engine modifies 113.  The port keeps those rows: its run equals the
    reference's 4-shard run up to that statement, and its results,
    latencies and accounting equal the reference's 1-shard run."""
    ref4, rdb4, port, pdb = _run(4, True, "write_heavy")
    ref1, rdb1, _, _ = one_shard["write_heavy"]
    first = next(i for i, (a, b) in enumerate(zip(ref4.results,
                                                  port.results)) if a != b)
    assert first == 28
    assert (ref4.results[first], port.results[first],
            ref1.results[first]) == ((0, 0, 112), (0, 0, 113), (0, 0, 113))
    assert port.latencies_ms[:first] == ref4.latencies_ms[:first]
    assert port.results[:first] == ref4.results[:first]
    assert_same_result(ref1, port)
    rt4 = R_tb.unshard_table(rdb4.tables["narrow"])
    rt1, pt = rdb1.tables["narrow"], P_tb.unshard_table(pdb.tables["narrow"])
    for page in (32, 33, 34):
        assert int(np.asarray(rt4.begin_ts)[page, 127]) == R_tb.NEVER_TS
        assert int(pt.begin_ts[page, 127]) == int(
            np.asarray(rt1.begin_ts)[page, 127]) != P_tb.NEVER_TS
        np.testing.assert_array_equal(pt.data[page, 127].numpy(),
                                      np.asarray(rt1.data)[page, 127])
    assert pdb.pershard_built == rdb4.pershard_built


# ---------------------------------------------------------------------------
# Relaxed prefix invariant: results stay exact, planner switches stitch
# ---------------------------------------------------------------------------

STAT_FIELDS = ("agg_sum", "count", "cost_units", "latency_ms", "used_index",
               "shard_pages")


def _stats_key(s):
    return tuple(getattr(s, f) for f in STAT_FIELDS)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_pershard_prefix_scans_bit_match_single_query_oracle(use_kernel):
    """Divergent shard-local prefixes: the per-shard stitch keeps
    aggregates equal to an index-free oracle, the batched path equals
    the single-query path, the planner routes through hybrid_ps, and
    every stats field equals the reference's."""

    def mk(pkg, src):
        db = pkg.Database(dict(src.tables), num_shards=4)
        bi = db.create_index(pkg.IndexDescriptor("narrow", (1,)), "vap")
        db.vap_build_step(bi, 3, shard=2)  # shard 2 ahead
        db.vap_build_step(bi, 1, shard=0)  # shard 0 behind
        db.shard_aware_tuning = True
        return db, bi

    db, bi = mk(P, port_src())
    rdb, _ = mk(R, SRC)
    assert not prefix_is_round_robin(bi.vap)
    assert "narrow:1" in db.pershard_built

    rgen = R.QueryGen(SRC, selectivity=0.01, seed=3)
    pgen = P.QueryGen(port_src(), selectivity=0.01, seed=3)
    rqs = [rgen.low_s(attr=1) for _ in range(6)]
    queries = [pgen.low_s(attr=1) for _ in range(6)]
    assert db.planner.plan_scan(queries[0]).path == "hybrid_ps"

    oracle = P.Database(dict(port_src().tables))  # no indexes at all
    single = [db.execute(q, observe=False) for q in queries]
    for s, q, rq in zip(single, queries, rqs):
        o = oracle.execute(q, observe=False)
        assert (s.agg_sum, s.count) == (o.agg_sum, o.count)
        assert s.used_index and len(s.shard_pages) == 4
        assert _stats_key(s) == _stats_key(rdb.execute(rq, observe=False))

    db2, _ = mk(P, port_src())
    batched = db2.execute_batch(queries, observe=False, use_kernel=use_kernel)
    for a, b in zip(single, batched):
        assert _stats_key(a) == _stats_key(b)


# ---------------------------------------------------------------------------
# The skewed benchmark: >= 1.2x convergence, equal to the reference's
# ---------------------------------------------------------------------------

def test_skewed_benchmark_convergence_speedup():
    """benchmarks/shard_tuning.py at the reference test's sizes (240
    read-only queries, phases of 120) through the port: each arm equals
    the reference's run field for field, and the shard-aware arm
    converges at least 1.2x sooner with a lower cumulative time."""
    ref = bench.run(total=240, phase_len=120, quiet=True)
    src = bench.make_skewed_db()
    st = src.tables["narrow"]
    tables, _ = from_reference(tables={"narrow": (
        [[np.asarray(x) for x in t] for t in st.shards],
        np.asarray(st.n_rows))}, device="cpu")
    psrc = P.TunerDB(tables=tables, quantiles=src.quantiles,
                     n_rows=src.n_rows, rng=None)
    out = {}
    for aware in (False, True):
        gen = P.QueryGen(psrc, selectivity=0.01, seed=31)
        wl = P.hybrid_workload(gen, "read_only", total=240, phase_len=120,
                               seed=5)
        db = P.Database(dict(psrc.tables))
        tuner = P.PredictiveTuner(db, P.TunerConfig(
            storage_budget_bytes=50e6, pages_per_cycle=8,
            max_build_pages_per_cycle=8, candidate_min_count=2))
        out[aware] = P.run_workload(db, tuner, wl, P.RunConfig(
            execution=P.ExecOptions(num_shards=db.num_shards),
            tuning=P.TuningOptions(tuning_interval_ms=5.0,
                                   shard_aware_tuning=aware)))
        assert_same_result(ref[aware], out[aware])
    conv_base = bench.queries_to_converge(out[False])
    conv_aware = bench.queries_to_converge(out[True])
    assert conv_aware < len(out[True].built_fraction)  # converged
    assert conv_base / max(conv_aware, 1) >= 1.2
    assert out[True].cumulative_ms < out[False].cumulative_ms


# ---------------------------------------------------------------------------
# ShardHeatForecaster: bit-equal to the reference's batched jitted forms
# ---------------------------------------------------------------------------

def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _assert_hw_equal(ref, port):
    for name in ("level", "trend", "season", "t"):
        np.testing.assert_array_equal(
            getattr(port, name).numpy().view(np.int32),
            np.asarray(getattr(ref, name)).view(np.int32), err_msg=name)


def test_shard_heat_forecaster_matches_reference():
    """observe / predict over a skewed, a drifting and an all-zero heat
    series, season 4 (so the seasonal factors take part), against the
    reference's ShardHeatForecaster: states and forecasts bit for bit,
    all ones before the first observation."""
    rng = np.random.default_rng(5)
    rf = R_hw.ShardHeatForecaster(4, season_len=4)
    pf = P_hw.ShardHeatForecaster(4, season_len=4, device="cpu")
    np.testing.assert_array_equal(pf.predict(), rf.predict())
    assert pf.predict().dtype == np.float64
    heat = [[40.0, 4.0, 4.0, 4.0]] * 3 + [
        rng.uniform(0, 500, 4).round(1).tolist() for _ in range(9)] + [
        [0.0] * 4, [0.0, 3.0, 0.0, 7.0]]
    for h in heat:
        rf.observe(h)
        pf.observe(h)
        _assert_hw_equal(rf.state, pf.state)
        for ahead in (1, 2, 3):
            np.testing.assert_array_equal(pf.predict(ahead),
                                          rf.predict(ahead))
    pred = pf.predict()
    assert pred.shape == (4,) and (pred >= 0).all()


def test_shard_heat_forecaster_halfway_sums_match_reference():
    """The halfway sums of tests/test_torch_forecaster.py through the
    batched forms: each of ``update``'s two fused multiply-adds (level,
    season) in its own series of a batched state, and ``forecast``'s
    ``l + h * b`` on both sides of a float32 midpoint."""
    for _, fields, y, alpha, beta, gamma, _ in UPDATE_CASES:
        n, m = 3, 4
        level = np.float32([fields["level"], 7.0, 11.0])
        trend = np.float32([fields["trend"], 0.5, -0.25])
        season = np.ones((n, m), np.float32)
        season[0, 1] = fields["s_tm"]
        ys = np.float32([y, 3.0, 250.0])
        t = np.ones(n, np.int32)
        rs = R_hw.HWState(*(jnp.asarray(x) for x in (level, trend, season,
                                                      t)))
        ps = P_hw.HWState(*(torch.from_numpy(x.copy())
                            for x in (level, trend, season, t)))
        rf = R_hw.ShardHeatForecaster(n, season_len=m, alpha=alpha,
                                      beta=beta, gamma=gamma)
        pf = P_hw.ShardHeatForecaster(n, season_len=m, alpha=alpha,
                                      beta=beta, gamma=gamma, device="cpu")
        rf.state, pf.state = rs, ps
        rf.observe(ys)
        pf.observe(ys)
        _assert_hw_equal(rf.state, pf.state)
    trend = 1 + 2.0**-23
    for level in (-(2.0**-60), 2.0**-60):
        lv = np.float32([level, 1.0])
        tr = np.float32([trend, 2.0])
        season = np.ones((2, 4), np.float32)
        t = np.int32([5, 5])
        rs = R_hw.HWState(*(jnp.asarray(x) for x in (lv, tr, season, t)))
        ps = P_hw.HWState(*(torch.from_numpy(x.copy())
                            for x in (lv, tr, season, t)))
        got = P_hw.forecast_batch(ps, 3).numpy()
        np.testing.assert_array_equal(_bits(got),
                                      _bits(R_hw.forecast_batch(rs, 3)))
        rf = R_hw.ShardHeatForecaster(2, season_len=4)
        pf = P_hw.ShardHeatForecaster(2, season_len=4, device="cpu")
        rf.state, pf.state = rs, ps
        np.testing.assert_array_equal(pf.predict(3), rf.predict(3))


def test_tuner_keeps_one_heat_forecaster_per_sharded_table():
    """The port's tuner builds the heat forecaster on the database's
    device, keyed by (table, shard count), with the tuner's season and
    smoothing parameters, and feeds it the monitor's window sums."""
    _, rdb, _, pdb = _run(4, True)
    port_tuner = P.make_dl_tuner(pdb, "predictive")
    ref_tuner = R.make_dl_tuner(rdb, "predictive")
    port_tuner.decide()
    ref_tuner.decide()
    assert list(port_tuner.shard_heat) == list(ref_tuner.shard_heat) == [
        ("narrow", 4)]
    pf, rf = port_tuner.shard_heat["narrow", 4], ref_tuner.shard_heat[
        "narrow", 4]
    assert pf.state.level.device == pdb.device
    assert pf.params == rf.params and pf.state.season.shape == (4, 16)
    _assert_hw_equal(rf.state, pf.state)
    np.testing.assert_array_equal(
        pdb.monitor.shard_page_counts("narrow", 4),
        rdb.monitor.shard_page_counts("narrow", 4))
    assert dataclasses.astuple(pdb.monitor.records[-1]) == \
        dataclasses.astuple(rdb.monitor.records[-1])
