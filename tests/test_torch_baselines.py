"""Whole-run parity of the port's baseline tuners with the reference.

``OnlineTuner`` (FULL builds), ``AdaptiveTuner`` (VBP populations on
every scan), ``SmixTuner`` (adaptive + LRU drops over the budget) and
``HolisticTuner`` (adaptive + random proactive populations from its own
seeded generator) driven by ``run_workload`` in both packages on the
same numpy inputs: every ``RunResult`` field but ``wall_s`` and
``execution_tiers``, the clock, the monitor window and every index's
state (FULL entries, VBP entries, intervals and ``in_index``) must be
equal, with no tolerance.  Read bursts of 1 and 6, the port's kernel
path off and on (plain versions on the CPU), 1 and 4 shards (the port
on 4 shards against the reference's 1-shard run); fig7's
``segments_workload`` with the holistic and predictive tuners at a
quick size; and the cases of ``test_tuner_system.py::
test_all_baseline_tuners_run``.
"""

import dataclasses
import warnings

import numpy as np
import pytest

import repro.api as R
from repro.core import baselines as R_bl
from repro_torch import api as P
from repro_torch.core import baselines as P_bl
from repro_torch.core import index as P_ix
from repro_torch.core.convert import from_reference

SRC = R.make_tuner_db(n_rows=3_000, page_size=128)
EXEMPT = ("wall_s", "execution_tiers")
BASELINES = ("OnlineTuner", "AdaptiveTuner", "SmixTuner", "HolisticTuner")


def port_src(src):
    tables, _ = from_reference(
        tables={k: [np.asarray(x) for x in t] for k, t in src.tables.items()},
        device="cpu")
    return P.TunerDB(tables=tables, quantiles=src.quantiles,
                     n_rows=src.n_rows, rng=None)


def _cfg(pkg, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return pkg.RunConfig(**kw)


def _tuner(pkg, db, kind, config=None):
    cfg = None if config is None else pkg.TunerConfig(**config)
    if kind in ("predictive", "immediate", "retrospective"):
        return pkg.make_dl_tuner(db, kind, cfg)
    if kind == "DisabledTuner":
        return (R_bl if pkg is R else P_bl).DisabledTuner(db)
    mod = R_bl if pkg is R else P_bl
    return getattr(mod, kind)(db, cfg)


def run_pair(make_workload, tuner, src=SRC, tuner_cfg=None, db_kw=None,
             use_kernel=False, num_shards=1, **cfg):
    """One run in each package: (ref result, ref db, port result, port
    db); the port may run on ``num_shards`` shards and its kernel path,
    the reference runs one shard and its vmap tier."""
    out = []
    for pkg, tsrc in ((R, src), (P, port_src(src))):
        wl = make_workload(pkg, tsrc)
        db = pkg.Database(dict(tsrc.tables), **(db_kw or {}))
        t = _tuner(pkg, db, tuner, tuner_cfg)
        res = pkg.run_workload(db, t, wl, _cfg(
            pkg, use_kernel=use_kernel and pkg is P,
            num_shards=num_shards if pkg is P else 1, **cfg))
        out += [res, db]
    return tuple(out)


def assert_same_result(ref, port):
    for f in dataclasses.fields(ref):
        if f.name not in EXEMPT:
            assert getattr(port, f.name) == getattr(ref, f.name), f.name


def _assert_entries(r, p):
    for name in ("key_hi", "key_lo", "rids"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(r, name)),
                                      err_msg=name)
    assert p.n_entries == int(r.n_entries)


def assert_same_db(rdb, pdb, page_size=128):
    """Clock, monitor, catalog order and every index state; a port
    index on S shards is held to the reference's 1-shard index by its
    entries as global rids."""
    assert pdb.clock_ms == rdb.clock_ms
    assert [dataclasses.astuple(r) for r in pdb.monitor.records] == [
        dataclasses.astuple(r) for r in rdb.monitor.records]
    assert list(pdb.indexes) == list(rdb.indexes)  # catalog order
    for name, rb in rdb.indexes.items():
        pb = pdb.indexes[name]
        assert (pb.scheme, pb.complete, pb.building) == (
            rb.scheme, rb.complete, rb.building)
        assert (pb.created_ms, pb.last_used_ms) == (rb.created_ms,
                                                    rb.last_used_ms)
        assert pb.size_bytes() == rb.size_bytes()
        if rb.scheme != "vbp":
            assert pb.vap.built_pages == int(rb.vap.built_pages)
            if not isinstance(pb.vap, P_ix.ShardedIndex):
                _assert_entries(rb.vap, pb.vap)
            continue
        assert pb.cov_union.ivs == rb.cov_union.ivs
        rv, pv = rb.vbp, pb.vbp
        for f in ("cov_lo_hi", "cov_lo_lo", "cov_hi_hi", "cov_hi_lo"):
            np.testing.assert_array_equal(getattr(pv, f),
                                          np.asarray(getattr(rv, f)))
        assert pv.n_cov == int(rv.n_cov)
        np.testing.assert_array_equal(pv.in_index.numpy(),
                                      np.asarray(rv.in_index))
        if isinstance(pv, P_ix.VbpState):
            _assert_entries(rv.index, pv.index)
        else:
            _assert_sharded_entries(rv.index, pv, page_size)


def _assert_sharded_entries(ref_index, pv, psz):
    """Each shard's entries are the reference's single-index entries
    owned by that shard (global page p on shard p % S at local page
    p // S), in the same order."""
    S = pv.index.n_shards
    n = int(ref_index.n_entries)
    kh = np.asarray(ref_index.key_hi)[:n]
    kl = np.asarray(ref_index.key_lo)[:n]
    rid = np.asarray(ref_index.rids)[:n].astype(np.int64)
    gp, sl = rid // psz, rid % psz
    for s in range(S):
        mine = gp % S == s
        ix = pv.index.shard(s)
        m = ix.n_entries
        assert m == int(mine.sum())
        np.testing.assert_array_equal(ix.key_hi[:m].numpy(), kh[mine])
        np.testing.assert_array_equal(ix.key_lo[:m].numpy(), kl[mine])
        np.testing.assert_array_equal(ix.rids[:m].numpy(),
                                      (gp[mine] // S) * psz + sl[mine])


def hybrid(mixture, total=72, phase_len=24, seed=2, gen_seed=23):
    def make(pkg, src):
        gen = pkg.QueryGen(src, selectivity=0.01, seed=gen_seed)
        return pkg.hybrid_workload(gen, mixture, total=total,
                                   phase_len=phase_len, seed=seed)
    return make


def shifting(total=60, phase_len=20):
    def make(pkg, src):
        gen = pkg.QueryGen(src, selectivity=0.02, seed=4)
        return pkg.shifting_workload(gen, total=total, phase_len=phase_len,
                                     complexity="mod")
    return make


TUNER_CFGS = {
    "OnlineTuner": None,
    "AdaptiveTuner": None,
    # 1,000 entries of 12 bytes: a few populations force LRU drops.
    "SmixTuner": dict(storage_budget_bytes=12_000.0),
    "HolisticTuner": dict(storage_budget_bytes=30_000.0),
}


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("batch", [1, 6])
@pytest.mark.parametrize("tuner", BASELINES)
def test_baseline_run_matches_reference(tuner, batch, use_kernel):
    ref, rdb, port, pdb = run_pair(
        hybrid("read_heavy"), tuner, tuner_cfg=TUNER_CFGS[tuner],
        use_kernel=use_kernel, tuning_interval_ms=1.0, read_batch_size=batch)
    assert_same_result(ref, port)
    assert_same_db(rdb, pdb)
    assert len(port.latencies_ms) == 72
    schemes = {b.scheme for b in pdb.indexes.values()}
    if tuner == "OnlineTuner":
        assert schemes == {"full"} and port.tuner_work_units > 0.0
    else:
        assert schemes == {"vbp"}
        assert any(s != 0.0 for s in port.latencies_ms)


def test_smix_drops_least_recently_used():
    """Over its budget SMIX drops the least recently used index, as the
    reference does: an index it has just created was never used by a
    scan (``last_used_ms`` 0.0), so each later phase's new index is the
    one dropped and the first phase's index is the one that stays."""
    ref, rdb, port, pdb = run_pair(
        shifting(), "SmixTuner", tuner_cfg=TUNER_CFGS["SmixTuner"],
        tuning_interval_ms=1.0, read_batch_size=4)
    assert_same_result(ref, port)
    assert_same_db(rdb, pdb)
    wl = [q for _, q in shifting()(P, port_src(SRC))]
    first, last = tuple(wl[0].attrs[:2]), tuple(wl[-1].attrs[:2])
    assert first != last
    assert [b.desc.key_attrs for b in pdb.indexes.values()] == [first]
    assert pdb.total_index_bytes() > TUNER_CFGS["SmixTuner"][
        "storage_budget_bytes"]  # the last index stays even over budget


@pytest.mark.parametrize("tuner", ["AdaptiveTuner", "HolisticTuner",
                                   "OnlineTuner"])
@pytest.mark.parametrize("S", [2, 4])
def test_baseline_run_on_shards_matches_reference(tuner, S):
    """The port on S round-robin shards (``ShardedVbpState``,
    ``pure_vbp`` over stacked shards) against the reference's 1-shard
    run."""
    ref, rdb, port, pdb = run_pair(
        shifting(), tuner, tuner_cfg=TUNER_CFGS[tuner], num_shards=S,
        use_kernel=True, tuning_interval_ms=1.0, read_batch_size=6)
    assert_same_result(ref, port)
    assert_same_db(rdb, pdb)
    assert pdb.num_shards == S
    if tuner != "OnlineTuner":
        assert all(isinstance(b.vbp, P_ix.ShardedVbpState)
                   for b in pdb.indexes.values())


def segments(n_rows, seg_len):
    def make(pkg, src):
        gen = pkg.QueryGen(src, selectivity=0.01)
        return pkg.segments_workload(gen, seg_len=seg_len)
    return make


@pytest.mark.parametrize("tuner", ["HolisticTuner", "predictive"])
def test_fig7_segments_match_reference(tuner):
    """benchmarks/fig7_holistic.py at a quick size: its two tuners, its
    open-loop client paced at one table scan (``arrival_ms``), a tuning
    interval of 12.5 table scans and a monitor horizon of 100, over two
    scan segments and an insert segment (the inserts drop the VBP
    coverage claims)."""
    n_rows, seg_len = 3_000, 40
    src = R.make_tuner_db(n_rows=n_rows, page_size=128, headroom=2.5)
    scan_ms = n_rows * 1e-4
    cfgs = {"predictive": dict(storage_budget_bytes=50e6, pages_per_cycle=16,
                               max_build_pages_per_cycle=48,
                               candidate_min_count=3, u_min_write=0.3),
            "HolisticTuner": dict(storage_budget_bytes=50e6)}
    ref, rdb, port, pdb = run_pair(
        segments(n_rows, seg_len), tuner, src=src, tuner_cfg=cfgs[tuner],
        db_kw=dict(monitor_max_age_ms=100 * scan_ms),
        tuning_interval_ms=12.5 * scan_ms, arrival_ms=scan_ms,
        read_batch_size=4)
    assert_same_result(ref, port)
    assert_same_db(rdb, pdb)
    assert port.phases.count(2) == seg_len
    if tuner == "HolisticTuner":
        lat, ph = np.asarray(port.latencies_ms), np.asarray(port.phases)
        assert lat[ph < 2].max() > scan_ms  # population spikes
        assert all(b.vbp.n_cov == 0 for b in pdb.indexes.values())


@pytest.mark.parametrize("kind", ["OnlineTuner", "AdaptiveTuner", "SmixTuner",
                                  "HolisticTuner", "DisabledTuner",
                                  "immediate", "retrospective"])
def test_all_baseline_tuners_run(kind):
    """``test_tuner_system.py::test_all_baseline_tuners_run`` in both
    packages (its balanced workload, its SMIX budget, its tuning
    interval), held field for field."""
    config = dict(storage_budget_bytes=2e5) if kind == "SmixTuner" else None
    ref, rdb, port, pdb = run_pair(
        hybrid("balanced", total=60, phase_len=30, seed=9, gen_seed=11),
        kind, tuner_cfg=config, tuning_interval_ms=50.0)
    assert_same_result(ref, port)
    assert_same_db(rdb, pdb)
    assert len(port.latencies_ms) == 60 and port.cumulative_ms > 0


def test_tuners_exported_where_the_reference_has_them():
    for name in BASELINES + ("DisabledTuner",):
        assert getattr(P, name) is getattr(P_bl, name)
        assert getattr(R_bl, name).name == getattr(P_bl, name).name


def built_slots(table, vap):
    """Flat slots of a table (plain: (n_pages, page_size); sharded: (S,
    max_pages, page_size)) that lie in the built pages of a VAP / FULL
    state: a plain ``built_pages`` prefix, or each shard's
    ``shard_built`` prefix."""
    psz = table.page_size
    slot = np.arange(table.begin_ts.numel())
    if isinstance(table, P.ShardedTable):
        per_shard = table.max_pages * psz
        built = np.asarray(vap.shard_built) * psz
        return slot % per_shard < built[slot // per_shard]
    return slot < vap.built_pages * psz


@pytest.mark.parametrize("S", [1, 4])
def test_full_index_answers_from_its_built_pages(S):
    """The reference lets a complete FULL index answer a scan alone
    (``pure_vap``) although rows of the watermark page, and rows
    appended since the build, are not in it.  The port keeps that rule:
    every answer equals the reference's and a numpy scan of the rows in
    the index's built pages, and some miss rows of the whole table."""
    rdb = R.Database(dict(SRC.tables))
    rbi = rdb.create_index(R.IndexDescriptor("narrow", (1,)), "full")
    rdb.vap_build_step(rbi, 100)
    ins = R.QueryGen(SRC, seed=3).ins(n=40)
    rdb.execute(ins)
    db = P.Database(port_src(SRC).tables, num_shards=S)
    bi = db.create_index(P.IndexDescriptor("narrow", (1,)), "full")
    db.vap_build_step(bi, 100)
    db.execute(P.Query(**{f.name: getattr(ins, f.name)
                          for f in dataclasses.fields(ins)}))
    assert bi.complete
    t = db.tables["narrow"]
    vals = t.data.reshape(-1, t.n_attrs).numpy()
    begin, end = t.begin_ts.reshape(-1).numpy(), t.end_ts.reshape(-1).numpy()
    in_index = built_slots(t, bi.vap)
    missed = 0
    for lo in range(1, 1_000_000, 25_000):
        q = R.Query(kind="scan", table="narrow", attrs=(1,), los=(lo,),
                    his=(lo + 25_000,), agg_attr=2)
        pq = P.Query(**{f.name: getattr(q, f.name)
                        for f in dataclasses.fields(q)})
        assert db.planner.plan_scan(pq).path == "pure_vap"
        ref = rdb.execute(q, observe=False)
        ts = db.clock_ms_i32()
        got = db.execute(pq, observe=False)
        assert (got.agg_sum, got.count, got.cost_units) == (
            ref.agg_sum, ref.count, ref.cost_units)
        m = ((vals[:, 1] >= lo) & (vals[:, 1] <= lo + 25_000)
             & (begin <= ts) & (ts < end))
        whole = (int(vals[m, 2].astype(np.int64).sum()), int(m.sum()))
        m &= in_index
        assert (got.agg_sum, got.count) == (
            int(vals[m, 2].astype(np.int64).sum()), int(m.sum()))
        missed += (got.agg_sum, got.count) != whole
    assert missed > 0  # the reference's rule misses rows
