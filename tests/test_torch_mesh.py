"""Parity of the port's device mesh (``repro_torch.parallel.mesh`` and
the engine's five ``mesh_*`` forms) with the reference.

Every form runs under ``force_local_devices([cpu] * d)``: d entries
that all name the CPU, the counterpart of XLA's
``--xla_force_host_platform_device_count``.  So these tests check the
split of the stacked shard axis (and of a burst's queries on a 2 x 2
grid), the explicit reductions that stand for the reference's
collectives and the runner's mesh options -- not placement on
separate devices.

Tolerance: none.  Each form is held bit-equal, every
``BatchScanResult`` field, to the reference's in-process stacked
dispatch on the same numpy inputs (the reference's own tests hold its
mesh equal to that dispatch); one subprocess runs the reference on a
forced 4-device mesh and holds the port's ``ExecStats`` (tier
``shard_map`` included), clock, monitor records and whole
``run_workload`` results to it field for field.
"""

import _torch_threads  # noqa: F401  (first: pins torch's threads)

import dataclasses
import functools
import os
import pickle
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as R
from benchmarks.shard_tuning import make_skewed_db
from repro.core import engine as R_eng
from repro.core import index as R_ix
from repro_torch import api as P
from repro_torch.core import engine as P_eng
from repro_torch.core import index as P_ix
from repro_torch.core import table as P_tb
from repro_torch.parallel import mesh as P_mesh
from test_torch_runner import port_src
from test_torch_sharded import (
    _assert_result_equal,
    _coverage_pair,
    _port_index,
    _port_table,
)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CPU = torch.device("cpu")
SRC = R.make_tuner_db(n_rows=2_000, page_size=128)
MESHES = {"d2": (2, 1), "d4": (4, 1), "2x2": (2, 2)}  # (d, q)
FORMS = ("table", "hybrid", "hybrid_ps", "hybrid_masked", "pure_vap")
MESH_FNS = {
    "table": P_eng.mesh_batched_full_table_scan,
    "hybrid": P_eng.mesh_batched_hybrid_scan,
    "hybrid_ps": P_eng.mesh_batched_hybrid_scan_pershard,
    "hybrid_masked": P_eng.mesh_batched_hybrid_scan_masked,
    "pure_vap": P_eng.mesh_batched_pure_index_scan,
}


@functools.lru_cache(maxsize=None)
def _state(layout):
    """Reference and port 4-shard table with a VAP index on attr 1 of
    divergent per-shard prefixes, plus a second index built on every
    third eligible page and its coverage views."""
    if layout == "skewed":  # 36/4/4/4 pages
        rdb = R.Database(dict(make_skewed_db().tables))
        builds = ((0, 10), (2, 4))
    else:
        rdb = R.Database(dict(SRC.tables), num_shards=4)
        builds = ((0, 3), (2, 1), (3, 4))  # rho_m on the last shard
    bi = rdb.create_index(R.IndexDescriptor("narrow", (1,)), "vap")
    for shard, pages in builds:
        rdb.vap_build_step(bi, pages=pages, shard=shard)
    rst = rdb.tables["narrow"]
    pst = _port_table(rst)
    pages = P_ix.eligible_global_pages(pst)[1::3]
    rmx = R_ix.build_page_list(R_ix.make_sharded_index(rst), rst, (1,),
                               pages)
    pmx = P_ix.build_page_list(P_ix.make_sharded_index(pst), pst, (1,),
                               pages)
    return (rst, bi.vap, rmx, pst, _port_index(bi.vap), pmx,
            _coverage_pair(rst, pages))


def _bounds(n_queries, seed, width=40_000):
    rng = np.random.default_rng(seed)
    los = rng.integers(1, 5 * 10**5, size=(n_queries, 1)).astype(np.int32)
    return los, los + width, np.full((n_queries,), 5, np.int32)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("layout", ["uniform", "skewed"])
def test_mesh_form_matches_reference_stacked(layout, mesh_name, form):
    """The form called directly and through ``ScanEngine.scan_batch``
    (plain and kernel paths: K4 / K3 plain versions per slice on the
    CPU) equals the reference's stacked dispatch."""
    rst, rix, rmx, pst, pix, pmx, (rcov, pcov) = _state(layout)
    masked = form == "hybrid_masked"
    rix, pix = (rmx, pmx) if masked else (rix, pix)
    los, his, tss = _bounds(6, seed=len(mesh_name) + len(form))
    ref = R_eng.ScanEngine().scan_batch(
        rst, form, rix, (1,), (1,), jnp.asarray(los), jnp.asarray(his),
        jnp.asarray(tss), 2, coverage=rcov if masked else None)
    d, q = MESHES[mesh_name]
    pargs = (torch.from_numpy(los), torch.from_numpy(his),
             torch.from_numpy(tss), 2)
    with P_mesh.force_local_devices([CPU] * (d * q)):
        mesh = P_mesh.make_scan_mesh(4, q, "cpu")
        assert mesh.shape == ({"shard": d} if q == 1
                              else {"shard": d, "qbatch": q})
        assert P_mesh.mesh_device_count(mesh) == d * q
        if form == "table":
            got = MESH_FNS[form](pst, (1,), *pargs, mesh)
        elif masked:
            got = MESH_FNS[form](pst, pix, (1,), (1,), *pargs, pcov, mesh)
        else:
            got = MESH_FNS[form](pst, pix, (1,), (1,), *pargs, mesh)
        _assert_result_equal(ref, got, f"{layout}.{mesh_name}.{form}")
        for use_kernel in (False, True):
            eng = P_eng.ScanEngine()
            eng.mesh_query_axis = q
            got = eng.scan_batch(pst, form, pix, (1,), (1,), *pargs,
                                 use_kernel=use_kernel,
                                 coverage=pcov if masked else None)
            assert eng.last_tier == "shard_map"
            _assert_result_equal(ref, got, f"{form}.kernel={use_kernel}")


def test_two_attribute_bursts_and_uneven_query_axis():
    """A 2-attribute conjunction (K4's second predicate plane per slice)
    on a 2 x 2 grid; a burst of 5 queries does not split over a query
    axis of 2 and takes the 1-D grid, as in the reference."""
    rst, rix, _, pst, pix, _, _ = _state("uniform")
    rng = np.random.default_rng(9)
    los = np.stack([rng.integers(1, 5 * 10**5, 8),
                    np.zeros(8, np.int64)], 1).astype(np.int32)
    his = los + np.array([40_000, 10**6], np.int32)
    tss = np.full((8,), 5, np.int32)
    with P_mesh.force_local_devices([CPU] * 4):
        for B in (8, 5):
            for path in ("table", "hybrid", "hybrid_ps"):
                ref = R_eng.ScanEngine().scan_batch(
                    rst, path, rix, (1,), (1, 2), jnp.asarray(los[:B]),
                    jnp.asarray(his[:B]), jnp.asarray(tss[:B]), 3)
                eng = P_eng.ScanEngine()
                eng.mesh_query_axis = 2
                got = eng.scan_batch(
                    pst, path, pix, (1,), (1, 2), torch.from_numpy(los[:B]),
                    torch.from_numpy(his[:B]), torch.from_numpy(tss[:B]), 3,
                    use_kernel=True)
                assert eng.last_tier == "shard_map"
                _assert_result_equal(ref, got, f"B={B}.{path}")
        assert P_mesh.make_scan_mesh(4, 2, "cpu").shape == {"shard": 2,
                                                            "qbatch": 2}
        assert P_mesh.make_scan_mesh(3, 1, "cpu").shape == {"shard": 3}
        assert P_mesh.make_scan_mesh(5, 1, "cpu") is None  # no d | 5


def test_placement_rule_matches_reference():
    """The reference's rule: the largest d >= 2 dividing n_shards among
    ``len(devices) // q`` devices, None below two; the device tuple is
    part of the cache key."""
    for n_dev in (1, 2, 3, 4, 6, 8):
        with P_mesh.force_local_devices([CPU] * n_dev):
            for n_shards in (1, 2, 3, 4, 6, 8):
                for q in (1, 2):
                    avail = n_dev // q
                    want = max([c for c in range(2, min(n_shards, avail) + 1)
                                if n_shards % c == 0], default=None)
                    mesh = P_mesh.make_scan_mesh(n_shards, q, "cpu")
                    got = None if mesh is None else mesh.shape["shard"]
                    assert got == want, (n_dev, n_shards, q)
    assert P_mesh.make_scan_mesh(4, 1, "cpu") is None  # one CPU again
    assert P_mesh.local_devices("cpu") == (CPU,)
    with P_mesh.force_local_devices(["cpu", "cpu"]):
        m = P_mesh.make_scan_mesh(2, 1, "cpu")
        assert P_mesh.batch_spec(m) == () and P_mesh.query_axis_size(m) == 1
        with pytest.raises(AttributeError):
            m.devices = ()
    assert P_mesh.stacked_specs() == (P_mesh.SHARD_AXIS,)
    assert P_mesh.replicated_spec() == ()


def test_one_device_falls_back_and_required_mesh_raises():
    """No grid on one device: auto takes the stacked dispatch with its
    tier, False never tries, True raises naming the mesh."""
    rst, rix, _, pst, pix, _, _ = _state("uniform")
    los, his, tss = _bounds(4, seed=3)
    args = (torch.from_numpy(los), torch.from_numpy(his),
            torch.from_numpy(tss), 2)
    ref = R_eng.ScanEngine().scan_batch(
        rst, "hybrid", rix, (1,), (1,), jnp.asarray(los), jnp.asarray(his),
        jnp.asarray(tss), 2)
    for mode, use_kernel, tier in ((None, False, "vmap-stacked"),
                                   (None, True, "kernel"),
                                   (False, False, "vmap-stacked")):
        eng = P_eng.ScanEngine()
        eng.mesh_mode = mode
        got = eng.scan_batch(pst, "hybrid", pix, (1,), (1,), *args,
                             use_kernel=use_kernel)
        assert eng.last_tier == tier
        _assert_result_equal(ref, got, str(mode))
    with P_mesh.force_local_devices([CPU] * 4):  # False: never
        eng = P_eng.ScanEngine()
        eng.mesh_mode = False
        eng.scan_batch(pst, "hybrid", pix, (1,), (1,), *args)
        assert eng.last_tier == "vmap-stacked"
    eng = P_eng.ScanEngine()
    eng.mesh_mode = True
    with pytest.raises(RuntimeError, match="mesh"):
        eng.scan_batch(pst, "hybrid", pix, (1,), (1,), *args)
    # Through the runner: the same refusal before the first dispatch's
    # result, and None / False run the stacked dispatch.
    src = port_src()
    db = P.Database(dict(src.tables))
    wl = P.hybrid_workload(P.QueryGen(src, selectivity=0.01, seed=5),
                           "read_only", total=16, phase_len=8)
    cfg = P.RunConfig(execution=P.ExecOptions(read_batch_size=8,
                                              num_shards=4, mesh=True))
    with pytest.raises(RuntimeError, match="mesh"):
        P.run_workload(db, P.make_dl_tuner(db, "predictive"), wl, cfg)


def test_plain_table_and_single_query_never_take_the_mesh():
    src = port_src()
    gen = P.QueryGen(src, selectivity=0.01, seed=3)
    qs = [gen.low_s(attr=1) for _ in range(4)]
    with P_mesh.force_local_devices([CPU] * 4):
        db = P.Database(dict(src.tables))
        db.engine.mesh_mode = True  # a plain table never asks
        assert all(s.tier == "single" for s in db.execute_batch(qs))
        db4 = P.Database(dict(port_src().tables), num_shards=4)
        assert db4.execute(qs[0]).tier == "loop"
        assert {s.tier for s in db4.execute_batch(qs)} == {"shard_map"}


def test_same_device_slice_is_a_view_and_other_device_a_cached_copy():
    """On the table's own device a slice shares storage (no copy);
    elsewhere (``meta`` here) it is a copy made once per source tensor,
    kept in attribute-major stride order and dropped by a mutator."""
    _, _, _, pst, pix, _, (_, pcov) = _state("uniform")
    sl = P_tb.slice_shards(pst, 2, 4, CPU)
    assert sl.data.data_ptr() == pst.data[2].data_ptr()
    assert sl.begin_ts.data_ptr() == pst.begin_ts[2].data_ptr()
    assert sl.local_pages == pst.local_pages[2:]
    assert sl.n_rows == pst.n_rows
    assert sl.data[..., 1].is_contiguous()  # a unit-stride plane
    six = P_ix.slice_shard_indexes(pix, 2, 4, CPU)
    assert six.rids.data_ptr() == pix.rids[2].data_ptr()
    assert six.shard_built == pix.shard_built[2:]
    cov = P_ix.slice_coverage(pcov, 2, 4, CPU)
    assert cov.words.data_ptr() == pcov.words[2].data_ptr()
    assert cov.mask.data_ptr() == pcov.mask[2].data_ptr()

    st = P_tb.shard_table(P_tb.load_table(
        np.arange(4 * 64 * 3, dtype=np.int32).reshape(-1, 3), 16,
        n_pages=20, device="cpu"), 4)
    meta = torch.device("meta")
    a = P_tb.slice_shards(st, 0, 2, meta)
    assert a.data.device == meta and a.data.shape == st.data[:2].shape
    assert a.data.stride() == P_tb.attribute_major(
        (2, st.max_pages), 16, 3, meta).stride()
    b = P_tb.slice_shards(st, 0, 2, meta)
    assert b.data is a.data and b.end_ts is a.end_ts  # made once
    st = P_tb.sharded_insert_rows(st, torch.ones((3, 3), dtype=torch.int32),
                                  7, 3)
    c = P_tb.slice_shards(st, 0, 2, meta)
    assert c.data is not a.data and c.begin_ts is not a.begin_ts
    d = P_tb.slice_shards(st, 0, 2, meta)
    st, n = P_tb.sharded_update_rows(st, (0,), (0,), (10**6,), (1,), (5,),
                                     9, max_new=4)
    assert n == 4
    assert P_tb.slice_shards(st, 0, 2, meta).end_ts is not d.end_ts


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_run_workload_on_a_forced_mesh_matches_reference(mesh_name):
    """Whole closed-loop runs (read_heavy: UPDATE / INSERT statements
    between 4-shard read bursts, kernel path on) on a forced grid equal
    the reference's run field for field; every batched scan was served
    by the mesh."""
    d, q = MESHES[mesh_name]
    out = []
    for pkg, src in ((R, SRC), (P, port_src(SRC))):
        gen = pkg.QueryGen(src, selectivity=0.01, seed=5)
        wl = pkg.hybrid_workload(gen, "read_heavy", total=48, phase_len=24,
                                 seed=2)
        db = pkg.Database(dict(src.tables))
        cfg = pkg.RunConfig(execution=pkg.ExecOptions(
            read_batch_size=8, num_shards=4, mesh=pkg is P or None,
            mesh_query_axis=q, use_kernel=pkg is P))
        with P_mesh.force_local_devices([CPU] * (d * q)):
            res = pkg.run_workload(db, pkg.make_dl_tuner(db, "predictive"),
                                   wl, cfg)
        out += [res, db]
    ref, rdb, got, pdb = out
    for f in dataclasses.fields(ref):
        if f.name not in ("wall_s", "execution_tiers"):
            assert getattr(got, f.name) == getattr(ref, f.name), f.name
    assert got.execution_tiers.get("shard_map", 0) > 0
    assert "vmap-stacked" not in got.execution_tiers
    assert "kernel" not in got.execution_tiers
    assert pdb.clock_ms == rdb.clock_ms
    assert [dataclasses.astuple(r) for r in pdb.monitor.records] == [
        dataclasses.astuple(r) for r in rdb.monitor.records]


def test_replica_proxy_fans_the_mesh_flags_out():
    src = port_src()
    db = P.Database(dict(src.tables), num_shards=4)
    rs = P.ReplicaSet(db, 3)
    assert rs.n_replicas == 3 and rs.replica_db(0) is db
    rs.engine.mesh_mode = False
    rs.engine.mesh_query_axis = 2
    for r in range(rs.n_replicas):
        eng = rs.replica_db(r).engine
        assert (eng.mesh_mode, eng.mesh_query_axis) == (False, 2)
    gen = P.QueryGen(src, selectivity=0.01, seed=3)
    qs = [gen.low_s(attr=1) for _ in range(4)]
    with P_mesh.force_local_devices([CPU] * 4):
        assert {s.tier for s in rs.execute_batch(qs)} == {"vmap-stacked"}
        rs.engine.mesh_mode = None
        assert {s.tier for s in rs.execute_batch(qs)} == {"shard_map"}


# ---------------------------------------------------------------------------
# The reference on a forced 4-device mesh (one subprocess)
# ---------------------------------------------------------------------------

_REF_SCRIPT = """
    import dataclasses, pickle, sys
    import jax
    from repro.bench_db import QueryGen, make_tuner_db
    from repro.bench_db.runner import RunConfig, run_workload
    from repro.bench_db.workloads import hybrid_workload
    from repro.core import Database, make_dl_tuner

    assert len(jax.devices()) == 4, jax.devices()
    SRC = make_tuner_db(n_rows=2_000, page_size=128)
    gen = QueryGen(SRC, selectivity=0.01, seed=3)
    qs = [gen.low_s(attr=1) for _ in range(6)]
    out = {}
    for q in (1, 2):
        db = Database(dict(SRC.tables), num_shards=4)
        db.engine.mesh_query_axis = q
        stats = db.execute_batch(qs)
        out[("batch", q)] = (
            [dataclasses.replace(s, wall_s=0.0) for s in stats],
            db.clock_ms, list(db.monitor.records))
        db = Database(dict(SRC.tables))
        gen2 = QueryGen(SRC, selectivity=0.01, seed=5)
        wl = hybrid_workload(gen2, "read_only", total=40, phase_len=20)
        cfg = RunConfig(read_batch_size=8, num_shards=4, mesh=None,
                        mesh_query_axis=q)
        res = run_workload(db, make_dl_tuner(db, "predictive"), wl, cfg)
        out[("run", q)] = ({f.name: getattr(res, f.name)
                            for f in dataclasses.fields(res)
                            if f.name != "wall_s"},
                           db.clock_ms, list(db.monitor.records))
    with open(sys.argv[1], "wb") as fh:
        pickle.dump(out, fh)
    print("REF_MESH_OK")
"""


def _env(n_devices):
    """tests/test_mesh_scan.py's recipe: a fresh process with XLA's
    forced host device count."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_force_host_platform_device_count")]
    flags.append(f"--xla_force_host_platform_device_count={n_devices}")
    env["XLA_FLAGS"] = " ".join(flags)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT, os.path.join(ROOT, "tests")])
    return env


def test_reference_forced_4_device_mesh_subprocess(tmp_path):
    """The reference at ``--xla_force_host_platform_device_count=4``
    against the port under ``force_local_devices([cpu] * 4)``: the
    ExecStats of a 6-query burst (tier ``shard_map``), the clock, the
    monitor records and whole read_only runs on a 4-device and a 2 x 2
    grid, ``execution_tiers`` and latencies included."""
    path = tmp_path / "ref.pkl"
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REF_SCRIPT), str(path)],
        env=_env(4), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "REF_MESH_OK" in proc.stdout
    with open(path, "rb") as fh:
        ref = pickle.load(fh)

    src = port_src(SRC)
    gen = P.QueryGen(src, selectivity=0.01, seed=3)
    qs = [gen.low_s(attr=1) for _ in range(6)]
    with P_mesh.force_local_devices([CPU] * 4):
        for q in (1, 2):
            db = P.Database(dict(port_src(SRC).tables), num_shards=4)
            db.engine.mesh_query_axis = q
            stats = db.execute_batch(qs)
            rstats, rclock, rrecs = ref[("batch", q)]
            assert [dataclasses.astuple(dataclasses.replace(s, wall_s=0.0))
                    for s in stats] == [dataclasses.astuple(s)
                                        for s in rstats]
            assert all(s.tier == "shard_map" for s in stats)
            assert db.clock_ms == rclock
            assert [dataclasses.astuple(r) for r in db.monitor.records] == [
                dataclasses.astuple(r) for r in rrecs]

            db = P.Database(dict(port_src(SRC).tables))
            gen2 = P.QueryGen(src, selectivity=0.01, seed=5)
            wl = P.hybrid_workload(gen2, "read_only", total=40, phase_len=20)
            cfg = P.RunConfig(execution=P.ExecOptions(
                read_batch_size=8, num_shards=4, mesh_query_axis=q))
            res = P.run_workload(db, P.make_dl_tuner(db, "predictive"), wl,
                                 cfg)
            rres, rclock, rrecs = ref[("run", q)]
            for name, want in rres.items():
                if name != "build_pages_per_ms":
                    assert getattr(res, name) == want, (q, name)
            assert res.execution_tiers.get("shard_map", 0) > 0
            assert db.clock_ms == rclock
            assert [dataclasses.astuple(r) for r in db.monitor.records] == [
                dataclasses.astuple(r) for r in rrecs]
