"""Parity of the port's hybrid scan operators and ScanEngine with the
reference: every single and batched scan form, and
``ScanEngine.scan_batch`` with ``use_kernel`` off and on (the
reference's kernel in Pallas interpret mode, the port's plain K1
version), on mid-build indexes over MVCC tables."""

import _torch_threads  # noqa: F401  (first: pins torch's threads)

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import index as R_ix
from repro.core import table as R_tb
from repro.core.engine import ScanEngine as RefEngine
from repro_torch.core import hybrid_scan as P_hs
from repro_torch.core import index as P_ix
from repro_torch.core.convert import from_reference
from repro_torch.core.engine import ScanEngine
from repro_torch.core.planner import ScanPlan

# ``repro.core`` re-exports a function named hybrid_scan over the module.
R_hs = importlib.import_module("repro.core.hybrid_scan")

PSZ, N_PAGES = 64, 24


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _state(key_attrs, built_pages):
    """A reference table with updated and inserted rows and a VAP index
    built ``built_pages`` pages, and the same state in the port."""
    rng = np.random.default_rng(len(key_attrs) * 100 + built_pages)
    vals = rng.integers(1, 500, size=(1100, 4)).astype(np.int32)
    rt = R_tb.load_table(vals, page_size=PSZ, n_pages=N_PAGES)
    ri = R_ix.make_index(rt.capacity)
    ri = R_ix.build_pages_vap(ri, rt, key_attrs, pages_per_cycle=built_pages)
    rt, _ = R_tb.update_rows(rt, (1,), jnp.array([100]), jnp.array([180]),
                             jnp.array([1, 2]), jnp.array([150, 9]), ts=3,
                             max_new=50)
    rows = rng.integers(1, 500, size=(30, 4)).astype(np.int32)
    rt = R_tb.insert_rows(rt, jnp.asarray(rows), 5, 30, max_new=30)
    tables, indexes = from_reference(
        tables={"t": [np.asarray(x) for x in rt]},
        indexes={"i": [np.asarray(x) for x in ri]}, device="cpu")
    return rt, ri, tables["t"], indexes["i"]


def _queries(seed, attrs, B=6):
    rng = np.random.default_rng(seed)
    los = rng.integers(1, 450, size=(B, len(attrs))).astype(np.int32)
    his = (los + rng.integers(0, 120, size=(B, len(attrs)))).astype(np.int32)
    tss = rng.choice([2, 4, 6], size=B).astype(np.int32)
    return los, his, tss


STATES = [((1,), 0), ((1,), 7), ((1,), 16), ((1, 2), 9), ((1, 2), 16)]


def _assert_same(ref, port, fields):
    for f in fields:
        np.testing.assert_array_equal(_np(getattr(port, f)),
                                      _np(getattr(ref, f)), err_msg=f)


@pytest.mark.parametrize("key_attrs,built", STATES)
def test_single_query_scans_match_reference(key_attrs, built):
    rt, ri, pt, pi = _state(key_attrs, built)
    los, his, tss = _queries(1, (1, 2))
    fields = R_hs.ScanResult._fields
    for q in range(3):
        for attrs in ((1,), (1, 2)):
            lo, hi = los[q, : len(attrs)], his[q, : len(attrs)]
            args = (attrs, jnp.asarray(lo), jnp.asarray(hi), int(tss[q]), 3)
            pargs = (attrs, tuple(lo.tolist()), tuple(hi.tolist()),
                     int(tss[q]), 3)
            if attrs[0] == key_attrs[0]:
                _assert_same(
                    R_hs.hybrid_scan(rt, ri, key_attrs, *args),
                    P_hs.hybrid_scan(pt, pi, key_attrs, *pargs), fields)
                _assert_same(
                    R_hs.pure_index_scan(rt, ri, key_attrs, *args),
                    P_hs.pure_index_scan(pt, pi, key_attrs, *pargs), fields)
            _assert_same(R_hs.full_table_scan(rt, *args),
                         P_hs.full_table_scan(pt, *pargs), fields)


@pytest.mark.parametrize("key_attrs,built", STATES)
@pytest.mark.parametrize("attrs", [(1,), (1, 2)])
def test_batched_scans_match_reference(key_attrs, built, attrs):
    rt, ri, pt, pi = _state(key_attrs, built)
    los, his, tss = _queries(2 + built, attrs)
    r_in = (jnp.asarray(los), jnp.asarray(his), jnp.asarray(tss))
    p_in = (torch.from_numpy(los), torch.from_numpy(his),
            torch.from_numpy(tss))
    fields = R_hs.BatchScanResult._fields
    _assert_same(R_hs.batched_full_table_scan(rt, attrs, *r_in, 3),
                 P_hs.batched_full_table_scan(pt, attrs, *p_in, 3), fields)
    _assert_same(
        R_hs.batched_hybrid_scan(rt, ri, key_attrs, attrs, *r_in, 3),
        P_hs.batched_hybrid_scan(pt, pi, key_attrs, attrs, *p_in, 3),
        fields)
    _assert_same(
        R_hs.batched_pure_index_scan(rt, ri, key_attrs, attrs, *r_in, 3),
        P_hs.batched_pure_index_scan(pt, pi, key_attrs, attrs, *p_in, 3),
        fields)
    _assert_same(
        R_hs.batched_hybrid_index_prefix(rt, ri, key_attrs, attrs, *r_in, 3),
        P_hs.batched_hybrid_index_prefix(pt, pi, key_attrs, attrs, *p_in, 3),
        R_hs.HybridPrefixResult._fields)


def test_hybrid_scan_returns_each_row_once():
    """Exactly-once: index prefix + table suffix partition the matches
    (contrib is 0/1 and equals the full-scan mask)."""
    _, _, pt, pi = _state((1,), 9)
    for q in range(4):
        los, his, tss = _queries(30 + q, (1,), B=1)
        args = ((1,), tuple(los[0].tolist()), tuple(his[0].tolist()),
                int(tss[0]), 3)
        h = P_hs.hybrid_scan(pt, pi, (1,), *args)
        f = P_hs.full_table_scan(pt, *args)
        assert int(h.contrib.max()) <= 1
        assert torch.equal(h.contrib, f.contrib)
        assert (int(h.agg_sum), int(h.count)) == (int(f.agg_sum),
                                                  int(f.count))


class _Bi:
    def __init__(self, key_attrs):
        from repro_torch.core.cost_model import IndexDescriptor

        self.desc = IndexDescriptor("t", key_attrs)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("path", ["table", "hybrid", "pure_vap"])
@pytest.mark.parametrize("key_attrs,built", [((1,), 10), ((1, 2), 16)])
def test_scan_batch_matches_reference_engine(use_kernel, path, key_attrs,
                                             built):
    rt, ri, pt, pi = _state(key_attrs, built)
    attrs = (1, 2)
    los, his, tss = _queries(7, attrs, B=5)
    ref = RefEngine().scan_batch(
        rt, path, ri, key_attrs, attrs, jnp.asarray(los), jnp.asarray(his),
        jnp.asarray(tss), 3, use_kernel=use_kernel)
    eng = ScanEngine()
    port = eng.scan_batch(
        pt, path, pi, key_attrs, attrs, torch.from_numpy(los),
        torch.from_numpy(his), torch.from_numpy(tss), 3,
        use_kernel=use_kernel)
    _assert_same(ref, port, R_hs.BatchScanResult._fields)
    kernel_path = use_kernel and path in ("table", "hybrid")
    assert eng.last_tier == ("kernel" if kernel_path else "single")
    assert eng.last_tier in eng.TIERS + ("single",)


def test_engine_single_scan_and_unported_paths():
    rt, ri, pt, pi = _state((1,), 8)
    eng = ScanEngine()
    plan = ScanPlan("hybrid", _Bi((1,)), pinned_state=pi)
    los, his = (50,), (200,)
    r = RefEngine().scan(rt, _ref_plan(ri), (1,), jnp.array(los),
                         jnp.array(his), 6, 3)
    p = eng.scan(pt, plan, (1,), los, his, 6, 3)
    _assert_same(r, p, R_hs.ScanResult._fields)
    assert eng.last_tier == "single"
    # The masked stitch is ported: single (no kernel, as in the
    # reference) and batched dispatches, kernel tier off and on.
    built = np.zeros(N_PAGES, bool)
    built[[0, 1, 2, 5, 6, 11]] = True
    rcov, pcov = R_ix.PageCoverage(N_PAGES, PSZ), P_ix.PageCoverage(
        N_PAGES, PSZ, device="cpu")
    for cov in (rcov, pcov):
        cov.set_pages(np.flatnonzero(built))
    rview, pview = rcov.view(1, N_PAGES), pcov.view(1, N_PAGES)
    ref_plan = _ref_plan(ri)
    ref_plan = type(ref_plan)("hybrid_masked", ref_plan.index,
                              pinned_state=ri, pinned_coverage=rview)
    plan = ScanPlan("hybrid_masked", _Bi((1,)), pinned_state=pi,
                    pinned_coverage=pview)
    r = RefEngine().scan(rt, ref_plan, (1,), jnp.array(los),
                         jnp.array(his), 6, 3)
    p = eng.scan(pt, plan, (1,), los, his, 6, 3)
    _assert_same(r, p, R_hs.ScanResult._fields)
    assert eng.last_tier == "single"
    blos, bhis, btss = _queries(4, (1,))
    for use_kernel, tier in ((False, "single"), (True, "kernel")):
        r = RefEngine().scan_batch(rt, "hybrid_masked", ri, (1,), (1,),
                                   blos, bhis, btss, 3,
                                   use_kernel=use_kernel, coverage=rview)
        p = eng.scan_batch(pt, "hybrid_masked", pi, (1,), (1,),
                           torch.from_numpy(blos), torch.from_numpy(bhis),
                           torch.from_numpy(btss), 3,
                           use_kernel=use_kernel, coverage=pview)
        _assert_same(r, p, R_hs.BatchScanResult._fields)
        assert eng.last_tier == tier
    # ``hybrid_ps`` is ported: on a plain table (no shards) it is the
    # hybrid scan, as in the reference.  So is ``pure_vbp``: the pure
    # index scan over the entries it is handed, as in the reference.
    for use_kernel, tier in ((False, "single"), (True, "kernel")):
        r = RefEngine().scan_batch(rt, "hybrid_ps", ri, (1,), (1,), blos,
                                   bhis, btss, 3, use_kernel=use_kernel)
        p = eng.scan_batch(pt, "hybrid_ps", pi, (1,), (1,),
                           torch.from_numpy(blos), torch.from_numpy(bhis),
                           torch.from_numpy(btss), 3, use_kernel=use_kernel)
        _assert_same(r, p, R_hs.BatchScanResult._fields)
        assert eng.last_tier == tier
    for use_kernel in (False, True):
        r = RefEngine().scan_batch(rt, "pure_vbp", ri, (1,), (1,), blos,
                                   bhis, btss, 3, use_kernel=use_kernel)
        p = eng.scan_batch(pt, "pure_vbp", pi, (1,), (1,),
                           torch.from_numpy(blos), torch.from_numpy(bhis),
                           torch.from_numpy(btss), 3, use_kernel=use_kernel)
        _assert_same(r, p, R_hs.BatchScanResult._fields)
        assert eng.last_tier == "single"
    vbp_plan = ScanPlan("pure_vbp", _Bi((1,)), pinned_state=pi)
    r = RefEngine().scan(rt, type(ref_plan)("pure_vbp", ref_plan.index,
                                            pinned_state=ri), (1,),
                         jnp.array(los), jnp.array(his), 6, 3)
    p = eng.scan(pt, vbp_plan, (1,), los, his, 6, 3)
    _assert_same(r, p, R_hs.ScanResult._fields)
    # Sharded storage is ported (tests/test_torch_sharded.py); anything
    # else is no table.
    with pytest.raises(TypeError):
        eng.scan_batch(object(), "table", None, (), (1,), None, None, None,
                       3)


def _ref_plan(ri):
    from repro.core.cost_model import IndexDescriptor
    from repro.core.planner import BuiltIndex
    from repro.core.planner import ScanPlan as RefPlan

    bi = BuiltIndex(desc=IndexDescriptor("t", (1,)), scheme="vap", vap=ri)
    return RefPlan("hybrid", bi, pinned_state=ri)
