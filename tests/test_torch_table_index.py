"""Parity of the port's table, index and TUNER data generators with
the reference: same numpy inputs, bit-equal tables and indexes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench_db.queries import QueryGen as RefQueryGen
from repro.bench_db.schema import make_tuner_db as ref_make_tuner_db
from repro.core import index as R_ix
from repro.core import table as R_tb
from repro_torch.bench_db.queries import QueryGen
from repro_torch.bench_db.schema import make_tuner_db
from repro_torch.core import index as P_ix
from repro_torch.core import table as P_tb
from repro_torch.core.convert import (
    from_reference,
    index_from_reference,
    table_from_reference,
)

PSZ = 64


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_tables_equal(ref, port):
    for name in ("data", "begin_ts", "end_ts"):
        np.testing.assert_array_equal(_np(getattr(port, name)),
                                      _np(getattr(ref, name)), err_msg=name)
    assert port.n_rows == int(ref.n_rows)


def assert_indexes_equal(ref, port):
    for name in ("key_hi", "key_lo", "rids"):
        np.testing.assert_array_equal(_np(getattr(port, name)),
                                      _np(getattr(ref, name)), err_msg=name)
    assert port.n_entries == int(ref.n_entries)
    assert port.built_pages == int(ref.built_pages)


def _pair(vals, n_pages=None):
    ref = R_tb.load_table(vals, page_size=PSZ, n_pages=n_pages)
    port = P_tb.load_table(vals, page_size=PSZ, n_pages=n_pages,
                           device="cpu")
    return ref, port


def _vals(seed, n=1000, n_attrs=4, vmax=1000):
    rng = np.random.default_rng(seed)
    return rng.integers(1, vmax, size=(n, n_attrs)).astype(np.int32)


def test_load_table_matches_reference():
    ref, port = _pair(_vals(0), n_pages=24)
    assert_tables_equal(ref, port)
    assert (port.n_pages, port.page_size, port.n_attrs, port.capacity) == (
        ref.n_pages, ref.page_size, ref.n_attrs, ref.capacity)


def test_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P_tb.load_table(_vals(0, n=10), page_size=PSZ)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_tuner_db(n_rows=100)


def test_tuner_db_and_queries_match_reference():
    ref = ref_make_tuner_db(n_rows=2000, page_size=PSZ, seed=3)
    port = make_tuner_db(n_rows=2000, page_size=PSZ, seed=3, device="cpu")
    assert_tables_equal(ref.tables["narrow"], port.tables["narrow"])
    np.testing.assert_array_equal(port.quantiles["narrow"],
                                  ref.quantiles["narrow"])
    rg, pg = RefQueryGen(ref, seed=9), QueryGen(port, seed=9)
    for mk in ("low_s", "mod_s", "low_u", "high_u", "ins", "low_s"):
        a, b = getattr(rg, mk)(), getattr(pg, mk)()
        for f in ("kind", "attrs", "los", "his", "agg_attr", "proj_attrs",
                  "set_attrs", "set_vals", "template"):
            assert getattr(a, f) == getattr(b, f), (mk, f)
        if a.rows is not None:
            np.testing.assert_array_equal(a.rows, b.rows)


def test_predicates_and_table_scan_match_reference():
    ref, port = _pair(_vals(1), n_pages=20)
    ref, _ = R_tb.update_rows(ref, (1,), jnp.array([100]), jnp.array([400]),
                              jnp.array([2]), jnp.array([7]), ts=5,
                              max_new=64)
    port, _ = P_tb.update_rows(port, (1,), (100,), (400,), (2,), (7,), ts=5,
                               max_new=64)
    for ts in (0, 4, 5, 9):
        np.testing.assert_array_equal(
            _np(P_tb.visible_mask(port, ts)),
            _np(R_tb.visible_mask(ref, ts)))
        for attrs, los, his in (((1,), (200,), (600,)),
                                ((1, 3), (0, 300), (500, 999))):
            np.testing.assert_array_equal(
                _np(P_tb.conj_predicate_mask(port, attrs, los, his)),
                _np(R_tb.conj_predicate_mask(ref, attrs, jnp.array(los),
                                             jnp.array(his))))
            for from_page in (0, 7):
                r = R_tb.table_scan(ref, attrs, jnp.array(los),
                                    jnp.array(his), ts, 2,
                                    from_page=from_page)
                p = P_tb.table_scan(port, attrs, los, his, ts, 2,
                                    from_page=from_page)
                for a, b in zip(r, p):
                    np.testing.assert_array_equal(_np(b), _np(a))


@pytest.mark.parametrize("n_new,max_new", [(5, 5), (3, 8), (0, 4)])
def test_insert_rows_matches_reference(n_new, max_new):
    ref, port = _pair(_vals(2, n=900), n_pages=16)
    rows = _vals(3, n=max_new)
    ref = R_tb.insert_rows(ref, jnp.asarray(rows), 11, n_new,
                           max_new=max_new)
    port = P_tb.insert_rows(port, torch.from_numpy(rows), 11, n_new)
    assert_tables_equal(ref, port)


def test_insert_rows_keeps_last_slot_where_reference_parks_over_it():
    """The one divergence (ROADMAP.md queue 3 item 1): filling the table
    to capacity while writes are parked.  The reference's parked write
    overwrites the real row in slot capacity-1; the port keeps it."""
    ref, port = _pair(_vals(4, n=1), n_pages=1)  # capacity 64, 1 row
    rows = _vals(5, n=80)
    ref = R_tb.insert_rows(ref, jnp.asarray(rows), 3, 80, max_new=80)
    port = P_tb.insert_rows(port, torch.from_numpy(rows), 3, 80)
    assert port.n_rows == int(ref.n_rows) == 64
    cap = 64
    # Slots 0..62 agree bit for bit.
    for name in ("data", "begin_ts", "end_ts"):
        a = _np(getattr(ref, name)).reshape(cap, -1)[: cap - 1]
        b = _np(getattr(port, name)).reshape(cap, -1)[: cap - 1]
        np.testing.assert_array_equal(b, a)
    # Slot 63: the reference lost the row, the port kept it.
    assert int(_np(ref.begin_ts).reshape(-1)[-1]) == R_tb.NEVER_TS
    assert int(port.begin_ts.reshape(-1)[-1]) == 3
    np.testing.assert_array_equal(port.data.reshape(cap, -1)[-1].numpy(),
                                  rows[cap - 2])


@pytest.mark.parametrize("max_new", [4, 64])
def test_update_rows_matches_reference(max_new):
    """More matches than max_new: both pick the first matches in rid
    order (the reference's stable argsort)."""
    ref, port = _pair(_vals(6, n=1200, vmax=20), n_pages=30)
    for ts, (lo, hi), set_attrs, set_vals in (
        (4, (3, 9), (2, 3), (77, 88)),
        (6, (1, 19), (1,), (5,)),
        (9, (5, 5), (3, 0), (1, 2)),
    ):
        ref, rn = R_tb.update_rows(ref, (1,), jnp.array([lo]),
                                   jnp.array([hi]), jnp.array(set_attrs),
                                   jnp.array(set_vals), ts=ts,
                                   max_new=max_new)
        port, pn = P_tb.update_rows(port, (1,), (lo,), (hi,), set_attrs,
                                    set_vals, ts=ts, max_new=max_new)
        assert pn == int(rn)
        assert_tables_equal(ref, port)


def _index_pair(seed, key_attrs, vmax=6, n=1000, n_pages=20):
    """Tables with many duplicate keys (vmax small), dead versions and
    a partially filled watermark page."""
    ref, port = _pair(_vals(seed, n=n, vmax=vmax), n_pages=n_pages)
    ref, _ = R_tb.update_rows(ref, (2,), jnp.array([1]), jnp.array([2]),
                              jnp.array([1]), jnp.array([3]), ts=2,
                              max_new=40)
    port, _ = P_tb.update_rows(port, (2,), (1,), (2,), (1,), (3,), ts=2,
                               max_new=40)
    return (ref, R_ix.make_index(ref.capacity),
            port, P_ix.make_index(port.capacity, "cpu"))


@pytest.mark.parametrize("key_attrs", [(1,), (1, 2)])
def test_vap_build_steps_match_reference_with_ties(key_attrs):
    rt, ri, pt, pi = _index_pair(7, key_attrs)
    for ppc in (3, 1, 5, 4, 9):  # crosses the watermark page
        ri = R_ix.build_pages_vap(ri, rt, key_attrs, pages_per_cycle=ppc)
        pi = P_ix.build_pages_vap(pi, pt, key_attrs, pages_per_cycle=ppc)
        assert_indexes_equal(ri, pi)
    ri, done_r = R_ix.advance_build(ri, rt, key_attrs, 4)
    pi, done_p = P_ix.advance_build(pi, pt, key_attrs, 4)
    assert done_p == done_r
    assert_indexes_equal(ri, pi)
    assert P_ix.build_pages_remaining(pi, pt) == R_ix.build_pages_remaining(
        ri, rt)


def test_build_full_matches_reference():
    rt, ri, pt, pi = _index_pair(8, (2,))
    assert_indexes_equal(R_ix.build_full(ri, rt, (2,)),
                         P_ix.build_full(pi, pt, (2,)))


@pytest.mark.parametrize("pages,quantum", [(0, 4), (10, None), (10, 3),
                                           (9, 3), (5, 8)])
def test_split_build_pages_matches_reference(pages, quantum):
    assert P_ix.split_build_pages(pages, quantum) == \
        R_ix.split_build_pages(pages, quantum)


@pytest.mark.parametrize("key_attrs", [(1,), (1, 2)])
def test_index_range_scan_matches_reference(key_attrs):
    rt, ri, pt, pi = _index_pair(9, key_attrs, vmax=50)
    ri = R_ix.build_pages_vap(ri, rt, key_attrs, pages_per_cycle=7)
    pi = P_ix.build_pages_vap(pi, pt, key_attrs, pages_per_cycle=7)
    bounds = [(10, 20, 5, 30), (0, 60, -5, 100), (25, 25, 25, 25),
              (30, 10, 0, 0)]
    for lo0, hi0, lo1, hi1 in bounds:
        args = (lo0, hi0) if len(key_attrs) == 1 else (lo0, hi0, lo1, hi1)
        rm, rr = R_ix.index_range_scan(ri, *R_ix.key_range(*args))
        pm, pr = P_ix.index_range_scan(pi, *P_ix.key_range(*args))
        np.testing.assert_array_equal(pm.numpy(), np.asarray(rm))
        np.testing.assert_array_equal(pr.numpy(), np.asarray(rr))
        # The batched binary-search form selects the same positions.
        (lh, ll), (hh, hl) = P_ix.key_range(*args)
        start, stop = P_ix.index_range_bounds(
            pi, P_ix.packed_keys(torch.tensor([lh]), torch.tensor([ll])),
            P_ix.packed_keys(torch.tensor([hh]), torch.tensor([hl])))
        hits = np.flatnonzero(np.asarray(rm))
        assert int(stop[0] - start[0]) == hits.size
        if hits.size:
            assert (int(start[0]), int(stop[0])) == (hits[0], hits[-1] + 1)


def test_packed_keys_order_like_pairs():
    rng = np.random.default_rng(0)
    kh = rng.integers(-(2**31), 2**31, size=500).astype(np.int32)
    kl = rng.integers(-(2**31), 2**31, size=500).astype(np.int32)
    kh[::7] = kh[0]  # ties on the leading component
    packed = P_ix.packed_keys(torch.from_numpy(kh), torch.from_numpy(kl))
    order = torch.sort(packed, stable=True).indices.numpy()
    np.testing.assert_array_equal(order, np.lexsort((kl, kh)))


def test_from_reference_round_trip_copies():
    rt, ri, _, _ = _index_pair(10, (1,))
    ri = R_ix.build_pages_vap(ri, rt, (1,), pages_per_cycle=6)
    tables, indexes = from_reference(
        tables={"t": [np.asarray(x) for x in rt]},
        indexes={"i": [np.asarray(x) for x in ri]}, device="cpu")
    assert_tables_equal(rt, tables["t"])
    assert_indexes_equal(ri, indexes["i"])
    fields = [np.asarray(x) for x in rt]
    t = table_from_reference(fields, device="cpu")
    t.data.zero_()  # port tensors never alias the caller's arrays
    assert fields[0].any()
    assert index_from_reference([np.asarray(x) for x in ri],
                                device="cpu").built_pages == 6
