"""The port's tables are stored attribute-major behind the JAX shape.

Every path that makes or changes a table -- ``make_table``,
``load_table``, ``table_from_reference``, INSERT / UPDATE,
``shard_table``, ``stack_shards``, ``reshard``, ``unshard_table``, the
sharded mutators and a ``Database`` loop with a tuning cycle -- leaves
each plane ``data[..., a]`` one unit-stride run, and
``data.view(-1, n_attrs)`` a view of the same storage (no path quietly
makes a row-major copy).  The index half's row view in
``_probe_stacked`` shares the table's storage, and the stream kernels'
plane check (K1 / K4 on the card) refuses a plane whose row stride is
not 1.  Values are compared with a row-major numpy oracle.
"""

import _torch_threads  # noqa: F401  (first: pins torch's threads)

import numpy as np
import pytest
import torch

import repro.api as R
from repro_torch import api as P
from repro_torch.core import hybrid_scan
from repro_torch.core.convert import from_reference, table_from_reference
from repro_torch.core.executor import Query
from repro_torch.core.table import (
    INF_TS,
    Table,
    attribute_major,
    insert_rows,
    is_attribute_major,
    load_table,
    make_table,
    rows_view,
    shard_table,
    sharded_insert_rows,
    sharded_update_rows,
    stack_shards,
    unshard_table,
    update_rows,
)
from repro_torch.kernels import batched_filter_agg as bfa

PSZ, N_ATTRS = 8, 5


def assert_attribute_major(data):
    """Every plane has row stride 1 and is one unit-stride run, and the
    (rows, n_attrs) view shares the table's storage."""
    assert is_attribute_major(data)
    for a in range(data.shape[-1]):
        plane = data[..., a]
        assert plane.stride(-1) == 1 and plane.is_contiguous(), a
    flat = data.view(-1, data.shape[-1])
    assert flat.data_ptr() == data.data_ptr()
    assert flat.untyped_storage().data_ptr() == \
        data.untyped_storage().data_ptr()


def _values(n, seed=0, n_attrs=N_ATTRS):
    return np.random.default_rng(seed).integers(
        -1000, 1000, size=(n, n_attrs)).astype(np.int32)


def _check_table(t, values=None):
    assert_attribute_major(t.data)
    assert_attribute_major(t.data[..., :t.n_attrs])
    if values is not None:
        got = t.data.reshape(-1, t.n_attrs)[:len(values)].numpy()
        np.testing.assert_array_equal(got, values)


@pytest.mark.parametrize("lead", [(7,), (3, 5), (1, 1)])
def test_attribute_major_storage_and_public_shape(lead):
    data = attribute_major(lead, PSZ, N_ATTRS, "cpu")
    assert tuple(data.shape) == lead + (PSZ, N_ATTRS)
    assert data.dtype == torch.int32 and not data.any()
    assert_attribute_major(data)
    # plane a is the a-th run of the store
    n = int(np.prod(lead)) * PSZ
    assert [data[..., a].data_ptr() - data.data_ptr() for a in range(
        N_ATTRS)] == [a * n * 4 for a in range(N_ATTRS)]
    # clone / empty_like / to() keep the layout (the tensor is dense)
    assert_attribute_major(data.clone())
    assert_attribute_major(torch.empty_like(data))
    assert_attribute_major(data.to("cpu", copy=True))


def test_make_table_and_load_table():
    _check_table(make_table(6, PSZ, N_ATTRS, device="cpu"))
    vals = _values(37)
    t = load_table(vals, page_size=PSZ, n_pages=9, device="cpu")
    _check_table(t, vals)
    assert t.n_rows == 37 and t.n_pages == 9


def test_table_from_reference_is_attribute_major():
    src = R.make_tuner_db(n_rows=500, page_size=PSZ, seed=3)
    tables, _ = from_reference(
        tables={k: [np.asarray(x) for x in t] for k, t in src.tables.items()},
        device="cpu")
    t = tables["narrow"]
    _check_table(t)
    np.testing.assert_array_equal(t.data.numpy(),
                                  np.asarray(src.tables["narrow"].data))
    # a sharded record (shards, n_rows) becomes one stacked table
    plain = load_table(_values(50), page_size=PSZ, n_pages=8, device="cpu")
    shards = [[x.numpy() for x in (plain.data[s::2], plain.begin_ts[s::2],
                                   plain.end_ts[s::2])] + [24]
              for s in range(2)]
    st = table_from_reference((shards, 50), device="cpu")
    assert_attribute_major(st.data)
    np.testing.assert_array_equal(st.data[1, :4].numpy(),
                                  plain.data[1::2].numpy())


def test_insert_and_update_write_in_place():
    vals = _values(20, seed=1)
    t = load_table(vals, page_size=PSZ, n_pages=8, device="cpu")
    ptr = t.data.data_ptr()
    new = _values(7, seed=2)
    t = insert_rows(t, torch.from_numpy(new), ts=5, n_new=7)
    _check_table(t, np.concatenate([vals, new]))
    t, n_upd = update_rows(t, (1,), (-1000,), (0,), (2,), (77,), ts=9,
                           max_new=4)
    assert n_upd == 4 and t.n_rows == 31
    _check_table(t)
    assert t.data.data_ptr() == ptr  # the same store, written in place
    assert (t.data.reshape(-1, N_ATTRS)[27:31, 2] == 77).all()


@pytest.mark.parametrize("S", [2, 3])
def test_shard_stack_unshard_keep_the_layout(S):
    vals = _values(70, seed=S)
    t = load_table(vals, page_size=PSZ, n_pages=11, device="cpu")
    st = shard_table(t, S)
    assert_attribute_major(st.data)
    for s in range(S):
        assert_attribute_major(st.shard(s).data)
    back = unshard_table(st)
    _check_table(back, vals)
    np.testing.assert_array_equal(back.data.numpy(), t.data.numpy())
    skew = stack_shards([Table(t.data[a:b], t.begin_ts[a:b], t.end_ts[a:b],
                               (b - a) * PSZ)
                         for a, b in ((0, 6), (6, 8), (8, 11))], 70)
    assert_attribute_major(skew.data)
    np.testing.assert_array_equal(skew.data[1, :2].numpy(),
                                  t.data[6:8].numpy())


def test_sharded_mutators_write_in_place():
    t = load_table(_values(50, seed=4), page_size=PSZ, n_pages=12,
                   device="cpu")
    oracle = load_table(_values(50, seed=4), page_size=PSZ, n_pages=12,
                        device="cpu")
    st = shard_table(t, 3)
    ptr = st.data.data_ptr()
    new = torch.from_numpy(_values(9, seed=5))
    st = sharded_insert_rows(st, new, ts=3, n_new=9)
    oracle = insert_rows(oracle, new, ts=3, n_new=9)
    st, n1 = sharded_update_rows(st, (0,), (0,), (500,), (3,), (-5,), ts=8,
                                 max_new=6)
    oracle, n2 = update_rows(oracle, (0,), (0,), (500,), (3,), (-5,), ts=8,
                             max_new=6)
    assert n1 == n2 > 0 and st.data.data_ptr() == ptr
    assert_attribute_major(st.data)
    back = unshard_table(st)
    np.testing.assert_array_equal(back.data.numpy(), oracle.data.numpy())
    np.testing.assert_array_equal(back.end_ts.numpy(), oracle.end_ts.numpy())
    assert (back.begin_ts.reshape(-1)[:oracle.n_rows] < INF_TS).all()


def test_database_loop_keeps_the_layout_through_reshard_and_tuning():
    src = P.make_tuner_db(n_rows=2000, page_size=32, seed=6, device="cpu")
    db = P.Database(dict(src.tables))
    tuner = P.PredictiveTuner(db, P.TunerConfig(pages_per_cycle=8))
    gen = P.QueryGen(src, selectivity=0.02, seed=2)
    for num_shards in (1, 2, 3, 1):
        if num_shards != db.num_shards:
            db.reshard(num_shards)
        for _ in range(2):
            db.execute_batch([gen.low_s(attr=3) for _ in range(4)] +
                             [gen.mod_s(attrs=(1, 2)) for _ in range(4)],
                             use_kernel=True)
            db.execute(gen.low_u())
            db.execute(gen.ins(n=8))
            tuner.tuning_cycle()
        t = db.tables["narrow"]
        assert_attribute_major(t.data)
    assert db.indexes  # the tuner built something on the way


def test_probe_row_view_shares_the_table_storage(monkeypatch):
    """The index half gathers each plane through a (rows, n_attrs) view
    of the stacked table: a view, never a copy."""
    seen = []

    def recording_rows_view(data):
        flat = rows_view(data)
        seen.append(flat.untyped_storage().data_ptr() ==
                    data.untyped_storage().data_ptr())
        return flat

    monkeypatch.setattr(hybrid_scan, "rows_view", recording_rows_view)
    t = load_table(_values(300, seed=7), page_size=PSZ, n_pages=40,
                   device="cpu")
    for num_shards in (1, 3):
        db = P.Database({"narrow": t}, num_shards=num_shards)
        bi = db.create_index(P.IndexDescriptor("narrow", (1,)), "vap")
        db.vap_build_step(bi, pages=20)
        q = Query(kind="scan", table="narrow", attrs=(1,), los=(-200,),
                  his=(300,), agg_attr=2)
        assert db.execute_batch([q, q], use_kernel=False)[0].used_index
        t = unshard_table(db.tables["narrow"]) if num_shards > 1 else t
    assert seen and all(seen)


def test_rows_view_refuses_to_copy():
    row_major = torch.zeros((4, PSZ, N_ATTRS), dtype=torch.int32)
    assert not is_attribute_major(row_major)
    with pytest.raises(RuntimeError):
        rows_view(row_major.permute(1, 0, 2))  # strides that do not merge


def _planes(data, begin, end):
    return (data[..., 1], data[..., 3], data[..., 2], begin, end)


def test_stream_kernels_require_unit_stride_planes():
    """``check_planes`` with ``unit_stride`` -- what every kernel's
    wrapper calls on a CUDA tensor -- accepts the attribute-major planes
    and refuses a plane of a row-major 21-attribute table (row stride
    21), which the plain versions on the CPU still take."""
    am = make_table(6, PSZ, 21, device="cpu")
    good = _planes(am.data, am.begin_ts, am.end_ts)
    bfa.check_planes(good, unit_stride=True)
    stacked = shard_table(am._replace(n_rows=6 * PSZ), 2)
    bfa.check_planes(_planes(stacked.data, stacked.begin_ts,
                             stacked.end_ts), ndim=3, unit_stride=True)
    row_major = torch.zeros((6, PSZ, 21), dtype=torch.int32)
    bad = _planes(row_major, am.begin_ts, am.end_ts)
    bfa.check_planes(bad)  # evenly spaced rows: the plain versions read them
    with pytest.raises(ValueError, match="pred0 has row stride 21"):
        bfa.check_planes(bad, unit_stride=True)
    with pytest.raises(ValueError, match="row stride 21"):
        bfa.check_planes(tuple(x[None] for x in bad), ndim=3,
                         unit_stride=True)
