"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown,
                                     # tables in build/profile/

Phases, each asserted (any failure exits non-zero):

1. Device: the card's name and power limit; build the CUDA kernels
   (K1, K2) from ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a.
2. Kernels against their plain PyTorch versions on the card at the
   paper's table size (58,594 pages x 256 rows, columns read in place
   out of a 21-attribute table, MVCC gaps, values that wrap int32),
   B in {1, 8, 32} with mixed start pages: bit-equal, timed.
3. The main path at the paper's scale: ``make_tuner_db(10M rows)`` on
   the card in two databases from one seed.  Both take the same read
   bursts (16 LOW-S / MOD-S scans at 1% selectivity), UPDATE / INSERT
   statements and one ``PredictiveTuner.tuning_cycle`` per burst; one
   runs ``execute_batch(use_kernel=True)`` (K1), its twin the plain
   PyTorch path.  Every ExecStats field but wall_s and tier must agree,
   K1 must have been launched once per kernel dispatch, and the results
   must match a numpy brute-force scan.  The engine never launches K2
   (nor does the reference's): after the counted run, K2's adapters
   (``kernels.ops.scan_table`` / ``scan_table_hybrid``) are held to the
   same numpy scan and to K1 on the final table.

Prints one JSON line per measurement, then the card line, the kernels
line and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero
without a result when no CUDA device is present or the port's sources
are missing.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# int32 ALU issue rate: 132 SMs x 64 INT32 lanes x 1.98 GHz (Hopper
# white paper).  The scan's compares and adds are int32 instructions.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_ROW_QUERY = 9  # 4 range + 2 visibility + 1 page compares, 2 adds

N_ROWS = 10_000_000  # the paper's table size (TUNER narrow)
PAGE_SIZE = 256
N_BURSTS = 10
PAGES_PER_CYCLE = 2048  # ~half of the 39,062 full pages over the run
BURST_LOW_S, BURST_MOD_S = 8, 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n=25, warm=3) -> float:
    """Median device time of ``fn`` in ms (CUDA events per call)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def scan_bound(n_pages, page_size, n_planes, start_pages):
    """(bytes, bound_ms, bound_by) of a filter-aggregate whose queries
    start at ``start_pages``: each input plane read once from the
    smallest start page on, per-query operands read once, outputs
    written once; each query does its work on its own suffix only."""
    def rows_from(p):
        return max(n_pages - max(int(p), 0), 0) * page_size

    B = len(start_pages)
    rows = rows_from(min(start_pages))
    nbytes = rows * 4 * n_planes + B * 6 * 4 + B * 2 * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(rows_from(p) for p in start_pages) * OPS_PER_ROW_QUERY \
        / INT32_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return nbytes, max(t_bytes, t_ops), by


def phase_kernels(torch, bfa, fa, dev):
    """Phase 2: K1/K2 against their plain versions at full size."""
    import numpy as np

    n_pages, psz, n_attrs = 58_594, PAGE_SIZE, 21
    rng = np.random.default_rng(12)
    data = torch.from_numpy(rng.integers(
        -(2**31), 2**31, size=(n_pages, psz, n_attrs), dtype=np.int64
    ).astype(np.int32)).to(dev)
    begin = torch.from_numpy(
        rng.integers(0, 100, size=(n_pages, psz)).astype(np.int32)).to(dev)
    end = torch.from_numpy(np.where(
        rng.random((n_pages, psz)) < 0.3,
        rng.integers(50, 200, size=(n_pages, psz)), 2**31 - 1,
    ).astype(np.int32)).to(dev)
    begin.view(-1)[-psz * 100:] = 2**31 - 1  # unoccupied headroom
    planes = (data[..., 3], data[..., 1], data[..., 2], begin, end)
    results = {}
    for B in (1, 8, 32):
        lo0 = rng.integers(-(2**31), 2**30, size=B)
        q = [lo0, lo0 + 2**30, np.full(B, -(2**31)), np.full(B, 2**31 - 1),
             rng.integers(0, 200, size=B),
             rng.integers(0, n_pages + 100, size=B)]
        if B > 1:
            q[5][0] = 0  # one full scan in every batch
        qt = [torch.tensor(x.astype(np.int32), device=dev) for x in q]
        before = bfa.launches
        ks, kc = bfa.batched_filter_agg(*planes, *qt)
        torch.cuda.synchronize()
        assert bfa.launches == before + 1
        ps, pc = bfa.batched_filter_agg_plain(*planes, *qt)
        err = int(max((ks.long() - ps.long()).abs().max(),
                      (kc.long() - pc.long()).abs().max()))
        assert torch.equal(ks, ps) and torch.equal(kc, pc), (B, err)
        n0 = bfa.launches
        k_ms = cuda_ms(lambda: bfa.batched_filter_agg(*planes, *qt))
        p_ms = cuda_ms(lambda: bfa.batched_filter_agg_plain(*planes, *qt),
                       n=5, warm=1)
        nbytes, bound, by = scan_bound(n_pages, psz, 5, q[5].tolist())
        row = dict(phase="kernel", kernel="K1", B=B, kernel_ms=k_ms,
                   plain_ms=p_ms, bytes_moved=nbytes, bound_ms=bound,
                   bound_by=by, launches=bfa.launches - n0,
                   max_abs_err=err, equal=True)
        emit(row)
        results[("K1", B)] = row
        if B == 1:
            args = [int(x[0]) for x in q[:5]]
            start = int(q[5][0])
            s2, c2 = fa.filter_agg(*planes, *args, start_page=start)
            torch.cuda.synchronize()
            p2 = fa.filter_agg_plain(*planes, *args, start_page=start)
            err2 = max(abs(int(s2) - int(p2[0])), abs(int(c2) - int(p2[1])))
            assert err2 == 0 and (int(s2), int(c2)) == (int(ks[0]),
                                                        int(kc[0]))
            n0 = fa.launches
            k_ms = cuda_ms(lambda: fa.filter_agg(*planes, *args,
                                                 start_page=start))
            p_ms = cuda_ms(lambda: fa.filter_agg_plain(
                *planes, *args, start_page=start), n=5, warm=1)
            nbytes, bound, by = scan_bound(n_pages, psz, 5, [start])
            row = dict(phase="kernel", kernel="K2", B=1, kernel_ms=k_ms,
                       plain_ms=p_ms, bytes_moved=nbytes, bound_ms=bound,
                       bound_by=by, launches=fa.launches - n0,
                       max_abs_err=err2, equal=True)
            emit(row)
            results[("K2", 1)] = row
    del data, begin, end, planes
    torch.cuda.empty_cache()
    return results


def numpy_scan(table, q, ts):
    """Brute-force SUM/COUNT of one scan query over a host copy."""
    import numpy as np

    cols = {a: table.data[:, :, a].cpu().numpy()
            for a in set(q.attrs) | {q.agg_attr}}
    b = table.begin_ts.cpu().numpy()
    e = table.end_ts.cpu().numpy()
    mask = (b <= ts) & (ts < e)
    for a, lo, hi in zip(q.attrs, q.los, q.his):
        mask &= (cols[a] >= lo) & (cols[a] <= hi)
    s = int(cols[q.agg_attr][mask].astype(np.int64).sum())
    return (s + 2**31) % 2**32 - 2**31, int(mask.sum())


def phase_main_path(torch, bfa, fa, dev, profile):
    """Phase 3: the predictive-indexing loop at 10M rows on the card."""
    from repro_torch.api import (Database, PredictiveTuner, QueryGen,
                                 TunerConfig, make_tuner_db)
    from repro_torch.core.table import Table
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    tdb = make_tuner_db(n_rows=N_ROWS, page_size=PAGE_SIZE, device=dev)
    src = tdb.tables["narrow"]
    twin_tables = {"narrow": Table(src.data.clone(), src.begin_ts.clone(),
                                   src.end_ts.clone(), src.n_rows)}
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    emit(dict(phase="load", rows=N_ROWS, pages=src.n_pages,
              page_size=PAGE_SIZE, attrs=src.n_attrs, seconds=load_s,
              table_bytes=src.data.numel() * 4))
    dbk, dbp = Database(dict(tdb.tables)), Database(twin_tables)
    cfg = dict(storage_budget_bytes=200e6, pages_per_cycle=PAGES_PER_CYCLE,
               max_build_pages_per_cycle=PAGES_PER_CYCLE)
    tuners = (PredictiveTuner(dbk, TunerConfig(**cfg)),
              PredictiveTuner(dbp, TunerConfig(**cfg)))
    gen = QueryGen(tdb, selectivity=0.01, seed=11)

    starts = []  # per kernel dispatch: max start_page of the group
    orig = dbk.engine.scan_batch

    def recording_scan_batch(*a, **k):
        r = orig(*a, **k)
        starts.append(r.start_page.max())
        return r

    dbk.engine.scan_batch = recording_scan_batch
    fields = ("cost_units", "latency_ms", "used_index", "agg_sum", "count",
              "rows_modified", "populate_units", "shard_pages")
    bfa.launches = 0
    fa.launches = 0  # counts from here on are the main path's
    expected_k1, hybrid_groups = 0, 0
    tk, tp = [], []  # per-burst wall seconds of each twin
    torch.cuda.reset_peak_memory_stats()
    for burst in range(N_BURSTS):
        scans = [gen.low_s(attr=3) for _ in range(BURST_LOW_S)] + [
            gen.mod_s(attrs=(1, 2)) for _ in range(BURST_MOD_S)]
        muts = [gen.low_u(), gen.ins(n=16)]
        groups = {}
        for q in scans:
            plan = dbk.planner.plan_scan(q)
            groups[(tuple(q.attrs), q.agg_attr) + plan.group_key] = plan
        expected_k1 += sum(p.path in ("table", "hybrid")
                           for p in groups.values())
        hybrid_groups += sum(p.path == "hybrid" for p in groups.values())
        n_before = len(starts)
        # The twins take turns going first, so neither alone pays the
        # first use of an operator.
        order = ((dbk, True), (dbp, False))
        if burst % 2:
            order = order[::-1]
        for db, use_kernel in order:
            t1 = time.perf_counter()
            out = db.execute_batch(scans, use_kernel=use_kernel)
            torch.cuda.synchronize()
            (tk if use_kernel else tp).append(time.perf_counter() - t1)
            if use_kernel:
                sk = out
            else:
                sp = out
        for i, (a, b) in enumerate(zip(sk, sp)):
            ka = tuple(getattr(a, f) for f in fields)
            kb = tuple(getattr(b, f) for f in fields)
            assert ka == kb, (burst, i, ka, kb)
            assert a.tier == "kernel", (burst, i, a.tier)
        mk = dbk.execute_batch(muts, use_kernel=True)
        mp = dbp.execute_batch(muts, use_kernel=False)
        for a, b in zip(mk, mp):
            assert tuple(getattr(a, f) for f in fields) == tuple(
                getattr(b, f) for f in fields)
        assert dbk.clock_ms == dbp.clock_ms
        wk = tuners[0].tuning_cycle()
        wp = tuners[1].tuning_cycle()
        assert wk == wp and sorted(dbk.indexes) == sorted(dbp.indexes)
        built = {n: b.vap.built_pages for n, b in dbk.indexes.items()}
        emit(dict(phase="burst", burst=burst, kernel_s=tk[-1],
                  plain_s=tp[-1], used_index=sum(s.used_index for s in sk),
                  max_start_page=max(
                      [int(x) for x in starts[n_before:]], default=0),
                  build_work=wk, built_pages=built))
    # The main path's counts.  The engine launches K2 nowhere (nor does
    # the reference's); K2 is held to K1 and numpy below, off the count.
    k1_launches, k2_launches = bfa.launches, fa.launches
    peak = torch.cuda.max_memory_allocated()
    assert k1_launches == expected_k1 > 0, (k1_launches, expected_k1)
    assert hybrid_groups > 0
    stitch = max(int(x) for x in starts)
    assert stitch > 0, "no hybrid stitch past page 0"
    # The repo's own oracle: a brute-force scan of the final table, which
    # K1 (through the engine) and K2 (through its adapters) must equal.
    table = dbk.tables["narrow"]
    for q in (gen.low_s(attr=3), gen.mod_s(attrs=(1, 2))):
        ts = dbk.clock_ms_i32()
        sk = dbk.execute_batch([q], use_kernel=True)[0]
        want = numpy_scan(table, q, ts)
        assert (sk.agg_sum, sk.count) == want
        s2, c2 = ops.scan_table(table, q.attrs, q.los, q.his, ts, q.agg_attr)
        assert (int(s2), int(c2)) == want
        s2, c2 = ops.scan_table_hybrid(table, q.attrs, q.los, q.his, ts,
                                       q.agg_attr, start_page=stitch)
        s1, c1 = ops.scan_table_batched(
            table, q.attrs, [q.los], [q.his], [ts], q.agg_attr,
            start_pages=[stitch])
        assert (int(s2), int(c2)) == (int(s1[0]), int(c1[0]))
    assert fa.launches == k2_launches + 4  # the adapters reached K2
    emit(dict(phase="main_path", bursts=N_BURSTS,
              scans_per_burst=len(scans),
              kernel_bursts_per_s=N_BURSTS / sum(tk),
              plain_bursts_per_s=N_BURSTS / sum(tp),
              kernel_median_burst_ms=statistics.median(tk) * 1e3,
              plain_median_burst_ms=statistics.median(tp) * 1e3,
              kernel_s=sum(tk), plain_s=sum(tp), k1_launches=k1_launches,
              k2_launches=k2_launches, hybrid_groups=hybrid_groups,
              indexes=sorted(dbk.indexes), peak_bytes=peak))
    emit(dict(phase="scale", reduced=[],
              note=f"{N_ROWS} rows x {src.n_attrs} attrs, page_size "
                   f"{PAGE_SIZE}, {src.n_pages} pages: the paper's size; "
                   f"depth {N_BURSTS} bursts"))
    if profile:
        profile_bursts(torch, dbk, dbp, gen)
    return k1_launches, k2_launches


def device_busy_us(prof):
    """Microseconds in which the card ran at least one kernel, memcpy or
    memset: the union of the trace's device activity intervals."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("aten::")
                   and not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_bursts(torch, dbk, dbp, gen):
    """Device time by kernel name for one burst of each twin."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = ROOT / "build" / "profile"
    out.mkdir(parents=True, exist_ok=True)
    for name, db, use_kernel in (("kernel", dbk, True),
                                 ("plain", dbp, False)):
        scans = [gen.low_s(attr=3) for _ in range(BURST_LOW_S)] + [
            gen.mod_s(attrs=(1, 2)) for _ in range(BURST_MOD_S)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            db.execute_batch(scans, use_kernel=use_kernel)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy_ms = device_busy_us(prof) / 1e3
        wall_ms = wall * 1e3
        assert 0 < busy_ms <= wall_ms, (name, busy_ms, wall_ms)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("aten::")
                   and not getattr(e, "is_user_annotation", False)]
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
        (out / f"profile_{name}.txt").write_text(
            prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=40))
        emit(dict(phase="profile", twin=name, wall_ms=wall_ms,
                  device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
                  kernel_ms_sum=sum(e.self_device_time_total
                                    for e in kernels) / 1e3,
                  top=[(e.key[:60], e.self_device_time_total / 1e3, e.count)
                       for e in top]))


def main(argv) -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: the port's sources (src/repro_torch) are "
              "missing; run it from the root of a checkout",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import batched_filter_agg as bfa
    from repro_torch.kernels import filter_agg as fa

    dev = torch.device("cuda", 0)
    card = card_line()
    t0 = time.perf_counter()
    _build.library()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              nvcc_seconds=_build.BUILD_INFO.get("seconds"),
              library=Path(_build.BUILD_INFO["path"]).name,
              ptxas=[ln for ln in _build.BUILD_INFO.get("log", "").splitlines()
                     if "registers" in ln]))
    emit(dict(phase="device", card=card, name=torch.cuda.get_device_name(0),
              torch=torch.__version__, cuda=torch.version.cuda))

    kr = phase_kernels(torch, bfa, fa, dev)
    k1_launches, k2_launches = phase_main_path(torch, bfa, fa, dev,
                                               "--profile" in argv)

    k1, k2 = kr[("K1", 8)], kr[("K2", 1)]
    kernels = [
        dict(name="K1 batched_filter_agg", route="cuda",
             source="src/repro_torch/kernels/csrc/filter_agg.cu",
             replaces="src/repro/kernels/batched_filter_agg.py:163",
             launches=k1_launches,
             max_abs_err=max(kr[("K1", b)]["max_abs_err"]
                             for b in (1, 8, 32)),
             ms=k1["kernel_ms"], plain_ms=k1["plain_ms"],
             bound_ms=k1["bound_ms"], bound_by=k1["bound_by"],
             library_ms=None),
        dict(name="K2 filter_agg", route="cuda",
             source="src/repro_torch/kernels/csrc/filter_agg.cu",
             replaces="src/repro/kernels/filter_agg.py:103",
             launches=k2_launches, max_abs_err=k2["max_abs_err"],
             ms=k2["kernel_ms"], plain_ms=k2["plain_ms"],
             bound_ms=k2["bound_ms"], bound_by=k2["bound_by"],
             library_ms=None),
    ]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
