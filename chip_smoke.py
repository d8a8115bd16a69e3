"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of
                                     # one burst of phases 3, 5, 7(a)
                                     # and 7(c), tables in
                                     # build/profile/, and the device
                                     # time of the index half's gathers

Phases, each asserted (any failure exits non-zero):

1. Device: the card's name and power limit; build the CUDA kernels
   (K1, K2, K3, K4) from ``src/repro_torch/kernels/csrc`` with nvcc
   for sm_90a.
2. Kernels against their plain PyTorch versions on the card at the
   paper's table size (58,594 pages x 256 rows, column planes of a
   21-attribute table stored attribute-major as the port stores every
   table, MVCC gaps, values that wrap int32), B in {1, 8, 32} with
   mixed start pages: bit-equal, timed, with each time's share of its
   bound.  Each kernel row carries three times: ``kernel_ms``, the
   event time of one call from an idle card (the wrapper's host work
   included; ``event_floor`` is that time for no work), ``device_ms``,
   the call's device work alone, and ``host_ms``, the host clock's time
   of the call.
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
4. K3 (the masked scan) against its plain version at phase 2's size,
   B in {1, 8, 16, 32}, under an empty, a prefix, a scattered, a runs
   (every other window of 512 pages, the shape of phase 5's hot
   windows) and a full coverage bitmap, plus one stacked S = 4 launch
   with ragged real page counts and 14,645 pages per shard (not a
   multiple of 32): bit-equal; a prefix of length L also equals K1 with
   start_pages = L, and the full bitmap returns zeros.  The launch's
   work items (coverage words) and grid are printed first.  Timed on
   the scattered bitmap at B = 8 (the ``kernels`` line), the full one
   at B = 8 and the runs one at B = 16 (phase 5's burst); the K3 and K1
   wrappers' host times are then taken alternating in one window
   (``masked_host``).
5. The masked main path at the paper's 10M rows: a clustered table
   (attribute 1 is the row id, as in the reference's
   ``benchmarks/crack_on_scan.py``) in two databases from one seed, with
   ``crack_on_scan`` on.  Phased hot windows (width 512 on attribute 1)
   in bursts of 16 scans, one decide / apply tuning cycle per burst
   (hot-range page lists); the K3 twin runs ``execute_batch(
   use_kernel=True)``, the plain twin the plain path.  Every ExecStats
   field but wall_s and tier, the clock, the quanta and the coverage
   bits agree; at least one burst plans ``hybrid_masked`` with a bitmap
   that is not a prefix; K3's launches equal the masked kernel groups;
   crack adoption charged populate units; a numpy scan of the final
   table equals the K3 twin's answers.
6. K4 (the sharded scan) against its plain version: phase 2's table
   sharded round-robin over S = 4 (14,649 / 14,649 / 14,648 / 14,648
   local pages), B in {1, 8, 16, 32}, with zero local starts, the
   global stitch 19,531 mapped to local pages, divergent per-shard
   starts and starts past ``local_pages``; then the reference
   benchmark's 36/4/4/4 skewed layout at the paper's scale (29,295 +
   3 x 3,255 pages).  Bit-equal everywhere; zero starts and the mapped
   global stitch equal K1 on the unsharded table, one shard equals K1,
   starts past the real pages return zeros.  The B = 8 cases (among
   them the global stitch, starts past ``local_pages`` and the skewed
   zero starts) are summed up on one ``sharded_kernel_b8`` line.
7. The sharded main path at 10M rows, a K4 twin against a plain twin:
   (a) phase 3's workload on ``Database(..., num_shards=4)`` -- every
   stats field, the tuning work and the clock equal phase 3's, burst
   for burst, and two scans per burst equal a numpy scan; (b) the
   skewed table adopted as is, with per-shard builds
   (``vap_build_step(shard=)``), so the scans plan ``hybrid_ps`` and K4
   takes per-shard local starts; every scan equals numpy; (c) phase 5's
   crack-on-scan loop on 4 round-robin shards at reduced depth (K3 at
   S = 4).  K4 launches once per sharded table / hybrid group, K3 once
   per masked group; K1 and K2 never.
8. The closed loop: ``run_workload`` through the port on fig10's
   ``hybrid_workload`` (1,000 queries in two phases of 500, 1%
   selectivity, read bursts of 8) over phase 3's 10M-row table, at the
   paper's scale (1e-6 simulated ms per tuple touch, so a scan costs
   ~10 ms, and the FAST frequency of 100 ms).  Each arm is a kernel twin
   (``use_kernel``) against a plain twin on tables from one seed: (a) 1
   shard, the predictive tuner at FAST and DIS, on ``read_only`` and
   ``read_heavy`` (K1); (b) 4 round-robin shards, shard-aware tuning
   off, equal to (a) field for field (K4); (c) 4 shards, shard-aware
   (K4, ``hybrid_ps``); (d) phase 7(b)'s skewed table, read-only,
   shard-aware off and on, the reference's ``benchmarks/shard_tuning.py``
   with its tuner budgets scaled to the table (K4); (e) 1 shard with
   crack-on-scan and decay (K3).  Every RunResult field but wall_s and
   execution_tiers agrees between the twins; each arm's kernel launches
   its kernel and the plain twin none; in (b) and (c) every fifth
   statement that is a scan equals a numpy scan of the rows live at its
   snapshot.  Prints each twin's summary, tiers and wall_s, DIS / FAST
   for (a) and queries to converge for (d).
9. The paper's baselines through ``run_workload`` on phase 3's table
   at phase 8's scale, each arm a kernel twin against a plain twin with
   every fifth scan held to a numpy scan (a join's pair count to a
   numpy pair count): (a) fig7's ``segments_workload``, the predictive
   tuner against ``HolisticTuner`` with fig7's budgets scaled to the
   rows and its tuning interval, client cadence and monitor horizon to
   one table scan (holistic / predictive cumulative time, the largest
   scan-segment latency over a table scan, the indexes left); (b)
   ``OnlineTuner`` (its FULL build cycle's work and wall time; scans
   its complete FULL index answers alone are held to the index's built
   pages, the reference's rule), ``AdaptiveTuner`` and ``SmixTuner``
   (a budget of half an index, so it drops) on phase 8's read_heavy
   workload; (c) HIGH-S joins
   (``affinity_workload(template="high_s")``) under the predictive
   tuner on 1 and 4 round-robin shards, equal field for field, ending
   with an index on the join attribute 4; (d) ``AdaptiveTuner`` on 4
   shards (sharded VBP), equal to (b)'s 1-shard run.  K1 (K4 on
   shards) launches in every kernel twin, none in the plain twins, and
   the twins' index states are equal.
10. The async build lane, the open-loop front end and single-engine
   faults through ``run_workload`` on phase 3's table at phase 8's
   scale, each arm a kernel twin against a plain twin equal in every
   simulated field (all but wall_s, execution_tiers and
   build_pages_per_ms, with no escalated drain: its size reads the wall
   clock), configured from the repo's benchmarks with budgets and page
   counts x rows / 20,000 and intervals, cadences, deadlines and SLOs x
   one table scan's ratio (5): (a) ``benchmarks/async_tuning.py``
   (read_only, phases of 100, bursts of 8) serialized and
   deterministic, equal field for field, on 1 shard (K1) and 4
   round-robin shards (K4), 4 equal to 1; (b) its overlap run, results
   equal to (a)'s, with each run's charged and overlapped build time,
   p99 and cumulative latency; (c) ``benchmarks/serving_slo.py``'s
   ``fixed_always`` and ``deadline_throttle`` on one bursty stream (p99,
   p999, miss rate, deferrals, shed quanta); (d)
   ``benchmarks/fault_recovery.py``'s transient categories (no outage)
   on (c)'s throttled stream in overlap mode: a zero-fault schedule
   equal to none in every field, recovery on and off with results
   equal to the fault-free run's, the fault counters; (e) overlap with
   crack-on-scan on phase 8(e)'s configuration (K3).  Every fifth scan
   of (a)'s 1-shard serialized run, (c)'s fixed run and (e) is held to
   numpy; every other arm's results are held equal to one of them.

Prints one JSON line per measurement (with each phase's peak device
memory), then the card line, the kernels line and, last, ``{"ok":
true, "device": {...}}``.  Exits non-zero
without a result when no CUDA device is present or the port's sources
are missing.
"""

from __future__ import annotations

import gc
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
# Phase 5: 16-scan bursts of the shifting hot-range workload; 64 pages
# per cycle plus crack adoption cover ~2,000 of the 39,062 full pages,
# so the index is still building at the end.
N_MASKED_BURSTS = 12
MASKED_BURST = 16
MASKED_PHASE_LEN = 48  # scans per hot window (3 bursts)
MASKED_PAGES_PER_CYCLE = 64
RUN_PAGES = 512  # phase 4's runs bitmap: every other window of 512 pages
# Phase 7: the skewed 36/4/4/4 layout at the paper's scale (whole pages
# of 256 rows: 9,999,360 rows), and the depth of the sharded loops.
SKEW_PAGES = (29_295, 3_255, 3_255, 3_255)
SKEW_BURSTS = 4
SHARDED_MASKED_BURSTS = 6
# Phase 8: the closed loop (run_workload) on fig10's hybrid workload.  A
# 10M-row scan costs ~10 simulated ms at 1e-6 ms per tuple touch (the
# paper's scale), so FAST (100 ms) fires about one cycle per burst.
LOOP_TOTAL, LOOP_PHASE_LEN, LOOP_BATCH = 1_000, 500, 8
LOOP_UNIT_MS = 1e-6
LOOP_CHECK_EVERY = 5  # (b), (c): every fifth statement against numpy
# (d): benchmarks/shard_tuning.py's tuner sizes its per-cycle budget
# (8 pages) and storage (50 MB) for a 48-page table; both scale with
# the table, so convergence stays a few cycles long as it is there.
BENCH_SKEW_PAGES, BENCH_CYCLE_PAGES, BENCH_STORAGE = 48, 8, 50e6
CONVERGED_FRACTION = 0.98  # benchmarks/shard_tuning.py
# Phase 9: the paper's baselines at phase 8's scale.  fig7's benchmark
# runs a 20,000-row table; its storage and build budgets scale with the
# rows, its tuning interval, client cadence and monitor horizon with one
# table scan's simulated latency.  fig7 runs the benchmark's 400
# statements per segment, the other arms phase 8's 1,000 statements.
FIG7_ROWS = 20_000
FIG7_SEG_LEN = 400
JOIN_NOISE = 0.2  # (c): LOW-S scans that batch, between the joins
SMIX_BUDGET = 12.0 * N_ROWS / 2  # half a full index: forces LRU drops
# Phase 10: the build lane, the open loop and faults.  The repo's
# benchmarks (async_tuning, serving_slo, fault_recovery) run 20,000-row
# tables at 1e-4 ms per tuple touch: budgets and page counts scale with
# the rows, times with one table scan's simulated latency (x5).
LANE_BENCH_ROWS, LANE_BENCH_UNIT_MS = 20_000, 1e-4
LANE_TOTAL = 1_200  # the benchmarks' depth
LANE_ASYNC_PHASE_LEN = 100   # benchmarks/async_tuning.py
LANE_SERVING_PHASE_LEN = 150  # benchmarks/serving_slo.py
LANE_FAULT_QUEUE_CAP = 1_024  # (d): past the deepest queue


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# Cycles the card spins before each timed kernel call (~1 ms at the
# H100's 1.98 GHz), so that the host has enqueued the whole call before
# the card reaches it.
AHEAD_CYCLES = 2_000_000


def cuda_ms(fn, n=25, warm=3, ahead=False, host=None) -> float:
    """Median time of ``fn`` in ms between CUDA events recorded around
    each call.  Without ``ahead`` the card is idle when the call starts,
    so the time includes the host's work to enqueue it (the call time,
    ``kernel_ms``); with ``ahead`` the card first spins ``AHEAD_CYCLES``
    while the host enqueues, so the events time the call's device work
    alone (``device_ms``).  ``host``, a list, receives the host clock's
    ms of each call."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if ahead:
            torch.cuda._sleep(AHEAD_CYCLES)
        a.record()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        if host is not None:
            host.append((t1 - t0) * 1e3)
    return statistics.median(times)


def kernel_ms(fn) -> tuple:
    """(call ms, device ms, host ms) of a kernel wrapper call: the event
    time of one call from an idle card, the wrapper's host work
    included; its device work alone; and the host clock's time of the
    call from an idle card, the wrapper's part of the call time."""
    host = []
    call = cuda_ms(fn, host=host)
    return call, cuda_ms(fn, ahead=True), statistics.median(host)


HOST_PAIR_CALLS = 200


def host_ms_pair(**fns) -> dict:
    """Median host-clock ms of each wrapper call in ``fns``, the calls
    alternating, each from an idle card: ``{name}_host_ms``."""
    import torch

    times = {name: [] for name in fns}
    for i in range(HOST_PAIR_CALLS * len(fns)):
        name = list(fns)[i % len(fns)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[name]()
        times[name].append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return {f"{name}_host_ms": statistics.median(t)
            for name, t in times.items()}


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


def kernel_table(torch, dev):
    """Phases 2, 4 and 6: the paper's table size (58,594 pages x 256
    rows x 21 attributes) with values that wrap int32 sums, MVCC gaps
    and an unoccupied tail, stored as the port stores every table
    (attribute-major, ``core.table.attribute_major``) so that the
    kernels read the planes the main path reads; returns (data,
    begin_ts, end_ts) on ``dev`` and the generator, whose stream phase
    2 continues for its queries."""
    import numpy as np

    from repro_torch.core.table import attribute_major, is_attribute_major

    n_pages, psz, n_attrs = 58_594, PAGE_SIZE, 21
    rng = np.random.default_rng(12)
    data = attribute_major((n_pages,), psz, n_attrs, dev)
    for a in range(n_attrs):  # one plane at a time: no row-major copy
        data[..., a].copy_(torch.from_numpy(rng.integers(
            -(2**31), 2**31, size=(n_pages, psz), dtype=np.int64
        ).astype(np.int32)))
    assert is_attribute_major(data)
    begin = torch.from_numpy(
        rng.integers(0, 100, size=(n_pages, psz)).astype(np.int32)).to(dev)
    end = torch.from_numpy(np.where(
        rng.random((n_pages, psz)) < 0.3,
        rng.integers(50, 200, size=(n_pages, psz)), 2**31 - 1,
    ).astype(np.int32)).to(dev)
    begin.view(-1)[-psz * 100:] = 2**31 - 1  # unoccupied headroom
    return data, begin, end, rng


def phase_kernels(torch, bfa, fa, tab):
    """Phase 2: K1/K2 against their plain versions at full size."""
    import numpy as np

    data, begin, end, rng = tab
    dev = data.device
    n_pages, psz, _ = data.shape
    planes = (data[..., 3], data[..., 1], data[..., 2], begin, end)
    # The call time of nothing: two events recorded on an idle card, the
    # floor under every kernel_ms.
    emit(dict(phase="event_floor", kernel_ms=cuda_ms(lambda: None)))
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
        k_ms, d_ms, h_ms = kernel_ms(
            lambda: bfa.batched_filter_agg(*planes, *qt))
        p_ms = cuda_ms(lambda: bfa.batched_filter_agg_plain(*planes, *qt),
                       n=5, warm=1)
        nbytes, bound, by = scan_bound(n_pages, psz, 5, q[5].tolist())
        row = dict(phase="kernel", kernel="K1", B=B, kernel_ms=k_ms,
                   device_ms=d_ms, host_ms=h_ms, plain_ms=p_ms,
                   bytes_moved=nbytes, bound_ms=bound, bound_by=by,
                   share_of_bound=bound / k_ms,
                   device_share_of_bound=bound / d_ms,
                   launches=bfa.launches - n0, max_abs_err=err, equal=True)
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
            k_ms, d_ms, h_ms = kernel_ms(lambda: fa.filter_agg(
                *planes, *args, start_page=start))
            p_ms = cuda_ms(lambda: fa.filter_agg_plain(
                *planes, *args, start_page=start), n=5, warm=1)
            nbytes, bound, by = scan_bound(n_pages, psz, 5, [start])
            row = dict(phase="kernel", kernel="K2", B=1, kernel_ms=k_ms,
                       device_ms=d_ms, host_ms=h_ms, plain_ms=p_ms,
                       bytes_moved=nbytes, bound_ms=bound, bound_by=by,
                       share_of_bound=bound / k_ms,
                       device_share_of_bound=bound / d_ms,
                       launches=fa.launches - n0, max_abs_err=err2,
                       equal=True)
            emit(row)
            results[("K2", 1)] = row
    return results


def pack_words(torch, built, dev):
    """(S, W) int32 packed little-endian coverage words of a (S,
    n_pages) bool bitmap (bit p & 31 of word p >> 5 is page p)."""
    import numpy as np

    S, n = built.shape
    W = -(-n // 32)
    bits = np.pad(built, ((0, 0), (0, W * 32 - n))).astype(np.uint32)
    words = (bits.reshape(S, W, 32) << np.arange(32, dtype=np.uint32)).sum(
        axis=2, dtype=np.uint32)
    return torch.from_numpy(words.view(np.int32)).to(dev)


def masked_bound(n_uncovered, page_size, n_queries, n_words):
    """(bytes, bound_ms, bound_by) of K3: the five planes of the
    uncovered real pages read once, the coverage words and per-query
    operands read once, outputs written once; every query does its
    work on every uncovered row."""
    rows = n_uncovered * page_size
    nbytes = rows * 4 * 5 + n_words * 4 + n_queries * 5 * 4 \
        + n_queries * 2 * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = rows * n_queries * OPS_PER_ROW_QUERY / INT32_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return nbytes, max(t_bytes, t_ops), by


def phase_masked_kernel(torch, bfa, tab):
    """Phase 4: K3 against its plain version (and K1 on prefixes) at
    full size."""
    import numpy as np

    from repro_torch.core.index import PageCoverage

    data, begin, end, _ = tab
    dev = data.device
    n_pages, psz, _ = data.shape
    rng = np.random.default_rng(14)
    planes = (data[..., 3], data[..., 1], data[..., 2], begin, end)
    planes3 = tuple(x[None] for x in planes)
    local = torch.tensor([n_pages], dtype=torch.int32, device=dev)
    prefix = n_pages // 3
    items, grid = bfa.masked_launch_shape(dev, 1, n_pages)
    items4, grid4 = bfa.masked_launch_shape(dev, 4, n_pages // 4 - 3)
    emit(dict(phase="masked_kernel_launch", S=1, pages=n_pages,
              work_items=items, grid=grid, S4_work_items=items4,
              S4_grid=grid4))
    covers = {}
    for name, pages in (("empty", []), ("prefix", range(prefix)),
                        ("scattered", np.flatnonzero(
                            rng.random(n_pages) < 0.5)),
                        # phase 5's shape: hot windows of 512 pages
                        ("runs", np.flatnonzero(
                            np.arange(n_pages) // RUN_PAGES % 2 == 0)),
                        ("full", range(n_pages))):
        cov = PageCoverage(n_pages, psz, dev)
        cov.set_pages(list(pages))
        covers[name] = (cov.packed_words(1, n_pages), cov.count())
    errs, timed = [], None
    for B in (1, 8, 16, 32):  # 16: the masked path's burst (phase 5)
        lo0 = rng.integers(-(2**31), 2**30, size=B)
        q = [lo0, lo0 + 2**30, np.full(B, -(2**31)), np.full(B, 2**31 - 1),
             rng.integers(0, 200, size=B)]
        qt = [torch.tensor(x.astype(np.int32), device=dev) for x in q]
        for name, (words, n_cov) in covers.items():
            before = bfa.masked_launches
            ks, kc = bfa.sharded_batched_filter_agg_masked(
                *planes3, *qt, words, local)
            torch.cuda.synchronize()
            assert bfa.masked_launches == before + 1
            ps, pc = bfa.sharded_batched_filter_agg_masked_plain(
                *planes3, *qt, words, local)
            err = int(max((ks.long() - ps.long()).abs().max(),
                          (kc.long() - pc.long()).abs().max()))
            assert torch.equal(ks, ps) and torch.equal(kc, pc), (B, name, err)
            errs.append(err)
            if name == "prefix":
                starts = torch.full((B,), prefix, dtype=torch.int32,
                                    device=dev)
                s1, c1 = bfa.batched_filter_agg(*planes, *qt, starts)
                assert torch.equal(ks, s1) and torch.equal(kc, c1), B
            if name == "full":
                assert not kc.any() and not ks.any(), B
            row = dict(phase="masked_kernel", kernel="K3", S=1, B=B,
                       cover=name, covered_pages=n_cov, equal=True,
                       max_abs_err=err)
            if (B, name) in ((8, "scattered"), (8, "full"), (16, "runs")):
                n0 = bfa.masked_launches
                (row["kernel_ms"], row["device_ms"],
                 row["host_ms"]) = kernel_ms(
                    lambda: bfa.sharded_batched_filter_agg_masked(
                        *planes3, *qt, words, local))
                row["plain_ms"] = cuda_ms(
                    lambda: bfa.sharded_batched_filter_agg_masked_plain(
                        *planes3, *qt, words, local), n=5, warm=1)
                nbytes, bound, by = masked_bound(n_pages - n_cov, psz, B,
                                                 words.numel())
                row.update(bytes_moved=nbytes, bound_ms=bound, bound_by=by,
                           share_of_bound=bound / row["kernel_ms"],
                           device_share_of_bound=bound / row["device_ms"],
                           launches=bfa.masked_launches - n0)
                if name == "scattered":
                    timed = row
                    k3_call = (qt, words)
            emit(row)
    # The K3 and K1 wrappers' host times in one window, alternating (the
    # per-row host_ms of calls timed minutes apart drift by up to 2x).
    qt, words = k3_call
    zero = torch.zeros((8,), dtype=torch.int32, device=dev)
    pair = host_ms_pair(
        K3=lambda: bfa.sharded_batched_filter_agg_masked(*planes3, *qt,
                                                         words, local),
        K1=lambda: bfa.batched_filter_agg(*planes, *qt, zero))
    emit(dict(phase="masked_host", B=8, calls=HOST_PAIR_CALLS, **pair))
    # Stacked shards: S = 4 of n_pages // 4 - 3 pages (14,645: not a
    # multiple of 32), ragged real page counts, a scattered bitmap per
    # shard.
    S = 4
    n_s = n_pages // 4 - 3
    d4 = data[: S * n_s].view(S, n_s, psz, -1)
    stacked = (d4[..., 3], d4[..., 1], d4[..., 2],
               begin[: S * n_s].view(S, n_s, psz),
               end[: S * n_s].view(S, n_s, psz))
    words = pack_words(torch, rng.random((S, n_s)) < 0.4, dev)
    local4 = torch.tensor([n_s, n_s - n_s // 20, n_s - n_s // 9,
                           n_s * 5 // 8], dtype=torch.int32, device=dev)
    qt = [torch.tensor(x.astype(np.int32), device=dev) for x in (
        np.full(8, -(2**30)), np.full(8, 2**30), np.full(8, -(2**31)),
        np.full(8, 2**31 - 1), rng.integers(0, 200, size=8))]
    before = bfa.masked_launches
    ks, kc = bfa.sharded_batched_filter_agg_masked(*stacked, *qt, words,
                                                   local4)
    torch.cuda.synchronize()
    assert bfa.masked_launches == before + 1
    ps, pc = bfa.sharded_batched_filter_agg_masked_plain(*stacked, *qt,
                                                         words, local4)
    err = int(max((ks.long() - ps.long()).abs().max(),
                  (kc.long() - pc.long()).abs().max()))
    assert torch.equal(ks, ps) and torch.equal(kc, pc), err
    errs.append(err)
    emit(dict(phase="masked_kernel", kernel="K3", S=S, B=8,
              pages_per_shard=n_s, local_pages=local4.tolist(),
              cover="scattered", equal=True, max_abs_err=err))
    timed["max_abs_err"] = max(errs)
    return timed


def sharded_bound(local_pages, page_size, starts):
    """(bytes, bound_ms, bound_by) of K4 with the (S, B) local
    ``starts``: each shard's five planes read once over its real pages
    at or past its smallest local start, the per-query operands, the
    start table and ``local_pages`` read once, outputs written once;
    each query does its work on its own rows only."""
    S, B = starts.shape

    def rows(s, p):
        return max(local_pages[s] - max(int(p), 0), 0) * page_size

    read = sum(rows(s, starts[s].min()) for s in range(S))
    nbytes = read * 4 * 5 + B * 5 * 4 + S * B * 4 + S * 4 + B * 2 * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    work = sum(rows(s, starts[s, q]) for s in range(S) for q in range(B))
    t_ops = work * OPS_PER_ROW_QUERY / INT32_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return nbytes, max(t_bytes, t_ops), by


def k4_case(torch, bfa, planes, q, starts, local, label, timed):
    """Launch K4 once, hold it to its plain version (bit-equal), and
    time both when ``timed``; returns the measurement row."""
    before = bfa.sharded_launches
    ks, kc = bfa.sharded_batched_filter_agg(*planes, *q, starts, local)
    torch.cuda.synchronize()
    assert bfa.sharded_launches == before + 1
    ps, pc = bfa.sharded_batched_filter_agg_plain(*planes, *q, starts,
                                                  local)
    err = int(max((ks.long() - ps.long()).abs().max(),
                  (kc.long() - pc.long()).abs().max()))
    assert torch.equal(ks, ps) and torch.equal(kc, pc), (label, err)
    lp = local.tolist()
    nbytes, bound, by = sharded_bound(lp, planes[0].shape[2],
                                      starts.cpu().numpy())
    row = dict(phase="sharded_kernel", kernel="K4", B=starts.shape[1],
               local_pages=lp, max_abs_err=err, equal=True,
               bytes_moved=nbytes, bound_ms=bound, bound_by=by, **label)
    n0 = bfa.sharded_launches
    row["kernel_ms"], row["device_ms"], row["host_ms"] = kernel_ms(
        lambda: bfa.sharded_batched_filter_agg(*planes, *q, starts, local))
    row["share_of_bound"] = bound / row["kernel_ms"]
    row["device_share_of_bound"] = bound / row["device_ms"]
    row["launches"] = bfa.sharded_launches - n0
    if timed:
        row["plain_ms"] = cuda_ms(
            lambda: bfa.sharded_batched_filter_agg_plain(
                *planes, *q, starts, local), n=3, warm=1)
    emit(row)
    return row, (ks, kc)


def phase_sharded_kernel(torch, bfa, tab):
    """Phase 6: K4 against its plain version at full size -- phase 2's
    table sharded round-robin over S = 4 (local pages 14,649 / 14,649 /
    14,648 / 14,648) for B in {1, 8, 16, 32} under four kinds of local
    starts, the reference benchmark's 36/4/4/4 skewed layout at the
    paper's scale, and the identities S = 1 == K1 and zero starts == a
    full scan."""
    import numpy as np

    from repro_torch.core.table import Table, shard_table, stack_shards

    data, begin, end, _ = tab
    dev = data.device
    n_pages, psz, _ = data.shape
    rng = np.random.default_rng(16)
    flat = (data[..., 3], data[..., 1], data[..., 2], begin, end)
    st = shard_table(Table(data, begin, end, n_pages * psz), 4)
    S = st.n_shards
    local = st.local_pages_tensor()
    planes = (st.data[..., 3], st.data[..., 1], st.data[..., 2],
              st.begin_ts, st.end_ts)
    stitch = n_pages // 3  # 19,531: the prefix of phase 4
    sid = np.arange(S)[:, None]
    lp = np.array(st.local_pages)[:, None]
    rows, errs, headline, b8 = [], [], None, {}
    for B in (1, 8, 16, 32):
        lo0 = rng.integers(-(2**31), 2**30, size=B)
        q = [lo0, lo0 + 2**30, np.full(B, -(2**31)), np.full(B, 2**31 - 1),
             rng.integers(0, 200, size=B)]
        qt = [torch.tensor(x.astype(np.int32), device=dev) for x in q]
        kinds = {
            "zero": np.zeros((S, B)),
            "global_stitch": np.maximum(
                (stitch - sid + S - 1) // S, 0).repeat(B, 1),
            "divergent": rng.integers(0, lp, size=(S, B)),
            "past_local_pages": lp + rng.integers(0, 50, size=(S, B)),
        }
        for kind, starts in kinds.items():
            starts = torch.tensor(starts.astype(np.int32), device=dev)
            row, (ks, kc) = k4_case(torch, bfa, planes, qt, starts, local,
                                    dict(layout="round_robin", S=S,
                                         starts=kind), timed=B == 8)
            rows.append(row)
            errs.append(row["max_abs_err"])
            if kind in ("zero", "global_stitch"):  # the unsharded table
                g = torch.full((B,), 0 if kind == "zero" else stitch,
                               dtype=torch.int32, device=dev)
                s1, c1 = bfa.batched_filter_agg(*flat, *qt, g)
                assert torch.equal(ks, s1) and torch.equal(kc, c1), kind
            if kind == "past_local_pages":
                assert not kc.any() and not ks.any(), B
            if B == 8:
                b8[kind] = row
                if kind == "global_stitch":
                    headline = row
        # S = 1 is K1: one shard of the unsharded planes, mixed starts.
        one = torch.tensor(rng.integers(0, n_pages + 100, size=(1, B)).astype(
            np.int32), device=dev)
        k4 = bfa.sharded_batched_filter_agg(
            *[x[None] for x in flat], *qt, one,
            torch.tensor([n_pages], dtype=torch.int32, device=dev))
        k1 = bfa.batched_filter_agg(*flat, *qt, one[0])
        assert all(torch.equal(a, b) for a, b in zip(k4, k1)), B
    del st, planes
    torch.cuda.empty_cache()
    # The reference's 36/4/4/4 layout (benchmarks/shard_tuning.py) at the
    # paper's scale, cut to whole pages: 29,295 + 3 x 3,255 pages.
    counts = list(SKEW_PAGES)
    edges = np.cumsum([0] + counts)
    skew = stack_shards([Table(data[a:b], begin[a:b], end[a:b], 0)
                         for a, b in zip(edges[:-1], edges[1:])], 0)
    splanes = (skew.data[..., 3], skew.data[..., 1], skew.data[..., 2],
               skew.begin_ts, skew.end_ts)
    slocal = skew.local_pages_tensor()
    B = 8
    lo0 = rng.integers(-(2**31), 2**30, size=B)
    q = [lo0, lo0 + 2**30, np.full(B, -(2**31)), np.full(B, 2**31 - 1),
         rng.integers(0, 200, size=B)]
    qt = [torch.tensor(x.astype(np.int32), device=dev) for x in q]
    head = [x[: edges[-1]] for x in flat]
    cl = np.array(counts)[:, None]
    for kind, starts in (("zero", np.zeros((4, B))),
                         ("divergent", rng.integers(0, cl, size=(4, B)))):
        starts = torch.tensor(starts.astype(np.int32), device=dev)
        row, (ks, kc) = k4_case(torch, bfa, splanes, qt, starts, slocal,
                                dict(layout="skewed_36_4_4_4", S=4,
                                     starts=kind), timed=True)
        errs.append(row["max_abs_err"])
        b8[f"skewed_{kind}"] = row
        if kind == "zero":  # padding tiles skipped, padding invisible
            s1, c1 = bfa.batched_filter_agg(
                *head, *qt, torch.zeros(B, dtype=torch.int32, device=dev))
            assert torch.equal(ks, s1) and torch.equal(kc, c1)
    del skew, splanes
    torch.cuda.empty_cache()
    emit(dict(phase="sharded_kernel_b8", cases={
        k: dict(kernel_ms=r["kernel_ms"], device_ms=r["device_ms"],
                host_ms=r["host_ms"], bound_ms=r["bound_ms"],
                share_of_bound=r["share_of_bound"],
                device_share_of_bound=r["device_share_of_bound"],
                plain_ms=r.get("plain_ms"))
        for k, r in b8.items()}))
    headline["max_abs_err"] = max(errs)
    return headline


def numpy_scan(table, q, ts):
    """Brute-force SUM/COUNT of one scan query over a host copy of a
    ``Table`` or a ``ShardedTable`` (padding pages are invisible)."""
    return numpy_answer(host_columns(table, q.attrs + (q.agg_attr,)), q, ts)


def host_columns(table, attrs):
    """Host copies of the columns ``attrs`` and the MVCC planes of a
    ``Table`` or ``ShardedTable``, flattened to rows."""
    out = {a: table.data[..., a].reshape(-1).cpu().numpy()
           for a in set(attrs)}
    out["begin"] = table.begin_ts.reshape(-1).cpu().numpy()
    out["end"] = table.end_ts.reshape(-1).cpu().numpy()
    return out


def numpy_mask(cols, q, ts, rows=None):
    """Rows of host columns that scan ``q`` returns at snapshot ``ts``
    (among ``rows``, a bool mask, when given)."""
    mask = (cols["begin"] <= ts) & (ts < cols["end"])
    if rows is not None:
        mask &= rows
    for a, lo, hi in zip(q.attrs, q.los, q.his):
        mask &= (cols[a] >= lo) & (cols[a] <= hi)
    return mask


def numpy_answer(cols, q, ts, rows=None):
    import numpy as np

    mask = numpy_mask(cols, q, ts, rows)
    s = int(cols[q.agg_attr][mask].astype(np.int64).sum())
    return (s + 2**31) % 2**32 - 2**31, int(mask.sum())


def numpy_pairs(cols, q, ts, inner, rows=None):
    """Brute-force pair count of a HIGH-S join (a self-join of the table
    the columns come from): the scan's rows (among ``rows``) against
    ``inner``, the rows live at ``ts`` counted per join value
    (``np.bincount``), on ``join_attr == join_inner_attr``."""
    import numpy as np

    outer = cols[q.join_attr][numpy_mask(cols, q, ts, rows)]
    per_value = np.bincount(outer, minlength=inner.size)[:inner.size]
    return int(np.dot(per_value.astype(np.int64), inner))


def clone_table(t):
    """A copy of a ``Table`` (or ``ShardedTable``) on its device."""
    return t._replace(data=t.data.clone(), begin_ts=t.begin_ts.clone(),
                      end_ts=t.end_ts.clone())


FIELDS = ("cost_units", "latency_ms", "used_index", "agg_sum", "count",
          "rows_modified", "populate_units", "shard_pages")


def stats_key(s):
    return tuple(getattr(s, f) for f in FIELDS)


def twin_burst(torch, dbk, dbp, queries, burst):
    """One burst through both twins, in turns (neither alone pays the
    first use of an operator): the kernel twin with ``use_kernel``, its
    twin on the plain path.  Every stats field but wall_s / tier must
    agree and every kernel-twin scan must report the kernel tier.
    Returns (kernel twin stats, kernel seconds, plain seconds)."""
    order = ((dbk, True), (dbp, False))
    if burst % 2:
        order = order[::-1]
    out, secs = {}, {}
    for db, use_kernel in order:
        t1 = time.perf_counter()
        out[use_kernel] = db.execute_batch(queries, use_kernel=use_kernel)
        torch.cuda.synchronize()
        secs[use_kernel] = time.perf_counter() - t1
    for i, (a, b) in enumerate(zip(out[True], out[False])):
        assert stats_key(a) == stats_key(b), (burst, i, a, b)
        if queries[i].kind == "scan":
            assert a.tier == "kernel", (burst, i, a.tier)
    assert dbk.clock_ms == dbp.clock_ms
    return out[True], secs[True], secs[False]


def kernel_groups(db, scans, paths):
    """Plan groups of a burst (as ``execute_batch`` forms them) whose
    path is in ``paths``; returns (count, plans)."""
    groups = {}
    for q in scans:
        plan = db.planner.plan_scan(q)
        groups[(tuple(q.attrs), q.agg_attr) + plan.group_key] = plan
    return sum(p.path in paths for p in groups.values()), list(
        groups.values())


def prefix_loop(torch, dbk, dbp, tdb, tag, count_launches, oracle=False):
    """The phase-3 workload on two twin databases: N_BURSTS bursts of
    BURST_LOW_S LOW-S (attr 3) and BURST_MOD_S MOD-S (attrs 1, 2) scans
    at 1% selectivity, then one LOW-U and one 16-row INS, then one
    tuning cycle per twin.  ``count_launches`` reads the launch counter
    of the kernel the table and hybrid groups take; it must grow by one
    per such group.  With ``oracle`` two scans of every burst are also
    held to a numpy scan of the table as the burst saw it.  Returns the
    per-burst record of every stats field, the timings and counts."""
    from repro_torch.api import PredictiveTuner, QueryGen, TunerConfig

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
    launches0 = count_launches()
    expected, paths, record, tk, tp, checked = 0, [], [], [], [], 0
    for burst in range(N_BURSTS):
        scans = [gen.low_s(attr=3) for _ in range(BURST_LOW_S)] + [
            gen.mod_s(attrs=(1, 2)) for _ in range(BURST_MOD_S)]
        muts = [gen.low_u(), gen.ins(n=16)]
        n, plans = kernel_groups(dbk, scans, ("table", "hybrid",
                                              "hybrid_ps"))
        expected += n
        paths += [p.path for p in plans]
        n_before = len(starts)
        if oracle:
            ts = dbk.clock_ms_i32()
            cols = host_columns(dbk.tables["narrow"], (1, 2, 3))
        sk, k_s, p_s = twin_burst(torch, dbk, dbp, scans, burst)
        tk.append(k_s)
        tp.append(p_s)
        if oracle:
            for i in (0, BURST_LOW_S):
                assert (sk[i].agg_sum, sk[i].count) == numpy_answer(
                    cols, scans[i], ts), (tag, burst, i)
                checked += 1
        mk, _, _ = twin_burst(torch, dbk, dbp, muts, burst)
        wk = tuners[0].tuning_cycle()
        wp = tuners[1].tuning_cycle()
        assert wk == wp and sorted(dbk.indexes) == sorted(dbp.indexes)
        record.append(([stats_key(s) for s in sk + mk], wk, dbk.clock_ms))
        built = {n: b.vap.built_pages for n, b in dbk.indexes.items()}
        emit(dict(phase=f"{tag}_burst", burst=burst, kernel_s=k_s,
                  plain_s=p_s, used_index=sum(s.used_index for s in sk),
                  max_start_page=max(
                      [int(x) for x in starts[n_before:]], default=0),
                  build_work=wk, built_pages=built))
    launches = count_launches() - launches0
    assert launches == expected > 0, (tag, launches, expected)
    assert "hybrid" in paths or "hybrid_ps" in paths, paths
    stitch = max(int(x) for x in starts)
    assert stitch > 0, "no hybrid stitch past page 0"
    return dict(record=record, tk=tk, tp=tp, launches=launches,
                paths=paths, stitch=stitch, gen=gen, numpy_checks=checked)


def phase_main_path(torch, bfa, fa, dev, profile):
    """Phase 3: the predictive-indexing loop at 10M rows on the card."""
    from repro_torch.api import Database, TunerDB, make_tuner_db
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    tdb = make_tuner_db(n_rows=N_ROWS, page_size=PAGE_SIZE, device=dev)
    src = tdb.tables["narrow"]
    twin_tables = {"narrow": clone_table(src)}
    # Phase 7 starts from the same table: keep an untouched copy (the
    # numpy generator takes most of a minute for 10M Zipf rows).
    initial = TunerDB(tables={"narrow": clone_table(src)},
                      quantiles=tdb.quantiles, n_rows=N_ROWS, rng=None)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    emit(dict(phase="load", rows=N_ROWS, pages=src.n_pages,
              page_size=PAGE_SIZE, attrs=src.n_attrs, seconds=load_s,
              table_bytes=src.data.numel() * 4))
    dbk, dbp = Database(dict(tdb.tables)), Database(twin_tables)
    bfa.launches = 0
    fa.launches = 0  # counts from here on are the main path's
    torch.cuda.reset_peak_memory_stats()
    run = prefix_loop(torch, dbk, dbp, tdb, "main", lambda: bfa.launches)
    # The main path's counts.  The engine launches K2 nowhere (nor does
    # the reference's); K2 is held to K1 and numpy below, off the count.
    k1_launches, k2_launches = bfa.launches, fa.launches
    peak = torch.cuda.max_memory_allocated()
    assert k1_launches == run["launches"]
    stitch, gen = run["stitch"], run["gen"]
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
    tk, tp = run["tk"], run["tp"]
    emit(dict(phase="main_path", bursts=N_BURSTS,
              scans_per_burst=BURST_LOW_S + BURST_MOD_S,
              kernel_bursts_per_s=N_BURSTS / sum(tk),
              plain_bursts_per_s=N_BURSTS / sum(tp),
              kernel_median_burst_ms=statistics.median(tk) * 1e3,
              plain_median_burst_ms=statistics.median(tp) * 1e3,
              kernel_s=sum(tk), plain_s=sum(tp), k1_launches=k1_launches,
              k2_launches=k2_launches,
              hybrid_groups=run["paths"].count("hybrid"),
              indexes=sorted(dbk.indexes), peak_bytes=peak))
    emit(dict(phase="scale", reduced=[],
              note=f"{N_ROWS} rows x {src.n_attrs} attrs, page_size "
                   f"{PAGE_SIZE}, {src.n_pages} pages: the paper's size; "
                   f"depth {N_BURSTS} bursts"))
    if profile:
        profile_bursts(torch, dbk, dbp, "main", lambda: [
            gen.low_s(attr=3) for _ in range(BURST_LOW_S)] + [
            gen.mod_s(attrs=(1, 2)) for _ in range(BURST_MOD_S)])
    return k1_launches, k2_launches, run["record"], initial


def make_clustered_table(n_rows, page_size, n_attrs=21, headroom=1.5,
                         seed=11, device=None):
    """The TUNER 'narrow' table with attribute 1 as the clustered key
    (ascending row id, so page p holds values (p * page_size, (p + 1) *
    page_size]): zone maps prune perfectly and a hot value window is a
    hot page range.  A copy of the reference's ``benchmarks/
    crack_on_scan.py:make_clustered_db`` at any width and headroom."""
    import numpy as np

    from repro_torch.core.table import load_table

    rng = np.random.default_rng(seed)
    rowid = np.arange(1, n_rows + 1, dtype=np.int32)[:, None]
    vals = np.concatenate(
        [rowid, rowid,
         rng.integers(1, 1_000_000, size=(n_rows, n_attrs - 2),
                      dtype=np.int32)], axis=1)
    n_pages = int(np.ceil(n_rows / page_size * headroom))
    return load_table(vals, page_size=page_size, n_pages=n_pages,
                      device=device)


def make_shifting_workload(n_rows, total, phase_len, width=512, seed=13):
    """Each phase hammers one value segment of attribute 1; segments
    are visited in a fixed shuffled order (a copy of the reference's
    ``benchmarks/crack_on_scan.py:make_shifting_workload``)."""
    import numpy as np

    from repro_torch.api import Query

    rng = np.random.default_rng(seed)
    phases = max(total // phase_len, 1)
    order = rng.permutation(phases)
    seg_span = n_rows // phases
    items = []
    for i in range(total):
        ph = i // phase_len
        seg_lo = 1 + int(order[ph % phases]) * seg_span
        hi_bound = max(seg_lo + seg_span - width - 1, seg_lo + 1)
        lo = int(rng.integers(seg_lo, hi_bound))
        items.append(Query(kind="scan", table="narrow", attrs=(1,),
                           los=(lo,), his=(lo + width,), agg_attr=2,
                           template=f"hot{ph}"))
    return items


def masked_loop(torch, bfa, dbk, dbp, n_bursts, tag, table_launches):
    """The phase-5 workload on two twin databases with crack_on_scan
    on: ``n_bursts`` bursts of MASKED_BURST scans of the shifting
    hot-range workload, one decide / apply tuning cycle per burst
    (hot-range page lists).  Every stats field, the clock, the quanta
    and the coverage bits agree; K3 launches once per masked group and
    the table kernel (``table_launches``) once per table / hybrid
    group; a numpy scan of the final table equals the kernel twin's
    answers.  Returns the counts and timings."""
    import numpy as np

    from repro_torch.api import PredictiveTuner, TunerConfig
    from repro_torch.core import build_service

    cfg = dict(storage_budget_bytes=200e6,
               pages_per_cycle=MASKED_PAGES_PER_CYCLE,
               max_build_pages_per_cycle=MASKED_PAGES_PER_CYCLE,
               candidate_min_count=2)
    tuners = []
    for db in (dbk, dbp):
        db.crack_on_scan = True
        tuners.append(PredictiveTuner(db, TunerConfig(**cfg)))
    wl = make_shifting_workload(N_ROWS, n_bursts * MASKED_BURST,
                                MASKED_PHASE_LEN)
    k3_0, table_0 = bfa.masked_launches, table_launches()
    masked_groups, table_groups, non_prefix, populate = 0, 0, 0, 0.0
    tk, tp = [], []
    for burst in range(n_bursts):
        scans = wl[burst * MASKED_BURST:(burst + 1) * MASKED_BURST]
        n, plans = kernel_groups(dbk, scans, ("table", "hybrid",
                                              "hybrid_ps"))
        table_groups += n
        masked = [p for p in plans if p.path == "hybrid_masked"]
        masked_groups += len(masked)
        non_prefix += any(not p.index.coverage.is_prefix() for p in masked)
        sk, k_s, p_s = twin_burst(torch, dbk, dbp, scans, burst)
        tk.append(k_s)
        tp.append(p_s)
        populate += sum(s.populate_units for s in sk)
        pk, pp = tuners[0].decide(), tuners[1].decide()
        qk = [(q.index_name, q.pages, q.page_list, q.utility)
              for q in pk.quanta]
        assert qk == [(q.index_name, q.pages, q.page_list, q.utility)
                      for q in pp.quanta], burst
        wk = sum(build_service.apply_quantum(dbk, q) for q in pk.quanta)
        wp = sum(build_service.apply_quantum(dbp, q) for q in pp.quanta)
        assert wk == wp and sorted(dbk.indexes) == sorted(dbp.indexes)
        for name, b in dbk.indexes.items():
            assert np.array_equal(b.coverage.built,
                                  dbp.indexes[name].coverage.built)
        emit(dict(phase=f"{tag}_burst", burst=burst, kernel_s=k_s,
                  plain_s=p_s, paths=sorted(p.path for p in plans),
                  populate_units=sum(s.populate_units for s in sk),
                  page_list_pages=sum(len(q.page_list) for q in pk.quanta),
                  build_work=wk,
                  covered={n: b.coverage.count()
                           for n, b in dbk.indexes.items()}))
    # The path's counts, read before the checks below.
    k3_launches = bfa.masked_launches - k3_0
    t_launches = table_launches() - table_0
    assert k3_launches == masked_groups > 0, (k3_launches, masked_groups)
    assert t_launches == table_groups, (t_launches, table_groups)
    assert non_prefix > 0, "no burst planned a bitmap that is not a prefix"
    assert populate > 0, "crack adoption charged no populate units"
    bi = dbk.indexes["narrow:1"]
    assert bi.building, "the index finished building: raise the depth cut"
    table = dbk.tables["narrow"]
    checks = wl[-4:] + wl[:2]
    masked_checks = 0
    for q in checks:
        ts = dbk.clock_ms_i32()
        plan = dbk.planner.plan_scan(q)
        got = dbk.execute_batch([q], use_kernel=True)[0]
        assert (got.agg_sum, got.count) == numpy_scan(table, q, ts), q
        masked_checks += plan.path == "hybrid_masked"
    assert masked_checks > 0
    return dict(tk=tk, tp=tp, k3_launches=k3_launches,
                table_launches=t_launches, masked_groups=masked_groups,
                non_prefix_bursts=non_prefix, populate_units=populate,
                final_covered_pages=bi.coverage.count(),
                numpy_checks=len(checks), numpy_checks_masked=masked_checks)


def clustered_twins(torch, dev, num_shards=1):
    """Two databases over one clustered 10M-row table (its copy)."""
    from repro_torch.api import Database

    t0 = time.perf_counter()
    src = make_clustered_table(N_ROWS, PAGE_SIZE, device=dev)
    twin = clone_table(src)
    dbs = (Database({"narrow": src}, num_shards=num_shards),
           Database({"narrow": twin}, num_shards=num_shards))
    del src, twin
    torch.cuda.synchronize()
    emit(dict(phase="load_clustered", rows=N_ROWS, shards=num_shards,
              pages=dbs[0].tables["narrow"].n_pages, page_size=PAGE_SIZE,
              seconds=time.perf_counter() - t0))
    return dbs


def phase_masked_path(torch, bfa, fa, dev, profile):
    """Phase 5: the masked main path (coverage bitmaps, crack-on-scan,
    hot-range quanta) at 10M rows on the card."""
    dbk, dbp = clustered_twins(torch, dev)
    bfa.launches = bfa.masked_launches = fa.launches = 0
    run = masked_loop(torch, bfa, dbk, dbp, N_MASKED_BURSTS, "masked",
                      lambda: bfa.launches)
    assert fa.launches == 0
    tk, tp = run.pop("tk"), run.pop("tp")
    emit(dict(phase="masked_path", bursts=N_MASKED_BURSTS,
              scans_per_burst=MASKED_BURST,
              kernel_median_burst_ms=statistics.median(tk) * 1e3,
              plain_median_burst_ms=statistics.median(tp) * 1e3,
              kernel_s=sum(tk), plain_s=sum(tp),
              k1_launches=run.pop("table_launches"),
              full_pages=N_ROWS // PAGE_SIZE, **run))
    emit(dict(phase="scale_masked",
              reduced=[f"depth: {N_MASKED_BURSTS} bursts of {MASKED_BURST} "
                       f"scans (the reference benchmark runs 240 scans)"],
              note=f"{N_ROWS} rows x 21 attrs, page_size {PAGE_SIZE}, "
                   f"{dbk.tables['narrow'].n_pages} pages: the paper's "
                   f"size"))
    if profile:  # the workload's next burst, after the counted run
        extra = make_shifting_workload(
            N_ROWS, (N_MASKED_BURSTS + 1) * MASKED_BURST,
            MASKED_PHASE_LEN)[-MASKED_BURST:]
        profile_bursts(torch, dbk, dbp, "masked", lambda: extra)
    return run["k3_launches"]


def skewed_tuner_db(initial, page_counts):
    """The reference's ``benchmarks/shard_tuning.py:make_skewed_db``
    (one hot shard, cold shards of ``page_counts`` pages, every shard
    exactly full) at any size, cut from the TUNER table ``initial``:
    both draw the row id plus ``zipf_attrs(default_rng(7), n, 20)``, and
    the numpy generator fills the Zipf array in row order, so the
    skewed table's rows are the first rows of the TUNER table (checked
    on the first 1,000 rows)."""
    import numpy as np

    from repro_torch.bench_db.schema import TunerDB, zipf_attrs
    from repro_torch.core.table import Table, stack_shards

    t = initial.tables["narrow"]
    psz = t.page_size
    head = zipf_attrs(np.random.default_rng(7), 1_000, t.n_attrs - 1)
    assert np.array_equal(t.data.view(-1, t.n_attrs)[:1_000, 1:].cpu()
                          .numpy(), head)
    edges = np.cumsum([0] + list(page_counts))
    n_rows = int(edges[-1]) * psz
    table = stack_shards([Table(t.data[a:b], t.begin_ts[a:b],
                                t.end_ts[a:b], (b - a) * psz)
                          for a, b in zip(edges[:-1], edges[1:])], n_rows)
    col = t.data.view(-1, t.n_attrs)[:n_rows, 1].cpu().numpy()
    return TunerDB(tables={"narrow": table}, quantiles={"narrow":
                                                        np.sort(col)},
                   n_rows=n_rows, rng=None)


def phase_sharded_path(torch, bfa, fa, profile, record_main, initial):
    """Phase 7: the sharded main path at 10M rows, a K4 twin against a
    plain twin: (a) phase 3's workload on 4 round-robin shards, equal
    to phase 3 burst for burst; (b) the 36/4/4/4 skewed pre-sharded
    table with per-shard builds (``hybrid_ps``); (c) phase 5's
    crack-on-scan loop on 4 shards (K3 at S = 4), at reduced depth."""
    from repro_torch.api import Database, IndexDescriptor, QueryGen

    dev = initial.tables["narrow"].device
    bfa.launches = bfa.sharded_launches = bfa.masked_launches = 0
    fa.launches = 0  # counts from here on are the sharded path's
    out = {}
    # (a) Phase 3's workload on Database(..., num_shards=4).
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    src = initial.tables["narrow"]
    dbk = Database({"narrow": clone_table(src)}, num_shards=4)
    dbp = Database({"narrow": clone_table(src)}, num_shards=4)
    torch.cuda.synchronize()
    st = dbk.tables["narrow"]
    emit(dict(phase="load_sharded", rows=N_ROWS, shards=st.n_shards,
              local_pages=list(st.local_pages),
              seconds=time.perf_counter() - t0))
    run = prefix_loop(torch, dbk, dbp, initial, "sharded",
                      lambda: bfa.sharded_launches, oracle=True)
    assert bfa.launches == 0 and fa.launches == 0  # K4 only, no K1 / K2
    for burst, (a, b) in enumerate(zip(run["record"], record_main)):
        assert a == b, ("sharded run differs from phase 3", burst)
    assert len(run["record"]) == len(record_main)
    tk, tp = run["tk"], run["tp"]
    out["a"] = dict(k4_launches=run["launches"],
                    kernel_median_burst_ms=statistics.median(tk) * 1e3,
                    plain_median_burst_ms=statistics.median(tp) * 1e3,
                    numpy_checks=run["numpy_checks"],
                    peak_bytes=torch.cuda.max_memory_allocated())
    emit(dict(phase="sharded_path", bursts=N_BURSTS, equal_to_phase3=True,
              hybrid_groups=run["paths"].count("hybrid"), **out["a"]))
    if profile:
        gen = run["gen"]
        profile_bursts(torch, dbk, dbp, "sharded", lambda: [
            gen.low_s(attr=3) for _ in range(BURST_LOW_S)] + [
            gen.mod_s(attrs=(1, 2)) for _ in range(BURST_MOD_S)])
    del dbk, dbp, st, run
    torch.cuda.empty_cache()

    # (b) The skewed layout, adopted as is; per-shard builds.
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sdb = skewed_tuner_db(initial, SKEW_PAGES)
    st = sdb.tables["narrow"]
    twin = clone_table(st)
    dbk, dbp = Database({"narrow": st}), Database({"narrow": twin})
    torch.cuda.synchronize()
    emit(dict(phase="load_skewed", rows=st.n_rows,
              local_pages=list(st.local_pages),
              seconds=time.perf_counter() - t0))
    assert dbk.num_shards == 4 and not dbk.table_is_round_robin("narrow")
    works = []
    for db in (dbk, dbp):
        bi = db.create_index(IndexDescriptor("narrow", (1,)), "vap")
        works.append([db.vap_build_step(bi, pages=p, shard=s)
                      for s, p in ((0, SKEW_PAGES[0] // 3), (2, 1_000))])
    assert works[0] == works[1]
    gen = QueryGen(sdb, selectivity=0.01, seed=21)
    cols = host_columns(st, (1, 2, 3))  # a read-only workload
    k4_0, expected, ps_groups, checked, tk, tp = (
        bfa.sharded_launches, 0, 0, 0, [], [])
    for burst in range(SKEW_BURSTS):
        scans = [gen.low_s(attr=1) for _ in range(BURST_LOW_S)] + [
            gen.mod_s(attrs=(1, 2)) for _ in range(BURST_MOD_S)]
        n, plans = kernel_groups(dbk, scans, ("table", "hybrid",
                                              "hybrid_ps"))
        expected += n
        ps_groups += sum(p.path == "hybrid_ps" for p in plans)
        ts = dbk.clock_ms_i32()
        sk, k_s, p_s = twin_burst(torch, dbk, dbp, scans, burst)
        tk.append(k_s)
        tp.append(p_s)
        for q, r in zip(scans, sk):
            assert (r.agg_sum, r.count) == numpy_answer(cols, q, ts), q
            checked += 1
        for db in (dbk, dbp):  # one more per-shard quantum per burst
            db.vap_build_step(db.indexes["narrow:1"], pages=2_000,
                              shard=burst % 4)
        emit(dict(phase="skewed_burst", burst=burst, kernel_s=k_s,
                  plain_s=p_s, paths=sorted(p.path for p in plans),
                  used_index=sum(s.used_index for s in sk)))
    k4_b = bfa.sharded_launches - k4_0
    assert k4_b == expected > 0 and ps_groups > 0, (k4_b, expected,
                                                    ps_groups)
    out["b"] = dict(k4_launches=k4_b, hybrid_ps_groups=ps_groups,
                    kernel_median_burst_ms=statistics.median(tk) * 1e3,
                    plain_median_burst_ms=statistics.median(tp) * 1e3,
                    numpy_checks=checked,
                    peak_bytes=torch.cuda.max_memory_allocated())
    emit(dict(phase="skewed_path", bursts=SKEW_BURSTS, **out["b"]))
    del dbk, dbp, st, twin, sdb, cols
    torch.cuda.empty_cache()

    # (c) Phase 5's crack-on-scan loop on 4 round-robin shards.
    torch.cuda.reset_peak_memory_stats()
    dbk, dbp = clustered_twins(torch, dev, num_shards=4)
    run = masked_loop(torch, bfa, dbk, dbp, SHARDED_MASKED_BURSTS,
                      "sharded_masked", lambda: bfa.sharded_launches)
    tk, tp = run.pop("tk"), run.pop("tp")
    out["c"] = dict(kernel_median_burst_ms=statistics.median(tk) * 1e3,
                    plain_median_burst_ms=statistics.median(tp) * 1e3,
                    k4_launches=run.pop("table_launches"),
                    peak_bytes=torch.cuda.max_memory_allocated(), **run)
    emit(dict(phase="sharded_masked_path", bursts=SHARDED_MASKED_BURSTS,
              shards=4, **out["c"]))
    if profile:
        extra = make_shifting_workload(
            N_ROWS, (SHARDED_MASKED_BURSTS + 1) * MASKED_BURST,
            MASKED_PHASE_LEN)[-MASKED_BURST:]
        profile_bursts(torch, dbk, dbp, "sharded_masked", lambda: extra)
    del dbk, dbp
    torch.cuda.empty_cache()
    # Each loop's counts were read right after it: the numpy checks of
    # (c) and the profiled bursts launch K3 / K4 again, off the count.
    k4 = sum(out[p]["k4_launches"] for p in "abc")
    assert bfa.launches == 0 and fa.launches == 0
    emit(dict(phase="scale_sharded",
              reduced=[f"(b) depth: {SKEW_BURSTS} bursts",
                       f"(c) depth: {SHARDED_MASKED_BURSTS} bursts of "
                       f"{MASKED_BURST} scans",
                       "(b) 36/4/4/4 cut to whole pages of 256 rows: "
                       "9,999,360 rows"],
              note="(a) phase 3's 10M rows on 4 shards; (c) phase 5's "
                   "clustered 10M rows on 4 shards"))
    return k4, out["c"]["k3_launches"]


def queries_to_converge(res) -> int:
    """First query at which the mean built fraction reaches
    CONVERGED_FRACTION (len(run) when it never does): a copy of the
    reference's ``benchmarks/shard_tuning.py:queries_to_converge``."""
    for i, frac in enumerate(res.built_fraction):
        if frac >= CONVERGED_FRACTION:
            return i
    return len(res.built_fraction)


def shard_slots(table) -> int:
    """Slots per shard of a ``Table`` (one shard) or ``ShardedTable``."""
    return table.begin_ts.shape[-2] * table.begin_ts.shape[-1]


def slot_prefix(table, slot, counts):
    """Which flat slots of ``table`` lie in the first ``counts[s]``
    slots of their shard ``s``."""
    import numpy as np

    per_shard = shard_slots(table)
    return slot % per_shard < np.asarray(counts)[slot // per_shard]


def row_counts(table):
    """Each shard's append watermark (a ``Table``: its row count)."""
    return tuple(getattr(table, "local_rows", (table.n_rows,)))


def numpy_oracle(db, workload, shared_ts):
    """Wrap ``db``'s statement entry points so that every
    LOOP_CHECK_EVERY-th statement that is a scan gets the answer a numpy
    scan gives at its snapshot: (agg_sum, count), or (agg_sum, pairs)
    for a join.  A written slot never changes its values (an UPDATE
    ends the old version and appends the new one), so the final table
    holds what a scan saw, unless a later write shares the scan's
    timestamp.  With ``shared_ts`` such a scan is answered from the
    final table as it stood before that write: the first write after it
    records each shard's append watermark and the slots already ended
    at that timestamp (one compare on the card); later slots are
    invisible and later ends undone.  Without it, no such write may
    occur.  A scan that a complete FULL index answers alone
    (``pure_vap``, planned at the scan) is held to the rows of the
    index's built pages: the reference's rule leaves the watermark
    page and rows appended since the build out (ROADMAP.md queue 3
    item 2).  Returns ``finish``: called after the run, it gives
    (answers by statement position, scans answered before a shared
    write, scans held to built pages)."""
    import numpy as np

    items = [q for _, q in workload]
    attrs = {a for q in items if q.kind == "scan"
             for a in q.attrs + (q.agg_attr,)}
    attrs |= {a for q in items if q.join_table is not None
              for a in (q.join_attr, q.join_inner_attr)}
    assert all(q.join_table in (None, "narrow") for q in items)
    log, epochs, pending, before, built = [], [], [], {}, {}
    writes, plans = [0], {}
    batch, single, plan_scan = (db.execute_batch, db.execute,
                                db.planner.plan_scan)

    def planned(q):
        plan = plan_scan(q)
        vap = plan.pinned_state
        if plan.path == "pure_vap":  # only a complete FULL index
            plans[id(q)] = tuple(
                b * db.tables[q.table].page_size for b in getattr(
                    vap, "shard_built", (vap.built_pages,)))
        else:
            plans.pop(id(q), None)
        return plan

    def submit(queries):
        ts = db.clock_ms_i32()
        if any(q.kind != "scan" for q in queries):
            due = [i for i in pending if log[i] == ts and i not in before]
            if due:
                assert shared_ts, ("a write shares scan timestamps", due)
                t = db.tables["narrow"]
                ended = (t.end_ts.reshape(-1) == ts).nonzero()
                ended = ended.reshape(-1).cpu().numpy()
                for i in due:
                    before[i] = (row_counts(t), ended, shard_slots(t))
        for q in queries:
            i = len(log)
            log.append(ts)
            epochs.append(writes[0])
            if q.kind == "scan" and i % LOOP_CHECK_EVERY == 0:
                pending.append(i)
        writes[0] += sum(q.kind != "scan" for q in queries)

    def done(first):
        for i in range(first, len(log)):
            if i in pending and id(items[i]) in plans:
                built[i] = plans[id(items[i])]

    def execute_batch(queries, **kw):
        first = len(log)
        submit(queries)
        out = batch(queries, **kw)
        done(first)
        return out

    def execute(q, **kw):
        first = len(log)
        submit([q])
        out = single(q, **kw)
        done(first)
        return out

    def finish():
        assert len(log) == len(items)
        t = db.tables["narrow"]
        cols = host_columns(t, tuple(attrs))
        cols["slot"] = np.arange(cols["begin"].size)
        # Slots never written (headroom, shard padding) are visible at
        # no snapshot: drop them once instead of in every check.
        written = cols["begin"] != np.iinfo(np.int32).max
        cols = {k: v[written] for k, v in cols.items()}
        answers, inner, prefixes = {}, {}, {}

        def prefix(counts):  # one slot mask per watermark set
            if counts not in prefixes:
                prefixes[counts] = slot_prefix(t, cols["slot"], counts)
            return prefixes[counts]

        for i in pending:
            q, ts = items[i], log[i]
            c = cols
            if i in before:
                counts, ended, per_shard = before[i]
                # Slot ids as the final table numbers them (a grown
                # table has more slots per shard).
                ended = ended // per_shard * shard_slots(t) + ended % per_shard
                c = dict(cols)
                c["begin"] = np.where(prefix(counts), cols["begin"],
                                      np.iinfo(np.int32).max)
                later = (cols["end"] == ts) & ~np.isin(cols["slot"], ended)
                c["end"] = np.where(later, np.iinfo(np.int32).max,
                                    cols["end"])
            rows = prefix(built[i]) if i in built else None
            want = numpy_answer(c, q, ts, rows)
            if q.join_table is not None:
                # The live rows change only with a write.
                key = (epochs[i], q.join_inner_attr)
                if key not in inner:
                    live = (c["begin"] <= ts) & (ts < c["end"])
                    inner[key] = np.bincount(
                        c[q.join_inner_attr][live]).astype(np.int64)
                want = (want[0], numpy_pairs(c, q, ts, inner[key], rows))
            answers[i] = want
        return answers, len(before), len(built)

    db.execute_batch, db.execute = execute_batch, execute
    db.planner.plan_scan = planned
    return finish


def loop_run(torch, bfa, table, workload, tuner, exec_kw, tuning_kw,
             oracle=False, shared_ts=False, db_kw=None, serving_kw=None,
             faults_kw=None):
    """One ``run_workload`` on the card (the closed loop, or the open
    loop when ``serving_kw`` names an arrival stream); returns the
    RunResult, the database, the kernel launches of the run (each
    count set to 0 just before it) and, with ``oracle``, the
    ``finish`` of a ``numpy_oracle`` (``shared_ts`` passed on), else
    None.  ``tuner`` is "dis", "predictive", a TunerConfig's fields or
    a callable that makes the tuner from the database; ``faults_kw``
    are ``FaultOptions`` fields."""
    from repro_torch.api import (Database, DisabledTuner, ExecOptions,
                                 FaultOptions, PredictiveTuner, RunConfig,
                                 ServingOptions, TunerConfig, TuningOptions,
                                 make_dl_tuner, run_workload)

    db = Database({"narrow": table}, time_per_unit_ms=LOOP_UNIT_MS,
                  **(db_kw or {}))
    if callable(tuner):
        t = tuner(db)
    elif tuner == "dis":
        t = DisabledTuner(db)
    elif tuner == "predictive":
        t = make_dl_tuner(db, "predictive")
    else:  # a TunerConfig's fields
        t = PredictiveTuner(db, TunerConfig(**tuner))
    cfg = RunConfig(execution=ExecOptions(read_batch_size=LOOP_BATCH,
                                          **exec_kw),
                    tuning=TuningOptions(**tuning_kw),
                    serving=ServingOptions(**(serving_kw or {})),
                    faults=FaultOptions(**(faults_kw or {})),
                    time_per_unit_ms=LOOP_UNIT_MS)
    finish = numpy_oracle(db, workload, shared_ts) if oracle else None
    torch.cuda.synchronize()
    bfa.launches = bfa.sharded_launches = bfa.masked_launches = 0
    res = run_workload(db, t, workload, cfg)
    launches = dict(K1=bfa.launches, K3=bfa.masked_launches,
                    K4=bfa.sharded_launches)
    return res, db, launches, finish


def result_diffs(a, b):
    """Fields of two RunResults that differ (all but wall_s,
    execution_tiers and build_pages_per_ms, the build lane's measured
    throughput), and the elements of ``results`` and ``latencies_ms``
    that differ."""
    import dataclasses

    fields = [f.name for f in dataclasses.fields(a)
              if f.name not in ("wall_s", "execution_tiers",
                                "build_pages_per_ms")
              and getattr(a, f.name) != getattr(b, f.name)]
    elements = sum(x != y for name in ("results", "latencies_ms")
                   for x, y in zip(getattr(a, name), getattr(b, name)))
    return fields, elements


def loop_arm(torch, bfa, tag, make_table, workload, tuner, exec_kw,
             tuning_kw, must_launch, numpy_check=False, shared_ts=False,
             db_kw=None, serving_kw=None, faults_kw=None, after=None):
    """One arm of phases 8-10: a kernel twin (``use_kernel``) and a
    plain twin, each on its own table from ``make_table``.  Every
    simulated field must agree (no escalated build-lane drain may
    occur: their size reads the wall clock), the kernel twin must
    launch each kernel of ``must_launch`` and the plain twin none; with
    ``numpy_check``
    every LOOP_CHECK_EVERY-th statement of the kernel twin that is a
    scan is held to a numpy scan of the rows live at its snapshot (a
    join's pair count to a numpy pair count; ``numpy_oracle``, which
    ``shared_ts`` lets answer scans that a later write shares a
    timestamp with).  ``after(kernel db, plain
    db)`` checks the twins' end states and returns fields for the arm's
    line.  Returns the kernel twin's result, its launches, the arm's
    peak device memory and ``after``'s fields."""
    import numpy as np

    # A Database sits in a reference cycle (its planner points back at
    # it), so the databases of earlier arms and phases stay allocated
    # until the collector runs: collect them before measuring.
    gc.collect()
    torch.cuda.empty_cache()
    t_arm = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    for use_kernel in (True, False):
        out[use_kernel] = loop_run(
            torch, bfa, make_table(), workload, tuner,
            dict(exec_kw, use_kernel=use_kernel), tuning_kw,
            oracle=numpy_check and use_kernel, shared_ts=shared_ts,
            db_kw=db_kw, serving_kw=serving_kw, faults_kw=faults_kw)
    (rk, dbk, lk, finish), (rp, dbp, lp, _) = out[True], out[False]
    fields, elements = result_diffs(rk, rp)
    extra = after(dbk, dbp) if after is not None else {}
    for name, twin in (("kernel", rk), ("plain", rp)):
        emit(dict(phase="loop_summary", arm=tag, twin=name,
                  summary=twin.summary(), wall_s=twin.wall_s,
                  execution_tiers=twin.execution_tiers))
    checked, joins_checked, shared, built = 0, 0, 0, 0
    t_check = time.perf_counter()
    if numpy_check:
        answers, shared, built = finish()
        items = [q for _, q in workload]
        for i, want in sorted(answers.items()):
            assert rk.results[i][:2] == want, (tag, i, items[i])
            joins_checked += items[i].join_table is not None
        checked = len(answers)
        assert checked > 0
    peak = torch.cuda.max_memory_allocated()
    emit(dict(phase="loop_arm", arm=tag, differing_fields=fields,
              differing_elements=elements, statements=len(rk.results),
              numpy_checks=checked, numpy_join_checks=joins_checked,
              launches=lk, plain_launches=lp,
              numpy_checks_before_shared_ts_write=shared,
              numpy_checks_on_built_pages=built,
              kernel_wall_s=rk.wall_s, plain_wall_s=rp.wall_s,
              peak_bytes=peak, seconds=time.perf_counter() - t_arm,
              check_seconds=time.perf_counter() - t_check, **extra))
    assert not fields and elements == 0, (tag, fields, elements)
    assert rk.build_escalations == rp.build_escalations == 0, tag
    assert all(lp[k] == 0 for k in lp), (tag, lp)
    for k in must_launch:
        assert lk[k] > 0, (tag, k, lk)
    assert sum(rk.execution_tiers.values()) == len(rk.results) - sum(
        q.kind != "scan" for _, q in workload)
    return rk, lk, peak, extra


def phase_closed_loop(torch, bfa, initial, profile=False):
    """Phase 8: ``run_workload`` through the port on the card, on fig10's
    hybrid workload over phase 3's 10M-row table, each arm a kernel twin
    against a plain twin: (a) 1 shard, predictive at FAST and DIS; (b) 4
    round-robin shards, flag off, equal to (a); (c) 4 shards,
    shard-aware; (d) phase 7(b)'s skewed table, shard-aware off and on
    (``benchmarks/shard_tuning.py`` at full width); (e) 1 shard with
    crack-on-scan and decay.  With ``profile``, one more run of each
    twin of (a)'s read_only predictive arm under torch.profiler.
    Returns the kernel twins' launches."""
    from repro_torch.api import (TUNING_FREQ_MS, QueryGen, hybrid_workload)

    t_phase = time.perf_counter()
    src = initial.tables["narrow"]
    fast = dict(tuning_interval_ms=TUNING_FREQ_MS["fast"])
    workloads = {}
    for mixture in ("read_only", "read_heavy"):
        gen = QueryGen(initial, selectivity=0.01, seed=17 + LOOP_PHASE_LEN)
        workloads[mixture] = hybrid_workload(
            gen, mixture, total=LOOP_TOTAL, phase_len=LOOP_PHASE_LEN)
    launches, peaks = dict(K1=0, K3=0, K4=0), []

    def arm(tag, *a, **k):
        res, lk, peak, _ = loop_arm(torch, bfa, tag, *a, **k)
        for key in launches:
            launches[key] += lk[key]
        peaks.append(peak)
        return res

    # (a) 1 shard: predictive at FAST against DIS, on both mixtures.
    a = {}
    for mixture, wl in workloads.items():
        for tuner, tuning in (("predictive", fast), ("dis", dict(
                tuning_interval_ms=TUNING_FREQ_MS["dis"]))):
            a[mixture, tuner] = arm(
                f"a_{mixture}_{tuner}", lambda: clone_table(src), wl, tuner,
                dict(num_shards=1), tuning, must_launch=("K1",))
        dis, fst = a[mixture, "dis"], a[mixture, "predictive"]
        emit(dict(phase="loop_dis_over_fast", mixture=mixture,
                  dis_cumulative_ms=dis.cumulative_ms,
                  fast_cumulative_ms=fst.cumulative_ms,
                  dis_over_fast=dis.cumulative_ms / fst.cumulative_ms))
    if profile:  # after the counted runs
        for name, use_kernel in (("kernel", True), ("plain", False)):
            table = clone_table(src)
            profiled(torch, "loop_a_read_only", name, lambda: loop_run(
                torch, bfa, table, workloads["read_only"], "predictive",
                dict(num_shards=1, use_kernel=use_kernel), fast))
            del table
    wl = workloads["read_heavy"]
    # (b) 4 round-robin shards, flag off: equal to (a) field for field.
    b = arm("b_4_shards", lambda: clone_table(src), wl, "predictive",
            dict(num_shards=4), dict(fast, shard_aware_tuning=False),
            must_launch=("K4",), numpy_check=True)
    fields, elements = result_diffs(b, a["read_heavy", "predictive"])
    emit(dict(phase="loop_b_equals_a", differing_fields=fields,
              differing_elements=elements))
    assert not fields and elements == 0, (fields, elements)
    # (c) 4 round-robin shards, shard-aware.
    arm("c_4_shards_aware", lambda: clone_table(src), wl, "predictive",
        dict(num_shards=4), dict(fast, shard_aware_tuning=True),
        must_launch=("K4",), numpy_check=True)
    # (d) The skewed 36/4/4/4 layout (read-only: every shard is full),
    # the benchmark's tuner with its budgets scaled to the table.
    sdb = skewed_tuner_db(initial, SKEW_PAGES)
    skewed = sdb.tables["narrow"]
    scale = sum(SKEW_PAGES) / BENCH_SKEW_PAGES
    cycle = round(BENCH_CYCLE_PAGES * scale)
    bench_tuner = dict(storage_budget_bytes=BENCH_STORAGE * scale,
                       pages_per_cycle=cycle, max_build_pages_per_cycle=cycle,
                       candidate_min_count=2)
    gen = QueryGen(sdb, selectivity=0.01, seed=31)
    swl = hybrid_workload(gen, "read_only", total=LOOP_TOTAL,
                          phase_len=LOOP_PHASE_LEN, seed=5)
    conv = {}
    for aware in (False, True):
        res = arm(f"d_skewed_aware_{aware}", lambda: clone_table(skewed),
                  swl, bench_tuner, dict(num_shards=len(SKEW_PAGES)),
                  dict(fast, shard_aware_tuning=aware), must_launch=("K4",))
        conv[aware] = queries_to_converge(res)
    emit(dict(phase="loop_d_convergence", local_pages=list(SKEW_PAGES),
              pages_per_cycle=cycle, queries_to_converge_round_robin=conv[
                  False], queries_to_converge_shard_aware=conv[True],
              speedup=conv[False] / max(conv[True], 1)))
    del sdb, skewed
    # (e) 1 shard, crack-on-scan and decay: the masked path (K3).
    arm("e_crack_decay", lambda: clone_table(src), wl, "predictive",
        dict(num_shards=1), dict(fast, crack_on_scan=True, index_decay=True),
        must_launch=("K3",))
    emit(dict(phase="closed_loop", seconds=time.perf_counter() - t_phase,
              peak_bytes=max(peaks), launches=launches))
    emit(dict(phase="scale_closed_loop",
              reduced=["fig10's write_heavy mixture left out for run time "
                       "(phase 8 runs read_only and read_heavy)"],
              note=f"{N_ROWS} rows x 21 attrs, page_size {PAGE_SIZE}: "
                   f"phase 3's table; {LOOP_TOTAL} queries in phases of "
                   f"{LOOP_PHASE_LEN}, read bursts of {LOOP_BATCH}; (d) "
                   f"{'/'.join(map(str, SKEW_PAGES))} pages, "
                   f"{cycle} pages per cycle"))
    return launches


def same_indexes(torch, dbk, dbp) -> dict:
    """The twins' catalogs hold the same indexes in the same order, each
    with the same state: entries (VAP / FULL, or the VBP entries with
    their intervals, merged coverage and ``in_index``), watermarks and
    usage clock.  Returns the count and the schemes."""
    import numpy as np

    assert list(dbk.indexes) == list(dbp.indexes)
    for name, a in dbk.indexes.items():
        b = dbp.indexes[name]
        assert (a.scheme, a.complete, a.building, a.last_used_ms) == (
            b.scheme, b.complete, b.building, b.last_used_ms), name
        if a.scheme == "vbp":
            va, vb = a.vbp, b.vbp
            assert a.cov_union.ivs == b.cov_union.ivs and va.n_cov == vb.n_cov
            for f in ("cov_lo_hi", "cov_lo_lo", "cov_hi_hi", "cov_hi_lo"):
                assert np.array_equal(getattr(va, f), getattr(vb, f)), name
            assert torch.equal(va.in_index, vb.in_index), name
            sa, sb = va.index, vb.index
        else:
            sa, sb = a.vap, b.vap
        for x, y in zip(sa[:3], sb[:3]):
            assert torch.equal(x, y), name
        assert tuple(sa[3:]) == tuple(sb[3:]), name
    return dict(indexes_end=len(dbk.indexes),
                schemes=sorted({b.scheme for b in dbk.indexes.values()}))


def phase_baselines(torch, bfa, initial):
    """Phase 9: the paper's baselines through ``run_workload`` on phase
    3's 10M-row table at phase 8's scale, each arm a kernel twin
    against a plain twin with every fifth scan held to numpy: (a) fig7
    (``segments_workload``, predictive against holistic); (b) the
    online, adaptive and SMIX tuners on phase 8's read_heavy workload;
    (c) HIGH-S joins under the predictive tuner on 1 and 4 shards, equal
    to each other; (d) the adaptive tuner on 4 shards, equal to (b)'s.
    Returns the kernel twins' launches."""
    from repro_torch.api import (TUNING_FREQ_MS, AdaptiveTuner, Database,
                                 HolisticTuner, OnlineTuner, PredictiveTuner,
                                 QueryGen, SmixTuner, TunerConfig,
                                 affinity_workload, hybrid_workload,
                                 segments_workload)

    t_phase = time.perf_counter()
    src = initial.tables["narrow"]
    scan_ms = N_ROWS * LOOP_UNIT_MS  # one table scan's simulated latency
    fast = dict(tuning_interval_ms=TUNING_FREQ_MS["fast"])
    launches, peaks, seconds = dict(K1=0, K3=0, K4=0), [], {}

    def table():
        return clone_table(src)

    def same(dbk, dbp):
        return same_indexes(torch, dbk, dbp)

    def arm(tag, *a, **k):
        t_arm = time.perf_counter()
        res, lk, peak, extra = loop_arm(torch, bfa, tag, *a,
                                        numpy_check=True, shared_ts=True,
                                        **k)
        for key in launches:
            launches[key] += lk[key]
        peaks.append(peak)
        seconds[tag] = time.perf_counter() - t_arm
        return res, extra

    # (a) fig7: predictive against holistic over two scan segments and
    # an insert segment, budgets scaled to the table.
    scale = N_ROWS // FIG7_ROWS
    gen = QueryGen(initial, selectivity=0.01)
    seg = segments_workload(gen, seg_len=FIG7_SEG_LEN)
    makers = {
        "predictive": lambda db: PredictiveTuner(db, TunerConfig(
            storage_budget_bytes=50e6 * scale, pages_per_cycle=16 * scale,
            max_build_pages_per_cycle=48 * scale, candidate_min_count=3,
            u_min_write=0.3)),
        "holistic": lambda db: HolisticTuner(db, TunerConfig(
            storage_budget_bytes=50e6 * scale)),
    }
    fig7 = {}
    for name, make in makers.items():
        fig7[name] = arm(
            f"a_fig7_{name}", table, seg, make, dict(num_shards=1),
            dict(tuning_interval_ms=12.5 * scan_ms), must_launch=("K1",),
            db_kw=dict(monitor_max_age_ms=100 * scan_ms),
            serving_kw=dict(arrival_ms=scan_ms), after=same)
    spikes = {name: max(lat for lat, ph in zip(r.latencies_ms, r.phases)
                        if ph < 2) / scan_ms for name, (r, _) in fig7.items()}
    (pred, pe), (hol, he) = fig7["predictive"], fig7["holistic"]
    emit(dict(phase="baselines_fig7", seg_len=FIG7_SEG_LEN,
              predictive_cumulative_ms=pred.cumulative_ms,
              holistic_cumulative_ms=hol.cumulative_ms,
              holistic_over_predictive=hol.cumulative_ms / pred.cumulative_ms,
              max_scan_latency_over_table_scan=spikes,
              indexes_end=dict(predictive=pe["indexes_end"],
                               holistic=he["indexes_end"])))

    # (b) online, adaptive and SMIX on phase 8's read_heavy workload.
    gen = QueryGen(initial, selectivity=0.01, seed=17 + LOOP_PHASE_LEN)
    wl = hybrid_workload(gen, "read_heavy", total=LOOP_TOTAL,
                         phase_len=LOOP_PHASE_LEN)

    def online(db):
        t = OnlineTuner(db)
        log, cycle = [], t.tuning_cycle

        def tuning_cycle(idle=False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            work = cycle(idle=idle)
            torch.cuda.synchronize()
            log.append((work, time.perf_counter() - t0))
            return work

        t.tuning_cycle, db.cycle_log = tuning_cycle, log
        return t

    def online_after(dbk, dbp):
        assert [w for w, _ in dbk.cycle_log] == [w for w, _ in dbp.cycle_log]
        work, wall = max(dbk.cycle_log)
        # One cycle indexes the whole table: every full page.
        assert work >= (N_ROWS // PAGE_SIZE) * PAGE_SIZE, work
        return dict(same(dbk, dbp), full_build_work_units=work,
                    full_build_wall_s=wall,
                    full_build_plain_wall_s=max(dbp.cycle_log)[1])

    def smix(db):
        t = SmixTuner(db, TunerConfig(storage_budget_bytes=SMIX_BUDGET))
        drops, drop = [], db.drop_index

        def drop_index(name):
            drops.append(name)
            drop(name)

        db.drop_index, db.dropped = drop_index, drops
        return t

    def smix_after(dbk, dbp):
        assert dbk.dropped == dbp.dropped and dbk.dropped
        return dict(same(dbk, dbp), lru_drops=len(dbk.dropped))

    base = {}
    for name, make, after in (("online", online, online_after),
                              ("adaptive", AdaptiveTuner, same),
                              ("smix", smix, smix_after)):
        base[name] = arm(f"b_{name}", table, wl, make, dict(num_shards=1),
                         fast, must_launch=("K1",), after=after)

    # (c) HIGH-S joins (plus LOW-S noise scans that batch) under the
    # predictive tuner: 4 round-robin shards equal 1 shard.
    gen = QueryGen(initial, selectivity=0.01, seed=29)
    jwl = affinity_workload(gen, total=LOOP_TOTAL, phase_len=LOOP_PHASE_LEN,
                            template="high_s", noise_frac=JOIN_NOISE)

    def join_after(dbk, dbp):
        keys = [list(b.desc.key_attrs) for b in dbk.indexes.values()]
        assert any(k[0] == 4 for k in keys), keys  # the join attribute
        return dict(same(dbk, dbp), index_keys=keys)

    # The kernel twin runs first, so the first join of the process (its
    # 10M-value sort and searchsorted on the card) would be paid by one
    # twin alone: one throwaway join first.
    warm = Database({"narrow": table()}, time_per_unit_ms=LOOP_UNIT_MS)
    warm.execute(next(q for _, q in jwl if q.join_table is not None),
                 observe=False)
    torch.cuda.synchronize()
    del warm
    joins = {}
    for S, kernel in ((1, "K1"), (4, "K4")):
        joins[S] = arm(f"c_joins_{S}_shards", table, jwl, "predictive",
                       dict(num_shards=S), fast, must_launch=(kernel,),
                       after=join_after)[0]
    fields, elements = result_diffs(joins[4], joins[1])
    emit(dict(phase="baselines_joins_4_equal_1", differing_fields=fields,
              differing_elements=elements,
              joins=sum(q.join_table is not None for _, q in jwl)))
    assert not fields and elements == 0, (fields, elements)

    # (d) the adaptive tuner on 4 round-robin shards (sharded VBP, K4)
    # equals (b)'s 1-shard run.
    d, _ = arm("d_adaptive_4_shards", table, wl, AdaptiveTuner,
               dict(num_shards=4), fast, must_launch=("K4",), after=same)
    fields, elements = result_diffs(d, base["adaptive"][0])
    emit(dict(phase="baselines_d_equals_b", differing_fields=fields,
              differing_elements=elements))
    assert not fields and elements == 0, (fields, elements)

    emit(dict(phase="baselines", seconds=time.perf_counter() - t_phase,
              arm_seconds=seconds, peak_bytes=max(peaks), launches=launches,
              cumulative_ms={name: r.cumulative_ms
                             for name, (r, _) in base.items()}))
    emit(dict(phase="scale_baselines",
              reduced=[],
              note=f"{N_ROWS} rows x 21 attrs, page_size {PAGE_SIZE}: "
                   f"phase 3's table; fig7 {FIG7_SEG_LEN} statements per "
                   f"segment, budgets x{scale} (rows / {FIG7_ROWS}); (b), "
                   f"(c), (d) {LOOP_TOTAL} statements in phases of "
                   f"{LOOP_PHASE_LEN}, (c) with {JOIN_NOISE:.0%} LOW-S "
                   f"noise; read bursts of {LOOP_BATCH}"))
    return launches


def phase_build_lane(torch, bfa, initial):
    """Phase 10: the async build lane, the open-loop front end and
    single-engine faults through ``run_workload`` on phase 3's 10M-row
    table at phase 8's scale, each arm a kernel twin against a plain
    twin.  The configurations are the repo's benchmarks scaled as phase
    9 scaled fig7: budgets and page counts x rows / 20,000, intervals,
    cadences, deadlines and SLOs x the ratio of one unindexed table
    scan here to one there.  (a) ``benchmarks/async_tuning.py``
    serialized and deterministic, equal field for field, on 1 shard
    (K1) and 4 round-robin shards (K4, equal to 1); (b) its overlap
    run, results equal to (a)'s; (c) ``benchmarks/serving_slo.py``'s
    two policies on one bursty stream (open loop); (d)
    ``benchmarks/fault_recovery.py``'s transient categories (no
    outage) on (c)'s throttled stream in overlap mode: a zero-fault
    schedule equals none, recovery on and off keep the results; (e)
    overlap with crack-on-scan on phase 8(e)'s configuration (K3).
    Every fifth scan of (a)'s 1-shard, (c)'s fixed run and (e) is held
    to numpy; every other arm's results are held equal to one of
    those.  Returns the kernel twins' launches."""
    from repro_torch.api import (TUNING_FREQ_MS, Database, FaultSchedule,
                                 QueryGen, hybrid_workload)

    t_phase = time.perf_counter()
    src = initial.tables["narrow"]
    scale = N_ROWS // LANE_BENCH_ROWS  # budgets and page counts
    ratio = (N_ROWS * LOOP_UNIT_MS) / (LANE_BENCH_ROWS * LANE_BENCH_UNIT_MS)
    launches, peaks, seconds, runs = dict(K1=0, K3=0, K4=0), [], {}, {}

    def table():
        return clone_table(src)

    def arm(tag, *a, **k):
        t_arm = time.perf_counter()
        res, lk, peak, _ = loop_arm(torch, bfa, tag, table, *a, **k)
        for key in launches:
            launches[key] += lk[key]
        peaks.append(peak)
        seconds[tag] = time.perf_counter() - t_arm
        runs[tag] = res
        return res

    def equal(tag, a, b, results_only=False):
        if results_only:
            fields = [] if a.results == b.results else ["results"]
            elements = sum(x != y for x, y in zip(a.results, b.results))
        else:
            fields, elements = result_diffs(a, b)
        emit(dict(phase="lane_equal", check=tag, differing_fields=fields,
                  differing_elements=elements))
        assert not fields and elements == 0, (tag, fields, elements)

    def lane(res):
        return dict(cumulative_ms=res.cumulative_ms, p99_ms=res.p99_latency_ms,
                    tuner_charged_ms=res.tuner_charged_ms,
                    tuner_overlapped_ms=res.tuner_overlapped_ms,
                    tuner_work_units=res.tuner_work_units,
                    build_pages_per_ms=res.build_pages_per_ms)

    # A table scan's simulated latency (no index), for the record.
    probe = Database({"narrow": src}, time_per_unit_ms=LOOP_UNIT_MS)
    scan_ms = probe.execute(QueryGen(initial, selectivity=0.01, seed=1)
                            .low_s(), observe=False).latency_ms
    del probe

    # (a), (b): benchmarks/async_tuning.py.
    gen = QueryGen(initial, selectivity=0.01, seed=29)
    awl = hybrid_workload(gen, "read_only", total=LANE_TOTAL,
                          phase_len=LANE_ASYNC_PHASE_LEN, seed=7)
    atuner = dict(storage_budget_bytes=50e6 * scale,
                  pages_per_cycle=8 * scale,
                  max_build_pages_per_cycle=16 * scale,
                  candidate_min_count=2)
    atuning = dict(tuning_interval_ms=25.0 * ratio,
                   build_quantum_pages=8 * scale)
    for S, kernel in ((1, "K1"), (4, "K4")):
        for mode in (None, "deterministic"):
            arm(f"a_{mode or 'serialized'}_{S}_shards", awl, atuner,
                dict(num_shards=S), dict(atuning, async_tuning=mode),
                must_launch=(kernel,), numpy_check=(S, mode) == (1, None))
        equal(f"a_deterministic_equals_serialized_{S}_shards",
              runs[f"a_deterministic_{S}_shards"],
              runs[f"a_serialized_{S}_shards"])
    equal("a_4_shards_equal_1", runs["a_serialized_4_shards"],
          runs["a_serialized_1_shards"])
    ser = runs["a_serialized_1_shards"]
    assert ser.tuner_charged_ms > 0.0 and ser.tuner_overlapped_ms == 0.0
    ovl = arm("b_overlap_1_shard", awl, atuner, dict(num_shards=1),
              dict(atuning, async_tuning="overlap"), must_launch=("K1",))
    equal("b_results_equal_a", ovl, ser, results_only=True)
    assert ovl.tuner_charged_ms == 0.0 < ovl.tuner_overlapped_ms
    emit(dict(phase="lane_overlap", deterministic=lane(
        runs["a_deterministic_1_shards"]), overlap=lane(ovl),
              p99_overlap_over_deterministic=ovl.p99_latency_ms
              / runs["a_deterministic_1_shards"].p99_latency_ms))

    # (c): benchmarks/serving_slo.py's two policies on one stream.
    gen = QueryGen(initial, selectivity=0.01, seed=29)
    swl = hybrid_workload(gen, "read_only", total=LANE_TOTAL,
                          phase_len=LANE_SERVING_PHASE_LEN, seed=7)
    stuner = dict(storage_budget_bytes=50e6 * scale,
                  pages_per_cycle=32 * scale,
                  max_build_pages_per_cycle=64 * scale,
                  candidate_min_count=2)
    stream = dict(arrival_stream="bursty", arrival_ms=5.0 * ratio,
                  arrival_seed=11, slo_ms=6.0 * ratio)
    throttle = dict(stream, burst_deadline_ms=2.0 * ratio,
                    build_throttle=True, load_shed_tuning=True)
    stuning = dict(tuning_interval_ms=25.0 * ratio, build_queue_cap=16)

    def slo(res):
        return dict(p99_ms=res.p99_latency_ms, p999_ms=res.p999_latency_ms,
                    miss_rate=res.deadline_miss_rate,
                    deferrals=res.build_throttle_deferrals,
                    shed_quanta=res.build_shed_quanta,
                    tuner_charged_ms=res.tuner_charged_ms,
                    tuner_overlapped_ms=res.tuner_overlapped_ms,
                    worst_phase_p99_ms=max(
                        s.p99_ms for _, s in res.slo_report.phases))

    fixed = arm("c_fixed_always", swl, stuner, dict(num_shards=1),
                dict(stuning, async_tuning="deterministic"),
                must_launch=("K1",), serving_kw=stream, numpy_check=True)
    served = arm("c_deadline_throttle", swl, stuner, dict(num_shards=1),
                 dict(stuning, async_tuning="deterministic"),
                 must_launch=("K1",), serving_kw=throttle)
    equal("c_results_equal", served, fixed, results_only=True)
    emit(dict(phase="lane_serving", fixed_always=slo(fixed),
              deadline_throttle=slo(served),
              p99_fixed_over_throttle=fixed.p99_latency_ms
              / served.p99_latency_ms))

    # (d): faults on one engine, (c)'s throttled stream, overlap lane
    # (quanta of 8 pages before scaling, as (b)'s).  Scan errors and
    # stragglers hold the throttle's pause on long enough for ~400
    # quanta to queue (a CPU dry run at 0.2M and 1M rows), so the queue
    # cap is set past that: no drain escalates (an escalated drain's
    # size reads the wall clock) and nothing is shed.
    dtuning = dict(stuning, async_tuning="overlap",
                   build_quantum_pages=8 * scale,
                   build_queue_cap=LANE_FAULT_QUEUE_CAP)
    sched = dict(seed=11, scan_error_rate=0.08, straggler_rate=0.1,
                 straggler_ms=0.3 * ratio, build_fail_rate=0.2)
    d = {}
    for name, faults in (
            ("fault_free", None),
            ("zero_fault", dict(fault_schedule=FaultSchedule(seed=11))),
            ("recovery", dict(fault_schedule=FaultSchedule(**sched))),
            ("no_recovery", dict(fault_schedule=FaultSchedule(**sched),
                                 fault_recovery=False))):
        d[name] = arm(f"d_{name}", swl, stuner, dict(num_shards=1), dtuning,
                      must_launch=("K1",), serving_kw=throttle,
                      faults_kw=faults)
    equal("d_zero_fault_equals_none", d["zero_fault"], d["fault_free"])
    equal("d_fault_free_results_equal_c", d["fault_free"], fixed,
          results_only=True)
    for name in ("recovery", "no_recovery"):
        equal(f"d_{name}_results_equal_fault_free", d[name],
              d["fault_free"], results_only=True)
        r = d[name]
        assert r.fault_build_failures > 0, name
        assert r.fault_scan_retries + r.fault_stragglers > 0, name
        assert r.cumulative_ms > d["fault_free"].cumulative_ms, name
    # Off, every failed quantum is dropped: never retried or quarantined.
    assert d["no_recovery"].fault_quarantined_builds == 0
    emit(dict(phase="lane_faults", schedule=sched, **{
        name: dict(slo(r), scan_retries=r.fault_scan_retries,
                   stragglers=r.fault_stragglers,
                   build_failures=r.fault_build_failures,
                   quarantined=r.fault_quarantined_builds,
                   tuner_work_units=r.tuner_work_units,
                   availability=r.availability)
        for name, r in d.items()}))

    # (e): phase 8(e)'s configuration (crack-on-scan and decay on the
    # read_heavy workload, default tuner, FAST) on the overlap lane.
    # FAST fires about one cycle per burst here, and a burst gives the
    # lane one or two drains: with the default 8-page quanta the queue
    # outgrows its cap and the drains escalate (213 times on the H100;
    # 208 on the CPU at 1M rows with the interval scaled), so a quantum
    # is one index's cycle slice (the default 32 pages).
    gen = QueryGen(initial, selectivity=0.01, seed=17 + LOOP_PHASE_LEN)
    ewl = hybrid_workload(gen, "read_heavy", total=LOOP_TOTAL,
                          phase_len=LOOP_PHASE_LEN)
    e = arm("e_overlap_crack", ewl, "predictive", dict(num_shards=1),
            dict(tuning_interval_ms=TUNING_FREQ_MS["fast"],
                 async_tuning="overlap", crack_on_scan=True,
                 index_decay=True, build_quantum_pages=32),
            must_launch=("K3",), numpy_check=True, shared_ts=True)
    assert e.tuner_overlapped_ms > 0.0

    emit(dict(phase="build_lane", seconds=time.perf_counter() - t_phase,
              arm_seconds=seconds, peak_bytes=max(peaks), launches=launches,
              table_scan_ms=scan_ms, interval_ratio=ratio,
              budget_scale=scale))
    emit(dict(phase="scale_build_lane",
              reduced=[],
              note=f"{N_ROWS} rows x 21 attrs, page_size {PAGE_SIZE}: "
                   f"phase 3's table; (a)-(d) {LANE_TOTAL} statements "
                   f"(the benchmarks' depth), budgets x{scale} (rows / "
                   f"{LANE_BENCH_ROWS}), intervals, cadences, deadlines "
                   f"and SLOs x{ratio:g} (one table scan here / there); "
                   f"(d) queue cap {LANE_FAULT_QUEUE_CAP} (the "
                   f"benchmark's 16 escalates once faults hold the "
                   f"throttle on); (e) phase 8(e)'s {LOOP_TOTAL} "
                   f"statements, quanta of 32 pages; read bursts of "
                   f"{LOOP_BATCH}"))
    return launches


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


# Device kernels that gather rows by index (``aten::index`` and
# ``index_select``).
GATHER_KERNELS = ("index_elementwise_kernel", "vectorized_gather_kernel",
                  "indexSelect", "gather_kernel")


def range_kernels(prof, name):
    """How many times the profiler range ``name`` was entered, and
    (kernel name, device us) of every device kernel launched inside it:
    by the CPU ops under it, at any depth."""
    from torch.autograd import DeviceType

    stack = [e for e in prof.events()
             if e.name == name and e.device_type == DeviceType.CPU]
    entered, out = len(stack), []
    while stack:
        e = stack.pop()
        out += [(k.name, k.duration) for k in e.kernels]
        stack += e.cpu_children
    return entered, out


def by_name(kernels):
    """[(name, us, count)] of (name, us) pairs, summed by name."""
    tot = {}
    for k, us in kernels:
        t, c = tot.get(k, (0.0, 0))
        tot[k] = (t + us, c + 1)
    return [(k[:60], t / 1e3, c) for k, (t, c) in sorted(
        tot.items(), key=lambda kv: -kv[1][0])]


def profiled(torch, tag, name, fn):
    """Run ``fn`` under torch.profiler; emit its wall time, the device's
    busy time and idle share and the largest kernels by device time
    (the table in build/profile/).  Returns (profiler, busy ms, device
    kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = ROOT / "build" / "profile"
    out.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    (out / f"profile_{tag}_{name}.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=40))
    emit(dict(phase="profile", path=tag, twin=name, wall_ms=wall_ms,
              device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
              kernel_ms_sum=sum(e.self_device_time_total
                                for e in kernels) / 1e3,
              top=[(e.key[:60], e.self_device_time_total / 1e3, e.count)
                   for e in top]))
    return prof, busy_ms, kernels


def profile_bursts(torch, dbk, dbp, tag, make_scans):
    """Device time by kernel name for one burst of each twin (each
    twin's scans from one call of ``make_scans``), and on a line of its
    own the gather kernels of the index half (those launched inside
    ``hybrid_scan.GATHER_RANGE``) beside every gather kernel of the
    burst (crack adoption's page gathers and coverage writes
    included)."""
    from repro_torch.core.hybrid_scan import GATHER_RANGE

    for name, db, use_kernel in (("kernel", dbk, True),
                                 ("plain", dbp, False)):
        scans = make_scans()
        prof, busy_ms, kernels = profiled(
            torch, tag, name,
            lambda: db.execute_batch(scans, use_kernel=use_kernel))
        probes, in_range = range_kernels(prof, GATHER_RANGE)
        half = [(k, us) for k, us in in_range
                if any(g in k for g in GATHER_KERNELS)]
        gather_ms = sum(us for _, us in half) / 1e3
        burst = [e for e in kernels
                 if any(g in e.key for g in GATHER_KERNELS)]
        burst_ms = sum(e.self_device_time_total for e in burst) / 1e3
        emit(dict(phase="profile_gathers", path=tag, twin=name,
                  probes=probes, gather_ms=gather_ms,
                  share_of_busy=gather_ms / busy_ms,
                  range_ms=sum(us for _, us in in_range) / 1e3,
                  kernels=by_name(half),
                  burst_gather_ms=burst_ms,
                  burst_kernels=[(e.key[:60], e.self_device_time_total / 1e3,
                                  e.count) for e in burst]))


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

    profile = "--profile" in argv

    def memory(phase):
        """Peak device memory of the phase just run; resets the peak."""
        emit(dict(phase="memory", of=phase,
                  max_memory_allocated=torch.cuda.max_memory_allocated()))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    tab = kernel_table(torch, dev)
    kr = phase_kernels(torch, bfa, fa, tab)
    k3 = phase_masked_kernel(torch, bfa, tab)
    k4 = phase_sharded_kernel(torch, bfa, tab)
    del tab
    memory("kernels (phases 2, 4, 6)")
    k1_launches, k2_launches, record, initial = phase_main_path(
        torch, bfa, fa, dev, profile)
    memory("main path (phase 3)")
    k3_launches = phase_masked_path(torch, bfa, fa, dev, profile)
    memory("masked path (phase 5)")
    k4_launches, k3_sharded = phase_sharded_path(torch, bfa, fa, profile,
                                                 record, initial)
    memory("sharded path (phase 7)")
    loop = phase_closed_loop(torch, bfa, initial, profile)  # own peak
    base = phase_baselines(torch, bfa, initial)  # own peak
    lane = phase_build_lane(torch, bfa, initial)  # own peak
    del initial
    emit(dict(phase="main_path_launches", K1=k1_launches, K2=k2_launches,
              K3_phase5=k3_launches, K3_phase7=k3_sharded, K4=k4_launches,
              phase8=loop, phase9=base, phase10=lane))

    k1, k2 = kr[("K1", 8)], kr[("K2", 1)]
    kernels = [
        dict(name="K1 batched_filter_agg", route="cuda",
             source="src/repro_torch/kernels/csrc/filter_agg.cu",
             replaces="src/repro/kernels/batched_filter_agg.py:163",
             launches=k1_launches + loop["K1"] + base["K1"] + lane["K1"],
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
        dict(name="K3 sharded_batched_filter_agg_masked", route="cuda",
             source="src/repro_torch/kernels/csrc/filter_agg.cu",
             replaces="src/repro/kernels/batched_filter_agg.py:483",
             launches=(k3_launches + k3_sharded + loop["K3"] + base["K3"]
                       + lane["K3"]),
             max_abs_err=k3["max_abs_err"],
             ms=k3["kernel_ms"], plain_ms=k3["plain_ms"],
             bound_ms=k3["bound_ms"], bound_by=k3["bound_by"],
             library_ms=None),
        dict(name="K4 sharded_batched_filter_agg", route="cuda",
             source="src/repro_torch/kernels/csrc/filter_agg.cu",
             replaces="src/repro/kernels/batched_filter_agg.py:308",
             launches=k4_launches + loop["K4"] + base["K4"] + lane["K4"],
             max_abs_err=k4["max_abs_err"],
             ms=k4["kernel_ms"], plain_ms=k4["plain_ms"],
             bound_ms=k4["bound_ms"], bound_by=k4["bound_by"],
             library_ms=None),
    ]
    for k, row in zip(kernels, (k1, k2, k3, k4)):
        k["share_of_bound"] = k["bound_ms"] / k["ms"]
        k["device_ms"] = row["device_ms"]
        k["host_ms"] = row["host_ms"]
        k["device_share_of_bound"] = k["bound_ms"] / k["device_ms"]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
