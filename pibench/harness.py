"""One run of one cell: set-up, the measured window, the check.

Set-up makes the cell's table on the device from the seed (the
configuration's sizes, the TUNER law), hands it to the program through
its own ``make_table`` / ``Database``, makes the tuner, and warms up on a
copy of the table with the cell's own traffic from another stream of
the seed, so that every kernel the window launches is built and loaded
before it opens.  The window drives ``repro_torch.api.run_workload``
(the closed loop) over consecutive segments of the statement stream,
one call per segment, on one ``Database`` and one tuner, from an empty
index catalog; it closes at the first segment boundary past
``--seconds`` (or before a segment whose updates could outgrow the
table's free slots).  Then the program's answers are compared with the
plain reference's (``pibench/reference``), run after the program's
state is freed, and the cell's metrics are read by their readers
(``pibench/metrics/<name>.py``).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import sys
import time

import torch

from pibench import bounds, datagen, digest, guard, spec
from pibench import trace as trace_reader
from pibench.reference.serial_store import SerialStore
from pibench.spans import Probes
from pibench.traffic import Traffic

NEVER_TS = INF_TS = 2**31 - 1  # an unoccupied slot's begin; a live end


class Run:
    """What one run measured, for the metric readers."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


# -- the program under test ---------------------------------------------

def capacity_pages(cfg) -> int:
    return int(math.ceil(cfg["n_rows"] / cfg["page_size"] * cfg["headroom"]))


def make_table(cfg, seed: int, device):
    """The configuration's table on ``device``: the port's own empty
    table, its first ``n_rows`` slots filled from the seed and made
    visible at timestamp 0, as ``core.table.load_table`` loads rows."""
    from repro_torch.core.table import make_table as port_make_table

    n = int(cfg["n_rows"])
    t = port_make_table(capacity_pages(cfg), int(cfg["page_size"]),
                        int(cfg["n_attrs"]), device=device)
    datagen.fill_columns(lambda a: t.data[..., a].reshape(-1),
                         int(cfg["n_attrs"]), n, seed)
    t.begin_ts.view(-1)[:n] = 0
    return t._replace(n_rows=n)


def make_program(table, cfg, traffic):
    """(Database, tuner, RunConfig) of the configuration and mix."""
    from repro_torch.api import (TUNING_FREQ_MS, Database, ExecOptions,
                                 RunConfig, TunerConfig, TuningOptions,
                                 make_dl_tuner)

    db = Database({cfg["table"]: table},
                  time_per_unit_ms=float(cfg["time_per_unit_ms"]))
    if db.update_cap != int(cfg["update_cap"]):
        raise RuntimeError(f"the program changes {db.update_cap} rows per "
                           f"UPDATE; the configuration states "
                           f"{cfg['update_cap']}")
    tuner = make_dl_tuner(db, cfg["tuner"], TunerConfig(
        storage_budget_bytes=float(cfg["storage_budget_bytes"])))
    # The mix's ``options`` are the runner's tuning options by name
    # (crack_on_scan, index_decay, async_tuning, ...).
    rc = RunConfig(
        execution=ExecOptions(read_batch_size=int(traffic["read_batch_size"]),
                              use_kernel=bool(cfg["use_kernel"])),
        tuning=TuningOptions(
            tuning_interval_ms=TUNING_FREQ_MS[cfg["tuning_frequency"]],
            **traffic.get("options", {})),
        time_per_unit_ms=float(cfg["time_per_unit_ms"]))
    return db, tuner, rc


def to_workload(table: str, items):
    """The program's ``Workload`` of (phase, Stmt) items, and its
    queries in order."""
    from repro_torch.api import Query, Workload

    out = []
    for phase, s in items:
        kw = dict(agg_attr=s.agg_attr) if s.kind == "scan" else {}
        out.append((phase, Query(
            kind=s.kind, table=table, attrs=s.attrs, los=s.los, his=s.his,
            proj_attrs=s.proj_attrs, set_attrs=s.set_attrs,
            set_vals=s.set_vals, template=s.template, **kw)))
    return Workload(out), [q for _, q in out]


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def warm_up(table, cfg, traffic, quantiles, seed: int, device) -> None:
    """Run the cell's traffic (another stream of the seed) on a copy of
    the table with a tuner of its own, then free both: the window's
    kernels are then built, loaded and warm."""
    from repro_torch.api import run_workload
    from repro_torch.core.table import clone_table

    copy = clone_table(table)
    db, tuner, rc = make_program(copy, cfg, traffic)
    gen = Traffic(traffic, int(cfg["n_attrs"]), quantiles, seed, stream=1)
    for k in range(int(traffic["warmup_statements"])
                   // gen.seg_len):
        wl, _ = to_workload(cfg["table"], gen.segment(k))
        run_workload(db, tuner, wl, rc)
    synchronize(device)
    del db, tuner, rc, copy


# -- the window -----------------------------------------------------------

def measure(db, tuner, rc, cfg, gen, seconds: float, traced: bool, device):
    """Drive the closed loop over segments until ``seconds`` have passed;
    returns the probes, the statements sent, and the window's marks."""
    from repro_torch.api import run_workload

    probes = Probes(db, tuner, traced)
    sent, queries = [], []
    prof = None
    if traced and torch.device(device).type == "cuda":
        # Device activity only: the host's side of the trace is the
        # harness's own spans, which cost nothing per operator.
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    synchronize(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    closed_by, stop_s = "seconds", 0.0
    t0, t0_ns = time.perf_counter(), time.time_ns()
    seg = 0
    try:
        while True:
            items = gen.segment(seg)
            table = db.tables[cfg["table"]]
            free = table.capacity - table.n_rows
            if gen.max_new_rows(items, db.update_cap) > free:
                closed_by = "headroom"
                break
            wl, qs = to_workload(cfg["table"], items)
            run_workload(db, tuner, wl, rc)
            sent += [s for _, s in items]
            queries += qs
            seg += 1
            if time.perf_counter() - t0 >= seconds:
                break
        synchronize(device)
        t1, t1_ns = time.perf_counter(), time.time_ns()
    finally:
        if prof is not None:
            t_stop = time.perf_counter()
            prof.stop()
            stop_s = time.perf_counter() - t_stop
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    return dict(probes=probes, sent=sent, queries=queries, t0=t0, t1=t1,
                t0_ns=t0_ns, t1_ns=t1_ns, prof=prof, peak=peak,
                segments=seg, closed_by=closed_by, stop_s=stop_s)


def kernel_bounds(probes):
    """Summed least seconds of the window's K1 and K3 launches."""
    k1 = sum(bounds.k1_bound_s(n_pages, psz, planes, starts.tolist())
             for n_pages, psz, planes, starts in probes.k1)
    k3 = 0.0
    for psz, planes, nq, words, local in probes.k3:
        w = words.tolist()
        k3 += bounds.k3_bound_s(bounds.uncovered_pages(w, local.tolist()),
                                psz, planes, nq, len(w) * len(w[0]))
    return k1, k3


def table_digest(table, n_attrs: int):
    live = ((table.begin_ts.reshape(-1) != NEVER_TS)
            & (table.end_ts.reshape(-1) == INF_TS))
    return digest.rows_digest(lambda a: table.data[..., a].reshape(-1),
                              n_attrs, live)


# -- the check --------------------------------------------------------------

def reference_answers(cfg, seed: int, sent, device, agg_dtype=torch.int64):
    """The plain reference's answers to ``sent`` and its final digest:
    scans as (sum, count), updates as rows changed."""
    n_attrs = int(cfg["n_attrs"])
    store = SerialStore(n_attrs, capacity_pages(cfg) * int(cfg["page_size"]),
                        device, int(cfg["update_cap"]), agg_dtype)
    datagen.fill_columns(store.plane, n_attrs, int(cfg["n_rows"]), seed)
    store.loaded(int(cfg["n_rows"]))
    scans, out = [], []
    for s in sent:
        if s.kind == "scan":
            scans.append(store.scan(s.attrs, s.los, s.his, s.agg_attr))
            out.append(None)
        else:
            out.append(store.update(s.attrs, s.los, s.his, s.set_attrs,
                                    s.set_vals))
    if scans:
        flat = torch.stack([x for pair in scans for x in pair]).tolist()
        it = iter(zip(flat[0::2], flat[1::2]))
        out = [next(it) if x is None else x for x in out]
    final = digest.rows_digest(store.plane, n_attrs, store.live)
    del store
    return out, final


def compare(sent, answered, want, final_program, final_reference):
    """The numbers ``correct`` is decided on, each with its limit."""
    scan_wrong = update_wrong = 0
    for s, got, ref in zip(sent, answered, want):
        if got is None:
            continue
        if s.kind == "scan":
            scan_wrong += (got[0], got[1]) != tuple(ref)
        else:
            update_wrong += got[2] != ref
    unanswered = sum(a is None for a in answered) + len(sent) - len(answered)
    return {
        "scan_answers_wrong": {"value": scan_wrong, "limit": 0},
        "update_rows_wrong": {"value": update_wrong, "limit": 0},
        "final_rows_wrong": {"value": int(final_program != final_reference),
                             "limit": 0},
        "unanswered": {"value": unanswered, "limit": 0},
    }


# -- metrics ------------------------------------------------------------------

def read_metrics(names, units, run: Run):
    out = {}
    for name in names:
        path = spec.PACKAGE / "metrics" / f"{name}.py"
        loader = importlib.util.spec_from_file_location(
            "pibench.metrics." + name.replace(".", "_"), path)
        module = importlib.util.module_from_spec(loader)
        loader.loader.exec_module(module)
        value = module.read(run)
        if value is not None:
            out[name] = {"value": float(value), "unit": units[name]}
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device="cuda", t_start: float | None = None, log=sys.stderr,
             marks=None):
    """One run of ``cell``; returns the result's fields (the line the
    benchmark prints) and the run's record."""
    t_start = time.perf_counter() if t_start is None else t_start
    cfg, traffic = cell.config, cell.traffic
    if traffic["table"] != cfg["table"]:
        raise ValueError(f"traffic addresses {traffic['table']!r}, the "
                         f"configuration holds {cfg['table']!r}")
    seed = int(seed) % 2**63
    device = torch.device(device)
    n_attrs = int(cfg["n_attrs"])

    marks = dict(marks or {}, start=time.perf_counter() - t_start)
    table = make_table(cfg, seed, device)
    quantiles = datagen.quantile_sample(
        table.data[..., 1].reshape(-1)[:int(cfg["n_rows"])])
    marks["table"] = time.perf_counter() - t_start
    warm_up(table, cfg, traffic, quantiles, seed, device)
    marks["warm_up"] = time.perf_counter() - t_start
    db, tuner, rc = make_program(table, cfg, traffic)
    del table
    gen = Traffic(traffic, n_attrs, quantiles, seed)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    synchronize(device)
    setup_s = time.perf_counter() - t_start

    w = measure(db, tuner, rc, cfg, gen, seconds, traced, device)
    probes, window_s = w["probes"], w["t1"] - w["t0"]
    bad = guard.forbidden_modules()
    if bad:
        raise RuntimeError(f"the run loaded {', '.join(bad)}")
    tr = None
    t_trace = time.perf_counter()
    if w["prof"] is not None:
        tr = trace_reader.summarize(w["prof"], w["t0_ns"], w["t1_ns"],
                                    probes.spans)
    marks["profiler_stop"] = w["stop_s"]
    marks["trace_read"] = time.perf_counter() - t_trace
    k1_bound, k3_bound = kernel_bounds(probes) if traced else (0.0, 0.0)
    position = {id(q): i for i, q in enumerate(w["queries"])}
    answered = [None] * len(w["queries"])
    misplaced = 0
    for k, (q, ans) in enumerate(probes.answered):
        i = position.get(id(q))
        misplaced += i != k
        if i is not None:
            answered[i] = ans
    final_program = table_digest(db.tables[cfg["table"]], n_attrs)
    user_bytes = capacity_pages(cfg) * int(cfg["page_size"]) * n_attrs * 4
    run = Run(
        statements=probes.statements(), window_s=window_s, setup_s=setup_s,
        latencies_ms=probes.latencies_ms(w["t0"]), peak_bytes=w["peak"],
        user_bytes=user_bytes, traced=traced, trace=tr,
        burst_walls_s=probes.burst_walls, cycle_walls_s=probes.cycle_walls,
        vap_pages=probes.vap_pages, k1_launches=len(probes.k1),
        k3_launches=len(probes.k3), k1_bound_s=k1_bound,
        k3_bound_s=k3_bound, plans=dict(probes.plans))
    probes.remove()
    del db, tuner, rc, probes, w["probes"], w["prof"]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    want, final_reference = reference_answers(cfg, seed, w["sent"], device)
    checks = compare(w["sent"], answered, want, final_program,
                     final_reference)
    checks["answers_out_of_order"] = {"value": misplaced, "limit": 0}
    checks["empty_window"] = {"value": int(not w["sent"]), "limit": 0}
    ref_s = time.perf_counter() - t_ref
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    wrong = sum(c["value"] for k, c in checks.items()
                if k in ("scan_answers_wrong", "update_rows_wrong",
                         "unanswered"))
    names = cell.per_layer if traced else cell.end_to_end
    result = {
        "correct": correct,
        "attempted": len(w["sent"]),
        "failed": wrong,
        "metrics": read_metrics(names, cell.units, run),
        "device": device_info(device, run),
    }
    if tr is not None:
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    print(json.dumps(dict(
        cell=cell.name, seed=seed, setup_marks_s=marks,
        segments=w["segments"],
        closed_by=w["closed_by"], statements=run.statements,
        window_s=window_s, setup_s=setup_s, reference_s=ref_s,
        plans=run.plans, k1_launches=run.k1_launches,
        k3_launches=run.k3_launches,
        device_events=tr["device_events"] if tr else None)), file=log)
    return result, run


def device_info(device, run: Run) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(run.peak_bytes)}
    if run.trace is not None:
        info["busy_s"] = run.trace["busy_s"]
        info["window_s"] = run.trace["window_s"]
    return info


def parse_args(argv):
    p = argparse.ArgumentParser(prog="pibench/run.py", description=(
        "Run one cell of the benchmark once and print its result line."))
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    marks = {"imports": time.perf_counter() - t_start}
    args = parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("pibench: no CUDA device; the benchmark runs on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"pibench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    marks["cuda"] = time.perf_counter() - t_start
    result, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         device="cuda:0", t_start=t_start, marks=marks)
    bad = guard.forbidden_modules()
    if bad:
        print(f"pibench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
