"""Run one cell as ``run.py`` does, with the program's tracer on in the
window, and read the program's spans beside the device trace.

    python3 pibench/program_run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--out <file>]

``harness.main`` runs, checks and prints the cell as for ``run.py``;
the one difference is that the program's tracer
(``repro_torch.telemetry``) is switched on just before the window opens
and drained after it closes (set-up and the warm-up run with it off).
``run.py`` is the same run with the tracer off.  The result line
carries the metrics that read the program's spans and counters
(``program_trace.METRICS``) in ``metrics``, and ``program``: the spans'
idle time, largest first, and, traced, how the program's spans agree
with the harness's own timers.  ``--out`` writes the whole summary of
the spans there as JSON.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    # run.py, imported from beside this script: the caches under
    # build/pibench/ and the import path (the checkout's root and its
    # sources) as the benchmark's own runs have them.
    import run  # noqa: F401

from pibench import harness, program_trace  # noqa: E402


def consistency(summary, cycle_walls_s, idle_gaps) -> dict:
    """The program's spans against the harness's timers in one traced
    run: the cycles' summed walls; the share of ``tuner.cycle``'s wall
    that ``tuner.decide``'s stages and ``index.build`` take; the idle
    time program spans hold inside the harness's ``tuning_cycle``
    against the harness's own reading of it."""
    sp, tree = summary["spans"], summary["tree"]
    cycle = sp.get("tuner.cycle")
    if not cycle:
        return {}
    wall = cycle["total"]["wall_s"]
    stages = sum(v[1] for v in tree.get("tuner.decide", {}).values())
    builds = tree.get("tuner.cycle", {}).get("index.build", [0, 0.0])[1]
    within = summary["idle_within"].get("tuning_cycle", {})
    return {
        "cycle_wall_s": wall,
        "harness_cycle_wall_s": sum(cycle_walls_s),
        "cycle_wall_ratio": wall / sum(cycle_walls_s) if cycle_walls_s
        else None,
        "stages_and_builds_share": (stages + builds) / wall if wall else None,
        "idle_in_tuning_cycle_s": sum(within.values()),
        "idle_in_tuning_cycle_under_spans_s": sum(
            v for k, v in within.items() if k != "-"),
        "harness_idle_tuning_cycle_s": dict(idle_gaps).get("tuning_cycle"),
    }


def run_with_tracer(cell, seed, seconds, traced, device="cuda:0",
                    t_start=None, log=sys.stderr, marks=None):
    """``harness.run_cell`` with the tracer on in the window; returns its
    result and what was read of the program's spans."""
    from repro_torch import telemetry

    got = {}

    def measure_traced(*args, **kw):
        telemetry.drain()
        telemetry.enable()
        try:
            w = _MEASURE(*args, **kw)
        finally:
            telemetry.disable()
        t = time.perf_counter()
        prof = w["prof"]
        events = prof.profiler.kineto_results.events() if prof else ()
        got["summary"] = program_trace.summarize(
            telemetry.drain(), events, w["t0_ns"], w["t1_ns"],
            outer=w["probes"].spans)
        got["read_s"] = time.perf_counter() - t
        got["cycle_walls_s"] = list(w["probes"].cycle_walls)
        return w

    harness.measure = measure_traced
    try:
        result, _ = _RUN_CELL(cell, seed, seconds, traced, device=device,
                              t_start=t_start, log=log, marks=marks)
    finally:
        harness.measure = _MEASURE
    return result, got


def add_program(result, got) -> dict:
    """Put the program's metrics and ``program`` on the result line."""
    s = got["summary"]
    result["metrics"].update(program_trace.metrics(s))
    program = {"idle_by_span": program_trace.idle_by_span(s),
               "read_s": got["read_s"],
               "runtime_calls": s["runtime_calls"],
               "counts": s["counts"]}
    if "breakdown" in result:
        program["consistency"] = consistency(
            s, got["cycle_walls_s"], result["breakdown"]["idle_gaps"])
    result["program"] = program
    return result


_RUN_CELL, _MEASURE = harness.run_cell, harness.measure


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser(prog="pibench/program_run.py",
                                add_help=False)
    p.add_argument("--out", type=Path)
    args, rest = p.parse_known_args(argv)

    def run_cell(cell, seed, seconds, traced, **kw):
        result, got = run_with_tracer(cell, seed, seconds, traced, **kw)
        add_program(result, got)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(dict(
                cell=cell.name, seed=seed, result=result,
                summary=got["summary"])))
        print(json.dumps(dict(
            cell=cell.name, seed=seed,
            idle_by_span=result["program"]["idle_by_span"])),
            file=kw.get("log", sys.stderr))
        return result, None

    harness.run_cell = run_cell
    try:
        return harness.main(rest, t_start)
    finally:
        harness.run_cell = _RUN_CELL


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
