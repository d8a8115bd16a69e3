"""What a cell is made of, found by name from ``BENCHMARK.json``.

A cell names a configuration and a traffic mix.  The configuration's
file is the one ``BENCHMARK.json`` gives it (under ``pibench/configs/``),
the traffic mix is ``pibench/workloads/<traffic>.json``, and each metric
is read by ``pibench/metrics/<metric name>.py``.  A later change adds a
configuration, a mix or a metric as new files and new entries; no file
here names one.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = Path(__file__).resolve().parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    end_to_end: List[str]
    per_layer: List[str]
    units: Dict[str, str]
    chips: int


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (PACKAGE / "workloads" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name,
        config=config,
        traffic=traffic,
        end_to_end=[m["name"] for m in bench["end_to_end"]
                    if _applies(m, name)],
        per_layer=[m["name"] for m in bench["per_layer"]
                   if _applies(m, name)],
        units={m["name"]: m["unit"]
               for m in bench["end_to_end"] + bench["per_layer"]},
        chips=int(w["chips"]),
    )
