"""BENCHMARK.json keeps to the contract's shapes, and every cell,
configuration, mix and metric it names has its file."""
import json
import re

from pibench import harness, spec

ROOT = spec.ROOT
B = spec.load_benchmark()


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["pibench"]
    assert B["command"][1] == "pibench/run.py"
    assert 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) < 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in B["configs"]]
             + [w["name"] for w in B["workloads"]]
             + [m["name"] for m in B["end_to_end"] + B["per_layer"]]
             + [w["config"] for w in B["workloads"]]
             + [w["traffic"] for w in B["workloads"]]
             + [k for c in B["configs"] for k in c["reduced"]])
    for n in names:
        assert spec.NAME_RE.match(n), n
    for m in B["end_to_end"] + B["per_layer"]:
        assert spec.UNIT_RE.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in spec.SOURCES
    for text in ([c["source"] for c in B["configs"]]
                 + [x["why"] for x in B["configs"] + B["workloads"]]
                 + [m["layer"] for m in B["per_layer"]] + B["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in B[group]]
        assert len(got) == len(set(got)), group


def test_entries_have_only_their_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                           "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                           "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in B["end_to_end"]}


def test_every_name_finds_its_file():
    for c in B["configs"]:
        assert spec.PATH_RE.match(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert harness.capacity_pages(cfg) == cfg["n_pages"]
    cells = {w["name"] for w in B["workloads"]}
    for w in B["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.traffic["table"] == cell.config["table"]
        assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
        assert cell.per_layer
    for m in B["end_to_end"] + B["per_layer"]:
        assert (spec.PACKAGE / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
    for m in B["per_layer"]:
        moved = next(e for e in B["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    assert next(m for m in B["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "pibench").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel
