"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by its name: the repository's, and a copy holding an addition
made as a later PR makes one (`helpers.planted_addition`)."""

import re

import pytest

from helpers import bench, tree  # noqa: F401

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_and_paths(tree):
    b = bench(tree)
    assert set(b) == TOP_KEYS
    assert b["command"] == ["python3", "fgbench/run.py"]
    assert b["paths"] == ["fgbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len((tree / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters(tree):
    b = bench(tree)
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for c in b["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    assert len(set(names)) == len(names)


def test_metric_keys_and_bounds(tree):
    b = bench(tree)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("kind", ["configs", "workloads", "per_layer"])
def test_every_file_is_found_by_name(kind, tree):
    import json

    b = bench(tree)
    fgbench = tree / "fgbench"
    cells = {w["name"] for w in b["workloads"]}
    for e in b[kind]:
        if kind == "configs":
            path = tree / e["file"]
            assert path.is_file() and path.parent == fgbench / "configs" and path.stem == e["name"]
            cfg = json.loads(path.read_text())
            assert cfg["source"] == e["source"]
            assert set(cfg["reduced"]) == set(e["reduced"])
        elif kind == "workloads":
            assert (fgbench / "configs" / f"{e['config']}.json").is_file()
            traffic = json.loads((fgbench / "traffic" / f"{e['traffic']}.json").read_text())
            assert (fgbench / f"{traffic['kind']}.py").is_file()
        else:
            assert (fgbench / "metrics" / f"{e['name']}.py").is_file()
            assert set(e.get("workloads", cells)) <= cells


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(tree):
    b = bench(tree)
    for w in b["workloads"]:
        name = w["name"]
        e2e = [m["name"] for m in b["end_to_end"] if name in m.get("workloads", [name])]
        per = [m["name"] for m in b["per_layer"] if name in m.get("workloads", [name])]
        assert "setup_s" in e2e and len(e2e) >= 2 and per, name
