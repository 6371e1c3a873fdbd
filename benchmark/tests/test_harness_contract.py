"""BENCHMARK.json against the rules it is held to, and the harness's files
for each of its names."""
from __future__ import annotations

import json
import os
import re

import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    b = tiny.bench()
    assert set(b) == KEYS
    assert os.path.getsize(os.path.join(tiny.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert not any(w.startswith("/") or ".." in w for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits 43,200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    b = tiny.bench()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        names = [e["name"] for e in b[group]]
        assert len(names) == len(set(names))
        for e in b[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and _line(e["why"])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"])
    for c in b["configs"]:
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)


def test_cells_metrics_and_files():
    b = tiny.bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"]: w for w in b["workloads"]}
    configs = {c["name"]: c for c in b["configs"]}
    assert {w["config"] for w in cells.values()} == set(configs)
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith(tuple(p + "/" for p in b["paths"])) and PATH.match(f)
        assert os.path.isfile(os.path.join(tiny.ROOT, f))
    for name, w in cells.items():
        reports = {m for m, e in e2e.items() if name in e.get("workloads", [name])}
        assert "setup_s" in reports and len(reports) >= 2, name
        assert os.path.isfile(os.path.join(tiny.ROOT, "benchmark", "workloads", name + ".json"))
        assert os.path.isfile(os.path.join(tiny.ROOT, "benchmark", "traffic",
                                           w["traffic"] + ".json"))
        layer = [m for m in b["per_layer"] if name in m["workloads"]]
        assert layer, name
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for name in m["workloads"]:
            assert name in cells and name in e2e[m["moves"]].get("workloads", [name]), (m, name)
        assert os.path.isfile(os.path.join(tiny.ROOT, "benchmark", "metrics",
                                           m["name"].split(".")[0] + ".py"))
    # one pair of configuration and traffic a cell
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(pairs) == len(set(pairs))


def test_roofline_and_mfu_names():
    b = tiny.bench()
    for m in b["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for roof in (m for m in b["per_layer"] if m["name"].endswith("_roofline")):
        assert any("mfu" in m["name"] and m["moves"] == roof["moves"]
                   and set(roof["workloads"]) <= set(m["workloads"]) for m in b["per_layer"])


def test_cell_files_state_their_checks():
    for w in tiny.bench()["workloads"]:
        c = tiny.cell(w["name"])
        assert c["cell"]["checks"] and all(isinstance(v, (int, float)) and v >= 0
                                           for v in c["cell"]["checks"].values())
        assert json.dumps(c)   # every file is JSON
