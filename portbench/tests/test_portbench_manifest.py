"""`BENCHMARK.json` against the benchmark's contract, and every file it
names found by its name."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from portbench import harness
from portbench.isolation import FORBIDDEN

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert list(MANIFEST) == ["command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths_stay_inside_the_benchmark():
    paths = MANIFEST["paths"]
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd[1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths)


def test_run_seconds_fit_a_full_check_of_24_cells():
    t = MANIFEST["run_seconds"]
    assert isinstance(t, int) and 1 <= t <= 51
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (t + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    groups = [MANIFEST["configs"], MANIFEST["workloads"], METRICS]
    for group in groups:
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert _line(w["why"]) and NAME.match(w["traffic"])


def test_configs_files_and_cells():
    paths = MANIFEST["paths"]
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    for c in MANIFEST["configs"]:
        assert any(c["file"].startswith(p + "/") for p in paths)
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert 1 <= len(pairs) <= 24
    four = [w for w in MANIFEST["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in MANIFEST["workloads"])
    assert len(four) <= max(1, len(pairs) // 4)


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_it_must(cell):
    e2e = [m["name"] for m in harness.metric_entries(MANIFEST, cell,
                                                     "end_to_end")]
    layer = harness.metric_entries(MANIFEST, cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e


def test_per_layer_entries():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert all(len(spellings) == 1 for spellings in layers.values())


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_is_found_by_name(cell):
    entry, config = harness.find_cell(MANIFEST, cell)
    cfg = json.loads((ROOT / config["file"]).read_text())
    assert (ROOT / "portbench" / "traffic" / f"{entry['traffic']}.json"
            ).is_file()
    for name in cfg["checks"]:
        assert callable(harness.load_reader(ROOT, "checks", name).compute)
    for kind in ("end_to_end", "per_layer"):
        for m in harness.metric_entries(MANIFEST, cell, kind):
            assert callable(harness.load_reader(ROOT, "metrics",
                                                m["name"]).read)


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".", 1)[0] not in FORBIDDEN, (path, name)
