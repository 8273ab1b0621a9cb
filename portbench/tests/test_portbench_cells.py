"""Whole runs of the cells at a size the CPU holds (the port's plain
versions in place of its kernels): a sound run is correct; the control,
and each fault the cells can have planted under the timed path, are not;
a cell, a traffic mix and a metric are added from new files alone."""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _portbench_tiny import ROOT, make_root
from portbench import harness
from portbench.datasets import cluster_sizes, make_points

CELLS = [w["name"] for w in harness.load_manifest(ROOT)["workloads"]]
SEED = 2 ** 31 + 977


def _run(root, cell, **kw):
    return harness.run_cell(root, cell, kw.pop("seed", SEED), 0.2, False,
                            device="cpu", **kw)


def _failed_checks(result):
    return {k for k, c in result["checks"].items()
            if c["value"] is None or c["value"] > c["limit"]}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_reports_its_metrics(tiny_root, cell):
    result = _run(tiny_root, cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 10
    assert result["attempted"] % 10 == 0
    manifest = harness.load_manifest(tiny_root)
    wanted = {m["name"] for m in harness.metric_entries(manifest, cell,
                                                        "end_to_end")}
    assert wanted - {"peak_device_gib"} == set(result["metrics"])
    assert list(result)[-1] == "checks"
    assert result["checks"]["prepare_differ"]["value"] == 0
    assert result["checks"]["centers_differ"]["value"] == 0
    assert result["checks"]["lanes_alike"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_is_not_correct(tiny_root, cell):
    result = _run(tiny_root, cell, control=True)
    assert not result["correct"]
    assert {"cost_gap", "centers_differ"} <= _failed_checks(result)


# The check each fault has to fail, at least.
FAULTS = {"state_unchanged": {"centers_differ", "law_z"},
          "half_the_rows": {"cost_gap"},
          "center_altered": {"centers_differ"},
         "lanes_shared": {"lanes_alike"},
          "cost_altered": {"cost_gap"}}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_under_the_timed_path_is_not_correct(tiny_root, cell, fault):
    result = _run(tiny_root, cell, fault=fault)
    assert not result["correct"]
    assert FAULTS[fault] & _failed_checks(result)


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_a_mix_and_a_metric_from_new_files_alone(tmp_path):
    root = make_root(tmp_path)
    before = _digest(root)
    bench = root / "portbench"
    cfg = json.loads((bench / "configs" / "census-fastkmeanspp.json")
                     .read_text())
    cfg.update(name="small-fastkmeanspp")
    cfg["data"].update(n=1500, d=5)
    cfg["cluster"]["k"] = 20
    (bench / "configs" / "small-fastkmeanspp.json").write_text(
        json.dumps(cfg))
    (bench / "traffic" / "x3.json").write_text(json.dumps(
        {"name": "x3", "lanes": 3, "warmup_requests": 1}))
    (bench / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return float(len(run.answered))\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append(
        {"name": "small-fastkmeanspp", "source": cfg["source"],
         "file": "portbench/configs/small-fastkmeanspp.json",
         "reduced": [], "why": "a small copy"})
    manifest["workloads"].append(
        {"name": "small-x3", "config": "small-fastkmeanspp",
         "traffic": "x3", "chips": 1, "why": "three lanes"})
    manifest["end_to_end"].append(
        {"name": "requests_done", "unit": "requests", "better": "higher",
         "bound": 0.25, "source": "host_clock", "workloads": ["small-x3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    after = _digest(root)
    assert all(after[f] == h for f, h in before.items()
               if f != "BENCHMARK.json")
    result = _run(root, "small-x3")
    assert result["correct"], result["checks"]
    assert result["attempted"] % 3 == 0
    assert result["metrics"]["requests_done"]["value"] >= 1
    assert result["metrics"]["requests_done"]["unit"] == "requests"
    assert "requests_done" not in _run(root, CELLS[-1])["metrics"]


@pytest.mark.parametrize("extra", [{"loop": "open"}, {"clients": 4}])
def test_a_mix_with_a_key_the_loop_does_not_read_is_refused(tiny_root,
                                                             extra):
    path = tiny_root / "portbench" / "traffic" / "x10.json"
    mix = json.loads(path.read_text())
    assert set(mix) <= harness.MIX_KEYS
    path.write_text(json.dumps(dict(mix, **extra)))
    with pytest.raises(ValueError, match=next(iter(extra))):
        _run(tiny_root, CELLS[0])


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from portbench import harness\n"
        "from portbench.isolation import forbidden_modules\n"
        "r = harness.run_cell(%r, %r, 5, 0.1, False, device='cpu')\n"
        "assert r['correct'], r['checks']\n"
        "print(forbidden_modules())\n"
        % (str(ROOT / "src"), str(ROOT), str(tiny_root), CELLS[0]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_a_checkout_without_the_port(tmp_path):
    (tmp_path / "portbench").mkdir()
    for f in ("BENCHMARK.json",):
        (tmp_path / f).write_bytes((ROOT / f).read_bytes())
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_seeds_and_points_repeat_for_a_seed_and_differ_across_seeds():
    big = 2 ** 31 + 12345
    assert harness.derive_seeds(big)["data"] == harness.derive_seeds(
        big)["data"]
    assert harness.derive_seeds(big)["spec"] != harness.derive_seeds(
        big + 1)["spec"]
    seeds = [harness.request_seeds(big, r, 10) for r in range(3)]
    assert all(len(set(s)) == 10 for s in seeds)
    assert not set(seeds[0]) & set(seeds[1])
    law = {"n": 5000, "d": 4, "clusters": 20, "size_exponent": 1.3,
           "center_scale": 12.0, "spread_low": 0.3, "spread_high": 3.0,
           "structure_seed": 0}
    a = make_points(law, big, "cpu")
    assert a.shape == (5000, 4) and a.dtype == np.float64
    np.testing.assert_array_equal(a, make_points(law, big, "cpu"))
    assert not np.array_equal(a, make_points(law, big + 1, "cpu"))
    sizes = cluster_sizes(5000, 20, 1.3)
    assert sizes.sum() == 5000 and (np.diff(sizes) <= 0).all()
    assert torch.get_default_dtype() == torch.float32
