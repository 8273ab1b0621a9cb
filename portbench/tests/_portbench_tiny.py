"""A checkout of the benchmark whose configurations are cut to a size a
CPU test holds."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# Small enough for the CPU, large enough that each lane opens many centers.
TINY = {"n": 2000, "d": 8, "clusters": 30, "k": 60}


def make_root(dest: Path, **sizes) -> Path:
    """A copy of the benchmark (manifest and `portbench/`) under `dest`,
    every configuration cut to `TINY` updated by `sizes`."""
    size = dict(TINY, **sizes)
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        cfg["data"].update(n=size["n"], d=size["d"],
                           clusters=size["clusters"])
        cfg["cluster"]["k"] = size["k"]
        cfg["law_lanes"] = 10
        path.write_text(json.dumps(cfg, indent=1))
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return dest
