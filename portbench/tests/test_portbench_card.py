"""The cells on the card at a size a test run holds: the port's kernels
under the timed path.  A sound run is correct; the bfloat16 control and
each planted fault are not.  Skips where there is no card."""

from __future__ import annotations

import pytest

from portbench import harness
from _portbench_tiny import ROOT

CELLS = [w["name"] for w in harness.load_manifest(ROOT)["workloads"]]
FAILS = {"state_unchanged": {"centers_differ", "law_z"},
         "half_the_rows": {"cost_gap"},
         "center_altered": {"centers_differ"},
         "lanes_shared": {"lanes_alike"},
         "cost_altered": {"cost_gap"}}


def _run(root, cell, device, **kw):
    return harness.run_cell(root, cell, 2 ** 31 + 4099, 0.5, False,
                            device=device, **kw)


def _failed(result):
    return {k for k, c in result["checks"].items()
            if c["value"] is None or c["value"] > c["limit"]}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_control_and_faults_on_the_card(tiny_root, cuda_device,
                                                   cell):
    sound = _run(tiny_root, cell, cuda_device)
    assert sound["correct"], sound["checks"]
    assert sound["device"]["platform"] == "gpu"
    assert sound["metrics"]["peak_device_gib"]["value"] > 0
    control = _run(tiny_root, cell, cuda_device, control=True)
    assert not control["correct"]
    for fault, fails in FAILS.items():
        result = _run(tiny_root, cell, cuda_device, fault=fault)
        assert not result["correct"] and fails & _failed(result), fault


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_on_the_card(tiny_root, cuda_device, cell):
    result = harness.run_cell(tiny_root, cell, 77, 0.5, True,
                              device=cuda_device)
    assert result["correct"], result["checks"]
    dev = result["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"] * 1.05
    manifest = harness.load_manifest(tiny_root)
    wanted = {m["name"] for m in harness.metric_entries(manifest, cell,
                                                        "per_layer")}
    assert wanted == set(result["metrics"])
    if "sweep_roofline" in wanted:
        assert 0 < result["metrics"]["sweep_roofline"]["value"] <= 105
    assert result["breakdown"]["device_ops"]
