"""The metrics' arithmetic over whole requests, on made-up runs."""

import pytest

from _portbench_tiny import ROOT
from portbench import counts, trace
from portbench.harness import Request, Run, load_reader


def _reader(name):
    return load_reader(ROOT, "metrics", name)


def _run(requests, **kw):
    shapes = {"n": 1000, "n_pad": 1024, "levels": 12, "trees": 3,
              "lanes": 10, "tile": 512, "k": 50}
    return Run(cell={}, config={}, traffic={}, setup_s=kw.get("setup", 1.0),
               prepare_s=kw.get("prepare", 0.5), requests=requests,
               peak_bytes=kw.get("peak", 0), shapes=shapes,
               trace=kw.get("trace"), traced=kw.get("traced", []))


def test_rate_counts_whole_requests_from_the_first_start_to_the_last_end():
    reqs = [Request(t0=10.0, t1=16.0, seeds=list(range(10))),
            Request(t0=16.0, t1=23.0, seeds=list(range(10)))]
    assert _reader("fits_per_s").read(_run(reqs)) == pytest.approx(20 / 13)


def test_a_failed_request_keeps_its_time_and_loses_its_lanes():
    reqs = [Request(t0=0.0, t1=5.0, seeds=[1, 2], error="RuntimeError: x"),
            Request(t0=5.0, t1=10.0, seeds=[3, 4])]
    assert _reader("fits_per_s").read(_run(reqs)) == pytest.approx(0.2)
    assert _reader("fits_per_s").read(_run(reqs[:1])) is None
    last_failed = [Request(t0=0.0, t1=5.0, seeds=[3, 4]),
                   Request(t0=5.0, t1=10.0, seeds=[1, 2], error="x")]
    assert _reader("fits_per_s").read(_run(last_failed)) == pytest.approx(
        0.2)


def test_ops_per_center_and_sweep_roofline():
    tr = trace.Trace(busy_s=1.0, device_events=5000,
                     by_name={"sweep_kernel": [0.002, 100],
                              "sweep_tiles_kernel": [0.001, 50],
                              "other": [5.0, 7]}, gaps=[])
    reqs = [Request(t0=0, t1=1, seeds=[1] * 10)]
    run = _run(reqs, trace=tr, traced=reqs)
    assert _reader("device_ops_per_center").read(run) == 100.0
    step = counts.center_step_bytes(1024, 12, 3, 10, 512)
    want = 100 * counts.bound_seconds(50 * step) / 0.003
    assert _reader("sweep_roofline").read(run) == pytest.approx(want)
    assert _reader("sweep_roofline").read(_run(reqs)) is None


def test_memory_and_spans():
    run = _run([Request(t0=0, t1=1, seeds=[1])], peak=3 << 30, setup=95.5,
               prepare=80.25)
    assert _reader("peak_device_gib").read(run) == 3.0
    assert _reader("setup_s").read(run) == 95.5
    assert _reader("prepare_s").read(run) == 80.25
    assert _reader("peak_device_gib").read(_run([])) is None
