"""The trace's arithmetic: the union of device spans, the idle gaps and
what the host was doing in them."""

import pytest

from portbench import trace
from portbench.harness import Run, Request


def test_busy_time_is_the_union_of_overlapping_and_nested_spans():
    spans = [(0, 10), (5, 15), (20, 30), (22, 25), (30, 31)]
    assert trace.busy_seconds(spans, per_second=1) == 26
    assert trace.idle_gaps(spans) == [(15, 20)]


def test_gaps_are_named_by_the_device_op_that_ends_them():
    events = [(0, 10, "a"), (12, 20, "b"), (15, 30, "c"), (40, 45, "b"),
              (50, 51, "d")]
    named = dict(trace.name_gaps(events, per_second=1))
    assert named == {"before b": 12, "before d": 5}


def test_kernel_names_are_shortened_to_their_function():
    raw = ("(anonymous namespace)::sweep_kernel((anonymous namespace)"
           "::Sweep)")
    assert trace.short_name(raw) == "sweep_kernel"
    raw = ("void at::native::elementwise_kernel<128, 2, at::native::"
           "gpu_kernel_impl_nocast<at::native::CUDAFunctor_add<float> >("
           "at::TensorIteratorBase&)::{lambda(int)#1}>(int, float)")
    assert trace.short_name(raw) == "at::native::elementwise_kernel"
    gemm = "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x128x8_cublas"
    assert trace.short_name(gemm) == gemm
    tr = trace.Trace(busy_s=1.0, device_events=3, gaps=[],
                     by_name={"sweep_kernel": [2.0, 2],
                              "sweep_tiles_kernel": [1.0, 1],
                              "at::native::sweep_kernel_x": [5.0, 1]})
    assert tr.kernel(("sweep_kernel", "sweep_tiles_kernel")) == (3.0, 3)


def _run(busy, window):
    tr = trace.Trace(busy_s=busy, device_events=1, by_name={}, gaps=[])
    reqs = [Request(t0=0.0, t1=window, seeds=[1])]
    return Run(cell={}, config={}, traffic={}, setup_s=0.0, prepare_s=0.0,
               requests=reqs * 2, peak_bytes=0, shapes={},
               trace=tr, traced=reqs)


def test_idle_share_reader():
    from portbench.harness import load_reader
    from _portbench_tiny import ROOT

    idle = load_reader(ROOT, "metrics", "device_idle_share")
    assert idle.read(_run(busy=3.0, window=4.0)) == pytest.approx(25.0)
    assert idle.read(_run(busy=4.0, window=4.0)) == 0.0
