"""The metric arithmetic: the p95 over every request, texels without the
pad, the union of device intervals, and each per-layer reader."""

import numpy as np
import pytest

from harness import runner, spec, trace

OPS = [trace.Op("void (anonymous namespace)::single_plane_kernel<3>"
                "(Params)", "kernel", 10, 30),
       trace.Op("_ZN12_GLOBAL__N_116shape_pca_kernelEPKi", "kernel", 25,
                40),
       trace.Op("elementwise_kernel", "kernel", 50, 60),
       trace.Op("Memcpy DtoH (Device -> Pageable)", "memcpy", 90, 95)]
REQUESTS = [trace.Span("request", 0, 70), trace.Span("request", 80, 100)]
SPANS = REQUESTS + [trace.Span("encode_call", 0, 5),
                    trace.Span("to_host", 5, 70),
                    trace.Span("between_requests", 70, 80),
                    trace.Span("to_host", 85, 100)]
CSRC = ("shape_pca_kernel", "single_plane_kernel", "dual_plane_kernel",
        "bc6h_group_kernel")


HOST = trace.HostTimes(settle_ms=[12.0, 13.0, 11.0, 12.5, 14.0, 10.0],
                       request_ms=[10.0, 9.0, 11.0, 10.0],
                       enqueue_ms=[0.8, 0.7, 0.9, 2.0])


def _view(bound_ms=None, host=HOST):
    return trace.view(OPS, SPANS, texels=2_000_000, csrc_kernels=CSRC,
                      bound_ms=bound_ms, host=host)


def test_p95_is_numpys_over_every_request():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 40, 333):
        v = rng.gamma(2.0, 10.0, n).tolist()
        assert runner.percentile(v, 95) == pytest.approx(
            np.percentile(v, 95), rel=1e-12)


def test_union_covered_and_gaps():
    merged = trace.union([(10, 30), (25, 40), (50, 60), (90, 95)])
    assert merged == [(10, 40), (50, 60), (90, 95)]
    assert trace.covered(merged, 0, 100) == 45
    assert trace.covered(merged, 35, 55) == 10
    assert trace.gaps(merged, 0, 100) == [(0, 10), (40, 50), (60, 90),
                                          (95, 100)]


def test_kernel_names_are_read_from_demangled_and_mangled_symbols():
    of = trace.csrc_kernel_of
    assert of(OPS[0].name, CSRC) == "single_plane_kernel"
    assert of(OPS[1].name, CSRC) == "shape_pca_kernel"
    assert of("void (anonymous namespace)::dual_plane_kernel(Params)",
              CSRC) == "dual_plane_kernel"
    assert of("_ZN12_GLOBAL__N_117bc6h_group_kernelENS_6ParamsE",
              CSRC) == "bc6h_group_kernel"
    assert of("void at::native::vectorized_elementwise_kernel<4>(int)",
              CSRC) is None
    assert of("my_shape_pca_kernel(int)", CSRC) is None
    v = _view()
    assert [v.is_csrc(o) for o in OPS] == [True, True, False, False]


def _read(name, view):
    return spec.metric_reader(name)(view)


def test_the_per_layer_readers():
    v = _view(bound_ms=15e-6)             # 15 ns of bound
    assert v.interval == (0, 100) and v.busy_ns() == 45
    assert v.window_ns() == 100
    # the host clock's readings, not the trace's: the median enqueue time,
    # and the first 5 settle requests' median (12.5) over the window's (10)
    assert _read("host_enqueue_ms_per_request.tiles", v) == pytest.approx(
        0.85)
    assert _read("settle_slowdown", v) == pytest.approx(25.0)
    assert _read("device_ops_per_request.tiles", v) == 2.0
    assert _read("kernel_ms_per_mtexel.bake", v) == pytest.approx(
        35 / 1e6 / 2.0)
    assert _read("torch_ops_ms_per_mtexel.bake", v) == pytest.approx(
        10 / 1e6 / 2.0)
    # sum of bounds over the sum of the same kernels' time
    assert _read("csrc_kernels_roofline", v) == pytest.approx(
        100 * 15 / 35)
    assert _read("csrc_kernels_roofline", _view()) is None


def test_a_reader_with_nothing_to_read_returns_nothing():
    empty = trace.TraceView([], [], REQUESTS, 0, (0, 100),
                            frozenset(CSRC), 1.0)
    for name in ("kernel_ms_per_mtexel.bake", "torch_ops_ms_per_mtexel.bake",
                 "csrc_kernels_roofline", "device_ops_per_request.tiles",
                 "host_enqueue_ms_per_request.tiles", "settle_slowdown"):
        assert _read(name, empty) is None
    short = _view(host=trace.HostTimes([12.0] * 4, [10.0], [1.0]))
    assert _read("settle_slowdown", short) is None   # fewer than 5 settled


def test_breakdown_names_idle_gaps_by_the_innermost_open_span():
    b = trace.breakdown(_view())
    assert b["device_ops"][0] == [OPS[0].name, 20e-9]
    names = dict((g[1], g[0]) for g in b["idle_gaps"])
    assert names[30e-9] == "between_requests"     # 60-90, middle 75
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
