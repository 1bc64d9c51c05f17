"""The reader of build_s on synthetic builds of the port's tracer: the first
calls and captures before the profiled requests, less the nvcc builds they
hold, and nothing from a port without the tracer."""

import sys

import pytest

from convectionkernels_tpu_torch import tracing
from harness import spec, trace

REQUESTS = [trace.Span("request", 1_000, 2_000)]


def _view():
    return trace.view([], REQUESTS, texels=16, csrc_kernels=(),
                      bound_ms=None)


def _build(name, start, end):
    return tracing.Build(name, start, end, {})


def test_build_s_sums_first_calls_and_captures_less_their_nvcc(
        monkeypatch):
    monkeypatch.setattr(tracing, "_builds", [
        _build("kernel_build", 100, 300),      # inside the first call
        _build("first_call", 50, 450),
        _build("capture", 500, 600),
        _build("kernel_build", 700, 900),      # outside any: not the program's
        _build("capture", 1_500, 1_700)])      # inside the profiled requests
    read = spec.metric_reader("build_s")
    assert read(_view()) == pytest.approx((400 - 200 + 100) / 1e9)
    monkeypatch.setattr(tracing, "_builds", [_build("kernel_build", 1, 2)])
    assert read(_view()) is None
    monkeypatch.setattr(tracing, "_builds", [])
    assert read(_view()) is None


def test_build_s_reads_the_tracers_own_builds(monkeypatch):
    monkeypatch.setattr(tracing, "_builds", [])
    with tracing.build("first_call", bucket=256):
        with tracing.build("kernel_build", libraries="shape_pca"):
            pass
    (kernel, first) = tracing.builds()
    view = trace.view([], [trace.Span("request", first.end + 1,
                                      first.end + 2)], 16, (), None)
    assert spec.metric_reader("build_s")(view) == pytest.approx(
        (first.end - first.start - (kernel.end - kernel.start)) / 1e9)


def test_build_s_is_nothing_without_the_tracer(monkeypatch):
    monkeypatch.setitem(sys.modules, "convectionkernels_tpu_torch.tracing",
                        None)
    monkeypatch.delattr(sys.modules["convectionkernels_tpu_torch"],
                        "tracing")
    assert spec.metric_reader("build_s")(_view()) is None
