"""The port's build timing (convectionkernels_tpu_torch/tracing.py) on the
CPU: builds always timed, in the order they end, one held inside another;
a block that raises records nothing; the torch profiler's clock;
release_programs() leaving the records; a call on the CPU building
nothing. The card's side (a bucket's first call and capture, each ending
with a synchronize) is in tests/test_torch_cuda.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import convectionkernels_tpu_torch as ckt
from convectionkernels_tpu_torch import programs, tracing


def test_builds_are_timed_in_the_order_they_end():
    n = len(tracing.builds())
    with tracing.build("first_call", bucket=256):
        with tracing.build("kernel_build", libraries="shape_pca"):
            pass
    with tracing.build("capture", torch.device("cpu"), bucket=256):
        pass
    kernel, first, capture = tracing.builds()[n:]
    assert [b.name for b in (kernel, first, capture)] == [
        "kernel_build", "first_call", "capture"]
    assert (kernel.attrs, first.attrs, capture.attrs) == (
        {"libraries": "shape_pca"}, {"bucket": 256}, {"bucket": 256})
    assert first.start <= kernel.start <= kernel.end <= first.end \
        <= capture.start <= capture.end


def test_a_build_that_raises_records_nothing():
    n = len(tracing.builds())
    with pytest.raises(ValueError):
        with tracing.build("capture", bucket=512):
            raise ValueError("capture failed")
    assert len(tracing.builds()) == n


def test_builds_are_on_the_profilers_clock():
    """The profiler's range opens between the host's clock readings around
    its entry and closes between those around its exit, and the build
    timed inside it lies inside it: one clock. (Under the profiler,
    entering and leaving a record_function range take tens of
    microseconds each.)"""
    n = len(tracing.builds())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in ("portbench.warm", "portbench.encode_call"):
            t0 = tracing.now_ns()
            with record_function(name):
                t1 = tracing.now_ns()
                with tracing.build("first_call", bucket=256):
                    torch.ones(64).sum()
                t2 = tracing.now_ns()
            t3 = tracing.now_ns()
    build = tracing.builds()[n + 1]
    (r,) = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "portbench.encode_call"]
    rs, re = r.start_ns(), r.start_ns() + r.duration_ns()
    assert t0 <= rs <= t1 <= build.start <= build.end <= t2 <= re <= t3


@pytest.mark.parametrize("release", (False, True), ids=("kept", "released"))
def test_a_call_on_the_cpu_builds_nothing_and_release_keeps_the_builds(
        release):
    """On the CPU a program runs op by op, with no first call or capture to
    time; release_programs() leaves the records of earlier builds."""
    with tracing.build("capture", bucket=256):
        pass
    before = tracing.builds()
    px = np.random.default_rng(1601).integers(0, 256, (40, 16, 4),
                                              dtype=np.uint8)
    ckt.encode_bc7(px, ckt.Options(refine_rounds_bc7=0), quality=1,
                   device="cpu")
    if release:
        programs.release_programs()
    assert tracing.builds() == before
