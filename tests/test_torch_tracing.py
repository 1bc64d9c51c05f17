"""The port's build timing (convectionkernels_tpu_torch/tracing.py) on the
CPU: builds always timed, in the order they end, one held inside another;
a block that raises records nothing; the torch profiler's clock;
release_programs() leaving the records; a call on the CPU building
nothing. Stages: recorded inside a bucket's first call only, with the
bucket; a no-op with no synchronize anywhere else; the BC3 program's
three stages in its first call and none in later calls or in the body
run as a capture runs it. The card's side (a bucket's first call and
capture, each ending with a synchronize; the stages of a first call and
none in its capture or replays) is in tests/test_torch_cuda.py.
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


def test_a_stage_records_only_inside_a_first_call(monkeypatch):
    """Outside `staged` a stage is the shared no-op context: no synchronize,
    no record; inside it each stage is recorded when it ends, with its
    attrs and the bucket, a nested one first; a stage that raises records
    nothing."""
    def no_sync(device=None):
        raise AssertionError("a stage outside a first call synchronized")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    n = len(tracing.stages())
    assert tracing.stage("outer") is tracing.stage("other", pairs=3)
    with tracing.stage("outer"):
        pass
    assert len(tracing.stages()) == n
    with tracing.staged(torch.device("cpu"), 512):
        with tracing.stage("outer"):
            with tracing.stage("inner", pairs=7):
                torch.ones(8).sum()
        with pytest.raises(ValueError):
            with tracing.stage("failed"):
                raise ValueError("stage failed")
    with tracing.stage("after"):
        pass
    inner, outer = tracing.stages()[n:]
    assert (inner.name, inner.attrs) == ("inner", {"pairs": 7, "bucket": 512})
    assert (outer.name, outer.attrs) == ("outer", {"bucket": 512})
    assert outer.start <= inner.start <= inner.end <= outer.end


def test_the_bc3_first_call_records_its_three_stages():
    """BC3 at Flags.BETTER on the CPU: the first call of its 256-block
    bucket records the alpha half, the exhaustive search inside the colour
    half, with the blocks and the (block, partition) pairs it tests (965
    four-count partitions a block, no alpha test), and the colour half; a
    second call records none, and neither does the body run as a capture
    runs it (outside the first call). A BC1 first call also tests the 150
    three-count partitions."""
    programs.release_programs()
    px = np.random.default_rng(2201).integers(0, 256, (8, 16, 4),
                                              dtype=np.uint8)
    options = ckt.Options(flags=ckt.Flags.BETTER)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        n = len(tracing.stages())
        first = ckt.encode_bc3(px, options, device="cpu")
        alpha, search, color = tracing.stages()[n:]
        assert [s.name for s in (alpha, search, color)] == [
            "s3tc.alpha", "s3tc.exhaustive", "s3tc.color"]
        assert alpha.attrs == color.attrs == {"bucket": 256}
        assert search.attrs == {"blocks": 256, "pairs": 256 * 965,
                                "bucket": 256}
        assert alpha.end <= color.start <= search.start <= search.end \
            <= color.end
        n = len(tracing.stages())
        again = ckt.encode_bc3(px, options, device="cpu")
        assert torch.equal(first, again)
        (program,) = [p for p in programs.programs() if p.width == 16]
        program.body(torch.from_numpy(np.repeat(px[:1], 256, 0)))
        assert len(tracing.stages()) == n
        ckt.encode_bc1(px, options, device="cpu")
        (bc1_search,) = tracing.stages()[n:]
        assert bc1_search.attrs == {"blocks": 256, "pairs": 256 * (965 + 150),
                                    "bucket": 256}
    finally:
        torch.set_num_threads(threads)
        programs.release_programs()
