"""The port's builds, always timed: each bucket's op-by-op first call
(`first_call`) and graph capture (`capture`) in programs.py, and each nvcc
build of kernel libraries (`kernel_build`) in cuda_lib.py; and the stages
a program body names (`stage`), timed in a bucket's first call only.

Builds are rare, so each is timed whether or not anything reads it, and
each first call and capture ends with a synchronize of its card, so that
its device work counts in it. A build may hold another: the first call
that first launches a kernel holds that kernel's nvcc build. The records
are kept for the life of the process (`builds()`); release_programs()
leaves them.

A body names its stages with `stage(name, **attrs)`. Inside a bucket's
op-by-op first call (programs.py opens `staged` around it, on the card
and on the CPU) each stage is timed from a synchronize of the card to
another and recorded with the bucket (`stages()`). Anywhere else, in a
graph capture, a replay or any later call, `stage` is a no-op: one test
of a module flag, no synchronize and no record, so that a captured graph
and its replays are those of a body without stages.

Times are nanoseconds on the Unix-epoch clock (the perf_counter clock
plus one offset, taken at import), which is the clock of the torch
profiler's events, so a build can be placed against a profiled window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch


def _epoch_offset() -> int:
    """time.time_ns() - time.perf_counter_ns(), from a pair of perf_counter
    readings taken around the wall-clock reading."""
    before = time.perf_counter_ns()
    wall = time.time_ns()
    after = time.perf_counter_ns()
    return wall - (before + after) // 2


_offset_ns = _epoch_offset()


def now_ns() -> int:
    """The tracer's clock: ns since the Unix epoch."""
    return time.perf_counter_ns() + _offset_ns


@dataclasses.dataclass
class Build:
    name: str            # first_call, capture or kernel_build
    start: int           # ns, the tracer's clock
    end: int
    attrs: dict          # bucket (first_call, capture) or libraries


_builds: list[Build] = []


@contextlib.contextmanager
def build(name: str, device=None, **attrs):
    """Time the block as the build `name`, then a synchronize of `device`
    when it is a card. A block that raises records nothing."""
    start = now_ns()
    yield
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    _builds.append(Build(name, start, now_ns(), attrs))


def builds() -> list[Build]:
    """Every build of the process so far, in the order they ended."""
    return list(_builds)


@dataclasses.dataclass
class Stage:
    name: str            # as the body names it
    start: int           # ns, the tracer's clock
    end: int
    attrs: dict          # the body's attrs and the bucket


_stages: list[Stage] = []
_staging = None          # (device, bucket) of the first call open, or None
_NOTHING = contextlib.nullcontext()


@contextlib.contextmanager
def staged(device, bucket: int):
    """Record the stages the block names: a bucket's op-by-op first
    call."""
    global _staging
    outer = _staging
    _staging = (device, bucket)
    try:
        yield
    finally:
        _staging = outer


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _stage(name: str, attrs: dict):
    device, bucket = _staging
    _sync(device)
    start = now_ns()
    yield
    _sync(device)
    _stages.append(Stage(name, start, now_ns(), dict(attrs, bucket=bucket)))


def stage(name: str, **attrs):
    """Time the block as the stage `name` when a bucket's first call is
    open (staged), up to a synchronize of its card at either end; else
    do nothing. A block that raises records nothing."""
    if _staging is None:
        return _NOTHING
    return _stage(name, attrs)


def stages() -> list[Stage]:
    """Every stage recorded in the process so far, in the order they
    ended."""
    return list(_stages)
