"""The harness's spans, the profiler's device activity, the host's own
clock readings, and the reductions the per-layer readers share.

Spans are torch.profiler.record_function ranges opened by the harness
around each layer boundary it drives (SPANS), so that they and the device
activity share the profiler's clock. The profiled requests run after the
window: under the profiler a graph launch costs the host about 2 us a
node, so a host time or an idle share read from the trace carries the
profiler's cost. What the host's clock says of the host path is read from
the untraced window and the settle instead (HostTimes). The trace stays in
memory; only its reductions are kept. The aggregation of device time by name follows
chip_smoke.py:657-684 (profile_encode) at commit 9895176, reading the
profiler's raw events instead of key_averages().
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re

# the harness's spans: a whole request, a call of the entry point (until it
# returns), the copy of its bytes to the host, and the harness's own work
# between two requests
SPANS = ("request", "encode_call", "to_host", "between_requests")
PREFIX = "portbench."


class Spans:
    """Opens the harness's spans: record_function ranges while a profiler
    runs (`on`), nothing otherwise."""

    def __init__(self):
        self.on = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        import torch
        with torch.profiler.record_function(PREFIX + name):
            yield


@dataclasses.dataclass
class Op:
    name: str
    kind: str            # kernel, memcpy or memset
    start: int           # ns, the profiler's clock
    end: int


@dataclasses.dataclass
class Span:
    name: str
    start: int
    end: int


def _kind(e) -> str:
    """The profiler's activity type of an event, where this torch says it."""
    at = getattr(e, "activity_type", None)
    return str(at()) if at is not None else ""


def read_events(prof) -> tuple[list[Op], list[Span]]:
    """(device operations, harness spans) of a finished profile, each
    sorted by start. A device operation is a kernel, memcpy or memset on
    the card; the card-side copies of the harness's ranges are not."""
    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        on_card = str(e.device_type()).endswith("CUDA")
        if name.startswith(PREFIX):
            if not on_card:
                spans.append(Span(name[len(PREFIX):], start, end))
            continue
        kind = _kind(e)
        if not on_card or "annotation" in kind:
            continue
        if "memcpy" in kind or name.startswith("Memcpy"):
            kind = "memcpy"
        elif "memset" in kind or name.startswith("Memset"):
            kind = "memset"
        else:
            kind = "kernel"
        ops.append(Op(name, kind, start, end))
    ops.sort(key=lambda o: o.start)
    spans.sort(key=lambda s: s.start)
    return ops, spans


def union(intervals) -> list[tuple[int, int]]:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def covered(merged, lo: int, hi: int) -> int:
    """The length of [lo, hi) that the disjoint sorted `merged` covers."""
    total = 0
    i = max(bisect.bisect_right(merged, (lo, lo)) - 1, 0)
    for s, e in merged[i:]:
        if s >= hi:
            break
        total += max(0, min(e, hi) - max(s, lo))
    return total


def gaps(merged, lo: int, hi: int) -> list[tuple[int, int]]:
    """The parts of [lo, hi) that `merged` leaves uncovered."""
    out, t = [], lo
    for s, e in merged:
        if e <= lo:
            continue
        if s >= hi:
            break
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def csrc_kernel_of(name: str, kernels) -> str | None:
    """Which of `kernels` (plain function names) the device operation
    `name` is: demangled (`void (anonymous namespace)::single_plane_kernel
    <3>(Params)`) or mangled (`..._116shape_pca_kernelE...`)."""
    for k in kernels:
        if re.search(r"(^|[^A-Za-z0-9_])%s([^A-Za-z0-9_]|$)" % k, name) or \
                f"{len(k)}{k}" in name:
            return k
    return None


@dataclasses.dataclass
class HostTimes:
    """The host clock's readings of the untraced run around the trace."""
    settle_ms: list       # each settle request, in order
    request_ms: list      # each request the window completed
    enqueue_ms: list      # each of those requests' time inside the entry
                          # point's calls


@dataclasses.dataclass
class TraceView:
    """What the per-layer readers read: the profiled requests' spans, the
    device operations inside the profiled interval, the names of the
    program's own CUDA kernels, and the work the profiled requests need."""
    ops: list
    spans: list
    requests: list           # Span of each profiled request
    texels: int              # real texels of the profiled requests
    interval: tuple          # (start, end) ns of the profiled interval
    csrc_kernels: frozenset  # base names of the program's __global__ kernels
    bound_ms: float | None   # the frozen work model's bound of their kernels
    host: HostTimes | None = None
    _merged: list | None = None

    @property
    def merged(self):
        """The union of device activity."""
        if self._merged is None:
            self._merged = union((o.start, o.end) for o in self.ops)
        return self._merged

    @property
    def mtexels(self) -> float:
        return self.texels / 1e6

    def is_csrc(self, op: Op) -> bool:
        return op.kind == "kernel" and \
            csrc_kernel_of(op.name, self.csrc_kernels) is not None

    def busy_ns(self) -> int:
        return covered(self.merged, *self.interval)

    def window_ns(self) -> int:
        return self.interval[1] - self.interval[0]


def view(ops, spans, texels, csrc_kernels, bound_ms,
         host: HostTimes | None = None) -> TraceView:
    requests = [s for s in spans if s.name == "request"]
    lo, hi = requests[0].start, requests[-1].end
    inside = [o for o in ops if o.end > lo and o.start < hi]
    return TraceView(inside, [s for s in spans if s.end > lo and s.start < hi],
                     requests, texels, (lo, hi), frozenset(csrc_kernels),
                     bound_ms, host)


def breakdown(v: TraceView, top: int = 10) -> dict:
    """The device operations that took most time (seconds, by name) and
    the longest idle gaps, each named by the innermost harness span open
    at its middle."""
    by_name: dict[str, int] = {}
    for o in v.ops:
        key = o.name[:120]
        by_name[key] = by_name.get(key, 0) + (o.end - o.start)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps(v.merged, *v.interval),
                  key=lambda g: -(g[1] - g[0]))[:top]
    named = []
    for s, e in idle:
        mid = (s + e) // 2
        open_spans = [sp for sp in v.spans if sp.start <= mid < sp.end]
        inner = min(open_spans, key=lambda sp: sp.end - sp.start,
                    default=None)
        named.append([inner.name if inner else "outside_spans",
                      (e - s) / 1e9])
    return dict(device_ops=[[k, ns / 1e9] for k, ns in device_ops],
                idle_gaps=named)
