"""One run of one cell: set-up, the settle, the window, the trace, the
check.

A request is one texture (traffic.Request). The loop is closed, with one
request in flight: for each level in order the program's entry point is
called on the level's host blocks and its bytes copied to the host; the
request ends when the last level's bytes are there. The window's requests
are sent in order until `seconds` have passed, and the one in flight then
is finished and counted: the window is from the first request's start to
the last one's end. A mix may name another loop (`"loop":
"module:function"`, called as loop(entry, requests, seconds, log) ->
Window). With --trace 1 the window runs untraced all the same, and
`trace_requests` further requests are profiled after it closes: the
profiler's instrumentation of each graph launch costs the host about 2 us
a node (PERF.md), which no host-clock reading may carry.
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
import time
import traceback

from . import check, spec, trace, traffic

GIB = 2**30

# what the output check compares, and the limit of each (PERF.md gives the
# readings each limit was set from): an exact comparison has the limit 0
LIMITS = {"mismatched_blocks": 0, "failed_requests": 0}


def program_entry(config: dict, device: str, root: str = spec.ROOT):
    """The configuration's entry point of the program: host blocks ->
    bytes on `device`. `program`: `entry`, the port's function; `options`,
    its Options; `plan_quality`, a BC7 plan; or `builder`,
    `module:function` of a file under portbench/ called as
    builder(config, device) -> entry, for an entry these cannot say."""
    prog = config["program"]
    if "builder" in prog:
        return spec.resolve(prog["builder"], root)(config, device)
    import convectionkernels_tpu_torch as ckt
    fn = getattr(ckt, prog["entry"])
    options = ckt.Options(**prog.get("options", {}))
    kwargs = {}
    if "plan_quality" in prog:
        kwargs["plan"] = ckt.plan_from_quality(int(prog["plan_quality"]))
    return lambda blocks: fn(blocks, options, device=device, **kwargs)


def reference_entry(config: dict, root: str = spec.ROOT):
    """The configuration's plain reference: device blocks -> bytes."""
    ref = config["reference"]
    fn = spec.resolve(ref["function"], root)
    kwargs = ref.get("kwargs", {})
    return lambda blocks: fn(blocks, **kwargs)


def release_program() -> None:
    """Free the program's programs, constants and graph pool."""
    import convectionkernels_tpu_torch.api as api
    api.release_programs()


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between closest ranks (NumPy's
    default)."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


@dataclasses.dataclass
class Window:
    served: list          # (request index, [level bytes]) per completed one
    latencies: list       # seconds per completed request
    enqueue: list         # seconds each completed request spent in the
                          # entry point's calls (until they returned)
    texels: int           # real texels of the completed requests
    seconds: float        # first request's start to the last one's end
    attempted: int
    failed: int


def send(entry, request, spans=None):
    """One request, level by level: (level bytes or None when it raised,
    seconds, seconds inside the entry point's calls)."""
    spans = spans or trace.Spans()
    t0 = time.perf_counter()
    inside = 0.0
    outs = []
    with spans("request"):
        for blocks in request.levels:
            t = time.perf_counter()
            with spans("encode_call"):
                out = entry(blocks)
            inside += time.perf_counter() - t
            with spans("to_host"):
                outs.append(out.cpu().numpy())
    return outs, time.perf_counter() - t0, inside


def warm_up(entry, pool, log) -> None:
    """Every level size the pool sends, three calls each: on the card the
    first runs the program op by op, the second captures it, the third
    replays it."""
    seen = {}
    for r in pool:
        for lv in r.levels:
            seen.setdefault(lv.shape[0], lv)
    for n, blocks in sorted(seen.items(), reverse=True):
        t = time.perf_counter()
        for _ in range(3):
            entry(blocks).cpu()
        log(f"warm-up {n} blocks: {time.perf_counter() - t:.3f} s")


def settle(entry, pool, settle_s: float, log) -> list:
    """Whole pool requests in pool order for `settle_s` seconds, after the
    set-up and before the window: on the H100 the graphs' replays ran up to
    30% slower per node for 2 to over 30 seconds after the captures in
    about half the processes (PERF.md), which the window leaves out and the
    metric `settle_slowdown` reports. Returns each request's ms."""
    start = time.perf_counter()
    times, inside = [], []
    i = 0
    while time.perf_counter() - start < settle_s:
        _, took, enq = send(entry, pool[i % len(pool)])
        times.append(took * 1e3)
        inside.append(enq * 1e3)
        i += 1
    if times:
        log(f"settle: {len(times)} requests in {settle_s} s; first 10 ms "
            + " ".join(f"{x:.1f}" for x in times[:10]) + "; their ms in "
            "the entry point " + " ".join(f"{x:.1f}" for x in inside[:10])
            + "; last 10 ms " + " ".join(f"{x:.1f}" for x in times[-10:])
            + "; in the entry point "
            + " ".join(f"{x:.1f}" for x in inside[-10:]))
    return times


def closed_loop(entry, requests, seconds: float, log) -> Window:
    """The window: requests in order, one in flight, until `seconds`."""
    w = Window([], [], [], 0, 0.0, 0, 0)
    start = last_end = time.perf_counter()
    i = 0
    while time.perf_counter() - start < seconds:
        request = requests[i % len(requests)]
        w.attempted += 1
        try:
            outs, took, inside = send(entry, request)
        except Exception:  # a failed request is counted and reported
            w.failed += 1
            log("request failed:\n" + traceback.format_exc())
        else:
            w.latencies.append(took)
            w.enqueue.append(inside)
            w.served.append((i % len(requests), outs))
            w.texels += request.texels
            last_end = time.perf_counter()
        i += 1
    w.seconds = last_end - start
    return w


def profile(entry, requests, first: int, count: int, log):
    """Profile `count` whole requests from index `first` on: (served
    [(index, bytes)], failed, the indexes, the finished profiler)."""
    import torch
    from torch.profiler import ProfilerActivity
    spans = trace.Spans()
    spans.on = True
    served, indexes, failed = [], [], 0
    prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
    with prof:
        for i in range(first, first + count):
            index = i % len(requests)
            indexes.append(index)
            try:
                outs, _, _ = send(entry, requests[index], spans)
            except Exception:
                failed += 1
                log("profiled request failed:\n" + traceback.format_exc())
            else:
                served.append((index, outs))
            with spans("between_requests"):
                pass
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return served, failed, indexes, prof


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool,
        device: str, t0: float, entry=None, csrc_kernels=(),
        log=None, warm=True) -> dict:
    """Run `cell` and return the result line's fields (with `compared`
    last) and the check's numbers. `entry` replaces the program's entry
    point (the control, the fault tests; `warm` False skips the warm-up
    and the settle, which only the program needs); `t0` is the process
    start."""
    import torch
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    on_card = device.startswith("cuda")
    work = traffic.make(cell.mix, cell.config, seed, cell.root)
    requests = work.window
    log(f"pool: {len(work.pool)} requests, {work.pool[0].blocks} blocks "
        f"each (the first), level sizes {traffic.level_sizes(work.pool)}; "
        f"{len(requests)} window requests")
    program = entry is None
    entry = program_entry(cell.config, device, cell.root) if program \
        else entry
    if warm:
        warm_up(entry, work.pool, log)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    settle_ms = settle(entry, work.pool, float(cell.mix["settle_s"]),
                       log) if warm else []

    loop = spec.resolve(cell.mix["loop"], cell.root) if "loop" in cell.mix \
        else closed_loop
    window = loop(entry, requests, seconds, log)
    served = list(window.served)
    failed = window.failed
    prof = None
    profiled = []
    if traced:
        p_served, p_failed, profiled, prof = profile(
            entry, requests, window.attempted,
            int(cell.mix["trace_requests"]), log)
        served += p_served
        failed += p_failed
    memory_peak = torch.cuda.max_memory_reserved() if on_card else 0
    ops = spans = None
    if prof is not None:
        ops, spans = trace.read_events(prof)
        prof = None
    if program:
        release_program()
    if on_card:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    result = check.check(requests, served,
                         reference_entry(cell.config, cell.root),
                         device, int(cell.config["check_chunk"]), seed,
                         int(cell.mix["check_full_max"]),
                         int(cell.mix["check_sample"]), profiled=profiled)
    log(f"check: {result['blocks_compared']} blocks of "
        f"{result['requests_compared']} requests "
        f"({result['distinct_requests']} distinct; "
        f"{result['reference_blocks']} blocks through the reference) in "
        f"{time.perf_counter() - t:.3f} s")

    n = len(window.latencies)
    log(f"window: {window.seconds:.3f} s, {n} requests completed of "
        f"{window.attempted}; request samples for the p95: {n}")
    log("request ms: " + " ".join(f"{x * 1e3:.1f}" for x in window.latencies))
    metrics = {}
    device_info = {}
    if not traced:
        if n:
            values = {
                "texel_rate": window.texels / window.seconds / 1e6,
                "request_ms_p95": percentile(window.latencies, 95) * 1e3,
                "device_reserved_gib": memory_peak / GIB,
                "setup_s": setup_s,
            }
            median = statistics.median(window.latencies) * 1e3
            log(f"request ms: median {median:.3f}, p95 "
                f"{values['request_ms_p95']:.3f}, max "
                f"{max(window.latencies) * 1e3:.3f}; in the entry point: "
                f"median {statistics.median(window.enqueue) * 1e3:.3f}")
            metrics = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in cell.end_to_end}
    elif ops is not None and spans:
        profiled_texels = sum(requests[i].texels for i in profiled)
        bound = result["bound"]
        if bound:
            for k, (b, o, ms, by) in sorted(bound.items()):
                log(f"work model {k}: {b} bytes, {o} operations, bound "
                    f"{ms:.4f} ms by {by}")
        host = trace.HostTimes(
            settle_ms=settle_ms,
            request_ms=[x * 1e3 for x in window.latencies],
            enqueue_ms=[x * 1e3 for x in window.enqueue])
        v = trace.view(ops, spans, profiled_texels, csrc_kernels,
                       sum(x[2] for x in bound.values()) if bound else None,
                       host)
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(v)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info = dict(busy_s=v.busy_ns() / 1e9,
                           window_s=v.window_ns() / 1e9)
        result["breakdown"] = trace.breakdown(v)
        log(f"trace: {len(v.ops)} device operations in "
            f"{len(profiled)} profiled requests")
    result.update(setup_s=setup_s, metrics=metrics, window=window,
                  failed=failed, attempted=window.attempted + len(profiled),
                  served=served, memory_peak=memory_peak,
                  device_info=device_info)
    return result


def result_line(cell: spec.Cell, result: dict, kind: str) -> dict:
    """The run's result line: correct, attempted, failed, metrics, device,
    breakdown when traced, and last `compared`, each number the check
    compared with its limit. `kind` is the card's name."""
    compared = {"mismatched_blocks": result["mismatched_blocks"],
                "failed_requests": result["failed"]}
    correct = (bool(result["window"].served)
               and all(compared[k] <= LIMITS[k] for k in LIMITS))
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": result["memory_peak"]}
    device.update(result["device_info"])
    line = {"correct": correct, "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"],
            "device": device}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["compared"] = {k: {"value": v, "limit": LIMITS[k]}
                        for k, v in compared.items()}
    return line
