"""build_s (layer: programs): the seconds the program spent building before
the profiled requests, as the port's tracer times them
(convectionkernels_tpu_torch/tracing.py, always on, kept through
release_programs): each bucket's op-by-op first call and each graph
capture, both up to a synchronize of the card, less the nvcc builds of
kernel libraries held inside them. nvcc runs only where the checkout has
not built that library yet, so leaving it out keeps the metric a reading
of the program rather than of the checkout's build cache. The warm-up is
the only phase that builds. Host clock. Nothing from a port without the
tracer."""


def read(view):
    try:
        from convectionkernels_tpu_torch import tracing
    except ImportError:
        return None
    done = [b for b in tracing.builds() if b.end <= view.interval[0]]
    programs = [b for b in done if b.name in ("first_call", "capture")]
    if not programs:
        return None
    nvcc = [k for k in done if k.name == "kernel_build"
            and any(p.start <= k.start and k.end <= p.end for p in programs)]
    return (sum(b.end - b.start for b in programs)
            - sum(k.end - k.start for k in nvcc)) / 1e9
