"""s3tc_search_ms_per_mblock.first_call (layer: models): the host time of
the exhaustive S3TC colour search (the stage `s3tc.exhaustive` of
convectionkernels_tpu_torch/models/s3tc.py pack_rgb) in the op-by-op
first call of the largest bucket that ran it before the profiled requests
(the warm-up's 65,536-block call in a 1024 bake), in ms per million
blocks of that bucket. The port's tracer times a stage in a bucket's first
call only, from a synchronize of the card to another, so this reads the
bulk search's device work run op by op, not a replay. It also logs the
shares of that first call taken by the BC3 alpha half, the search and the
rest of the colour half. Host clock. Nothing from a port without stage
records."""

import sys

SEARCH = "s3tc.exhaustive"


def _inside(stage, outer) -> bool:
    return outer.start <= stage.start and stage.end <= outer.end


def _log_shares(tracing, search, bucket: int) -> None:
    calls = [b for b in tracing.builds() if b.name == "first_call"
             and b.attrs.get("bucket") == bucket and _inside(search, b)]
    if not calls:
        return
    call = calls[-1]
    ns = {s.name: s.end - s.start for s in tracing.stages()
          if s.attrs.get("bucket") == bucket and _inside(s, call)}
    whole = call.end - call.start
    search_ns = search.end - search.start
    parts = [("alpha half", ns.get("s3tc.alpha")),
             ("exhaustive search", search_ns),
             ("rest of the colour half",
              ns["s3tc.color"] - search_ns if "s3tc.color" in ns else None)]
    print(f"s3tc stages of the {bucket}-block first call "
          f"({whole / 1e6:.3f} ms): " + ", ".join(
              f"{name} {ns_ / 1e6:.3f} ms ({100.0 * ns_ / whole:.2f}%)"
              for name, ns_ in parts if ns_ is not None),
          file=sys.stderr, flush=True)


def read(view):
    try:
        from convectionkernels_tpu_torch import tracing
    except ImportError:
        return None
    if not hasattr(tracing, "stages"):
        return None
    search = [s for s in tracing.stages()
              if s.name == SEARCH and s.end <= view.interval[0]]
    if not search:
        return None
    bucket = max(s.attrs["bucket"] for s in search)
    last = [s for s in search if s.attrs["bucket"] == bucket][-1]
    _log_shares(tracing, last, bucket)
    return (last.end - last.start) / 1e6 / (last.attrs["blocks"] / 1e6)
