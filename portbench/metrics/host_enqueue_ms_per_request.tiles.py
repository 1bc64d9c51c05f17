"""host_enqueue_ms_per_request.tiles (layer: api + programs, the host
path): the median, over the requests of the untraced window, of the host's
time inside the program's entry point calls (cast, shape check, chunk
loop, bucket pad, static-input copy, replay launch, clone, strip, until
the calls return), in ms. Read on the host's clock, not from the trace:
under the profiler a graph launch costs the host about 2 us a node."""

import statistics


def read(view):
    host = view.host
    if host is None or not host.enqueue_ms:
        return None
    return statistics.median(host.enqueue_ms)
