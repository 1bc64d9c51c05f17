"""settle_slowdown (layer: device): how much slower the first requests
after the warm-up ran than the window's, in percent: the median of the
settle's first 5 requests over the median of the window's requests, less
1. On the H100 the graphs' replays ran up to 30% slower per node for 2 to
over 30 seconds after their capture in about half the processes; the
settle keeps that out of the window, and this reports it. Host clock,
untraced."""

import statistics

FIRST = 5


def read(view):
    host = view.host
    if host is None or len(host.settle_ms) < FIRST or not host.request_ms:
        return None
    first = statistics.median(host.settle_ms[:FIRST])
    return 100.0 * (first / statistics.median(host.request_ms) - 1.0)
