"""device_ops_per_request.tiles (layer: models): the device kernels,
memcpys and memsets that start inside the profiled requests, over the
requests."""


def read(view):
    if not view.requests:
        return None
    count = 0
    for r in view.requests:
        count += sum(1 for o in view.ops if r.start <= o.start < r.end)
    return count / len(view.requests) if count else None
