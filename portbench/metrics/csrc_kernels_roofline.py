"""csrc_kernels_roofline (layer: kernels): the least time the card could
take for the work the profiled requests' kernels need, by the frozen work
model (harness/workmodel.py) on the frozen reference's own stages, over
the device time of the program's own CUDA kernels in those requests, in
percent. Nothing when no such kernel ran or the work is unknown."""


def read(view):
    ns = sum(o.end - o.start for o in view.ops if view.is_csrc(o))
    if not ns or not view.bound_ms:
        return None
    return 100.0 * view.bound_ms * 1e6 / ns
