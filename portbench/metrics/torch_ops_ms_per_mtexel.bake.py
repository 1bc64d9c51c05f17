"""torch_ops_ms_per_mtexel.bake (layer: models): the device time of every
kernel that is not one of the program's own CUDA kernels (csrc/), over
the profiled requests' Mtexels; memcpys and memsets are not counted."""


def read(view):
    ns = sum(o.end - o.start for o in view.ops
             if o.kind == "kernel" and not view.is_csrc(o))
    return ns / 1e6 / view.mtexels if ns and view.texels else None
