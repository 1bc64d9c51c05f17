"""kernel_ms_per_mtexel.bake (layer: kernels): the device time of the
program's own __global__ kernels (csrc/<name>.cu's <name>_kernel) over the
profiled requests' Mtexels."""


def read(view):
    ns = sum(o.end - o.start for o in view.ops if view.is_csrc(o))
    return ns / 1e6 / view.mtexels if ns and view.texels else None
