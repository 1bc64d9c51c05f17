"""The frozen work model equals chip_smoke.py's on the arguments the
frozen reference's stages pass to its kernel functions."""

import numpy as np
import torch

import reference
from harness import inputs, workmodel
from reference.models import bc6h_kernel, bc7_kernel


def _record(run):
    """The argument tuples of every kernel-function call while `run()`."""
    calls = []
    saved = []
    for module in (bc7_kernel, bc6h_kernel):
        for name in workmodel.WORK:
            fn = getattr(module, name, None)
            if fn is None:
                continue
            saved.append((module, name, fn))

            def wrapper(*args, _name=name, _fn=fn):
                calls.append((_name, args))
                return _fn(*args)
            setattr(module, name, wrapper)
    try:
        run()
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)
    return calls


def test_work_equals_chip_smokes_on_recorded_arguments():
    import chip_smoke
    ldr = torch.from_numpy(inputs.blockify(inputs.make_texture_image(4, 32)))
    hdr = torch.from_numpy(inputs.blockify(
        inputs.make_hdr_image(4, 8)).view(np.int16))
    calls = _record(lambda: (reference.encode_bc7(ldr, 50),
                             reference.encode_bc6hu(hdr)))
    names = {n for n, _ in calls}
    assert names == set(workmodel.WORK)
    for name, args in calls:
        assert workmodel.WORK[name](args) == chip_smoke.WORK[name](args), name
    for nbytes, ops in ((1e9, 1e6), (1e3, 1e12)):
        assert workmodel.bound_ms(nbytes, ops) == chip_smoke.bound_ms(
            nbytes, ops)


def test_recorder_sums_the_work_of_every_call():
    ldr = torch.from_numpy(inputs.blockify(inputs.make_texture_image(9, 16)))
    calls = _record(lambda: reference.encode_bc7(ldr, 50))
    with workmodel.Recorder() as rec:
        reference.encode_bc7(ldr, 50)
    for name in workmodel.WORK:
        want = [0, 0]
        for n, args in calls:
            if n == name:
                b, o = workmodel.WORK[n](args)
                want[0] += b
                want[1] += o
        assert rec.work[name] == want
    assert rec.work["partitioned_group_meta_rounds"] == [0, 0]
    # the wrappers are restored
    assert bc7_kernel.shape_pca.__name__ == "shape_pca"
