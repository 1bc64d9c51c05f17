"""The output check's control, and the faults it has to catch.

The control is the plain reference put in the program's place and
computed in the nearest precision below the configuration's float32:
every divide, reciprocal and square root of the reference's exact-math
layer (reference/ops/exact_math.py, which every encoder stage divides
through) rounded to bfloat16. It is the step a later PR would be tempted
by, an approximate divide or square root, and the check has to find it
not correct. The faults break the timed path underneath a run, each as a
wrapper of the program's entry point: a stale answer (the bytes of the
previous call of the same size: a program's output left unchanged), half
of a level's blocks left out (the encoded half repeated over the rest),
and one block's bytes altered where they are produced.
"""

from __future__ import annotations

import contextlib

import torch

EXACT = ("exact_divide", "exact_reciprocal", "exact_sqrt")


def _bf16(fn):
    def lower(*args):
        return fn(*args).to(torch.bfloat16).to(torch.float32)
    return lower


@contextlib.contextmanager
def lower_precision():
    """Inside this block the reference's divides, reciprocals and square
    roots are rounded to bfloat16, in every module that imported them."""
    import sys
    saved = []
    for name, module in list(sys.modules.items()):
        if name.split(".")[0] != "reference" or module is None:
            continue
        for attr in EXACT:
            fn = module.__dict__.get(attr)
            if fn is not None:
                saved.append((module, attr, fn))
                setattr(module, attr, _bf16(fn))
    try:
        yield
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)


def control_entry(reference, device):
    """The reference in the program's place, in the lower precision: host
    blocks -> bytes on `device`."""
    def entry(blocks):
        with lower_precision():
            return reference(torch.from_numpy(blocks).to(device))
    return entry


def stale(entry):
    """A fault: each call returns the bytes of the previous call of the
    same size (the first call of a size is answered right)."""
    last = {}

    def faulty(blocks):
        out = entry(blocks)
        prev = last.get(blocks.shape[0])
        last[blocks.shape[0]] = out
        return out if prev is None else prev
    return faulty


def half_left_out(entry):
    """A fault: only the first half of a level's blocks is encoded, and its
    bytes are repeated over the rest."""
    def faulty(blocks):
        n = blocks.shape[0]
        if n < 2:
            return entry(blocks)
        head = entry(blocks[: n // 2])
        reps = -(-n // head.shape[0])
        return head.repeat(reps, 1)[:n]
    return faulty


def altered(entry):
    """A fault: one byte of one block of every call's bytes is altered."""
    count = [0]

    def faulty(blocks):
        out = entry(blocks).clone()
        row = count[0] % out.shape[0]
        count[0] += 1
        out[row, 0] ^= 1
        return out
    return faulty


FAULTS = {"stale": stale, "half_left_out": half_left_out,
          "altered": altered}
