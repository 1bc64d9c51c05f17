"""The output check: the blocks the window's requests were served, held
byte for byte against the configuration's plain reference.

A block's bytes are an answer that can be checked on its own. Of each
level of each distinct pool request that the window served, the check
takes every block when the level has at most `full_max` blocks, else a
sample of `sample` blocks drawn from the seed; every served copy of that
request is compared at those blocks. So each mip tail is compared whole
and each large level by a sample, and one reference call serves every
copy. The reference runs once the window has closed and the program's
state is freed, on the same device, `chunk` blocks a call. For the
requests a --trace 1 run profiled, the frozen work model records the
work of the reference's own kernel stages on each level's blocks, scaled
up from the sample to the level (workmodel.Recorder).
"""

from __future__ import annotations

import numpy as np
import torch

from . import workmodel


def sample_rows(n: int, full_max: int, sample: int, seed: int, item: int,
                level: int) -> np.ndarray:
    """The rows of a level of n blocks that the check compares."""
    if n <= full_max or n <= sample:
        return np.arange(n)
    rng = np.random.default_rng([seed % 2**63, item, level])
    return np.sort(rng.choice(n, size=sample, replace=False))


def reference_bytes(reference, blocks: np.ndarray, device,
                    chunk: int) -> np.ndarray:
    """The reference's bytes of host blocks, [N, B] uint8."""
    outs = []
    for i in range(0, blocks.shape[0], chunk):
        x = torch.from_numpy(blocks[i:i + chunk]).to(device)
        outs.append(reference(x).cpu().numpy())
    return np.concatenate(outs)


def mismatched(got: np.ndarray, rows: np.ndarray, want: np.ndarray) -> int:
    """Rows `rows` of the served bytes `got` that differ from `want` (all
    of them when the served level has the wrong shape)."""
    if got.ndim != 2 or got.dtype != want.dtype or \
            got.shape[1] != want.shape[1] or got.shape[0] <= rows[-1]:
        return len(rows)
    return int((got[rows] != want).any(axis=1).sum())


def check(pool, served, reference, device, chunk: int, seed: int,
          full_max: int, sample: int, profiled=()) -> dict:
    """Compare every served request with the reference at its sampled rows.

    served: [(pool index, [level bytes])] of the window's completed
    requests; profiled: the pool indexes of the profiled requests, in
    order. Returns the numbers compared and, when some were profiled,
    {kernel: (bytes, ops, bound ms, what bounds it)} of their kernels'
    work."""
    used = sorted({i for i, _ in served})
    rows = {(i, lv): sample_rows(b.shape[0], full_max, sample, seed, i, lv)
            for i in used for lv, b in enumerate(pool[i].levels)}
    want = {}
    work = {}
    traced = set(profiled)
    for i in sorted(traced & set(used)):
        work[i] = {k: [0.0, 0.0] for k in workmodel.WORK}
        for lv, blocks in enumerate(pool[i].levels):
            r = rows[(i, lv)]
            with workmodel.Recorder() as rec:
                want[(i, lv)] = reference_bytes(reference, blocks[r], device,
                                                chunk)
            scale = blocks.shape[0] / len(r)
            for k, (nbytes, ops) in rec.work.items():
                work[i][k][0] += nbytes * scale
                work[i][k][1] += ops * scale
    keys = [(i, lv) for i in used if i not in traced
            for lv in range(len(pool[i].levels))]
    if keys:
        flat = np.concatenate([pool[i].levels[lv][rows[(i, lv)]]
                               for i, lv in keys])
        out = reference_bytes(reference, flat, device, chunk)
        at = 0
        for key in keys:
            want[key] = out[at:at + len(rows[key])]
            at += len(rows[key])
    bad = blocks = 0
    for i, levels in served:
        n_levels = len(pool[i].levels)
        for lv in range(n_levels):
            r = rows[(i, lv)]
            blocks += len(r)
            if len(levels) != n_levels:
                bad += len(r)
            else:
                bad += mismatched(levels[lv], r, want[(i, lv)])
    bound = None
    if work:
        total = {}
        for i in profiled:
            for k, (nbytes, ops) in work.get(i, {}).items():
                t = total.setdefault(k, [0.0, 0.0])
                t[0] += nbytes
                t[1] += ops
        bound = {k: (b, o) + workmodel.bound_ms(b, o)
                 for k, (b, o) in total.items() if b or o}
    return dict(mismatched_blocks=bad, blocks_compared=blocks,
                requests_compared=len(served), distinct_requests=len(used),
                reference_blocks=sum(len(r) for r in rows.values()),
                bound=bound)
