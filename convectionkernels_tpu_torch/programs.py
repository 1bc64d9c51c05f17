"""The program layer: batch buckets, one reusable program per configuration
and bucket, and the device constants the programs read.

The counterpart of the JAX package's program cache (api.py:36-143 there:
_PROGRAM_CACHE_SIZE, _program_cache, release_programs, _BUCKET_MIN,
_bucket_size, _wrap). An entry point pads its N blocks up to a bucket
(bucket_size: a power of two from BUCKET_MIN below the chunk size, a
multiple of the chunk at or above it) by repeating block 0, runs one
fixed-size program a chunk, and strips the pad. Blocks are independent, so
the pad changes no block's bytes, and any image size reuses a small fixed
set of programs: one chunk program per configuration, and at most
log2(chunk / BUCKET_MIN) + 1 bucket programs below it.

On a CUDA card a program is a CUDA graph of the configuration's chunk
body at one bucket size. The first call of a (configuration, bucket) runs
the body op by op on the bucket's static input, which also builds what
the body loads at first use and makes its device constants (`constant`);
the second call captures the body into a graph and replays it; later
calls copy their chunk into the static input, replay, and copy the bytes
out before anything else replays. Every graph of a device shares one
memory pool: replays run one at a time on one stream and each output is
copied out before the next, so a later capture reuses what an earlier
one freed and a process holds far less than the sum of the programs'
peaks. On the CPU a program is the same padded call, run op by op.

A bucket's first call and its capture are timed as builds of the tracer
(tracing.py), each up to a synchronize of the card, whether or not
anything reads them. The first call of a bucket, on the card or on the
CPU, also records the stages the body names (tracing.stage); a capture,
a replay and every later call record none.

Inside `eager()` the programs on the card run their bodies op by op too,
with no capture and no replay (per-launch timing, the eager side of a
comparison). Nothing enters it on an error: a capture or a replay that
fails raises.

Each cache of programs keeps PROGRAM_CACHE_SIZE configurations, least
recently used first out; a process that sweeps many Options calls
release_programs() between sweeps, which drops every program and constant
and returns their device memory.
"""

from __future__ import annotations

import collections
import contextlib
import functools

import numpy as np
import torch

from . import tracing

# Batches below the chunk size are padded to a power-of-two bucket of at
# least BUCKET_MIN blocks (the JAX package's _BUCKET_MIN).
BUCKET_MIN = 256

# Configurations each cache of programs keeps (the JAX package's
# _PROGRAM_CACHE_SIZE).
PROGRAM_CACHE_SIZE = 64


def bucket_size(n: int, chunk: int) -> int:
    """Padded batch size for n blocks: a multiple of `chunk` when
    n >= chunk, else the smallest power-of-two bucket in
    [BUCKET_MIN, chunk] holding n (capped at chunk)."""
    if n >= chunk:
        return ((n + chunk - 1) // chunk) * chunk
    b = min(BUCKET_MIN, chunk)
    while b < n:
        b *= 2
    return min(b, chunk)


# --- device constants ---------------------------------------------------------

_CONSTANTS: dict = {}


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def constant(values, device, dtype=None) -> torch.Tensor:
    """np.asarray(values, dtype) as a tensor on `device`, made once per
    value and device and then shared: never write to it. A graph cannot
    capture a copy from host memory, so a program body takes its tables
    and its Options-dependent values from here; the first, eager run of a
    body makes them. Kept until release_programs(), since a captured graph
    reads them."""
    a = np.ascontiguousarray(np.asarray(values, dtype=dtype))
    device = _device(device)
    key = (a.dtype.str, a.shape, a.tobytes(), device)
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.from_numpy(a.copy()).to(device)
    return t


def i32(values, device) -> torch.Tensor:
    """An int32 constant on `device` (constant)."""
    return constant(values, device, np.int32)


def lut(table, idx) -> torch.Tensor:
    """table[idx] for a small constant int32 table, on idx's device."""
    return i32(table, idx.device)[idx.long()]


# --- op-by-op mode --------------------------------------------------------------

_eager_depth = 0


@contextlib.contextmanager
def eager():
    """Run the programs' bodies op by op on the card, with no capture and
    no replay, inside this block (the counterpart of jax.disable_jit())."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


# --- programs -------------------------------------------------------------------

_POOLS: dict = {}


class _Bucket:
    """One program at one bucket size: on the card its static input, graph,
    static output and its captures."""

    def __init__(self):
        self.static_in = None
        self.graph = None
        self.static_out = None
        self.captures = 0

    def capture(self, body, device):
        graph = torch.cuda.CUDAGraph()
        pool = _POOLS.get(device)
        if pool is None:
            pool = _POOLS[device] = torch.cuda.graph_pool_handle()
        with tracing.build("capture", device, bucket=self.static_in.shape[0]):
            with torch.cuda.graph(graph, pool=pool):
                out = body(self.static_in)
        self.graph, self.static_out = graph, out
        self.captures += 1

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        return self.static_out.clone()


class Program:
    """One configuration's chunk body (uint8 [rows, width] bytes from
    [rows, ...] blocks), run at the buckets of bucket_size."""

    def __init__(self, body, width: int):
        self.body = body
        self.width = width
        self.buckets: dict[tuple, _Bucket] = {}

    def __call__(self, blocks: torch.Tensor, chunk: int) -> torch.Tensor:
        """`blocks` padded to bucket_size(N, chunk), through the program a
        chunk (or the one bucket program), the pad stripped."""
        n = blocks.shape[0]
        if n == 0:
            return torch.zeros((0, self.width), dtype=torch.uint8,
                               device=blocks.device)
        nb = bucket_size(n, chunk)
        if nb != n:
            blocks = torch.cat([blocks, blocks[:1].expand(
                (nb - n,) + tuple(blocks.shape[1:]))])
        rows = min(nb, chunk)
        outs = [self._run(blocks[i:i + rows]) for i in range(0, nb, rows)]
        out = outs[0] if len(outs) == 1 else torch.cat(outs)
        return out[:n] if nb != n else out

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        bucket = self.buckets.get(tuple(x.shape))
        new = bucket is None
        if new:
            bucket = self.buckets[tuple(x.shape)] = _Bucket()
        if x.device.type != "cuda" or _eager_depth:
            if not new:
                return self.body(x)
            with tracing.staged(x.device, x.shape[0]):
                return self.body(x)
        with torch.cuda.device(x.device):
            if bucket.static_in is None:
                with tracing.build("first_call", x.device,
                                   bucket=x.shape[0]), \
                        tracing.staged(x.device, x.shape[0]):
                    bucket.static_in = x.clone()
                    return self.body(bucket.static_in)
            bucket.static_in.copy_(x)
            if bucket.graph is None:
                bucket.capture(self.body, x.device)
            return bucket.replay()


class _ProgramCache:
    """Programs by configuration, least recently used evicted beyond
    PROGRAM_CACHE_SIZE (the JAX package's lru_cache per `_*_fn`)."""

    def __init__(self, make):
        self.make = make
        self.programs: collections.OrderedDict = collections.OrderedDict()
        functools.update_wrapper(self, make)

    def __call__(self, *config) -> Program:
        program = self.programs.get(config)
        if program is None:
            program = self.programs[config] = self.make(*config)
            while len(self.programs) > PROGRAM_CACHE_SIZE:
                self.programs.popitem(last=False)
        else:
            self.programs.move_to_end(config)
        return program


_CACHES: list[_ProgramCache] = []


def program_cache(make):
    """Memoize `make(*config) -> Program` per configuration (hashable
    arguments, the device last), in a bounded cache that release_programs
    empties."""
    cache = _ProgramCache(make)
    _CACHES.append(cache)
    return cache


def programs() -> list[Program]:
    """Every program the caches hold."""
    return [p for cache in _CACHES for p in cache.programs.values()]


def release_programs() -> None:
    """Drop every cached program and device constant and return their
    device memory to the card (the analogue of the reference's
    ReleaseETC*Data): later encodes build their programs anew."""
    for cache in _CACHES:
        cache.programs.clear()
    _CONSTANTS.clear()
    _POOLS.clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
