"""Quality metrics and throughput counters.

The counterpart of the JAX package's utils/metrics.py: PSNR/RMSE against
decoded output, bit-exact match rates against a reference encoding, and
Mtexels/s timers. Work on a CUDA card is asynchronous, so the timers wait
for the card before they read the clock, and profile_encode times a card
with CUDA events.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch


def psnr(original, decoded, peak: float = 255.0) -> float:
    """PSNR over all channels (inputs as [N, 16, C] blocks or images)."""
    a = np.asarray(original, dtype=np.float64)
    b = np.asarray(decoded, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def rmse(original, decoded) -> float:
    a = np.asarray(original, dtype=np.float64)
    b = np.asarray(decoded, dtype=np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def match_rate(blocks_a, blocks_b) -> float:
    """Fraction of encoded blocks that are byte-identical."""
    a = np.asarray(blocks_a)
    b = np.asarray(blocks_b)
    return float(np.all(a == b, axis=-1).mean())


def _synchronize_cards() -> None:
    """Wait for every card this process has used."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


class Throughput:
    """Mtexels/s timer for encode calls (16 texels per block). Entering and
    leaving the timed block wait for the cards this process has used, so
    the time covers the work and not only its launch."""

    def __init__(self):
        self.start = None
        self.elapsed = 0.0
        self.texels = 0

    def __enter__(self):
        _synchronize_cards()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _synchronize_cards()
        self.elapsed += time.perf_counter() - self.start

    def add_blocks(self, num_blocks: int):
        self.texels += num_blocks * 16

    @property
    def mtexels_per_s(self) -> float:
        return self.texels / self.elapsed / 1e6 if self.elapsed else 0.0


def profile_encode(fn, pixels, trace_dir: str | None = None, iters: int = 3):
    """Seconds per call of the encode `fn(pixels)`, after one warm-up call,
    and its Mtexels/s. When fn's result is on a card, the calls are timed
    with CUDA events on that card; on the CPU with the host clock. With
    `trace_dir`, one more call is traced by torch.profiler into
    `trace_dir/trace.json` (a Chrome trace)."""
    out = fn(pixels)
    dev = out.device if torch.is_tensor(out) else torch.device("cpu")
    on_card = dev.type == "cuda"
    _synchronize_cards()

    if trace_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        with torch.profiler.profile(activities=activities) as prof:
            fn(pixels)
            _synchronize_cards()
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

    if on_card:
        with torch.cuda.device(dev):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(pixels)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(pixels)
        _synchronize_cards()
        dt = (time.perf_counter() - t0) / iters
    return dict(seconds=dt, mtexels_per_s=pixels.shape[0] * 16 / dt / 1e6)
