#!/usr/bin/env python3
"""Drive the torch port's BC7 main path on one CUDA card and check it.

    python3 chip_smoke.py                  # the check, on one card
    python3 chip_smoke.py --chunks 8192,16384,32768,65536
                                           # also time encode_bc7 per chunk size
    python3 chip_smoke.py --profile        # also profile one full-width encode
    python3 chip_smoke.py --out DIR        # chip_smoke.json and profile.txt
                                           # go to DIR (default build/chip_smoke)

Phases, each printed on its own line; any failure exits nonzero:
  1. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  2. exact_probe: divide/sqrt/round/clamp/FMA/int chains, card vs CPU bits;
  3. each kernel against its plain PyTorch version on the card, on the
     inputs a 256-block q50 encode gives it (every mode's launch): f32
     outputs compared as int32 bits, so the tolerance is 0;
  4. encode_bc7 on the card against the JAX package's q50 golden bytes;
  5. the full-width run: a 1024x1024 RGBA texture (65,536 blocks) through
     encode_bc7 at quality 50 with default Options, decoded back, timed
     with CUDA events (median of 3 after a warm-up), with each kernel's
     launches counted over the main path; then each kernel, launched at
     the full width, against its plain version on 1,024 of its blocks;
  6. one JSON line describing every kernel, the card's name and power
     limit, and the final {"ok": true, ...} line.

Needs the CUDA toolkit (nvcc) and a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12   # float32 outside the tensor cores, data sheet

KERNELS = {
    "shape_pca": dict(
        source="convectionkernels_tpu_torch/csrc/shape_pca.cu",
        replaces="convectionkernels_tpu/models/bc7_kernel.py:246"),
    "single_plane_mode_best": dict(
        source="convectionkernels_tpu_torch/csrc/single_plane.cu",
        replaces="convectionkernels_tpu/models/bc7_kernel.py:302"),
    "dual_plane_best": dict(
        source="convectionkernels_tpu_torch/csrc/dual_plane.cu",
        replaces="convectionkernels_tpu/models/bc7_kernel.py:629"),
}


# --- work model: bytes each launch must move, operations it must do --------
# Operations are counted from the sources' arithmetic per lane (every
# add, multiply, compare, select, shift and conversion is one operation),
# over the lanes and member pixels these inputs have.

def _popcount(x):
    import numpy as np
    x = np.asarray(x, dtype=np.int64)
    return sum(((x >> i) & 1) for i in range(16))


def work_shape_pca(args):
    pix, mask_bits, nch = args[0], args[1], args[2]
    with_alpha = args[5]
    n, s = pix.shape[0], mask_bits.shape[0]
    ncov = nch * (nch + 1) // 2
    per = (16 * (2 * nch + 1) + nch + 2          # centroid
           + 16 * (nch + 3 * ncov)               # covariance
           + 8 * (2 * nch * nch + 2 * nch)       # power iteration
           + 3 * nch + 2                         # length, direction
           + 16 * (3 * nch + 3)                  # projection
           + 7 * nch                             # endpoints
           + (16 * 4 + 2 if with_alpha else 0))
    nbytes = n * 64 * 4 + s * 4 + n * s * 16 * 2 + (n * s * 4
                                                     if with_alpha else 0)
    return nbytes, n * s * per


def work_single_plane(args):
    import numpy as np
    mode, pix, base = args[0], args[1], args[2]
    lane_i, cpow, cfg, rounds = args[6], args[8], args[9], args[11]
    n, s = pix.shape[0], base.shape[1]
    k = lane_i.shape[1]
    rounds = max(rounds, 1)
    nrc = cfg["num_real_channels"]
    members = _popcount(lane_i[3].cpu().numpy()).astype(np.int64)
    if cfg["fast_indexing"]:
        per_px = 16 + 3 + 9 * nrc
        finish = 8
    else:
        per_px = 16 + 3 * (4 + 11 * nrc) + 10
        finish = 0
    per_px_refine = 5 + 3 * nrc
    per_lane = (12 * nrc
                + rounds * (56 + 33 + finish + 6)
                + (rounds - 1) * (12 + 16 * nrc)
                + 6 * int(np.log2(cpow)))
    ops = n * (k * per_lane + int(members.sum())
               * (rounds * per_px + (rounds - 1) * per_px_refine))
    nbytes = (n * 64 * 4 + n * s * (32 + 4) + n * 16 + k * 28
              + n * k * 16)
    return nbytes, ops


def work_dual_plane(args):
    pix, ci, rounds, fast = args[0], args[1], args[3], args[5]
    n, lanes = pix.shape[0], ci.shape[1]
    rounds = max(rounds, 1)
    pca3 = (16 * 7 + 5 + 16 * 21 + 8 * 24 + 11 + 16 * 12 + 21)
    per_px = 12 + 7 + ((3 + 27) + 11 if fast else 3 * (3 + 33 + 11) + 16)
    per_lane = (16 * 12 + pca3 + 40
                + rounds * (48 + 30 + 16 * per_px + 60)
                + (rounds - 1) * (16 * 22 + 60))
    nbytes = n * 64 * 4 + lanes * 33 * 4 + n * lanes * 176
    return nbytes, n * lanes * per_lane


WORK = {"shape_pca": work_shape_pca,
        "single_plane_mode_best": work_single_plane,
        "dual_plane_best": work_dual_plane}

# positions of each wrapper's arguments whose leading axis is the block axis
ROW_ARGS = {"shape_pca": (0,), "single_plane_mode_best": (1, 2, 3, 4, 5),
            "dual_plane_best": (0,)}


# --- helpers -----------------------------------------------------------------

def flat_outputs(out):
    import torch
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return [t for t in out if torch.is_tensor(t)]


def take_rows(out, rows):
    """The kernel outputs of the blocks `rows` (every output's leading axis
    is the block axis)."""
    import torch
    if isinstance(out, dict):
        return {k: v.index_select(0, rows) for k, v in out.items()}
    return tuple(t.index_select(0, rows) if torch.is_tensor(t) else t
                 for t in out)


def compare(kernel_out, plain_out):
    """(bit-equal, max |kernel - plain|) over every output tensor."""
    import torch
    equal, max_err = True, 0.0
    for a, b in zip(flat_outputs(kernel_out), flat_outputs(plain_out)):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False, float("inf")
        if a.dtype == torch.float32:
            same = torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            same = torch.equal(a, b)
        equal &= same
        if not same:
            diff = (a.double() - b.double()).abs()
            diff = torch.where(torch.isnan(diff), torch.full_like(diff, 1e30),
                               diff)
            max_err = max(max_err, float(diff.max()))
    return equal, max_err


class Instrument:
    """Wrap the three kernel wrappers of models/bc7_kernel.py for one run:
    time each launch with CUDA events, add up its work model, and (when
    `with_plain`) run its plain version on the same inputs and compare,
    on every block or on the blocks `plain_rows` only."""

    def __init__(self, bc7_kernel, with_plain, plain_rows=None):
        self.mod = bc7_kernel
        self.with_plain = with_plain
        self.plain_rows = plain_rows
        self.events = {k: [] for k in KERNELS}
        self.plain_events = {k: [] for k in KERNELS}
        self.work = {k: [0, 0] for k in KERNELS}
        self.equal = {k: True for k in KERNELS}
        self.max_err = {k: 0.0 for k in KERNELS}
        self.detail = []
        self.saved = {}

    def __enter__(self):
        import torch
        plain = {"shape_pca": self.mod.shape_pca_plain,
                 "single_plane_mode_best":
                     self.mod.single_plane_mode_best_plain,
                 "dual_plane_best": self.mod.dual_plane_best_plain}
        for name in KERNELS:
            fn = getattr(self.mod, name)
            self.saved[name] = fn

            def wrapper(*args, _name=name, _fn=fn):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _fn(*args)
                end.record()
                self.events[_name].append((start, end))
                nbytes, ops = WORK[_name](args)
                self.work[_name][0] += nbytes
                self.work[_name][1] += ops
                self.detail.append(dict(kernel=_name, mode=(
                    args[0] if _name == "single_plane_mode_best" else None),
                    bytes=nbytes, ops=ops, event=len(self.events[_name]) - 1))
                if self.with_plain:
                    rows = self.plain_rows
                    if rows is not None:
                        args = [a.index_select(0, rows)
                                if i in ROW_ARGS[_name] else a
                                for i, a in enumerate(args)]
                    ps = torch.cuda.Event(enable_timing=True)
                    pe = torch.cuda.Event(enable_timing=True)
                    ps.record()
                    ref = plain[_name](*args)
                    pe.record()
                    self.plain_events[_name].append((ps, pe))
                    eq, err = compare(
                        out if rows is None else take_rows(out, rows), ref)
                    self.equal[_name] &= eq
                    self.max_err[_name] = max(self.max_err[_name], err)
                return out

            setattr(self.mod, name, wrapper)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)
        return False

    @staticmethod
    def total_ms(pairs):
        return sum(s.elapsed_time(e) for s, e in pairs)

    def detail_ms(self):
        for d in self.detail:
            s, e = self.events[d["kernel"]][d["event"]]
            d["ms"] = s.elapsed_time(e)
        return self.detail


def make_texture(seed=0, size=1024):
    """A 1024x1024 RGBA texture from a seed: smooth color fields with
    noise and edges, an opaque region, a region of gradient alpha and a
    punch-through (0/255 alpha) region."""
    import numpy as np
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.empty((size, size, 4), dtype=np.float32)
    img[..., 0] = 128 + 100 * np.sin(2 * np.pi * (3 * x + 1.5 * y))
    img[..., 1] = 128 + 90 * np.cos(2 * np.pi * (2 * y - x))
    img[..., 2] = 255 * x * y + 40 * ((x * 16).astype(int) % 2)
    img[..., :3] += rng.normal(0, 6, (size, size, 3))
    img[..., 3] = 255
    img[: size // 2, size // 2:, 3] = 255 * y[: size // 2, size // 2:] * 2
    checker = ((x * 64).astype(int) + (y * 64).astype(int)) % 2
    img[size // 2:, : size // 2, 3] = 255 * checker[size // 2:, : size // 2]
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    blocks = img.reshape(size // 4, 4, size // 4, 4, 4).transpose(0, 2, 1, 3, 4)
    return blocks.reshape(-1, 16, 4).copy()


def profile_encode(api, tex_dev, opts, dev, out_dir):
    """One full-width encode under torch.profiler: the device's busy time
    by kernel name against the host's wall time for the same encode."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.encode_bc7(tex_dev, opts, quality=50, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    rows = []
    for e in averages:
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    with open(os.path.join(out_dir, "profile.txt"), "w") as f:
        f.write(averages.table(sort_by="self_cuda_time_total", row_limit=80))
    return dict(wall_ms=wall_ms, device_busy_ms=sum(r[1] for r in rows),
                device_launches=sum(r[2] for r in rows),
                top=[dict(name=k[:100], ms=ms, count=c)
                     for k, ms, c in rows[:30]])


def ptxas_usage(log_text):
    """{kernel<template args>: "N registers, S bytes stack"} from the
    -Xptxas -v output nvcc gave when it built a library."""
    usage, entry = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '\w*?([a-z_]+_kernel)"
                      r"(?:I((?:L[ib]\d+E)+)E)?", line)
        if m:
            args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
            entry = f"{m.group(1)}<{','.join(args)}>" if args else m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            stack = re.search(r"(\d+) bytes cumulative stack", line)
            usage[entry] = (f"{m.group(1)} registers, "
                            f"{stack.group(1) if stack else 0} bytes stack")
    return usage


def psnr(a, b):
    import numpy as np
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def phase(name, **fields):
    print(json.dumps(dict(phase=name, **fields)), flush=True)


# --- main ----------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", default="",
                    help="comma-separated encode chunk sizes to time")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one full-width encode "
                         "(profile.txt in --out)")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "chip_smoke"),
                    help="directory for chip_smoke.json (every launch's "
                         "time and work) and profile.txt")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np

    import convectionkernels_tpu_torch as ckt
    from convectionkernels_tpu_torch import api, cuda_lib, exact_probe
    from convectionkernels_tpu_torch.models import bc7_kernel

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    os.makedirs(args.out, exist_ok=True)
    detail = {}

    # 1. build
    t0 = time.perf_counter()
    cuda_lib.build_all()
    usage = {}
    for n in cuda_lib.SOURCES:
        with open(cuda_lib.log_path(n)) as f:
            usage.update(ptxas_usage(f.read()))
    detail["ptxas"] = usage
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          libraries=[os.path.basename(cuda_lib.library_path(n))
                     for n in cuda_lib.SOURCES], ptxas=usage)

    # 2. exactness probe
    mism = exact_probe.check(dev)
    phase("exact_probe", mismatches=mism)
    if any(mism.values()):
        raise SystemExit(f"exact_probe: the card's results differ from the "
                         f"CPU's — check nvcc's flags: {mism}")

    # 3. each kernel against its plain version, on a 256-block q50 encode
    with np.load(os.path.join(REPO, "convectionkernels_tpu_torch",
                              "testdata", "bc7_q50_golden.npz")) as z:
        golden_px, golden_blocks = z["pixels"], z["blocks"]
    small = torch.as_tensor(golden_px, device=dev)
    opts = ckt.Options()
    plan = ckt.plan_from_quality(50)
    from convectionkernels_tpu_torch.models import bc7
    # twice: the first run also loads the kernels and PyTorch's own CUDA
    # code, so only the second one's times are kept
    for _ in range(2):
        with Instrument(bc7_kernel, with_plain=True) as small_run:
            bc7.pack(small, opts.flags, opts.channel_weights(), plan,
                     opts.refine_rounds_bc7)
            torch.cuda.synchronize()
        if not all(small_run.equal.values()):
            break
    for name in KERNELS:
        phase("kernel_vs_plain", kernel=name,
              launches=len(small_run.events[name]),
              equal=small_run.equal[name],
              max_abs_err=small_run.max_err[name])
    if not all(small_run.equal.values()):
        raise SystemExit("a kernel disagrees with its plain version")
    plain_ms = {k: Instrument.total_ms(small_run.plain_events[k])
                for k in KERNELS}
    kernel_small_ms = {k: Instrument.total_ms(small_run.events[k])
                       for k in KERNELS}

    # 4. the port's bytes against the JAX package's golden
    got = api.encode_bc7(golden_px, quality=50, device=dev).cpu().numpy()
    bad = int((got != golden_blocks).any(axis=1).sum())
    phase("golden_q50", blocks=len(golden_px), mismatched_blocks=bad)
    if bad:
        raise SystemExit(f"{bad} of {len(golden_px)} blocks differ from the "
                         f"JAX package's q50 golden")

    # 5. the full-width run: 65,536 blocks, q50, default options
    tex = make_texture(seed=0)
    tex_dev = torch.as_tensor(tex, device=dev)
    torch.cuda.synchronize()
    bc7_kernel.LAUNCHES.clear()
    out = api.encode_bc7(tex_dev, opts, quality=50, device=dev)
    torch.cuda.synchronize()
    launches = {k: bc7_kernel.LAUNCHES[k] for k in KERNELS}
    if out.shape != (tex.shape[0], 16) or out.dtype != torch.uint8:
        raise SystemExit(f"encode_bc7 returned {tuple(out.shape)} "
                         f"{out.dtype}")
    if not all(launches.values()):
        raise SystemExit(f"a kernel of the main path never launched: "
                         f"{launches}")
    times = []
    for _ in range(3):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        again = api.encode_bc7(tex_dev, opts, quality=50, device=dev)
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
        if not torch.equal(again, out):
            raise SystemExit("encode_bc7 is not deterministic")
    ms = statistics.median(times)
    decoded = api.decode_bc7(out, device="cpu").numpy()
    quality_db = psnr(decoded, tex)
    if not np.isfinite(quality_db) or quality_db < 30.0:
        raise SystemExit(f"round-trip PSNR {quality_db:.2f} dB is too low")
    texels = tex.shape[0] * 16
    phase("full_width", blocks=tex.shape[0], chunk=api.CHUNK_BC7,
          encode_ms=times, encode_ms_median=ms,
          mtexels_per_s=texels / (ms * 1e-3) / 1e6, psnr_db=quality_db,
          launches=launches)

    # per-kernel device time at the full-width shapes (one more encode)
    with Instrument(bc7_kernel, with_plain=False) as full_run:
        api.encode_bc7(tex_dev, opts, quality=50, device=dev)
        torch.cuda.synchronize()

    # each kernel launched at the full width against its plain version on
    # the same inputs, for 1,024 blocks spread over the texture
    rows = torch.arange(0, tex.shape[0], tex.shape[0] // 1024, device=dev)
    with Instrument(bc7_kernel, with_plain=True, plain_rows=rows) as wide:
        api.encode_bc7(tex_dev, opts, quality=50, device=dev)
        torch.cuda.synchronize()
    for name in KERNELS:
        phase("kernel_vs_plain_full_width", kernel=name,
              launches=len(wide.events[name]), blocks_compared=len(rows),
              equal=wide.equal[name], max_abs_err=wide.max_err[name])
    if not all(wide.equal.values()):
        raise SystemExit("a kernel disagrees with its plain version at the "
                         "full width")
    detail["full_width_launches"] = full_run.detail_ms()
    detail["small_launches"] = small_run.detail_ms()

    if args.profile:
        prof = profile_encode(api, tex_dev, opts, dev, args.out)
        detail["profile"] = prof
        phase("profile", wall_ms=prof["wall_ms"],
              device_busy_ms=prof["device_busy_ms"],
              device_launches=prof["device_launches"], top=prof["top"][:8])

    # optional chunk sweep
    if args.chunks:
        sweep = {}
        default_chunk = api.CHUNK_BC7
        try:
            for chunk in [int(c) for c in args.chunks.split(",")]:
                api.CHUNK_BC7 = chunk
                api.encode_bc7(tex_dev, opts, quality=50, device=dev)
                torch.cuda.synchronize()
                runs = []
                for _ in range(3):
                    torch.cuda.reset_peak_memory_stats(dev)
                    s = torch.cuda.Event(enable_timing=True)
                    e = torch.cuda.Event(enable_timing=True)
                    s.record()
                    api.encode_bc7(tex_dev, opts, quality=50, device=dev)
                    e.record()
                    torch.cuda.synchronize()
                    runs.append(s.elapsed_time(e))
                sweep[chunk] = dict(
                    encode_ms=runs,
                    peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
        finally:
            api.CHUNK_BC7 = default_chunk
        phase("chunk_sweep", results=sweep)
        detail["chunk_sweep"] = sweep

    # 6. the kernels line, the card, and the result
    kernels = []
    for name, meta in KERNELS.items():
        nbytes, ops = full_run.work[name]
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = ops / H100_F32_OPS_PER_S * 1e3
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            max_abs_err=max(small_run.max_err[name], wide.max_err[name]),
            ms=Instrument.total_ms(full_run.events[name]),
            plain_ms=plain_ms[name],
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None,
            equal=small_run.equal[name] and wide.equal[name],
            plain_blocks=len(golden_px),
            ms_at_plain_blocks=kernel_small_ms[name],
            bytes=nbytes, ops=ops))
    detail["kernels"] = kernels
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    detail["card"] = smi
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
