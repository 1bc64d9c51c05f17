"""The benchmark's plain reference encoder of ETC2 RGBA: ETC2 colour
(CompressETC2Block, ConvectionKernels_ETC.cpp:1664-1887) beside EAC alpha
(CompressETC2AlphaBlockInternal, ETC.cpp:1902-2085), as
cvtt::Kernels::EncodeETC2RGBA (API.cpp:270-286) interleaves them.

It is written for this benchmark from the JAX package's
convectionkernels_tpu/models/etc.py and tables/etc_tables.py, read and not
imported, and shares no code with the program's models/etc.py. It imports
torch and numpy only: nothing of the program and nothing of JAX. Where
the JAX package reshapes a search for the TPU, this file keeps the
reference's plain form:

- the ETC1 search runs on the dense (table, offset) candidate grid, 8 x 81
  a sector, where the JAX package and the program compact it into runs;
- a differential pair is legal by a per-channel test of its colour
  difference, where they pack the three channels into one word;
- the H mode scans its (table, i1, i0) pair grid block-major;
- winners are taken by gather, and the first of equal minima by a masked
  minimum of indices.

Every float32 sum runs in the reference's order, pixel by pixel, and every
divide and square root of a float goes through exact_divide and
exact_sqrt below (the output check's control rounds both to bfloat16).
Only the stages of the non-punch-through encoder are here; the Uniform and
FakeBT709 flags are kept so that every stored ETC2 golden can be held
against it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .options import Flags, Options

F = np.float32
I32 = torch.int32
I64 = torch.int64
FLT_MAX = float(np.finfo(np.float32).max)
INF = float("inf")

# --- format tables -----------------------------------------------------------

# g_flipTables (ETC.cpp:47-57): the pixels of each sector, by flip
FLIP = (((0, 1, 4, 5, 8, 9, 12, 13), (2, 3, 6, 7, 10, 11, 14, 15)),
        ((0, 1, 2, 3, 4, 5, 6, 7), (8, 9, 10, 11, 12, 13, 14, 15)))
# the column-major order in which a block's 16 selectors are stored
ORDER = (0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15)
# an ETC1 selector (0..3, modifier order) to its 2-bit code
MODIFIER_CODES = (3, 2, 0, 1)
ETC1_MODIFIERS = ((-8, -2, 2, 8), (-17, -5, 5, 17), (-29, -9, 9, 29),
                  (-42, -13, 13, 42), (-60, -18, 18, 60), (-80, -24, 24, 80),
                  (-106, -33, 33, 106), (-183, -47, 47, 183))
TH_MODIFIERS = (3, 6, 11, 16, 23, 32, 41, 64)
ALPHA_MODIFIERS = ((2, 5, 8, 14), (2, 6, 9, 12), (1, 4, 7, 12), (1, 3, 5, 12),
                   (2, 5, 7, 11), (2, 6, 8, 10), (3, 6, 7, 10), (2, 4, 7, 10),
                   (1, 5, 7, 9), (1, 4, 7, 9), (1, 3, 7, 9), (1, 4, 6, 9),
                   (2, 3, 6, 9), (0, 1, 2, 9), (3, 5, 7, 8), (2, 4, 6, 8))
ALPHA_ROUNDERS = 13
TH_STEPS = 33          # premultipliers -16..16 of the T and H colour scans
OFFSETS = 81           # the most distinct 8-pixel modifier sums of a table


@functools.lru_cache(maxsize=None)
def etc1_offsets() -> np.ndarray:
    """[8, 81] int32: each table's distinct sums of 8 modifier picks,
    ascending, the shorter lists repeating their last sum (a repeat is the
    same candidate again)."""
    out = np.zeros((8, OFFSETS), dtype=np.int32)
    for t, mods in enumerate(ETC1_MODIFIERS):
        sums = sorted({a * mods[0] + b * mods[1] + c * mods[2]
                       + (8 - a - b - c) * mods[3]
                       for a in range(9) for b in range(9 - a)
                       for c in range(9 - a - b)})
        out[t] = sums + [sums[-1]] * (OFFSETS - len(sums))
    return out


@functools.lru_cache(maxsize=None)
def alpha_rounding() -> np.ndarray:
    """[16, 13] int32: the nearest positive alpha modifier to each rounder
    value, the first on a tie (MakeTables, g_alphaRoundingTables)."""
    out = np.zeros((16, ALPHA_ROUNDERS), dtype=np.int32)
    for t, mods in enumerate(ALPHA_MODIFIERS):
        for r in range(ALPHA_ROUNDERS):
            dist = [abs(r - m) for m in mods]
            out[t, r] = dist.index(min(dist))
    return out


def _yuv_double(r, g, b):
    # MakeTables' FakeBT709 in double; its u row's 0.5f is exact
    return (r * 0.368233989135369 + g * 1.23876274963149
            + b * 0.125054068802017,
            r * 0.5 - g * 0.4541529 - b * 0.04584709,
            r * -0.081014709086133 - g * 0.272538676238785
            + b * 0.353553390593274)


@functools.lru_cache(maxsize=None)
def fake_bt709_octants() -> np.ndarray:
    """[4096] int32 (FakeBT709 g_rounding16): for each 4-bit (r, g, b)
    remainder, the octant of the 16-step cube whose corner lies nearest in
    FakeBT709 space, the first on a tie."""
    corners = [_yuv_double(16.0 * (o & 1), 8.0 * (o & 2), 4.0 * (o & 4))
               for o in range(8)]
    out = np.zeros(4096, dtype=np.int32)
    for r in range(16):
        for g in range(16):
            for b in range(16):
                p = _yuv_double(float(r), float(g), float(b))
                errs = [sum((c[k] - p[k]) ** 2 for k in range(3))
                        for c in corners]
                out[(r * 16 + g) * 16 + b] = errs.index(min(errs))
    return out


# --- float helpers the control replaces --------------------------------------

def exact_divide(a, b):
    """float32 a / b, rounded to nearest (IEEE on the CPU and on CUDA)."""
    return a / b


def exact_sqrt(x):
    """float32 square root rounded to nearest: the float64 root rounded to
    float32 (a double rounding that cannot miss for a square root)."""
    return torch.sqrt(x.double()).float()


# --- the encoder's state -----------------------------------------------------

class _Encoding:
    """The blocks' pixels and the options they are encoded with."""

    def __init__(self, blocks: torch.Tensor, options: Options):
        self.device = blocks.device
        self.n = blocks.shape[0]
        self.fake = bool(options.flags & Flags.ETC_USE_FAKE_BT709)
        self.accurate = bool(options.flags & Flags.ETC_FAKE_BT709_ACCURATE)
        self.uniform = bool(options.flags & Flags.UNIFORM)
        self.w = (F(options.red_weight), F(options.green_weight),
                  F(options.blue_weight))
        self.pix = blocks[:, :, :3].to(I32)                       # [N,16,3]
        if self.fake:
            self.pw = torch.stack(to_yuv([self.pix[..., c].float()
                                          for c in range(3)]), -1)
        elif self.uniform:
            self.pw = self.pix.float()
        else:
            self.pw = torch.stack([self.pix[..., c].float() * float(self.w[c])
                                   for c in range(3)], -1)

    def const(self, values, dtype=I32):
        return torch.as_tensor(np.asarray(values), dtype=dtype,
                               device=self.device)

    def error(self, recon, pix, pw, fake=None):
        """ComputeError{FakeBT709,Uniform,Weighted} (ETC.cpp:59-92):
        recon, pix: 3 int32 tensors; pw: 3 float32, all broadcastable.
        `fake` False is the RGB error that the T mode's line colours use under
        the FakeBT709 flag too."""
        fake = self.fake if fake is None else fake
        if fake:
            yuv = to_yuv([c.float() for c in recon])
            d = [yuv[c] - pw[c] for c in range(3)]
        elif self.uniform:
            d = [(pix[c] - recon[c]).float() for c in range(3)]
        else:
            d = [recon[c].float() * float(self.w[c]) - pw[c]
                 for c in range(3)]
        return d[0] * d[0] + d[1] * d[1] + d[2] * d[2]

    def px(self, i, shape=()):
        """Pixel i's ints and pre-weighted floats, as 3-lists of [N, 1...]."""
        view = (self.n,) + (1,) * len(shape)
        return ([self.pix[:, i, c].reshape(view) for c in range(3)],
                [self.pw[:, i, c].reshape(view) for c in range(3)])


def to_yuv(rgb):
    """ConvertToFakeBT709 (ETC.cpp:2337-2347), float32."""
    r, g, b = rgb
    y = (r * float(F(0.368233989135369)) + g * float(F(1.23876274963149))
         + b * float(F(0.125054068802017)))
    u = (r * 0.5 - g * float(F(0.4541529)) - b * float(F(0.04584709)))
    v = (r * float(F(-0.081014709086133)) - g * float(F(0.272538676238785))
         + b * float(F(0.353553390593274)))
    return [y, u, v]


def from_yuv(yuv):
    """ConvertFromFakeBT709 (ETC.cpp:2349-2359), float32."""
    yy = yuv[0] * float(F(0.57735026466774571071))
    u, v = yuv[1], yuv[2]
    return [yy + u * float(F(1.5748000207960953486)),
            yy - u * float(F(0.46812425854364753669))
            - v * float(F(0.26491652528157560861)),
            yy + v * float(F(2.6242146882856944069))]


class _Best:
    """The running winner over the encoder's stages: the lowest error, and
    among equal errors the lowest stage rank; the block as two 32-bit
    words."""

    def __init__(self, enc: _Encoding):
        n, dev = enc.n, enc.device
        self.error = torch.full((n,), FLT_MAX, dtype=torch.float32,
                                device=dev)
        self.rank = torch.full((n,), 2**30, dtype=I32, device=dev)
        self.hi = torch.zeros((n,), dtype=I64, device=dev)
        self.lo = torch.zeros((n,), dtype=I64, device=dev)

    def update(self, error, rank, hi, lo, valid=None):
        better = (error < self.error) | ((error == self.error)
                                         & (rank < self.rank))
        if valid is not None:
            better = better & valid
        self.error = torch.where(better, error, self.error)
        self.rank = torch.where(better, torch.full_like(self.rank, rank),
                                self.rank)
        self.hi = torch.where(better, hi, self.hi)
        self.lo = torch.where(better, lo, self.lo)

    def to_bytes(self):
        cols = [(w >> s) & 0xFF for w in (self.hi, self.lo)
                for s in (24, 16, 8, 0)]
        return torch.stack(cols, -1).to(torch.uint8)


def first_min(x, dim=-1):
    """(least value, first index holding it) along `dim`."""
    m = x.amin(dim)
    idx = torch.arange(x.shape[dim], device=x.device).reshape(
        [-1 if d == dim % x.ndim else 1 for d in range(x.ndim)])
    first = torch.where(x == m.unsqueeze(dim), idx, x.shape[dim]).amin(dim)
    return m, first


def pick(x, idx):
    """x[i, idx[i]] of x [N, K]."""
    return torch.gather(x, 1, idx[:, None].to(I64))[:, 0]


def floor_div(numer, divisor):
    """The reference's integer divide of non-negative ints; 0 where the
    divisor is 0."""
    return torch.where(divisor == 0, torch.zeros_like(numer),
                       numer // divisor.clamp(min=1))


# --- planar (ETC.cpp:1274-1663) ----------------------------------------------

def _decode_planar(coeff, ch):
    """DecodePlanarCoeff (ETC.cpp:1266-1272): 6/7/6 bits to 8."""
    return (coeff << 1) | (coeff >> 6) if ch == 1 else \
        (coeff << 2) | (coeff >> 4)


def _planar(enc: _Encoding, best: _Best, rank: int):
    """EncodePlanar: the least-squares plane of each channel, solved by the
    reference's elimination, its coefficients rounded both ways."""
    n = enc.n
    z = F(0)
    fhh = fho = fhv = foo = fov = fvv = z
    for i in range(16):
        x, y = F(i % 4), F(i // 4)
        # fho, fhv and fov are summed twice a pixel, through aliases
        fhh = F(fhh + x * x)
        fhv = F(F(fhv + x * y) + y * x)
        fho = F(F(fho + x) + x)
        fvv = F(fvv + y * y)
        fov = F(F(fov + y) + y)
        foo = F(foo + F(1))
    d, e, ff, k, m, nn, p = (F(2) * fhh, fho, fhv, F(2) * fvv, fho,
                             F(2) * foo, fov)
    r0to1 = F(-fhv / d)
    r0to2 = F(-m / d)
    j1 = F(fov + r0to1 * e)
    k1 = F(k + r0to1 * ff)
    n1 = F(nn + r0to2 * e)
    p1 = F(p + r0to2 * ff)
    r1to2 = F(-p1 / k1)
    n2 = F(n1 + r1to2 * j1)
    r2to1 = F(-j1 / n2)
    elim2 = F(-ff / k1)
    elim1 = F(-e / n2)

    planes = []                                    # [ch] -> (o, h, v)
    for ch in range(3):
        fh = torch.zeros((n,), dtype=torch.float32, device=enc.device)
        fv = torch.zeros_like(fh)
        fo = torch.zeros_like(fh)
        for i in range(16):
            x, y = float(i % 4), float(i // 4)
            c = enc.pw[:, i, ch] if enc.fake else enc.pix[:, i, ch].float()
            for _ in range(2):
                fh = fh - c * x
                fv = fv - c * y
                fo = fo - c
        l1 = fv + fh * float(r0to1)
        q1 = fo + fh * float(r0to2)
        q2 = q1 + l1 * float(r1to2)
        o = exact_divide(-q2, torch.full_like(q2, float(n2)))
        l2 = l1 + q2 * float(r2to1)
        g2 = fh + l2 * float(elim2) + q2 * float(elim1)
        h = exact_divide(-g2, torch.full_like(g2, float(d)))
        v = exact_divide(-l2, torch.full_like(l2, float(k1)))
        planes.append((o, h * 4.0 + o, v * 4.0 + o))

    def scaled(value, ch):
        value = value.clamp(min=0.0)
        if ch == 1:
            return torch.minimum(value * float(F(127.0 / 255.0)),
                                 torch.full_like(value, 127.0))
        return torch.minimum(value * float(F(63.0 / 255.0)),
                             torch.full_like(value, 63.0))

    total = torch.zeros((n,), dtype=torch.float32, device=enc.device)
    coeffs = []
    if enc.fake:
        rgb = [from_yuv([planes[c][k] for c in range(3)]) for k in range(3)]
        for ch in range(3):
            coeffs.append([torch.floor(scaled(rgb[k][ch], ch) + 0.5).to(I32)
                           for k in range(3)])
        recon = [[None] * 3 for _ in range(16)]
        for ch in range(3):
            do, dh, dv = (_decode_planar(c, ch) for c in coeffs[ch])
            for i in range(16):
                x, y = i % 4, i // 4
                val = (x * (dh - do) + y * (dv - do) + (do << 2) + 2) >> 2
                recon[i][ch] = val.clamp(0, 255)
        for i in range(16):
            pix, pw = enc.px(i)
            total = total + enc.error(recon[i], pix, pw)
    else:
        for ch in range(3):
            ranges = [(torch.floor(s).to(I32), torch.ceil(s).to(I32))
                      for s in (scaled(c, ch) for c in planes[ch])]
            best_err = torch.full((n,), FLT_MAX, dtype=torch.float32,
                                  device=enc.device)
            chosen = [r[0] for r in ranges]
            for io in range(2):
                do = _decode_planar(ranges[0][io], ch)
                for ih in range(2):
                    dh = _decode_planar(ranges[1][ih], ch)
                    for iv in range(2):
                        dv = _decode_planar(ranges[2][iv], ch)
                        err = torch.zeros_like(best_err)
                        for i in range(16):
                            x, y = i % 4, i // 4
                            val = (x * (dh - do) + y * (dv - do)
                                   + (do << 2) + 2) >> 2
                            delta = (enc.pix[:, i, ch]
                                     - val.clamp(0, 255)).float()
                            err = err + delta * delta
                        better = err < best_err
                        best_err = torch.minimum(err, best_err)
                        chosen = [torch.where(better, ranges[c][ix], chosen[c])
                                  for c, ix in enumerate((io, ih, iv))]
            if not enc.uniform:
                best_err = best_err * float(F(enc.w[ch] * enc.w[ch]))
            total = total + best_err
            coeffs.append(chosen)

    (ro, rh, rv), (go, gh, gv), (bo, bh, bv) = [[c.to(I64) for c in cs]
                                                for cs in coeffs]
    # ETC.cpp:1590-1660: the planar block hides behind a differential
    # block whose red, green and blue each overflow
    go1, go2 = go >> 6, go & 63
    bo1, bo2, bo3 = bo >> 5, (bo >> 3) & 3, bo & 7
    rh1, rh2 = rh >> 1, rh & 1
    fake_r, fake_dr = ro >> 2, go1 | ((ro & 3) << 1)
    fake_g, fake_dg = go2 >> 2, ((go2 & 3) << 1) | bo1
    fake_b, fake_db = bo2, bo3 >> 1
    hi = (ro << 25) | (go1 << 24) | (go2 << 17) | (bo1 << 16) | (bo2 << 11) \
        | (bo3 << 7) | (rh1 << 2) | (1 << 1) | rh2
    hi = hi | torch.where(((fake_dr & 4) != 0) & (fake_r + fake_dr < 8),
                          1 << 31, 0)
    hi = hi | torch.where(((fake_dg & 4) != 0) & (fake_g + fake_dg < 8),
                          1 << 23, 0)
    hi = hi | torch.where(fake_b + fake_db < 4, 1 << 10, 7 << 13)
    lo = (gh << 25) | (bh << 19) | (rv << 13) | (gv << 6) | bv
    best.update(total, rank, hi, lo)


# --- the chroma split of the T and H modes (ETC.cpp:1723-1848) ---------------

def _chroma_axes(enc: _Encoding):
    """ETC2CompressionDataInternal's two weighted chroma axes, float32 on
    the host (ETC.cpp:3117-3145)."""
    cd = enc.w
    rot = (cd[1], cd[2], cd[0])
    offs = F(-(rot[0] * cd[0] + rot[1] * cd[1] + rot[2] * cd[2])
             / (cd[0] * cd[0] + cd[1] * cd[1] + cd[2] * cd[2]))
    a0 = [F(rot[i] + cd[i] * offs) for i in range(3)]
    a1 = [F(a0[1] * cd[2] - a0[2] * cd[1]), F(a0[2] * cd[0] - a0[0] * cd[2]),
          F(a0[0] * cd[1] - a0[1] * cd[0])]
    l0 = F(a0[0] * a0[0] + a0[1] * a0[1] + a0[2] * a0[2])
    l1 = F(a1[0] * a1[0] + a1[1] * a1[1] + a1[2] * a1[2])
    ratio = F(np.sqrt(F(l0 / l1)))
    return a0, [F(a * ratio) for a in a1]


def _split(enc: _Encoding):
    """Each pixel's side of the line through the block's chroma centroid
    along its principal axis: 16 bool [N]."""
    if enc.uniform:
        rcp_sqrt3 = float(F(0.57735026918962576450914878050196))
        p = enc.pix
        cc = [[p[:, i, 0] - p[:, i, 2],
               p[:, i, 0] - (p[:, i, 1] << 1) + p[:, i, 2]]
              for i in range(16)]
        cen = [sum(cc[i][c] for i in range(16)) for c in range(2)]
        chroma = [[((cc[i][c] << 4) - cen[c]).float() for c in range(2)]
                  for i in range(16)]
        for i in range(16):
            chroma[i][1] = chroma[i][1] * rcp_sqrt3
    else:
        a0, a1 = _chroma_axes(enc)
        pw = enc.pw
        cc = [[pw[:, i, 0] * float(a[0]) + pw[:, i, 1] * float(a[1])
               + pw[:, i, 2] * float(a[2]) for a in (a0, a1)]
              for i in range(16)]
        cen = [cc[0][c] for c in range(2)]
        for i in range(1, 16):
            cen = [cen[c] + cc[i][c] for c in range(2)]
        chroma = [[cc[i][c] * 16.0 - cen[c] for c in range(2)]
                  for i in range(16)]
    xx = yy = xy = None
    for i in range(16):
        x, y = chroma[i]
        xx = x * x if xx is None else xx + x * x
        yy = y * y if yy is None else yy + y * y
        xy = x * y if xy is None else xy + x * y
    half = (xx + yy) * 0.5
    det = xx * yy - xy * xy
    mm = exact_sqrt((half * half - det).clamp(min=0.0))
    ev = half + mm
    dx = yy - ev + xy
    dy = -(xx - ev + xy)
    dx = torch.where((dx == 0.0) & (dy == 0.0), torch.ones_like(dx), dx)
    return [(chroma[i][0] * dx + chroma[i][1] * dy) < 0.0 for i in range(16)]


def _th_fake_rounding(enc, quantized, targets, granularity):
    """ResolveTHFakeBT709Rounding (ETC.cpp:2286-2327): round each 4-bit
    channel up or not, by the octant nearest the target in FakeBT709."""
    low, high = [], []
    for q in quantized:
        unq = (q << 4) | q
        low.append(((unq * granularity) << 1).float())
        high.append(((torch.clamp(unq + 17, max=255) * granularity) << 1)
                    .float())
    want = to_yuv([t.float() for t in targets])
    best_err = best_oct = None
    for octant in range(8):
        got = to_yuv([high[c] if octant >> c & 1 else low[c]
                      for c in range(3)])
        d = [got[c] - want[c] for c in range(3)]
        err = d[0] * d[0] + d[1] + d[1] + d[2] * d[2]   # the reference's d1+d1
        if best_err is None:
            best_err, best_oct = err, torch.zeros_like(quantized[0])
        else:
            best_oct = torch.where(err < best_err, octant, best_oct)
            best_err = torch.minimum(err, best_err)
    return [quantized[c] + ((best_oct >> c) & 1) for c in range(3)]


def _emit_t(line, iso, selectors, table):
    """EmitTModeBlock (ETC.cpp:2414-2460), opaque. line, iso: 3 int64 [N]
    channel values; selectors: int64 [N], 2 bits a pixel."""
    rh, rl = (iso[0] >> 2) & 3, iso[0] & 3
    hi = torch.where(rh + rl < 4, 1 << 26, 7 << 29) | (rh << 27) \
        | (rl << 24) | (iso[1] << 20) | (iso[2] << 16) | (line[0] << 12) \
        | (line[1] << 8) | (line[2] << 4) | (((table >> 1) & 3) << 2) \
        | (1 << 1) | (table & 1)
    lo = torch.zeros_like(hi)
    for k in range(16):
        sel = (selectors >> (2 * ORDER[k])) & 3
        lo = lo | ((sel & 1) << k) | (((sel >> 1) & 1) << (16 + k))
    return hi, lo


def _emit_h(colors, sector_bits, sign_bits, table):
    """EmitHModeBlock (ETC.cpp:2462-2563), opaque, with its T-mode block
    where the two colours are equal. colors: 2 int64 [N], r<<10|g<<5|b."""
    t_line = [(colors[0] >> s) & 31 for s in (10, 5, 0)]
    t_sel = torch.full_like(colors[0], 0x55555555)
    for k in range(16):
        t_sel = t_sel | (((sign_bits >> k) & 1) << (2 * k + 1))
    t_hi, t_lo = _emit_t(t_line, t_line, t_sel, table)

    c = [[(colors[s] >> (10 - 5 * ch)) & 15 for ch in range(3)]
         for s in range(2)]
    swap = ((table & 1) == 1) != (colors[0] > colors[1])
    c = [[torch.where(swap, c[1][ch], c[0][ch]) for ch in range(3)],
         [torch.where(swap, c[0][ch], c[1][ch]) for ch in range(3)]]
    sector_bits = torch.where(swap, sector_bits ^ 0xFFFF, sector_bits)
    r1, g1a, g1b, b1a, b1b = (c[0][0], c[0][1] >> 1, c[0][1] & 1,
                              c[0][2] >> 3, c[0][2] & 7)
    hi = (r1 << 27) | (g1a << 24) | (g1b << 20) | (b1a << 19) | (b1b << 15) \
        | (c[1][0] << 11) | (c[1][1] << 7) | (c[1][2] << 3) \
        | (((table >> 2) & 1) << 2) | (1 << 1) | ((table >> 1) & 1)
    hi = hi | torch.where(((g1a & 4) != 0) & (r1 + g1a < 8), 1 << 31, 0)
    hi = hi | torch.where((b1a | (g1b << 1)) + (b1b >> 1) < 4, 1 << 18,
                          7 << 21)
    lo = torch.zeros_like(hi)
    for k in range(16):
        src = ORDER[k]
        lo = lo | (((sign_bits >> src) & 1) << k) \
            | (((sector_bits >> src) & 1) << (16 + k))
    same = colors[0] == colors[1]
    return torch.where(same, t_hi, hi), torch.where(same, t_lo, lo)


def _premultipliers(enc, count):
    """[N, 8, 33]: each table's modifier times the premultipliers -16..16
    clamped to +-count, times 2."""
    steps = enc.const(np.arange(-16, 17))[None, :]
    clamped = torch.maximum(-count[:, None],
                            torch.minimum(count[:, None], steps))
    return clamped[:, None, :] * (2 * enc.const(TH_MODIFIERS))[None, :, None]


def _tmode(enc: _Encoding, best: _Best, rank: int, isolated):
    """EncodeTMode (ETC.cpp:396-648): the isolated pixels' mean colour
    against a line colour +-modifier, over 8 tables x 33 premultipliers."""
    n = enc.n
    iso_mask = torch.stack(isolated, 1)                         # [N,16]
    num_iso = iso_mask.to(I32).sum(1)
    num_line = 16 - num_iso
    iso_total = [torch.where(iso_mask, enc.pix[..., c], 0).sum(1)
                 for c in range(3)]
    line_total = [enc.pix[..., c].sum(1) - iso_total[c] for c in range(3)]

    addend = (num_iso << 4) | num_iso
    numer = [2 * iso_total[c] + (0 if enc.fake else addend)
             for c in range(3)]
    iso_q = [floor_div(numer[c], num_iso * 34) for c in range(3)]
    if enc.fake:
        iso_q = _th_fake_rounding(enc, iso_q, numer, num_iso)
    iso_color = [(q << 4) | q for q in iso_q]
    iso_err = []
    for i in range(16):
        pix, pw = enc.px(i)
        iso_err.append(enc.error(iso_color, pix, pw))

    mods = _premultipliers(enc, num_line)                       # [N,8,33]
    line_addend = (num_line << 4) | num_line
    quant, targets = [], []
    for c in range(3):
        base = 2 * line_total[c] + (0 if enc.fake else line_addend)
        num = (base[:, None, None] + mods).clamp(min=0)
        quant.append(torch.clamp(floor_div(num, (num_line * 34)[:, None,
                                                                 None]),
                                 max=15))
        targets.append(num)
    if enc.fake:
        quant = [q.clamp(max=15) for q in _th_fake_rounding(
            enc, quant, targets, num_line[:, None, None])]
    unq = [(q << 4) | q for q in quant]
    mod = enc.const(TH_MODIFIERS)[None, :, None]
    lines = [[torch.clamp(u + mod, max=255) for u in unq], unq,
             [torch.clamp(u - mod, min=0) for u in unq]]

    error = None
    selectors = torch.zeros((n, 8, TH_STEPS), dtype=I64, device=enc.device)
    for i in range(16):
        pix, pw = enc.px(i, (8, TH_STEPS))
        px_err = iso_err[i][:, None, None].expand(n, 8, TH_STEPS)
        px_sel = torch.zeros((n, 8, TH_STEPS), dtype=I64, device=enc.device)
        for s in range(3):
            e = enc.error(lines[s], pix, pw, fake=False)
            px_sel = torch.where(e < px_err, s + 1, px_sel)
            px_err = torch.minimum(e, px_err)
        error = px_err if error is None else error + px_err
        selectors = selectors | (px_sel << (2 * i))

    err, win = first_min(error.reshape(n, -1))
    table = (win // TH_STEPS).to(I64)
    line = [pick(q.reshape(n, -1), win).to(I64) for q in quant]
    hi, lo = _emit_t(line, [q.to(I64) for q in iso_q],
                     pick(selectors.reshape(n, -1), win), table)
    best.update(err, rank, hi, lo)


def _hmode(enc: _Encoding, best: _Best, rank: int, grouping):
    """EncodeHMode (ETC.cpp:649-886): two colours, each +-modifier, for the
    two groups of pixels; every (table, colour 1, colour 0) pair is tried,
    each pixel taking the nearest of the four."""
    n = enc.n
    g1 = torch.stack(grouping, 1)                               # [N,16]
    count1 = g1.to(I32).sum(1)
    counts = (16 - count1, count1)
    sum1 = [torch.where(g1, enc.pix[..., c], 0).sum(1) for c in range(3)]
    sums = ([enc.pix[..., c].sum(1) - sum1[c] for c in range(3)], sum1)

    colors = []                                                 # [N,8,33]
    for s in range(2):
        mods = _premultipliers(enc, counts[s])
        q = [torch.clamp(floor_div(
            ((2 * sums[s][c] + 17 * counts[s])[:, None, None] + mods)
            .clamp(min=0), (34 * counts[s])[:, None, None]), max=15)
            for c in range(3)]
        colors.append((q[0] << 10) | (q[1] << 5) | q[2])

    mod = enc.const(TH_MODIFIERS)[None, :, None, None]
    errs = []                                                   # [N,8,33,16]
    for s in range(2):
        unq = [((colors[s] >> (10 - 5 * c)) & 15)[..., None] for c in range(3)]
        unq = [(u << 4) | u for u in unq]
        pix = [enc.pix[:, None, None, :, c] for c in range(3)]
        pw = [enc.pw[:, None, None, :, c] for c in range(3)]
        plus = enc.error([torch.clamp(u + mod, max=255) for u in unq], pix, pw)
        minus = enc.error([torch.clamp(u - mod, min=0) for u in unq], pix, pw)
        errs.append(torch.minimum(plus, minus))

    # each table's candidates in order, a repeat of the previous colour
    # not counted: the reference visits distinct colours only
    def distinct_rank(col):
        prev = torch.cat([torch.full_like(col[..., :1], -1), col[..., :-1]],
                         -1)
        return torch.cumsum((col != prev).to(I32), -1) - 1
    u0, u1 = distinct_rank(colors[0]), distinct_rank(colors[1])
    # the reference's pair walk steps its first index before the first
    # visit, so the pair of both first colours is tried only when the
    # second group has a single colour
    many1 = u1.amax(-1) >= 1                                    # [N,8]

    total = None                                    # [N, 8, 33 (i1), 33 (i0)]
    for i in range(16):
        t = torch.minimum(errs[1][:, :, :, None, i], errs[0][:, :, None, :, i])
        total = t if total is None else total + t
    skip = (u1[:, :, :, None] == 0) & (u0[:, :, None, :] == 0) \
        & many1[:, :, None, None]
    total = torch.where(skip, INF, total)
    err, win = first_min(total.reshape(n, -1))
    table = win // (TH_STEPS * TH_STEPS)
    i1 = (win // TH_STEPS) % TH_STEPS
    i0 = win % TH_STEPS
    c0 = pick(colors[0].reshape(n, -1), table * TH_STEPS + i0)
    c1 = pick(colors[1].reshape(n, -1), table * TH_STEPS + i1)

    # the winner's pixel choices: the nearer colour, then the nearer sign
    modifier = enc.const(TH_MODIFIERS)[table][:, None]
    pix = [enc.pix[..., c] for c in range(3)]
    pw = [enc.pw[..., c] for c in range(3)]

    def choices(color):
        unq = [((color >> (10 - 5 * c)) & 15)[:, None] for c in range(3)]
        unq = [(u << 4) | u for u in unq]
        plus = enc.error([torch.clamp(u + modifier, max=255) for u in unq],
                         pix, pw)
        minus = enc.error([torch.clamp(u - modifier, min=0) for u in unq],
                          pix, pw)
        return torch.minimum(plus, minus), minus < plus
    e0, neg0 = choices(c0)
    e1, neg1 = choices(c1)
    second = e1 < e0
    bit = (1 << torch.arange(16, device=enc.device, dtype=I64))[None, :]
    sector_bits = torch.where(second, bit, 0).sum(1)
    sign_bits = torch.where(torch.where(second, neg1, neg0), bit, 0).sum(1)
    hi, lo = _emit_h([c0.to(I64), c1.to(I64)], sector_bits, sign_bits,
                     table.to(I64))
    best.update(err, rank, hi, lo, valid=torch.isfinite(err))


# --- ETC1 differential (ETC.cpp:2624-2882, 219-362) --------------------------

def _etc1_fake_rounding(enc, cu):
    """ResolveHalfBlockFakeBT709Rounding{Accurate,Fast} (ETC.cpp:2157-2285)
    for the 5-bit differential colours."""
    if enc.accurate:
        quant = [((c << 5) - c + (c >> 3)) >> 11 for c in cu]
        low, high = [], []
        for q in quant:
            qn = torch.clamp(q + 1, max=31)
            low.append((((q << 3) | (q >> 2)) << 3).float())
            high.append((((qn << 3) | (qn >> 2)) << 3).float())
        want = to_yuv([c.float() for c in cu])
        best_err = best_oct = None
        for octant in range(8):
            got = to_yuv([high[c] if octant >> c & 1 else low[c]
                          for c in range(3)])
            d = [got[c] - want[c] for c in range(3)]
            # the reference's d1 + d1
            err = d[0] * d[0] + d[1] + d[1] + d[2] * d[2]
            if best_err is None:
                best_err, best_oct = err, torch.zeros_like(quant[0])
            else:
                best_oct = torch.where(err < best_err, octant, best_oct)
                best_err = torch.minimum(err, best_err)
        return [quant[c] + ((best_oct >> c) & 1) for c in range(3)]
    fill = [c + (c >> 8) for c in cu]
    key = ((fill[0] << 6) & 0xF00) | ((fill[1] << 4) & 0x0F0) \
        | ((fill[2] >> 2) & 0x00F)
    octant = enc.const(fake_bt709_octants())[key]
    return [torch.clamp((fill[c] >> 6) + ((octant >> c) & 1), max=31)
            for c in range(3)]


def _half_block(enc, packed, sector):
    """TestHalfBlock (ETC.cpp:94-149) of the differential candidates
    packed [N, 8, 81] (r | g<<5 | b<<10) on one sector's 8 pixels: the
    summed error and each pixel's modifier, 2 bits a pixel."""
    n = enc.n
    unq = [(packed >> (5 * c)) & 31 for c in range(3)]
    unq = [((q << 3) | (q >> 2))[:, None] for q in unq]         # [N,1,8,81]
    mods = enc.const(ETC1_MODIFIERS).T[None, :, :, None]        # [1,4,8,1]
    modified = [torch.clamp(u + mods, 0, 255) for u in unq]     # [N,4,8,81]
    total = None
    selectors = torch.zeros(packed.shape, dtype=I64, device=enc.device)
    for k, i in enumerate(sector):
        pix, pw = enc.px(i, (4, 8, OFFSETS))
        err, sel = first_min(enc.error(modified, pix, pw), 1)
        total = err if total is None else total + err
        selectors = selectors | (sel.to(I64) << (2 * k))
    return total.reshape(n, -1), selectors.reshape(n, -1)


def _sector_candidates(enc, sector):
    """One sector's differential candidates in the reference's visiting
    order (table, then offset), each [N, 648]: error, colour, selectors,
    table, and the distinct-colour rank."""
    n = enc.n
    cum = [enc.pix[:, list(sector), c].sum(1) for c in range(3)]
    offs = enc.const(etc1_offsets())[None]                      # [1,8,81]
    cu = [torch.clamp(c[:, None, None] + offs, 0, 2040) for c in cum]
    if enc.fake:
        quant = _etc1_fake_rounding(enc, cu)
    else:
        quant = [((c << 5) - c + (c >> 3) + 1024) >> 11 for c in cu]
    packed = quant[0] | (quant[1] << 5) | (quant[2] << 10)
    error, selectors = _half_block(enc, packed, sector)
    prev = torch.cat([torch.full_like(packed[..., :1], -1),
                      packed[..., :-1]], -1)
    rank = torch.cumsum((packed != prev).to(I32).reshape(n, -1), -1) - 1
    table = enc.const(np.repeat(np.arange(8), OFFSETS))[None].expand(n, -1)
    return dict(error=error, color=packed.reshape(n, -1), sel=selectors,
                table=table, rank=rank)


def _legal_pairs(c0, c1):
    """Whether colour c1 [.., A] can follow c0 [.., 1] differentially:
    each 5-bit channel moves by -4..3."""
    ok = None
    for ch in range(3):
        d = ((c1 >> (5 * ch)) & 31) - ((c0 >> (5 * ch)) & 31)
        o = (d >= -4) & (d <= 3)
        ok = o if ok is None else ok & o
    return ok


def _differential_pair(s0, s1, best_in):
    """FindBestDifferentialCombination (ETC.cpp:219-362) on dense
    candidates: the pair (i of sector 0, j of sector 1) the reference's
    scan commits, and its total error.

    The scan visits sector 0's candidates by (error, distinct rank) and
    takes for each its best legal partner, the least (error, rank) of
    sector 1; a later candidate replaces the winner when its partner's
    error is below the running best less its own error, in float32, so an
    equal total reached later can win. Before scanning, the pair of both
    sectors' best candidates is taken outright when it is legal and its
    total is below the stage's best so far (`best_in`)."""
    e0, e1, u0, u1 = s0["error"], s1["error"], s0["rank"], s1["rank"]
    c0, c1 = s0["color"], s1["color"]
    n, a = e0.shape
    idx = torch.arange(a, device=e0.device)[None, :]
    big = 2**30

    mine1 = torch.cat([torch.where(
        _legal_pairs(c0[:, r:r + OFFSETS, None], c1[:, None, :]),
        e1[:, None, :], INF).amin(2) for r in range(0, a, OFFSETS)], 1)
    total = e0 + mine1

    def least(mask, keys, largest=False):
        """The index of the least (largest) of `keys`, lexicographic, among
        the candidates in `mask`; -1 where there is none."""
        for k in keys:
            if largest:
                top = torch.where(mask, k, -INF if k.is_floating_point()
                                  else -1).amax(1, keepdim=True)
            else:
                top = torch.where(mask, k, INF if k.is_floating_point()
                                  else big).amin(1, keepdim=True)
            mask = mask & (k == top)
        chosen = torch.where(mask, idx, -1 if largest else big)
        out = chosen.amax(1) if largest else chosen.amin(1)
        return torch.where(mask.any(1), out, -1)

    tmin = total.amin(1, keepdim=True)
    first = least(total == tmin, (e0, u0, idx))
    first = torch.where(first < 0, a - 1, first)
    later = least(mine1 < (tmin - e0), (e0, u0, idx), largest=True)
    win = torch.where(later >= 0, later, first)

    all_rows = torch.ones_like(e0, dtype=torch.bool)
    b0 = least(all_rows, (e0, u0, idx))
    b1 = least(all_rows, (e1, u1, idx))
    fast = _legal_pairs(pick(c0, b0)[:, None], pick(c1, b1)[:, None])[:, 0] \
        & ((pick(e0, b0) + pick(e1, b1)) < best_in)
    win = torch.where(fast, b0, win)

    win_total = pick(total, win)
    valid = torch.isfinite(win_total)
    partner_ok = _legal_pairs(pick(c0, win)[:, None], c1) \
        & (e1 == pick(mine1, win)[:, None])
    partner = least(partner_ok, (u1, idx))
    partner = torch.where(valid & (partner >= 0), partner, 0)
    return win, partner, win_total, valid


def _etc1_differential(enc: _Encoding, best: _Best, rank_base: int):
    """The differential half of CompressETC1BlockInternal (the ETC2 encoder
    starts its ETC1 search at d = 1), for each flip."""
    codes = enc.const(MODIFIER_CODES, I64)
    for flip in range(2):
        sides = [_sector_candidates(enc, FLIP[flip][s]) for s in range(2)]
        i, j, total, valid = _differential_pair(sides[0], sides[1],
                                                best.error)
        got = [{k: torch.where(valid, pick(v, w), 0).to(I64)
                for k, v in side.items() if k != "rank"}
               for side, w in zip(sides, (i, j))]
        c = [[(g["color"] >> (5 * ch)) & 31 for ch in range(3)] for g in got]
        hi = (got[0]["table"] << 5) | (got[1]["table"] << 2) | (1 << 1) | flip
        for ch, sh in enumerate((27, 19, 11)):
            hi = hi | (c[0][ch] << sh) | (((c[1][ch] - c[0][ch]) & 7)
                                          << (sh - 3))
        code = [None] * 16
        for s in range(2):
            for k, px in enumerate(FLIP[flip][s]):
                code[px] = codes[(got[s]["sel"] >> (2 * k)) & 3]
        lo = torch.zeros_like(hi)
        for k in range(16):
            lo = lo | ((code[ORDER[k]] & 1) << k) \
                | (((code[ORDER[k]] >> 1) & 1) << (16 + k))
        best.update(total, rank_base + 2 * flip + 1, hi, lo)


# --- the two encoders --------------------------------------------------------

def encode_etc2(blocks: torch.Tensor, options: Options) -> torch.Tensor:
    """CompressETC2Block without punch-through (ETC.cpp:1664-1887): uint8
    [N, 16, 4] -> uint8 [N, 8]. The stages in the reference's order, a
    later one winning only with a lower error: planar, T on the chroma
    split and on its complement, H on the complement, ETC1 differential."""
    enc = _Encoding(blocks, options)
    best = _Best(enc)
    _planar(enc, best, 0)
    sides = _split(enc)
    flipped = [~s for s in sides]
    _tmode(enc, best, 1, sides)
    _tmode(enc, best, 2, flipped)
    _hmode(enc, best, 3, flipped)
    _etc1_differential(enc, best, 4)
    return best.to_bytes()


def encode_etc2_alpha(blocks: torch.Tensor) -> torch.Tensor:
    """CompressETC2AlphaBlock (ETC.cpp:1889-2085): the EAC block of each
    block's alpha, uint8 [N, 16, 4] -> uint8 [N, 8]. Every candidate of 16
    tables x 10 ranges x 2 multipliers is tried, the first of the least
    squared error kept."""
    dev = blocks.device
    a = blocks[:, :, 3].to(I32)                                 # [N,16]
    lo_a, hi_a = a.amin(1), a.amax(1)
    span, mid2 = (hi_a - lo_a)[:, None], (hi_a + lo_a)[:, None]

    cand = [(t, r, m) for t in range(16) for r in range(10) for m in range(2)]
    table = np.array([t for t, _, _ in cand], dtype=np.int32)
    max_off = np.array([ALPHA_MODIFIERS[t][3 - r // 3 - (r % 3 & 1)]
                        for t, r, _ in cand], dtype=np.int32)
    min_off = np.array([-ALPHA_MODIFIERS[t][3 - r // 3 - (r % 3 >> 1 & 1)] - 1
                        for t, r, _ in cand], dtype=np.int32)
    second = np.array([m == 1 for _, _, m in cand])
    c = len(cand)

    def const(x):
        return torch.as_tensor(x, device=dev)[None, :]

    mult = torch.clamp(span // const(max_off - min_off), 1, 14)
    mult = torch.where(const(second), mult + 1, mult)
    base = (torch.clamp(mid2 - mult * const(max_off) - mult * const(min_off),
                        0, 510) + 1) >> 1
    rounding = torch.as_tensor(alpha_rounding()[table].ravel(), device=dev)
    positive = torch.as_tensor(np.array(ALPHA_MODIFIERS, dtype=np.int32)
                               [table].ravel(), device=dev)
    rows = torch.arange(c, device=dev)[None, :]

    total = torch.zeros((a.shape[0], c), dtype=I32, device=dev)
    indexes = []
    for i in range(16):
        v = a[:, i:i + 1]
        reflect2 = 2 * (v - base) + mult
        lookup = torch.clamp((reflect2.abs() >> 1) // mult.clamp(min=1),
                             max=ALPHA_ROUNDERS - 1)
        pos = torch.take(rounding, rows * ALPHA_ROUNDERS + lookup)
        sign = reflect2 >> 31                                   # 0 or -1
        q = torch.clamp(base + (torch.take(positive, rows * 4 + pos) ^ sign)
                        * mult, 0, 255)
        total = total + (q - v) * (q - v)
        indexes.append(pos + 4 - (sign & 4))
    _, win = first_min(total)
    t = torch.as_tensor(table, device=dev)[win].to(I64)
    stream = torch.zeros_like(t)
    for i in range(16):
        stream = stream | (pick(indexes[i], win).to(I64)
                           << (45 - 3 * ORDER[i]))
    cols = [pick(base, win).to(I64) & 0xFF, (pick(mult, win).to(I64) << 4) | t]
    cols += [(stream >> s) & 0xFF for s in (40, 32, 24, 16, 8, 0)]
    return torch.stack(cols, -1).to(torch.uint8)


def encode_etc2_rgba(blocks: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """Kernels::EncodeETC2RGBA (API.cpp:270-286) with default Options: the
    EAC alpha block then the ETC2 colour block of each uint8 [N, 16, 4]
    block, uint8 [N, 16] on the blocks' device, `chunk` blocks at a time
    (blocks are independent)."""
    options = Options()
    outs = [torch.cat([encode_etc2_alpha(b), encode_etc2(b, options)], -1)
            for b in (blocks[i:i + chunk]
                      for i in range(0, blocks.shape[0], chunk))]
    return torch.cat(outs) if outs else torch.zeros(
        (0, 16), dtype=torch.uint8, device=blocks.device)
