"""The port's BC7 slice end to end on the CPU: encode_bc7 against the JAX
package's bytes, decode_bc7 against the JAX decoder, the configuration
converters, and the package's independence from JAX.

The JAX bytes come from convectionkernels_tpu_torch/testdata (made by the
JAX package; tests/test_torch_goldens.py re-derives them under the `slow`
marker). Tolerance 0: bytes are compared as bytes.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import convectionkernels_tpu as ck
import convectionkernels_tpu_torch as ckt
from convectionkernels_tpu.bc7_plan import plan_from_quality as jax_plan
from convectionkernels_tpu_torch import api, convert
from convectionkernels_tpu_torch.models import bc7_kernel
from tests import blockgen
from tests.test_torch_goldens import (LIGHT, LIGHT_CASES, load_light,
                                      load_q50)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_blocks_equal(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    bad = np.nonzero((got != want).any(axis=1))[0]
    assert bad.size == 0, (f"{bad.size} of {len(want)} blocks differ, first "
                           f"{bad[0]}: {got[bad[0]].tolist()} != "
                           f"{want[bad[0]].tolist()}")


def port_light(px, flags):
    """encode_bc7 on the CPU with the JAX package's Options and plan passed
    through convert."""
    options = convert.options_from_reference(ck.Options(flags=flags, **LIGHT))
    plan = convert.plan_from_reference(jax_plan(5))
    return ckt.encode_bc7(px, options, plan=plan, device="cpu")


@pytest.mark.parametrize("case", LIGHT_CASES, ids=[c[0] for c in LIGHT_CASES])
def test_encode_light_matches_jax(case):
    """quality 5 with Options(**LIGHT): RGB and alpha corpora at default
    flags, slow indexing, single color and punch-through."""
    bc7_kernel.LAUNCHES.clear()
    px, blocks, flags = load_light(case[0])
    got = port_light(px, flags)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert_blocks_equal(got, blocks)
    assert sum(bc7_kernel.LAUNCHES.values()) == 0   # plain versions only


@pytest.mark.slow
def test_encode_light_matches_live_jax():
    """The alpha corpus against ck.encode_bc7 run now (a cold compile of
    the JAX program takes about 100 s on a CPU)."""
    px, _, flags = load_light("alpha")
    want = np.asarray(ck.encode_bc7(px, ck.Options(flags=flags, **LIGHT),
                                    quality=5))
    assert_blocks_equal(port_light(px, flags), want)


def test_encode_q50_golden_first_32():
    """quality 50, default Options: the main path's configuration."""
    px, blocks, _ = load_q50()
    assert_blocks_equal(ckt.encode_bc7(px[:32], quality=50, device="cpu"),
                        blocks[:32])


def test_q50_golden_block62_refine_is_ieee():
    """Block 62 is where the JAX package's jitted encode (api_blocks)
    departs from its op-by-op run (blocks). A float32 scalar emulation of
    the deciding candidate (mode 6, shape 0, parity 1, tweak 1) from the
    port's PCA line puts the round-0 refine of blue endpoint 0 at
    200.50002, which rounds to 201: the op-by-op bytes, which the port
    gives."""
    px, blocks, api_blocks = load_q50()
    assert np.nonzero((blocks != api_blocks).any(axis=1))[0].tolist() == [62]
    f = np.float32
    p = px[62].astype(np.int64)
    cw = [f(w) for w in ckt.Options().channel_weights()]
    pix = torch.as_tensor(p.reshape(1, 64).astype(np.int32))
    base, offset, _ = bc7_kernel.shape_pca(
        pix, torch.tensor([0xFFFF], dtype=torch.int32), 4, cw, False, False)
    f1 = f(1) / f(14) + f(1)            # tweak 1 of 16 indexes: f0 is -0.0
    line = [(f(base[0, 0, c].item()), f(offset[0, 0, c].item()))
            for c in range(4)]
    ep = [[int(np.floor(max(min(f(b + f(o * fac)), f(255)), f(0)) + f(0.5)))
           for b, o in line] for fac in (-f(0) / f(14), f1)]
    # mode 6 QuantizeP (7 bits) with parities (1, 0)
    comp = [[(((((c << 8) - c + (1 if par else 255)) >> 9) << 1) | par)
             for c in ep[j]] for j, par in ((0, 1), (1, 0))]
    origin = [f(c) for c in comp[0]]
    edw = [f(f(f(comp[1][c]) - origin[c]) * cw[c]) for c in range(4)]
    len_sq = f(edw[0] * edw[0])
    for c in range(1, 4):
        len_sq = f(len_sq + f(edw[c] * edw[c]))
    mv_div = f(f(15) / len_sq)
    axis = [f(f(edw[c] * cw[c]) * mv_div) for c in range(4)]
    rcp_max = f(f(1) / f(15))
    tv, v, tt, ts = f(0), f(0), f(0), f(0)
    for i in range(16):
        fp = [f(p[i, c]) for c in range(4)]
        dist = f(f(fp[0] - origin[0]) * axis[0])
        for c in range(1, 4):
            dist = f(dist + f(f(fp[c] - origin[c]) * axis[c]))
        t = f(f(np.floor(max(min(dist, f(15)), f(0)) + f(0.5))) * rcp_max)
        pw = f(fp[2] * cw[2])
        tv, v = f(tv + f(t * pw)), f(v + pw)
        tt, ts = f(tt + f(t * t)), f(ts + t)
    w_rcp = f(f(1) / f(16))
    adenom = f(f(f(tt * f(16)) - f(ts * ts)) * w_rcp)
    a = f(f(tv - f(f(ts * v) * w_rcp)) / adenom)
    b = f(f(v - f(a * ts)) * w_rcp)
    p1 = f(b * f(f(1) / cw[2]))
    assert p1 == f(200.50002)
    assert int(np.floor(p1 + f(0.5))) == 201
    # the port's block 62 is the op-by-op bytes
    got = ckt.encode_bc7(px[62:63], quality=50, device="cpu").numpy()
    assert_blocks_equal(got, blocks[62:63])


def jax_reads(px):
    """The [N, 16, 4] uint8 channels the JAX package's encode_bc7 reads from
    `px`: its entry point's cast and check, then its static channel index
    (models/bc7.py:1210-1213), which clamps to the last channel."""
    from convectionkernels_tpu import api as jax_api
    arr = jax_api._as_block_array(px)
    return np.stack([np.asarray(arr[:, :, ch]) for ch in range(4)], -1)


def test_encode_takes_what_jax_takes():
    """Inputs JAX's encode_bc7 reads as the golden's pixels (int32 values
    that wrap, floats that truncate, a list, a tensor, a fifth channel)
    give the golden's bytes; [N, 16, 1] and [N, 16, 3] give the bytes of
    the channels JAX reads from them (held against JAX run op by op under
    `-m slow`). A wrong rank or a second axis other than 16 is refused."""
    px, blocks, flags = load_light("alpha")
    px, blocks = px[:6], blocks[:6]
    wide = px.astype(np.int32) + 256 * np.random.default_rng(7).integers(
        -2, 3, px.shape)
    for form in (wide, px.astype(np.float64) + 0.25, px.tolist(),
                 torch.as_tensor(px), np.concatenate([px, px[:, :, :1]], 2)):
        np.testing.assert_array_equal(
            jax_reads(form.numpy() if torch.is_tensor(form) else form), px)
        assert_blocks_equal(port_light(form, flags), blocks)
    for c in (1, 3):
        assert_blocks_equal(port_light(px[:, :, :c], flags),
                            port_light(jax_reads(px[:, :, :c]), flags).numpy())
    for bad in (px[:, :, 0], px[:, :8], px[:, :, :0]):
        with pytest.raises(ValueError):
            port_light(bad, flags)


@pytest.mark.slow
def test_encode_fewer_channels_matches_jax_op_by_op():
    """[N, 16, 1] and [N, 16, 3] against the JAX package's pack run op by op
    on what its entry point reads from them (about 90 s on a CPU)."""
    import jax

    from convectionkernels_tpu.models import bc7 as jax_bc7
    px, _, flags = load_light("alpha")
    forms = (px[:2, :, :1], px[2:4, :, :3])
    o = ck.Options(flags=flags, **LIGHT)
    with jax.disable_jit():
        want = np.asarray(jax_bc7.pack(
            np.concatenate([jax_reads(f) for f in forms]), o.flags,
            o.channel_weights(), jax_plan(5), o.refine_rounds_bc7))
    got = torch.cat([port_light(f, flags) for f in forms])
    assert_blocks_equal(got, want)


def test_encode_chunking_is_exact(monkeypatch):
    px, blocks, flags = load_light("alpha")
    monkeypatch.setattr(api, "CHUNK_BC7", 5)
    assert_blocks_equal(port_light(px, flags), blocks)


def test_decode_matches_jax():
    px, blocks, _ = load_q50()
    rng = np.random.default_rng(17)
    noise = rng.integers(0, 256, (512, 16), dtype=np.uint8)
    for m in range(9):   # every mode byte, plus the reserved all-zero one
        noise[m * 56:(m + 1) * 56, 0] = (1 << m) & 0xFF
    for data in (blocks, noise):
        got = ckt.decode_bc7(data, device="cpu")
        assert got.dtype == torch.uint8 and got.shape == (len(data), 16, 4)
        np.testing.assert_array_equal(got.numpy(), ck.decode_bc7(data))


@pytest.mark.parametrize("quality", [1, 5, 37, 50, 100])
def test_convert_plan_and_options(quality):
    assert convert.plan_from_reference(jax_plan(quality)) == \
        ckt.plan_from_quality(quality)
    ref = ck.Options(flags=ck.Flags.DEFAULT | ck.Flags.UNIFORM, seed_points=2,
                     refine_rounds_bc7=3)
    port = convert.options_from_reference(ref)
    assert port == ckt.Options(flags=ref.flags, seed_points=2,
                               refine_rounds_bc7=3)
    assert port.channel_weights() == ref.channel_weights()
    assert ckt.Options().channel_weights() == ck.Options().channel_weights()


def test_tables_and_plans_match_jax():
    """The port's own copies of the BC7 tables, the priority lists, the
    single-color tables and every quality's plan."""
    from convectionkernels_tpu.bc7_plan import \
        plan_from_fine_tuning_params as jax_fine
    from convectionkernels_tpu.tables import bc7_geometry as jax_geom
    from convectionkernels_tpu.tables import bc7_prio_data as jax_prio
    from convectionkernels_tpu.tables import bc7_single_color as jax_sc
    from convectionkernels_tpu_torch.tables import bc7_geometry as geom
    from convectionkernels_tpu_torch.tables import bc7_prio_data as prio
    from convectionkernels_tpu_torch.tables import bc7_single_color as sc
    for name in ("PARTITION_MAP_2", "PARTITION_MAP_3", "FIXUP_INDEXES_2",
                 "FIXUP_INDEXES_3", "SHAPES_2", "SHAPES_3", "SHAPE_LIST_1",
                 "SHAPE_LIST_2", "SHAPE_LIST_3", "SHAPE_LIST_3_SHORT"):
        np.testing.assert_array_equal(getattr(geom, name),
                                      getattr(jax_geom, name), name)
    np.testing.assert_array_equal(geom.shape_masks(), jax_geom.shape_masks())
    assert prio.PRIO_RGB == jax_prio.PRIO_RGB
    assert prio.PRIO_RGBA == jax_prio.PRIO_RGBA
    for mode in (0, 1, 2, 3, 6, 7):
        for (i, p, t), (ji, jp, jt) in zip(sc.mode_tables(mode),
                                           jax_sc.mode_tables(mode)):
            assert (i, p) == (ji, jp)
            np.testing.assert_array_equal(t, jt)
    for quality in range(1, 101):
        assert convert.plan_from_reference(jax_plan(quality)) == \
            ckt.plan_from_quality(quality), quality
    params = ckt.BC7FineTuningParams(mode6_sp=0, mode5_sp=(1, 0, 2, 0))
    ref = ck.BC7FineTuningParams(mode6_sp=0, mode5_sp=(1, 0, 2, 0))
    assert convert.plan_from_reference(jax_fine(ref)) == \
        ckt.plan_from_fine_tuning_params(params)


_NO_JAX = r"""
import contextlib
import io
import sys
sys.modules["jax"] = None          # any import of jax now raises
import torch
import convectionkernels_tpu_torch as ckt
from convectionkernels_tpu_torch import (api, cli, convert, cuda_lib,
                                         exact_probe)
from convectionkernels_tpu_torch.parallel import distributed, sharding
from convectionkernels_tpu_torch.utils import (containers, image, metrics,
                                               native)
from convectionkernels_tpu_torch.models import (bc7, bc7_kernel, decode, etc,
                                                s3tc)
from convectionkernels_tpu_torch.tables import etc_tables, s3tc_single_color
loaded = [m for m in sys.modules
          if m == "convectionkernels_tpu" or m.startswith("convectionkernels_tpu.")]
assert not loaded, loaded
px = torch.zeros((2, 16, 4), dtype=torch.uint8)
if not torch.cuda.is_available():
    for call in (lambda: ckt.encode_bc7(px, quality=5),
                 lambda: ckt.encode_bc1(px),
                 lambda: ckt.encode_bc5s(px.to(torch.int8)),
                 lambda: ckt.encode_etc1(px),
                 lambda: ckt.encode_etc2_punchthrough(px),
                 lambda: ckt.encode_eac11(px[:, :, 0].to(torch.int16)),
                 lambda: ckt.decode_bc7(torch.zeros((2, 16), dtype=torch.uint8))):
        try:
            call()
        except RuntimeError as e:
            assert "device='cpu'" in str(e), e
        else:
            raise AssertionError("an entry point ran without a card")
out = ckt.encode_bc7(px, ckt.Options(refine_rounds_bc7=1, seed_points=1),
                     quality=1, device="cpu")
assert out.shape == (2, 16) and out.dtype == torch.uint8
assert ckt.decode_bc7(out, device="cpu").shape == (2, 16, 4)
assert ckt.encode_bc1(px, device="cpu").shape == (2, 8)
assert ckt.encode_etc1(px, device="cpu").shape == (2, 8)
assert ckt.encode_etc2_alpha(px, device="cpu").shape == (2, 8)
assert ckt.encode_etc2(px, device="cpu").shape == (2, 8)
assert ckt.encode_etc2_rgba(px, device="cpu").shape == (2, 16)
px[0, :3, 3] = 255
assert ckt.encode_etc2_punchthrough(px, device="cpu").shape == (2, 8)
values = px[:, :, 0].to(torch.int16)
assert ckt.encode_eac11(values, device="cpu").shape == (2, 8)
assert len(s3tc_single_color.load_tables()) == 8
img = px.reshape(8, 4, 4).numpy()
blocks = image.blockify(img)
assert blocks.shape == (2, 16, 4)
assert sharding.encode_sharded(ckt.encode_bc1, blocks, ["cpu"] * 2).shape \
    == (2, 8)
assert distributed.encode_image_distributed(
    ckt.encode_bc1, img, device="cpu", assemble=True).shape == (2, 8)
assert metrics.psnr(blocks, blocks) == float("inf")
assert "bc7" in containers.DXGI_FORMATS and native.available() in (True, False)
with contextlib.redirect_stdout(io.StringIO()) as usage:
    assert cli.main([]) == 1
assert usage.getvalue().startswith("Command-line encoder")
loaded = [m for m in sys.modules
          if m == "convectionkernels_tpu" or m.startswith("convectionkernels_tpu.")]
assert not loaded, loaded
print("ok")
"""


def test_port_imports_without_jax():
    """The package imports and runs with jax unimportable, loads nothing of
    the JAX package, and its entry points refuse to run without a card
    unless the CPU is asked for; so do the CLI, the utils and the split."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_imports_in_port_sources():
    """No source of the port, and not chip_smoke.py, names jax or the JAX
    package in an import."""
    import ast
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO,
                                               "convectionkernels_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "convectionkernels_tpu"), \
                    (path, name)


def test_mixed_corpus_smoke():
    """A mixed batch round-trips through encode and decode on the CPU with
    every block's mode byte valid."""
    px = blockgen.mixed_blocks(32, seed=301)
    out = ckt.encode_bc7(px, ckt.Options(**LIGHT), quality=5, device="cpu")
    assert (out[:, 0] != 0).all()
    dec = ckt.decode_bc7(out, device="cpu").numpy().astype(np.int64)
    assert np.abs(dec - px.astype(np.int64)).mean() < 16
