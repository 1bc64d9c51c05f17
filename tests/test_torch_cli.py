"""The port's command-line encoder against the JAX package's, on the CPU.

The port's CLI runs with device="cpu". Its files are held against:
- files the JAX package's container writers make from the stored goldens'
  op-by-op bytes, for an image whose blocks are a golden case's blocks
  (no JAX encode needed);
- the JAX CLI itself, run end to end on a seeded 20x16 image: -f etc1
  -mips by default, every format under `-m slow`;
and its input transforms against the JAX CLI's on every u8 value.
Every comparison is of bytes: the tolerance is 0.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from convectionkernels_tpu import cli as jax_cli
from convectionkernels_tpu.utils import containers as jax_containers
from convectionkernels_tpu.utils import image as jax_image
from convectionkernels_tpu_torch import api, cli
from convectionkernels_tpu_torch.options import Options
from convectionkernels_tpu_torch.utils import image
from tests.test_torch_goldens import load_etc, load_q50, load_s3tc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: the test workers share the
    machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def read(path):
    with open(path, "rb") as f:
        return f.read()


def golden_image(pixels, blocks_wide):
    """The image whose raster blocks are `pixels`, blocks_wide blocks a
    row."""
    h = len(pixels) // blocks_wide * 4
    return image.unblockify(pixels, h, blocks_wide * 4)


# (name, CLI flags, output suffix, container format, loader of (pixels,
# op-by-op bytes), blocks a row)
GOLDEN_CLI = (
    ("bc7_q50", ["-f", "bc7", "-q", "50"], ".dds", "bc7",
     lambda: load_q50()[:2], 16),
    ("bc1_default", ["-f", "bc1"], ".dds", "bc1",
     lambda: load_s3tc("bc1_default")[:2], 8),
    ("etc2_default", ["-f", "etc2"], ".ktx", "etc2",
     lambda: (load_etc("etc2_default")[0], load_etc("etc2_default")[2]), 8),
)


@pytest.mark.parametrize("case", GOLDEN_CLI, ids=[c[0] for c in GOLDEN_CLI])
def test_cli_file_matches_jax_golden(case, tmp_path, capsys):
    """The port's CLI on the image made of a golden case's blocks writes the
    file the JAX package's writers make from the golden's bytes."""
    _, flags, suffix, container_fmt, load, blocks_wide = case
    pixels, blocks = load()
    img = golden_image(pixels, blocks_wide)
    np.testing.assert_array_equal(jax_image.blockify(img), pixels)
    src = str(tmp_path / "in.npy")
    np.save(src, img)
    out, want = str(tmp_path / f"port{suffix}"), str(tmp_path / f"jax{suffix}")
    assert cli.main(flags + [src, out], device="cpu") == 0
    h, w = img.shape[:2]
    write = (jax_containers.write_dds if suffix == ".dds"
             else jax_containers.write_ktx)
    write(want, blocks, w, h, fmt=container_fmt)
    assert read(out) == read(want)
    assert f"1 level(s), {blocks.nbytes} bytes" in capsys.readouterr().out


def seeded_image(seed=71, h=20, w=16):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 4),
                                                dtype=np.uint8)


def run_both(tmp_path, flags, suffix):
    """(port file, JAX file) of both CLIs on the seeded 20x16 image."""
    src = str(tmp_path / "in.npy")
    np.save(src, seeded_image())
    out, ref = str(tmp_path / f"port{suffix}"), str(tmp_path / f"jax{suffix}")
    assert cli.main(flags + [src, out], device="cpu") == 0
    assert jax_cli.main(flags + [src, ref]) == 0
    return read(out), read(ref)


def test_cli_matches_jax_cli_etc1_mips(tmp_path):
    """Both CLIs end to end: ETC1 with a mip chain (5 levels)."""
    got, want = run_both(tmp_path, ["-f", "etc1", "-mips"], ".ktx")
    assert got == want


# Formats whose JAX encoder XLA:CPU cannot compile here (S3TC's default
# interpolated-alpha rounds, ROADMAP C.2) or whose jitted program departs
# from the op-by-op one on some blocks (BC7 q50 and BC6H, ROADMAP C.3 and
# C.4): for these the slow test holds the port to the JAX CLI's encoder run
# op by op, written by the JAX writers, and not to the JAX CLI's file.
CLI_OP_BY_OP = ("bc3", "bc4", "bc4s", "bc5", "bc5s", "bc6h", "bc6hs", "bc7")
CLI_FORMATS = ("bc1", "bc2", "bc3", "bc4", "bc4s", "bc5", "bc5s", "bc6h",
               "bc6hs", "bc7", "etc1", "etc2", "etc2rgba", "etc2pt",
               "eac_r11", "eac_r11s", "eac_rg11", "eac_rg11s")


def jax_cli_op_by_op(tmp_path, flags, fmt, suffix):
    """The JAX CLI's file for `flags`, its encoder run op by op."""
    import jax

    from convectionkernels_tpu.options import Flags as JaxFlags
    from convectionkernels_tpu.options import Options as JaxOptions
    quality = int(flags[flags.index("-q") + 1]) if "-q" in flags else None
    encode, container_fmt = jax_cli.get_encoder(
        fmt, JaxOptions(flags=JaxFlags.DEFAULT), quality)
    levels = []
    with jax.disable_jit():
        for level in jax_image.mip_chain(seeded_image()):
            levels.append((np.asarray(encode(jax_image.blockify(level),
                                             False)),
                           level.shape[1], level.shape[0]))
    ref = str(tmp_path / f"jax{suffix}")
    write = (jax_containers.write_dds if suffix == ".dds"
             else jax_containers.write_ktx)
    write(ref, levels, fmt=container_fmt)
    return read(ref)


@pytest.mark.slow
@pytest.mark.parametrize("fmt", CLI_FORMATS)
def test_cli_matches_jax_cli_every_format(fmt, tmp_path):
    """Every format of the JAX CLI with a mip chain (BC7 at -q 50), against
    the JAX CLI's file or, for CLI_OP_BY_OP, its encoder op by op."""
    suffix = ".dds" if fmt.startswith("bc") else ".ktx"
    flags = ["-f", fmt, "-mips"] + (["-q", "50"] if fmt == "bc7" else [])
    if fmt in CLI_OP_BY_OP:
        src = str(tmp_path / "in.npy")
        np.save(src, seeded_image())
        out = str(tmp_path / f"port{suffix}")
        assert cli.main(flags + [src, out], device="cpu") == 0
        assert read(out) == jax_cli_op_by_op(tmp_path, flags, fmt, suffix)
    else:
        got, want = run_both(tmp_path, flags, suffix)
        assert got == want


def test_cli_arguments(tmp_path, capsys):
    """No paths prints the usage and returns 1; an unknown format exits;
    without a card and without device="cpu" the encode refuses to run."""
    assert cli.main([], device="cpu") == 1
    assert "Usage:" in capsys.readouterr().out
    src = str(tmp_path / "in.npy")
    np.save(src, seeded_image())
    with pytest.raises(SystemExit, match="unknown format"):
        cli.main(["-f", "bc9", src, str(tmp_path / "x.dds")], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["-f", "bc1", src, str(tmp_path / "x.dds")])


def test_cli_runs_as_a_module(tmp_path):
    """python -m convectionkernels_tpu_torch.cli prints its usage and exits
    1 without paths (the module entry point)."""
    out = subprocess.run(
        [sys.executable, "-m", "convectionkernels_tpu_torch.cli"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 1, out.stderr
    assert "python -m convectionkernels_tpu_torch.cli" in out.stdout


def test_cli_shard_splits_the_blocks(tmp_path, monkeypatch):
    """-shard sends the blocks through encode_sharded (over the named
    device) with the same bytes as the unsplit encode; small chunks make
    each slice run several chunks."""
    from convectionkernels_tpu_torch.parallel import sharding
    monkeypatch.setattr(api, "CHUNK_S3TC", 3)
    calls = []
    real = sharding.encode_sharded

    def spy(encode, pixels, devices=None):
        calls.append((pixels.shape[0], devices))
        return real(encode, pixels, devices)

    monkeypatch.setattr(sharding, "encode_sharded", spy)
    src = str(tmp_path / "in.npy")
    np.save(src, seeded_image())
    for flags in (["-f", "bc1"], ["-f", "bc1", "-shard"]):
        assert cli.main(flags + [src, str(tmp_path / f"{len(flags)}.dds")],
                        device="cpu") == 0
    assert calls == [(20, ["cpu"])]
    assert read(tmp_path / "2.dds") == read(tmp_path / "3.dds")


TRANSFORMS = (
    ("u8_to_s8", lambda m, b: m._u8_to_s8(b)),
    ("u8_to_half_bits", lambda m, b: m._u8_to_half_bits(b)),
    ("eac_channel_0", lambda m, b: m._eac_channel(b, 0)),
    ("eac_channel_3", lambda m, b: m._eac_channel(b, 3)),
)


@pytest.mark.parametrize("case", TRANSFORMS, ids=[t[0] for t in TRANSFORMS])
def test_input_transforms_match_jax(case):
    """Each CLI input transform on all 256 u8 values, bit for bit."""
    values = np.arange(256, dtype=np.uint8)
    blocks = np.stack([np.roll(values, 16 * i).reshape(16, 16)
                       for i in range(4)], axis=-1)      # [16, 16, 4]
    got, want = case[1](cli, blocks), case[1](jax_cli, blocks)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", CLI_FORMATS)
def test_container_format_matches_jax(fmt):
    """Each format's container label is the JAX CLI's, the unsigned labels
    of bc4s and bc5s included (ROADMAP C.6)."""
    from convectionkernels_tpu.options import Options as JaxOptions
    _, want = jax_cli.get_encoder(fmt, JaxOptions(), None)
    _, got = cli.get_encoder(fmt, Options(), None, "cpu")
    assert got == want
