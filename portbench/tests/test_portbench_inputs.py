"""The generators: the same inputs for a seed, other inputs for another,
and the frozen copies equal to their sources."""

import numpy as np
import pytest

from harness import inputs, traffic


@pytest.mark.parametrize("make", [inputs.make_texture_image,
                                  inputs.make_hdr_image])
def test_a_seed_gives_the_same_image_and_another_seed_another(make):
    a, b = make(7, 64), make(7, 64)
    c = make(8, 64)
    assert a.tobytes() == b.tobytes()
    assert a.tobytes() != c.tobytes()


def test_large_seeds_are_taken():
    seed = 2**31 + 12345
    a = traffic.make_pool(dict(image_size=16, pool_images=2, tile_size=None,
                               mips=False), "ldr_rgba8", seed)
    b = traffic.make_pool(dict(image_size=16, pool_images=2, tile_size=None,
                               mips=False), "ldr_rgba8", seed)
    assert a[1].levels[0].tobytes() == b[1].levels[0].tobytes()
    assert a[0].levels[0].tobytes() != a[1].levels[0].tobytes()


def test_hdr_values_are_finite_half_floats_in_range():
    img = inputs.make_hdr_image(3, 256)
    assert img.dtype == np.float16 and np.isfinite(img).all()
    rgb = img[..., :3].astype(np.float32)
    assert rgb.min() >= 0 and rgb.max() < inputs.HDR_MAX
    assert (img[..., 3] == 1.0).all()
    assert rgb.max() > 16.0                     # the bright spots
    assert np.percentile(rgb, 10) < 0.5         # the dark end


def test_frozen_copies_match_their_sources():
    import chip_smoke
    from convectionkernels_tpu_torch.utils import image
    img = inputs.make_texture_image(11, 128)
    assert np.array_equal(inputs.blockify(img),
                          chip_smoke.make_texture(11, 128))
    for got, want in zip(inputs.mip_chain(img), image.mip_chain(img)):
        assert np.array_equal(got, want)
    odd = img[:36, :20]
    assert np.array_equal(inputs.blockify(odd), image.blockify(odd))


def test_hdr_mips_are_float32_means_rounded_to_half():
    img = inputs.make_hdr_image(5, 16)
    chain = inputs.mip_chain_half(img)
    assert [lv.shape[0] for lv in chain] == [16, 8, 4, 2, 1]
    want = img.astype(np.float32)[:2, :2].mean(axis=(0, 1))
    assert np.array_equal(chain[1][0, 0], want.astype(np.float16))


def test_hdr_blocks_reach_the_program_as_int16_half_bits():
    pool = traffic.make_pool(dict(image_size=8, pool_images=1, tile_size=None,
                                  mips=True), "hdr_rgba16f", 1)
    levels = pool[0].levels
    assert [lv.shape[0] for lv in levels] == [4, 1, 1, 1]
    assert all(lv.dtype == np.int16 for lv in levels)


def test_the_window_requests_are_distinct_lsb_variants_of_the_pool():
    mix = dict(image_size=16, pool_images=2, tile_size=None, mips=True,
               window_requests=6)
    config = dict(input="ldr_rgba8")
    a = traffic.make(mix, config, 2**31 + 5)
    b = traffic.make(mix, config, 2**31 + 5)
    c = traffic.make(mix, config, 2**31 + 6)
    assert len(a.pool) == 2 and len(a.window) == 6
    seen = set()
    for v, r in enumerate(a.window):
        base = a.pool[v % 2]
        assert [lv.shape for lv in r.levels] == [lv.shape for lv in
                                                 base.levels]
        for lv, blv in zip(r.levels, base.levels):
            diff = lv ^ blv
            assert diff.max() <= 1                  # the lowest bit only
            assert not diff[..., 3].any()           # alpha untouched
        assert r.levels[0].tobytes() != base.levels[0].tobytes()
        key = b"".join(lv.tobytes() for lv in r.levels)
        assert key not in seen                      # no request repeats
        seen.add(key)
    assert all(x.levels[0].tobytes() == y.levels[0].tobytes()
               for x, y in zip(a.window, b.window))
    assert a.window[0].levels[0].tobytes() != c.window[0].levels[0].tobytes()


def test_hdr_variants_stay_finite_half_floats():
    mix = dict(image_size=16, pool_images=1, tile_size=None, mips=True,
               window_requests=3)
    w = traffic.make(mix, dict(input="hdr_rgba16f"), 9).window
    for r in w:
        for lv in r.levels:
            assert lv.dtype == np.int16
            half = lv.view(np.float16)
            assert np.isfinite(half).all() and (half[..., 3] == 1.0).all()
