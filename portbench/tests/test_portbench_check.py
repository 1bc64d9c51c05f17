"""The output check: the program's bytes pass, and the control and every
fault of the timed path come out not correct, at a size the CPU holds.

Each run goes through runner.run and runner.result_line as run.py drives
them, with only the look for a card skipped (device "cpu"): a 32x32 tile
cell (4 tiles of 16 blocks) and a 16x16 texture with its mips."""

import time

import pytest

from harness import control, runner, spec


def _cell(name, **mix):
    cell = spec.find_cell(name)
    cell.mix = dict(cell.mix, **mix)
    return cell


TILES = dict(image_size=32, tile_size=16, settle_s=0)
BAKE = dict(image_size=16, pool_images=2, settle_s=0)


def _line(cell, entry=None, warm=True, seconds=1.0, seed=2**31 + 77):
    result = runner.run(cell, seed, seconds, False, "cpu",
                        time.perf_counter(), entry=entry, warm=warm,
                        log=lambda m: None)
    return runner.result_line(cell, result, "cpu"), result


def test_the_programs_bytes_are_correct():
    line, result = _line(_cell("bc7_q50.tiles_128", **TILES))
    assert line["correct"] is True
    assert line["compared"] == {"mismatched_blocks": {"value": 0,
                                                      "limit": 0},
                                "failed_requests": {"value": 0, "limit": 0}}
    assert result["blocks_compared"] == 16 * len(result["window"].served)
    assert list(line)[-1] == "compared"
    assert set(line["metrics"]) == {"texel_rate", "request_ms_p95",
                                    "device_reserved_gib", "setup_s"}


@pytest.mark.parametrize("name,mix", [("bc7_q50.tiles_128", TILES),
                                      ("bc6hu.bake_1k_mips", BAKE)])
def test_the_control_is_not_correct(name, mix):
    cell = _cell(name, **mix)
    entry = control.control_entry(runner.reference_entry(cell.config), "cpu")
    line, result = _line(cell, entry=entry, warm=False)
    assert line["correct"] is False
    assert result["mismatched_blocks"] > 0


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
def test_each_fault_of_the_timed_path_is_not_correct(fault):
    cell = _cell("bc7_q50.tiles_128", **TILES)
    entry = control.FAULTS[fault](runner.program_entry(cell.config, "cpu"))
    line, result = _line(cell, entry=entry, seconds=2.5)
    assert len(result["window"].served) >= 2
    assert line["correct"] is False, fault


def test_a_request_that_raises_is_counted_failed_and_not_correct():
    cell = _cell("bc7_q50.tiles_128", **TILES)
    program = runner.program_entry(cell.config, "cpu")
    calls = [0]

    def flaky(blocks):
        calls[0] += 1
        if calls[0] == 5:              # the second request of the window
            raise RuntimeError("lost")
        return program(blocks)
    line, _ = _line(cell, entry=flaky, seconds=2.5)
    assert line["failed"] == 1 and line["correct"] is False
    assert line["compared"]["failed_requests"]["value"] == 1


def test_small_levels_are_checked_whole_and_large_ones_by_a_seeded_sample():
    from harness import check
    assert list(check.sample_rows(4096, 4096, 8192, 5, 0, 3)) == list(
        range(4096))
    a = check.sample_rows(262144, 4096, 8192, 5, 0, 0)
    assert len(a) == 8192 == len(set(a.tolist())) and a.max() < 262144
    assert list(a) == list(check.sample_rows(262144, 4096, 8192, 5, 0, 0))
    assert list(a) != list(check.sample_rows(262144, 4096, 8192, 6, 0, 0))
    assert list(a) != list(check.sample_rows(262144, 4096, 8192, 5, 1, 0))
    tile = check.sample_rows(1024, 0, 128, 2**31 + 9, 17, 0)
    assert len(tile) == 128


def test_a_served_level_of_the_wrong_shape_counts_every_row():
    import numpy as np
    from harness import check
    want = np.zeros((3, 16), np.uint8)
    rows = np.array([0, 5, 9])
    assert check.mismatched(np.zeros((10, 16), np.uint8), rows, want) == 0
    assert check.mismatched(np.zeros((9, 16), np.uint8), rows, want) == 3
    assert check.mismatched(np.zeros((10, 8), np.uint8), rows, want) == 3
    got = np.zeros((10, 16), np.uint8)
    got[5, 15] = 1
    assert check.mismatched(got, rows, want) == 1
