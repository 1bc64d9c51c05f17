"""A configuration, a traffic mix and a per-layer metric are added as files
and BENCHMARK.json entries alone: the harness finds them by name."""

import json
import os
import shutil
import time

import numpy as np

from harness import runner, spec, trace, traffic


def _checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root)
    return root


def test_the_benchmark_names_only_files_that_exist():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
        assert callable(spec.resolve(cell.config["reference"]["function"]))


def test_a_dummy_config_mix_and_metric_are_found(tmp_path):
    root = _checkout(tmp_path)
    bench_dir = root / "portbench"
    (bench_dir / "configs" / "dummy.json").write_text(json.dumps(dict(
        name="dummy", program={"entry": "encode_bc1", "options": {}},
        reference={"function": "reference:encode_bc7",
                   "kwargs": {"quality": 10}},
        input="ldr_rgba8", check_chunk=64)))
    (bench_dir / "mixes" / "dummy_mix.json").write_text(json.dumps(dict(
        image_size=16, pool_images=2, tile_size=8, mips=True,
        settle_s=0, trace_requests=1, check_full_max=4,
        check_sample=2)))
    (bench_dir / "metrics" / "dummy_ops.py").write_text(
        "def read(view):\n    return float(len(view.ops))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="dummy", source="https://example.org",
                                 file="portbench/configs/dummy.json",
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name="dummy.dummy_mix", config="dummy",
                                   traffic="dummy_mix", chips=1, why="t"))
    bench["per_layer"].append(dict(
        name="dummy_ops", unit="ops", better="lower", source="device_trace",
        layer="device", moves="texel_rate", workloads=["dummy.dummy_mix"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.find_cell("dummy.dummy_mix", str(root))
    assert cell.config["program"]["entry"] == "encode_bc1"
    assert [m["name"] for m in cell.per_layer] == ["dummy_ops"]
    assert {m["name"] for m in cell.end_to_end} == {
        "texel_rate", "request_ms_p95", "device_reserved_gib", "setup_s"}
    pool = traffic.make_pool(cell.mix, cell.config["input"], 3)
    assert len(pool) == 8                         # 2 images x 4 tiles
    assert [lv.shape for lv in pool[0].levels] == [(4, 16, 4), (1, 16, 4),
                                                   (1, 16, 4), (1, 16, 4)]
    read = spec.metric_reader("dummy_ops", str(root))
    v = trace.TraceView([trace.Op("k", "kernel", 0, 5)], [], [], 16, (0, 10),
                        frozenset(), None)
    assert read(v) == 1.0
    # a cell that BENCHMARK.json does not name is refused
    try:
        spec.find_cell("dummy.other", str(root))
    except KeyError:
        pass
    else:
        raise AssertionError("an unknown cell was found")


# A kind of traffic the one generator cannot make (textures of mixed
# sizes, each sent once, with its own loop) and an entry the configuration
# keys cannot say, in one new module that a new mix and a new
# configuration name.
ODD_TRAFFIC = '''
import time

from harness import inputs, runner, traffic


def make(mix, config, seed):
    sizes = mix["sizes"]
    pool = []
    for i, size in enumerate(sizes):
        image = inputs.make_texture_image(seed + i, size)
        pool.append(traffic.Request([inputs.blockify(lv)
                                     for lv in inputs.mip_chain(image)]))
    return traffic.Traffic(pool[:1], pool)


def each_once(entry, requests, seconds, log):
    w = runner.Window([], [], [], 0, 0.0, 0, 0)
    start = time.perf_counter()
    for i, request in enumerate(requests):
        outs, took, inside = runner.send(entry, request)
        w.served.append((i, outs))
        w.latencies.append(took)
        w.enqueue.append(inside)
        w.texels += request.texels
        w.attempted += 1
    w.seconds = time.perf_counter() - start
    return w


def builder(config, device):
    import convectionkernels_tpu_torch as ckt
    plan = ckt.plan_from_quality(config["quality"])
    return lambda blocks: ckt.encode_bc7(blocks, ckt.Options(), plan=plan,
                                         device=device)
'''


def test_a_new_kind_of_traffic_and_entry_are_new_files_only(tmp_path):
    """A run of a cell whose mix names its own generator and loop and whose
    configuration names its own entry builder, all in a new module: it
    goes through runner.run on the CPU and its bytes are correct."""
    root = _checkout(tmp_path)
    bench_dir = root / "portbench"
    (bench_dir / "odd_traffic.py").write_text(ODD_TRAFFIC)
    (bench_dir / "configs" / "bc7_q10.json").write_text(json.dumps(dict(
        name="bc7_q10", quality=10,
        program={"builder": "odd_traffic:builder"},
        reference={"function": "reference:encode_bc7",
                   "kwargs": {"quality": 10}},
        input="ldr_rgba8", check_chunk=256)))
    (bench_dir / "mixes" / "mixed_sizes.json").write_text(json.dumps(dict(
        generator="odd_traffic:make", loop="odd_traffic:each_once",
        sizes=[16, 8, 4], settle_s=0, trace_requests=0, check_full_max=16,
        check_sample=4)))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="bc7_q10", source="https://example.org",
                                 file="portbench/configs/bc7_q10.json",
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name="bc7_q10.mixed_sizes",
                                   config="bc7_q10", traffic="mixed_sizes",
                                   chips=1, why="t"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.find_cell("bc7_q10.mixed_sizes", str(root))
    result = runner.run(cell, 5, 0.0, False, "cpu", time.perf_counter(),
                        log=lambda m: None)
    line = runner.result_line(cell, result, "cpu")
    served = result["window"].served
    assert [len(outs) for _, outs in served] == [5, 4, 3]   # each size once
    assert [o.shape[0] for o in served[0][1]] == [16, 4, 1, 1, 1]
    assert line["correct"] is True and line["attempted"] == 3
    assert result["blocks_compared"] == 23 + 7 + 3        # every block


def test_the_cells_send_the_sizes_the_issue_gives():
    bake = spec.find_cell("bc7_q50.bake_2k_mips")
    sizes = [262144, 65536, 16384, 4096, 1024, 256, 64, 16, 4, 1, 1, 1]
    assert sum(sizes) == 349527
    assert traffic.Request([np.zeros((n, 16, 4), np.uint8)
                            for n in sizes]).texels == 5592432
    assert bake.mix["pool_images"] == 4 and bake.mix["mips"]
    hdr = spec.find_cell("bc6hu.bake_1k_mips")
    assert hdr.config["input"] == "hdr_rgba16f" and hdr.mix["mips"]
    tiles = spec.find_cell("bc7_q50.tiles_128")
    assert (tiles.mix["image_size"] // tiles.mix["tile_size"]) ** 2 == 256
