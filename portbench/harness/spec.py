"""Find a cell and everything it names, by name.

BENCHMARK.json at the checkout's root lists the cells (`workloads`), the
configurations and the metrics. A configuration's file is the `file` its
entry names; a traffic mix is portbench/mixes/<traffic>.json; a per-layer
metric's reader is portbench/metrics/<metric name>.py. Code that a mix or
a configuration needs of its own (a generator, a loop, an entry builder,
a reference) is a module under portbench/ that its file names as
`module:function` (resolve). A later cell, configuration, mix or metric
is new files and new entries: nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict          # the configuration's file
    traffic_name: str
    mix: dict             # the traffic mix's file
    end_to_end: list      # BENCHMARK.json's entries this cell reports
    per_layer: list
    root: str = ROOT      # the checkout the files were read from


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: str = ROOT, bench: dict | None = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its configuration file, its
    mix file and the metrics it reports; KeyError if there is none."""
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "mixes",
                           w["traffic"] + ".json")) as f:
        mix = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name) and m["moves"] in e2e_names]
    return Cell(name, int(w["chips"]), w["config"], config, w["traffic"],
                mix, e2e, per_layer, root)


def metric_reader(name: str, root: str = ROOT):
    """The `read(view)` function of portbench/metrics/<name>.py."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def resolve(dotted: str, root: str = ROOT):
    """`module:attribute` of a module under portbench/ (a configuration
    names its plain reference so)."""
    import importlib
    import sys
    bench_dir = os.path.join(root, "portbench")
    if bench_dir not in sys.path:
        sys.path.insert(0, bench_dir)
    module, attr = dotted.split(":")
    return getattr(importlib.import_module(module), attr)
