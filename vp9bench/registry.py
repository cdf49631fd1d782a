"""What the harness finds by name: the cells and metrics of
BENCHMARK.json, a configuration in configs/<name>.json, a traffic mix in
traffic/<name>.json, and a per-layer metric's reader in
metrics/<stem>.py, where the stem is the metric's name up to its first
dot (so `walk_ms.live` is read by metrics/walk_ms.py). A new
configuration, mix or metric is a new file and a new entry, never an
edit."""
from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    """BENCHMARK.json of the checkout at `root`."""
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench, name):
    """The workload entry `name`, with its end-to-end and per-layer
    metric entries: (workload, [end_to_end], [per_layer])."""
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]

    def mine(metrics):
        return [m for m in metrics
                if name in m.get("workloads", [name])]
    return w, mine(bench["end_to_end"]), mine(bench["per_layer"])


def config(name, bench_dir=BENCH_DIR):
    """configs/<name>.json."""
    return load_json(os.path.join(bench_dir, "configs", f"{name}.json"))


def traffic(name, bench_dir=BENCH_DIR):
    """traffic/<name>.json."""
    return load_json(os.path.join(bench_dir, "traffic", f"{name}.json"))


def resolve(path, root=ROOT):
    """A path of a configuration file, relative to the checkout's root."""
    return os.path.join(root, path)


def reader(metric, bench_dir=BENCH_DIR):
    """The `read(ctx)` function of metrics/<stem>.py for `metric`."""
    stem = metric.split(".", 1)[0]
    path = os.path.join(bench_dir, "metrics", f"{stem}.py")
    spec = importlib.util.spec_from_file_location(
        f"vp9bench.metrics.{stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
