"""The harness finds configurations, mixes and metric readers by name,
and BENCHMARK.json keeps to the benchmark's contract."""
import json
import os
import re

import pytest

from vp9bench import harness, ivf, registry
from vp9bench_helpers import tiny_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_dummy_config_found_without_a_code_edit(tmp_path):
    bench, d = tiny_bench(tmp_path)
    with open(os.path.join(d, "configs", "dummy_cfg.json"), "w") as f:
        json.dump({"clip": "x.ivf", "framemd5": "x.framemd5",
                   "pass_a_impl": "device"}, f)
    assert registry.config("dummy_cfg", d)["clip"] == "x.ivf"
    assert registry.traffic("mix", d)["sessions"] == 2
    w, e2e, per_layer = registry.cell(bench, "tiny.mix")
    assert w["config"] == "tiny" and [m["name"] for m in e2e] == [
        "fps", "frame_p95_ms", "setup_s"] and per_layer == []
    with pytest.raises(KeyError):
        registry.cell(bench, "no.such")


def test_reader_found_by_the_name_before_the_first_dot(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "metrics"))
    with open(os.path.join(d, "metrics", "dummy_ms.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx * 2\n")
    assert registry.reader("dummy_ms", d)(21) == 42
    assert registry.reader("dummy_ms.live", d)(4) == 8


def test_metric_workloads_key_limits_the_cells():
    bench = {"workloads": [{"name": "a"}, {"name": "b"}],
             "end_to_end": [{"name": "x"}, {"name": "y", "workloads": ["b"]}],
             "per_layer": []}
    assert [m["name"] for m in registry.cell(bench, "a")[1]] == ["x"]
    assert [m["name"] for m in registry.cell(bench, "b")[1]] == ["x", "y"]


def test_benchmark_json_keeps_to_the_contract():
    bench = registry.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["vp9bench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("vp9bench/")
        cfg = registry.config(c["name"])
        assert all(k in cfg for k in c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        registry.traffic(w["traffic"])
        cells.add(w["name"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m.get("workloads", cells)) <= cells
        registry.reader(m["name"])
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("name", ["vp9_p2_1080p_hdr10", "vp9_p1_1080p_444"])
def test_configuration_clip_and_reference_agree(name):
    cfg = registry.config(name)
    (w, h), cycle = ivf.read_clip(registry.resolve(cfg["clip"]))
    expected = ivf.read_framemd5(registry.resolve(cfg["framemd5"]))
    assert (w, h) == (cfg["width"], cfg["height"])
    assert len(cycle) == cfg["gop_frames"] == len(expected)
    assert all(p.visible for p in cycle)
    assert sum(len(p.data) for p in cycle) == cfg["bytes_per_cycle"]
    assert len(set(expected)) == len(expected)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types
    import ffmpeg_hybrid_tpu_torch  # noqa: F401
    assert "ffmpeg_hybrid_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlibx", types.ModuleType("jaxlibx"))
    assert "jaxlib" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ffmpeg_hybrid_tpu.ops",
                        types.ModuleType("ffmpeg_hybrid_tpu.ops"))
    assert "ffmpeg_hybrid_tpu" in harness.forbidden_modules()
