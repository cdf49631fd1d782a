"""Nothing the benchmark runs imports JAX, the JAX package
ffmpeg_hybrid_tpu, the root bench.py, chip_smoke.py or tools/ (top-level
module names compared whole: the port's name begins with the JAX
package's)."""
import ast
import glob
import os
import subprocess
import sys

from conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "ffmpeg_hybrid_tpu", "bench",
          "chip_smoke", "tools"}
BENCH = os.path.join(ROOT, "vp9bench")


def sources():
    return sorted(glob.glob(os.path.join(BENCH, "*.py"))
                  + glob.glob(os.path.join(BENCH, "metrics", "*.py")))


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_of_the_harness_imports_a_banned_module():
    assert len(sources()) >= 10
    for path in sources():
        found = set(imported(path)) & BANNED
        assert not found, f"{path} imports {found}"


def test_a_process_running_the_harness_loads_none():
    """Import every module of the harness and the port's decode path in
    a fresh interpreter, then list the banned top-level names loaded."""
    code = (
        "import sys, glob, os\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import vp9bench.harness, vp9bench.trace, vp9bench.control\n"
        "from vp9bench import registry\n"
        "for p in glob.glob(os.path.join(registry.BENCH_DIR, 'metrics', "
        "'*.py')):\n"
        "    registry.reader(os.path.basename(p)[:-3])\n"
        "from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder\n"
        "from ffmpeg_hybrid_tpu_torch.ops import recon, lpf_dense, "
        "lpf_masks, passa_device\n"
        f"print(sorted({{m.split('.')[0] for m in sys.modules}} & "
        f"set({sorted(BANNED)!r})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_the_port_exits_nonzero_and_prints_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and vp9bench/ has no
    port (and here no card): the run fails without a result line."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "vp9bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        import json
        cell = json.load(f)["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "vp9bench/run.py", "--workload", cell, "--seed",
         str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
