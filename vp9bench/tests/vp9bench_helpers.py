"""A benchmark folder of one tiny cell, made in a temporary directory:
a configuration on a small committed clip, a mix, no per-layer metric."""
import json
import os

TINY_CLIP = "vectors/passa_inter_modes"


def tiny_bench(tmp_path, sessions=2, clip=TINY_CLIP, **mix):
    """(bench dict, bench_dir) of the cell `tiny.mix`; `mix` adds keys
    to the traffic mix."""
    d = str(tmp_path)
    for sub in ("configs", "traffic", "metrics"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    with open(os.path.join(d, "configs", "tiny.json"), "w") as f:
        json.dump({"clip": clip + ".ivf", "framemd5": clip + ".framemd5",
                   "pass_a_impl": "device", "bit_depth": 8}, f)
    with open(os.path.join(d, "traffic", "mix.json"), "w") as f:
        json.dump({"sessions": sessions, "phase": "spread", **mix}, f)
    bench = {"workloads": [{"name": "tiny.mix", "config": "tiny",
                            "traffic": "mix", "chips": 1, "why": "test"}],
             "end_to_end": [{"name": "fps", "unit": "frames/s"},
                            {"name": "frame_p95_ms", "unit": "ms"},
                            {"name": "setup_s", "unit": "s"}],
             "per_layer": []}
    return bench, d
