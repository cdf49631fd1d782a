#!/usr/bin/env python3
"""An A/B of the constants of the port's loop-filter kernel (csrc/lpf.cu)
on one CUDA card.

Captures the loop filter's inputs of frame 0 of bench_1080p_lf (Y and
U+V, as recon_frame hands them to lf_frame_) and makes chip_smoke.py's
full-size random-grid frame (every edge position active; bench_1080p has
no loop filter, so its frame 0 gives the filter nothing to do). Builds
csrc/lpf.cu with the constants of each variant (`constexpr int NAME =
VALUE;` rewritten in a copy; an empty variant is the source as it
stands), and for each build, in turns (a b c c b a), holds both inputs
against the plain version and times (CUDA events, the planes' restore
copy subtracted) the launch of both sets and each set alone, in ms and
us per wave. Prints one JSON object and writes it to --out.

    python3 tools/lpf_ab_torch.py [--reps 20] [--out lpf_ab.json]
        [--variants ";kThreads=128;kLoadBatch=4"]
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start_build(variant, tag):
    """Start nvcc on a copy of csrc/lpf.cu with the constants of
    `variant` ("NAME=VALUE,..."). Returns (library path, process)."""
    from ffmpeg_hybrid_tpu_torch import _build
    with open(os.path.join(_build.CSRC_DIR, "lpf.cu")) as f:
        src = f.read()
    for item in filter(None, variant.split(",")):
        name, value = item.split("=")
        src, n = re.subn(rf"constexpr int {name} = [^;]+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"csrc/lpf.cu has no constant {name}")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    stem = os.path.join(_build.BUILD_DIR, f"lpf_ab_{tag}")
    with open(stem + ".cu", "w") as f:
        f.write(src)
    return stem + ".so", subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
         "-o", stem + ".so", stem + ".cu"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def load(path, proc):
    """The library a start_build has made, with lpf_frame's signature."""
    from ffmpeg_hybrid_tpu_torch.ops import lpf_dense as LD
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{log}")
    lib = ctypes.CDLL(path)
    lib.lpf_frame.argtypes = LD._SIGNATURES["lpf_frame"]
    lib.lpf_frame.restype = ctypes.c_int
    return lib


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=";kThreads=128;kThreads=512;"
                    "kLoadBatch=4;kBlocksPerSM=1",
                    help="';'-separated builds, each 'NAME=VALUE,...'")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("lpf_ab_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from ffmpeg_hybrid_tpu_torch import _build
    from ffmpeg_hybrid_tpu_torch.ops import lpf_dense as LD
    card = CS.card_line()
    frames, _want = CS.read_clip("bench_1080p_lf")
    inputs = {"bench_1080p_lf": CS.capture_inputs(
        torch, [(LD, "lf_frame_")], frames[:1])["lf_frame_"][0],
        "random": CS.random_lf_frame(torch, np, CS.SEED)}
    wants = {}
    for key, a in inputs.items():
        wants[key] = [p.clone() for p in a[:3]]
        LD.lf_frame_plain_(*wants[key], *a[3:])
    variants = args.variants.split(";")
    started = {v: start_build(v, i) for i, v in enumerate(variants)}
    libs = {v: load(*started[v]) for v in variants}
    runs = {v: [] for v in variants}
    for v in variants + variants[::-1]:
        _build._LIBS["lpf.cu"] = libs[v]
        run = {}
        for key, a in inputs.items():
            CS.lf_stress(torch, LD, a, wants[key], 3)
            work, go, restore = CS.lf_run(torch, LD, a)
            copy_ms = CS.cuda_ms(restore, args.reps)
            nwaves = 2 * (a[7] - 1) + a[8]
            ms = {name: CS.cuda_ms(lambda: go(*sets), args.reps) - copy_ms
                  for name, sets in (("both", (True, True)),
                                     ("y", (True, False)),
                                     ("uv", (False, True)))}
            run[key] = {"ms": ms, "us_per_wave": {
                k: t * 1e3 / nwaves for k, t in ms.items()}}
        runs[v].append(run)
    _build._LIBS.pop("lpf.cu", None)
    report = {"card": card, "torch": torch.__version__,
              "runs": {v or "as it stands": runs[v] for v in variants}}
    print(json.dumps({"lpf_ab": report}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
