#!/usr/bin/env python3
"""What the port's MC kernel (csrc/mc.cu) costs on each kind of input,
and an A/B of its builds, on one CUDA card.

Captures the MC inputs of bench_1080p frames 1-2 (as recon_frame hands
them to mc_planes) and makes chip_smoke.py's two seeded full-size frames
(a motion a cell with every inter cell compound, and a motion a tile).
Builds csrc/mc.cu for each variant, all at once: "NAME=VALUE,..."
rewrites `constexpr int NAME = VALUE;` in a copy, "@PATH" builds another
source with the same C interface as it stands (an earlier commit's,
unpacked beside the repository), "-PART,..." drops parts of the work
(DROP: the passes, the window copies, the whole window path, the
residual copies) to show what they cost, and an empty variant is the
source as it stands. Then for each build, in turns (a b c c b a), holds
every input against the plain version (not the builds that drop work)
and times the kernel on the card's clock (torch.profiler). Prints one
JSON object and writes it to --out.

    python3 tools/mc_ab_torch.py [--reps 50] [--out mc_ab.json]
        [--variants ";kWarps=8,kMinBlocks=3;@old/csrc/mc.cu;-passes"]
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# part: the edits of csrc/mc.cu that drop it. passes: the window path's
# horizontal and vertical passes (its values read as copied); copies:
# the window's copies (the passes run on what the slice holds); window:
# the whole window path; residual: the residual's copies
DROP = {
    "passes": [("  if (mx) {\n    // horizontal pass",
                "  if (false) {\n    // horizontal pass"),
               ("    if (my) {\n      int acc[4]",
                "    if (false) {\n      int acc[4]")],
    "copies": [("          copy4(s + r * kWinStride + lane,",
                "          if (false) copy4(s + r * kWinStride + lane,"),
               ("        copy4(hv + (r0 + 2 * i) * kTile + c,",
                "        if (false) copy4(hv + (r0 + 2 * i) * kTile + c,")],
    "window": [("      window_pass(p, a.maxp, s, lane, lead, y0, x0, v);",
                "      for (int k = 0; k < 2; ++k)\n"
                "        for (int i = 0; i < 4; ++i) v[k][i] = lead.mvx;")],
    "residual": [("      copy16(s + kRes", "      if (false) copy16(s + kRes")],
}


def sources(variants):
    """{variant: the source text to build}."""
    from ffmpeg_hybrid_tpu_torch import _build
    with open(os.path.join(_build.CSRC_DIR, "mc.cu")) as f:
        own = f.read()
    out = {}
    for v in variants:
        if v.startswith("@"):
            with open(os.path.join(ROOT, v[1:])) as f:
                out[v] = f.read()
            continue
        src = own
        if v.startswith("-"):
            for part in v[1:].split(",-"):
                for a, b in DROP[part]:
                    if src.count(a) != 1:
                        raise RuntimeError(f"csrc/mc.cu: cannot drop {part}")
                    src = src.replace(a, b)
            out[v] = src
            continue
        for item in filter(None, v.split(",")):
            name, value = item.split("=")
            src, n = re.subn(rf"constexpr int {name} = [^;]+;",
                             f"constexpr int {name} = {value};", src)
            if n != 1:
                raise RuntimeError(f"csrc/mc.cu has no constant {name}")
        out[v] = src
    return out


def build(variants):
    """{variant: (loaded library, ptxas lines)}, nvcc started for every
    variant at once."""
    from ffmpeg_hybrid_tpu_torch import _build
    from ffmpeg_hybrid_tpu_torch.ops import recon_cuda as RC
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for i, (v, src) in enumerate(sources(variants).items()):
        stem = os.path.join(_build.BUILD_DIR, f"mc_ab_{i}")
        with open(stem + ".cu", "w") as f:
            f.write(src)
        procs[v] = (stem, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", stem + ".so",
             stem + ".cu"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for v, (stem, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc of variant '{v}' failed:\n{log}")
        lib = ctypes.CDLL(stem + ".so")
        lib.mc_planes.argtypes = RC._SIGNATURES["mc.cu"]["mc_planes"]
        lib.mc_planes.restype = ctypes.c_int
        libs[v] = (lib, [ln.strip() for ln in log.splitlines()
                         if "registers" in ln or "spill" in ln
                         or "smem" in ln])
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=";kWarps=8,kMinBlocks=3;kCellLanes=8",
                    help="';'-separated builds: 'NAME=VALUE,...', '@PATH' "
                         "or '' (the source as it stands)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("mc_ab_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ffmpeg_hybrid_tpu_torch import _build
    from ffmpeg_hybrid_tpu_torch.ops import recon as R
    variants = args.variants.split(";")
    libs = build(variants)
    frames, _want = cs.read_clip("bench_1080p")
    calls = cs.capture_inputs(torch, [(R, "mc_planes")],
                              frames[:3])["mc_planes"]
    seeded, tiled = cs.mc_seeded(torch, np)
    inputs = {"bench_1080p_1": calls[0], "bench_1080p_2": calls[1],
              "seeded_cells": (seeded, 8, True),
              "seeded_tiles": (tiled, 8, True)}
    wants = {k: R.mc_planes_plain(*c) for k, c in inputs.items()}
    runs = {v: [] for v in variants}
    for v in variants + variants[::-1]:
        _build._LIBS["mc.cu"] = libs[v][0]
        run = {}
        for k, (jobs, bpp, has_comp) in inputs.items():
            for out, want in zip(R.mc_planes(jobs, bpp, has_comp), wants[k]):
                if not v.startswith("-") and not torch.equal(out, want):
                    raise RuntimeError(f"variant '{v}' on {k}: kernel != "
                                       "plain")
            run[k] = cs.device_ms(
                torch, lambda: R.mc_planes(jobs, bpp, has_comp), args.reps,
                ("mc_kernel",))[0]
        runs[v].append(run)
    _build._LIBS.pop("mc.cu", None)
    report = {"card": cs.card_line(), "torch": torch.__version__,
              "inputs": {k: {"inter_cells": sum(int(j[1].sum())
                                                for j in c[0]),
                             "paths": cs.mc_paths(np, c[0], c[2])}
                         for k, c in inputs.items()},
              "ptxas": {v or "as it stands": libs[v][1] for v in variants},
              "runs": {v or "as it stands": runs[v] for v in variants}}
    print(json.dumps({"mc_ab": report}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
