#!/usr/bin/env python3
"""What the port's scaled MC kernel (csrc/mc.cu mc_planes_scaled) costs
on each kind of input, and an A/B of its builds, on one CUDA card.

Inputs: the calls of resize_1080p frames 1-5, as recon_frame hands them
to mc_planes_scaled (with the splat's index as each frame left it), and
chip_smoke.py's seeded 1920x1080 frames (mc_scaled_seeded: SCALED_REFS
at 8 bpp 4:2:0, among them a frame of a motion a 16x16 tile at steps 32,
8 and 1, then MC_FORMATS' depths and layouts). Builds csrc/mc.cu for
each variant, all at once: "NAME=VALUE,..." rewrites `constexpr int NAME
= VALUE;` in a copy, "@PATH" builds another source with the same C
interface as it stands (an earlier commit's, unpacked beside the
repository), and an empty variant is the source as it stands. Then, for
each build in turns (a b c c b a), holds every input against the plain
version, bit for bit, and times the kernel on the card's clock
(chip_smoke.device_ms, --reps launches). Prints one JSON object and
writes it to --out, with the card, each build's ptxas lines and each
input's path shares (the tile passes on the window path and those that
walk the cells, as the source's own kernel counts them on the card;
chip_smoke.kernel_paths holds the count to the host model).

    python3 tools/mc_scaled_ab_torch.py [--reps 50]
        [--out mc_scaled_ab.json] [--variants ";@old/mc.cu;kSMinBlocks=6"]
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
        for item in filter(None, v.split(",")):
            name, value = item.split("=")
            src, n = re.subn(rf"constexpr int {name} = [^;]+;",
                             f"constexpr int {name} = {value};", src)
            if n != 1:
                raise RuntimeError(f"csrc/mc.cu has no constant {name}")
        out[v] = src
    return out


def build(variants):
    """{variant: (loaded library, ptxas lines of the scaled kernel)}, nvcc
    started for every variant at once."""
    from ffmpeg_hybrid_tpu_torch import _build
    from ffmpeg_hybrid_tpu_torch.ops import recon_cuda as RC
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for i, (v, src) in enumerate(sources(variants).items()):
        stem = os.path.join(_build.BUILD_DIR, f"mc_scaled_ab_{i}")
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
        for name, argtypes in RC._SIGNATURES["mc.cu"].items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        lines = log.splitlines()
        at = [i for i, ln in enumerate(lines)
              if "Compiling entry function" in ln and "mc_scaled_kernel" in ln]
        libs[v] = (lib, [ln.strip() for ln in lines[at[0] + 1:at[0] + 4]
                         if "registers" in ln or "spill" in ln])
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="",
                    help="';'-separated builds: 'NAME=VALUE,...', '@PATH' "
                         "or '' (the source as it stands)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("mc_scaled_ab_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ffmpeg_hybrid_tpu_torch import _build
    from ffmpeg_hybrid_tpu_torch.ops import recon as R
    variants = args.variants.split(";")
    # the decoder's own kernels (for the captures) build beside the variants
    th = threading.Thread(target=_build.build_all)
    th.start()
    libs = build(variants)
    th.join()
    frames, _want = cs.read_clip(cs.RESIZE_CLIP)
    calls = cs.capture_inputs(torch, [(R, "mc_planes_scaled")],
                              frames)["mc_planes_scaled"]
    inputs = {f"{cs.RESIZE_CLIP}_{i + 1}": a for i, a in enumerate(calls)}
    inputs.update(cs.mc_scaled_seeded(torch, np))
    wants = {k: R.mc_planes_scaled_plain(*a[:-1]) for k, a in inputs.items()}
    runs = {v: [] for v in variants}
    for v in variants + variants[::-1]:
        _build._LIBS["mc.cu"] = libs[v][0]
        run = {}
        for k, a in inputs.items():
            for out, want in zip(R.mc_planes_scaled(*a), wants[k]):
                if not torch.equal(out, want):
                    raise RuntimeError(f"variant '{v}' on {k}: kernel != "
                                       "plain")
            run[k] = cs.device_ms(torch, lambda: R.mc_planes_scaled(*a),
                                  args.reps, ("mc_scaled_kernel",))[0]
        runs[v].append(run)
    _build._LIBS.pop("mc.cu", None)
    info = {}
    for k, a in inputs.items():
        b, o = cs.mc_scaled_work(np, a)
        counted = torch.zeros(2, dtype=torch.int64, device="cuda")
        R.mc_planes_scaled(*a, paths=counted)
        info[k] = {"inter_cells": sum(int(j[1].sum()) for j in a[0]),
                   "steps": a[5], "bound_ms": cs.bounds(b, o, 0)[0],
                   "paths": cs.kernel_paths(np, k, a, counted)}
    report = {"card": cs.card_line(), "torch": torch.__version__,
              "inputs": info,
              "ptxas": {v or "as it stands": libs[v][1] for v in variants},
              "runs": {v or "as it stands": runs[v] for v in variants}}
    print(json.dumps({"mc_scaled_ab": report}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
