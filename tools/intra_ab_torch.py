#!/usr/bin/env python3
"""What one level of the port's intra kernel (csrc/intra.cu) costs, and
an A/B of its constants, on one CUDA card.

Captures the intra stage's inputs of frame 0 of bench_1080p_lf and of
bench_1080p (Y, U and V, as recon_frame hands them to
_intra_scan_planes), builds csrc/intra.cu with the constants of each
variant (`constexpr int NAME = VALUE;` rewritten in a copy; an empty
variant is the source as it stands), and for each build, in turns
(a b c c b a), holds the three planes against the plain version and
times (CUDA events) the launch of the three planes, each plane alone,
and each plane on its slab thinned to one block per level (what a level
costs without its pixel work). Prints one JSON object and writes it to
--out.

    python3 tools/intra_ab_torch.py [--reps 5] [--out intra_ab.json]
        [--variants "kLogCluster=0;kLogCluster=1;kLogCluster=2"]
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIPS = ("bench_1080p_lf", "bench_1080p")


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def capture(torch, clip):
    """(jobs, bpp) of frame 0's _intra_scan_planes call."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu_torch.formats.ivf import read_ivf
    from ffmpeg_hybrid_tpu_torch.formats.superframe import split_superframe
    from ffmpeg_hybrid_tpu_torch.ops import recon as R
    _info, pkts = read_ivf(os.path.join(ROOT, "vectors", clip + ".ivf"))
    frame = next(fd for pts, data in pkts
                 for _p, fd in split_superframe(data, pts))
    real, got = R._intra_scan_planes, []

    def keep(jobs, bpp):
        got.append(([tuple(a.clone() if torch.is_tensor(a) else a
                           for a in job) for job in jobs], bpp))
        return real(jobs, bpp)

    R._intra_scan_planes = keep
    try:
        VP9Decoder(device="cuda").decode(frame)
        torch.cuda.synchronize()
    finally:
        R._intra_scan_planes = real
    return got[0]


def thinned(torch, job):
    """The job with its slab keeping one real block per level (the first
    in slab order), every other row inert."""
    import numpy as np
    plane, residual, slab, L, sizes, caps = job
    buf = slab.cpu().numpy()
    H = plane.shape[0]
    out = buf.copy()
    out[:, 0] = H + 64
    kept = np.zeros(L, bool)
    base = 0
    for cap in caps:
        for lvl in range(L):
            rows = np.arange(base + lvl * cap, base + (lvl + 1) * cap)
            real = rows[buf[rows, 0] < H]
            if len(real) and not kept[lvl]:
                out[real[0]] = buf[real[0]]
                kept[lvl] = True
        base += L * cap
    return (plane, residual, torch.as_tensor(out, device=slab.device), L,
            sizes, caps)


def build(variant, tag):
    """The library of csrc/intra.cu with the constants of `variant`
    ("NAME=VALUE,...")."""
    from ffmpeg_hybrid_tpu_torch import _build
    from ffmpeg_hybrid_tpu_torch.ops import recon_cuda as RC
    with open(os.path.join(_build.CSRC_DIR, "intra.cu")) as f:
        src = f.read()
    for item in filter(None, variant.split(",")):
        name, value = item.split("=")
        src, n = re.subn(rf"constexpr int {name} = [^;]+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"csrc/intra.cu has no constant {name}")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    stem = os.path.join(_build.BUILD_DIR, f"intra_ab_{tag}")
    with open(stem + ".cu", "w") as f:
        f.write(src)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                    stem + ".so", stem + ".cu"], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(stem + ".so")
    lib.intra_scan.argtypes = RC._SIGNATURES["intra.cu"]["intra_scan"]
    lib.intra_scan.restype = ctypes.c_int
    return lib


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants",
                    default="kLogCluster=0;kLogCluster=1;kLogCluster=2",
                    help="';'-separated builds, each 'NAME=VALUE,...'")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("intra_ab_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ffmpeg_hybrid_tpu_torch import _build
    from ffmpeg_hybrid_tpu_torch.ops import recon as R
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    calls = {clip: capture(torch, clip) for clip in CLIPS}
    wants = {clip: [R._intra_scan_plain(*job, bpp) for job in jobs]
             for clip, (jobs, bpp) in calls.items()}
    thin = {clip: [thinned(torch, job) for job in jobs]
            for clip, (jobs, _bpp) in calls.items()}
    variants = args.variants.split(";")
    libs = {v: build(v, i) for i, v in enumerate(variants)}
    runs = {v: [] for v in variants}
    for c in variants + variants[::-1]:
        _build._LIBS["intra.cu"] = libs[c]
        run = {}
        for clip, (jobs, bpp) in calls.items():
            for out, want in zip(R._intra_scan_planes(jobs, bpp),
                                 wants[clip]):
                if not torch.equal(out, want):
                    raise RuntimeError(f"variant '{c}' on {clip}: "
                                       "kernel != plain")
            run[clip] = {
                "ms": cuda_ms(torch, lambda: R._intra_scan_planes(jobs, bpp),
                              args.reps),
                "us_per_level_alone": [
                    cuda_ms(torch, lambda: R._intra_scan(*job, bpp),
                            args.reps) * 1e3 / job[3] for job in jobs],
                "us_per_level_thin": [
                    cuda_ms(torch, lambda: R._intra_scan(*job, bpp),
                            args.reps) * 1e3 / job[3]
                    for job in thin[clip]]}
        runs[c].append(run)
    _build._LIBS.pop("intra.cu", None)
    report = {"card": card, "torch": torch.__version__,
              "levels": {clip: [job[3] for job in jobs]
                         for clip, (jobs, _b) in calls.items()},
              "pixels_per_level": {
                  clip: [int(job[0].numel()) / job[3] for job in jobs]
                  for clip, (jobs, _b) in calls.items()},
              "runs": {v or "as it stands": runs[v] for v in variants}}
    print(json.dumps({"intra_ab": report}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
