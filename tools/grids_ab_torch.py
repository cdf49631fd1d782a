#!/usr/bin/env python3
"""What the port's splat (csrc/splat.cu) and loop-filter grids
(csrc/lf_grids.cu) kernels cost, and an A/B of their builds, on one
CUDA card.

Captures the inputs that recon_frame hands the two kernels: the
splat's records of bench_1080p frames 0-1, bench_1080p_lf frame 0 and
bench_4k frame 1 (an inter frame), and the grids' levels and masks of
bench_1080p_lf frame 0 and bench_4k frame 0 (its filtered keyframe).
Builds every variant of each kernel at once: "NAME=VALUE,..." rewrites
`constexpr int NAME = VALUE;` in a copy, "@PATH" builds another source
as it stands (an earlier commit's, unpacked beside the repository; a
splat source named so must have the C interface of the splat before its
index grid kept an epoch: an int32 index grid that the call sets with a
memset), "-PART,..." drops parts of the splat's work (DROP: the index
launch's, the gather launch's) to show what they cost, and
an empty variant is the source as it stands. Then, for each build in
turns (a b c c b a), holds every input against the plain version (not
the builds that drop work) and times the kernel on the card's clock
(chip_smoke.device_ms: the union of its device ops' intervals, 50
launches) with its device ops per call; and, each turn, the empty
kernel's time, the launch floor. Prints one JSON object and writes it
to --out.

    python3 tools/grids_ab_torch.py [--reps 50] [--out grids_ab.json]
        [--splat ";kGroup=4;@old/splat.cu;-index"]
        [--grids ";kSbRun=1;kThreads=128;@old/lf_grids.cu"]
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# part: the edits of csrc/splat.cu that drop it. index: the index
# launch's work (every cell reads the last row); gather: the gather
# launch's work
DROP = {
    "index": [("  index_phase(a);\n", "")],
    "gather": [("    gather_cell(a, idx);", "    (void)idx;")],
}
SOURCES = {"splat": "splat.cu", "grids": "lf_grids.cu"}
# the device ops each kernel's time counts
NAMES = {"splat": ("splat_", "Memset"), "grids": ("lf_grids_kernel",)}


def variant_source(kernel, v):
    """The source text of variant v of kernel ('splat' or 'grids')."""
    from ffmpeg_hybrid_tpu_torch import _build
    if v.startswith("@"):
        with open(os.path.join(ROOT, v[1:])) as f:
            return f.read()
    with open(os.path.join(_build.CSRC_DIR, SOURCES[kernel])) as f:
        src = f.read()
    if v.startswith("-"):
        for part in v[1:].split(",-"):
            for a, b in DROP[part]:
                if src.count(a) != 1:
                    raise RuntimeError(f"{SOURCES[kernel]}: cannot drop "
                                       f"{part}")
                src = src.replace(a, b)
        return src
    for item in filter(None, v.split(",")):
        name, value = item.split("=")
        src, n = re.subn(rf"constexpr int {name} = [^;]+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"{SOURCES[kernel]} has no constant {name}")
    return src


def build(variants):
    """{(kernel, variant): (library, ptxas lines)}, nvcc started for
    every build at once; variants: [(kernel, variant)]."""
    from ffmpeg_hybrid_tpu_torch import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for i, (kernel, v) in enumerate(variants):
        stem = os.path.join(_build.BUILD_DIR, f"grids_ab_{kernel}_{i}")
        with open(stem + ".cu", "w") as f:
            f.write(variant_source(kernel, v))
        procs[kernel, v] = (stem, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", stem + ".so",
             stem + ".cu"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (stem, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc of {key} failed:\n{log}")
        libs[key] = (ctypes.CDLL(stem + ".so"),
                     [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln])
    return libs


def old_splat(torch, lib, recs, r4, c4, ss_h, ss_v):
    """The 14 grids from a splat library of the earlier interface
    (records, N, an int32 index grid the call clears, the grids, the
    geometry, the tables, the stream)."""
    from ffmpeg_hybrid_tpu_torch.ops import recon_cuda as RC
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.splat.argtypes = [P, I, P] + [P] * len(RC._SPLAT_GRIDS) \
        + [I] * 4 + [P, P, P]
    lib.splat.restype = ctypes.c_int
    planes = ((r4, c4), (r4 >> ss_v, c4 >> ss_h))
    outs = [torch.empty(planes[uv] + trail, dtype=dt, device=recs.device)
            for dt, uv, trail in RC._SPLAT_GRIDS]
    bidx = torch.empty(r4 * c4, dtype=torch.int32, device=recs.device)
    rc = lib.splat(recs.data_ptr(), recs.shape[0], bidx.data_ptr(),
                   *(o.data_ptr() for o in outs), r4, c4, ss_h, ss_v,
                   RC._SPLAT_BWH.ctypes.data, RC._SPLAT_ITT.ctypes.data,
                   torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"splat: CUDA error {rc}")
    return outs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--splat", default=";kGroup=4;kThreads=128",
                    help="';'-separated builds of csrc/splat.cu")
    ap.add_argument("--grids", default=";kSbRun=1;kThreads=128",
                    help="';'-separated builds of csrc/lf_grids.cu")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("grids_ab_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ffmpeg_hybrid_tpu_torch import _build
    from ffmpeg_hybrid_tpu_torch.ops import lpf_masks as LM
    from ffmpeg_hybrid_tpu_torch.ops import recon as R
    from ffmpeg_hybrid_tpu_torch.ops import recon_cuda as RC
    variants = {"splat": args.splat.split(";"),
                "grids": args.grids.split(";")}
    empty_build = cs.start_empty_build()
    libs = build([(k, v) for k, vs in variants.items() for v in vs])
    empty = cs.load_empty(empty_build)
    targets = [(R, "_grids_from_records"), (LM, "grids_device")]
    got = {c: cs.capture_inputs(torch, targets, cs.read_clip(c)[0][:n])
           for c, n in (("bench_1080p", 2), ("bench_1080p_lf", 1),
                        ("bench_4k", 2))}
    splat_in = {"bench_1080p_0": got["bench_1080p"]["_grids_from_records"][0],
                "bench_1080p_1": got["bench_1080p"]["_grids_from_records"][1],
                "bench_1080p_lf_0":
                    got["bench_1080p_lf"]["_grids_from_records"][0],
                "bench_4k_1": got["bench_4k"]["_grids_from_records"][1]}
    grids_in = {"bench_1080p_lf_0": got["bench_1080p_lf"]["grids_device"][0],
                "bench_4k_0": got["bench_4k"]["grids_device"][0]}
    del got
    wants = {("splat", k): R._grids_from_records_plain(*a)
             for k, a in splat_in.items()}
    wants.update({("grids", k): LM.grids_device_plain(*a)
                  for k, a in grids_in.items()})

    def caller(kernel, v, a):
        lib = libs[kernel, v][0]
        if kernel == "splat" and v.startswith("@"):
            return lambda: old_splat(torch, lib, *a)
        source = SOURCES[kernel]
        sigs = RC._SIGNATURES["splat.cu"] if kernel == "splat" \
            else LM._SIGNATURES
        for name, argtypes in sigs.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int

        states = {}     # the splat's index state, kept across the calls

        def call():
            _build._LIBS[source] = lib
            return (R._grids_from_records(*a, states) if kernel == "splat"
                    else LM.grids_device(*a))
        return call

    runs = {k: {v: [] for v in vs} for k, vs in variants.items()}
    floors = []
    for turn in (0, 1):
        floors.append(cs.launch_floor_ms(torch, empty, args.reps))
        for kernel, vs in variants.items():
            inputs = splat_in if kernel == "splat" else grids_in
            for v in (vs if turn == 0 else vs[::-1]):
                run = {}
                for k, a in inputs.items():
                    fn = caller(kernel, v, a)
                    for out, want in zip(fn(), wants[kernel, k]):
                        if not v.startswith("-") and not torch.equal(out,
                                                                     want):
                            raise RuntimeError(f"{kernel} variant '{v}' on "
                                               f"{k}: kernel != plain")
                    ms, ops = cs.device_ms(torch, fn, args.reps,
                                           NAMES[kernel])
                    run[k] = {"ms": ms, "device_ops": ops}
                runs[kernel][v].append(run)
        floors.append(cs.launch_floor_ms(torch, empty, args.reps))
    for source in SOURCES.values():
        _build._LIBS.pop(source, None)
    report = {"card": cs.card_line(), "torch": torch.__version__,
              "launch_floor_ms": floors,
              "splat_inputs": {k: [tuple(a[0].shape), *a[1:]]
                               for k, a in splat_in.items()},
              "grids_inputs": {k: list(a[3:]) for k, a in grids_in.items()},
              "ptxas": {k: {v or "as it stands": libs[k, v][1] for v in vs}
                        for k, vs in variants.items()},
              "runs": {k: {v or "as it stands": r for v, r in rs.items()}
                       for k, rs in runs.items()}}
    print(json.dumps({"grids_ab": report}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
