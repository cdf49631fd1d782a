#!/usr/bin/env python3
"""What the port's device pass-A walk (csrc/passa.cu) costs on the clips'
own frames, and an A/B of its builds, on one CUDA card.

Inputs: each frame's walk inputs as the decoder hands them over
(prep_keyframe or prep_inter after the native pass A of the frames
before it): bench_1080p_lf frame 0, fmt_444_1080p frame 0, bench_1080p
frames 1 and 6, bench_4k frame 1, resize_1080p frames 3 and 4, and
frame 2 of fmt_inter_422_1080p, 3 of fmt_inter_440_1080p, 1 of
fmt_inter_444_1080p, 2 of fmt_inter_420_10_1080p and 1 of
fmt_inter_444_12_1080p (the frames PERF.md's PR 17, 18 and 21 entries
time). Builds every variant
at once, one nvcc each: an empty variant is the source as it stands,
"@PATH" another source as it stands, such as a parent commit's unpacked
beside the repository (git show <parent>:ffmpeg_hybrid_tpu_torch/csrc/
passa.cu > build/old/passa.cu before the chip call: the chip's copy has
no .git). A source without the `sections` argument has the first
design's interface (the scan, neighbour and band tables as separate
arrays in device memory), which this tool calls as that design's
launcher did. Then, for each build in turns (a b b a), holds every
frame's outputs to decode_frame_plain's (records, pairs in order,
counts, err words, bools a lane and, on inter frames, the grids) and
times the walk under CUDA events (the wrapper's uploads included, as
chip_smoke.py times it); the longest lane's clock64 cycles a bool and
the MV quanta's cycles an inter block come from the kernel's own stats,
and, for a build with sections, each lane's debug sections from a call
of the instance that times them (ops/passa_device.py SECTIONS), its
outputs held to the kernel's. With --quick it
only holds each build to the plain walk on the small clips
(vectors/passa_*) and the first frame, untimed: a first call of a new
source. Prints one JSON object (with ptxas's registers, stack and
spills of each build's kernels) and writes it to --out.

    python3 tools/passa_ab_torch.py [--variants ";@build/old/passa.cu"]
        [--reps 3] [--quick] [--out passa_ab.json]
"""
import argparse
import copy
import ctypes
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (clip, frame) of the timed inputs
FRAMES = (("bench_1080p_lf", 0), ("fmt_444_1080p", 0), ("bench_1080p", 1),
          ("bench_1080p", 6), ("bench_4k", 1), ("resize_1080p", 3),
          ("resize_1080p", 4), ("fmt_inter_422_1080p", 2),
          ("fmt_inter_440_1080p", 3), ("fmt_inter_444_1080p", 1),
          ("fmt_inter_420_10_1080p", 2), ("fmt_inter_444_12_1080p", 1))
# the first design's passa_walk: no sections argument
_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_SIGNATURE = [_P] * 14 + [_I] * 17 + [_P] * 11 + [_P]


def source_of(v):
    from ffmpeg_hybrid_tpu_torch import _build
    path = os.path.join(ROOT, v[1:]) if v.startswith("@") else \
        os.path.join(_build.CSRC_DIR, "passa.cu")
    with open(path) as f:
        return f.read()


def ptxas_lines(log):
    """{entry function: its ptxas lines (stack, spills, registers)}."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = m.group(1)
            out[cur] = []
        elif cur and ("registers" in ln or "spill" in ln or "stack" in ln):
            out[cur].append(ln.split("ptxas info    :")[-1].strip())
    return out


def build(variants):
    """{variant: (library, its interface: 'sections' or 'first', ptxas)},
    nvcc started for every variant at once."""
    from ffmpeg_hybrid_tpu_torch import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for i, v in enumerate(variants):
        src = source_of(v)
        stem = os.path.join(_build.BUILD_DIR, f"passa_ab_{i}")
        with open(stem + ".cu", "w") as f:
            f.write(src)
        kind = "sections" if "long long* sections" in src else "first"
        procs[v] = (stem, kind, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
             "-o", stem + ".so", stem + ".cu"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for v, (stem, kind, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc of variant '{v}' failed:\n{log}")
        lib = ctypes.CDLL(stem + ".so")
        libs[v] = (lib, kind, ptxas_lines(log))
    return libs


def first_design_launch(torch, lib, inputs, meta, dev):
    """The first design's launcher (ops/passa_device.py _launch before
    the packed tables): the scan and neighbour tables [20, 1024] int16,
    the bands [4, 1024] uint8 in device memory, no sections."""
    import numpy as np
    from ffmpeg_hybrid_tpu_torch.ops import passa_device as PD
    lib.passa_walk.argtypes = OLD_SIGNATURE
    lib.passa_walk.restype = ctypes.c_int
    S = meta["S"]
    inter = int(bool(meta.get("inter")))
    caps = PD.lane_caps(inputs, meta)
    bcap, ccap, ecap = (int(np.max(c)) for c in caps)
    b = np.ascontiguousarray(inputs["bounds"], np.int32)
    sc, nb = PD._scans_i32()
    t = {k: torch.as_tensor(a, device=dev) for k, a in dict(
        packet=inputs["packet"],
        tile_off=np.asarray(inputs["tile_off"], np.int64),
        tile_len=np.asarray(inputs["tile_len"], np.int32), bounds=b,
        caps=np.stack([np.asarray(c, np.int32) for c in caps], 1),
        p8=PD.probs8(inputs), qmul=np.asarray(inputs["qmul"], np.int32),
        scans=sc.astype(np.int16), nbs=nb.astype(np.int16),
        bands=PD._BANDS.astype(np.uint8)).items()}
    i32 = torch.int32
    outs = [torch.empty((S, bcap, 34), dtype=i32, device=dev),
            torch.empty(S, dtype=i32, device=dev),
            torch.empty((S, ccap, 2), dtype=i32, device=dev),
            torch.empty(S, dtype=i32, device=dev),
            torch.empty((S, ecap, 2), dtype=i32, device=dev),
            torch.empty(S, dtype=i32, device=dev),
            torch.empty((S, PD.CNT_TOTAL), dtype=i32, device=dev),
            torch.empty(S, dtype=i32, device=dev),
            torch.empty((S, 3), dtype=torch.int64, device=dev)]
    prev, grids, hflags = (None, None, None), [None, None], None
    if inter:
        prev = tuple(None if g is None else torch.as_tensor(
            np.ascontiguousarray(g, dt), device=dev)
            for g, dt in zip(inputs["prev_grids"],
                             (np.int16, np.int8, np.uint8)))
        mv_shape, ref_shape = PD.grid_shapes(meta)
        grids = [torch.zeros(mv_shape, dtype=torch.int16, device=dev),
                 torch.full(ref_shape, -1, dtype=torch.int8, device=dev)]
        hflags = np.ascontiguousarray(inputs["aux"]["hflags"], np.int32)

    def ptr(a):
        return None if a is None else a.data_ptr()
    rc = lib.passa_walk(
        ptr(t["packet"]), ptr(t["tile_off"]), ptr(t["tile_len"]),
        ptr(t["bounds"]), ptr(t["caps"]), ptr(t["p8"]), ptr(t["qmul"]),
        ptr(t["scans"]), ptr(t["nbs"]), ptr(t["bands"]),
        *(ptr(a) for a in prev),
        hflags.ctypes.data if inter else None, int(t["p8"].numel()), S,
        meta["rows"], meta["cols"], meta["sb_cols"], meta["sb_rows"],
        meta["txfmmode"], meta["seg"], meta["lossless"], meta["bpp"],
        meta["ss_h"], meta["ss_v"], meta["want_counts"], inter, bcap, ccap,
        ecap, *(ptr(o) for o in outs), *(ptr(g) for g in grids),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"passa_walk: CUDA error {rc}")
    return tuple(outs) + (tuple(grids) if inter else ())


def caller(torch, libs, v, dev):
    """(walk(inputs, meta) -> outputs, sections(inputs, meta) -> [S, K]
    or None) for variant v."""
    from ffmpeg_hybrid_tpu_torch import _build
    from ffmpeg_hybrid_tpu_torch.ops import passa_device as PD
    lib, kind, _ptx = libs[v]
    if kind == "first":
        return (lambda i, m: first_design_launch(torch, lib, i, m, dev),
                None)
    for name, argtypes in PD._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int

    def walk(i, m):
        _build._LIBS["passa.cu"] = lib
        return PD._launch(i, m, dev)

    def sections(i, m):
        _build._LIBS["passa.cu"] = lib
        return PD.decode_frame_sections(i, m, dev)
    return walk, sections


def frame_inputs(cs, name, i):
    """The walk's inputs of frame i of clip `name`, after the native pass
    A of frames 0..i, copied: a decoder's arrays lie in a pool that
    another decoder of the same geometry reuses."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu_torch.ops import passa_device as PD
    frames, _want = cs.read_clip(name)
    dec = VP9Decoder(device="cuda")
    for fd in frames[:i + 1]:
        dec.decode_pass_a(fd)
    return copy.deepcopy(cs.prep_frame(PD, dec, frames[i]))


def small_inputs(cs):
    """Every frame the passa phase holds to the plain walk on the small
    clips (vectors/passa_*), the counts forced on for the inter clips."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu_torch.ops import passa_device as PD
    out = []
    for name in cs.PASSA_CLIPS + cs.PASSA_INTER_CLIPS:
        frames, _want = cs.read_clip(name)
        dec = VP9Decoder(device="cuda")
        for k, fd in enumerate(frames):
            if dec.decode_pass_a(fd).ready is not None:
                continue
            inputs, meta = copy.deepcopy(cs.prep_frame(PD, dec, fd))
            if name in cs.PASSA_INTER_CLIPS:
                meta["want_counts"] = 1
            elif not (dec.header.keyframe or dec.header.intraonly):
                continue
            out.append((f"{name}_{k}", inputs, meta))
    return out


def measure(np, torch, cs, walk, sections, inputs, meta, reps):
    """One build's figures on one frame."""
    from ffmpeg_hybrid_tpu_torch.ops import passa_device as PD
    got = cs.walk_host(walk(inputs, meta))
    ms = cs.cuda_ms(lambda: walk(inputs, meta), reps)
    bools, cycles, mv = got[8][:, 0], got[8][:, 1], got[8][:, 2]
    S = meta["S"]
    inter_blocks = sum(int((got[0][s, :int(got[1][s]), 6] == 0).sum())
                       for s in range(S))
    longest = int(np.argmax(cycles))
    row = {"ms": ms, "bools": bools.tolist(), "cycles": cycles.tolist(),
           "longest_lane_cycles_a_bool":
               float(cycles[longest]) / max(int(bools[longest]), 1),
           "mv_cycles_a_block": float(mv.sum()) / max(inter_blocks, 1),
           "inter_blocks": inter_blocks}
    if sections is not None:
        out, sec = sections(inputs, meta)
        diff = cs.walk_diff(np, cs.walk_host(out), got, S)
        if diff:
            raise RuntimeError(f"the sections instance against the kernel: "
                               f"{diff}")
        row["sections"] = [dict(zip(PD.SECTIONS, (int(v) for v in r)))
                           for r in sec]
    return got, row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=";@build/old/passa.cu",
                    help="';'-separated builds: '' (the source as it "
                         "stands) or '@PATH'")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("passa_ab_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ffmpeg_hybrid_tpu_torch import _build
    from ffmpeg_hybrid_tpu_torch.ops import passa_device as PD
    t0 = time.perf_counter()
    variants = args.variants.split(";")
    libs = build(variants)
    dev = torch.device("cuda", torch.cuda.current_device())
    callers = {v: caller(torch, libs, v, dev) for v in variants}
    report = {"card": cs.card_line(), "torch": torch.__version__,
              "ptxas": {v or "as it stands": libs[v][2] for v in variants},
              "runs": {v or "as it stands": [] for v in variants}}
    cases = small_inputs(cs)
    frames = FRAMES[:1] if args.quick else FRAMES
    wants = {}
    for name, i in frames:
        inputs, meta = frame_inputs(cs, name, i)
        cases.append((f"{name}_{i}", inputs, meta))
    for key, inputs, meta in cases:
        t = time.perf_counter()
        wants[key] = cs.walk_host(PD.decode_frame_plain(inputs, meta))
        print(f"[passa_ab] plain walk {key}: "
              f"{(time.perf_counter() - t) * 1e3:.1f} ms", flush=True)
    timed = {f"{n}_{i}" for n, i in frames}
    for turn, order in enumerate((variants, variants[::-1])):
        for v in order:
            walk, sections = callers[v]
            run = {}
            for key, inputs, meta in cases:
                if turn and key not in timed:
                    continue
                if key in timed and not args.quick:
                    got, row = measure(np, torch, cs, walk, sections, inputs,
                                       meta, args.reps)
                    run[key] = row
                else:
                    got = cs.walk_host(walk(inputs, meta))
                diff = cs.walk_diff(np, got, wants[key], meta["S"])
                if diff or got[7].any():
                    raise RuntimeError(f"variant '{v}' on {key}: the kernel "
                                       "against decode_frame_plain: "
                                       f"{diff or got[7]}")
            report["runs"][v or "as it stands"].append(run)
            print(f"[passa_ab] turn {turn} '{v}': {len(cases)} inputs "
                  "exact" + "".join(f"; {k} {r['ms']:.3f} ms"
                                    for k, r in run.items()), flush=True)
    _build._LIBS.pop("passa.cu", None)
    report["checked"] = [k for k, _i, _m in cases]
    report["seconds"] = time.perf_counter() - t0
    print(json.dumps({"passa_ab": report}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
