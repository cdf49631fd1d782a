#!/usr/bin/env python3
"""An A/B of builds of the port's record-replay loop filter
(csrc/lpf_replay.cu) and plane digest (csrc/digest.cu) on one CUDA card.

Inputs, as the decoder hands them over: the replay's sharded inputs of
bench_1080p_lf frame 0 (four stripes) and bench_4k frame 0 (eight), Y and
U+V (captured from sharded_decode_pass_b, as chip_smoke.py's sharded
phase captures them), the same frames' serial schedule through one
stripe, and the median Y and U+V bands of chained_1080p's first chained
frame in the stripe pipeline (parallel/gop_pipeline.py, one lane); the
digest on the three visible planes of fmt_inter_444_12_1080p's last frame.

Variants: "" is a source as it stands, "@PATH" another source as it
stands, such as a parent commit's unpacked beside the repository (git
show <parent>:ffmpeg_hybrid_tpu_torch/csrc/lpf_replay.cu >
build/old/lpf_replay.cu, and digest.cu likewise, before the chip call:
the chip's copy has no .git). Every variant of both sources is built at
once, one nvcc each. A replay source without the tickets (the first
design: steps [T, S, D, 7] on the card, one block a stripe in a cluster)
and a digest source without the scratch (the first design: a memset and
a launch a plane) are called as their launchers called them; the others
through the port's wrappers with the variant's library in place. Each
variant's outputs are held to the plain versions (lf_scan_sharded_plain,
lf_scan_plain, plane_digest_plain), then every input is timed in turns
(a b b a): the replay under CUDA events, the tickets built (and the
first design's steps uploaded) before the timed launches; the digest on
the card's clock (chip_smoke.py's device_ms: its kernels and memsets
under torch.profiler, their device ops counted) and under CUDA events
(the wrapper's host work included). Prints one JSON object (with
ptxas's registers, stack and spills of each build) and writes it to --out.

    python3 tools/lpf_replay_ab_torch.py
        [--replay ";@build/old/lpf_replay.cu"]
        [--digest ";@build/old/digest.cu"] [--reps 20]
        [--out lpf_replay_ab.json]
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_P, _I = ctypes.c_void_p, ctypes.c_int
# the first designs' entries
OLD_REPLAY = [_P, _P, _P] + [_I] * 9 + [_P]
OLD_DIGEST = [_P, ctypes.c_longlong, _I, _I, _P, _P]
DIGEST_CLIP = "fmt_inter_444_12_1080p"


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
    """{(source, variant): (library, first design?, ptxas)}, nvcc started
    for every variant at once."""
    from ffmpeg_hybrid_tpu_torch import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for i, (source, v) in enumerate(variants):
        path = os.path.join(ROOT, v[1:]) if v.startswith("@") else \
            os.path.join(_build.CSRC_DIR, source)
        with open(path) as f:
            src = f.read()
        first = ("tickets" not in src if source == "lpf_replay.cu"
                 else "scratch" not in src)
        stem = os.path.join(_build.BUILD_DIR, f"lpf_replay_ab_{i}")
        with open(stem + ".cu", "w") as f:
            f.write(src)
        procs[(source, v)] = (stem, first, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
             "-o", stem + ".so", stem + ".cu"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (stem, first, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc of {key} failed:\n{log}")
        libs[key] = (ctypes.CDLL(stem + ".so"), first, ptxas_lines(log))
    return libs


def install(lib, source, signatures):
    """The variant's library as the port's wrappers' own."""
    from ffmpeg_hybrid_tpu_torch import _build
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _build._LIBS[source] = lib


def replay_inputs(np, torch, cs):
    """[(key, buffers, steps, wreal, bpp, sb, halo)]: the sharded inputs
    of bench_1080p_lf and bench_4k frame 0, their serial schedule (one
    stripe, no halo), and the median bands of the stripe pipeline."""
    from ffmpeg_hybrid_tpu_torch.ops import lpf_replay as LR
    from ffmpeg_hybrid_tpu_torch.parallel import gop_pipeline as GP
    from ffmpeg_hybrid_tpu_torch.parallel.mesh import make_mesh
    captured, real = {}, LR.lf_scan_sharded

    def capture(clip):
        def wrapped(pl, steps, wreal, bpp, sb):
            sets = captured.setdefault(clip, [])
            if len(sets) < 2:
                sets.append((pl.clone(), np.array(steps), list(wreal), bpp,
                             tuple(sb)))
            return real(pl, steps, wreal, bpp, sb)
        return wrapped
    for clip, ntile in (("bench_1080p_lf", 4), ("bench_4k", 8)):
        frames, want = cs.read_clip(clip)
        LR.lf_scan_sharded = capture(clip)
        try:
            cs.sharded_run(torch, clip, frames[:1], want[:1], (1, ntile))
        finally:
            LR.lf_scan_sharded = real
    out = []
    for clip, sets in captured.items():
        for which, (buf, steps, wreal, bpp, sb) in zip(("Y", "U+V"), sets):
            out.append((f"{clip} {which} sharded", buf, steps, wreal, bpp,
                        sb, True))
            x0 = np.concatenate([[0], np.cumsum(wreal)[:-1]])
            joined = torch.cat([buf[t, :, :, LR.HALO:LR.HALO + w]
                                for t, w in enumerate(wreal)], dim=2)
            out.append((f"{clip} {which} serial", joined[None].contiguous(),
                        cs.serial_steps(np, steps, x0, LR.HALO)[None],
                        [joined.shape[-1]], bpp, sb, False))
    packets, _want = cs.read_clip(cs.CHAINED_CLIP)
    mesh = make_mesh(cs.PIPE_G, cs.PIPE_G)
    (oy, ou, ov), jobs = GP.decode_chained_gop(packets, mesh, cs.PIPE_HS,
                                               cs.PIPE_LAG)
    _run, frames, _ref0, _jobs = GP.prepare_chained_gop(
        packets, mesh, cs.PIPE_HS, cs.PIPE_LAG)
    bpp = jobs[0].header.bpp
    for which, Hp, planes, sb in (("ysteps", cs.PIPE_HS, (oy,), (64, 64)),
                                  ("uvsteps", cs.PIPE_HS >> 1, (ou, ov),
                                   (32, 32))):
        live = [(s.steps.shape[1], j, s) for j, s in
                enumerate(frames[0][which]) if s is not None]
        _n, j, s = sorted(live, key=lambda t: t[0])[len(live) // 2]
        y0, y1 = max(j * Hp - 8, 0), (j + 1) * Hp
        pl = torch.stack([p[0][y0:y1] for p in planes])[None].contiguous()
        out.append((f"{cs.CHAINED_CLIP} band {j} "
                    f"{'Y' if which == 'ysteps' else 'U+V'}", pl, s.steps,
                    [pl.shape[-1]], bpp, sb, False))
    return out


def replay_caller(torch, np, lib, first, case):
    """A callable that replays the case's steps on a copy of its buffers
    through lib, its inputs made on the card first; and its records."""
    from ffmpeg_hybrid_tpu_torch.ops import lpf_replay as LR
    _key, buf, steps, wreal, bpp, sb, halo = case
    T, B, H, Wb = buf.shape
    nrec = int((np.asarray(steps)[..., 3] > 0).sum())
    if first:
        lib.lf_replay.argtypes = OLD_REPLAY
        lib.lf_replay.restype = ctypes.c_int
        run = LR.steps_run(steps)
        S = max(run, 1)
        sdev = torch.from_numpy(np.ascontiguousarray(
            np.asarray(steps)[:, :S], np.int32)).cuda()
        wr = np.asarray(wreal, np.int32)

        def call(work):
            rc = lib.lf_replay(work.data_ptr(), sdev.data_ptr(),
                               wr.ctypes.data, T, B, H, Wb, S,
                               sdev.shape[2], run, int(halo), bpp,
                               torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"lf_replay: CUDA error {rc}")
        return call, nrec
    install(lib, "lpf_replay.cu", LR._SIGNATURES)
    rp = LR.Replay(steps, buf.shape, sb, wreal, LR.HALO if halo else 0,
                   halo)
    rp.tables(buf.device)

    def call(work):
        if halo:
            LR.lf_scan_sharded(work, rp, wreal, bpp, sb)
        else:
            LR._launch(work, rp, bpp)
    return call, nrec


def digest_caller(torch, lib, first, planes):
    """A callable that digests the three planes through lib -> [3, 2]."""
    from ffmpeg_hybrid_tpu_torch.utils import digest as DG
    if first:
        lib.plane_digest.argtypes = OLD_DIGEST
        lib.plane_digest.restype = ctypes.c_int

        def call():
            out = torch.empty((3, 2), dtype=torch.int32, device="cuda")
            for k, p in enumerate(planes):
                rc = lib.plane_digest(p.data_ptr(), p.stride(0),
                                      p.shape[0], p.shape[1],
                                      out[k].data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"plane_digest: CUDA error {rc}")
            return out
        return {"a launch a plane": call}
    install(lib, "digest.cu", DG._SIGNATURES)
    crops = [tuple(p.shape) for p in planes]
    return {"a launch a plane": lambda: torch.stack(
        [DG.plane_digest_dev_async(p, *p.shape) for p in planes]),
        "one launch": lambda: DG.frame_digest_dev_async(planes, crops)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--replay", default=";@build/old/lpf_replay.cu",
                    help="';'-separated builds of lpf_replay.cu: '' (the "
                         "source as it stands) or '@PATH'")
    ap.add_argument("--digest", default=";@build/old/digest.cu",
                    help="the same for digest.cu")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("lpf_replay_ab_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ffmpeg_hybrid_tpu_torch import _build
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu_torch.ops import lpf_replay as LR
    from ffmpeg_hybrid_tpu_torch.utils import digest as DG
    t0 = time.perf_counter()
    rv = [("lpf_replay.cu", v) for v in args.replay.split(";")]
    dv = [("digest.cu", v) for v in args.digest.split(";")]
    libs = build(rv + dv)
    name = (lambda key: f"{key[0]} {key[1] or 'as it stands'}")
    report = {"card": cs.card_line(), "torch": torch.__version__,
              "ptxas": {name(k): libs[k][2] for k in rv + dv},
              "runs": {name(k): [] for k in rv + dv}}
    _build.build_all()
    cases = replay_inputs(np, torch, cs)
    wants = {}
    for case in cases:
        key, buf, steps, wreal, bpp, _sb, halo = case
        wants[key] = (LR.lf_scan_sharded_plain(buf.cpu(), steps, wreal, bpp)
                      if halo else LR.lf_scan_plain(buf[0].cpu(), steps[0],
                                                    bpp)[None])
    frames, _want = cs.read_clip(DIGEST_CLIP)
    last = list(VP9Decoder(device="cuda").decode_stream(iter(frames)))[-1]
    w, h = last.size
    cw, ch = (w + last.ss_h) >> last.ss_h, (h + last.ss_v) >> last.ss_v
    planes = [p[:ph, :pw].clone() for p, (ph, pw) in
              zip(last.dev, ((h, w), (ch, cw), (ch, cw)))]
    dwant = torch.stack([DG.plane_digest_plain(p, *p.shape)
                         for p in planes])
    # turns a b b a over each source's variants
    for turn in range(4):
        for group, run_one in ((rv, "replay"), (dv, "digest")):
            order = group if turn in (0, 3) else group[::-1]
            for key in order:
                lib, first, _p = libs[key]
                row = {}
                if run_one == "replay":
                    for case in cases:
                        call, nrec = replay_caller(torch, np, lib, first,
                                                   case)
                        buf = case[1]
                        work = buf.clone()
                        call(work)
                        if not torch.equal(work.cpu(), wants[case[0]]):
                            raise RuntimeError(f"{name(key)} on {case[0]}: "
                                               "the kernel against the "
                                               "plain version")
                        copy_ms = cs.cuda_ms(lambda: work.copy_(buf),
                                             args.reps)
                        ms = cs.cuda_ms(lambda: (work.copy_(buf),
                                                 call(work)),
                                        args.reps) - copy_ms
                        row[case[0]] = {"ms": ms, "records": nrec,
                                        "us_per_record": ms * 1e3
                                        / max(nrec, 1)}
                    _build._LIBS.pop("lpf_replay.cu", None)
                else:
                    for entry, call in digest_caller(torch, lib, first,
                                                     planes).items():
                        if not torch.equal(call(), dwant):
                            raise RuntimeError(f"{name(key)} {entry}: the "
                                               "kernel against the plain "
                                               "version")
                        per = 3 if entry == "a launch a plane" else 1
                        dev_ms, ops = cs.device_ms(
                            torch, call, args.reps * 5,
                            ("digest_kernel", "Memset"), per_call=per,
                            kernel="digest_kernel")
                        row[entry] = {"ms": dev_ms, "device_ops": ops,
                                      "events_ms": cs.cuda_ms(
                                          call, args.reps * 5)}
                    _build._LIBS.pop("digest.cu", None)
                report["runs"][name(key)].append(row)
                print(f"[lpf_replay_ab] turn {turn} {name(key)}: exact; "
                      + "; ".join(f"{k} {r['ms']:.4f} ms"
                                  for k, r in row.items()), flush=True)
    report["inputs"] = [c[0] for c in cases]
    report["digest_planes"] = [tuple(p.shape) for p in planes]
    report["seconds"] = time.perf_counter() - t0
    print(json.dumps({"lpf_replay_ab": report}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
