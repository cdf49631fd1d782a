#!/usr/bin/env python3
"""An A/B, end to end, of the paths that run the port's record-replay
loop filter (csrc/lpf_replay.cu through ops/lpf_replay.py), between two
trees of the port on one CUDA card.

A tree is a directory that holds ffmpeg_hybrid_tpu_torch/ and native/:
"." is the repository as it stands, another a parent commit's unpacked
beside it (git archive <parent> ffmpeg_hybrid_tpu_torch native | tar -x
-C build/parent, made where the repository's .git is). Each
tree runs in a process of its own (its package first on sys.path, its
kernels built into its own build directory), in turns a b b a, on the
clips of this repository's vectors/:

- the sharded pass B (parallel/fullframe.py sharded_decode_pass_b) on
  every frame of bench_1080p_lf over a [1, 4] mesh and on the first
  frames of bench_4k over [1, 8]: after a warm-up pass of the clip, each
  frame's pass A untimed, then its pass B on the host's clock between
  two synchronisations, and inside it the replay's calls
  (lf_scan_sharded, a synchronisation before and after each) and, in a
  tree that has it, the host's ticket build (build_tickets); every
  frame's MD5 against the clip's framemd5;
- the rank mesh's replay (lf_scan_sharded_dist), as chip_smoke.py's
  mesh_mp phase times it alone: rank 0 of a 2+2 split of bench_1080p_lf
  frame 0's replay inputs (Y and U+V, captured from the sharded pass B)
  in this process, the swaps bringing back what was sent; its launches,
  their span under CUDA events and on the host's clock (the tickets of
  the segments built in it, in a tree that builds them), the median of
  --reps, and a hash of its stripes, equal across trees;
- the chained-GOP stripe pipeline (parallel/gop_pipeline.py) on
  chained_1080p (4 rows, stripes of 64 rows, lag 2): its preparation
  (prepare_chained_gop: keyframe, pass A, each frame's pass-B inputs and,
  in a tree that builds them there, the bands' tickets) on the host's
  clock, twice, and its run under CUDA events, the median of --reps after
  a warm-up; the run's output planes hashed, equal across trees.

Prints one JSON object with the card's name and power limit and writes
it to --out.

    python3 tools/replay_paths_ab_torch.py [--trees ".;build/parent"]
        [--frames-4k 3] [--reps 5] [--out replay_paths_ab.json]
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VECTORS = os.path.join(ROOT, "vectors")
SHARDED = (("bench_1080p_lf", 4, None), ("bench_4k", 8, "frames_4k"))
CHAINED = "chained_1080p"
PIPE_G, PIPE_HS, PIPE_LAG = 4, 64, 2


def read_clip(name):
    """(frames of the clip, each a superframe's part; their framemd5s)."""
    from ffmpeg_hybrid_tpu_torch.formats.ivf import read_ivf
    from ffmpeg_hybrid_tpu_torch.formats.superframe import split_superframe
    frames = []
    for pts, data in read_ivf(os.path.join(VECTORS, name + ".ivf"))[1]:
        frames += [fd for _p, fd in split_superframe(data, pts)]
    with open(os.path.join(VECTORS, name + ".framemd5")) as f:
        want = [ln.split(",")[-1].strip() for ln in f
                if ln.strip() and not ln.startswith("#")]
    return frames, want


class Clock:
    """Seconds spent in fn's calls, the card synchronised around each
    when sync is set, as a wrapper of the same signature; with keep a
    list, the first two calls' replay inputs (buffers, steps, real
    widths, bpp, superblock or None) go on it."""

    def __init__(self, torch, fn, sync, keep=None):
        self.torch, self.fn, self.sync, self.s, self.calls = (
            torch, fn, sync, 0.0, 0)
        self.keep = keep

    def __call__(self, *args, **kw):
        if self.keep is not None and len(self.keep) < 2:
            import numpy as np
            self.keep.append((args[0].clone(), np.array(args[1]),
                              [int(w) for w in args[2]], args[3],
                              args[4] if len(args) > 4 else kw.get("sb")))
        if self.sync:
            self.torch.cuda.synchronize()
        t = time.perf_counter()
        out = self.fn(*args, **kw)
        if self.sync:
            self.torch.cuda.synchronize()
        self.s += time.perf_counter() - t
        self.calls += 1
        return out


def sharded(torch, clip, ntile, nframes, keep=None):
    """The sharded pass B of the clip's first nframes (None: all), a
    warm-up pass then a timed one: ms a frame of pass B, of the replay's
    calls and of the ticket build, each frame's, and whether every
    frame's MD5 is the framemd5's; frame 0's replay inputs go on keep."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu_torch.ops import lpf_replay as LR
    from ffmpeg_hybrid_tpu_torch.parallel import fullframe as PF
    from ffmpeg_hybrid_tpu_torch.parallel.mesh import make_mesh
    frames, want = read_clip(clip)
    frames = frames[:nframes] if nframes else frames
    mesh = make_mesh(ntile, 1)
    lf = Clock(torch, LR.lf_scan_sharded, True, keep)
    build = (Clock(torch, LR.build_tickets, False)
             if hasattr(LR, "build_tickets") else None)
    LR.lf_scan_sharded = lf
    if build:
        LR.build_tickets = build
    out = {}
    try:
        for label in ("warm-up", "timed"):
            dec = VP9Decoder(device="cuda")
            got, per = [], []
            for fd in frames:
                job = dec.decode_pass_a(fd)
                if job.ready is None:
                    lf0, b0 = lf.s, build.s if build else 0.0
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    planes = PF.sharded_decode_pass_b([job], mesh)[0]
                    torch.cuda.synchronize()
                    per.append({
                        "pass_b_ms": (time.perf_counter() - t) * 1e3,
                        "lf_ms": (lf.s - lf0) * 1e3,
                        "build_ms": ((build.s - b0) * 1e3 if build
                                     else None)})
                    PF.install(job, planes)
                got += [hashlib.md5(f.to_bytes()).hexdigest() for f in
                        (job.ready if job.ready is not None
                         else job.outputs)]
            out[label] = per
            out["exact"] = got == want[:len(got)]
    finally:
        LR.lf_scan_sharded = lf.fn
        if build:
            LR.build_tickets = build.fn
    per = out["timed"]
    mean = (lambda k: None if per[0][k] is None
            else sum(p[k] for p in per) / len(per))
    return {"frames": len(per), "exact": out["exact"],
            "pass_b_ms": mean("pass_b_ms"), "lf_ms": mean("lf_ms"),
            "build_ms": mean("build_ms"), "per_frame": per}


def segments(torch, captured, reps):
    """Rank 0's segments of a 2+2 split on the captured replay inputs,
    alone in this process (the swaps bring back what was sent): its
    launches, the median of reps of their span (CUDA events, ms) and of
    the host's wall ms, Y and U+V together, and a hash of its stripes."""
    import inspect
    from ffmpeg_hybrid_tpu_torch.ops import lpf_replay as LR
    from ffmpeg_hybrid_tpu_torch.parallel import dist as D

    class Own(D.HaloExchange):
        def swap(self, peer, send=None, like=None):
            self.exchanges += 1
            return None if like is None else like.clone()

    takes_sb = "sb" in inspect.signature(
        LR.lf_scan_sharded_dist).parameters
    ranks = [0, 0, 1, 1]
    spans, walls, launches, h = [], [], 0, hashlib.md5()
    for rep in range(reps + 1):
        span = wall = 0.0
        LR.reset_launches()
        for buf, steps, wreal, bpp, sb in captured:
            lo, hi, _c, _s = LR.segment_plan(steps, wreal, ranks, 0)
            work = buf[lo:hi].clone()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t = time.perf_counter()
            start.record()
            LR.lf_scan_sharded_dist(work, steps, wreal, bpp, ranks, Own(0),
                                    *((sb,) if takes_sb else ()))
            end.record()
            end.synchronize()
            wall += (time.perf_counter() - t) * 1e3
            span += start.elapsed_time(end)
            if rep == 0:
                h.update(work.cpu().numpy().tobytes())
        launches = LR.LAUNCHES["lf_replay"]
        if rep:
            spans.append(span)
            walls.append(wall)
    return {"launches": launches, "span_ms": sorted(spans)[reps // 2],
            "wall_ms": sorted(walls)[reps // 2], "spans_ms": spans,
            "stripes_md5": h.hexdigest()}


def pipeline(torch, reps):
    """The stripe pipeline on CHAINED: preparation ms a frame (two
    calls), the run's ms a frame (CUDA events, median of reps after a
    warm-up) and a hash of the run's planes."""
    from ffmpeg_hybrid_tpu_torch.parallel import gop_pipeline as GP
    from ffmpeg_hybrid_tpu_torch.parallel.mesh import make_mesh
    packets, _want = read_clip(CHAINED)
    mesh = make_mesh(PIPE_G, PIPE_G)
    prep = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run, frames, ref0, _jobs = GP.prepare_chained_gop(
            packets, mesh, PIPE_HS, PIPE_LAG)
        torch.cuda.synchronize()
        prep.append((time.perf_counter() - t) * 1e3 / PIPE_G)
    outs = run(frames, ref0)
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = run(frames, ref0)
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / PIPE_G)
    h = hashlib.md5()
    for g in range(PIPE_G):
        for p in outs[g]:
            h.update(p.cpu().numpy().tobytes())
    return {"prep_ms": prep, "run_ms": sorted(runs)[reps // 2],
            "runs_ms": runs, "planes_md5": h.hexdigest()}


def child(tree, frames_4k, reps):
    """One tree's measurements, as a JSON line on stdout."""
    sys.path.insert(0, tree)
    import torch
    from ffmpeg_hybrid_tpu_torch import _build
    t = time.perf_counter()
    _build.build_all()
    out = {"tree": tree, "build_s": time.perf_counter() - t}
    captured = []
    for clip, ntile, key in SHARDED:
        out[clip] = sharded(torch, clip, ntile,
                            frames_4k if key else None,
                            None if key else captured)
    out["mesh_segments"] = segments(torch, captured, reps)
    out[CHAINED] = pipeline(torch, reps)
    print("RESULT " + json.dumps(out), flush=True)


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", default=".;build/parent")
    ap.add_argument("--frames-4k", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="replay_paths_ab.json")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        child(a.child, a.frames_4k, a.reps)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("replay_paths_ab: needs a CUDA card")
    trees = [os.path.abspath(os.path.join(ROOT, t))
             for t in a.trees.split(";")]
    if len(trees) != 2:
        sys.exit("replay_paths_ab: two trees, a;b")
    t0 = time.perf_counter()
    runs = {t: [] for t in trees}
    for turn, tree in enumerate([trees[0], trees[1], trees[1], trees[0]]):
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree,
             "--frames-4k", str(a.frames_4k), "--reps", str(a.reps)],
            capture_output=True, text=True, cwd=ROOT)
        line = [ln for ln in p.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if p.returncode or not line:
            sys.exit(f"replay_paths_ab: {tree} failed (rc {p.returncode}):"
                     f"\n{p.stdout[-3000:]}\n{p.stderr[-6000:]}")
        r = json.loads(line[0][len("RESULT "):])
        runs[tree].append(r)
        print(f"[replay_paths_ab] turn {turn} {os.path.relpath(tree, ROOT)}"
              f": " + "; ".join(
                  f"{c} pass B {r[c]['pass_b_ms']:.3f} ms a frame (replay "
                  f"{r[c]['lf_ms']:.3f}, tickets "
                  + (f"{r[c]['build_ms']:.3f}" if r[c]["build_ms"]
                     is not None else "none")
                  + f"), exact {r[c]['exact']}" for c, _n, _k in SHARDED)
              + f"; rank 0's segments of bench_1080p_lf frame 0 "
              f"({r['mesh_segments']['launches']} launches) "
              f"{r['mesh_segments']['span_ms']:.3f} ms on the card, host "
              f"{r['mesh_segments']['wall_ms']:.3f}"
              + f"; {CHAINED} preparation "
              f"{[round(x, 3) for x in r[CHAINED]['prep_ms']]} ms a frame, "
              f"run {r[CHAINED]['run_ms']:.3f}", flush=True)
    bad = [t for t in trees for r in runs[t]
           if not all(r[c]["exact"] for c, _n, _k in SHARDED)]
    hashes = {(r[CHAINED]["planes_md5"], r["mesh_segments"]["stripes_md5"])
              for t in trees for r in runs[t]}
    out = {"replay_paths_ab": {
        "card": card(), "torch": torch.__version__,
        "trees": [os.path.relpath(t, ROOT) for t in trees],
        "runs": {os.path.relpath(t, ROOT): runs[t] for t in trees},
        "all_exact": not bad, "trees_equal": len(hashes) == 1,
        "seconds": time.perf_counter() - t0}}
    with open(a.out, "w") as f:
        json.dump(out, f)
    print(json.dumps(out))
    if bad or len(hashes) != 1:
        sys.exit("replay_paths_ab: a tree's frames are not bit-exact or "
                 "the trees' pipeline planes or mesh stripes differ")


if __name__ == "__main__":
    main()
