#!/usr/bin/env python3
"""What the port's coefficient walk (csrc/rac.cu) and its coefficient
scatter with the consuming residual (csrc/itxfm.cu) cost, and an A/B of
their builds, on one CUDA card.

Inputs are the clips' own: every coefficient block of bench_1080p frame
0 (captured by the pure-Python pass A, every lane in one launch), and
the pair rows and grids that recon_frame hands the scatter and the
residual on bench_1080p frames 0-1 and bench_1080p_lf frame 0. Builds
every variant of each kernel at once: "@PATH" builds another source as
it stands, with the interface before the one-launch walk and the kept
buffers (rac.cu: a launch per size group; itxfm.cu: a scatter that
always zero-fills, a residual that never clears), such as an earlier
commit's unpacked beside the repository (an "@PATH" source that has
the current interface runs as the source does); "-PART,..." drops parts
of the work (DROP: the walk's zeroing of its outputs and caches, the
walk itself; the residual's clear) to show what they cost, timed
unchecked; "sms=N" (rac.cu; also as a suffix, "@PATH+sms=N") packs the
lanes for N SMs (more or fewer lanes a block), "one" (also a suffix)
walks the longest lane alone; "fresh" (itxfm.cu) runs the source as it stands under
the old contract (a scatter into fresh, zero-filled buffers and a
residual that does not clear); an empty variant is the source as it
stands. Then, for each
build in turns (a b c c b a), holds every input against the plain
version (not the builds that drop work) and times the kernels on the
card's clock (chip_smoke.device_ms, --reps launches) with their device
ops per call; and, each turn, the empty kernel's time, the launch floor.
Prints one JSON object and writes it to --out.

    python3 tools/coef_ab_torch.py [--reps 50] [--out coef_ab.json]
        [--rac ";@old/rac.cu;-zero;-walk"]
        [--itxfm ";fresh;@old/itxfm.cu;-clear"]
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# part: the edits of a source that drop it. zero: the walk's zeroing of
# its output rows and energy caches; walk: the walk (each lane writes
# eob 0); clear: the consuming residual's clear of coefficients and eob
# cells
DROP = {
    "zero": [("  for (int k = t; k < nout / 4; k += 32) o4[k] = "
              "make_int4(0, 0, 0, 0);\n", ""),
             ("  for (int k = t; k < ncache / 16; k += 32)\n"
              "    reinterpret_cast<int4*>(s_cache)[k] = "
              "make_int4(0, 0, 0, 0);\n", "")],
    "walk": [("  if (t >= nl) return;\n",
              "  if (t < nl) eob[lane0 + t] = 0;\n  return;\n")],
    "clear": [("    if (a.consume) clear_quad(p, cl, ry0, rx0, oy, ox);\n",
               ""),
              ("    if (consume && eob) st_grid_zero(p.eob, p.eob_sz, g);\n",
               "")],
}
SOURCES = {"rac": "rac.cu", "itxfm": "itxfm.cu"}


def _parse(v):
    """(source part, sms or None, one) of a variant: its "+"-separated
    tokens are a source ("", "@PATH", "-PART"), "sms=N" and "one"."""
    src, sms, one = "", None, False
    for tok in v.split("+"):
        if tok.startswith("sms="):
            sms = int(tok[4:])
        elif tok == "one":
            one = True
        elif tok != "fresh":
            src = tok
    return src, sms, one


def variant_source(kernel, v):
    """The source text of variant v of kernel ('rac' or 'itxfm')."""
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


def build(variants):
    """{(kernel, variant): (library, ptxas lines)}, nvcc started for
    every build at once (the "fresh" variant shares the source's)."""
    from ffmpeg_hybrid_tpu_torch import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for i, (kernel, v) in enumerate(variants):
        stem = os.path.join(_build.BUILD_DIR, f"coef_ab_{kernel}_{i}")
        with open(stem + ".cu", "w") as f:
            f.write(variant_source(kernel, _parse(v)[0]))
        procs[kernel, v] = (stem, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
             "-o", stem + ".so", stem + ".cu"], stdout=subprocess.PIPE,
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


def _call(torch, fn, *args):
    """A C entry point on the current stream; tensors pass as pointers,
    lists of tensors as host arrays of pointers, ints as C ints."""
    keep = []

    def arg(a):
        if torch.is_tensor(a):
            return ctypes.c_void_p(a.data_ptr())
        if isinstance(a, (list, tuple)):
            arr = (ctypes.c_void_p * len(a))(*(x.data_ptr() for x in a))
            keep.append(arr)
            return ctypes.c_void_p(ctypes.addressof(arr))
        return a
    rc = fn(*(arg(a) for a in args),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise RuntimeError(f"CUDA error {rc}")


def old_walk(torch, lib, groups, lanes, bpp):
    """Every group through a rac.cu library of the per-group interface
    (half16, S, Lh, value0, rng0, bitbuf0, nbits0, probs, scan, nb0, nb1,
    nnz0, qmul, band, n, bpp, is32, coef, eob): a launch a group."""
    from ffmpeg_hybrid_tpu_torch.ops import rac
    lib.rac_decode_coeffs.restype = ctypes.c_int
    out = {}
    for (tx, group), args in zip(groups.items(), lanes):
        n = (4 << tx) ** 2
        S, Lh = args[0].shape
        band = torch.as_tensor(rac.band_table(n), device=args[0].device)
        coef = torch.empty((S, n), dtype=torch.int32, device=args[0].device)
        eob = torch.empty((S,), dtype=torch.int32, device=args[0].device)
        _call(torch, lib.rac_decode_coeffs, args[0], S, Lh, *args[1:], band,
              n, bpp, int(group[0]["is32"]), coef, eob)
        out[tx] = (coef, eob)
    return out


def old_pair(torch, lib, sargs, jobs, lossless):
    """The scatter (a memset pair and a launch into fresh buffers) and
    the residual (no clear) of an itxfm.cu library of the earlier
    interface; returns the residuals."""
    import numpy as np
    cp, ep, nc, ne = sargs
    wide = cp.shape[1] == 4
    flat_c = torch.empty(nc, dtype=torch.int32 if wide else torch.int16,
                         device=cp.device)
    flat_e = torch.empty(ne, dtype=torch.int16, device=cp.device)
    lib.scatter_pairs.restype = lib.residual_planes.restype = ctypes.c_int
    _call(torch, lib.scatter_pairs, cp, cp.shape[0], cp.shape[1], ep,
          ep.shape[0], flat_c, nc, flat_e, ne)
    ptrs, dims, outs, bc, be = [], [], [], 0, 0
    for coef, eob4, txsz4, txtype4 in jobs:
        (H, W), (r4, c4) = coef.shape, eob4.shape
        out = torch.empty((H, W), dtype=torch.int32, device=cp.device)
        ptrs += [flat_c[bc:bc + H * W], flat_e[be:be + r4 * c4], txsz4,
                 txtype4, out]
        dims += [H, W, int(not wide), 2, txsz4.element_size(),
                 txtype4.element_size()]
        outs.append(out)
        bc += H * W
        be += r4 * c4
    d = np.asarray(dims, np.int32)
    _call(torch, lib.residual_planes, ptrs, ctypes.c_void_p(d.ctypes.data),
          len(jobs), int(lossless))
    return outs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rac", default=";-zero;-walk",
                    help="';'-separated builds of csrc/rac.cu")
    ap.add_argument("--itxfm", default=";fresh;-clear",
                    help="';'-separated builds of csrc/itxfm.cu")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("coef_ab_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ffmpeg_hybrid_tpu_torch import _build
    from ffmpeg_hybrid_tpu_torch.ops import coef_path as CP
    from ffmpeg_hybrid_tpu_torch.ops import rac
    from ffmpeg_hybrid_tpu_torch.ops import recon as R
    variants = {"rac": args.rac.split(";"), "itxfm": args.itxfm.split(";")}
    empty_build = cs.start_empty_build()
    libs = build([(k, v) for k, vs in variants.items() for v in vs])
    empty = cs.load_empty(empty_build)
    # the walk's inputs: bench_1080p frame 0's blocks
    caps = CP.capture_blocks(cs.read_clip("bench_1080p")[0][0],
                             count_work=True)
    groups = CP.group_by_tx(caps)
    fr = CP.frame_inputs(groups, "cuda", torch.cuda.get_device_properties(0)
                         .multi_processor_count)
    per_group = [CP.lane_inputs(g, "cuda") for g in groups.values()]
    want_walk = CP.decode_blocks(groups, fr, 8,
                                 fn=rac.decode_coeffs_multi_plain)
    # the scatter's and the residual's: as recon_frame hands them over
    targets = [(R, "scatter_frame"), (R, "residual_planes")]
    pairs = []
    for clip, n in (("bench_1080p", 2), ("bench_1080p_lf", 1)):
        got = cs.capture_inputs(torch, targets, cs.read_clip(clip)[0][:n])
        for k, ((bufs, cp, ep), (jobs, lossless, _bpp)) in enumerate(zip(
                got["scatter_frame"], got["residual_planes"])):
            sargs = (cp, ep, bufs.flat_c.numel(), bufs.flat_e.numel())
            want = [R.residual_plane_plain(*j, lossless, 8) for j in jobs]
            pairs.append((f"{clip}_{k}", sargs, jobs, lossless, want))

    def old_interface(kernel, v, marker):
        src = _parse(v)[0]
        return src.startswith("@") and \
            marker not in variant_source(kernel, src)

    # the longest lane alone, and its plain result
    longest = max(caps, key=lambda c: c["bools"])
    one = {longest["tx"]: [longest]}
    want_one = CP.decode_blocks(one, CP.frame_inputs(one, "cuda"), 8,
                                fn=rac.decode_coeffs_multi_plain)

    def walk_caller(v):
        lib = libs["rac", v][0]
        if old_interface("rac", v, "rac_decode_coeffs_frame"):
            return lambda: old_walk(torch, lib, groups, per_group, 8)
        for name, argtypes in rac._SIGNATURES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int

        _src, sms, alone = _parse(v)
        grp = one if alone else groups
        lanes = CP.frame_inputs(
            grp, "cuda", sms or torch.cuda.get_device_properties(0)
            .multi_processor_count) if sms or alone else fr

        def call():
            _build._LIBS["rac.cu"] = lib
            return CP.decode_blocks(grp, lanes, 8)
        return call

    def pair_caller(v, sargs, jobs, lossless):
        from ffmpeg_hybrid_tpu_torch.ops import recon_cuda as RC
        lib = libs["itxfm", v][0]
        if old_interface("itxfm", v, "zero_fill"):
            return lambda: old_pair(torch, lib, sargs, jobs, lossless)
        for name, argtypes in RC._SIGNATURES["itxfm.cu"].items():
            if not hasattr(lib, name):   # a source before residual_planes_hbd
                continue
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        cp, ep, nc, ne = sargs
        bufs = R.CoefBuffers(cp.device, nc, ne, cp.shape[1] == 4)

        def call():
            _build._LIBS["itxfm.cu"] = lib
            if v == "fresh":
                fc, fe = R.scatter_coef(*sargs)
                consume = None
            else:
                fc, fe = R.scatter_frame(bufs, cp, ep)
                bufs.consumed = True       # the "-clear" builds leave it
                consume = [bufs] * len(jobs)
            views, bc, be = [], 0, 0
            for coef, eob4, txsz4, txtype4 in jobs:
                (H, W), (r4, c4) = coef.shape, eob4.shape
                views.append((fc[bc:bc + H * W].view(H, W),
                              fe[be:be + r4 * c4].view(r4, c4), txsz4,
                              txtype4))
                bc += H * W
                be += r4 * c4
            return R.residual_planes(views, lossless, 8, consume=consume)
        return call

    runs = {k: {v: [] for v in vs} for k, vs in variants.items()}
    floors = []
    for turn in (0, 1):
        floors.append(cs.launch_floor_ms(torch, empty, args.reps))
        for v in (variants["rac"] if turn == 0 else variants["rac"][::-1]):
            fn = walk_caller(v)
            got = fn()
            want = want_one if _parse(v)[2] else want_walk
            if not v.startswith("-"):
                for tx in want:
                    for a, b in zip(got[tx], want[tx]):
                        if not torch.equal(a, b):
                            raise RuntimeError(f"rac variant '{v}': kernel "
                                               "!= plain")
            ms, ops = cs.device_ms(torch, fn, args.reps,
                                   ("decode_coeffs_kernel",))
            runs["rac"][v].append({"bench_1080p_0": {
                "ms": ms, "device_ops": ops, "call_ms": cs.cuda_ms(fn, 20)}})
        for v in (variants["itxfm"] if turn == 0
                  else variants["itxfm"][::-1]):
            run = {}
            for key, sargs, jobs, lossless, want in pairs:
                fn = pair_caller(v, sargs, jobs, lossless)
                got = fn()
                if not v.startswith("-") and not all(
                        torch.equal(a, b) for a, b in zip(got, want)):
                    raise RuntimeError(f"itxfm variant '{v}' on {key}: "
                                       "kernel != plain")
                sc, sc_ops = cs.device_ms(torch, fn, args.reps,
                                          ("scatter_kernel", "Memset"))
                res, res_ops = cs.device_ms(torch, fn, args.reps,
                                            ("residual_kernel",))
                run[key] = {"scatter_ms": sc, "scatter_ops": sc_ops,
                            "residual_ms": res, "residual_ops": res_ops}
            runs["itxfm"][v].append(run)
        floors.append(cs.launch_floor_ms(torch, empty, args.reps))
    for source in SOURCES.values():
        _build._LIBS.pop(source, None)
    report = {"card": cs.card_line(), "torch": torch.__version__,
              "launch_floor_ms": floors,
              "walk_inputs": {"lanes": len(caps),
                              "by_tx": {tx: len(g) for tx, g in
                                        groups.items()},
                              "blocks": int(fr.blocks.shape[0]),
                              "smem": fr.smem},
              "ptxas": {k: {v or "as it stands": libs[k, v][1] for v in vs}
                        for k, vs in variants.items()},
              "runs": {k: {v or "as it stands": r for v, r in rs.items()}
                       for k, rs in runs.items()}}
    print(json.dumps({"coef_ab": report}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
