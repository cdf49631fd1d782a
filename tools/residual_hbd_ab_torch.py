#!/usr/bin/env python3
"""What the port's 10/12-bit residual (csrc/itxfm.cu residual_planes_hbd)
costs on each kind of input, and an A/B of its builds, on one CUDA card.

Inputs: frame 0 of fmt_420_10_1080p and fmt_444_12_1080p, the pair rows
and grids that recon_frame hands scatter_frame and residual_planes, and
chip_smoke.py's seeded 12-bit 4:4:4 frame whose coefficients reach the
int32 extremes (hbd_pairs_frame). Builds csrc/itxfm.cu for each variant,
all at once. A variant is "[@PATH][+ITEM,...]": "@PATH" builds another
source with the same C interface as it stands (an earlier commit's,
unpacked beside the repository), an empty source part csrc/itxfm.cu as
it stands; an ITEM "NAME=VALUE" rewrites `constexpr int NAME = VALUE;`
(kHbdThreads, kHbdMinBlocks), any other is a PART that edits
the source (EDITS, each edit with a form for the first design's source
and one for this one's):
  u32      every butterfly on 32-bit words (wrong above int32: timed,
           not checked)
  u64      every butterfly on 64-bit integer words (exact: checked)
  no16     no 16x16 blocks (their regions' other sizes still run)
  no32     no 32x32 blocks
  noclear  no consuming clear of the coefficients and eob cells
Builds with u32, no16, no32 or noclear are timed unchecked. Then, for
each build in turns (a b c c b a), holds every input against the plain
version, bit for bit, and times the scatter and the consuming residual
of the input's three planes on the card's clock (chip_smoke.device_ms,
--reps launches; the residual kernel's time). Prints one JSON object and
writes it to --out, with the card, each build's ptxas lines and each
input's coded roots by size.

    python3 tools/residual_hbd_ab_torch.py [--reps 50]
        [--out residual_hbd_ab.json]
        [--variants "@old/itxfm.cu;;+u64;+kHbdThreads=256,kHbdMinBlocks=4"]
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# part: its edits, each a list of (old, new) forms of which exactly one
# must occur once in the source
_OLD_U64 = "    residual_kernel<u64><<<regions, kThreads, 0, stream>>>(a);"
_WORD = "using Word = f64;"
EDITS = {
    "u32": [[(_OLD_U64, _OLD_U64.replace("u64", "u32")),
             (_WORD, _WORD.replace("f64", "u32"))]],
    "u64": [[(_WORD, _WORD.replace("f64", "u64")), (_OLD_U64, _OLD_U64)]],
    "no16": [[("      if (vote & 4u)\n", "      if (false)\n")]],
    "no32": [[("      if (vote & 8u)\n", "      if (false)\n")]],
    "noclear": [[("    if (a.consume) clear_quad(p, cl, ry0, rx0, oy, ox);\n",
                  ""),
                 ("        clear_quad(p, cl, ry0, rx0, oy, ox);\n", "")],
                [("    if (consume && eob) st_grid_zero(p.eob, p.eob_sz, g);\n",
                  "")]],
}
UNCHECKED = ("u32", "no16", "no32", "noclear")


def _parse(v):
    """(source: '' or '@PATH', parts, constants) of a variant."""
    if "=" in v and not v.startswith("@") and "+" not in v:
        v = "+" + v
    src, _, items = v.partition("+")
    items = [i for i in items.split(",") if i]
    return (src, [i for i in items if "=" not in i],
            [i.split("=") for i in items if "=" in i])


def _checked(v):
    """Whether a variant's output is exact: not with an UNCHECKED part."""
    return not set(_parse(v)[1]) & set(UNCHECKED)


def variant_source(v):
    """The source text of variant v."""
    from ffmpeg_hybrid_tpu_torch import _build
    src, parts, consts = _parse(v)
    path = os.path.join(ROOT, src[1:]) if src else \
        os.path.join(_build.CSRC_DIR, "itxfm.cu")
    with open(path) as f:
        text = f.read()
    for part in parts:
        for forms in EDITS[part]:
            hits = [(a, b) for a, b in forms if text.count(a) == 1]
            if len(hits) != 1:
                raise RuntimeError(f"{path}: cannot apply {part}")
            text = text.replace(*hits[0])
    for name, value in consts:
        text, n = re.subn(rf"constexpr int {name} = [^;]+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise RuntimeError(f"{path} has no constant {name}")
    return text


def build(variants):
    """{variant: (loaded library, ptxas lines)}, nvcc started for every
    variant at once."""
    from ffmpeg_hybrid_tpu_torch import _build
    from ffmpeg_hybrid_tpu_torch.ops import recon_cuda as RC
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for i, v in enumerate(variants):
        stem = os.path.join(_build.BUILD_DIR, f"residual_hbd_ab_{i}")
        with open(stem + ".cu", "w") as f:
            f.write(variant_source(v))
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
        for name, argtypes in RC._SIGNATURES["itxfm.cu"].items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        libs[v] = (lib, [ln.strip() for ln in log.splitlines()
                         if "registers" in ln or "spill" in ln
                         or "smem" in ln])
    return libs


def inputs(torch, np, cs):
    """{name: (cp, ep, nc, ne, grids [(eob4, txsz4, txtype4)] a plane,
    lossless, bpp)}: the two clips' frame 0 and the seeded frame."""
    from ffmpeg_hybrid_tpu_torch.ops import recon as R
    out = {}
    for clip in cs.HBD_CLIPS:
        got = cs.capture_inputs(torch, [(R, "scatter_frame"),
                                        (R, "residual_planes")],
                                cs.read_clip(clip)[0][:1])
        (bufs, cp, ep), = got["scatter_frame"]
        (jobs, lossless, bpp), = [a[:3] for a in got["residual_planes"]]
        out[clip] = (cp, ep, bufs.flat_c.numel(), bufs.flat_e.numel(),
                     [tuple(j[1:]) for j in jobs], lossless, bpp)
    rng = np.random.RandomState(cs.SEED + 17)
    cp, ep, nc, ne, grids = cs.hbd_pairs_frame(np, rng, ((1088, 1920),) * 3)
    out["seeded_12bit_444_extremes"] = (
        torch.as_tensor(cp, device="cuda"), torch.as_tensor(ep, device="cuda"),
        nc, ne, [tuple(torch.as_tensor(g, device="cuda") for g in gr)
                 for gr in grids], False, 12)
    return out


def views(bufs, grids):
    """The planes' (coef, eob4, txsz4, txtype4) views of kept buffers."""
    out, bc, be = [], 0, 0
    for eob4, txsz4, txtype4 in grids:
        r4, c4 = eob4.shape
        out.append((bufs.flat_c[bc:bc + 16 * r4 * c4].view(4 * r4, 4 * c4),
                    bufs.flat_e[be:be + r4 * c4].view(r4, c4), txsz4,
                    txtype4))
        bc += 16 * r4 * c4
        be += r4 * c4
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=";+u32;+u64;+no16,no32;+noclear",
                    help="';'-separated builds: '[@PATH][+ITEM,...]' or '' "
                         "(the source as it stands)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("residual_hbd_ab_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ffmpeg_hybrid_tpu_torch import _build
    from ffmpeg_hybrid_tpu_torch.ops import recon as R
    import threading
    variants = args.variants.split(";")
    # the decoder's own kernels (for the captures) build beside the variants
    th = threading.Thread(target=_build.build_all)
    th.start()
    libs = build(variants)
    th.join()
    ins = inputs(torch, np, cs)
    wants, info = {}, {}
    for k, (cp, ep, nc, ne, grids, lossless, bpp) in ins.items():
        bufs = R.CoefBuffers(cp.device, nc, ne, True)
        R.scatter_frame(bufs, cp, ep)
        jobs = [tuple(t.clone() for t in j) for j in views(bufs, grids)]
        bufs.consumed = True
        wants[k] = [R.residual_plane_plain(*j, lossless, bpp) for j in jobs]
        info[k] = {"bpp": bpp, "pair_rows": int(cp.shape[0]),
                   "roots": cs.hbd_roots(np, jobs, lossless)}
        del jobs
    runs = {v: [] for v in variants}
    for v in variants + variants[::-1]:
        _build._LIBS["itxfm.cu"] = libs[v][0]
        checked = _checked(v)
        run = {}
        for k, (cp, ep, nc, ne, grids, lossless, bpp) in ins.items():
            bufs = R.CoefBuffers(cp.device, nc, ne, True)
            planes = views(bufs, grids)

            def pair():
                R.scatter_frame(bufs, cp, ep)
                out = R.residual_planes(planes, lossless, bpp,
                                        consume=[bufs] * len(planes))
                bufs.strays[0] = 0     # builds without the clear leave it
                return out
            got = pair()
            if checked:
                if not all(torch.equal(a, b) for a, b in zip(got, wants[k])):
                    raise RuntimeError(f"variant '{v}' on {k}: kernel != "
                                       "plain")
                if not bufs.read_zero():
                    raise RuntimeError(f"variant '{v}' on {k}: the kept "
                                       "buffers do not read zero")
            run[k] = cs.device_ms(torch, pair, args.reps,
                                  ("residual_kernel",))[0]
        runs[v].append(run)
    _build._LIBS.pop("itxfm.cu", None)
    report = {"card": cs.card_line(), "torch": torch.__version__,
              "inputs": info,
              "ptxas": {v or "as it stands": libs[v][1] for v in variants},
              "runs": {v or "as it stands": runs[v] for v in variants}}
    print(json.dumps({"residual_hbd_ab": report}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
