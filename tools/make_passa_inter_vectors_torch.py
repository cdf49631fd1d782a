#!/usr/bin/env python3
"""The on-device pass A's small inter clips for the PyTorch/CUDA port.

Short IVF chains of a keyframe and inter frames from the mini encoder
(its flexible inter generator, encode_inter_flex, and its random-syntax
one, encode_inter_random), each a few KB, for chip_smoke.py's `passa`
phase, which holds the walk kernel (csrc/passa.cu) to its plain version
on each inter frame where the mini encoder cannot run (it imports the
JAX package's tables):

    passa_inter_modes  96x96: single-reference NEWMV/NEARESTMV/NEARMV/
                       ZEROMV with deltas to 1024, blocks under 8x8, a
                       fixed filter; compound prediction always
                       (comppredmode 1) and per block (2) under two sets
                       of sign biases; switchable filters; hp MVs;
                       intra blocks and coefficients; a chain of one
                       size, so the last frame's MVs are candidates
    passa_inter_seg    96x96: temporal segmentation prediction (each
                       frame's ids predicted from the previous map, a
                       SKIP segment), then the seg REF and SKIP features
                       and a loop-filtered frame with lf_deltas
    passa_inter_tiles  512x64 in 2 tile columns: compound, switchable
                       filters, intra blocks, coefficients, loop filter

The clips' frames are the cases of tests/test_torch_passa_inter.py
(which encodes them itself from CASES here, and holds the committed
clips to them). The .framemd5 of each clip comes from the JAX package's
golden decoder (VP9Decoder(recon_backend="golden")), whose header line
says so.

    python3 tools/make_passa_inter_vectors_torch.py [clip ...]
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

# seg features (q delta, lf delta, ref, skip): plain, each forced
# reference, intra, skip, an alt-LF segment with a forced reference
SEG_REF = [(None, None, None, False), (None, None, 1, False),
           (None, None, 2, False), (None, None, 3, False),
           (None, None, 0, False), (None, None, None, True),
           (None, 15, 1, False), (None, -18, None, False)]
LF_DELTAS = ([2, -3, 5, -5], [3, -2])
BIG = (0, 2, 4, 8, 16, 64, 256, 1024)

# name: (width, height, [frame recipe]); a recipe is ("kf", kwargs of
# encode_keyframe_random), ("flex", kwargs of encode_inter_flex) or
# ("rand", seed): encode_inter_random with temporal segmentation, the
# previous random frame's map as its prediction
CASES = {
    "passa_inter_modes": (96, 96, [
        ("kf", dict(seed=201, txfmmode=3)),
        ("flex", dict(seed=202, filtermode=1, coeffs=True, p_intra=0.2,
                      mv_mags=BIG, refresh_mask=0x02)),
        ("flex", dict(seed=203, comppredmode=1, signbias=(0, 0, 1),
                      refidx=(0, 1, 0), filtermode=4, coeffs=True,
                      p_intra=0.15, mv_mags=BIG, refresh_mask=0x04)),
        ("flex", dict(seed=204, comppredmode=2, signbias=(1, 0, 1),
                      refidx=(1, 2, 0), filtermode=4, hp=1, coeffs=True,
                      p_intra=0.15, mv_mags=(0, 2, 20, 40),
                      refresh_mask=0x08)),
    ]),
    "passa_inter_seg": (96, 96, [
        ("kf", dict(seed=211, txfmmode=3)),
        ("rand", 212),
        ("rand", 213),
        ("flex", dict(seed=214, refidx=(0, 1, 0), filter_level=30,
                      lf_deltas=LF_DELTAS, coeffs=True, p_intra=0.15,
                      seg_feat=SEG_REF, mv_mags=(0, 2, 4, 16),
                      refresh_mask=0x04)),
    ]),
    "passa_inter_tiles": (512, 64, [
        ("kf", dict(seed=221, txfmmode=3, tile_cols_log2=1)),
        ("flex", dict(seed=222, comppredmode=2, signbias=(0, 0, 1),
                      filtermode=4, coeffs=True, p_intra=0.2,
                      filter_level=20, mv_mags=(0, 2, 4, 8, 16, 64),
                      tile_cols_log2=1, refresh_mask=0x02)),
        ("flex", dict(seed=223, refidx=(0, 1, 0), coeffs=True,
                      p_intra=0.1, filter_level=35, mv_mags=BIG,
                      tile_cols_log2=1, refresh_mask=0x04)),
    ]),
}
NAMES = tuple(CASES)


def packets(name):
    """The clip's packets (bytes), as the mini encoder writes them."""
    import mini_encoder as M
    w, h, recipe = CASES[name]
    out, segmap = [], None
    for kind, arg in recipe:
        if kind == "kf":
            kw = dict(arg)
            out.append(M.encode_keyframe_random(w, h, 8, yac_qi=60,
                                                filter_level=0, **kw))
        elif kind == "rand":
            pkt, segmap = M.encode_inter_random(w, h, seed=arg, seg=True,
                                                prev_segmap=segmap)
            out.append(pkt)
        else:
            out.append(M.encode_inter_flex(w, h, **arg))
    return out


def make(name):
    from make_format_vectors_torch import framemd5
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu.formats.ivf import write_ivf

    pkts = packets(name)
    w, h, _recipe = CASES[name]
    dec = VP9Decoder(recon_backend="golden")
    frames = [f for p in pkts for f in dec.decode(p)]
    path = os.path.join(ROOT, "vectors", name + ".ivf")
    write_ivf(path, b"VP90", w, h, 30, 1, list(enumerate(pkts)))
    with open(os.path.join(ROOT, "vectors", name + ".framemd5"), "w") as fh:
        fh.write(framemd5(frames, w, h))
    print(f"{name}: {len(pkts)} packets, {len(frames)} frames, "
          f"{os.path.getsize(path)} B", flush=True)


def main():
    for name in sys.argv[1:] or NAMES:
        make(name)


if __name__ == "__main__":
    main()
