#!/usr/bin/env python3
"""The on-device pass A's small vectors for the PyTorch/CUDA port.

One-frame IVF clips of intra frames from the mini encoder's
random-syntax generator (no loop filter), each a few KB, for
chip_smoke.py's `passa` phase, which holds the walk kernel
(csrc/passa.cu) to its plain version on each frame where the mini
encoder cannot run (it imports the JAX package's tables):

    passa_s2, _s4, _s5, _s7, _s41, _s42, _s51
                    every tx size, partial edge superblocks, 2 tile
                    columns, all 4x4, switchable tx (and with edges),
                    backward adaptation (refreshctx: the walk's counts)
    passa_seg       segmentation (a skip feature, q deltas)
    passa_wide      2240 px wide: 280 8x8 columns in one tile
    passa_10bit     10 bits, 4:2:0
    passa_444_12    12 bits, 4:4:4, switchable tx
    passa_lossless  yac_qi 0: the lossless WHT
    passa_intraonly a gray keyframe, then an invisible intra-only
                    lossless frame shown by a show-existing frame (in
                    one superframe): two packets, two output frames

The frames are the cases of tests/test_torch_passa_device.py (which
encodes them itself from CASES here). The .framemd5 of each clip comes
from the JAX package's golden decoder (VP9Decoder(recon_backend=
"golden")), whose header line says so.

    python3 tools/make_passa_vectors_torch.py [clip ...]
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

SEG_FEAT = [(20, 0, -1, 0), (-30, 0, -1, 0), (0, 0, -1, 1),
            (40, 0, -1, 0)] + [(0, 0, -1, 0)] * 4
# name: encode_keyframe_random's arguments (w, h, bpp and the rest)
CASES = {
    "passa_s2": dict(w=128, h=128, seed=2, txfmmode=3),
    "passa_s4": dict(w=130, h=70, seed=4, txfmmode=3),
    "passa_s5": dict(w=512, h=128, seed=5, txfmmode=3, tile_cols_log2=1),
    "passa_s7": dict(w=96, h=64, seed=7, txfmmode=0),
    "passa_s41": dict(w=128, h=128, seed=41, txfmmode=4),
    "passa_s42": dict(w=130, h=70, seed=42, txfmmode=4),
    "passa_s51": dict(w=130, h=70, seed=51, txfmmode=3, refreshctx=1),
    "passa_seg": dict(w=128, h=128, seed=9, txfmmode=3, seg_feat=SEG_FEAT),
    "passa_wide": dict(w=2240, h=64, seed=13, txfmmode=3),
    "passa_10bit": dict(w=128, h=96, bpp=10, seed=11, txfmmode=3),
    "passa_444_12": dict(w=64, h=64, bpp=12, seed=12, txfmmode=4, ss_h=0,
                         ss_v=0),
    "passa_lossless": dict(w=64, h=64, seed=14, txfmmode=0, yac_qi=0),
}
INTRA_ONLY = "passa_intraonly"
NAMES = tuple(CASES) + (INTRA_ONLY,)


def packets(name):
    """The clip's packets (bytes), as the mini encoder writes them."""
    import numpy as np
    import mini_encoder as M
    if name == INTRA_ONLY:
        from ffmpeg_hybrid_tpu.formats.superframe import merge_superframe
        rng = np.random.RandomState(8)
        io = M.encode_keyframe_lossless(rng.randint(0, 256, (64, 64)),
                                        rng.randint(0, 256, (32, 32)),
                                        rng.randint(0, 256, (32, 32)), 8,
                                        intraonly=True)
        show = bytes([(0b10 << 6) | (1 << 3) | 0])    # show slot 0
        return [M.encode_keyframe_gray(64, 64, 8),
                merge_superframe([io, show])]
    kw = dict(CASES[name])
    kw.setdefault("yac_qi", 60)
    return [M.encode_keyframe_random(kw.pop("w"), kw.pop("h"),
                                     kw.pop("bpp", 8), filter_level=0, **kw)]


def make(name):
    from make_format_vectors_torch import framemd5
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu.codecs.vp9.header import \
        parse_uncompressed_header
    from ffmpeg_hybrid_tpu.formats.ivf import write_ivf
    from ffmpeg_hybrid_tpu.formats.superframe import split_superframe

    pkts = packets(name)
    dec = VP9Decoder(recon_backend="golden")
    frames = [f for i, p in enumerate(pkts)
              for _pts, fd in split_superframe(p, i)
              for f in dec.decode(fd)]
    h = parse_uncompressed_header(pkts[0], VP9Decoder())
    path = os.path.join(ROOT, "vectors", name + ".ivf")
    write_ivf(path, b"VP90", h.width, h.height, 30, 1,
              list(enumerate(pkts)))
    with open(os.path.join(ROOT, "vectors", name + ".framemd5"), "w") as fh:
        fh.write(framemd5(frames, h.width, h.height))
    print(f"{name}: {len(pkts)} packets, {len(frames)} frames, "
          f"{os.path.getsize(path)} B", flush=True)


def main():
    for name in sys.argv[1:] or NAMES:
        make(name)


if __name__ == "__main__":
    main()
