#!/usr/bin/env python3
"""The resize clip of the PyTorch/CUDA port: a 1080p VP9 stream whose
inter frames change resolution, so that each predicts from a reference
of another size (FFmpeg vp9recon.c:492-628, mc_luma_scaled and
mc_chroma_scaled).

Six frames, 4:2:0 8-bit profile 0, every one with a nonzero loop-filter
level and 4 tile columns where the width allows (2 at 960 px):

    frame  size       predicts from (slot)             interpolation
    0      1920x1080  keyframe (fills every slot)       -
    1      1280x720   frame 0 (0): 1.5x down, step 24   switchable
    2      960x540    frame 1 (1): 1.33x down, step 21  bilinear
    3      1920x1080  frame 2 (2): 2x up, step 8        sharp
    4      1920x1080  compound: LAST and GOLDEN frame 3  switchable
                      (3, same size), ALTREF frame 2
                      (2, 2x up); single-reference
                      blocks take either
    5      960x540    frame 0 (0): 2x down, step 32     smooth

The keyframe is the mini encoder's random-syntax keyframe (every
transform size); the inter frames are its lossless flex frames with
random partitions (sub-8x8 included), NEWMV deltas, intra blocks and
coefficients on a fifth of the blocks.

The .framemd5 comes from the JAX package's golden decoder
(ffmpeg_hybrid_tpu VP9Decoder(recon_backend="golden")), whose header
line says so: the FFmpeg oracle that made the older clips' files is not
built here. Each line hashes the frame at its own size, as FFmpeg's
framemd5 does with -noautoscale. Encoding a 1080p inter frame takes
minutes, so the frames are encoded in parallel processes (--jobs).

    python3 tools/make_resize_vector_torch.py [--jobs N]
"""
import argparse
import hashlib
import multiprocessing
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

NAME = "resize_1080p"
MV_MAGS = (0, 2, 8, 24, 64, 256)
# (w, h, keyword arguments of encode_inter_flex); frame 0 is the keyframe
FRAMES = (
    (1920, 1080, None),
    (1280, 720, dict(refidx=(0, 0, 0), refresh_mask=0x02, filtermode=4,
                     filter_level=20, tile_cols_log2=2)),
    (960, 540, dict(refidx=(1, 1, 1), refresh_mask=0x04, filtermode=3,
                    filter_level=16, tile_cols_log2=1)),
    (1920, 1080, dict(refidx=(2, 2, 2), refresh_mask=0x08, filtermode=2,
                      filter_level=24, tile_cols_log2=2)),
    (1920, 1080, dict(comppredmode=2, signbias=(0, 0, 1), refidx=(3, 3, 2),
                      refresh_mask=0, filtermode=4, filter_level=28,
                      tile_cols_log2=2)),
    (960, 540, dict(refidx=(0, 0, 0), refresh_mask=0, filtermode=0,
                    filter_level=12, tile_cols_log2=1)),
)


def encode(i):
    """Frame i of the clip, encoded."""
    from mini_encoder import encode_inter_flex, encode_keyframe_random
    w, h, kw = FRAMES[i]
    if kw is None:
        return encode_keyframe_random(w, h, 8, seed=1200, txfmmode=3,
                                      yac_qi=60, filter_level=30,
                                      tile_cols_log2=2)
    return encode_inter_flex(w, h, seed=1200 + i, coeffs=True, p_intra=0.1,
                             p_skip=0.8, mv_mags=MV_MAGS, **kw)


def framemd5(frames):
    """The framemd5 text of decoded frames (rawvideo, one line each, at
    each frame's own size)."""
    w, h = frames[0].size
    lines = ["#format: frame checksums", "#version: 2", "#hash: MD5",
             "#software: ffmpeg_hybrid_tpu golden decoder "
             "(VP9Decoder(recon_backend=\"golden\")), not FFmpeg",
             "#tb 0: 1/30", "#media_type 0: video",
             "#codec_id 0: rawvideo", f"#dimensions 0: {w}x{h}",
             "#sar 0: 0/1",
             "#stream#, dts,        pts, duration,     size, hash"]
    for i, f in enumerate(frames):
        raw = f.to_bytes()
        lines.append(f"0, {i:10d}, {i:10d}, {1:8d}, {len(raw):8d}, "
                     f"{hashlib.md5(raw).hexdigest()}")
    return "\n".join(lines) + "\n"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=len(FRAMES),
                    help="frames encoded at once, a process each")
    args = ap.parse_args()
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu.formats.ivf import write_ivf

    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(max(1, args.jobs)) as pool:
        pkts = pool.map(encode, range(len(FRAMES)))
    for i, p in enumerate(pkts):
        print(f"{NAME} frame {i}: {FRAMES[i][0]}x{FRAMES[i][1]}, "
              f"{len(p)} bytes", flush=True)
    path = os.path.join(ROOT, "vectors", NAME + ".ivf")
    write_ivf(path, b"VP90", 1920, 1080, 30, 1, list(enumerate(pkts)))
    dec = VP9Decoder(recon_backend="golden")
    frames = [f for data in pkts for f in dec.decode(data)]
    if len(frames) != len(FRAMES):
        raise RuntimeError(f"{len(frames)} frames decoded")
    with open(os.path.join(ROOT, "vectors", NAME + ".framemd5"), "w") as fh:
        fh.write(framemd5(frames))
    print(f"{NAME}: {len(frames)} frames, "
          f"{os.path.getsize(path) / 1e6:.2f} MB", flush=True)


if __name__ == "__main__":
    main()
