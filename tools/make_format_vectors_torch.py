#!/usr/bin/env python3
"""The format clips of the PyTorch/CUDA port: VP9 profiles 1-3 at 1080p.

Five clips, each two keyframes from the mini encoder's random-syntax
generator at 1920x1080 with 4 tile columns: the first with every
transform size (txfmmode 3) and a loop-filter level of 36, the second
with 4x4 transforms only (txfmmode 0: the 4-px off-grid edges of the
loop filter) at another level and sharpness.

    clip                 bpp  layout  profile
    fmt_422_1080p          8  4:2:2   1
    fmt_440_1080p          8  4:4:0   1
    fmt_444_1080p          8  4:4:4   1
    fmt_420_10_1080p      10  4:2:0   2
    fmt_444_12_1080p      12  4:4:4   3

The .framemd5 of each clip comes from the JAX package's golden decoder
(ffmpeg_hybrid_tpu VP9Decoder(recon_backend="golden")), whose header
line says so: the FFmpeg oracle that made the other clips' files is not
built here. Encoding takes minutes (a 4:4:4 frame most of them).

    python3 tools/make_format_vectors_torch.py [clip ...]
"""
import hashlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

W, H = 1920, 1080
# name: (bpp, ss_h, ss_v)
CLIPS = {
    "fmt_422_1080p": (8, 1, 0),
    "fmt_440_1080p": (8, 0, 1),
    "fmt_444_1080p": (8, 0, 0),
    "fmt_420_10_1080p": (10, 1, 1),
    "fmt_444_12_1080p": (12, 0, 0),
}
# the two keyframes: (txfmmode, filter_level, sharpness)
FRAMES = ((3, 36, 0), (0, 20, 5))


def framemd5(frames, w, h):
    """The framemd5 text of decoded frames (rawvideo, one line each)."""
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


def make(name):
    from mini_encoder import encode_keyframe_random
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu.formats.ivf import write_ivf

    bpp, ss_h, ss_v = CLIPS[name]
    pkts = []
    for i, (txfmmode, level, sharpness) in enumerate(FRAMES):
        print(f"{name} frame {i}: txfmmode={txfmmode} lf={level} "
              f"sharpness={sharpness}", flush=True)
        pkts.append((i, encode_keyframe_random(
            W, H, bpp, seed=1100 + 10 * i + bpp, txfmmode=txfmmode,
            yac_qi=60, filter_level=level, sharpness=sharpness, ss_h=ss_h,
            ss_v=ss_v, tile_cols_log2=2)))
    path = os.path.join(ROOT, "vectors", name + ".ivf")
    write_ivf(path, b"VP90", W, H, 30, 1, pkts)
    dec = VP9Decoder(recon_backend="golden")
    frames = [f for _pts, data in pkts for f in dec.decode(data)]
    with open(os.path.join(ROOT, "vectors", name + ".framemd5"), "w") as fh:
        fh.write(framemd5(frames, W, H))
    print(f"{name}: {len(frames)} frames, "
          f"{os.path.getsize(path) / 1e6:.2f} MB", flush=True)


def main():
    for name in sys.argv[1:] or list(CLIPS):
        make(name)


if __name__ == "__main__":
    main()
