#!/usr/bin/env python3
"""The chained-GOP and dry-run clips of the PyTorch/CUDA port.

The port's dry runs (ffmpeg_hybrid_tpu_torch/parallel/dryrun.py) and
chip_smoke.py's `gop_pipeline` phase read these clips where the mini
encoder cannot run (it imports the JAX package's tables). Each is the
stream that the JAX driver's dry runs (__graft_entry__.py) encode:

    chained_1080p      1920x1080: a keyframe, then four chained inter
                       frames (refresh_mask 0x01, each referencing the
                       previous), no intra block, MV deltas to 2 px,
                       loop-filter levels 20, 23, 26, 29: the recipe of
                       dryrun_gop_pipeline at 1080p (the stripe pipeline
                       of parallel/gop_pipeline.py, 17 stripes of 64)
    dryrun_chained     the same recipe at 128x192, as dryrun_gop_pipeline
                       encodes it
    dryrun_mesh_1x2    dryrun_multichip's stream for n = 2, 4 and 8
    dryrun_mesh_2x2    devices, the meshes (gop, tile) = (1, 2), (2, 2)
    dryrun_mesh_2x4    and (2, 4): a filtered keyframe in `tile` tile
                       columns, then `gop` independent inter frames
                       (refresh_mask 0) with intra blocks, coefficients
                       and the loop filter, the last at twice the
                       keyframe's size when gop > 1 (scaled references)

The .framemd5 of each clip comes from the JAX package's golden decoder
(VP9Decoder(recon_backend="golden")), whose header line says so. The
mini encoder's bool coder keeps its codeword in one Python integer, so a
put costs the tile's length so far and a 1080p tile takes hours; this
tool swaps in `linear_bool_encoder`, which writes the same bytes in
linear time (tests/test_torch_gop_pipeline_parts.py holds it to the
mini encoder's). chained_1080p then takes some minutes.

    python3 tools/make_chained_vectors_torch.py [clip ...]
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

# the chained clips: name -> (width, height, inter frames)
CHAINED = {"chained_1080p": (1920, 1080, 4), "dryrun_chained": (128, 192, 4)}
# the mesh clips: name -> (gop, tile)
MESH = {"dryrun_mesh_1x2": (1, 2), "dryrun_mesh_2x2": (2, 2),
        "dryrun_mesh_2x4": (2, 4)}
NAMES = tuple(CHAINED) + tuple(MESH)


def linear_bool_encoder(M):
    """mini_encoder.BoolEncoder with the same codeword in linear time: the
    settled bytes go to a bytearray, `low` keeps the last k bits (8 <= k <
    16 after each put), and a carry out of them runs back through the
    bytes."""
    class LinearBoolEncoder(M.BoolEncoder):
        def __init__(self):
            super().__init__()
            self.out = bytearray()
            self.k = 8

        def put(self, bit, prob):
            split = 1 + (((self.range - 1) * prob) >> 8)
            if bit:
                self.low += split
                self.range -= split
                if self.low >> self.k:
                    self.low -= 1 << self.k
                    i = len(self.out) - 1
                    while i >= 0 and self.out[i] == 255:
                        self.out[i] = 0
                        i -= 1
                    if i < 0:
                        raise OverflowError("carry out of the codeword")
                    self.out[i] += 1
            else:
                self.range = split
            while self.range < 128:
                self.range <<= 1
                self.low <<= 1
                self.k += 1
                self.nbits += 1
            while self.k >= 16:
                self.k -= 8
                self.out.append(self.low >> self.k)
                self.low &= (1 << self.k) - 1

        def bytes(self):
            n = (self.k + 7) // 8
            return bytes(self.out) + (self.low << (8 * n - self.k)).to_bytes(
                n, "big")

    return LinearBoolEncoder


def chained_packets(w, h, n_inter):
    """dryrun_gop_pipeline's stream at w x h (__graft_entry__.py:167-174)."""
    import mini_encoder as M
    pkts = [M.encode_keyframe_random(w, h, 8, seed=3, txfmmode=3, yac_qi=60,
                                     filter_level=20)]
    for i in range(n_inter):
        pkts.append(M.encode_inter_flex(
            w, h, seed=13 + i, coeffs=True, p_intra=0.0, p_skip=0.3,
            mv_mags=(0, 2, 4, 8, 16), refresh_mask=0x01,
            filter_level=20 + 3 * i))
    return pkts


def mesh_packets(gop, ntile):
    """dryrun_multichip's stream on a (gop, ntile) mesh
    (__graft_entry__.py:71-100)."""
    import mini_encoder as M
    w, h = max(256, 256 * ntile), 128
    lc = ntile.bit_length() - 1
    pkts = [M.encode_keyframe_random(w, h, seed=5, filter_level=24,
                                     tile_cols_log2=lc)]
    inters = [M.encode_inter_flex(w, h, seed=10 + g, refresh_mask=0,
                                  filter_level=16 + 5 * g, coeffs=True,
                                  p_intra=0.2, mv_mags=(0, 2, 4, 8, 16),
                                  tile_cols_log2=lc)
              for g in range(gop)]
    if gop > 1:
        inters[-1] = M.encode_inter_flex(
            w * 2, h * 2, seed=10 + gop, refresh_mask=0, filter_level=21,
            coeffs=True, p_intra=0.2, mv_mags=(0, 2, 4, 8, 16),
            tile_cols_log2=lc)
    return pkts + inters, w, h


def packets(name):
    """The clip's packets (bytes) and its first frame's size."""
    if name in CHAINED:
        w, h, n = CHAINED[name]
        return chained_packets(w, h, n), w, h
    return mesh_packets(*MESH[name])


def make(name):
    import mini_encoder as M
    from make_format_vectors_torch import framemd5
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu.formats.ivf import write_ivf

    M.BoolEncoder = linear_bool_encoder(M)
    pkts, w, h = packets(name)
    path = os.path.join(ROOT, "vectors", name + ".ivf")
    write_ivf(path, b"VP90", w, h, 30, 1, list(enumerate(pkts)))
    dec = VP9Decoder(recon_backend="golden")
    frames = [f for p in pkts for f in dec.decode(p)]
    with open(os.path.join(ROOT, "vectors", name + ".framemd5"), "w") as fh:
        fh.write(framemd5(frames, w, h))
    print(f"{name}: {len(pkts)} packets, {len(frames)} frames, "
          f"{os.path.getsize(path)} B", flush=True)


def main():
    for name in sys.argv[1:] or NAMES:
        make(name)


if __name__ == "__main__":
    main()
