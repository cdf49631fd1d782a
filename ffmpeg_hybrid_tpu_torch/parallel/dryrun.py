"""Dry runs of the parallel decode on a device mesh, the counterpart of
the JAX package's driver entry points (__graft_entry__.py:
dryrun_multichip, dryrun_gop_pipeline).

    from ffmpeg_hybrid_tpu_torch.parallel.dryrun import (
        dryrun_gop_pipeline, dryrun_multichip)
    dryrun_multichip(8)                  # on the card; device="cpu" too
    dryrun_gop_pipeline(4)

`dryrun_multichip(n)` decodes a stream of a filtered keyframe in
several tile columns and independent inter frames (intra blocks,
coefficients, the loop filter, the last frame at twice the keyframe's
size: scaled references) through the tile-sharded pass B
(parallel/fullframe.py) on an (gop, tile) mesh of n slots, the keyframe
on a (1, tile) mesh first and its planes installed as the reference,
then runs the chained leg, `dryrun_gop_pipeline(min(n, 4))`: G chained
inter frames through the stripe pipeline (parallel/gop_pipeline.py) on
a [G, 1] mesh. Each holds every frame's coded area to the port's serial
decode of the same stream, whose MD5s must equal the clip's framemd5,
raises on the first mismatch, and prints one line on success.

The JAX driver encodes its streams with the mini encoder, which imports
the JAX package; these read the same streams as committed clips
(tools/make_chained_vectors_torch.py): dryrun_mesh_1x2, _2x2 and _2x4
for n = 2, 4 and 8, and dryrun_chained (128x192, four chained frames).
"""
from __future__ import annotations

import hashlib
import os

import torch

from ..device import resolve
from .fullframe import install, sharded_decode_pass_b
from .gop_pipeline import decode_chained_gop
from .mesh import make_mesh

VECTORS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "vectors")
# slots -> (clip, (gop, tile)), as the JAX driver shapes its mesh
MESH_CLIPS = {2: ("dryrun_mesh_1x2", (1, 2)), 4: ("dryrun_mesh_2x2", (2, 2)),
              8: ("dryrun_mesh_2x4", (2, 4))}
CHAINED_CLIP = "dryrun_chained"
# the chained clip's inter frames
CHAINED_MAX = 4


def read_clip(name):
    """A committed clip's packets and its framemd5 hashes."""
    from ..formats.ivf import read_ivf
    from ..formats.superframe import split_superframe
    base = os.path.join(VECTORS, name)
    packets = [fd for pts, data in read_ivf(base + ".ivf")[1]
               for _p, fd in split_superframe(data, pts)]
    with open(base + ".framemd5") as f:
        want = [line.split(",")[-1].strip() for line in f
                if line.strip() and not line.startswith("#")]
    return packets, want


def serial_frames(packets, want, device, name):
    """The port's serial decode of packets on device, each frame's MD5
    held to want."""
    from ..codecs.vp9.decoder import VP9Decoder
    dec = VP9Decoder(device=device)
    frames = [f for p in packets for f in dec.decode(p)]
    got = [hashlib.md5(f.to_bytes()).hexdigest() for f in frames]
    if got != want:
        bad = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                   min(len(got), len(want)))
        raise RuntimeError(f"{name}: the serial decode's frame {bad} does "
                           "not match the framemd5")
    return frames


def check(frame, planes, ctx):
    """The frame's coded area (8-pixel units) of each plane against
    planes; raises on a mismatch."""
    cw = ((frame.size[0] + 7) >> 3) * 8
    ch = ((frame.size[1] + 7) >> 3) * 8
    for i in range(3):
        pw = cw if i == 0 else cw >> frame.ss_h
        ph = ch if i == 0 else ch >> frame.ss_v
        want = frame.dev[i][:ph, :pw]
        got = planes[i][:ph, :pw].to(want.device)
        if not torch.equal(got, want):
            raise RuntimeError(f"{ctx} plane {i} mismatch")


def dryrun_multichip(n_slots, device=None):
    """The tile-sharded pass B on an n_slots mesh (n = 2, 4 or 8: (1, 2),
    (2, 2), (2, 4)) bit-exact against the serial decode, then the chained
    leg dryrun_gop_pipeline(min(n_slots, 4))."""
    if n_slots not in MESH_CLIPS:
        raise ValueError(f"no dry-run clip for {n_slots} slots: the meshes "
                         "are " + ", ".join(f"{n}: {s}" for n, (_c, s)
                                            in MESH_CLIPS.items()))
    dev = resolve(device)
    name, (gop, ntile) = MESH_CLIPS[n_slots]
    packets, want = read_clip(name)
    truth = serial_frames(packets, want, dev, name)
    from ..codecs.vp9.decoder import VP9Decoder
    shd = VP9Decoder(device=dev)
    jk = shd.decode_pass_a(packets[0])
    [kplanes] = sharded_decode_pass_b([jk], make_mesh(ntile, 1, device=dev))
    install(jk, kplanes)
    jobs = [shd.decode_pass_a(d) for d in packets[1:]]
    outs = sharded_decode_pass_b(jobs, make_mesh(n_slots, gop, device=dev))
    check(truth[0], kplanes, "kf")
    for g in range(gop):
        check(truth[1 + g], outs[g], f"inter {g}")
    w, h = truth[0].size
    print(f"dryrun_multichip OK: mesh gop={gop} x tile={ntile} on {dev}, "
          f"{w}x{h} frames (+ one {2 * w}x{2 * h} dynamic-resize frame with "
          f"scaled-ref MC when gop > 1), full sharded pass B (residual + MC "
          f"+ intra + cross-tile loop filter with halo copies) bit-exact vs "
          f"serial on {1 + gop} frames", flush=True)
    dryrun_gop_pipeline(min(n_slots, CHAINED_MAX), device)


def dryrun_gop_pipeline(G, device=None):
    """The stripe pipeline: the first G (1 .. 4) chained inter frames of
    dryrun_chained across a [G, 1] mesh, bit-exact against the serial
    decode."""
    if not 1 <= G <= CHAINED_MAX:
        raise ValueError(f"{CHAINED_CLIP} holds {CHAINED_MAX} chained "
                         f"inter frames, not {G}")
    dev = resolve(device)
    packets, want = read_clip(CHAINED_CLIP)
    packets, want = packets[:G + 1], want[:G + 1]
    truth = serial_frames(packets, want, dev, CHAINED_CLIP)
    (oy, ou, ov), _jobs = decode_chained_gop(
        packets, make_mesh(G, G, device=dev), Hs=64, lag=2)
    for g in range(G):
        check(truth[1 + g], (oy[g], ou[g], ov[g]), f"chained frame {g}")
    print(f"dryrun_gop_pipeline OK: {G} CHAINED inter frames "
          f"(refresh_mask=0x01, each referencing the previous, in-loop "
          f"filter ON) across {G} gop rows on {dev}, lag-2 stripe pipeline "
          f"with per-step reference-row forwarding under the 8-row finality "
          f"guard, bit-exact vs serial", flush=True)

