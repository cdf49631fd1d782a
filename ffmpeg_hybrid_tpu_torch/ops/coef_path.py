"""The coefficient-kernel path: re-decode a frame's coefficient blocks in
lanes on the card.

`capture_blocks(packet)` runs the pure-Python pass A over one packet
and snapshots, per transform block: the bool-decoder state at the
block's coefficient start, its probability slice, scan and neighbour
tables, initial nnz context and dequant pair, plus the host result
(dequantized raster coefficients and eob). `frame_inputs(groups,
device)` packs the blocks, grouped by transform size, for one launch,
and `decode_blocks` re-decodes them all with ops/rac.decode_coeffs_frame,
one lane per block (or per group with a function of the Pallas kernel's
signature). This is how the JAX package drives its Pallas coefficient
kernel (tests/test_coef_pallas.py, tools/kernel_bench.py), one call per
size there.
"""
from __future__ import annotations

import numpy as np
import torch

from . import rac


class _ReadRecorder:
    """probs11 seen through its [band][ctx][k] indexing, recording the
    flat index band*66 + ctx*11 + k of every entry read."""

    def __init__(self, arr, seen, base=0, stride=66):
        self.arr, self.seen, self.base, self.stride = arr, seen, base, stride

    def __getitem__(self, i):
        i = int(i)
        if self.stride == 1:
            self.seen.add(self.base + i)
            return self.arr[i]
        return _ReadRecorder(self.arr[i], self.seen,
                             self.base + i * self.stride, self.stride // 6)


def capture_blocks(packet, count_work=False):
    """Decode `packet` (a keyframe, or any frame with its decoder state
    fresh) with the pure-Python pass A and return one dict per
    coefficient block. With count_work, each dict also holds the work
    the block needed: "bools" (bool decodes), "stream_bytes" (bytes of
    its window the decoder consumed) and "prob_reads" (the flat indices,
    band*66 + ctx*11 + k, of the probability entries it read)."""
    from ..codecs.vp9.blockdec import TileDecoder
    from ..codecs.vp9.decoder import VP9Decoder
    from ..codecs.vp9.rac import BoolDecoder

    caps = []
    ticks = [0]
    orig = TileDecoder.decode_coeffs_block
    orig_get = BoolDecoder.get_prob

    def counting_get(self, prob):
        ticks[0] += 1
        return orig_get(self, prob)

    def wrapper(self, plane_coef, py, px, tx, is32, probs11, nnz, scan,
                nb, band_counts, qmul, cnt, eobcnt):
        c = self.c
        snap = (c.data, c.byte_pos, c.bit_pos, c.value, c.range)
        t0 = ticks[0]
        seen = set()
        eob = orig(self, plane_coef, py, px, tx, is32,
                   _ReadRecorder(probs11, seen) if count_work else probs11,
                   nnz, scan, nb, band_counts, qmul, cnt, eobcnt)
        # the window starts after the snapshot's partial byte
        start = snap[1] + (1 if snap[2] else 0)
        used_bits = c.byte_pos * 8 + c.bit_pos - start * 8
        sz = 4 << tx
        n = sz * sz
        caps.append({
            "snap": snap, "tx": tx, "is32": bool(is32),
            "probs": np.asarray(probs11, np.int32).reshape(36, 11),
            "nnz": int(nnz),
            "scan": np.asarray(scan[:n], np.int32),
            "nb": np.asarray(nb[:n], np.int32).reshape(n, 2),
            "qmul": np.asarray(qmul[:2], np.int32),
            "coef": np.asarray(plane_coef[py:py + sz, px:px + sz],
                               np.int64).reshape(-1),
            "eob": int(eob),
            "bools": ticks[0] - t0,
            "stream_bytes": min(max(0, -(-used_bits // 8)),
                                len(c.data) - start),
            "prob_reads": np.asarray(sorted(seen), np.int32),
        })
        return eob

    TileDecoder.decode_coeffs_block = wrapper
    if count_work:
        BoolDecoder.get_prob = counting_get
    try:
        dec = VP9Decoder(device="cpu", use_native=False)
        dec.decode_pass_a(packet)
    finally:
        TileDecoder.decode_coeffs_block = orig
        BoolDecoder.get_prob = orig_get
    return caps


def group_by_tx(caps):
    """{tx: [capture, ...]} in capture order."""
    groups = {}
    for c in caps:
        groups.setdefault(c["tx"], []).append(c)
    return groups


def _lane_host(group, Lw=None):
    """decode_coeffs_multi's arguments for one same-size group, numpy.
    Lw bounds each lane's byte window (a block reads far fewer than 4*n
    + 64 bytes)."""
    n = (4 << group[0]["tx"]) ** 2
    starts = [g["snap"][1] + (1 if g["snap"][2] else 0) for g in group]
    if Lw is None:
        Lw = min(max(len(g["snap"][0]) - st
                     for g, st in zip(group, starts)), 4 * n + 64)
    half16 = rac.pack_windows([g["snap"][0] for g in group], starts, Lw)
    value0, rng0, bitbuf0, nbits0 = rac.snapshot_to_state(
        [g["snap"] for g in group], starts)
    host = (half16, value0, rng0, bitbuf0, nbits0,
            np.stack([g["probs"] for g in group]),
            np.stack([g["scan"] for g in group]),
            np.stack([g["nb"][:, 0] for g in group]),
            np.stack([g["nb"][:, 1] for g in group]),
            np.asarray([g["nnz"] for g in group], np.int32),
            np.stack([g["qmul"] for g in group]))
    return tuple(np.ascontiguousarray(a, np.int32) for a in host)


def lane_inputs(group, device, Lw=None):
    """decode_coeffs_multi's arguments for one same-size group, on
    `device` (the Pallas kernel's signature)."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in _lane_host(group, Lw))


def frame_inputs(groups, device, sms=rac.H100_SMS):
    """Every group of a frame packed for one launch (rac.pack_lanes), on
    `device`: a rac.CoefLanes, groups in the order of `groups`."""
    parts = [(*_lane_host(g), (4 << tx) ** 2, g[0]["is32"])
             for tx, g in groups.items()]
    return rac.pack_lanes(parts, sms).to(device)


def decode_blocks(groups, inputs, bpp, fn=None):
    """Re-decode every group: {tx: (coef [S, n], eob [S])}. inputs: a
    frame_inputs(...) of these groups. fn None: every group in one call
    of rac.decode_coeffs_frame (one launch on the card); else fn, with
    decode_coeffs_multi's signature (the plain version, or the one-group
    wrapper), called per group on the lanes unpacked from inputs."""
    if fn is None:
        coef, eob = rac.decode_coeffs_frame(inputs, bpp)
        return dict(zip(groups, rac.split_groups(inputs, coef, eob)))
    return {tx: fn(*args, n=(4 << tx) ** 2, bpp=bpp, is32=group[0]["is32"])
            for (tx, group), args in zip(groups.items(),
                                         rac.group_args(inputs))}
