"""vp9_metadata: rewrite colour-space / colour-range metadata in the
uncompressed frame header of keyframes and (profile>0) intra-only
frames.

Equivalent of the reference BSF
(libavcodec/bsf/vp9_metadata.c:146 LoC — CBS re-parse
+ re-serialize). The colour block sits at a fixed bit position after
the sync code, so instead of a full header re-serialization this
rewrites by BIT SPLICE: emit the header bits up to the colour block,
the new colour bits, then the remaining header bits shifted, re-pad to
the byte boundary, and append the (byte-aligned) compressed header +
tile bytes unchanged. For unchanged-length rewrites this is an
in-place bit overwrite; RGB<->non-RGB on profiles 1/3 changes the
block length and shifts the header tail.

Differential-tested against the oracle's `-bsf:v vp9_metadata`
(tests/test_bsf.py).
"""
from __future__ import annotations

from typing import Optional

CS_UNKNOWN, CS_BT601, CS_BT709, CS_SMPTE170, CS_SMPTE240, CS_BT2020, \
    CS_RESERVED, CS_RGB = range(8)


class _Bits:
    """MSB-first bit cursor over bytes, with appendable output."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def get(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | ((self.data[self.pos >> 3]
                             >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v


def _color_block_span(data: bytes):
    """Locate the colour block: returns (span, p0_intra_only) where
    span is (profile, start_bit, end_bit, cur_cs, cur_range,
    intra_only), or None when this frame carries no colour metadata
    (inter frames, profile-0 intra-only, show-existing).
    p0_intra_only flags the one colour-less case that is implicitly
    BT.601 (vp9_metadata.c:72 warns only for it)."""
    bc = _Bits(data)
    if bc.get(2) != 2:
        raise ValueError("invalid frame marker")
    profile = bc.get(1) | (bc.get(1) << 1)
    if profile == 3:
        if bc.get(1):
            raise ValueError("profile reserved bit set")
    if bc.get(1):          # show_existing_frame
        return None, False
    frame_type = bc.get(1)
    show_frame = bc.get(1)
    errorres = bc.get(1)
    intra_only = 0
    if frame_type != 0:
        intra_only = bc.get(1) if show_frame == 0 else 0
        if errorres == 0:
            bc.get(2)      # reset_frame_context
        if not intra_only or profile == 0:
            return None, bool(intra_only) and profile == 0
    if bc.get(24) != 0x498342:
        raise ValueError("invalid sync code")
    start = bc.pos
    if profile >= 2:
        bc.get(1)          # ten_or_twelve_bit
    cs = bc.get(3)
    rng = 1 if cs == CS_RGB else None
    if cs != CS_RGB:
        rng = bc.get(1)
        if profile in (1, 3):
            bc.get(3)      # ss_h, ss_v, reserved
    elif profile in (1, 3):
        bc.get(1)          # reserved
    return (profile, start, bc.pos, cs, rng, intra_only), False


def _header_total_bits(data: bytes) -> int:
    """Exact bit length of the uncompressed header (via the full
    parser on a throwaway state)."""
    from ..codecs.vp9.header import parse_uncompressed_header

    class _S:
        header = None
        refs = [None] * 8
        cur_frame = None

    h = parse_uncompressed_header(data, _S())
    return h.uncompressed_header_bits


def rewrite_color(data: bytes, color_space: Optional[int] = None,
                  color_range: Optional[int] = None,
                  warn=lambda msg: None) -> bytes:
    """Return `data` with colour metadata rewritten (vp9_metadata.c
    semantics, incl. the RGB warnings/implications); frames without
    colour metadata pass through unchanged."""
    span, p0_intra_only = _color_block_span(data)
    if span is None:
        if color_space is not None and color_space != CS_BT601 \
                and p0_intra_only:
            # profile-0 intra-only frames are implicitly BT.601
            warn("intra-only frames in profile 0 are "
                 "automatically BT.601")
        return data
    profile, start, end, cs, rng, _intra = span

    new_cs = cs if color_space is None else color_space
    if color_space is not None and not (profile & 1) \
            and color_space == CS_RGB:
        warn("RGB incompatible with profiles 0 and 2")
        new_cs = cs
    new_rng = rng if color_range is None else color_range
    if new_cs == CS_RGB:
        if new_rng == 0:
            warn("colour space RGB implicitly sets PC range")
        new_rng = 1

    # original bits as a list for splicing
    bits = [(data[i >> 3] >> (7 - (i & 7))) & 1
            for i in range(len(data) * 8)]
    head = bits[:start]
    tail_start = end

    # rebuild the colour block
    blk = []
    bc = _Bits(data)
    bc.pos = start
    if profile >= 2:
        blk.append(bc.get(1))  # ten/twelve bit kept
    blk += [(new_cs >> 2) & 1, (new_cs >> 1) & 1, new_cs & 1]
    # consume the old cs to keep bc positioned on the old layout
    bc.get(3)
    if new_cs != CS_RGB:
        blk.append(new_rng)
        if profile in (1, 3):
            if cs != CS_RGB:
                bc.get(1)          # old range
                ss = [bc.get(1), bc.get(1), bc.get(1)]
            else:
                bc.get(1)          # old reserved
                # RGB -> non-RGB on profile 1/3: RGB means 4:4:4
                ss = [0, 0, 0]
            blk += ss
        else:
            if cs != CS_RGB:
                bc.get(1)
    else:
        if profile in (1, 3):
            blk.append(0)          # reserved
    assert bc.pos == end or cs == CS_RGB or new_cs == CS_RGB \
        or bc.pos <= end

    total = _header_total_bits(data)
    tail = bits[tail_start:total]
    new_bits = head + blk + tail
    # re-pad to the byte boundary; compressed header + tiles are
    # byte-aligned and copied unchanged
    while len(new_bits) % 8:
        new_bits.append(0)
    out = bytearray(len(new_bits) // 8)
    for i, b in enumerate(new_bits):
        out[i >> 3] |= b << (7 - (i & 7))
    byte_end = (total + 7) // 8
    return bytes(out) + data[byte_end:]
