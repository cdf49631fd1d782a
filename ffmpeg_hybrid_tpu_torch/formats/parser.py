"""VP9 packet parser: per-packet profile / keyframe / visibility flags
without a full header parse (reference: libavcodec/vp9_parser.c:36-70,
which sets key_frame and pict_type on packets from the same leading
header bits)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from .superframe import split_superframe


@dataclass
class PacketFlags:
    profile: int = 0
    keyframe: bool = False
    shows: bool = False          # emits an output frame (visible or
    #                              show-existing)
    show_existing: bool = False
    invisible: bool = False


def parse_frame_flags(d: bytes) -> PacketFlags:
    """Flags for ONE frame's bitstream (not a superframe)."""
    f = PacketFlags()
    if len(d) < 1:
        raise ValueError("packet too short")
    b0 = d[0]
    if (b0 >> 6) != 0b10:
        raise ValueError("invalid frame marker")
    f.profile = ((b0 >> 5) & 1) | (((b0 >> 4) & 1) << 1)
    bit = 4
    if f.profile == 3:
        bit += 1  # reserved
    f.show_existing = bool((b0 >> (7 - bit)) & 1)
    bit += 1
    if f.show_existing:
        f.shows = True
        return f
    if len(d) < 2:
        raise ValueError("packet too short")
    word = (b0 << 8) | d[1]
    f.keyframe = not ((word >> (15 - bit)) & 1)
    bit += 1
    f.shows = bool((word >> (15 - bit)) & 1)
    f.invisible = not f.shows
    return f


def parse_packet_flags(data: bytes) -> List[PacketFlags]:
    """Flags for every sub-frame of a (possibly superframe) packet."""
    return [parse_frame_flags(d) for _pts, d in split_superframe(data, 0)]
