"""vp9_raw_reorder: turn a coded-order raw VP9 stream (invisible
altref frames with no pts) into an output stream where every frame is
displayed at the right time, synthesizing 2-byte show-existing-frame
packets when a buffered frame must be displayed after later coded
frames.

Port of the reference BSF's slot model
(libavcodec/bsf/vp9_raw_reorder.c:414 LoC): each coded
frame occupies the reference slots it refreshes; a slot overwrite that
would drop the last copy of an undisplayed frame forces that frame's
display first; output picks the earliest coded (sequence) frame
needing output or the earliest pts needing display, whichever is due.

Differential-tested against the oracle's
`-bsf:v vp9_superframe_split,vp9_raw_reorder` (tests/test_bsf.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple


FRAME_SLOTS = 8


@dataclass(eq=False)
class _Frame:
    data: bytes
    pts: Optional[int]
    sequence: int
    needs_output: bool = True
    needs_display: bool = False
    slots: int = 0
    profile: int = 0
    show_existing_frame: int = 0
    frame_to_show: int = 0
    frame_type: int = 0
    show_frame: int = 0
    refresh_frame_flags: int = 0


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def get(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v


def parse_frame_bits(data: bytes) -> _Frame:
    """The minimal header walk the BSF needs (raw_reorder.c:74-170):
    profile, show-existing, frame type/visibility and the refresh
    mask (with the intra-only colorspace field skipping)."""
    f = _Frame(data=data, pts=None, sequence=0)
    bc = _BitReader(data)
    if bc.get(2) != 2:
        raise ValueError("invalid frame marker")
    f.profile = bc.get(1) | (bc.get(1) << 1)
    if f.profile == 3:
        if bc.get(1):
            raise ValueError("profile reserved bit set")
    f.show_existing_frame = bc.get(1)
    if f.show_existing_frame:
        f.frame_to_show = bc.get(3)
        return f
    f.frame_type = bc.get(1)
    f.show_frame = bc.get(1)
    errorres = bc.get(1)
    if f.frame_type == 0:
        if bc.get(24) != 0x498342:
            raise ValueError("invalid sync code")
        f.refresh_frame_flags = 0xFF
    else:
        intra_only = bc.get(1) if f.show_frame == 0 else 0
        if errorres == 0:
            bc.get(2)  # reset_frame_context
        if intra_only:
            if bc.get(24) != 0x498342:
                raise ValueError("invalid sync code")
            if f.profile > 0:
                if f.profile >= 2:
                    bc.get(1)  # ten_or_twelve_bit
                color_space = bc.get(3)
                if color_space != 7:  # != RGB
                    bc.get(1)  # color_range
                    if f.profile in (1, 3):
                        bc.get(3)  # subsampling + reserved
                elif f.profile in (1, 3):
                    bc.get(1)  # reserved
            f.refresh_frame_flags = bc.get(8)
        else:
            f.refresh_frame_flags = bc.get(8)
    return f


def _show_existing_packet(profile: int, slot: int) -> bytes:
    """2-byte show-existing-frame packet (raw_reorder.c:244-271)."""
    bits = []
    bits += [1, 0]                       # frame marker
    bits.append(profile & 1)
    bits.append((profile >> 1) & 1)
    if profile == 3:
        bits.append(0)
    bits.append(1)                       # show_existing_frame
    bits += [(slot >> 2) & 1, (slot >> 1) & 1, slot & 1]
    while len(bits) < 16:
        bits.append(0)
    out = bytearray(2)
    for i, b in enumerate(bits):
        out[i >> 3] |= b << (7 - (i & 7))
    return bytes(out)


class VP9RawReorder:
    """send(pts, data) -> list of (pts, data) output packets;
    flush() -> remaining packets. pts None marks an invisible frame
    (the superframe splitter's AV_NOPTS equivalent)."""

    def __init__(self):
        self.sequence = 0
        self.slot: List[Optional[_Frame]] = [None] * FRAME_SLOTS

    def _clear_slot(self, s: int):
        fr = self.slot[s]
        if fr is not None:
            fr.slots &= ~(1 << s)
            self.slot[s] = None

    def _make_output(self, last_frame) -> Optional[Tuple]:
        next_output = next_display = last_frame
        seen = []
        for s in range(FRAME_SLOTS):
            fr = self.slot[s]
            if fr is None or any(f is fr for f in seen):
                continue
            seen.append(fr)
            if fr.needs_output and (next_output is None
                                    or fr.sequence < next_output.sequence):
                next_output = fr
            if fr.needs_display and (next_display is None
                                     or fr.pts < next_display.pts):
                next_display = fr
        if next_output is None and next_display is None:
            return None  # EOF
        if next_display is None or (next_output is not None
                                    and next_output.sequence
                                    < next_display.sequence):
            fr = next_output
        else:
            fr = next_display
        if fr.needs_output and fr.needs_display and \
                next_output is next_display:
            fr.needs_output = fr.needs_display = False
            return (fr.pts, fr.data)
        if fr.needs_output:
            fr.needs_output = False
            # out->pts = out->dts (raw_reorder.c): a later-shown frame's
            # coded packet carries no display pts; the display pts rides
            # the later show-existing packet
            return (None if fr.needs_display else fr.pts, fr.data)
        # display-only: synthesize show_existing from the lowest slot
        if fr.slots == 0:
            raise ValueError("displaying a frame no longer in any slot")
        s = (fr.slots & -fr.slots).bit_length() - 1
        fr.needs_display = False
        return (fr.pts, _show_existing_packet(fr.profile, s))

    def send(self, pts: Optional[int], data: bytes) -> List[Tuple]:
        """Feed one coded-order frame (NOT a superframe — split
        first); returns 0+ output packets."""
        if len(data) == 0:
            raise ValueError("empty packet")
        if (data[-1] & 0xE0) == 0xC0:
            raise ValueError("superframe input not supported; split "
                             "with formats.superframe first")
        fr = parse_frame_bits(data)
        fr.pts = pts
        self.sequence += 1
        fr.sequence = self.sequence
        fr.needs_output = True
        fr.needs_display = pts is not None

        out = []
        for s in range(FRAME_SLOTS):
            if not (fr.refresh_frame_flags & (1 << s)):
                continue
            old = self.slot[s]
            if old is not None:
                # overwriting the last copy of an undisplayed frame:
                # it must be displayed now to keep the stream valid
                # (the C BSF returns one packet per filter() call and
                # re-enters this loop until the slot frees up)
                while old.needs_display and old.slots == (1 << s):
                    pkt = self._make_output(old)
                    if pkt is None:
                        raise ValueError("cannot free slot for display")
                    out.append(pkt)
            self._clear_slot(s)
        for s in range(FRAME_SLOTS):
            if fr.refresh_frame_flags & (1 << s):
                self.slot[s] = fr
        fr.slots = fr.refresh_frame_flags

        if not fr.refresh_frame_flags:
            # transient frame: the C BSF keeps re-filtering it until
            # it has been both output and displayed
            while fr.needs_display or fr.needs_output:
                pkt = self._make_output(fr)
                if pkt is None:
                    break
                out.append(pkt)
        return out

    def flush(self) -> List[Tuple]:
        out = []
        while True:
            pkt = self._make_output(None)
            if pkt is None:
                break
            out.append(pkt)
        return out
