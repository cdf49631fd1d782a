"""The benchmark's own input preparation: an IVF file read into frame
payloads, superframes split. A frozen copy of the port's
formats/ivf.py read_ivf and formats/superframe.py split_superframe, so
that the input side does not move with the program.

IVF: a 32-byte header ('DKIF', ...), then per packet a 12-byte header
(LE32 size, LE64 pts) and the payload. A VP9 superframe ends in an index
(marker 0b110xxxxx) of its frames' sizes (libavcodec
vp9_superframe_split_bsf.c).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass


@dataclass(frozen=True)
class Packet:
    """One frame payload as the decoder takes it, and whether it puts a
    frame out (show_frame or show_existing_frame)."""
    data: bytes
    visible: bool


def read_ivf(path):
    """((width, height, nframes of the header), [(pts, payload)])."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"DKIF":
        raise ValueError(f"{path}: not an IVF file")
    _ver, hdrlen, _fourcc, w, h, _rate, _scale, nframes, _u = \
        struct.unpack("<HH4sHHIIII", raw[4:32])
    packets, pos = [], hdrlen
    while pos + 12 <= len(raw):
        size, pts = struct.unpack("<IQ", raw[pos:pos + 12])
        pos += 12
        if pos + size > len(raw):
            break
        packets.append((pts, raw[pos:pos + size]))
        pos += size
    return (w, h, nframes), packets


def split_superframe(data):
    """The frames of a packet: a superframe's, or the packet itself."""
    if not data:
        return [data]
    marker = data[-1]
    if (marker & 0xE0) != 0xC0:
        return [data]
    length_size = 1 + ((marker >> 3) & 0x3)
    nb_frames = 1 + (marker & 0x7)
    idx_size = 2 + nb_frames * length_size
    if len(data) < idx_size or data[len(data) - idx_size] != marker:
        return [data]
    idx = data[len(data) + 1 - idx_size:]
    sizes, total = [], 0
    for i in range(nb_frames):
        fs = int.from_bytes(idx[i * length_size:(i + 1) * length_size],
                            "little")
        total += fs
        if fs <= 0 or total > len(data) - idx_size:
            return [data]
        sizes.append(fs)
    frames, off = [], 0
    for fs in sizes:
        frames.append(data[off:off + fs])
        off += fs
    return frames


def is_visible(frame):
    """Whether a frame payload puts a frame out: show_existing_frame, or
    show_frame in its uncompressed header (VP9 spec 6.2)."""
    if len(frame) < 2:
        return True
    bits = int.from_bytes(frame[:2], "big")
    pos = 2                                   # frame_marker

    def bit():
        nonlocal pos
        pos += 1
        return (bits >> (16 - pos)) & 1
    profile = bit() | (bit() << 1)
    if profile == 3:
        bit()                                 # reserved_zero
    if bit():                                 # show_existing_frame
        return True
    bit()                                     # frame_type
    return bool(bit())                        # show_frame


def read_clip(path):
    """((width, height), [Packet]) of an IVF file, superframes split."""
    (w, h, _n), packets = read_ivf(path)
    out = [Packet(fr, is_visible(fr))
           for _pts, data in packets for fr in split_superframe(data)]
    return (w, h), out


def read_framemd5(path):
    """The MD5 of each output frame, in order, from a framemd5 file."""
    with open(path) as f:
        return [line.rsplit(",", 1)[1].strip() for line in f
                if line.strip() and not line.startswith("#")]
