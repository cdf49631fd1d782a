"""WebM/Matroska demuxer (and minimal muxer) for VP9 tracks.

Parses the EBML structure (behavioral reference: the subset of
libavformat/matroskadec.c needed for VP9-in-WebM: Segment/Tracks/Cluster/
SimpleBlock + BlockGroup + all three lacing modes), yielding
(pts_ms, packet) for the first VP9 video track.

Malformed input raises ValueError — never hangs or reads out of bounds.
`write_webm` is the inverse (SimpleBlock / BlockGroup / laced variants)
used to build container test vectors the oracle demuxer cross-checks.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

# EBML element IDs (with length/marker bits, as read)
EBML_HEADER = 0x1A45DFA3
SEGMENT = 0x18538067
SEGMENT_INFO = 0x1549A966
TIMECODE_SCALE = 0x2AD7B1
TRACKS = 0x1654AE6B
TRACK_ENTRY = 0xAE
TRACK_NUMBER = 0xD7
TRACK_TYPE = 0x83
CODEC_ID = 0x86
CLUSTER = 0x1F43B675
CLUSTER_TIMECODE = 0xE7
SIMPLE_BLOCK = 0xA3
BLOCK_GROUP = 0xA0
BLOCK = 0xA1

_UNKNOWN = -1  # sentinel for unknown-size elements


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.d)

    def _need(self, n: int):
        if self.pos + n > len(self.d):
            raise ValueError("truncated EBML")

    def read_id(self) -> int:
        self._need(1)
        b0 = self.d[self.pos]
        n = 1
        mask = 0x80
        while n <= 4 and not (b0 & mask):
            mask >>= 1
            n += 1
        if n > 4:
            raise ValueError("invalid EBML ID")
        self._need(n)
        v = 0
        for i in range(n):
            v = (v << 8) | self.d[self.pos + i]
        self.pos += n
        return v

    def read_size(self) -> int:
        """EBML data-size vint; returns _UNKNOWN for the all-ones value."""
        self._need(1)
        b0 = self.d[self.pos]
        n = 1
        mask = 0x80
        while n <= 8 and not (b0 & mask):
            mask >>= 1
            n += 1
        if n > 8:
            raise ValueError("invalid EBML size")
        self._need(n)
        v = b0 & (mask - 1)
        for i in range(1, n):
            v = (v << 8) | self.d[self.pos + i]
        self.pos += n
        if v == (1 << (7 * n)) - 1:
            return _UNKNOWN
        return v

    def read_uint(self, size: int) -> int:
        self._need(size)
        v = 0
        for i in range(size):
            v = (v << 8) | self.d[self.pos + i]
        self.pos += size
        return v

    def read_vint(self) -> int:
        """Unsigned vint (same wire format as a size, no unknown case)."""
        v = self.read_size()
        if v == _UNKNOWN:
            raise ValueError("unexpected unknown-size vint")
        return v

    def read_svint(self) -> int:
        """Signed vint (EBML lacing deltas): value - (2^(7n-1) - 1)."""
        self._need(1)
        b0 = self.d[self.pos]
        n = 1
        mask = 0x80
        while n <= 8 and not (b0 & mask):
            mask >>= 1
            n += 1
        if n > 8:
            raise ValueError("invalid lace svint")
        self._need(n)
        v = b0 & (mask - 1)
        for i in range(1, n):
            v = (v << 8) | self.d[self.pos + i]
        self.pos += n
        return v - ((1 << (7 * n - 1)) - 1)


def _lace_sizes(br: _Reader, lacing: int, total_end: int) -> List[int]:
    """Frame sizes for one (Simple)Block given its lacing mode.

    reference: matroskadec.c matroska_parse_laces: 0=none, 1=Xiph,
    2=fixed, 3=EBML. The LAST frame's size is implied by the block end.
    """
    if lacing == 0:
        return [total_end - br.pos]
    n_frames = br.read_uint(1) + 1
    sizes: List[int] = []
    if lacing == 1:  # Xiph: 255-run coded sizes for first n-1 frames
        for _ in range(n_frames - 1):
            sz = 0
            while True:
                b = br.read_uint(1)
                sz += b
                if b != 255:
                    break
            sizes.append(sz)
    elif lacing == 2:  # fixed: equal sizes
        payload = total_end - br.pos
        if n_frames == 0 or payload % n_frames:
            raise ValueError("invalid fixed-lace block")
        return [payload // n_frames] * n_frames
    else:  # EBML: first absolute, then signed deltas
        sz = br.read_vint()
        sizes.append(sz)
        for _ in range(n_frames - 2):
            sz += br.read_svint()
            if sz < 0:
                raise ValueError("negative lace size")
            sizes.append(sz)
    used = sum(sizes)
    last = total_end - br.pos - used
    if last < 0:
        raise ValueError("lace sizes exceed block")
    sizes.append(last)
    return sizes


def read_webm(path: str) -> Iterator[Tuple[Optional[int], bytes]]:
    """Yield (pts_ms, packet_bytes) for the first VP9 track."""
    data = open(path, "rb").read()
    r = _Reader(data)
    if not data.startswith(b"\x1a\x45\xdf\xa3"):
        raise ValueError("not an EBML/WebM file")
    vp9_track: Optional[int] = None
    timecode_scale = 1000000  # ns per tick (default: 1 ms)

    def parse_tracks(end):
        nonlocal vp9_track
        while r.pos < end:
            eid = r.read_id()
            esz = r.read_size()
            if esz == _UNKNOWN:
                raise ValueError("unknown-size track entry")
            eend = r.pos + esz
            if eid == TRACK_ENTRY:
                tnum = None
                ttype = None
                codec = None
                while r.pos < eend:
                    fid = r.read_id()
                    fsz = r.read_size()
                    if fsz == _UNKNOWN or r.pos + fsz > eend:
                        raise ValueError("bad track field size")
                    if fid == TRACK_NUMBER:
                        tnum = r.read_uint(fsz)
                    elif fid == TRACK_TYPE:
                        ttype = r.read_uint(fsz)
                    elif fid == CODEC_ID:
                        codec = r.d[r.pos:r.pos + fsz]
                        r.pos += fsz
                    else:
                        r.pos += fsz
                if ttype == 1 and codec == b"V_VP9" and vp9_track is None:
                    vp9_track = tnum
            else:
                r.pos = eend

    def parse_block(blk, cluster_tc, simple):
        br = _Reader(blk)
        track = br.read_vint()
        rel_tc = int.from_bytes(blk[br.pos:br.pos + 2], "big", signed=True)
        br.pos += 2
        br._need(1)
        flags = blk[br.pos]
        br.pos += 1
        lacing = (flags >> 1) & 3
        if track != vp9_track:
            return
        pts = cluster_tc + rel_tc
        for sz in _lace_sizes(br, lacing, len(blk)):
            br._need(sz)
            yield pts, blk[br.pos:br.pos + sz]
            br.pos += sz
            pts = None  # laced frames carry no individual timestamps

    while not r.eof():
        eid = r.read_id()
        esz = r.read_size()
        end = len(data) if esz == _UNKNOWN else r.pos + esz
        if eid == SEGMENT:
            end = min(end, len(data))
            while r.pos < end:
                sid = r.read_id()
                ssz = r.read_size()
                if ssz == _UNKNOWN:
                    if sid != CLUSTER:
                        raise ValueError("unknown-size non-cluster element")
                    # unknown-size cluster: runs until the next cluster ID
                    # or segment end (streamed files)
                    nxt = data.find(b"\x1f\x43\xb6\x75", r.pos)
                    ssz = (end if nxt < 0 else nxt) - r.pos
                send = r.pos + ssz
                if send > len(data):
                    raise ValueError("element overruns file")
                if sid == TRACKS:
                    parse_tracks(send)
                    r.pos = send
                elif sid == SEGMENT_INFO:
                    while r.pos < send:
                        fid = r.read_id()
                        fsz = r.read_size()
                        if fsz == _UNKNOWN or r.pos + fsz > send:
                            raise ValueError("bad info field")
                        if fid == TIMECODE_SCALE:
                            timecode_scale = r.read_uint(fsz)
                        else:
                            r.pos += fsz
                elif sid == CLUSTER:
                    cluster_tc = 0
                    while r.pos < send:
                        cid = r.read_id()
                        csz = r.read_size()
                        if csz == _UNKNOWN or r.pos + csz > send:
                            raise ValueError("bad cluster child")
                        cend = r.pos + csz
                        if cid == CLUSTER_TIMECODE:
                            cluster_tc = r.read_uint(csz)
                        elif cid == SIMPLE_BLOCK:
                            yield from parse_block(r.d[r.pos:cend],
                                                   cluster_tc, True)
                            r.pos = cend
                        elif cid == BLOCK_GROUP:
                            while r.pos < cend:
                                gid = r.read_id()
                                gsz = r.read_size()
                                if gsz == _UNKNOWN or r.pos + gsz > cend:
                                    raise ValueError("bad block group")
                                gend = r.pos + gsz
                                if gid == BLOCK:
                                    yield from parse_block(
                                        r.d[r.pos:gend], cluster_tc, False)
                                r.pos = gend
                            r.pos = cend
                        else:
                            r.pos = cend
                else:
                    r.pos = send
        else:
            if end > len(data):
                raise ValueError("element overruns file")
            r.pos = end


# ---------------------------------------------------------------------------
# Minimal muxer — builds the exact structures the demuxer must handle
# (SimpleBlock, BlockGroup/Block, Xiph/fixed/EBML lacing), validated
# against the oracle's matroska demuxer in tools/make_webm_vectors.py.

def _vint_size(v: int, n: int) -> bytes:
    """Size vint with explicit length n."""
    assert v < (1 << (7 * n)) - 1
    v |= 1 << (7 * n)
    return v.to_bytes(n, "big")


def _elem(eid: int, payload: bytes) -> bytes:
    idb = eid.to_bytes((eid.bit_length() + 7) // 8, "big")
    return idb + _vint_size(len(payload), 8) + payload


def _uint_elem(eid: int, v: int, width: int = 0) -> bytes:
    n = max(1, width or (v.bit_length() + 7) // 8)
    return _elem(eid, v.to_bytes(n, "big"))


def _svint(v: int) -> bytes:
    """Signed vint for EBML lacing deltas (4-byte form)."""
    return _vint_size(v + ((1 << 27) - 1), 4)


def _xiph_len(n: int) -> bytes:
    return b"\xff" * (n // 255) + bytes([n % 255])


def write_webm(path: str, w: int, h: int,
               packets: List[Tuple[int, bytes]],
               block_groups: bool = False,
               lacing: Optional[str] = None,
               lace_group: int = 3,
               track_number: int = 1,
               codec: bytes = b"V_VP9"):
    """Write a minimal VP9 WebM. `packets` = [(pts_ms, bytes)].

    lacing: None | "xiph" | "fixed" | "ebml" — packs runs of `lace_group`
    packets into one laced (Simple)Block (their pts collapse to the run
    head, as lacing discards per-frame timestamps).
    """
    ebml = _elem(EBML_HEADER, b"".join([
        _uint_elem(0x4286, 1),        # EBMLVersion
        _uint_elem(0x42F7, 1),        # EBMLReadVersion
        _uint_elem(0x42F2, 4),        # EBMLMaxIDLength
        _uint_elem(0x42F3, 8),        # EBMLMaxSizeLength
        _elem(0x4282, b"webm"),       # DocType
        _uint_elem(0x4287, 2),        # DocTypeVersion
        _uint_elem(0x4285, 2),        # DocTypeReadVersion
    ]))
    info = _elem(SEGMENT_INFO, b"".join([
        _uint_elem(TIMECODE_SCALE, 1000000),
        _elem(0x4D80, b"ffmpeg_hybrid_tpu"),   # MuxingApp
        _elem(0x5741, b"ffmpeg_hybrid_tpu"),   # WritingApp
    ]))
    video = _elem(0xE0, _uint_elem(0xB0, w) + _uint_elem(0xBA, h))
    track = _elem(TRACKS, _elem(TRACK_ENTRY, b"".join([
        _uint_elem(TRACK_NUMBER, track_number),
        _uint_elem(0x73C5, track_number),      # TrackUID
        _uint_elem(TRACK_TYPE, 1),
        _elem(CODEC_ID, codec),
        video,
    ])))

    def block_bytes(rel_tc: int, frames: List[bytes], keyframe: bool,
                    simple: bool) -> bytes:
        lace_id = {"xiph": 1, "fixed": 2, "ebml": 3}.get(lacing or "", 0)
        if len(frames) == 1:
            lace_id = 0
        flags = (0x80 if (keyframe and simple) else 0) | (lace_id << 1)
        hdr = _vint_size(track_number, 1) + \
            rel_tc.to_bytes(2, "big", signed=True) + bytes([flags])
        if lace_id == 0:
            body = frames[0] if len(frames) == 1 else b"".join(frames)
        else:
            body = bytes([len(frames) - 1])
            if lace_id == 1:
                for f in frames[:-1]:
                    body += _xiph_len(len(f))
            elif lace_id == 2:
                assert len({len(f) for f in frames}) == 1, \
                    "fixed lacing needs equal sizes"
            else:
                body += _vint_size(len(frames[0]), 4)
                for a, b in zip(frames, frames[1:-1]):
                    body += _svint(len(b) - len(a))
            body += b"".join(frames)
        blk = hdr + body
        if simple:
            return _elem(SIMPLE_BLOCK, blk)
        return _elem(BLOCK_GROUP, _elem(BLOCK, blk))

    clusters = b""
    group = lace_group if lacing else 1
    i = 0
    while i < len(packets):
        run = packets[i:i + group]
        if lacing == "fixed" and len({len(p) for _, p in run}) != 1:
            run = run[:1]  # unequal sizes: fall back to a lone block
        pts0 = run[0][0]
        payload = _uint_elem(CLUSTER_TIMECODE, pts0, 2)
        payload += block_bytes(0, [p for _, p in run],
                               keyframe=(i == 0), simple=not block_groups)
        clusters += _elem(CLUSTER, payload)
        i += len(run)

    segment = _elem(SEGMENT, info + track + clusters)
    with open(path, "wb") as fh:
        fh.write(ebml + segment)
