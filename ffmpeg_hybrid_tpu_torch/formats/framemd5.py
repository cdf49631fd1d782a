"""framemd5 output + comparison against FATE-style reference files
(reference: tests/fate-run.sh:164-174, libavformat/hashenc.c format)."""
import hashlib


def frame_md5(frame) -> str:
    return hashlib.md5(frame.to_bytes()).hexdigest()


def parse_framemd5(path: str):
    """Parse a framemd5 file into a list of (size, md5hex)."""
    out = []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = [p.strip() for p in line.split(",")]
        if len(parts) >= 6:
            out.append((int(parts[4]), parts[5]))
    return out


def decode_file_md5s(path: str, device=None, use_native=None):
    """Decode an IVF or WebM file and return [(size, md5hex)] per output
    frame. Pass B runs on `device`: the card unless "cpu" is asked
    for."""
    from ..codecs.vp9.decoder import VP9Decoder
    from .ivf import read_ivf
    from .superframe import split_superframe

    if path.endswith(".webm") or path.endswith(".mkv"):
        from .webm import read_webm
        pkts = read_webm(path)
    else:
        info, pkts = read_ivf(path)
    dec = VP9Decoder(device=device, use_native=use_native)
    out = []
    for pts, data in pkts:
        for _fpts, fd in split_superframe(data, pts):
            for f in dec.decode(fd):
                raw = f.to_bytes()
                out.append((len(raw), hashlib.md5(raw).hexdigest()))
    return out
