"""Bitstream-filter chain: the `-bsf` fftools equivalent.

Supported filters (reference: libavcodec/bsf/):
  vp9_superframe_split        split superframes into frame packets
                              (invisible frames get pts None)
  vp9_superframe              merge invisible frames + the next visible
                              frame back into superframes
  vp9_raw_reorder             formats/reorder.py (slot-model reorder)
  vp9_metadata=k=v:k=v        formats/metadata.py colour rewrite
                              (color_space=bt601|bt709|smpte170|
                              smpte240|bt2020|rgb|unknown,
                              color_range=tv|pc) — superframe-aware
                              like the CBS original

`apply_bsf_chain(pkts, "a,b=opt:opt")` maps an iterator of
(pts, data) packets through the comma-separated chain.
"""
from __future__ import annotations

import sys

_CS_NAMES = {"unknown": 0, "bt601": 1, "bt709": 2, "smpte170": 3,
             "smpte240": 4, "bt2020": 5, "rgb": 7}
_CR_NAMES = {"tv": 0, "pc": 1}


def _split_filter(pkts):
    from .superframe import split_superframe
    for pts, data in pkts:
        yield from split_superframe(data, pts)


def _merge_filter(pkts):
    """vp9_superframe: buffer invisible frames, emit a superframe at
    the next visible one (bsf/vp9_superframe.c behavior)."""
    from .superframe import merge_superframe
    from .parser import parse_frame_flags
    pending = []
    for pts, data in pkts:
        try:
            shows = parse_frame_flags(data).shows
        except ValueError:
            shows = True
        if not shows:
            pending.append(data)
            continue
        if pending:
            yield pts, merge_superframe(pending + [data])
            pending = []
        else:
            yield pts, data
    for d in pending:     # trailing invisible frames pass through
        yield None, d


def _reorder_filter(pkts):
    from .reorder import VP9RawReorder
    r = VP9RawReorder()
    for pts, data in pkts:
        yield from r.send(pts, data)
    yield from r.flush()


def _metadata_filter(pkts, opts):
    from .metadata import rewrite_color
    from .superframe import split_superframe, merge_superframe
    cs = cr = None
    for kv in filter(None, opts.split(":")):
        k, _, v = kv.partition("=")
        if k == "color_space":
            cs = _CS_NAMES[v] if v in _CS_NAMES else int(v)
        elif k == "color_range":
            cr = _CR_NAMES[v] if v in _CR_NAMES else int(v)
        else:
            raise ValueError(f"vp9_metadata: unknown option {k}")
    warned = set()

    def warn(msg):
        if msg not in warned:
            warned.add(msg)
            print(f"[vp9_metadata] warning: {msg}", file=sys.stderr)

    for pts, data in pkts:
        subs = split_superframe(data, pts)
        out = [rewrite_color(d, cs, cr, warn) for _p, d in subs]
        if len(out) == 1:
            yield pts, out[0]
        else:
            yield pts, merge_superframe(out)


def apply_bsf_chain(pkts, spec: str):
    for ent in spec.split(","):
        name, _, opts = ent.strip().partition("=")
        if name == "vp9_superframe_split":
            pkts = _split_filter(pkts)
        elif name == "vp9_superframe":
            pkts = _merge_filter(pkts)
        elif name == "vp9_raw_reorder":
            pkts = _reorder_filter(pkts)
        elif name == "vp9_metadata":
            pkts = _metadata_filter(pkts, opts)
        else:
            raise ValueError(f"unknown bitstream filter: {name}")
    return pkts
