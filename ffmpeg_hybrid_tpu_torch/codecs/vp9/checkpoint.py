"""Decoder checkpoint/resume: serialize the exact cross-frame state.

The reference keeps this state implicitly in VP9Context (8 reference
slots + refresh mask vp9.c:1688-1692/1849-1851, probability contexts
prob_ctx[4] vp9dec.h:143-146, segmentation map frames, and the previous
header fields that persist across frames vp9.c:519-907). Here it is
explicit and serializable: `state_dict` returns a nested dict of numpy
arrays and scalars (np.savez/orbax-friendly), `load_state_dict`
reconstructs a decoder that continues bit-exactly — the fleet story is
host-failure recovery without redecoding from the stream start (resume
at any frame, not just keyframes).

In the port a frame's planes live on the decoder's device: the state
pulls them to the host (`Frame.sync_host`), so a state taken on the
card loads into a decoder on the CPU and back. Take it between
`decode()` calls, never while a `decode_stream` generator is open: its
pass-A worker runs frames ahead of the ones it has yielded. The
decoder's own device state needs no entry: its kept coefficient
buffers (`coef_bufs`) read zero after every residual, and its splat
index states (`splat_states`) and loop-filter schedule states
(`lf_schedules`) are epoch-tagged, so a restored decoder starts them
fresh.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .header import Header, SegFeature
from .probs import Probs


_STATE_VERSION = 1


def _header_to_dict(h: Header | None):
    if h is None:
        return None
    d = {}
    for f in dataclasses.fields(Header):
        v = getattr(h, f.name)
        if f.name == "seg_feat":
            v = [{g.name: (np.asarray(getattr(sf, g.name)).copy()
                           if g.name in ("qmul", "lflvl")
                           else getattr(sf, g.name))
                  for g in dataclasses.fields(SegFeature)} for sf in v]
        elif isinstance(v, list):
            v = list(v)
        d[f.name] = v
    return d


def _header_from_dict(d):
    if d is None:
        return None
    kw = dict(d)
    kw["seg_feat"] = [SegFeature(**{k: (np.asarray(v).copy()
                                        if k in ("qmul", "lflvl") else v)
                                    for k, v in sf.items()})
                      for sf in d["seg_feat"]]
    return Header(**kw)


def _probs_to_dict(p: Probs):
    d = {f: np.asarray(getattr(p, f)).copy() for f in Probs.FIELDS}
    d["coef"] = np.asarray(p.coef).copy()
    return d


def _probs_from_dict(d):
    p = Probs.defaults()
    for f in Probs.FIELDS:
        getattr(p, f)[...] = d[f]
    p.coef = np.asarray(d["coef"]).copy()
    return p


def _frame_to_dict(f):
    f.sync_host()
    w, h = f.size
    cw, ch = ((w + 7) >> 3) * 8, ((h + 7) >> 3) * 8
    return {
        "size": (w, h), "ss_h": f.ss_h, "ss_v": f.ss_v, "bpp": f.bpp,
        "y": f.planes[0][:ch, :cw].copy(),
        "u": f.planes[1][:ch >> f.ss_v, :cw >> f.ss_h].copy(),
        "v": f.planes[2][:ch >> f.ss_v, :cw >> f.ss_h].copy(),
        "seg_map": f.seg_map.copy(),
        "mv": f.mv.copy(),
        "refs": f.refs.copy(),
    }


def _frame_from_dict(d, device):
    """A Frame with the state's host planes, uploaded once, as int32, to
    `device`: otherwise pass B would upload a restored reference's host
    planes again on every frame that reads it."""
    from .decoder import Frame

    w, h = d["size"]
    f = Frame(w, h, d["ss_h"], d["ss_v"], d["bpp"])
    y, u, v = d["y"], d["u"], d["v"]
    f.planes[0][:y.shape[0], :y.shape[1]] = y
    f.planes[1][:u.shape[0], :u.shape[1]] = u
    f.planes[2][:v.shape[0], :v.shape[1]] = v
    f.seg_map[...] = d["seg_map"]
    f.mv[...] = d["mv"]
    f.refs[...] = d["refs"]
    f.dev = [torch.tensor(p, dtype=torch.int32, device=device)
             for p in f.planes]
    f._host_stale = False
    return f


def state_dict(dec) -> dict:
    """Snapshot everything the next decode() reads: previous header,
    the 4 probability contexts, and the reference/segmap/mvpair frame
    slots (object aliasing preserved via a frame table)."""
    frames = []
    ids = {}

    def fid(f):
        if f is None:
            return -1
        k = id(f)
        if k not in ids:
            ids[k] = len(frames)
            frames.append(_frame_to_dict(f))
        return ids[k]

    return {
        "version": _STATE_VERSION,
        "header": _header_to_dict(dec.header),
        "prob_ctx": [None if p is None else _probs_to_dict(p)
                     for p in dec.prob_ctx],
        "last_keyframe": dec.last_keyframe,
        # rebuilt only when sharpness CHANGES (vp9.c:669-697), so the
        # current tables are cross-frame state
        "lim_lut": np.asarray(dec.lim_lut).copy(),
        "mblim_lut": np.asarray(dec.mblim_lut).copy(),
        "slots": {
            "refs": [fid(f) for f in dec.refs],
            "cur_frame": fid(dec.cur_frame),
            "mvpair_frame": fid(dec.mvpair_frame),
            "segmap_frame": fid(dec.segmap_frame),
        },
        "frames": frames,
    }


def load_state_dict(dec, state: dict):
    """Restore `dec` (a fresh or existing VP9Decoder) from state_dict
    output, its frames on dec.device. Returns dec."""
    if state["version"] != _STATE_VERSION:
        raise ValueError(f"checkpoint version {state['version']} "
                         f"unsupported")
    dec.header = _header_from_dict(state["header"])
    dec.prob_ctx = [None if p is None else _probs_from_dict(p)
                    for p in state["prob_ctx"]]
    dec.last_keyframe = state["last_keyframe"]
    dec.lim_lut = np.asarray(state["lim_lut"]).copy()
    dec.mblim_lut = np.asarray(state["mblim_lut"]).copy()
    frames = [_frame_from_dict(d, dec.device) for d in state["frames"]]

    def at(i):
        return None if i == -1 else frames[i]

    slots = state["slots"]
    dec.refs = [at(i) for i in slots["refs"]]
    dec.cur_frame = at(slots["cur_frame"])
    dec.mvpair_frame = at(slots["mvpair_frame"])
    dec.segmap_frame = at(slots["segmap_frame"])
    dec.cur_frame_obj = dec.cur_frame
    return dec
