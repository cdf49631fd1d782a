"""Carry one frame's pass-B state across from the JAX package.

`snapshot(job)` reads a FrameJob of either package (duck-typed: it
imports neither) into plain Python and numpy values: the pass-A fields
(decoder._JOB_ATTRS), the host half of `job.pre`, and the reference
frames' planes. `frame_job(snap, device)` builds the port's FrameJob and
reference Frames from such a snapshot. A test can then reconstruct the
same pass-A output, against the same reference planes, with both
packages' recon_frame.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .codecs.vp9.decoder import _JOB_ATTRS, Frame, FrameJob
from .device import resolve

_BLOCK_ATTRS = ("bs", "seg_id", "skip", "intra", "tx", "uvtx", "mode",
                "uvmode", "comp", "ref", "filter", "mv")
# the host products of precompute_host; the device half is rebuilt
_PRE_KEYS = ("levels", "pairs", "pairs_merged", "slabs", "recs",
             "lf_masks", "lf_bufs")


def _host(a):
    """numpy copy of a host or device array of either framework."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.array(a)


def _frame_state(f):
    planes = f.dev if f.dev is not None else f.planes
    return {"size": tuple(f.size), "ss": (f.ss_h, f.ss_v), "bpp": f.bpp,
            "planes": [_host(p).astype(np.int32) for p in planes]}


def snapshot(job) -> dict:
    """Plain-value copy of everything pass B reads from `job`."""
    snap = {}
    for a in _JOB_ATTRS:
        v = getattr(job, a)
        if a == "header":
            v = SimpleNamespace(**vars(v))
        elif a == "cur_frame_obj":
            v = {"size": tuple(v.size), "ss": (v.ss_h, v.ss_v),
                 "bpp": v.bpp}
        elif a == "blocks":
            # only read when there are no native block records
            v = [] if job.block_records is not None else [
                (row, col, tcs, SimpleNamespace(
                    **{k: getattr(b, k) for k in _BLOCK_ATTRS}))
                for row, col, tcs, b in v]
        elif isinstance(v, np.ndarray):
            v = v.copy()
        snap[a] = v
    # reference slots: the same frame may fill several slots
    ids, frames = [], []
    for f in job.refs:
        if f is None:
            ids.append(None)
            continue
        for k, g in enumerate(frames):
            if g is f:
                ids.append(k)
                break
        else:
            ids.append(len(frames))
            frames.append(f)
    snap["refs"] = ids
    snap["ref_frames"] = [_frame_state(f) for f in frames]
    pre = getattr(job, "pre", None)
    snap["pre"] = None if pre is None else {k: pre.get(k)
                                            for k in _PRE_KEYS}
    return snap


def _frame(st, device):
    (w, h), (ss_h, ss_v) = st["size"], st["ss"]
    f = Frame(w, h, ss_h, ss_v, st["bpp"])
    if "planes" in st:
        f.dev = [torch.as_tensor(p, dtype=torch.int32, device=device)
                 for p in st["planes"]]
        f._host_stale = True
    return f


def frame_job(snap, device=None) -> FrameJob:
    """The port's FrameJob for a snapshot; its output frame is fresh
    and its references live on `device`."""
    from .ops import recon
    device = resolve(device)
    job = FrameJob()
    for a in _JOB_ATTRS:
        setattr(job, a, snap[a])
    job.cur_frame_obj = _frame(snap["cur_frame_obj"], device)
    refs = [_frame(st, device) for st in snap["ref_frames"]]
    job.refs = [None if k is None else refs[k] for k in snap["refs"]]
    job.device = device
    job.ready = None
    job.outputs = [job.cur_frame_obj]
    if snap["pre"] is not None:
        pre = dict(snap["pre"])
        if job.header.filter_level and pre["lf_masks"] is None:
            # the JAX package took its record-replay loop filter (or its
            # host one) for this frame: the port takes the masks path
            recon._pack_lf(job, pre)
        pre["flat"] = recon._pack_flat_upload(pre)
        job.pre = pre
    return job
