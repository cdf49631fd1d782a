"""Launchers of pass B's splat, coefficient scatter, residual, MC and
intra kernels (csrc/splat.cu, csrc/itxfm.cu, csrc/mc.cu, csrc/intra.cu):
their ctypes signatures, the launch counters and the host side of the
kernels' tables. The wrappers that choose between a kernel and its plain
version are ops/recon.py's _grids_from_records, scatter_coef,
residual_planes, mc_planes, mc_planes_scaled and _intra_scan_planes;
they call these only with tensors off the CPU, and these raise for
anything but CUDA tensors.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import _cuda
from . import intra_tables as it
from ..codecs.vp9 import tables as T

# kernel launches since the last reset_launches()
LAUNCHES = {"residual": 0, "residual_hbd": 0, "intra": 0, "splat": 0,
            "scatter": 0, "mc": 0, "mc_scaled": 0}

# the splat's outputs in _grids_from_records' order: (dtype, chroma
# plane, trailing dimensions)
_SPLAT_GRIDS = ((torch.bool, False, ()), (torch.int32, False, ()),
               (torch.int32, False, ()), (torch.bool, False, ()),
               (torch.int32, False, ()), (torch.int32, False, (2,)),
               (torch.int32, False, (2, 2)),
               (torch.bool, True, ()), (torch.int32, True, ()),
               (torch.int32, True, ()), (torch.bool, True, ()),
               (torch.int32, True, ()), (torch.int32, True, (2,)),
               (torch.int32, True, (2, 2)))
# the splat's tables, passed by value: block sizes in 8 px units, the
# intra transform type of each mode
_SPLAT_BWH = np.ascontiguousarray(T.BWH_TAB[1], dtype=np.int32)
_SPLAT_ITT = np.ascontiguousarray(T.INTRA_TXFM_TYPE, dtype=np.int32)

# planes one residual launch and one MC launch take
RESIDUAL_MAX_PLANES = MC_MAX_PLANES = 3

# the block sizes the intra tap table holds, in its order
INTRA_SIZES = (4, 8, 16, 32)
# planes one intra launch takes (a cluster of thread blocks each)
INTRA_MAX_PLANES = 3
# ints per plane of the intra kernel's slab layout (intra_meta, padded)
INTRA_META_LEN = 1 + 5 * len(INTRA_SIZES)
# how the tap table holds a mode's predictor (csrc/intra.cu reads these)
TAPS, COLUMN, TM = 0, 1, 2

_c = ctypes
_P, _I = _c.c_void_p, _c.c_int
_SIGNATURES = {
    # pointers (5 a plane), dims (6 a plane), planes, lossless, strays
    # flags (a plane; null unless consuming), stream; cp, rows, columns,
    # ep, rows, flat coef, length, flat eob, length, zero_fill, stream
    "itxfm.cu": {"residual_planes": [_P, _P, _I, _I, _P, _P],
                 "residual_planes_hbd": [_P, _P, _I, _I, _P, _P],
                 "scatter_pairs": [_P, _I, _I, _P, _I, _P, _I, _P, _I, _I,
                                   _P]},
    # pointers (10 a plane), dims (8 a plane), planes, bpp, has_comp,
    # stream; the scaled entry: pointers (10 a plane, then recs and the
    # splat's index), dims (16 a plane), planes, frame ints (18), bpp,
    # has_comp, stream
    "mc.cu": {"mc_planes": [_P, _P, _I, _I, _I, _P],
              "mc_planes_scaled": [_P, _P, _I, _P, _I, _I, _P]},
    # plane, residual, slab of three planes, taps, edges, n, dims, meta,
    # bpp, windows (out), stream
    "intra.cu": {"intra_scan": [_P] * 9 + [_P, _P, _I, _P, _P, _I, _P,
                                           _P]},
    # recs, N, bidx, epoch (state), 14 grids, r4, c4, ss_h, ss_v, bwh,
    # itt (host), stream
    "splat.cu": {"splat": [_P, _I, _P, _c.c_uint]
                 + [_P] * len(_SPLAT_GRIDS) + [_I] * 4 + [_P, _P, _P]},
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def residual(jobs, outs, lossless, strays=None, hbd=False):
    """csrc/itxfm.cu on checked, contiguous tensors: the residuals of up
    to RESIDUAL_MAX_PLANES planes in one launch (hbd: of 10/12-bit
    planes, residual_planes_hbd, counted apart as "residual_hbd"). jobs:
    [(coef [H, W] int16 or int32 (int32 only with hbd), eob4, txsz4,
    txtype4 [H/4, W/4] int8/int16/int32)];
    outs: the [H, W] int32 residuals, one a job. strays: None, or a
    pinned int32 flag a job; then the launch consumes its inputs: it
    clears the eob cells and coefficients it reads, and sets a job's flag
    to 1 where a nonzero eob cell is no root it transforms."""
    n = len(jobs)
    if not 1 <= n <= RESIDUAL_MAX_PLANES or len(outs) != n:
        raise ValueError(f"{n} planes for one residual launch")
    ptrs = []
    dims = np.zeros((n, 6), np.int32)
    for j, ((coef, eob4, txsz4, txtype4), out) in enumerate(zip(jobs, outs)):
        ptrs += [coef, eob4, txsz4, txtype4, out]
        dims[j] = (*coef.shape, int(coef.dtype == torch.int16),
                   eob4.element_size(), txsz4.element_size(),
                   txtype4.element_size())
    if strays is not None:
        if len(strays) != n:
            raise ValueError(f"{len(strays)} strays flags for {n} planes")
        # pinned host memory: its address is the device's address too
        strays = [f.data_ptr() for f in strays]
    name = "residual_planes_hbd" if hbd else "residual_planes"
    _cuda.launch("itxfm.cu", _SIGNATURES["itxfm.cu"], name, ptrs,
                 dims.ctypes.data, n, int(lossless), strays)
    LAUNCHES["residual_hbd" if hbd else "residual"] += 1


def scatter(cp, ep, flat_c, flat_e, zero_fill=True):
    """csrc/itxfm.cu's scatter on checked, contiguous tensors: cp [N, 3]
    (or [N, 4], int32 values) and ep [M, 3] int16 pair rows into flat_c
    [nc] (int16, or int32 for four columns) and flat_e [ne] int16. One
    call: with zero_fill a memset pair and one launch; without, the one
    launch into buffers that read zero already."""
    _cuda.launch("itxfm.cu", _SIGNATURES["itxfm.cu"], "scatter_pairs", cp,
                 cp.shape[0], cp.shape[1], ep, ep.shape[0], flat_c,
                 flat_c.numel(), flat_e, flat_e.numel(), int(zero_fill))
    LAUNCHES["scatter"] += 1


def mc(jobs, outs, bpp, has_comp):
    """csrc/mc.cu on checked, contiguous tensors: the inter pass of up to
    MC_MAX_PLANES planes in one launch. jobs: [(residual [H, W] int32,
    inter4 bool, comp bool (None without has_comp), filt int32 [H/4,
    W/4], refsel int32 [H/4, W/4, 2], mv16 int32 [H/4, W/4, 2, 2], refs
    (three int32 [Hr, Wr]), w, h, mvsx, mvsy)]; outs: the [H, W] int32
    planes, one a job."""
    n = len(jobs)
    if not 1 <= n <= MC_MAX_PLANES or len(outs) != n:
        raise ValueError(f"{n} planes for one MC launch")
    ptrs = []
    dims = np.zeros((n, 8), np.int32)
    for j, (job, out) in enumerate(zip(jobs, outs)):
        residual_, inter4, comp, filt, refsel, mv16, refs, w, h, mvsx, \
            mvsy = job
        ptrs += [*refs, residual_, out, inter4, comp, filt, refsel, mv16]
        dims[j] = (*out.shape, *refs[0].shape, w, h, mvsx, mvsy)
    _cuda.launch("mc.cu", _SIGNATURES["mc.cu"], "mc_planes", ptrs,
                 dims.ctypes.data, n, bpp, int(has_comp))
    LAUNCHES["mc"] += 1


def mc_scaled(jobs, outs, bpp, has_comp, recs, index, scales, steps, cols,
              rows, paths=None):
    """csrc/mc.cu's scaled entry on checked, contiguous tensors: the inter
    pass of up to MC_MAX_PLANES planes of a frame with a reference of
    another size, in one launch. jobs: [(residual [H, W] int32, inter4
    bool, comp bool (None without has_comp), filt int32 [H/4, W/4],
    refsel int32 [H/4, W/4, 2], mvraw int32 [H/4, W/4, 2, 2], refs (three
    int32 planes, each [Hr, Wr] of its own), dims (three visible (w, h)),
    ss_x, ss_y)]; outs: the [H, W] int32 planes, one a job. recs: the
    frame's [N, 36] int16 records; index: the SplatState of the splat
    that made the grids, read at its current epoch; scales, steps: [3][2]
    per slot; cols, rows: the frame's 8x8 block columns and rows; paths:
    None, or an int64 [2] tensor that counts the warps' tile passes on
    the window path and on the walk."""
    n = len(jobs)
    if not 1 <= n <= MC_MAX_PLANES or len(outs) != n:
        raise ValueError(f"{n} planes for one MC launch")
    r4, c4 = (outs[0].shape[0] // 4) << jobs[0][9], \
        (outs[0].shape[1] // 4) << jobs[0][8]
    ptrs = []
    dims = np.zeros((n, 16), np.int32)
    for j, (job, out) in enumerate(zip(jobs, outs)):
        residual_, inter4, comp, filt, refsel, mvraw, refs, rdims, ss_x, \
            ss_y = job
        ptrs += [*refs, residual_, out, inter4, comp, filt, refsel, mvraw]
        dims[j, :4] = (*out.shape, ss_x, ss_y)
        for k, (r, (w, h)) in enumerate(zip(refs, rdims)):
            dims[j, 4 + 4 * k:8 + 4 * k] = (*r.shape, w, h)
    ptrs += [recs, index.bidx, paths]
    frame = np.asarray([recs.shape[0], index.epoch, (r4 + 1) // 2,
                        (c4 + 1) // 2, cols, rows,
                        *np.asarray(scales).reshape(-1),
                        *np.asarray(steps).reshape(-1)],
                       np.int64).astype(np.uint32).view(np.int32)
    _cuda.launch("mc.cu", _SIGNATURES["mc.cu"], "mc_planes_scaled", ptrs,
                 dims.ctypes.data, n, frame.ctypes.data, bpp, int(has_comp))
    LAUNCHES["mc_scaled"] += 1


class SplatState:
    """csrc/splat.cu's state for one device and cell grid of one decoder
    (its splat_states; splat_state): the index grid bidx [units], an
    entry an 8x8 unit, of (epoch << 32) | record entries (int64 here,
    uint64 to the kernel), zero at first. Each call takes a
    new epoch, so the index grid needs no reset between frames; a
    wrapped epoch clears it. The kernel updates the state in stream
    order, so one state serves one stream only: calls on two streams at
    once would share its entries."""

    def __init__(self, dev, units):
        self.bidx = torch.zeros(units, dtype=torch.int64, device=dev)
        self.epoch = 0

    def next_epoch(self):
        if self.epoch == 0xffffffff:    # entries may hold any epoch: clear
            self.bidx.zero_()
            self.epoch = 0
        self.epoch += 1
        return self.epoch


def splat_state(states, dev, r4, c4):
    """The SplatState of (device, r4, c4) in `states` (a dict: a decoder's
    splat_states, which its FrameJobs carry), made at first use. A CUDA
    device without an index is the current one, so that "cuda" and the
    tensors' "cuda:0" find one state."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (dev, r4, c4)
    st = states.get(key)
    if st is None:
        st = states[key] = SplatState(dev, ((r4 + 1) // 2) * ((c4 + 1) // 2))
    return st


def splat(recs, r4, c4, ss_h, ss_v, states=None):
    """csrc/splat.cu on checked, contiguous records recs [N, 36] int16
    (the last row a pad row): the 14 grids of _grids_from_records, Y
    [r4, c4] and chroma [r4 >> ss_v, c4 >> ss_h], in its order, shapes
    and dtypes. An index launch and a gather launch that starts while it
    runs, on the SplatState of (device, r4, c4) in `states` (the
    caller's store: the current stream must be the only one that runs
    the splat on it), or on a fresh one of this call alone when states is
    None. Records not 8-byte aligned (a view at an odd offset) are
    copied first."""
    dev = recs.device
    if recs.data_ptr() % 8:
        recs = recs.clone()
    planes = ((r4, c4), (r4 >> ss_v, c4 >> ss_h))
    outs = [torch.empty(planes[uv] + trail, dtype=dt, device=dev)
            for dt, uv, trail in _SPLAT_GRIDS]
    st = splat_state({} if states is None else states, dev, r4, c4)
    _cuda.launch("splat.cu", _SIGNATURES["splat.cu"], "splat", recs,
                 recs.shape[0], st.bidx, st.next_epoch(), *outs, r4, c4,
                 ss_h, ss_v, _SPLAT_BWH.ctypes.data, _SPLAT_ITT.ctypes.data)
    LAUNCHES["splat"] += 1
    return tuple(outs)


def _tap_word(col):
    """One pixel's weight column of a directional mode as one int32: up
    to three taps at bits 9c..9c+8, each an edge index (7 bits) and a
    weight code (2 bits, weight 16 * (code + 1)), and their count at bits
    27-28."""
    idx = np.flatnonzero(col)
    if not 1 <= len(idx) <= 3 or idx[-1] >= 128:
        raise ValueError(f"a column with taps at {idx.tolist()}")
    word = len(idx) << 27
    for c, j in enumerate(idx):
        w = int(col[j])
        if w not in (16, 32, 48, 64):
            raise ValueError(f"weight {w} has no tap code")
        word |= (int(j) | (w // 16 - 1) << 7) << (9 * c)
    return word


def _size_taps(sz):
    """The tap table's part for one block size, from its weights
    (ops/intra_tables.build_all): 16 ints of descriptors, one per mode,
    kind << 24 | offset of the mode's data from the part's start; then
    each mode's data: a tap word per pixel (TAPS), or the one weight
    column that every pixel of the block shares (COLUMN, zero-padded to a
    multiple of 4), or nothing (TM). Every part and every mode's data
    start at a multiple of 4 ints, so the kernel reads 4 tap words as one
    int4."""
    W = it.build_all(sz)
    desc, data, o = np.zeros(16, np.int64), [], 16
    for m in range(15):
        w = W[m]
        if m == it.TM:
            desc[m] = TM << 24
            continue
        if (w == w[:, :1]).all():
            kind, vals = COLUMN, np.pad(w[:, 0], (0, -len(w) % 4))
        else:
            kind, vals = TAPS, [_tap_word(w[:, p]) for p in range(w.shape[1])]
        desc[m] = kind << 24 | o
        data.append(vals)
        o += len(vals)
    return np.concatenate([desc] + data).astype(np.int32)


@lru_cache(maxsize=None)
def _tap_parts():
    return tuple(_size_taps(sz) for sz in INTRA_SIZES)


def tap_offsets():
    """{sz: offset of that size's part in tap_table()}."""
    offs, o = {}, 0
    for sz, part in zip(INTRA_SIZES, _tap_parts()):
        offs[sz] = o
        o += len(part)
    return offs


def tap_table():
    """The predictors of every size in the form csrc/intra.cu reads
    (_size_taps), int32, concatenated in INTRA_SIZES order."""
    return np.concatenate(_tap_parts())


@lru_cache(maxsize=None)
def _taps_on(device):
    return torch.as_tensor(tap_table(), device=device)


def intra_meta(sizes, caps, L):
    """The slab layout as csrc/intra.cu reads it: rows of one level, then
    per section sz, cap, first slab row, edge length and the offset of
    the size's part of the tap table."""
    toff = tap_offsets()
    meta = [sum(caps)]
    base = 0
    for sz, cap in zip(sizes, caps):
        meta += [sz, cap, base, it.edge_len(sz), toff[sz]]
        base += L * cap
    return np.asarray(meta, np.int32)


def intra(jobs, bpp, edges):
    """csrc/intra.cu on checked, contiguous tensors: the wavefronts of up
    to INTRA_MAX_PLANES planes in one launch, side by side, each in place
    on its plane. jobs: [(plane [H, W] int32, residual [H, W] int32, slab
    [tot, 8] int16, L, sizes, caps)]; edges: the [15, 4] int32 EDGES
    table. Returns per plane the windows the kernel took each level in
    (the rows of a level whose edge vectors fit its shared memory at
    once)."""
    n = len(jobs)
    if not 1 <= n <= INTRA_MAX_PLANES:
        raise ValueError(f"{n} planes for one intra launch")
    ptrs = [None] * (3 * INTRA_MAX_PLANES)
    dims = np.zeros((n, 5), np.int32)
    meta = np.zeros((n, INTRA_META_LEN), np.int32)
    for j, (plane, residual_, slab, L, sizes, caps) in enumerate(jobs):
        ptrs[3 * j:3 * j + 3] = plane, residual_, slab
        dims[j] = (*plane.shape, L, len(sizes), slab.shape[0])
        m = intra_meta(sizes, caps, L)
        meta[j, :len(m)] = m
    windows = (_c.c_int * n)()
    _cuda.launch("intra.cu", _SIGNATURES["intra.cu"], "intra_scan", *ptrs,
                 _taps_on(jobs[0][0].device), edges, n, dims.ctypes.data,
                 meta.ctypes.data, bpp, _c.addressof(windows))
    LAUNCHES["intra"] += 1
    return list(windows)


def spread_slab(slab, caps_to, Hp, Wp, seed=0):
    """The intra slab `slab` = (buf, L, sizes, caps) of an Hp x Wp plane
    re-packed with the wider caps `caps_to`, each level's blocks moved to
    slots drawn at random among its new ones (the order of a level's
    blocks does not matter, since they are independent). With enough
    rows per level, one level spans several of the intra kernel's
    windows; this checks that path on any slab."""
    buf, L, sizes, caps = slab
    rng = np.random.RandomState(seed)
    out = np.zeros((L * sum(caps_to), 8), np.int16)
    out[:] = (Hp + 64, Wp + 64, 2, 0, 0, 0, 1, 1)     # inert rows
    src = dst = 0
    for cap, cap_to in zip(caps, caps_to):
        if cap_to < cap:
            raise ValueError(f"cap {cap_to} < {cap}")
        for lvl in range(L):
            rows = buf[src + lvl * cap:src + (lvl + 1) * cap]
            rows = rows[rows[:, 0] < Hp]
            slots = rng.choice(cap_to, len(rows), replace=False)
            out[dst + lvl * cap_to + slots] = rows
        src += L * cap
        dst += L * cap_to
    return out, L, sizes, tuple(caps_to)
