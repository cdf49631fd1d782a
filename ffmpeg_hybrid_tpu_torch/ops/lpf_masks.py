"""Dense loop-filter parameter grids straight from pass A's mask and
level outputs — the counterpart of the JAX package's ops/lpf_masks.py.

Pass A builds, per superblock, the 8x8 filter-level grid and the four
32-word edge masks (vp9_entropy_block.h mask_edges; the walker
semantics live in native/vp9_lpf.c lf_cols/lf_rows, behavioral
reference ff_vp9_loopfilter_sb, vp9lpf.c:183-230). Masks and levels go
to the device in the frame's one flat upload, and `grids_device` turns
them into the dense V/H parameter grids that ops/lpf_dense.py consumes:
on the card with one launch of the CUDA kernel (csrc/lf_grids.cu: a
block per run of superblocks stages their levels and masks in shared
memory, then writes their edges), on the CPU with the plain version,
`grids_device_plain`, which evaluates the walker's decision tree as
tensor ops. Kernel launches are counted in LAUNCHES.

Walker semantics being reproduced (native/vp9_lpf.c):

  * cols (V edges): rows pair up as (a, b) = (it*(2<<ss_v),
    a+1+ss_v); the pair's top row picks wd 16/8/4 from mask classes
    0/1/2; a 16-wide top edge spans both rows ONLY when class 0 is
    set in both (the bottom half then inherits the TOP row's level),
    else the bottom row falls back to its own class-1/2 bits — a
    bottom class-0 bit alone emits nothing, and a top-16 edge
    suppresses the bottom's class-1/2 bits outright.
  * rows (H edges): positions pair as (left, right) 8px halves; a
    16-wide edge needs class 0 on both halves and reuses the LEFT
    level; a right class-0 bit alone degrades to wd 8/4 by class 1.
  * class-3 masks are the 4px-offset edges; they exist only where the
    walker loops them (cols: ss_h==0, rows: ss_v==0).
  * frame boundary: the first 8px-aligned V column (px==0) and H row
    (py==0) of the frame are never filtered.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _cuda
from ._cuda import check_tensor

# kernel launches of grids_device since the last reset_launches()
LAUNCHES = {"lf_grids": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
# lfl, lfm, luts, Vy, Hy, Vu, Hu, sb_rows, sb_cols, ss_h, ss_v, stream
_SIGNATURES = {"lf_grids": [_P] * 7 + [_I] * 4 + [_P]}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _params(wd, L, lim, mblim):
    """(wd, E, I, H) int32 parameter vectors; all zero where wd == 0.
    L indexes the 64-entry limit tables (levels are 6-bit)."""
    Ll = L.long()
    par = torch.stack([wd.to(torch.int32), mblim[Ll], lim[Ll], L >> 4],
                      dim=-1).to(torch.int32)
    return torch.where((wd > 0)[..., None], par, 0)


def _pick(cond, a, b):
    """torch.where over int32 tensors or Python ints, kept int32."""
    return torch.where(cond, a, b).to(torch.int32)


def dense_grids(level, cmask, rmask, lim, mblim, ss_h, ss_v, sb_rows,
                sb_cols):
    """Dense V/H loop-filter parameter grids for ONE plane set.

    level: [nSB, 8, 8] int32 (8x8-block filter levels, luma grid —
    shared by luma and chroma walks). cmask/rmask: [nSB, 8, 4] int32
    (this plane set's cols/rows masks). lim/mblim: [64] int32.
    Returns (V [sb_rows*Rv, sb_cols*Cv, 4], H [sb_rows*Rh,
    sb_cols*Ch, 4]) int32 for the (64>>ss_h) x (64>>ss_v) plane
    superblock, in lpf_dense.dense_params' layout."""
    dev = level.device
    shifts = torch.arange(8, dtype=torch.int32, device=dev)
    cb = (cmask[..., None] >> shifts) & 1      # [nSB, 8, 4, 8]
    rb = (rmask[..., None] >> shifts) & 1
    nSB = level.shape[0]

    def idx(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=dev)

    # ---- cols walk (V edges) ----
    npair = 4 >> ss_v
    a_rows = np.array([it * (2 << ss_v) for it in range(npair)])
    b_rows = a_rows + 1 + ss_v
    # level column per mask bit cx (ss_h: bit pairs share a column)
    lev_cols = idx((np.arange(8) & ~1) if ss_h else np.arange(8))
    h1 = cb[:, idx(a_rows)]                    # [nSB, npair, 4, 8]
    h2 = cb[:, idx(b_rows)]
    La = level[:, idx(a_rows)][:, :, lev_cols]  # [nSB, npair, 8]
    Lb = level[:, idx(b_rows)][:, :, lev_cols]
    k0a, k1a, k2a = h1[:, :, 0], h1[:, :, 1], h1[:, :, 2]
    k0b, k1b, k2b = h2[:, :, 0], h2[:, :, 1], h2[:, :, 2]
    top_any = k0a | k1a | k2a
    top_wd = _pick(top_any == 0, 0,
                   _pick(k0a == 1, 16, _pick(k1a == 1, 8, 4)))
    bot_wd = _pick(k0a == 1, _pick(k0b == 1, 16, 0),
                   _pick(k1b == 1, 8, _pick(k2b == 1, 4, 0)))
    Lbot = torch.where((k0a & k0b) == 1, La, Lb)
    top_par = _params(top_wd, La, lim, mblim)   # [nSB, npair, 8, 4]
    bot_par = _params(bot_wd, Lbot, lim, mblim)
    # interleave rows (top, bottom) -> Rv = 2*npair 8px rows
    par = torch.stack([top_par, bot_par], dim=2).reshape(nSB, 2 * npair,
                                                         8, 4)
    if ss_h == 0:
        toff = _params(h1[:, :, 3] * 4, La, lim, mblim)
        boff = _params(h2[:, :, 3] * 4, Lb, lim, mblim)
        off = torch.stack([toff, boff], dim=2).reshape(nSB, 2 * npair, 8,
                                                       4)
        # interleave cols (aligned, offset) -> Cv = 16 4px positions
        par = torch.stack([par, off], dim=3).reshape(nSB, 2 * npair, 16, 4)
    Rv, Cv = par.shape[1], par.shape[2]
    V = par.reshape(sb_rows, sb_cols, Rv, Cv, 4).permute(0, 2, 1, 3, 4) \
        .reshape(sb_rows * Rv, sb_cols * Cv, 4).clone()
    # frame-left boundary: first 8px-aligned V column never filtered
    V[:, 0] = 0

    # ---- rows walk (H edges) ----
    ncx = 4 >> ss_h
    lb_np = np.array([(2 << ss_h) * c for c in range(ncx)])
    lb_idx, rb_idx = idx(lb_np), idx(lb_np + 1 + ss_h)
    lev_rows = idx((np.arange(8) & ~1) if ss_v else np.arange(8))
    levr = level[:, lev_rows]                  # [nSB, 8, 8]
    Ll = levr[:, :, lb_idx]                    # [nSB, 8, ncx]
    Lr = levr[:, :, rb_idx]
    rl, rr = rb[..., lb_idx], rb[..., rb_idx]  # [nSB, 8, 4, ncx]
    k0l, k1l, k2l = rl[:, :, 0], rl[:, :, 1], rl[:, :, 2]
    k0r, k1r, k2r = rr[:, :, 0], rr[:, :, 1], rr[:, :, 2]
    left_any = k0l | k1l | k2l
    left_wd = _pick(left_any == 0, 0,
                    _pick(k0l == 1, 16, _pick(k1l == 1, 8, 4)))
    right_any = k0r | k1r | k2r
    right_wd = _pick(k0l == 1, _pick(k0r == 1, 16, 0),
                     _pick(right_any == 1, _pick(k1r == 1, 8, 4), 0))
    Lright = torch.where((k0l & k0r) == 1, Ll, Lr)
    l_par = _params(left_wd, Ll, lim, mblim)   # [nSB, 8, ncx, 4]
    r_par = _params(right_wd, Lright, lim, mblim)
    par = torch.stack([l_par, r_par], dim=3).reshape(nSB, 8, 2 * ncx, 4)
    if ss_v == 0:
        ol = _params(rl[:, :, 3] * 4, Ll, lim, mblim)
        orr = _params(rr[:, :, 3] * 4, Lr, lim, mblim)
        off = torch.stack([ol, orr], dim=3).reshape(nSB, 8, 2 * ncx, 4)
        # interleave rows (aligned, offset) -> Rh = 16 4px rows
        par = torch.stack([par, off], dim=2).reshape(nSB, 16, 2 * ncx, 4)
    Rh, Ch = par.shape[1], par.shape[2]
    Hg = par.reshape(sb_rows, sb_cols, Rh, Ch, 4).permute(0, 2, 1, 3, 4) \
        .reshape(sb_rows * Rh, sb_cols * Ch, 4).clone()
    # frame-top boundary: first 8px-aligned H row never filtered
    Hg[0] = 0
    return V, Hg


def grid_shapes(sb_rows, sb_cols, ss_h, ss_v):
    """The shapes of (Vy, Hy, Vuv, Huv) for a frame of sb_rows x sb_cols
    superblocks whose chroma planes have subsampling (ss_h, ss_v)."""
    return [(sb_rows * (8 >> sv), sb_cols * (16 >> sh), 4)
            if v else (sb_rows * (16 >> sv), sb_cols * (8 >> sh), 4)
            for sh, sv in ((0, 0), (ss_h, ss_v)) for v in (True, False)]


def grids_device(lfl, lfm, lfluts, sb_rows, sb_cols, ss_h, ss_v):
    """Grids from the uploaded level/mask/LUT tensors. lfl: [nSB*64]
    int16 levels; lfm: [nSB*128] int32 masks; lfluts: [128] int32
    (lim ++ mblim). Returns (Vy, Hy, Vuv, Huv), int32 in
    grid_shapes(). CPU tensors take grids_device_plain; any other device
    the kernel (csrc/lf_grids.cu, one launch for both plane sets), which
    takes CUDA tensors only."""
    if lfl.device.type == "cpu":
        return grids_device_plain(lfl, lfm, lfluts, sb_rows, sb_cols,
                                  ss_h, ss_v)
    if ss_h not in (0, 1) or ss_v not in (0, 1) or sb_rows < 1 \
            or sb_cols < 1:
        raise ValueError(f"{sb_rows}x{sb_cols} superblocks under "
                         f"subsampling ({ss_h}, {ss_v})")
    nSB, dev = sb_rows * sb_cols, lfl.device
    args = [check_tensor(t, (dt,), (n,), dev, name) for t, dt, n, name in (
        (lfl, torch.int16, nSB * 64, "lfl"),
        (lfm, torch.int32, nSB * 128, "lfm"),
        (lfluts, torch.int32, 128, "lfluts"))]
    outs = [torch.empty(sh, dtype=torch.int32, device=dev)
            for sh in grid_shapes(sb_rows, sb_cols, ss_h, ss_v)]
    _cuda.launch("lf_grids.cu", _SIGNATURES, "lf_grids", *args, *outs,
                 sb_rows, sb_cols, ss_h, ss_v)
    LAUNCHES["lf_grids"] += 1
    return tuple(outs)


def grids_device_plain(lfl, lfm, lfluts, sb_rows, sb_cols, ss_h, ss_v):
    """The plain PyTorch grids_device: dense_grids on each plane set."""
    nSB = sb_rows * sb_cols
    level = lfl.to(torch.int32).reshape(nSB, 8, 8)
    m = lfm.reshape(nSB, 2, 2, 8, 4)
    lim, mblim = lfluts[:64], lfluts[64:]
    uvidx = 1 if (ss_h | ss_v) else 0
    Vy, Hy = dense_grids(level, m[:, 0, 0], m[:, 0, 1], lim, mblim, 0, 0,
                         sb_rows, sb_cols)
    Vu, Hu = dense_grids(level, m[:, uvidx, 0], m[:, uvidx, 1], lim, mblim,
                         ss_h, ss_v, sb_rows, sb_cols)
    return Vy, Hy, Vu, Hu


def lf_buffers(s):
    """The host level, mask and LUT arrays of a pass-A state, as
    grids_device takes them: (int16 levels, int32 masks, int32 lim ++
    mblim)."""
    return (s.lf_level.reshape(-1).astype(np.int16),
            np.ascontiguousarray(s.lf_mask, dtype=np.int32).reshape(-1),
            np.concatenate([s.lim_lut, s.mblim_lut]).astype(np.int32))


def grids_host(s):
    """CPU grids for the current frame's Y and UV plane sets (the
    tests' entry). Returns (Vy, Hy, Vuv, Huv)."""
    h = s.header
    return grids_device(*(torch.from_numpy(a) for a in lf_buffers(s)),
                        s.sb_rows, s.sb_cols, h.ss_h, h.ss_v)


def lf_flags(s):
    """Cheap host flags from the raw masks: (y_any, uv_any), a SUPERSET
    of "the plane set has an active edge" (a set mask bit can still be
    suppressed by the walker; filtering an edgeless plane set is a
    no-op, so over-reporting is safe)."""
    h = s.header
    m = s.lf_mask.reshape(s.sb_rows * s.sb_cols, 2, 2, 8, 4)
    uvidx = 1 if (h.ss_h | h.ss_v) else 0

    def any_edge(cm, rm, ss_h, ss_v):
        return bool(cm[:, :, :3].any() or rm[:, :, :3].any()
                    or (ss_h == 0 and cm[:, :, 3].any())
                    or (ss_v == 0 and rm[:, :, 3].any()))

    return (any_edge(m[:, 0, 0], m[:, 0, 1], 0, 0),
            any_edge(m[:, uvidx, 0], m[:, uvidx, 1], h.ss_h, h.ss_v))
