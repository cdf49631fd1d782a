"""Dense superblock-wavefront loop filter — the counterpart of the JAX
package's ops/lpf_dense.py (`lf_dense`) and ops/lpf_tpu.py
(`filter_lanes_jnp`).

The frame's edges are given as dense parameter grids (lpf_masks): V
edges at (py/8, px/4), H edges at (py/4, px/8), each (wd, E, I, H). The
filter runs as a superblock wavefront: superblock (r, c) depends on
(r, c-1), (r-1, c) and (r-1, c+1) (the top-right SB's V edges reach
into this SB's left margin), so the SBs on a wave of constant 2r + c
are independent and their windows (the SB plus 8 px all round) are
disjoint. Within one SB, V edges run in serial column order and then H
edges in serial row order: the order of ff_vp9_loopfilter_sb
(vp9lpf.c:183-230), which 4px-offset edges (4x4-transform interiors)
need, since edge e writes [e-2, e+1] and edge e+4 reads e.

`lf_frame_` filters a frame's Y and U+V in place: for planes on the card
with one launch of the CUDA kernel (csrc/lpf.cu: a persistent grid that
takes superblocks in the order of `schedule`, each one waiting for the
superblocks it depends on), for planes on the CPU with the plain
PyTorch version, `lf_dense_plain`, per plane set. `lf_dense` is one
plane set on a copy. Kernel launches are counted in LAUNCHES.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import _cuda
from ._cuda import check_tensor

# kernel launches of lf_dense since the last reset_launches()
LAUNCHES = {"lf_dense": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def dense_params(recs, n, Hp, Wp):
    """Splat an edge-record stream [n, 8] (sb, py, px, dir, wd, E, I,
    H) into dense V [Hp/8, Wp/4, 4] and H [Hp/4, Wp/8, 4] int32
    grids."""
    V = np.zeros((Hp // 8, Wp // 4, 4), np.int32)
    Hg = np.zeros((Hp // 4, Wp // 8, 4), np.int32)
    if n:
        r = recs[:n].astype(np.int32)
        v = r[r[:, 3] == 0]
        hh = r[r[:, 3] == 1]
        V[v[:, 1] >> 3, v[:, 2] >> 2] = v[:, 4:8]
        Hg[hh[:, 1] >> 2, hh[:, 2] >> 3] = hh[:, 4:8]
    return torch.from_numpy(V), torch.from_numpy(Hg)


# 15-tap window of the wd16 filter: output k (1..14) sums samples
# k-7..k+7 clamped to the 16-sample window, plus sample k once more
_TAP16 = np.clip(np.arange(1, 15)[:, None] + np.arange(-7, 8)[None, :],
                 0, 15)


def filter_lanes(win, E, I, H, wd, bpp):
    """win: [N, 8, 16] int32 (8 lanes x 16 across-edge samples, edge
    between cols 7|8). E/I/H/wd: [N] int32 (wd in {0, 4, 8, 16}).
    Returns the filtered [N, 8, 16] (reference: loop_filter,
    vp9dsp_template.c:1780-1889)."""
    x = win
    F = 1 << (bpp - 8)
    sh = bpp - 8
    E = (E << sh)[:, None]
    I = (I << sh)[:, None]
    H = (H << sh)[:, None]
    wd = wd[:, None]
    p = [x[..., 7 - i] for i in range(8)]
    q = [x[..., 8 + i] for i in range(8)]
    ab = torch.abs

    fm = ((ab(p[3] - p[2]) <= I) & (ab(p[2] - p[1]) <= I)
          & (ab(p[1] - p[0]) <= I) & (ab(q[1] - q[0]) <= I)
          & (ab(q[2] - q[1]) <= I) & (ab(q[3] - q[2]) <= I)
          & (ab(p[0] - q[0]) * 2 + (ab(p[1] - q[1]) >> 1) <= E))
    fm = fm & (wd > 0)
    flat8in = ((ab(p[3] - p[0]) <= F) & (ab(p[2] - p[0]) <= F)
               & (ab(p[1] - p[0]) <= F) & (ab(q[1] - q[0]) <= F)
               & (ab(q[2] - q[0]) <= F) & (ab(q[3] - q[0]) <= F))
    flat8out = ((ab(p[7] - p[0]) <= F) & (ab(p[6] - p[0]) <= F)
                & (ab(p[5] - p[0]) <= F) & (ab(p[4] - p[0]) <= F)
                & (ab(q[4] - q[0]) <= F) & (ab(q[5] - q[0]) <= F)
                & (ab(q[6] - q[0]) <= F) & (ab(q[7] - q[0]) <= F))
    w16 = fm & (wd >= 16) & flat8out & flat8in
    w8 = fm & (wd >= 8) & flat8in & ~w16
    wn = fm & ~w16 & ~w8

    out = x.clone()
    # wd16: positions 1..14, 15 taps with edge replication
    taps = torch.as_tensor(_TAP16, dtype=torch.long, device=x.device)
    v16 = (x[..., taps].sum(-1, dtype=torch.int32) + x[..., 1:15] + 8) >> 4
    out[..., 1:15] = torch.where(w16[..., None], v16, out[..., 1:15])

    # wd8 flat filter: positions 5..10
    f8 = [
        (p[3] + p[3] + p[3] + 2 * p[2] + p[1] + p[0] + q[0] + 4) >> 3,
        (p[3] + p[3] + p[2] + 2 * p[1] + p[0] + q[0] + q[1] + 4) >> 3,
        (p[3] + p[2] + p[1] + 2 * p[0] + q[0] + q[1] + q[2] + 4) >> 3,
        (p[2] + p[1] + p[0] + 2 * q[0] + q[1] + q[2] + q[3] + 4) >> 3,
        (p[1] + p[0] + q[0] + 2 * q[1] + q[2] + q[3] + q[3] + 4) >> 3,
        (p[0] + q[0] + q[1] + 2 * q[2] + q[3] + q[3] + q[3] + 4) >> 3,
    ]
    out[..., 5:11] = torch.where(w8[..., None], torch.stack(f8, -1),
                                 out[..., 5:11])

    # narrow filter: positions 6..9 (arithmetic >> on negative values)
    maxs = (1 << (bpp - 1)) - 1
    mins = -(1 << (bpp - 1))
    maxp = (1 << bpp) - 1

    def clip_s(v):
        return v.clamp(mins, maxs)

    hev = (ab(p[1] - p[0]) > H) | (ab(q[1] - q[0]) > H)
    fh = clip_s(3 * (q[0] - p[0]) + clip_s(p[1] - q[1]))
    f1h = fh.add(4).clamp(max=maxs) >> 3
    f2h = fh.add(3).clamp(max=maxs) >> 3
    fn = clip_s(3 * (q[0] - p[0]))
    f1n = fn.add(4).clamp(max=maxs) >> 3
    f2n = fn.add(3).clamp(max=maxs) >> 3
    fo = (f1n + 1) >> 1
    f1 = torch.where(hev, f1h, f1n)
    f2 = torch.where(hev, f2h, f2n)
    np1 = torch.where(hev, p[1], (p[1] + fo).clamp(0, maxp))
    np0 = (p[0] + f2).clamp(0, maxp)
    nq0 = (q[0] - f1).clamp(0, maxp)
    nq1 = torch.where(hev, q[1], (q[1] - fo).clamp(0, maxp))
    out[..., 6:10] = torch.where(wn[..., None],
                                 torch.stack([np1, np0, nq0, nq1], -1),
                                 out[..., 6:10])
    return out


def _apply_sub2(sub, par, bpp):
    """sub: [N, 8, 16] windows (edge between cols 7|8); par: [N, 4]
    (wd, E, I, H). Returns (filtered windows with writes restricted to
    each wd's modified range, the [N, 16] write mask)."""
    wd, E, I, H = (par[:, i] for i in range(4))
    filt = filter_lanes(sub, E, I, H, wd, bpp)
    r16 = torch.arange(16, device=sub.device)
    lo = torch.where(wd >= 16, 1, torch.where(wd >= 8, 5, 6))
    hi = torch.where(wd >= 16, 15, torch.where(wd >= 8, 11, 10))
    wmask = ((r16[None, :] >= lo[:, None]) & (r16[None, :] < hi[:, None])
             & (wd > 0)[:, None])
    return torch.where(wmask[:, None, :], filt, sub), wmask


def lf_dense_plain(planes, vpar, hpar, sb_rows, sb_cols, sbwx, sbwy, bpp):
    """The plain PyTorch version of the wavefront filter. planes: [B,
    Hp, Wp] int32 (B=1 for Y, 2 for stacked U+V). vpar/hpar: the dense
    parameter grids. sbwx/sbwy: the superblock span in THIS plane's
    pixels (64 for Y; chroma-scaled for U/V). Returns filtered planes.

    Per wave, every SB row contributes a lane: its window, or for an
    off-wave lane a window of the trash region below the padded plane
    with zeroed parameters. The lanes' V positions (then H positions)
    are filtered in serial order, vectorised over lanes, planes and
    8-px bands; the windows are written back whole."""
    B, Hp, Wp = planes.shape
    dev = planes.device
    npos_v = sbwx // 4          # V edge positions per SB (x-serial)
    npos_h = sbwy // 4          # H edge positions per SB (y-serial)
    nb_v = sbwy // 8            # V row bands
    nb_h = sbwx // 8            # H col bands
    L = sb_rows
    wx, wy = sbwx + 16, sbwy + 16

    # pad: 8 all around + a trash region at the bottom for off-wave
    # lanes' write-back
    pad = torch.zeros((B, 8 + Hp + 8 + wy, 8 + Wp + 8), dtype=planes.dtype,
                      device=dev)
    pad[:, 8:8 + Hp, 8:8 + Wp] = planes
    trash_y = 8 + Hp + 8
    vz = torch.zeros((nb_v, npos_v, 4), dtype=torch.int32, device=dev)
    hz = torch.zeros((npos_h, nb_h, 4), dtype=torch.int32, device=dev)

    nwaves = 2 * (sb_rows - 1) + (sb_cols - 1) + 1
    for w in range(nwaves):
        wins, vps, hps, y0s, x0s = [], [], [], [], []
        for r in range(L):
            c = w - 2 * r
            valid = 0 <= c < sb_cols
            cc = min(max(c, 0), sb_cols - 1)
            y0 = r * sbwy if valid else trash_y
            x0 = cc * sbwx
            wins.append(pad[:, y0:y0 + wy, x0:x0 + wx])
            if valid:
                vps.append(vpar[r * nb_v:(r + 1) * nb_v,
                                cc * npos_v:(cc + 1) * npos_v])
                hps.append(hpar[r * npos_h:(r + 1) * npos_h,
                                cc * nb_h:(cc + 1) * nb_h])
            else:
                vps.append(vz)
                hps.append(hz)
            y0s.append(y0)
            x0s.append(x0)
        win = torch.stack(wins)        # [L, B, wy, wx]
        vp = torch.stack(vps)          # [L, nb_v, npos_v, 4]
        hp = torch.stack(hps)          # [L, npos_h, nb_h, 4]

        # V phase: serial left-to-right positions
        for t in range(npos_v):
            sub = win[:, :, 8:8 + sbwy, 4 * t:4 * t + 16] \
                .reshape(L, B, nb_v, 8, 16)
            par = vp[:, :, t]                        # [L, nb_v, 4]
            par_b = par[:, None].expand(L, B, nb_v, 4)
            out = _apply_sub2(sub.reshape(-1, 8, 16),
                              par_b.reshape(-1, 4), bpp)[0]
            win[:, :, 8:8 + sbwy, 4 * t:4 * t + 16] = \
                out.reshape(L, B, sbwy, 16)
        # H phase: serial top-to-bottom positions
        for t in range(npos_h):
            sub = win[:, :, 4 * t:4 * t + 16, 8:8 + sbwx] \
                .reshape(L, B, 16, nb_h, 8).movedim(2, 4)
            par = hp[:, t]                           # [L, nb_h, 4]
            par_b = par[:, None].expand(L, B, nb_h, 4)
            out = _apply_sub2(sub.reshape(-1, 8, 16),
                              par_b.reshape(-1, 4), bpp)[0]
            out = out.reshape(L, B, nb_h, 8, 16).movedim(4, 2)
            win[:, :, 4 * t:4 * t + 16, 8:8 + sbwx] = \
                out.reshape(L, B, 16, sbwx)

        for r in range(L):
            pad[:, y0s[r]:y0s[r] + wy, x0s[r]:x0s[r] + wx] = win[r]
    return pad[:, 8:8 + Hp, 8:8 + Wp].clone()


def lf_frame_plain_(y, u, v, Vy, Hy, Vu, Hu, sb_rows, sb_cols, ss_h, ss_v,
                    bpp, do_y=True, do_uv=True):
    """The plain version of lf_frame_: lf_dense_plain on Y, then on
    stacked U+V, each result copied back into its planes."""
    for planes, V, H, sbwx, sbwy in _plane_sets(y, u, v, Vy, Hy, Vu, Hu,
                                                ss_h, ss_v, do_y, do_uv):
        out = lf_dense_plain(torch.stack(planes), V, H, sb_rows, sb_cols,
                             sbwx, sbwy, bpp)
        for p, o in zip(planes, out):
            p.copy_(o)


# ---------------------------------------------------------------------------
# the kernel's order of work

def schedule(sb_rows, sb_cols, nsets):
    """The order in which csrc/lpf.cu filters the superblocks of `nsets`
    plane sets of sb_rows x sb_cols: [T, 8] int32, row t for ticket t:
    (set, r, c, its flag, the flags it waits for (dep0, dep1; -1 for
    none), wave, 0). Tickets run wave by wave (2r + c), the sets
    interleaved; SB (r, c) waits for (r, c-1) and for (r-1, c+1), or
    (r-1, c) in the last column, so every earlier ticket comes before it
    or is independent of it."""
    R, C = sb_rows, sb_cols
    rows = []
    for w in range(2 * (R - 1) + C):
        for r in range(max(0, (w - C + 2) // 2), min(R - 1, w // 2) + 1):
            c = w - 2 * r
            for s in range(nsets):
                f = (s * R + r) * C     # flag of (s, r, 0)
                left = f + c - 1 if c else -1
                up = f - C + min(c + 1, C - 1) if r else -1
                rows.append((s, r, c, f + c, left, up, w, 0))
    return np.asarray(rows, np.int32).reshape(-1, 8)


class _Schedule:
    """schedule() on a device, with the kernel's state: a ready flag per
    ticket and two counters, zero before the first launch. Each launch
    takes a new epoch, which its superblocks write to their flags, so
    the flags need no reset between launches."""

    def __init__(self, dev, sb_rows, sb_cols, nsets):
        table = schedule(sb_rows, sb_cols, nsets)
        self.ntickets = len(table)
        self.table = torch.as_tensor(table, device=dev)
        self.state = torch.zeros(self.ntickets + 2, dtype=torch.int32,
                                 device=dev)
        self.epoch = 0
        self._lock = threading.Lock()

    def next_epoch(self):
        """A new epoch, never the same twice, on any thread."""
        with self._lock:
            if self.epoch == 0x7fffffff:    # flags may hold any epoch
                self.state.zero_()
                self.epoch = 0
            self.epoch += 1
            return self.epoch


def schedule_state(store, dev, sb_rows, sb_cols, nsets):
    """The _Schedule of (device, geometry, number of sets) in `store` (a
    dict: a decoder's lf_schedules, which its FrameJobs carry), made at
    first use. Its ticket counter and flags serve one stream: a launch
    takes tickets from the counter and waits only on flags of its own
    epoch, which its own superblocks write, so two launches on one state
    must not run at once. Each decoder owns its store, so decoders on
    streams of their own (the GOP workers of parallel/gop.py) never share
    a state."""
    key = (torch.device(dev), sb_rows, sb_cols, nsets)
    sch = store.get(key)
    if sch is None:
        sch = store[key] = _Schedule(dev, sb_rows, sb_cols, nsets)
    return sch


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, CUDA kernel on the card

# the superblock spans (sbwx, sbwy) the kernel takes: luma and 4:4:4
# chroma, 4:2:0, 4:4:0 and 4:2:2 chroma
_SPANS = ((64, 64), (32, 32), (64, 32), (32, 64))

_c = ctypes
_SIGNATURES = {
    # per set (two): plane 0, plane 1, vgrid, hgrid; nsets, dims,
    # sb_rows, sb_cols, schedule, tickets, state, epoch, bpp, stream
    "lpf_frame": [_c.c_void_p] * 8 + [
        _c.c_int, _c.c_void_p, _c.c_int, _c.c_int, _c.c_void_p, _c.c_int,
        _c.c_void_p, _c.c_int, _c.c_int, _c.c_void_p],
}


def _plane_sets(y, u, v, Vy, Hy, Vu, Hu, ss_h, ss_v, do_y, do_uv):
    """[(planes, V, H, sbwx, sbwy)] of the frame's sets to filter."""
    return ([((y,), Vy, Hy, 64, 64)] if do_y else []) + \
        ([((u, v), Vu, Hu, 64 >> ss_h, 64 >> ss_v)] if do_uv else [])


def _launch(sets, sb_rows, sb_cols, bpp, schedules=None):
    """One launch of csrc/lpf.cu on the plane sets [(planes, V, H, sbwx,
    sbwy)], each plane filtered in place, after checking every tensor, on
    the schedule state of the caller's store `schedules` (a decoder's
    lf_schedules), or on a fresh one of this call when it is None."""
    if bpp not in (8, 10, 12):
        raise ValueError(f"bpp={bpp}")
    dev = sets[0][0][0].device
    i32 = (torch.int32,)
    ptrs, dims = [], []
    for planes, V, H, sbwx, sbwy in sets:
        if (sbwx, sbwy) not in _SPANS or len(planes) not in (1, 2):
            raise ValueError(f"{len(planes)} planes of {sbwx}x{sbwy} "
                             "superblocks: the kernel takes 1 or 2 planes "
                             f"of one of {_SPANS}")
        Hp, Wp = sb_rows * sbwy, sb_cols * sbwx
        for k, p in enumerate(planes):
            check_tensor(p, i32, (Hp, Wp), dev, f"plane {k}")
            if not p.is_contiguous():
                raise ValueError(f"plane {k} is not contiguous: the kernel "
                                 "filters it in place")
        ptrs += [planes[0], planes[1] if len(planes) == 2 else None,
                 check_tensor(V, i32, (Hp // 8, Wp // 4, 4), dev, "vpar"),
                 check_tensor(H, i32, (Hp // 4, Wp // 8, 4), dev, "hpar")]
        dims += [len(planes), sbwx, sbwy]
    ptrs += [None] * (8 - len(ptrs))
    dims = np.asarray(dims + [0] * (6 - len(dims)), np.int32)
    sch = schedule_state({} if schedules is None else schedules, dev,
                         sb_rows, sb_cols, len(sets))
    _cuda.launch("lpf.cu", _SIGNATURES, "lpf_frame", *ptrs, len(sets),
                 dims.ctypes.data, sb_rows, sb_cols, sch.table, sch.ntickets,
                 sch.state, sch.next_epoch(), bpp)
    LAUNCHES["lf_dense"] += 1


def lf_frame_(y, u, v, Vy, Hy, Vu, Hu, sb_rows, sb_cols, ss_h, ss_v, bpp,
              do_y=True, do_uv=True, schedules=None):
    """Loop-filter a frame's planes IN PLACE: y [sb_rows * 64, sb_cols *
    64] int32 with its grids Vy, Hy if do_y; u and v [sb_rows * (64 >>
    ss_v), sb_cols * (64 >> ss_h)] int32 with Vu, Hu if do_uv (grids as
    lf_dense takes them). The caller owns the planes: recon_frame hands
    over the planes it has just reconstructed, and nothing reads them
    unfiltered afterwards. CPU planes take lf_frame_plain_; planes on the
    card the kernel, one launch for both sets, which runs U+V beside Y,
    on the schedule state of `schedules` (schedule_state; None: a fresh
    one)."""
    sets = _plane_sets(y, u, v, Vy, Hy, Vu, Hu, ss_h, ss_v, do_y, do_uv)
    if not sets:
        return
    if sets[0][0][0].device.type == "cpu":
        lf_frame_plain_(y, u, v, Vy, Hy, Vu, Hu, sb_rows, sb_cols, ss_h,
                        ss_v, bpp, do_y, do_uv)
        return
    _launch(sets, sb_rows, sb_cols, bpp, schedules)


def lf_dense(planes, vpar, hpar, sb_rows, sb_cols, sbwx, sbwy, bpp,
             schedules=None):
    """Loop-filter planes [B, Hp, Wp] int32 (Hp = sb_rows * sbwy, Wp =
    sb_cols * sbwx) with the dense grids vpar [Hp/8, Wp/4, 4] and hpar
    [Hp/4, Wp/8, 4] int32. Returns the filtered planes; the input is
    not modified. CPU tensors take lf_dense_plain; any other device the
    kernel of lf_frame_ on a copy, as one plane set (schedules as
    lf_frame_ takes it)."""
    if planes.device.type == "cpu":
        return lf_dense_plain(planes, vpar, hpar, sb_rows, sb_cols, sbwx,
                              sbwy, bpp)
    out = planes.clone(memory_format=torch.contiguous_format)
    _launch([(tuple(out.unbind(0)), vpar, hpar, sbwx, sbwy)], sb_rows,
            sb_cols, bpp, schedules)
    return out
