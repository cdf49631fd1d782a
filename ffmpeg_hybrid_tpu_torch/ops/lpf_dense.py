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

`lf_dense` launches the CUDA kernel (csrc/lpf.cu) for planes on the
card and takes the plain PyTorch version, `lf_dense_plain`, for planes
on the CPU. It counts its kernel launches (one per wave) in LAUNCHES.
"""
from __future__ import annotations

import ctypes

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


# ---------------------------------------------------------------------------
# wrapper: plain version on the CPU, CUDA kernel on the card

_c = ctypes
_SIGNATURES = {
    # pad, B, PH, PW, vgrid, vgw, hgrid, hgw, sb_rows, sb_cols, sbwx,
    # sbwy, bpp, launches (out), stream
    "lpf_frame": [_c.c_void_p, _c.c_int, _c.c_int, _c.c_int, _c.c_void_p,
                  _c.c_int, _c.c_void_p, _c.c_int, _c.c_int, _c.c_int,
                  _c.c_int, _c.c_int, _c.c_int, _c.c_void_p, _c.c_void_p],
}


def lf_dense(planes, vpar, hpar, sb_rows, sb_cols, sbwx, sbwy, bpp):
    """Loop-filter planes [B, Hp, Wp] int32 (Hp = sb_rows * sbwy, Wp =
    sb_cols * sbwx) with the dense grids vpar [Hp/8, Wp/4, 4] and hpar
    [Hp/4, Wp/8, 4] int32. Returns the filtered planes; the input is
    not modified. CPU tensors take lf_dense_plain, any other device the
    kernel (one launch per wave)."""
    if planes.device.type == "cpu":
        return lf_dense_plain(planes, vpar, hpar, sb_rows, sb_cols, sbwx,
                              sbwy, bpp)
    if sbwx % 8 or sbwy % 8 or bpp not in (8, 10, 12):
        raise ValueError(f"unsupported SB span {sbwx}x{sbwy} or bpp={bpp}")
    dev = planes.device
    B, Hp, Wp = planes.shape
    if (Hp, Wp) != (sb_rows * sbwy, sb_cols * sbwx):
        raise ValueError(f"planes {Hp}x{Wp} are not {sb_rows}x{sb_cols} "
                         f"superblocks of {sbwy}x{sbwx}")
    i32 = (torch.int32,)
    planes = check_tensor(planes, i32, (B, Hp, Wp), dev, "planes")
    vg = check_tensor(vpar, i32, (Hp // 8, Wp // 4, 4), dev, "vpar")
    hg = check_tensor(hpar, i32, (Hp // 4, Wp // 8, 4), dev, "hpar")
    # the kernel filters in place on a zero-padded copy: reads past the
    # plane see zeros, as lf_dense_plain's padding gives them
    pad = torch.zeros((B, Hp + 16, Wp + 16), dtype=torch.int32,
                      device=dev)
    pad[:, 8:8 + Hp, 8:8 + Wp] = planes
    launched = _c.c_int(0)
    _cuda.launch("lpf.cu", _SIGNATURES, "lpf_frame", pad, B, Hp + 16,
                 Wp + 16, vg, Wp // 4, hg, Wp // 8, sb_rows, sb_cols, sbwx,
                 sbwy, bpp, _c.addressof(launched))
    LAUNCHES["lf_dense"] += launched.value
    return pad[:, 8:8 + Hp, 8:8 + Wp].contiguous()
