"""Record-replay loop filter: the wavefront replay of the loop filter's
exact edge-call sequence, the counterpart of the JAX package's
ops/lpf_tpu.py (`pack_schedule`, `_lf_scan`) and of the sharded scan of
its parallel/fullframe.py (`_lf_apply_step`, `_lf_scan_sharded`).

The mask walker's edge calls (ops/lpf_walk.py, or the native recorder
passa_native.lpf_record_native) come as records (sb, py, px, dir, wd, E,
I, H) in the reference's order. Superblock (r, c) depends on (r, c-1),
(r-1, c) and (r-1, c+1), so the superblocks of a wave of constant 2r + c
are independent: `pack_schedule` puts substep k of every superblock of a
wave into one step [D lanes, 7], a lane per superblock row, and the
replay runs the steps in order.

`lf_scan` replays the steps over a plane set [B, H, W] (Y alone, or U and
V stacked: the chroma records apply to both). `lf_scan_sharded` replays
per-stripe steps over the tile-column stripes of a frame, [T, B, H, HALO +
Wpad] (columns 0..HALO of a stripe hold a copy of its left neighbour's
last HALO real columns; its own columns follow), and after every step
merges the copies both ways: a pixel that a stripe's step changed wins
over the stale copy (the wave's records of two stripes never touch the
same pixel, so at most one side changes it).

For planes on the card both run csrc/lpf_replay.cu, one launch a plane
set (one thread block a stripe, the stripes of a frame in one cluster);
for planes on the CPU the plain versions, lf_scan_plain and
lf_scan_sharded_plain, a Python loop over the steps. Launches are counted
in LAUNCHES.

JAX clamps gather indices and drops scatters outside the array; here a
window's reads clamp to the buffer and only a record's written range
(wd > 0) is stored, inside the buffer.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _cuda
from ._cuda import check_tensor
from .lpf_dense import filter_lanes

# columns of a stripe's halo: the left neighbour's last HALO columns
HALO = 8

# kernel launches of lf_scan and lf_scan_sharded since the last
# reset_launches()
LAUNCHES = {"lf_replay": 0}

# stripes one launch takes (the portable cluster size)
MAX_STRIPES = 8

_SIGNATURES = {
    # planes, steps, wreal (host), T, B, H, Wb, S, D, steps run, halo,
    # bpp, stream
    "lf_replay": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [
        ctypes.c_int] * 9 + [ctypes.c_void_p],
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pack_schedule(recs, n, sb_cols, bucket=True):
    """Group records [n, 8] (sb, py, px, dir, wd, E, I, H) into wavefront
    steps [S, D, 7]. Superblocks on the same 2r+c wave are
    independent; within a superblock the order is preserved."""
    if n == 0:
        return np.zeros((0, 1, 7), np.int32)
    r = recs[:n].astype(np.int32)
    sb = r[:, 0]
    sbr = sb // sb_cols
    sbc = sb % sb_cols
    # dependency set of SB (r,c): (r,c-1), (r-1,c) and (r-1,c+1) — the
    # top-right SB's vertical edges modify this SB's left write margin —
    # so the safe wavefront is w = 2r + c (all deps in waves w-1/w-2)
    wave = 2 * sbr + sbc
    # per-record substep index within its SB (records are emitted
    # contiguously per SB, in order)
    order = np.arange(n, dtype=np.int64)
    change = np.empty(n, bool)
    change[0] = True
    change[1:] = sb[1:] != sb[:-1]
    group_start = np.maximum.accumulate(np.where(change, order, 0))
    sub = order - group_start
    nwaves = int(wave.max()) + 1
    # step row base per wave = cumulative max substeps
    max_sub = np.zeros(nwaves, np.int64)
    np.maximum.at(max_sub, wave, sub + 1)
    base = np.zeros(nwaves, np.int64)
    base[1:] = np.cumsum(max_sub)[:-1]
    S = int(np.cumsum(max_sub)[-1])
    # lane within step: sbr is unique within an anti-diagonal wave
    lane = sbr
    D = int(lane.max()) + 1
    steps = np.zeros((S, D, 7), np.int32)
    rows = base[wave] + sub
    steps[rows, lane] = r[:, 1:8]
    if bucket:
        S2 = 64
        while S2 < S:
            S2 *= 2
        if S2 != S:
            pad = np.zeros((S2 - S, D, 7), np.int32)
            steps = np.concatenate([steps, pad], axis=0)
    return steps


def steps_run(steps):
    """The steps of [..., S, D, 7] up to the last one with a record (wd >
    0) in any stripe: the bucket's padding steps are no-ops."""
    live = np.nonzero((np.asarray(steps)[..., 3] > 0).reshape(
        -1, *steps.shape[-3:-1]).any(axis=(0, 2)))[0]
    return int(live[-1]) + 1 if len(live) else 0


# ---------------------------------------------------------------------------
# plain versions

def _write_range(wd):
    """The samples [lo, hi) of a record's 16 that its filter may write."""
    lo = torch.where(wd >= 16, 1, torch.where(wd >= 8, 5, 6))
    hi = torch.where(wd >= 16, 15, torch.where(wd >= 8, 11, 10))
    return lo, hi


def apply_step_plain(pl, rec, bpp):
    """One wave step over T stripes at once, in place: pl [T, B, H, W]
    int32, rec [T, D, 7] int32 records (py, px, dir, wd, E, I, H), stripe
    t's on its own buffer; wd == 0 is a no-op. Each record reads the 8 x
    16 window across its edge (rows py..py+7 around column px for dir 0,
    columns px..px+7 around row py for dir 1), indices clamped to the
    buffer, and stores the filtered samples of its write range. Returns
    pl."""
    T, B, H, W = pl.shape
    D = rec.shape[1]
    dev = pl.device
    r = rec.to(torch.int64)
    py, px, dr, wd, E, I, Ht = (r[..., i] for i in range(7))
    r8 = torch.arange(8, device=dev)
    r16 = torch.arange(16, device=dev)
    # lane k, sample j of each record: dir 0 (row py + k, column px - 8 +
    # j), dir 1 (row py - 8 + j, column px + k)
    v = (dr == 0)[..., None, None]
    rows = torch.where(v, py[..., None, None] + r8[:, None],
                       py[..., None, None] + r16[None, :] - 8)
    cols = torch.where(v, px[..., None, None] + r16[None, :] - 8,
                       px[..., None, None] + r8[:, None])    # [T, D, 8, 16]
    base = (torch.arange(T, device=dev)[:, None] * B
            + torch.arange(B, device=dev)[None, :]) * (H * W)  # [T, B]
    idx = (base[:, :, None, None, None]
           + (rows.clamp(0, H - 1) * W + cols.clamp(0, W - 1))[:, None])
    flat = pl.view(-1)
    win = flat[idx]                                          # [T, B, D, 8, 16]
    rep = (lambda a: a[:, None].expand(T, B, D).reshape(-1))
    filt = filter_lanes(win.reshape(-1, 8, 16), rep(E), rep(I), rep(Ht),
                        rep(wd), bpp).view(T, B, D, 8, 16)
    lo, hi = _write_range(wd)
    keep = ((r16 >= lo[..., None]) & (r16 < hi[..., None])
            & (wd > 0)[..., None])[:, None, :, None, :]      # [T, 1, D, 1, 16]
    inside = ((rows >= 0) & (rows < H) & (cols >= 0) & (cols < W))[:, None]
    m = (keep & inside).expand(T, B, D, 8, 16)
    flat[idx[m]] = filt[m]
    return pl


def lf_scan_plain(plane, steps, bpp):
    """The plain version of lf_scan: plane [B, H, W] int32, steps [S, D,
    7] int32 (pack_schedule) -> the filtered planes, a new tensor."""
    pl = plane.clone()[None]
    live = _live_steps(steps[None])
    steps = torch.as_tensor(steps, dtype=torch.int32, device=pl.device)
    for s in live:
        apply_step_plain(pl, steps[s][None], bpp)
    return pl[0]


def _live_steps(steps):
    """The indices of the steps of [T, S, D, 7] with a record (wd > 0) in
    some stripe: a step without one changes nothing (and leaves the
    stripes' copies as they were), so the plain versions skip it."""
    wd = steps[..., 3]
    live = (wd > 0).any(-1).any(0)
    if torch.is_tensor(live):
        live = live.cpu().numpy()
    return np.nonzero(np.asarray(live))[0].tolist()


def _edge_steps(steps, wreal):
    """The steps of [T, S, D, 7] in which some record may write a halo
    column (< HALO) or a tail column (wreal[t] .. wreal[t] + HALO) of its
    stripe: a dir 0 record writes at most columns px - 7 .. px + 6, a
    dir 1 record px .. px + 7."""
    st = steps.cpu().numpy() if torch.is_tensor(steps) else np.asarray(steps)
    px, dr, wd = st[..., 1], st[..., 2], st[..., 3]
    c0 = np.where(dr == 0, px - 7, px)
    c1 = np.where(dr == 0, px + 6, px + 7)
    wr = np.asarray(wreal, np.int64)[:, None, None]
    hit = (wd > 0) & ((c0 < HALO) | ((c1 >= wr) & (c0 < wr + HALO)))
    return set(np.nonzero(hit.any(axis=(0, 2)))[0].tolist())


def _cols(pl, start, n=HALO):
    """Columns start[t] .. start[t] + n of each stripe t of pl [T, B, H,
    W]: [T, B, H, n]."""
    idx = (torch.as_tensor(start, device=pl.device).long()[:, None]
           + torch.arange(n, device=pl.device))
    return torch.gather(pl, 3, idx[:, None, None, :].expand(
        *pl.shape[:3], n))


def lf_scan_sharded_plain(pl, steps, wreal, bpp):
    """The plain version of lf_scan_sharded: pl [T, B, H, HALO + Wpad]
    int32 stripe buffers, steps [T, S, D, 7] each stripe's records (px in
    its buffer's columns), wreal [T] each stripe's real width -> the
    filtered buffers, a new tensor. First each stripe's halo takes its
    left neighbour's last HALO real columns (columns wreal .. wreal +
    HALO of the neighbour's buffer: its tail); then every step runs on
    every stripe and the copies merge: a stripe's halo takes the
    neighbour's tail where the neighbour's step changed it, its tail the
    right neighbour's halo where that one's step did, else each keeps its
    own (fullframe.py:224-238 of the JAX package)."""
    pl = pl.clone()
    T = pl.shape[0]
    steps = torch.as_tensor(np.asarray(steps) if not torch.is_tensor(steps)
                            else steps, dtype=torch.int32, device=pl.device)
    wreal = [int(w) for w in wreal]

    def put_tails(pl, tails):
        for t in range(T):
            pl[t, :, :, wreal[t]:wreal[t] + HALO] = tails[t]

    if T > 1:
        pl[1:, :, :, :HALO] = _cols(pl, wreal)[:-1]
    edge = _edge_steps(steps, wreal) if T > 1 else set()
    for s in _live_steps(steps):
        if s not in edge:
            # no record of the step writes a halo or a tail: the merge
            # would leave every copy as it is
            apply_step_plain(pl, steps[:, s], bpp)
            continue
        old_tail = _cols(pl, wreal)
        old_halo = pl[..., :HALO].clone()
        apply_step_plain(pl, steps[:, s], bpp)
        new_tail = _cols(pl, wreal)
        new_halo = pl[..., :HALO].clone()
        # what each stripe receives: its left neighbour's tail, its right
        # neighbour's halo (none at the ends)
        recv_tail = torch.zeros_like(new_tail)
        recv_tail[1:] = new_tail[:-1]
        recv_halo = torch.zeros_like(new_halo)
        recv_halo[:-1] = new_halo[1:]
        t_idx = torch.arange(T, device=pl.device)[:, None, None, None]
        halo_m = torch.where((t_idx > 0) & (recv_tail != old_halo),
                             recv_tail, new_halo)
        tail_m = torch.where((t_idx < T - 1) & (recv_halo != old_tail),
                             recv_halo, new_tail)
        put_tails(pl, tail_m)
        pl[..., :HALO] = halo_m
    return pl


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, CUDA kernel on the card

def _launch(pl, steps, wreal, halo, bpp):
    """csrc/lpf_replay.cu on pl [T, B, H, Wb] in place, after checking
    every tensor: steps [T, S, D, 7] int32 (a host array, whose trailing
    no-op steps the launch skips, or a tensor on pl's device), wreal [T]
    (halo exchange when halo is set), bpp 8-12."""
    if pl.dim() != 4 or steps.ndim != 4 or steps.shape[-1] != 7:
        raise ValueError(f"buffers of shape {tuple(pl.shape)} and steps of "
                         f"shape {tuple(steps.shape)}")
    T, B, H, Wb = pl.shape
    if not 1 <= T <= MAX_STRIPES or B not in (1, 2) or not 8 <= bpp <= 12:
        raise ValueError(f"{T} stripes of {B} planes at {bpp} bpp: the "
                         f"kernel takes 1-{MAX_STRIPES} stripes of 1 or 2 "
                         "planes at 8-12 bpp")
    dev = pl.device
    check_tensor(pl, (torch.int32,), (T, B, H, Wb), dev, "planes")
    if not pl.is_contiguous():
        raise ValueError("the buffers are not contiguous: the kernel "
                         "filters them in place")
    S, D = steps.shape[1], steps.shape[2]
    if torch.is_tensor(steps):
        run = S
    else:
        # only the steps the launch runs go up
        run = steps_run(steps) if S else 0
        S = max(run, 1)
        steps = torch.from_numpy(np.ascontiguousarray(
            steps[:, :S], np.int32)).to(dev)
    steps = check_tensor(steps, (torch.int32,), (T, S, D, 7), dev, "steps")
    wr = np.asarray([int(w) for w in wreal], np.int32)
    if len(wr) != T or (halo and not all(HALO <= w and w + HALO <= Wb
                                         for w in wr)):
        raise ValueError(f"real widths {wr.tolist()} in buffers of {Wb} "
                         "columns")
    _cuda.launch("lpf_replay.cu", _SIGNATURES, "lf_replay", pl, steps,
                 wr.ctypes.data, T, B, H, Wb, S, D, run, int(halo), bpp)
    LAUNCHES["lf_replay"] += 1
    return pl


def lf_scan(plane, steps, bpp):
    """Replay the steps [S, D, 7] (pack_schedule; a host array or a
    tensor) over the plane set plane [B, H, W] int32 (B = 1: Y, 2: U and
    V) -> the filtered planes, a new tensor; the input is not modified.
    CPU tensors take lf_scan_plain; any other device the kernel
    (csrc/lpf_replay.cu, one launch, one stripe), which takes CUDA
    tensors only."""
    if plane.device.type == "cpu":
        return lf_scan_plain(plane, steps, bpp)
    out = plane.clone(memory_format=torch.contiguous_format)[None]
    return _launch(out, steps[None], [plane.shape[-1]], False, bpp)[0]


def lf_scan_sharded(pl, steps, wreal, bpp):
    """Replay each stripe's steps over the stripe buffers pl [T, B, H,
    HALO + Wpad] int32 with the halo exchange of lf_scan_sharded_plain
    (steps [T, S, D, 7], a host array or a tensor; wreal [T] each
    stripe's real width) -> the filtered buffers; CPU tensors take
    lf_scan_sharded_plain (a new tensor), any other device the kernel
    (csrc/lpf_replay.cu: one launch, a thread block a stripe, the T of
    them in one cluster), which filters pl in place and returns it."""
    if pl.device.type == "cpu":
        return lf_scan_sharded_plain(pl, steps, wreal, bpp)
    return _launch(pl, steps, wreal, pl.shape[0] > 1, bpp)
