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

`lf_scan_sharded_dist` replays the stripes of one process when a frame's
stripes are split across torch.distributed ranks (parallel/mesh.py,
parallel/dist.py): the rank's run of stripes in segments, each one launch
(csrc/lpf_replay.cu's lf_replay_from, on steps uploaded once) that ends at
a step writing a column on a boundary with another rank
(`segment_plan`), then a swap of those columns with the neighbour rank
and the same merge. Its plain version is lf_scan_sharded_dist_plain.

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
    # ... S, D, first, run, halo, bpp, stream
    "lf_replay_from": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [
        ctypes.c_int] * 10 + [ctypes.c_void_p],
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


def _writes(steps, wreal):
    """Which records of [T, S, D, 7] may write a halo column (< HALO)
    and which a tail column (wreal[t] .. wreal[t] + HALO) of their stripe:
    two bool arrays [T, S, D]. A dir 0 record writes at most columns px -
    7 .. px + 6, a dir 1 record px .. px + 7."""
    st = steps.cpu().numpy() if torch.is_tensor(steps) else np.asarray(steps)
    px, dr, wd = st[..., 1], st[..., 2], st[..., 3]
    c0 = np.where(dr == 0, px - 7, px)
    c1 = np.where(dr == 0, px + 6, px + 7)
    wr = np.asarray(wreal, np.int64)[:, None, None]
    return ((wd > 0) & (c0 < HALO),
            (wd > 0) & (c1 >= wr) & (c0 < wr + HALO))


def _edge_steps(steps, wreal):
    """The steps of [T, S, D, 7] in which some record may write a halo
    or a tail column of its stripe."""
    halo, tail = _writes(steps, wreal)
    return set(np.nonzero((halo | tail).any(axis=(0, 2)))[0].tolist())


def boundary_steps(steps, wreal, t):
    """The steps of [T, S, D, 7] after which the copies across the
    boundary between stripes t - 1 and t may differ: a record of stripe
    t - 1 may write its tail, or one of stripe t its halo (_edge_steps'
    column rule on that boundary alone). Sorted."""
    halo, tail = _writes(steps, wreal)
    hit = tail[t - 1].any(axis=1) | halo[t].any(axis=1)
    return np.nonzero(hit)[0].tolist()


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
    steps = torch.as_tensor(np.asarray(steps) if not torch.is_tensor(steps)
                            else steps, dtype=torch.int32, device=pl.device)
    if pl.shape[0] > 1:
        pl[1:, :, :, :HALO] = _cols(pl, wreal)[:-1]
    _replay_plain(pl, steps, wreal, bpp, _live_steps(steps))
    return pl


def _replay_plain(pl, steps, wreal, bpp, todo):
    """Steps `todo` of steps [T, S, D, 7] (a tensor) over the stripes pl
    in place, each followed by lf_scan_sharded_plain's merge of the
    stripes' copies."""
    T = pl.shape[0]
    wreal = [int(w) for w in wreal]

    def put_tails(pl, tails):
        for t in range(T):
            pl[t, :, :, wreal[t]:wreal[t] + HALO] = tails[t]

    edge = _edge_steps(steps, wreal) if T > 1 else set()
    for s in todo:
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


def segment_plan(steps, wreal, ranks, rank):
    """How rank replays its stripes of a gop row whose T stripes the
    ranks `ranks` [T] own (a contiguous run each; steps [T, S, D, 7] and
    wreal [T] of the whole row). Returns (lo, hi, cuts, segments): the
    rank's stripes lo .. hi - 1; cuts {"left": [steps], "right": [steps]}
    the boundary_steps of its boundaries with other ranks (a side without
    one is absent); segments [(first, end, sides)]: the live steps up to
    the row's last one, cut after every step of cuts, steps first .. end -
    1 each, `sides` the boundaries whose columns are swapped after it.
    With no boundary: one segment, or none when the row has no record."""
    ranks = [int(r) for r in ranks]
    mine = [t for t, r in enumerate(ranks) if r == rank]
    if not mine or mine != list(range(mine[0], mine[-1] + 1)):
        raise ValueError(f"rank {rank}'s stripes {mine} of {ranks} are not "
                         "one contiguous run")
    lo, hi = mine[0], mine[-1] + 1
    cuts = {}
    if lo > 0:
        cuts["left"] = boundary_steps(steps, wreal, lo)
    if hi < len(ranks):
        cuts["right"] = boundary_steps(steps, wreal, hi)
    run = steps_run(steps)
    at = sorted(set().union(*cuts.values()))
    segments, first = [], 0
    for c in at:
        segments.append((first, c + 1, [side for side in ("left", "right")
                                        if c in cuts.get(side, ())]))
        first = c + 1
    if first < run:
        segments.append((first, run, []))
    return lo, hi, cuts, segments


def _scan_dist(pl, plan, wreal, ranks, exchange, replay):
    """The segment loop of lf_scan_sharded_dist on the rank's stripes pl
    (in place), plan its segment_plan: the first swap (the left
    boundary's halo takes the left rank's tail), then each segment: a
    snapshot of the columns it cuts on, replay(first, end), a swap of
    those columns with the neighbour rank, and the merge of
    fullframe.py:234-237 of the JAX package: the neighbour's value where
    it differs from the snapshot, else our own (the wave's records never
    change one pixel on both sides)."""
    lo, hi, cuts, segments = plan
    wr = int(wreal[hi - 1])
    cols = {"left": (0, slice(0, HALO)),
            "right": (hi - lo - 1, slice(wr, wr + HALO))}
    peer = {"left": ranks[lo - 1] if lo > 0 else None,
            "right": ranks[hi] if hi < len(ranks) else None}

    def view(side):
        t, c = cols[side]
        return pl[t, :, :, c]

    if "left" in cuts:
        view("left").copy_(exchange.swap(peer["left"], None, view("left")))
    if "right" in cuts:
        exchange.swap(peer["right"], view("right"), None)
    for first, end, sides in segments:
        old = {side: view(side).clone() for side in sides}
        replay(first, end)
        for side in sides:
            own = view(side)
            got = exchange.swap(peer[side], own, own)
            own.copy_(torch.where(got != old[side], got, own))
    exchange.note_plan(len(segments), sum(len(c) for c in cuts.values()),
                       len(cuts))


def lf_scan_sharded_dist_plain(pl, steps, wreal, bpp, ranks, exchange):
    """The plain version of lf_scan_sharded_dist on CPU tensors: the
    rank's stripes pl [hi - lo, B, H, HALO + Wpad] -> the filtered
    stripes, a new tensor; each segment runs _replay_plain on its live
    steps."""
    pl = pl.clone()
    steps = np.asarray(steps)
    plan = segment_plan(steps, wreal, ranks, exchange.rank)
    lo, hi = plan[:2]
    local = torch.as_tensor(steps[lo:hi], dtype=torch.int32)
    wl = [int(w) for w in wreal[lo:hi]]
    if hi - lo > 1:
        pl[1:, :, :, :HALO] = _cols(pl, wl)[:-1]
    live = _live_steps(local)

    def replay(first, end):
        _replay_plain(pl, local, wl, bpp, [s for s in live
                                           if first <= s < end])

    _scan_dist(pl, plan, wreal, ranks, exchange, replay)
    return pl


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, CUDA kernel on the card

def _launch(pl, steps, wreal, halo, bpp, first=None, end=None):
    """csrc/lpf_replay.cu on pl [T, B, H, Wb] in place, after checking
    every tensor: steps [T, S, D, 7] int32 (a host array, whose trailing
    no-op steps the launch skips, or a tensor on pl's device), wreal [T]
    (halo exchange when halo is set), bpp 8-12. With first and end (a
    tensor's steps): lf_replay_from, steps first .. end - 1."""
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
        run = S if end is None else end
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
    if first is None:
        _cuda.launch("lpf_replay.cu", _SIGNATURES, "lf_replay", pl, steps,
                     wr.ctypes.data, T, B, H, Wb, S, D, run, int(halo), bpp)
    else:
        if not 0 <= first <= run <= S:
            raise ValueError(f"steps {first} .. {run} of {S}")
        _cuda.launch("lpf_replay.cu", _SIGNATURES, "lf_replay_from", pl,
                     steps, wr.ctypes.data, T, B, H, Wb, S, D, first, run,
                     int(halo), bpp)
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


def lf_scan_sharded_dist(pl, steps, wreal, bpp, ranks, exchange):
    """Replay the stripes of one rank when a gop row's T stripes are
    split across ranks: pl [hi - lo, B, H, HALO + Wpad] int32, the
    stripes lo .. hi - 1 that `ranks` [T] (the row's rank a slot, a
    contiguous run each) gives exchange.rank; steps [T, S, D, 7] and wreal
    [T] of the whole row (every rank holds the whole job; the cuts read
    the neighbours' records); exchange: a parallel/dist.py HaloExchange
    (swap, note_plan, rank). Equal, stripe for stripe, to
    lf_scan_sharded_plain over all T stripes. CPU tensors take
    lf_scan_sharded_dist_plain (a new tensor); on the card the steps go
    up once and each segment of segment_plan is one lf_replay_from launch
    on pl in place, which is returned. The segment launches are timed
    under CUDA events into exchange.replay_events when exchange.timed."""
    if pl.device.type == "cpu":
        return lf_scan_sharded_dist_plain(pl, steps, wreal, bpp, ranks,
                                          exchange)
    steps = np.asarray(steps)
    run = max(steps_run(steps), 1)
    plan = segment_plan(steps, wreal, ranks, exchange.rank)
    lo, hi = plan[:2]
    local = torch.from_numpy(np.ascontiguousarray(
        steps[lo:hi, :run], np.int32)).to(pl.device)
    wl = [int(w) for w in wreal[lo:hi]]

    def replay(first, end):
        ev = exchange.timed and (torch.cuda.Event(enable_timing=True),
                                 torch.cuda.Event(enable_timing=True))
        if ev:
            ev[0].record()
        _launch(pl, local, wl, hi - lo > 1, bpp, first, end)
        if ev:
            ev[1].record()
            exchange.replay_events.append(ev)

    _scan_dist(pl, plan, wreal, ranks, exchange, replay)
    return pl
