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
set: `build_tickets` turns the steps into superblock tickets on the host
(a `Replay` holds them, uploaded once), which the kernel runs as a
dataflow ordered by per-superblock flags; for planes on the CPU the plain
versions, lf_scan_plain and lf_scan_sharded_plain, a Python loop over the
steps. The wrappers take the superblock's size in the set's samples (sb,
64 >> ss) from their callers. Launches are counted in LAUNCHES.

`lf_scan_sharded_dist` replays the stripes of one process when a frame's
stripes are split across torch.distributed ranks (parallel/mesh.py,
parallel/dist.py): the rank's run of stripes in segments, each one launch
(csrc/lpf_replay.cu's lf_replay_from, on tickets uploaded once) that ends at
a step writing a column on a boundary with another rank
(`segment_plan`), then a swap of those columns with the neighbour rank
and the same merge. Its plain version is lf_scan_sharded_dist_plain.

JAX clamps gather indices and drops scatters outside the array; here a
window's reads clamp to the buffer and only a record's written range
(wd > 0) is stored, inside the buffer.
"""
from __future__ import annotations

import copy
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

# stripes one launch takes
MAX_STRIPES = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # planes, tickets, levels, records, wreal (host), T, B, H, Wb,
    # tickets, most records, most levels, sbw, sbh, halo, bpp, state,
    # epoch, stream
    "lf_replay": [_P] * 5 + [_I] * 11 + [_P, _I, _P],
    # ... sbw, sbh, first, halo, bpp, state, epoch, stream
    "lf_replay_from": [_P] * 5 + [_I] * 12 + [_P, _I, _P],
}

# int32 words of a ticket (csrc/lpf_replay.cu: kTicketInt4 int4)
TICKET_WORDS = 20

# the superblock sides the kernel takes, in a plane set's samples: luma
# and 4:4:4 chroma 64, subsampled chroma 32
SB_SIZES = (32, 64)


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
    """The samples [lo, hi) of a record's 16 that its filter may write
    (wd a tensor or a numpy array)."""
    where = torch.where if torch.is_tensor(wd) else np.where
    lo = where(wd >= 16, 1, where(wd >= 8, 5, 6))
    hi = where(wd >= 16, 15, where(wd >= 8, 11, 10))
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
# the kernel's tickets

def build_tickets(steps, spans, shape, sb, wreal, col_off, halo):
    """The tickets of csrc/lpf_replay.cu for the live records (wd > 0) of
    steps [T, S, D, 7] (host int32; stripe t's records in its buffer's
    coordinates) over buffers of `shape` (T, B, H, Wb): one launch a span
    (first, end) of steps, spans disjoint and in order.

    A ticket is one superblock of sb = (sbw, sbh) samples with live
    records in a span: its row is the records' lane, its column their px
    in the frame's columns (px - col_off + x0[t], x0 the running sum of
    wreal) over sbw; tickets go wave by wave (2 row + column), each
    holding its records in recorded order, grouped into levels: a run
    of records of one direction is split into chains, the V records of
    one row group (py) or the H records of one column group (px), each
    in order, the chains side by side when their groups are 8 samples
    apart and inside the buffer (else the run goes one record a level).
    Each ticket waits for the tickets of its span at (row, column - 1),
    (row - 1, column - 1), (row - 1, column) and (row - 1, column + 1):
    every superblock before it in the wave order whose window (the
    superblock plus 8 samples all round) overlaps its own. With halo,
    the superblocks next to a stripe boundary also wait for the halo
    copy of a span that starts at step 0.

    Returns a dict: tickets [n, TICKET_WORDS] int32 ((stripe, lv0, nlv,
    copy | nwork << 8), four waits (the span's ticket index, -1 none),
    the load box (r0, c0, rows, cols: the records' clamped footprints),
    the write box (what their filters may write inside the buffer),
    (rec0, nrec, rt, cl): the load box's rows before rt and columns
    before cl are what the waits guard, the rest is copied before them);
    levels [L + 1] int32, the record at which each level starts; records
    [m, 4] int32 (py, px, dir | wd << 2, E | I << 8 | H << 16); source
    [m]: each record's flat index into steps[..., 0] (stripe, step,
    lane); launches [(ticket lo, hi, first, most records, most levels of
    a ticket)] a span. The boxes are aligned to 4 columns: the kernel
    moves int4 only, so Wb and, with halo, every wreal must be multiples
    of 4. Raises ValueError where they are not, and where the records do
    not fit the superblocks: two waves in one step, waves out of step
    order, the rows (py) of one lane spread over sbh or more (lane l's
    superblock starts at one offset plus l * sbh), a superblock in two
    stripes, a box larger than the superblock plus 8 all round, or a
    parameter the kernel cannot pack. On a single lane of a single
    stripe (a band of the stripe pipeline) nothing in the records tells
    a superblock too wide from a right one: the caller's sb must be the
    set's."""
    st = np.asarray(steps)
    T, B, H, Wb = (int(v) for v in shape)
    sbw, sbh = (int(v) for v in sb)
    if sbw not in SB_SIZES or sbh not in SB_SIZES:
        raise ValueError(f"superblocks of {sbw}x{sbh}: the kernel takes "
                         f"{SB_SIZES} samples a side")
    if st.ndim != 4 or st.shape[0] != T or st.shape[-1] != 7:
        raise ValueError(f"steps of shape {st.shape} for {T} stripes")
    wreal = np.asarray([int(w) for w in wreal], np.int64)
    x0 = np.concatenate([[0], np.cumsum(wreal)[:-1]]).astype(np.int64)
    if Wb % 4 or (halo and (wreal % 4).any()):
        raise ValueError(f"buffers {Wb} wide, real widths {wreal.tolist()}: "
                         "the kernel moves int4, so they must be multiples "
                         "of 4")
    S, D = st.shape[1], st.shape[2]
    firsts = np.asarray([int(f) for f, _e in spans], np.int64)
    span_of = np.full(S + 1, -1, np.int64)
    for k, (first, end) in enumerate(spans):
        if not 0 <= first <= end <= S or (k and first < spans[k - 1][1]):
            raise ValueError(f"spans {spans} of {S} steps")
        span_of[first:end] = k
    # the live records of the spans (rec: their 7 words); then in (span,
    # wave, row, step) order: a ticket a run, its records in step order
    st2 = st.reshape(-1, 7)
    flat = np.flatnonzero(st2[:, 3] > 0)
    s_i = flat // D % S
    keep = span_of[s_i] >= 0
    flat, s_i = flat[keep], s_i[keep]
    t_i, d_i = flat // (S * D), flat % D
    rec = st2[flat].astype(np.int64)
    sp = span_of[s_i]
    col = (rec[:, 1] - col_off + x0[t_i]) // sbw
    wave = 2 * d_i + col
    n = len(flat)
    if n:
        # one wave a step: what a step's last record leaves, every one of
        # its records must hold; and the waves in step order
        w_of = np.full(S, -1, np.int64)
        w_of[s_i] = wave
        if (w_of[s_i] != wave).any():
            raise ValueError(f"a step holds records of two waves: they do "
                             f"not fit superblocks {sbw} wide")
        if (np.diff(w_of[w_of >= 0]) < 0).any():
            raise ValueError(f"the steps' waves go back: the records do "
                             f"not fit superblocks {sbw}x{sbh}")
        # a record's edge row lies in its superblock, whose rows start at
        # one offset plus lane * sbh
        top = rec[:, 0] - d_i * sbh
        if top.max() - top.min() >= sbh:
            raise ValueError(f"a lane's records span more rows than "
                             f"superblocks {sbh} high")
    order = np.argsort(((sp * (int(wave.max(initial=0)) + 1) + wave) * D
                        + d_i) * S + s_i)
    t_i, sp, row, col, flat, rec = (v[order] for v in (t_i, sp, d_i, col,
                                                        flat, rec))
    py, px, dr, wd = rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3]
    new = np.ones(n, bool)
    new[1:] = ((sp[1:] != sp[:-1]) | (row[1:] != row[:-1])
               | (col[1:] != col[:-1]))
    tk = np.cumsum(new) - 1
    starts = np.nonzero(new)[0]
    nt = len(starts)
    if (t_i != t_i[starts][tk]).any():
        raise ValueError("a superblock's records lie in two stripes")
    # levels: direction runs, chains of one row or column group
    idx = np.arange(n)
    v = dr == 0
    key = np.where(v, py, px)
    ph_new = new.copy()
    ph_new[1:] |= dr[1:] != dr[:-1]
    ph = np.cumsum(ph_new) - 1
    ph_start = np.nonzero(ph_new)[0]
    inside = (key >= 0) & (key + 7 < np.where(v, H, Wb))
    if n:
        m8 = key % 8
        ph_ok = ((np.minimum.reduceat(m8, ph_start)
                  == np.maximum.reduceat(m8, ph_start))
                 & (np.minimum.reduceat(inside.astype(np.int8), ph_start)
                    > 0))
    else:
        ph_ok = np.zeros(0, bool)
    kmin = int(key.min(initial=0))
    o2 = np.argsort(ph * (int(key.max(initial=0)) - kmin + 1) + key - kmin,
                    kind="stable")
    g_new = np.ones(n, bool)
    g_new[1:] = (ph[o2][1:] != ph[o2][:-1]) | (key[o2][1:] != key[o2][:-1])
    rank = np.empty(n, np.int64)
    rank[o2] = idx - np.maximum.accumulate(np.where(g_new, idx, 0))
    rank = np.where(ph_ok[ph], rank, idx - ph_start[ph])
    depth = (np.maximum.reduceat(rank, ph_start) + 1 if n
             else np.zeros(0, np.int64))
    before = np.cumsum(depth) - depth
    tk_first_ph = ph[starts]
    base = before - before[tk_first_ph][tk[ph_start]]
    level = rank + base[ph]
    nlv = (np.add.reduceat(depth, tk_first_ph) if n
           else np.zeros(0, np.int64))
    o3 = np.argsort(tk * (int(level.max(initial=0)) + 1) + level,
                    kind="stable")
    level, tk2, flat, rec = level[o3], tk[o3], flat[o3], rec[o3]
    py, px, dr, wd = rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3]
    par = rec[:, 4:7]
    if ((dr != 0) & (dr != 1)).any() or (par < 0).any() or (
            par > 255).any() or (wd >= 1 << 29).any():
        raise ValueError("a record's direction or parameters are out of "
                         "the kernel's range")
    lv_new = np.ones(n, bool)
    lv_new[1:] = (tk2[1:] != tk2[:-1]) | (level[1:] != level[:-1])
    levels = np.append(np.nonzero(lv_new)[0], n)
    if len(levels) - 1 != int(nlv.sum()):
        raise AssertionError("levels of the tickets are not contiguous")
    lv0 = np.cumsum(nlv) - nlv
    width = np.diff(levels)
    most = (np.maximum.reduceat(width, lv0) if nt
            else np.zeros(0, np.int64))
    nwork = np.clip((most * 8 * B + 31) // 32 * 32, 32, 256)
    nrec = np.diff(np.append(starts, n))
    # boxes: footprints clamped to the buffer; write ranges inside it
    d0 = dr == 0
    fr0 = np.clip(np.where(d0, py, py - 8), 0, H - 1)
    fr1 = np.clip(py + 7, 0, H - 1)
    fc0 = np.clip(np.where(d0, px - 8, px), 0, Wb - 1)
    fc1 = np.clip(px + 7, 0, Wb - 1)
    lo, hi = _write_range(wd)
    wr0 = np.maximum(np.where(d0, py, py - 8 + lo), 0)
    wr1 = np.minimum(np.where(d0, py + 7, py - 9 + hi), H - 1)
    wc0 = np.maximum(np.where(d0, px - 8 + lo, px), 0)
    wc1 = np.minimum(np.where(d0, px - 9 + hi, px + 7), Wb - 1)
    empty = (wr0 > wr1) | (wc0 > wc1)
    big, small = np.int64(1 << 40), np.int64(-(1 << 40))
    wr0, wc0 = np.where(empty, big, wr0), np.where(empty, big, wc0)
    wr1, wc1 = np.where(empty, small, wr1), np.where(empty, small, wc1)
    red = (lambda fn, a: fn.reduceat(a, starts) if nt
           else np.zeros(0, np.int64))
    lb = [red(np.minimum, fr0), red(np.minimum, fc0), red(np.maximum, fr1),
          red(np.maximum, fc1)]
    wb = [red(np.minimum, wr0), red(np.minimum, wc0), red(np.maximum, wr1),
          red(np.maximum, wc1)]
    w_empty = wb[0] > wb[2]
    lb[1], lb[3] = lb[1] & ~3, lb[3] | 3
    wb[1], wb[3] = wb[1] & ~3, wb[3] | 3
    load = np.stack([lb[0], lb[1], lb[2] - lb[0] + 1, lb[3] - lb[1] + 1], 1)
    write = np.stack([wb[0], wb[1], wb[2] - wb[0] + 1, wb[3] - wb[1] + 1], 1)
    write[w_empty] = 0
    tstripe, trow, tcol = t_i[starts], row[starts], col[starts]
    xs = tcol * sbw - x0[tstripe] + col_off
    if nt and ((load[:, 2] > sbh + 16).any() or (load[:, 3] > sbw + 16).any()
               or (lb[1] < xs - 8).any() or (lb[3] > xs + sbw + 7).any()):
        raise ValueError(f"a superblock's records reach beyond its "
                         f"{sbw}x{sbh} samples plus 8 all round")
    # waits, within each span
    tsp = sp[starts]
    tloc = np.arange(nt) - np.searchsorted(tsp, tsp)
    waits = np.full((nt, 4), -1, np.int64)
    copy = np.zeros(nt, np.int64)
    if nt:
        cmin = int(tcol.min())
        grid = np.full((len(spans), int(trow.max()) + 2,
                        int(tcol.max()) - cmin + 3), -1, np.int64)
        c = tcol - cmin + 1
        grid[tsp, trow + 1, c] = tloc
        for j, (dy, dx) in enumerate(((0, -1), (-1, -1), (-1, 0), (-1, 1))):
            waits[:, j] = grid[tsp, trow + 1 + dy, c + dx]
        if halo:
            ct0 = x0[1:] // sbw
            copy = (np.isin(tcol, ct0) | np.isin(tcol, ct0 - 1)).astype(
                np.int64)
    # what the waits guard in each load box: its rows up to the end of
    # what the tickets above write there (rt), its columns up to the end
    # of what the ticket on the left (and a launch's halo copy) write (cl);
    # all they write lies in those rows or those columns (in the frame's
    # columns: mirrors land where their source is), so the kernel copies
    # the rest of the window before it waits
    lr0, lc0 = load[:, 0], load[:, 1]
    lr1, lc1 = lr0 + load[:, 2], lc0 + load[:, 3]
    rt, cl = lr0.copy(), lc0.copy()
    gcol = x0[tstripe] - col_off   # a buffer column + gcol: the frame's
    base = np.arange(nt) - tloc
    for j in range(4):
        has = waits[:, j] >= 0
        d = np.where(has, waits[:, j] + base, 0)
        w = write[d]
        wc0 = w[:, 1] + gcol[d] - gcol
        wc1 = wc0 + w[:, 3]
        hit = (has & (w[:, 2] > 0) & (w[:, 0] < lr1)
               & (w[:, 0] + w[:, 2] > lr0) & (wc0 < lc1) & (wc1 > lc0))
        if j == 0:
            cl = np.where(hit, np.maximum(cl, np.minimum(wc1, lc1)), cl)
        else:
            rt = np.where(hit, np.maximum(rt, np.minimum(w[:, 0] + w[:, 2],
                                                         lr1)), rt)
    if halo and nt:
        copies = (firsts[tsp] == 0) & (copy > 0)
        cl = np.where(copies & (lc0 < HALO), np.maximum(cl, np.minimum(
            HALO, lc1)), cl)
    tickets = np.zeros((nt, TICKET_WORDS), np.int64)
    tickets[:, 0] = tstripe
    tickets[:, 1] = lv0
    tickets[:, 2] = nlv
    tickets[:, 3] = copy | nwork << 8
    tickets[:, 4:8] = waits
    tickets[:, 8:12] = load
    tickets[:, 12:16] = write
    tickets[:, 16] = starts
    tickets[:, 17] = nrec
    tickets[:, 18] = rt
    tickets[:, 19] = cl
    records = np.stack([py, px, dr | wd << 2,
                        par[:, 0] | par[:, 1] << 8 | par[:, 2] << 16], 1)
    # a launch a span: its tickets a .. b, the most records and levels of
    # one (the spans with tickets hold consecutive runs of them)
    ks = np.arange(len(spans))
    a, b = np.searchsorted(tsp, ks), np.searchsorted(tsp, ks, "right")
    most = np.zeros((len(spans), 2), np.int64)
    if nt:
        most[b > a] = np.stack([np.maximum.reduceat(nrec, a[b > a]),
                                np.maximum.reduceat(nlv, a[b > a])], 1)
    launches = [(int(a[k]), int(b[k]), int(firsts[k]), int(most[k, 0]),
                 int(most[k, 1])) for k in ks]
    return {"tickets": tickets.astype(np.int32),
            "levels": levels.astype(np.int32),
            "records": records.astype(np.int32), "launches": launches,
            "source": flat}


class Replay:
    """A replay's tickets (build_tickets) for steps [T, S, D, 7] over
    buffers of `shape` [T, B, H, Wb], built on the host once and uploaded
    once a device; one launch a span of steps (spans: [(first, end)];
    None: the whole run). The wrappers take one in place of the steps
    (steps keeps them for the plain versions), so a caller that replays
    the same records again, or ahead of its launches, builds them once:
    parallel/gop_pipeline.py prepares each band's with its frame."""

    def __init__(self, steps, shape, sb, wreal=None, col_off=0, halo=False,
                 spans=None):
        self.steps = np.asarray(steps, np.int32)
        self.shape = tuple(int(v) for v in shape)
        self.sb = tuple(int(v) for v in sb)
        self.wreal = [int(w) for w in (wreal if wreal is not None
                                       else [self.shape[-1]])]
        self.halo = bool(halo)
        if spans is None:
            spans = [(0, steps_run(self.steps))]
        self.spans = [(int(a), int(b)) for a, b in spans]
        t = build_tickets(self.steps, self.spans, self.shape, self.sb,
                          self.wreal, col_off, self.halo)
        self.parts = t
        self.launches = t["launches"]
        self.ntickets = len(t["tickets"])
        self.nrecords = len(t["records"])
        lv = t["levels"]
        lv = np.concatenate([lv, np.zeros(-len(lv) % 4, np.int32)])
        self.host = np.concatenate([t["tickets"].ravel(), lv,
                                    t["records"].ravel()])
        self._at = (self.ntickets * TICKET_WORDS,
                    self.ntickets * TICKET_WORDS + len(lv))
        self._dev = {}

    def idle(self):
        """The same tickets with every record a no-op (wd 0): their
        waits, windows, levels and write-backs without the filter's work,
        what the dataflow alone costs (chip_smoke.py's chain alone)."""
        out = copy.copy(self)
        out.parts = dict(self.parts, records=self.parts["records"].copy())
        out.parts["records"][:, 2] &= 3
        out.host = self.host.copy()
        out.host[self._at[1]:] = out.parts["records"].ravel()
        out._dev = {}
        return out

    def tables(self, device):
        """(tickets, levels, records) on `device`: views of one upload."""
        key = str(device)
        if key not in self._dev:
            buf = torch.from_numpy(self.host).to(device)
            a, b = self._at
            self._dev[key] = (buf[:a], buf[a:b], buf[b:])
        return self._dev[key]


def _as_replay(steps, shape, sb, wreal, col_off, halo):
    """steps as a Replay over buffers of `shape`: a Replay is checked, a
    host array (or a tensor, copied to the host) is built."""
    if isinstance(steps, Replay):
        if (steps.shape != tuple(shape) or steps.sb != tuple(sb)
                or steps.halo != bool(halo)
                or steps.wreal != [int(w) for w in wreal]):
            raise ValueError(f"a replay of {steps.shape} ({steps.sb} "
                             f"superblocks) for buffers of {tuple(shape)} "
                             f"({tuple(sb)})")
        return steps
    if torch.is_tensor(steps):
        steps = steps.cpu().numpy()
    return Replay(steps, shape, sb, wreal, col_off, halo)


def _host_steps(steps):
    """The steps of a Replay, a tensor or a host array, as given."""
    return steps.steps if isinstance(steps, Replay) else steps


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, CUDA kernel on the card

def _launch(pl, rp, bpp, k=0, name="lf_replay"):
    """csrc/lpf_replay.cu on pl [T, B, H, Wb] in place, after checking
    every tensor: launch k of the Replay rp, whose shape is pl's; bpp
    8-12. name: lf_replay (a whole replay) or lf_replay_from (a segment
    of one). The kernel moves int4 only: pl must start on 16 bytes."""
    if pl.dim() != 4:
        raise ValueError(f"buffers of shape {tuple(pl.shape)}")
    T, B, H, Wb = pl.shape
    if not 1 <= T <= MAX_STRIPES or B not in (1, 2) or not 8 <= bpp <= 12:
        raise ValueError(f"{T} stripes of {B} planes at {bpp} bpp: the "
                         f"kernel takes 1-{MAX_STRIPES} stripes of 1 or 2 "
                         "planes at 8-12 bpp")
    dev = pl.device
    check_tensor(pl, (torch.int32,), (T, B, H, Wb), dev, "planes")
    if not pl.is_contiguous() or pl.data_ptr() % 16:
        raise ValueError("the buffers are not contiguous on 16 bytes: the "
                         "kernel filters them in place, an int4 at a time")
    if rp.shape != (T, B, H, Wb):
        raise ValueError(f"a replay of {rp.shape} for buffers of "
                         f"{tuple(pl.shape)}")
    if len(rp.wreal) != T or (rp.halo and not all(
            HALO <= w and w + HALO <= Wb for w in rp.wreal)):
        raise ValueError(f"real widths {rp.wreal} in buffers of {Wb} "
                         "columns")
    lo, hi, first, most_recs, most_lv = rp.launches[k]
    tickets, levels, records = rp.tables(dev)
    nt = hi - lo
    st = _cuda.stream_state("lpf_replay", dev, nt + 3)
    wr = np.asarray(rp.wreal, np.int32)
    args = [pl, tickets[lo * TICKET_WORDS:], levels, records,
            wr.ctypes.data, T, B, H, Wb, nt, most_recs, most_lv, *rp.sb]
    if name == "lf_replay_from":
        args.append(first)
    args += [int(rp.halo), bpp, st.buf, st.next_epoch()]
    _cuda.launch("lpf_replay.cu", _SIGNATURES, name, *args)
    LAUNCHES["lf_replay"] += 1
    return pl


def lf_scan(plane, steps, bpp, sb):
    """Replay the steps [S, D, 7] (pack_schedule; a host array, a tensor
    or a Replay of shape [1, B, H, W]) over the plane set plane [B, H, W]
    int32 (B = 1: Y, 2: U and V) of superblocks sb = (width, height) in
    its samples -> the filtered planes, a new tensor; the input is not
    modified. CPU tensors take lf_scan_plain; any other device the kernel
    (csrc/lpf_replay.cu, one launch, one stripe), which takes CUDA
    tensors only."""
    if plane.device.type == "cpu":
        s = _host_steps(steps)
        return lf_scan_plain(plane, s[0] if isinstance(steps, Replay)
                             else s, bpp)
    out = plane.clone(memory_format=torch.contiguous_format)[None]
    if not isinstance(steps, Replay):
        steps = (steps.cpu().numpy() if torch.is_tensor(steps)
                 else np.asarray(steps))[None]
    rp = _as_replay(steps, out.shape, sb, [out.shape[-1]], 0, False)
    return _launch(out, rp, bpp)[0]


def lf_scan_sharded(pl, steps, wreal, bpp, sb):
    """Replay each stripe's steps over the stripe buffers pl [T, B, H,
    HALO + Wpad] int32 with the halo exchange of lf_scan_sharded_plain
    (steps [T, S, D, 7], a host array, a tensor or a Replay; wreal [T]
    each stripe's real width; sb the superblock's (width, height) in the
    set's samples) -> the filtered buffers; CPU tensors take
    lf_scan_sharded_plain (a new tensor), any other device the kernel
    (csrc/lpf_replay.cu: one launch of the stripes' tickets), which
    filters pl in place and returns it."""
    if pl.device.type == "cpu":
        return lf_scan_sharded_plain(pl, _host_steps(steps), wreal, bpp)
    rp = _as_replay(steps, pl.shape, sb, wreal, HALO, pl.shape[0] > 1)
    return _launch(pl, rp, bpp)


def lf_scan_sharded_dist(pl, steps, wreal, bpp, ranks, exchange, sb):
    """Replay the stripes of one rank when a gop row's T stripes are
    split across ranks: pl [hi - lo, B, H, HALO + Wpad] int32, the
    stripes lo .. hi - 1 that `ranks` [T] (the row's rank a slot, a
    contiguous run each) gives exchange.rank; steps [T, S, D, 7] and wreal
    [T] of the whole row (every rank holds the whole job; the cuts read
    the neighbours' records); sb the superblock's (width, height) in the
    set's samples; exchange: a parallel/dist.py HaloExchange (swap,
    note_plan, rank). Equal, stripe for stripe, to lf_scan_sharded_plain
    over all T stripes. CPU tensors take lf_scan_sharded_dist_plain (a new
    tensor); on the card the tickets of every segment of segment_plan are
    built and uploaded once, and each segment is one lf_replay_from
    launch on pl in place, which is returned. The segment launches are
    timed under CUDA events into exchange.replay_events when
    exchange.timed."""
    if pl.device.type == "cpu":
        return lf_scan_sharded_dist_plain(pl, steps, wreal, bpp, ranks,
                                          exchange)
    steps = np.asarray(steps)
    plan = segment_plan(steps, wreal, ranks, exchange.rank)
    lo, hi, _cuts, segments = plan
    wl = [int(w) for w in wreal[lo:hi]]
    rp = Replay(steps[lo:hi], pl.shape, sb, wl, HALO, hi - lo > 1,
                [(first, end) for first, end, _s in segments])
    at = iter(range(len(segments)))

    def replay(first, end):
        ev = exchange.timed and (torch.cuda.Event(enable_timing=True),
                                 torch.cuda.Event(enable_timing=True))
        if ev:
            ev[0].record()
        _launch(pl, rp, bpp, next(at), "lf_replay_from")
        if ev:
            ev[1].record()
            exchange.replay_events.append(ev)

    _scan_dist(pl, plan, wreal, ranks, exchange, replay)
    return pl
