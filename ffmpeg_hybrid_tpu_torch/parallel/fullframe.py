"""Full-frame tile-column-sharded pass B, the counterpart of the JAX
package's parallel/fullframe.py.

A frame's tile columns (`_tile_bounds`, the bitstream's own,
vp9.c:1244-1250) become stripes, one tile slot of a mesh row each
(parallel/mesh.py). The step reconstructs every stripe (residual, MC
against the frame's reference planes with the stripe's offset folded into
the motion, the stripe-local intra wavefront: VP9 intra prediction never
crosses a tile column), then runs the loop filter, which does cross tile
columns (the frame-wide serial filter of vp9.c:1441-1552), as a replay of
its recorded edge calls over the stripes with an 8-pixel column halo
exchanged after every wave step (ops/lpf_replay.py; the wave-safety
argument of the JAX module's header makes the merge exact).

Every tile slot of a row is on that row's device, so the JAX package's
shard_map becomes one pass over the row's slots, which calls each of the
port's kernels once per stage over all the stripes' planes:
  - the splat, the coefficient scatter and the consuming residual run on
    the frame's own buffers (the stripes are adjacent column ranges of
    them, and a transform block never crosses a tile column), which keeps
    the decoder's kept coefficient buffers reading zero after the frame;
  - MC runs on the stripes stacked one under the other, [T * H, Wpad] a
    plane (Wpad the widest stripe, the rest zero), the stripe's column
    offset x0 and row offset folded into each cell's motion, and edge
    clamping at the frame's visible size (mc_planes, one launch for the
    three planes). A frame with a reference of another size runs the
    scaled MC (mc_planes_scaled) on the frame's planes, whose columns the
    stripes partition, and the result is stacked: the scaled kernel reads
    each cell's block record through the splat's frame-wide index, and a
    stripe offset in it is left for a later change;
  - the intra wavefront runs on the stacked planes with the frame's slab
    moved to the stripes' coordinates (`_stripe_slab`: the rows and
    levels that the JAX package's `_split_levels` keeps), one launch for
    three stacked planes, so INTRA_MAX_PLANES stays 3;
  - the loop filter runs csrc/lpf_replay.cu once a plane set (Y, then U
    and V), a thread block a stripe, the stripes in one cluster, on
    buffers [T, B, H, HALO + Wpad].
ppermute and psum become copies between the slots' buffers. The outputs
stay on the device: `sharded_decode_pass_b` returns each frame's padded
planes as int32 tensors there, and `install` makes them the frame's
planes, so later frames take them as references.

The gop axis runs the rows' frames one after another on their devices
(gop row g on cuda:(g % device_count)), each with its decoder's own kept
buffers and states.

On a mesh whose tile axis crosses torch.distributed ranks
(parallel/mesh.py's make_rank_mesh, parallel/dist.py), every rank holds
the whole job, as every JAX process builds the whole tensors
(`prepare_gop_tensors`): its decoder runs pass A of every frame, and the
splat, the coefficient scatter and the residual run frame-wide on every
rank (about 0.03 ms on the card). MC and intra run on the rank's own
stripes (`local_tensors` takes its slices, by `put_spec`), the loop
filter through ops/lpf_replay.py's lf_scan_sharded_dist, which swaps the
halos on the boundaries with the other ranks. `sharded_decode_pass_b`
then returns each frame's `Stripes` (the rank's share), and
`gather_planes` rebuilds the frame's padded planes on every rank, so that
`install` chains frames: MC reads whole reference planes, replicated as
the JAX package's P("gop") places them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import lpf_replay, lpf_walk, recon
from ..utils.metrics import metrics
from .dist import all_gather_stripes

HALO = lpf_replay.HALO


# ---------------------------------------------------------------------------
# loop-filter edge recording


class _Tag:
    pass


def record_lf_python(s):
    """Record the exact loop-filter edge-call sequence by driving the
    mask walker (ops/lpf_walk.py) with a recording sink instead of the
    pixel filter. Returns (y_rec, ny, uv_rec, nuv): int16 [n, 8] rows
    (sb, py, px, dir, wd, E, I, H), 16-lane compound calls decomposed
    into their 8-lane halves — the same stream lpf_record_native emits
    (reference order: ff_vp9_loopfilter_sb, vp9lpf.c:183-230)."""
    h = s.header
    y_recs, uv_recs = [], []
    ytag, utag, vtag = _Tag(), _Tag(), _Tag()
    cur_sb = [0]

    def rec(plane, py, px, dir_, wd, E, I, H, bpp, nlanes=8):
        if plane is vtag:
            return
        sink = y_recs if plane is ytag else uv_recs
        sink.append((cur_sb[0], py, px, dir_, wd, E, I, H))
        if nlanes == 16:
            if dir_ == 0:
                sink.append((cur_sb[0], py + 8, px, dir_, wd, E, I, H))
            else:
                sink.append((cur_sb[0], py, px + 8, dir_, wd, E, I, H))

    planes = [ytag, utag, vtag]
    for sbr in range(s.sb_rows):
        for sbc in range(s.sb_cols):
            cur_sb[0] = sbr * s.sb_cols + sbc
            lpf_walk.loopfilter_sb(planes, s.lf_level[sbr, sbc],
                                   s.lf_mask[sbr, sbc], sbr * 8, sbc * 8,
                                   h.ss_h, h.ss_v, s.lim_lut, s.mblim_lut,
                                   h.bpp, apply=rec)
    y = np.asarray(y_recs, np.int16).reshape(-1, 8)
    uv = np.asarray(uv_recs, np.int16).reshape(-1, 8)
    return y, len(y), uv, len(uv)


def record_lf(s):
    """The native recorder when the frame's pass A was native (its
    failure raises: no silent fallback), the Python recorder otherwise."""
    if getattr(s, "use_native", False):
        from ..passa_native import lpf_record_native
        return lpf_record_native(s)
    return record_lf_python(s)


# ---------------------------------------------------------------------------
# per-tile schedule packing with GLOBAL wave/substep alignment


def pack_schedule_tiles(recs, n, sb_cols, tile_sb, x0_px, ss_h=0):
    """Split a recorded edge stream into per-tile step grids that share
    one global (wave, substep) numbering, so the sharded scan advances
    all tiles in lockstep and halo exchanges line up.

    recs: [n, 8] int16 (sb, py, px, dir, wd, E, I, H) in serial order.
    tile_sb: [ntile+1] tile SB-column boundaries. x0_px: [ntile] stripe
    pixel offsets in THIS plane's coordinates (Y or chroma). Returns
    [ntile, S, D, 7] int32 with px localized to stripe+HALO."""
    ntile = len(tile_sb) - 1
    if n == 0:
        return np.zeros((ntile, 64, 1, 7), np.int32)
    r = recs[:n].astype(np.int32)
    sb = r[:, 0]
    sbr = sb // sb_cols
    sbc = sb % sb_cols
    wave = 2 * sbr + sbc
    order = np.arange(n, dtype=np.int64)
    change = np.empty(n, bool)
    change[0] = True
    change[1:] = sb[1:] != sb[:-1]
    group_start = np.maximum.accumulate(np.where(change, order, 0))
    sub = order - group_start
    nwaves = int(wave.max()) + 1
    max_sub = np.zeros(nwaves, np.int64)
    np.maximum.at(max_sub, wave, sub + 1)
    base = np.zeros(nwaves, np.int64)
    base[1:] = np.cumsum(max_sub)[:-1]
    S = int(np.cumsum(max_sub)[-1])
    lane = sbr
    D = int(lane.max()) + 1
    tile = np.searchsorted(np.asarray(tile_sb[1:]), sbc, side="right")
    rows = base[wave] + sub
    steps = np.zeros((ntile, S, D, 7), np.int32)
    loc = r[:, 1:8].copy()
    loc[:, 1] = loc[:, 1] - np.asarray(x0_px)[tile] + HALO
    steps[tile, rows, lane] = loc
    S2 = 64
    while S2 < S:
        S2 *= 2
    if S2 != S:
        steps = np.concatenate(
            [steps, np.zeros((ntile, S2 - S, D, 7), np.int32)], axis=1)
    return steps


# ---------------------------------------------------------------------------
# host-side inputs


def _tile_bounds(s):
    from ..codecs.vp9.decoder import _tile_offset
    h = s.header
    bounds = [0]
    for i in range(h.tile_cols):
        _c0, c1 = _tile_offset(i, h.log2_tile_cols, s.sb_cols)
        bounds.append(c1 // 8)  # SB units
    return bounds


def _stripe_slab(slab, x0, Hp, Wpad):
    """The frame's intra slab (buf, L, sizes, caps) of a plane Hp high
    moved to its stripes stacked one under the other: a block of the
    stripe starting at column x0[t] moves to row py + t * Hp and column px
    - x0[t] (the rows the JAX package's _split_levels keeps for each
    stripe, with their levels); inert rows move past the stacked plane,
    [T * Hp, Wpad]."""
    buf, L, sizes, caps = slab
    x0 = np.asarray(x0, np.int64)
    out = buf.copy()
    real = buf[:, 0] < Hp
    px = buf[real, 1].astype(np.int64)
    t = np.searchsorted(x0[1:], px, side="right")
    out[real, 0] = buf[real, 0] + t * Hp
    out[real, 1] = px - x0[t]
    out[~real, 0] = len(x0) * Hp + 64
    out[~real, 1] = Wpad + 64
    return out, L, sizes, caps


def frame_tensors(s):
    """The host side of a frame's sharded step: the stripe geometry of
    its tile columns, the loop filter's per-stripe steps and the intra
    slabs in the stripes' coordinates. Returns (t, cfg): t holds numpy
    arrays (x0, x0u, wreal, wrealu, ysteps, uvsteps, and yslab, uvslab:
    (buf, L, sizes, caps) or None), cfg the frame's scalars. A frame
    whose inter blocks use a reference of invalid size raises ValueError,
    as the serial path does."""
    h = s.header
    if getattr(s, "pre", None) is None:
        recon.precompute_host(s)
    recon._check_refs(s, s.pre["recs"])
    bounds = _tile_bounds(s)  # SB units
    ntile = len(bounds) - 1
    ss_h, ss_v = h.ss_h, h.ss_v
    Hy, Wy = s.sb_rows * 64, s.sb_cols * 64
    Hu = Hy >> ss_v
    x0 = np.asarray([b * 64 for b in bounds[:-1]], np.int32)
    x1 = np.asarray([b * 64 for b in bounds[1:]], np.int32)
    wreal = x1 - x0
    Wpad = int(wreal.max())
    x0u, wrealu = x0 >> ss_h, wreal >> ss_h
    Wpadu = Wpad >> ss_h
    t = {"x0": x0, "x0u": x0u.astype(np.int32),
         "wreal": wreal.astype(np.int32),
         "wrealu": wrealu.astype(np.int32)}
    slabs = s.pre["slabs"]
    t["yslab"] = None if slabs[0] is None else _stripe_slab(
        slabs[0], x0, Hy, Wpad)
    t["uvslab"] = None if slabs[1] is None else _stripe_slab(
        slabs[1], x0u, Hu, Wpadu)
    if h.filter_level:
        with metrics.timer("sharded.record_lf"):
            yrec, ny, uvrec, nuv = record_lf(s)
            t["ysteps"] = pack_schedule_tiles(yrec, ny, s.sb_cols, bounds,
                                              x0)
            t["uvsteps"] = pack_schedule_tiles(uvrec, nuv, s.sb_cols,
                                               bounds, x0u)
    w, hh = s.cur_frame_obj.size
    cfg = {
        "ntile": ntile, "bpp": h.bpp, "lossless": bool(h.lossless),
        "lf": bool(h.filter_level), "ss_h": ss_h, "ss_v": ss_v,
        "w": w, "hh": hh, "Hy": Hy, "Wy": Wy, "Hu": Hu,
        "Wpad": Wpad, "Wpadu": Wpadu,
        "scaled": any(sc[0] for sc in s.mvscale),
    }
    return t, cfg


# ---------------------------------------------------------------------------
# the sharded step


def _stack(a, x0, w, wpad):
    """The stripes of a frame-wide array a [R, C, ...] (columns x0[t] ..
    x0[t] + w[t], in a's column units) stacked one under the other,
    [T * R, wpad, ...], zero beyond each stripe's width."""
    T = len(x0)
    out = a.new_zeros((T, a.shape[0], wpad) + tuple(a.shape[2:]))
    for t in range(T):
        out[t, :, :w[t]] = a[:, x0[t]:x0[t] + w[t]]
    return out.reshape((T * a.shape[0], wpad) + tuple(a.shape[2:]))


def _unstack(a, w):
    """The frame-wide [R, sum(w)] array of stripes a [T, R, >= max(w)]."""
    return torch.cat([a[t, :, :wt] for t, wt in enumerate(w)], dim=1)


def _fold_motion(mv16, T, r4, x0, Hp, mvsx, mvsy):
    """Fold each stacked stripe's offsets into its cells' motion (mv16
    [T * r4, c, 2, 2] int32, this plane's units before the mvsx/mvsy
    scale): + x0[t] columns and - t * Hp rows, so that the MC of a cell at
    row i of the stacked plane gathers from the reference at its frame
    position (the JAX package folds x0 alone, fullframe.py:564)."""
    dev = mv16.device
    offx = torch.as_tensor(np.repeat(np.asarray(x0, np.int64)
                                     * (16 // mvsx), r4), device=dev)
    offy = torch.as_tensor(np.repeat(-np.arange(T, dtype=np.int64) * Hp
                                     * (16 // mvsy), r4), device=dev)
    mv = mv16.clone()
    mv[..., 0] += offx[:, None, None].to(mv.dtype)
    mv[..., 1] += offy[:, None, None].to(mv.dtype)
    return mv


def _stripe_planes(s, t, cfg, plane_grids, residuals, has_inter, has_comp):
    """Residual + MC + intra of every stripe of the frame's three planes,
    stacked: [T * H, Wpad] int32 a plane (the JAX package's _stripe_plane
    on every stripe of every plane; one launch a stage)."""
    T = cfg["ntile"]
    bpp = cfg["bpp"]
    ss_h, ss_v = cfg["ss_h"], cfg["ss_v"]
    dev = s.device
    geo = []   # per plane: (H, x0, w, Wpad, ss_x, ss_y)
    for p in range(3):
        ss_x, ss_y = (ss_h, ss_v) if p else (0, 0)
        if p:
            geo.append((cfg["Hu"], t["x0u"], t["wrealu"], cfg["Wpadu"],
                        ss_x, ss_y))
        else:
            geo.append((cfg["Hy"], t["x0"], t["wreal"], cfg["Wpad"], 0, 0))
    res_st = [_stack(r, x0, w, wp) for r, (_H, x0, w, wp, _a, _b)
              in zip(residuals, geo)]
    if has_inter and cfg["scaled"]:
        with metrics.timer("recon.mc"):
            outs = recon.inter_planes_scaled(s, plane_grids, residuals,
                                             has_comp)
        outs = [_stack(o, x0, w, wp) for o, (_H, x0, w, wp, _a, _b)
                in zip(outs, geo)]
    elif has_inter:
        jobs = []
        for p, (res, g, (H, x0, w, wp, ss_x, ss_y)) in enumerate(
                zip(res_st, plane_grids, geo)):
            inter4, _tx, _tt, comp, filt, refsel, mv16 = g
            c0, cw = x0 // 4, w // 4
            mvsx, mvsy = 2 >> ss_x, 2 >> ss_y
            refplanes, _dims = recon._ref_planes(s, p, ss_x, ss_y)
            mv = _fold_motion(_stack(mv16, c0, cw, wp // 4), T, H // 4, x0,
                              H, mvsx, mvsy)
            jobs.append((res, _stack(inter4, c0, cw, wp // 4),
                         _stack(comp, c0, cw, wp // 4),
                         _stack(filt, c0, cw, wp // 4),
                         _stack(refsel, c0, cw, wp // 4), mv, refplanes,
                         (cfg["w"] + ss_x) >> ss_x,
                         (cfg["hh"] + ss_y) >> ss_y, mvsx, mvsy))
        with metrics.timer("recon.mc"):
            outs = recon.mc_planes(jobs, bpp, has_comp)
    else:
        outs = [torch.zeros(r.shape, dtype=torch.int32, device=dev)
                for r in res_st]
    jobs, which = [], []
    for p in range(3):
        slab = t["uvslab" if p else "yslab"]
        if slab is None:
            continue
        buf, L, sizes, caps = slab
        jobs.append((outs[p], res_st[p],
                     torch.from_numpy(buf).to(dev), L, sizes, caps))
        which.append(p)
    if jobs:
        with metrics.timer("recon.intra_run"):
            for p, plane in zip(which, recon._intra_scan_planes(jobs, bpp)):
                outs[p] = plane
    return outs


def _sb(cfg, which):
    """The superblock's (width, height) in the samples of the plane set
    whose steps are t[which]."""
    if which == "ysteps":
        return 64, 64
    return 64 >> cfg["ss_h"], 64 >> cfg["ss_v"]


def _sharded_lf(cfg, outs, scan):
    """The cross-tile loop filter of the stacked planes outs: the stripes
    of Y, then of U and V together, in buffers [T, B, H, HALO + Wpad],
    one scan(buf, steps key, real widths key) a set. Returns the three
    planes' filtered stripes, [T, H, Wpad] each."""
    T = cfg["ntile"]
    stripes = []
    for which, wkey, idx, H, wp in (
            ("ysteps", "wreal", (0,), cfg["Hy"], cfg["Wpad"]),
            ("uvsteps", "wrealu", (1, 2), cfg["Hu"], cfg["Wpadu"])):
        dev = outs[0].device
        buf = torch.zeros((T, len(idx), H, HALO + wp), dtype=torch.int32,
                          device=dev)
        for b, p in enumerate(idx):
            buf[:, b, :, HALO:] = outs[p].view(T, H, wp)
        if cfg["lf"]:
            with metrics.timer("recon.lf"):
                buf = scan(buf, which, wkey)
        stripes += [buf[:, b, :, HALO:] for b in range(len(idx))]
    return stripes


class Stripes:
    """A rank's share of a frame's sharded pass B on a mesh whose tile
    axis crosses ranks: planes [y, u, v], each [hi - lo, H, Wpad] (stripe
    lo + i's real columns first), the stripes lo .. hi - 1 of a gop row
    whose slots `ranks` [T] own; wreal and wrealu every stripe's real
    width in Y and in chroma."""

    def __init__(self, planes, lo, hi, ranks, wreal, wrealu):
        self.planes, self.lo, self.hi = planes, lo, hi
        self.ranks, self.wreal, self.wrealu = ranks, wreal, wrealu


# The frame_tensors keys as they are placed on a mesh, after the JAX
# package's put_spec: a stripe's own slice along the tile axis for every
# key. The JAX package's replicated tensors (its _NON_TILED, P("gop"):
# the reference planes and the scaled MC's and geometry's scalars) have
# no counterpart among them: MC reads the references from the frame's
# decoder, which every rank runs, and the scalars ride in cfg.
TILED = ("x0", "x0u", "wreal", "wrealu", "ysteps", "uvsteps", "yslab",
         "uvslab")


def put_spec(name, ndim):
    """The placement of frame_tensors' key `name` (ndim dimensions with
    the gop axis), as the JAX package's put_spec gives it: ("gop",
    "tile", None ...) for a key split along the tile axis."""
    if name not in TILED:
        raise KeyError(f"{name} is not a frame_tensors key")
    return ("gop", "tile") + (None,) * (ndim - 2)


def _local_slab(slab, lo, hi, Hp, Wpad):
    """The stacked intra slab (_stripe_slab) of stripes lo .. hi - 1
    alone: their rows moved up by lo stripes, the other stripes' rows made
    inert (past the stacked plane of hi - lo stripes)."""
    buf, L, sizes, caps = slab
    out = buf.copy()
    row = buf[:, 0].astype(np.int64)
    keep = (row >= lo * Hp) & (row < hi * Hp)
    out[keep, 0] = row[keep] - lo * Hp
    out[~keep, 0] = (hi - lo) * Hp + 64
    out[~keep, 1] = Wpad + 64
    return out, L, sizes, caps


def local_tensors(t, cfg, lo, hi):
    """The frame_tensors t of stripes lo .. hi - 1 (a rank's slots of a
    gop row): every put_spec key sliced along the tile axis, the slabs
    moved to the local stacking."""
    out = {}
    for k in TILED:
        v = t.get(k)
        if v is None:
            out[k] = None
        elif k in ("yslab", "uvslab"):
            Hp, wp = ((cfg["Hy"], cfg["Wpad"]) if k == "yslab"
                      else (cfg["Hu"], cfg["Wpadu"]))
            out[k] = _local_slab(v, lo, hi, Hp, wp)
        else:
            out[k] = v[lo:hi]
    return out


def build_sharded_step(mesh, cfg, exchange=None, g=0):
    """The sharded pass-B step for one frame geometry: a callable
    step(s, t) that reconstructs the frame s (a FrameJob; t, its
    frame_tensors) on its row's device and returns its three padded
    planes, filtered, as int32 tensors there. On a mesh of several ranks
    (exchange: this rank's HaloExchange; g: the frame's gop row) the step
    reconstructs the rank's stripes of the row alone, filters them with
    lf_scan_sharded_dist and returns their Stripes."""
    ntile = mesh.devices.shape[1]
    if cfg["ntile"] != ntile:
        raise ValueError(f"stream has {cfg['ntile']} tile cols, mesh wants "
                         f"{ntile}")
    lo, hi = 0, ntile
    if mesh.world > 1:
        if exchange is None:
            raise ValueError(f"a mesh of {mesh.world} ranks needs the "
                             "rank's HaloExchange")
        slots = {row: (a, b) for row, a, b in
                 mesh.local_slots(exchange.rank)}
        if g not in slots:
            raise ValueError(f"rank {exchange.rank} owns no slot of gop row "
                             f"{g}")
        lo, hi = slots[g]
    if hi - lo > lpf_replay.MAX_STRIPES:
        raise ValueError(f"{hi - lo} tile columns: the replay kernel "
                         f"takes at most {lpf_replay.MAX_STRIPES}")

    def frame(s):
        recon.upload_job(s)
        return recon.frame_residuals(s)

    if mesh.world == 1:
        def step(s, t):
            outs = _stripe_planes(s, t, cfg, *frame(s))

            def scan(buf, which, wkey):
                return lpf_replay.lf_scan_sharded(buf, t[which], t[wkey],
                                                  cfg["bpp"], _sb(cfg, which))
            stripes = _sharded_lf(cfg, outs, scan)
            return [_unstack(p, w) for p, w in zip(
                stripes, (t["wreal"], t["wrealu"], t["wrealu"]))]
        return step

    ranks = [int(r) for r in mesh.ranks[g]]
    local_cfg = dict(cfg, ntile=hi - lo)

    def dist_step(s, t):
        outs = _stripe_planes(s, local_tensors(t, cfg, lo, hi), local_cfg,
                              *frame(s))

        def scan(buf, which, wkey):
            return lpf_replay.lf_scan_sharded_dist(
                buf, t[which], t[wkey], cfg["bpp"], ranks, exchange,
                _sb(cfg, which))
        return Stripes(_sharded_lf(local_cfg, outs, scan), lo, hi, ranks,
                       t["wreal"], t["wrealu"])

    return dist_step


def gather_planes(out, exchange=None):
    """A frame's three padded planes on every rank from each rank's
    Stripes (all_gather_stripes; every rank of the group calls it, in
    the same order); anything else (a single-process output, a
    show-existing job's planes) is returned as it is."""
    if not isinstance(out, Stripes):
        return out
    return [_unstack(all_gather_stripes(p, out.ranks, exchange), w)
            for p, w in zip(out.planes, (out.wreal, out.wrealu,
                                         out.wrealu))]


def _device_key(dev):
    """(type, index) of a device, a card without an index taken as the
    current one."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return "cuda", torch.cuda.current_device()
    return dev.type, dev.index


def _ready_planes(j):
    """The planes a show-existing job passes through (None when the
    packet shows nothing): its frame's device planes, or its host planes
    as int32 tensors."""
    if not j.ready:
        return None
    f = j.ready[0]
    if f.dev is not None:
        return list(f.dev)
    return [torch.as_tensor(np.asarray(p, np.int32)) for p in f.planes]


def sharded_decode_pass_b(jobs, mesh, exchange=None):
    """Decode pass B for `jobs` (a list of FrameJob, one per gop row)
    sharded over the mesh's (gop, tile) slots: per-stripe residual + MC +
    intra, then the cross-tile loop filter with its halo exchange.
    Returns one [y, u, v] list of padded int32 planes on the row's device
    per job, bit-exact with the serial decode (a show-existing job's: its
    referenced frame's planes). The frames may differ in geometry and in
    scaled references; bpp, lossless, subsampling and tile count must
    match. A job's decoder must be on its row's device. On a mesh of
    several ranks each rank calls it with the same jobs and its
    HaloExchange, and gets each job's Stripes (gather_planes rebuilds the
    planes)."""
    gop, _ntile = mesh.devices.shape
    if len(jobs) != gop:
        raise ValueError(f"{len(jobs)} jobs for {gop} gop rows")
    active = [(g, j) for g, j in enumerate(jobs) if j.ready is None]
    outs = [_ready_planes(j) if j.ready is not None else None for j in jobs]
    if not active:
        return outs
    built, cfg = prepare_gop_tensors([j for _g, j in active], _ntile)
    rank = 0 if exchange is None else exchange.rank
    for (g, j), (t, c) in zip(active, built):
        dev = mesh.row_device(g, rank)
        if _device_key(j.device) != _device_key(dev):
            raise ValueError(f"gop row {g} is on {dev}, its frame's decoder "
                             f"on {j.device}")
        with metrics.timer("sharded.step"):
            outs[g] = build_sharded_step(mesh, c, exchange, g)(j, t)
    return outs


def install(job, planes):
    """Make the sharded outputs `planes` the frame's own (its device
    planes), as the serial pass B leaves them, so that later frames take
    them as references."""
    f = job.cur_frame_obj
    f.dev = list(planes)
    f._host_stale = True


def prepare_gop_tensors(jobs, ntile):
    """Host-side preparation of the gop rows' frames: frame_tensors of
    each, after checking that they share bpp, lossless, subsampling and
    tile count, and that the count is the mesh's. Returns ([(t, cfg)]
    per job, the first cfg)."""
    built = [frame_tensors(j) for j in jobs]
    keys = ("ntile", "bpp", "lossless", "ss_h", "ss_v")
    cfg = built[0][1]
    for _t, c in built[1:]:
        if any(c[k] != cfg[k] for k in keys):
            raise ValueError(
                "gop-sharded frames must share bpp/lossless/"
                "subsampling/tile count")
    if cfg["ntile"] != ntile:
        raise ValueError(
            f"stream has {cfg['ntile']} tile cols, mesh wants {ntile}")
    return built, cfg
