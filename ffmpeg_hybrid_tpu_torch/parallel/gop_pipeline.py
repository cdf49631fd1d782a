"""Chained-GOP stripe pipeline: consecutive chained frames across the gop
rows of a mesh, the counterpart of the JAX package's
parallel/gop_pipeline.py.

GOP parallelism (parallel/gop.py) degenerates when keyframes are sparse:
one worker owns a long chained run while the rest idle. The reference's
answer is frame threading with row-granular progress waits: decoder
state forwarded thread to thread (pthread_frame.c:501) and frame N+1's
MC for row r blocking until frame N has decoded past r plus the refetch
border (progressframe.h:88-102, vp9recon.c:392-395). Here consecutive
CHAINED frames (each referencing the previous, refresh_mask 0x01) go to
consecutive gop rows of a [G, 1] mesh (parallel/mesh.py), each frame's
pass B runs in horizontal stripes of Hs rows under a static schedule
with a lag of `lag` steps, and after every step each row copies a window
of its frame into the next row's reference buffer: the row-await
contract turned into a fixed order of copies.

Schedule: at step k, row g reconstructs stripe j = k - g * lag of frame
g (when 0 <= j < S_f). By then it has received stripes 0 .. j + lag - 1
of frame g - 1, reference rows < (j + lag) * Hs. MC of stripe j reads
reference rows up to (j + 1) * Hs - 1 + mv + 4 (the 8-tap reach), so the
static schedule is exact when |mv_y| <= (lag - 1) * Hs - 16 px, the
bound with the loop filter's 8-row guard below; `decode_chained_gop`
checks it on the frames' block records.

A stripe's reconstruction is the port's inter pass (ops/recon.py
mc_planes, csrc/mc.cu: one launch for the three planes) on the stripe's
rows of the frame's residual and cell grids, with the stripe's row
origin folded into the motion so that the gathers hit frame rows, and
the row's reference buffer as all three references. The residual of the
whole frame is computed once, right after its pass A (splat, scatter
and the consuming residual: recon.frame_residuals); it reads no
reference pixel. Hs is a multiple of 64, so no transform block crosses
a stripe.

The loop filter follows the reference's 8-row finality guard
(vp9recon.c:392-394): each stripe's recorded edge calls (the serial
order of ff_vp9_loopfilter_sb, parallel/fullframe.record_lf), split into
the stripe's superblock rows and packed into wavefront steps
(ops/lpf_replay.pack_schedule), replay on the row's own frame buffer
right after the stripe's reconstruction (lpf_replay.lf_scan,
csrc/lpf_replay.cu: a launch for Y, one for U and V). A stripe's edges
touch rows [j * Hs - 8, (j + 1) * Hs) only, so the replay runs on that
band of the plane, its records' rows shifted. Horizontal edges at a
stripe's top modify the previous stripe's last 8 rows, so the window
forwarded after stripe j is Hs + 8 rows from 8 above the stripe, rows
[j * Hs - 8, (j + 1) * Hs) (from row 0 for the first stripe). Its last 8
rows are not final yet; the next stripe's window overwrites them before
any read the MV bound allows.

Every row's reconstruction and filter of a step come before any
forward of that step, as the JAX module's ppermute delivers a step's
stripes after the step. On one card every row is cuda:0 and a forward
is a copy on the card; where rows are on other cards it is a copy to
the next row's device. The reference buffers are the rows' own: row g +
1 never reads row g's frame buffer, only the windows forwarded to it.

Scope (as the JAX driver asserts it, ValueError here): chained all-inter
frames after one keyframe, unscaled references, 4:2:0, and the MV
bound. Intra blocks inside chained frames would also need the
above-row pixel handoff of the intra wavefront.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import lpf_replay, recon
from .fullframe import install, record_lf

# record columns (ops/recon.py _records_from_blocks): block size (pad
# rows -1), intra flag, and the first of the motion vectors, mv[q][ref]
# (x, y) at 18 + 4 q + 2 ref
_BS, _INTRA, _MV = 3, 6, 18
# block sizes above this are under 8x8, with a motion a quadrant
_BS_8X8 = 9


def _max_mv_y(recs):
    """The largest |mv_y| of a frame's block records [N, 36] (1/8 pel) as
    the JAX driver reads it from the frame's mv4 grid: both reference
    slots of every block, mv[0] of a block of 8x8 or more, every
    quadrant's of a smaller one."""
    r = recs[recs[:, _BS] >= 0].astype(np.int64)
    if not len(r):
        return 0
    ys = r[:, _MV + 1:_MV + 16:2].reshape(-1, 4, 2)   # [N, q, ref]
    big = r[:, _BS] <= _BS_8X8
    ys = np.where(big[:, None, None], ys[:, :1], ys)
    return int(np.abs(ys).max())


def _check_frame(job, prev, lag, Hs):
    """The JAX driver's scope asserts on one inter frame (its pass A done
    and its records packed), as ValueError."""
    h = job.header
    if h.keyframe or h.intraonly:
        raise ValueError("chained gop: no frame after the first may be a "
                         "keyframe or intra-only")
    if not (h.ss_h == 1 and h.ss_v == 1):
        raise ValueError("demo scope: 4:2:0")
    if not all(list(sc) == [0, 0] for sc in job.mvscale):
        raise ValueError("unscaled refs")
    recs = job.pre["recs"]
    real = recs[:, _BS] >= 0
    if (recs[real, _INTRA] != 0).any():
        raise ValueError("demo scope: all-inter frames")
    for i in range(3):
        if job.refs[h.refidx[i]] is not prev:
            raise ValueError("chained gop: every ref must be the previous "
                             "frame")
    mvb = _max_mv_y(recs) // 8
    # 8-tap reach + the 8-row loop-filter finality guard
    if mvb > (lag - 1) * Hs - 16:
        raise ValueError(f"|mv_y|={mvb}px exceeds the static lag-{lag} "
                         "bound")


def _band_steps(recs, n, sb_cols, S_f, sbs_per, Hs_p, W_p, B, sb, device):
    """A frame's recorded edge calls of one plane set (recs [n, 8]: sb,
    py, px, dir, wd, E, I, H) split into the stripes' superblock-row bands
    and packed into wavefront steps (pack_schedule, bucket=False), each
    record's row moved into its band, rows [max(j * Hs_p - 8, 0), (j +
    1) * Hs_p) of the plane (W_p columns, B planes, superblocks of sb
    samples): a list of S_f lpf_replay.Replay (the steps, and on the card
    their tickets, built and uploaded here, ahead of the run), None for a
    band without a record."""
    r = np.asarray(recs[:n], np.int32) if n else np.zeros((0, 8), np.int32)
    band = r[:, 0] // sb_cols // sbs_per
    out = []
    for j in range(S_f):
        rr = r[band == j].copy()
        if not len(rr):
            out.append(None)
            continue
        rr[:, 0] -= j * sbs_per * sb_cols
        steps = lpf_replay.pack_schedule(rr, len(rr), sb_cols, bucket=False)
        live = steps[..., 3] > 0
        y0 = max(j * Hs_p - 8, 0)
        steps[..., 0][live] -= y0
        rp = lpf_replay.Replay(steps[None], (1, B, (j + 1) * Hs_p - y0, W_p),
                               sb)
        if torch.device(device).type != "cpu":
            rp.tables(device)
        out.append(rp)
    return out


def prepare_frame(job, device, S_f, Hs):
    """A chained frame's pass-B inputs on `device`, made right after its
    pass A (the native pass A's buffers rotate through POOL_DEPTH slots,
    and its loop-filter recorder reads the job's): the cell grids and the
    three residual planes (recon.frame_residuals), and the loop filter's
    per-stripe steps of Y and of U+V (None where the frame is not
    filtered), with the superblock's (width, height) in each set's
    samples. Returns a dict for the pipeline's run."""
    job.device = device
    recon.upload_job(job)
    grids, residuals, _has_inter, has_comp = recon.frame_residuals(job)
    h = job.header
    fr = {"grids": grids, "residuals": residuals, "has_comp": has_comp,
          "ysteps": [None] * S_f, "uvsteps": [None] * S_f,
          "sb": ((64, 64), (64 >> h.ss_h, 64 >> h.ss_v))}
    if h.filter_level:
        y_rec, ny, uv_rec, nuv = record_lf(job)
        sbs_per = Hs // 64
        W = job.sb_cols * 64
        fr["ysteps"] = _band_steps(y_rec, ny, job.sb_cols, S_f, sbs_per, Hs,
                                   W, 1, fr["sb"][0], device)
        fr["uvsteps"] = _band_steps(uv_rec, nuv, job.sb_cols, S_f, sbs_per,
                                    Hs >> h.ss_v, W >> h.ss_h, 2,
                                    fr["sb"][1], device)
    return fr


def forward(k, outs, refs, S_f, lag, Hs_p):
    """Step k's forwards of one plane: every row g whose stripe j = k - g
    * lag is in 0 .. S_f - 1 copies rows [max(j * Hs_p - 8, 0), + Hs_p +
    8) of its frame buffer outs[g] into the next row's reference buffer
    refs[g + 1] (the JAX module's ppermute of that window). outs, refs:
    a plane a row, [H, W] each."""
    for g in range(len(outs) - 1):
        j = k - g * lag
        if 0 <= j < S_f:
            H = outs[g].shape[0]
            y0 = max(j * Hs_p - 8, 0)
            y1 = min(y0 + Hs_p + 8, H)
            refs[g + 1][y0:y1].copy_(outs[g][y0:y1])


def _check_args(mesh, G, Hs, lag):
    """ValueError unless mesh is [G, 1], Hs a positive multiple of 64 and
    lag at least 1."""
    if mesh.devices.shape != (G, 1):
        raise ValueError(f"the pipeline runs on a [{G}, 1] mesh, not "
                         f"{list(mesh.devices.shape)}")
    if Hs <= 0 or Hs % 64:
        raise ValueError(f"stripes of {Hs} rows: a multiple of 64")
    if lag < 1:
        raise ValueError(f"a lag of {lag} steps")


def build_stripe_pipeline(mesh, G, S_f, Hs, lag, dims, lossless, bpp,
                          ss_h, ss_v):
    """The pipelined pass B of G chained frames on the [G, 1] mesh.

    dims: (H64, W64, w, hh), the luma plane's padded and visible size.
    The residuals come made (prepare_frame), so `lossless` (the JAX
    signature's) changes nothing here. Returns run(frames, ref0): frames,
    G prepare_frame dicts, frame g's on row g's device; ref0, the root
    frame's three
    padded planes on row 0's device. run yields the rows' decoded planes,
    [y, u, v] a row on its device."""
    _check_args(mesh, G, Hs, lag)
    H64, W64, w, hh = dims
    Hs_p = (Hs, Hs >> ss_v, Hs >> ss_v)
    shapes = ((H64, W64), (H64 >> ss_v, W64 >> ss_h),
              (H64 >> ss_v, W64 >> ss_h))
    vis = ((w, hh),) + (((w + ss_h) >> ss_h, (hh + ss_v) >> ss_v),) * 2
    mvs = ((2, 2),) + ((2 >> ss_h, 2 >> ss_v),) * 2
    nsteps = S_f + (G - 1) * lag
    devs = [mesh.row_device(g) for g in range(G)]

    def recon_stripe(fr, j, refs):
        """Stripe j of a frame's three planes: MC on the row's reference
        buffers plus the residual, one mc_planes call."""
        jobs = []
        for p in range(3):
            inter4, _tx, _tt, comp, filt, refsel, mv16 = fr["grids"][p]
            y0, n = j * Hs_p[p], Hs_p[p]
            r0, nr = y0 // 4, n // 4
            mvsx, mvsy = mvs[p]
            # the stripe's row origin folded into the motion (the
            # vertical counterpart of fullframe._fold_motion)
            mv = mv16[r0:r0 + nr].to(torch.int32, copy=True)
            mv[..., 1] += y0 * (16 // mvsy)
            jobs.append((fr["residuals"][p][y0:y0 + n], inter4[r0:r0 + nr],
                         comp[r0:r0 + nr], filt[r0:r0 + nr],
                         refsel[r0:r0 + nr], mv, (refs[p],) * 3,
                         vis[p][0], vis[p][1], mvsx, mvsy))
        return recon.mc_planes(jobs, bpp, fr["has_comp"])

    def filter_stripe(fr, j, out):
        """The loop filter of stripe j on its bands of the row's frame
        buffers out (Y, then U and V together), in place."""
        y0, y1 = max(j * Hs - 8, 0), (j + 1) * Hs
        if fr["ysteps"][j] is not None:
            out[0][y0:y1] = lpf_replay.lf_scan(out[0][None, y0:y1],
                                               fr["ysteps"][j], bpp,
                                               fr["sb"][0])[0]
        u0, u1 = max(j * Hs_p[1] - 8, 0), (j + 1) * Hs_p[1]
        if fr["uvsteps"][j] is not None:
            uv = lpf_replay.lf_scan(torch.stack([out[1][u0:u1],
                                                 out[2][u0:u1]]),
                                    fr["uvsteps"][j], bpp, fr["sb"][1])
            out[1][u0:u1] = uv[0]
            out[2][u0:u1] = uv[1]

    def run(frames, ref0):
        if len(frames) != G:
            raise ValueError(f"{len(frames)} frames for {G} gop rows")
        # row 0 predicts from the root frame; the others from what their
        # predecessor forwards, zero until then
        refs = [[r.to(devs[0]) for r in ref0]] + [
            [torch.zeros(s, dtype=torch.int32, device=d) for s in shapes]
            for d in devs[1:]]
        outs = [[torch.zeros(s, dtype=torch.int32, device=d)
                 for s in shapes] for d in devs]
        for k in range(nsteps):
            active = [(g, k - g * lag) for g in range(G)
                      if 0 <= k - g * lag < S_f]
            for g, j in active:
                planes = recon_stripe(frames[g], j, refs[g])
                for p in range(3):
                    y0 = j * Hs_p[p]
                    outs[g][p][y0:y0 + Hs_p[p]] = planes[p]
            for g, j in active:
                filter_stripe(frames[g], j, outs[g])
            for p in range(3):
                forward(k, [o[p] for o in outs], [r[p] for r in refs], S_f,
                        lag, Hs_p[p])
        return outs

    return run


def prepare_chained_gop(packets, mesh, Hs=64, lag=2, use_native=None):
    """Pass A of [keyframe, inter_1 .. inter_G] on the host (frame-serial
    by spec) with each inter frame's pass-B inputs made right after it on
    its gop row's device (prepare_frame), after the scope checks of the
    JAX driver (ValueError). The keyframe decodes serially on row 0's
    device. Returns (run, frames, ref0, jobs): run from
    build_stripe_pipeline, its inputs, and the inter frames' FrameJobs."""
    from ..codecs.vp9.decoder import VP9Decoder

    G = mesh.devices.shape[0]
    _check_args(mesh, G, Hs, lag)
    dec = VP9Decoder(device=mesh.row_device(0), use_native=use_native)
    dec.decode(packets[0])
    if dec.header is None or not dec.header.keyframe:
        raise ValueError("chained gop: the first packet must be a keyframe")
    root = dec.cur_frame
    # unscaled references keep every chained frame at the root's size
    H64, W64 = root.sb_rows * 64, root.sb_cols * 64
    if H64 % Hs:
        raise ValueError(f"{H64} rows do not make stripes of {Hs}")
    S_f = H64 // Hs
    jobs, frames = [], []
    for g, pkt in enumerate(packets[1:]):
        job = dec.decode_pass_a(pkt)
        if job.ready is not None:
            raise ValueError("chained gop: a show-existing frame")
        recon.precompute_host(job)
        _check_frame(job, jobs[-1].cur_frame_obj if jobs else root, lag, Hs)
        frames.append(prepare_frame(job, mesh.row_device(min(g, G - 1)),
                                    S_f, Hs))
        jobs.append(job)
    if len(jobs) != G:
        raise ValueError(f"need exactly {G} chained inter frames")
    h = jobs[0].header
    run = build_stripe_pipeline(mesh, G, S_f, Hs, lag,
                                (H64, W64, *root.size), bool(h.lossless),
                                int(h.bpp), h.ss_h, h.ss_v)
    return run, frames, list(root.dev), jobs


def decode_chained_gop(packets, mesh, Hs=64, lag=2, use_native=None):
    """Decode [keyframe, inter_1 .. inter_G] with pass A on the host and
    the chained pass B pipelined across the [G, 1] mesh's gop rows (G
    from the mesh). Returns ((oy, ou, ov), jobs): the G inter frames'
    padded planes as int32 tensors [G, H64, W64] and [G, Hu, Wu] on row
    0's device, and their FrameJobs, whose frames take their row's
    planes (fullframe.install). use_native: the pass A, as VP9Decoder
    takes it (None: native where it is built).

    Raises ValueError outside the scope the JAX driver asserts: the first
    packet a keyframe, every later frame inter, 4:2:0, unscaled
    references, no intra block, every reference the previous frame,
    |mv_y| <= (lag - 1) * Hs - 16 px, exactly G inter frames, Hs a
    multiple of 64 that divides the padded height."""
    run, frames, ref0, jobs = prepare_chained_gop(packets, mesh, Hs, lag,
                                                  use_native)
    outs = run(frames, ref0)
    for job, planes in zip(jobs, outs):
        install(job, planes)
    dev0 = mesh.row_device(0)
    stacked = tuple(torch.stack([o[p].to(dev0) for o in outs])
                    for p in range(3))
    return stacked, jobs
