"""GPU pass-B reconstruction backend (PyTorch), the counterpart of the
JAX package's ops/recon_tpu.py.

Architecture (the reference's accumulate-then-dispatch WebGPU idea,
reference: vp9_webgpu.c:2956):
  0. splat           — pass A's block records become the per-4x4-cell
                       grids (inter, tx size and type, comp, filter,
                       refs, MVs) of Y and chroma. On the card one
                       call of csrc/splat.cu per frame (an index launch
                       and a gather launch that starts while it runs,
                       on an index grid kept from frame to frame under
                       an epoch); the plain version,
                       _grids_from_records_plain, scatters and gathers
                       in eager ops
  1. residual pass   — the coefficient pairs scattered into dense
                       buffers kept from frame to frame (scatter_frame:
                       on the card one launch of csrc/itxfm.cu's scatter
                       per frame, no memset; the plain version,
                       _scatter_pairs16/32 copied in), then the inverse
                       transforms of every tx block of the three planes
                       (dc-only fast path by eob==1), which clear what
                       they read, so the buffers read zero for the next
                       frame. On
                       the card one launch of csrc/itxfm.cu per frame;
                       the plain version, residual_plane_plain with
                       _consume_plain, runs dense passes over a whole
                       plane (one per tx size, dct/adst variants
                       computed and selected per tile)
  2. inter pass      — uniform per-4x4-cell 8-tap MC (sub-pel phases and
                       filter banks gathered per cell; bilinear expressed
                       as an 8-tap bank), compound average, +residual. On
                       the card one launch of csrc/mc.cu per frame with
                       inter blocks, for the three planes; the plain
                       version, mc_planes_plain, is _mc_cells and the
                       apply per plane. A frame with a reference of
                       another size takes mc_planes_scaled instead (one
                       launch of csrc/mc.cu's scaled entry): per cell and
                       reference, a resized slot steps each pixel's
                       phase from its block's call anchor, a same-size
                       slot takes the unscaled arithmetic; the plain
                       version is mc_planes_scaled_plain
  3. intra wavefront — host-computed dependency levels, after the
                       three planes' residual and inter passes. On the
                       card one launch of csrc/intra.cu per frame walks
                       every level of the three planes side by side;
                       the plain version, _intra_scan_plain, loops
                       over the levels in Python, gathering each level's
                       edges and predicting them with one exact float32
                       product (ops/intra_tables) + TM
  4. loop filter     — pass A's per-superblock levels and edge masks
                       become dense parameter grids on the device
                       (ops/lpf_masks; on the card one launch of
                       csrc/lf_grids.cu per frame), then the
                       superblock-wavefront filter runs in place on Y
                       and U+V (ops/lpf_dense; on the card one launch
                       of csrc/lpf.cu per frame)

Every stage runs a kernel on the card. Each kernel's wrapper takes its
plain version only for tensors on the CPU and counts its launches
(LAUNCHES here for the splat, scatter, residual, MC and intra kernels,
lpf_masks.LAUNCHES, lpf_dense.LAUNCHES).

Frame planes stay on the device across frames (references included).
Every stage is integer math or exact float32, so the planes equal the
JAX package's bit for bit. The port covers VP9 profiles 0-3 (8, 10 and
12 bits; 4:2:0, 4:2:2, 4:4:0 and 4:4:4) and references of any valid
size; a frame whose inter blocks use a reference of invalid size raises
ValueError, as the reference does. At 10/12 bits the coefficients are
int32 and the residual runs its own kernel instantiation (64-bit
butterflies).

Where JAX clamps out-of-bounds gather indices and drops out-of-bounds
scatter writes, torch raises, so this module masks explicitly: pad and
inert rows scatter into a dump slot one past the plane, and gathers
clamp their indices.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils.metrics import metrics

from . import itxfm
from . import intra_tables as it
from . import lpf_dense, lpf_masks, recon_cuda
from ._cuda import check_tensor
from .recon_cuda import LAUNCHES, reset_launches  # noqa: F401
from ..codecs.vp9 import tables as T

XP = itxfm.TORCH

# ---------------------------------------------------------------------------
# filter taps: [4 banks][16 phases][8 taps]; bank 3 = bilinear as 8-tap
# ((128-8m)*a + 8m*b + 64) >> 7 == a + (m*(b-a) + 8) >> 4 exactly
_FTAB = np.zeros((4, 16, 8), np.int32)
_FTAB[:3] = T.SUBPEL_FILTERS
for _m in range(16):
    _FTAB[3, _m, 3] = 128 - 8 * _m
    _FTAB[3, _m, 4] = 8 * _m


# EDGES flags per converted mode: needs_left, needs_top, needs_tl,
# needs_tr (reference: vp9recon.c:71-97)
def _edges_arr():
    from ..codecs.vp9.golden import EDGES
    arr = np.zeros((15, 4), np.int32)
    for m, fl in EDGES.items():
        arr[m] = fl[:4]
    return arr


_EDGES_ARR = _edges_arr()


@lru_cache(maxsize=None)
def _const(name, device):
    """Host tables moved to a device once."""
    src = {
        "ftab": _FTAB,
        "edges": _EDGES_ARR,
        "bwh": np.asarray(T.BWH_TAB[1], np.int32),
        "itt": np.asarray(T.INTRA_TXFM_TYPE, np.int32),
    }[name]
    return torch.as_tensor(src, device=device)


@lru_cache(maxsize=None)
def _wall(sz, device):
    """[15, ne, sz*sz] float32 predictor matrices for every mode."""
    return torch.as_tensor(it.build_all(sz), dtype=torch.float32,
                           device=device)


def _iota(n, device):
    return torch.arange(n, dtype=torch.int32, device=device)


def _check_refs(s, recs):
    """Raise, as the reference does (vp9recon.c:661-669), when an inter
    block of the frame predicts from a reference of invalid dimensions
    (mvscale -1: more than twice the frame's size or under a sixteenth of
    it): recs, the frame's [N, 36] block records on the host. A frame
    whose invalid slot no block uses decodes."""
    bad = [k for k, sc in enumerate(getattr(s, "mvscale", ())) if sc[0] == -1]
    if not bad:
        return
    inter = (recs[:, 3] >= 0) & (recs[:, 6] == 0)
    uses = np.isin(recs[:, 15], bad) | ((recs[:, 14] != 0)
                                        & np.isin(recs[:, 16], bad))
    if (inter & uses).any():
        raise ValueError("reference frame has invalid dimensions")


# ---------------------------------------------------------------------------
# residual pass


def _round_residual(r, tx, bpp):
    """The final rounding of a pass-b output r (its dctcoef value): at 8
    bpp itxfm.round_residual; above, (int)(r + (1U << (bits - 1))) >>
    bits as the reference's itxfm wrapper computes it, in 32 bits (JAX's
    int32 pair path does the same; a numpy int64 rounding differs only
    within 2^(bits-1) of the int32 maximum)."""
    bits = itxfm.FINAL_SHIFT[tx] if tx < 4 else 0
    if bpp == 8 or bits == 0:
        return itxfm.round_residual(r, tx)
    return itxfm._wrap32(r + (1 << (bits - 1))) >> bits


def _residual_for_size(coef, eob4, txsz4, txtype4, tx, lossless, bpp):
    """Residual contribution of all tiles of size `tx` -> [H, W] int32
    (8 bpp: int32 arithmetic with the int16 wrap between passes; 10/12
    bpp: int64 (dctint) with the int32 wrap between passes)."""
    coef = coef.to(torch.int32 if bpp == 8 else torch.int64)
    sz = 4 << tx
    k = sz // 4
    H, W = coef.shape
    nth, ntw = H // sz, W // sz
    tiles = coef.reshape(nth, sz, ntw, sz).permute(0, 2, 1, 3)
    roots_eob = eob4[::k, ::k]
    roots_sz = txsz4[::k, ::k]
    roots_tp = txtype4[::k, ::k]
    active = roots_sz == tx

    if lossless:
        res = itxfm.itxfm_2d(XP, tiles, 4, 0, bpp)
    elif tx == 3:
        r = itxfm.itxfm_2d(XP, tiles, 3, 0, bpp)
        full = _round_residual(r, 3, bpp)
        dc = itxfm.dc_only_residual(tiles[..., 0, 0], tx)
        res = torch.where((roots_eob == 1)[..., None, None],
                          dc[..., None, None], full)
    else:
        # pass a (columns) both variants, select per tile
        use_adst_a = ((roots_tp == 1) | (roots_tp == 3))[..., None, None]
        use_adst_b = ((roots_tp == 2) | (roots_tp == 3))[..., None, None]
        blk_t = tiles.swapaxes(-1, -2)
        wrap = itxfm._wrap16 if bpp == 8 else itxfm._wrap32
        fa_d = itxfm._1D[(tx, "dct")]
        fa_a = itxfm._1D[(tx, "adst")]
        tmp = wrap(torch.where(use_adst_a, fa_a(XP, blk_t),
                               fa_d(XP, blk_t)))
        tmp_t = tmp.swapaxes(-1, -2)
        r = wrap(torch.where(use_adst_b, fa_a(XP, tmp_t),
                             fa_d(XP, tmp_t)))
        full = _round_residual(r.swapaxes(-1, -2), tx, bpp)
        dc = itxfm.dc_only_residual(tiles[..., 0, 0], tx)
        dc_ok = (roots_eob == 1) & (roots_tp == 0)
        res = torch.where(dc_ok[..., None, None], dc[..., None, None],
                          full)

    res = torch.where((active & (roots_eob > 0))[..., None, None], res,
                      torch.zeros((), dtype=res.dtype, device=res.device))
    return res.permute(0, 2, 1, 3).reshape(H, W).to(torch.int32)


def residual_plane_plain(coef, eob4, txsz4, txtype4, lossless, bpp):
    """The plain PyTorch residual of one plane: every size over the
    whole plane, summed."""
    if lossless:
        return _residual_for_size(coef, eob4, txsz4, txtype4, 0, True,
                                  bpp)
    out = torch.zeros(coef.shape, dtype=torch.int32, device=coef.device)
    for tx in range(4):
        out = out + _residual_for_size(coef, eob4, txsz4, txtype4, tx,
                                       False, bpp)
    return out


_GRID_DTYPES = (torch.int8, torch.int16, torch.int32)


def _consume_plain(coef, eob4, txsz4, txtype4, lossless):
    """What a consuming residual launch clears, on one plane, in place:
    every eob cell, and the coefficients of every transformed root that
    is not DC-only with the first 4-pixel quad of every DC-only one
    (csrc/itxfm.cu). Returns whether a nonzero eob cell is no root the
    residual transforms (a stray)."""
    e = eob4.to(torch.int64)
    t = txsz4.to(torch.int64)
    ty = txtype4.to(torch.int64)
    r4, c4 = e.shape
    dev = coef.device
    yy = torch.arange(r4, device=dev)[:, None]
    xx = torch.arange(c4, device=dev)[None, :]
    roots = torch.zeros((r4, c4), dtype=torch.bool, device=dev)
    full = torch.zeros_like(roots)
    dcq = torch.zeros((coef.shape[0], c4), dtype=torch.bool, device=dev)
    for tx in ((0,) if lossless else range(4)):
        k = 1 << tx
        root = ((t == tx) & (e > 0) & (yy % k == 0) & (xx % k == 0)
                & (yy + k <= r4) & (xx + k <= c4))
        dc = root & (e == 1) & ((ty == 0) | (tx == 3)) & (not lossless)
        roots |= root
        cover = (root & ~dc)[::k, ::k]
        full |= cover.repeat_interleave(k, 0).repeat_interleave(k, 1)[
            :r4, :c4]
        dcq[::4] |= dc
    mask = full.repeat_interleave(4, 0).repeat_interleave(4, 1) \
        | dcq.repeat_interleave(4, 1)
    coef.masked_fill_(mask, 0)
    stray = bool(((e != 0) & ~roots).any())
    eob4.zero_()
    return stray


def residual_planes(jobs, lossless, bpp, consume=None):
    """The residuals of a frame's planes: jobs [(coef, eob4, txsz4,
    txtype4)], each as residual_plane takes them -> an [H, W] int32
    residual a job. CPU tensors take residual_plane_plain, one call a
    plane; any other device the kernel (csrc/itxfm.cu, one launch for
    all the planes: residual_planes at 8 bpp, residual_planes_hbd at 10
    and 12), which takes CUDA tensors only. consume: None, or a
    CoefBuffers a job, whose buffers the job's coef and eob4 are views
    of; then the call also clears what it read (_consume_plain on the
    CPU), so the buffers read zero for the next scatter, and marks them
    consumed."""
    if not jobs:
        return []
    if consume is not None and len(consume) != len(jobs):
        raise ValueError(f"{len(consume)} buffer sets for {len(jobs)} planes")
    if jobs[0][0].device.type == "cpu":
        outs = [residual_plane_plain(*job, lossless, bpp) for job in jobs]
        if consume is not None:
            for job, bufs in zip(jobs, consume):
                if _consume_plain(*job, lossless):
                    bufs.strays[0] = 1
            for bufs in consume:
                bufs.consumed = True
        return outs
    if bpp not in (8, 10, 12):
        raise ValueError(f"bpp={bpp}")
    if len(jobs) > recon_cuda.RESIDUAL_MAX_PLANES:
        raise ValueError(f"{len(jobs)} planes, the kernel takes at most "
                         f"{recon_cuda.RESIDUAL_MAX_PLANES}")
    dev = jobs[0][0].device
    align = 4 if lossless else 32
    checked, outs = [], []
    for coef, eob4, txsz4, txtype4 in jobs:
        if coef.dim() != 2:
            raise ValueError(f"coef has shape {tuple(coef.shape)}, "
                             "expected [H, W]")
        H, W = coef.shape
        if H % align or W % align:
            raise ValueError(f"a {H}x{W} plane is not made of {align}x"
                             f"{align} regions")
        coef = check_tensor(coef, (torch.int16, torch.int32) if bpp == 8
                            else (torch.int32,), (H, W), dev, "coef")
        grids = [check_tensor(g, _GRID_DTYPES, (H // 4, W // 4), dev, name)
                 for g, name in ((eob4, "eob4"), (txsz4, "txsz4"),
                                 (txtype4, "txtype4"))]
        checked.append((coef, *grids))
        outs.append(torch.empty((H, W), dtype=torch.int32, device=dev))
    hbd = bpp > 8
    if consume is None:
        recon_cuda.residual(checked, outs, lossless, hbd=hbd)
        return outs
    for (coef, eob4, _t, _ty), job in zip(checked, jobs):
        if coef is not job[0] or eob4 is not job[1]:
            raise ValueError("a consuming residual clears its coef and eob4 "
                             "in place: they must be contiguous")
    recon_cuda.residual(checked, outs, lossless,
                        [bufs.strays for bufs in consume], hbd=hbd)
    for bufs in {id(b): b for b in consume}.values():
        bufs.consumed = True
        if bufs.done is not None:
            bufs.done.record()
    return outs


def residual_plane(coef, eob4, txsz4, txtype4, lossless, bpp):
    """The residual of one plane -> [H, W] int32. coef: [H, W] int16
    (8 bpp uploads narrow) or int32 (10/12 bpp: int32 only); eob4,
    txsz4, txtype4: [H/4, W/4] int8/int16/int32 grids. residual_planes of
    this one plane."""
    return residual_planes([(coef, eob4, txsz4, txtype4)], lossless,
                           bpp)[0]


# ---------------------------------------------------------------------------
# inter pass: per-4x4-cell MC


def _mc_cells(refstack, mv16, refsel, comp, filt, inter_mask, w, h, bpp,
              mvsx=1, mvsy=1, has_comp=True):
    """MC every 4x4 cell.

    refstack: [3, Hp, Wp] candidate ref planes (b.ref -> plane index).
    mv16: [r4, c4, 2, 2] int (1/16-pel in this plane's units).
    refsel: [r4, c4, 2] in 0..2; comp: [r4, c4] bool;
    filt: [r4, c4]; inter_mask: [r4, c4] bool (unused: non-inter cells
    are garbage and masked by the caller). has_comp=False skips the
    second reference pass (every comp cell is False then).
    Returns [r4*4, c4*4] int32 MC plane.
    """
    dev = refstack.device
    mv16 = mv16.to(torch.int32)
    # JAX clamps out-of-range gathers where torch raises: keep the plane
    # and table indices in range (only cells that are not inter carry
    # such values, and the apply masks those cells)
    refsel = refsel.long().clamp(0, 2)
    filt = filt.long().clamp(0, 3)
    r4, c4 = mv16.shape[:2]
    Hp, Wp = refstack.shape[1:]
    cy = (_iota(r4, dev) * 4)[:, None]
    cx = (_iota(c4, dev) * 4)[None, :]
    ftab = _const("ftab", dev)
    flat = refstack.reshape(-1)
    span = torch.arange(-3, 8, dtype=torch.int32, device=dev)
    maxp = (1 << bpp) - 1

    def one_ref(ri):
        mvx = mv16[:, :, ri, 0] * mvsx
        mvy = mv16[:, :, ri, 1] * mvsy
        iy = cy + (mvy >> 4)
        ix = cx + (mvx >> 4)
        mx = (mvx & 15).long()
        my = (mvy & 15).long()
        # gather 11x11 patches, coordinate-clamped to the visible area
        rows = (iy[..., None] + span).clamp(0, h - 1).long()
        cols = (ix[..., None] + span).clamp(0, w - 1).long()
        base = refsel[:, :, ri] * (Hp * Wp)
        idx = (base[..., None, None] + rows[..., :, None] * Wp
               + cols[..., None, :])
        patch = flat[idx]  # [r4, c4, 11, 11]
        tapsx = ftab[filt, mx]  # [r4, c4, 8]
        tapsy = ftab[filt, my]
        # h-pass -> [r4, c4, 11, 4]
        acc = torch.zeros(patch.shape[:2] + (11, 4), dtype=torch.int32,
                          device=dev)
        for k in range(8):
            acc = acc + tapsx[..., k, None, None] * patch[..., :, k:k + 4]
        tmp = ((acc + 64) >> 7).clamp(0, maxp)
        # v-pass -> [r4, c4, 4, 4]
        acc = torch.zeros(patch.shape[:2] + (4, 4), dtype=torch.int32,
                          device=dev)
        for k in range(8):
            acc = acc + tapsy[..., k, None, None] * tmp[..., k:k + 4, :]
        return ((acc + 64) >> 7).clamp(0, maxp)

    out = one_ref(0)
    if has_comp:
        p1 = one_ref(1)
        out = torch.where(comp.bool()[..., None, None], (out + p1 + 1) >> 1,
                          out)
    return out.permute(0, 2, 1, 3).reshape(r4 * 4, c4 * 4)


def mc_planes_plain(jobs, bpp, has_comp):
    """The plain inter pass of a frame's planes, _mc_cells and the apply
    per plane: jobs as mc_planes takes them -> per job the plane
    clip(mc + residual) on inter cells (inter4 repeated 4x4) and 0
    elsewhere."""
    maxp = (1 << bpp) - 1
    outs = []
    for residual, inter4, comp, filt, refsel, mv16, refs, w, h, mvsx, \
            mvsy in jobs:
        mc = _mc_cells(torch.stack(list(refs), dim=0), mv16, refsel, comp,
                       filt, inter4, w, h, bpp, mvsx, mvsy,
                       has_comp=has_comp)
        mh, mw = mc.shape
        mcfull = (mc + residual[:mh, :mw]).clamp(0, maxp)
        mask = inter4.bool().repeat_interleave(4, 0).repeat_interleave(4, 1)
        plane = torch.zeros(residual.shape, dtype=torch.int32,
                            device=residual.device)
        plane[:mh, :mw] = torch.where(mask, mcfull, plane[:mh, :mw])
        outs.append(plane)
    return outs


def mc_planes(jobs, bpp, has_comp):
    """The inter pass of a frame's planes -> an [H, W] int32 plane a job.
    jobs: [(residual [H, W] int32, inter4 [H/4, W/4] bool, comp bool,
    filt int32, refsel [H/4, W/4, 2] int32, mv16 [H/4, W/4, 2, 2] int32
    (1/16 pel, this plane's units before the mvsx/mvsy scale), refs (the
    three reference planes, [Hr, Wr] int32 each), w, h (the plane's
    visible size), mvsx, mvsy)]. has_comp=False (the frame has no
    compound block) leaves comp unread. CPU tensors take
    mc_planes_plain; any other device the kernel (csrc/mc.cu, one launch
    for all the planes), which takes CUDA tensors only: it reads the
    residual, the output and mv16 as 16-byte vectors and refsel as 8-byte
    pairs, so those must be aligned to them."""
    if not jobs:
        return []
    if jobs[0][0].device.type == "cpu":
        return mc_planes_plain(jobs, bpp, has_comp)
    if not 8 <= bpp <= 12:
        raise ValueError(f"bpp={bpp}")
    if len(jobs) > recon_cuda.MC_MAX_PLANES:
        raise ValueError(f"{len(jobs)} planes, the kernel takes at most "
                         f"{recon_cuda.MC_MAX_PLANES}")
    dev = jobs[0][0].device
    i32 = (torch.int32,)
    checked, outs = [], []
    for residual, inter4, comp, filt, refsel, mv16, refs, w, h, mvsx, \
            mvsy in jobs:
        if residual.dim() != 2 or residual.shape[0] % 4 \
                or residual.shape[1] % 4:
            raise ValueError(f"residual has shape {tuple(residual.shape)}, "
                             "expected [H, W] in 4x4 cells")
        H, W = residual.shape
        cells = (H // 4, W // 4)
        residual = check_tensor(residual, i32, (H, W), dev, "residual")
        inter4 = check_tensor(inter4, (torch.bool,), cells, dev, "inter4")
        comp = check_tensor(comp, (torch.bool,), cells, dev, "comp") \
            if has_comp else None
        filt = check_tensor(filt, i32, cells, dev, "filt")
        refsel = check_tensor(refsel, i32, cells + (2,), dev, "refsel")
        mv16 = check_tensor(mv16, i32, cells + (2, 2), dev, "mv16")
        if len(refs) != 3 or refs[0].dim() != 2:
            raise ValueError("expected three [Hr, Wr] reference planes")
        refs = tuple(check_tensor(r, i32, refs[0].shape, dev, f"ref{i}")
                     for i, r in enumerate(refs))
        Hr, Wr = refs[0].shape
        if not (1 <= w <= Wr and 1 <= h <= Hr) or mvsx not in (1, 2) \
                or mvsy not in (1, 2):
            raise ValueError(f"visible size {w}x{h} in {Wr}x{Hr} "
                             f"references, MV scale ({mvsx}, {mvsy})")
        out = torch.empty((H, W), dtype=torch.int32, device=dev)
        for t, name, size in ((residual, "residual", 16), (out, "out", 16),
                              (mv16, "mv16", 16), (refsel, "refsel", 8)):
            if t.data_ptr() % size:
                raise ValueError(f"{name} is not {size}-byte aligned")
        checked.append((residual, inter4, comp, filt, refsel, mv16, refs,
                        w, h, mvsx, mvsy))
        outs.append(out)
    recon_cuda.mc(checked, outs, bpp, has_comp)
    return outs


# ---------------------------------------------------------------------------
# inter pass with scaled references (dynamic resize): per-pixel stepping
#
# Reference: mc_luma_scaled / mc_chroma_scaled (vp9recon.c:492-628) and
# do_scaled_8tap_c / do_scaled_bilin_c (vp9dsp_template.c:2363-2500). In
# scaled mode every sub-8x8 block becomes four 4x4 quadrant calls, the MV
# is clamped against the parent block, and with subsampling the phase
# uses the libvpx-820 formula. A call's phase steps from its corner: in
# closed form total(k) = mx0 + k * step, offset(k) = total >> 4, phase
# total & 15, so every 4x4 cell is computed from its call anchor alone.
# A cell gathers a 16x16 source patch: a step is at most 32 (2x down), so
# a cell spans at most 6 source pixels and 8 taps.


def _mulshift14(a, b):
    """Exact (a * b) >> 14, as the reference's int64 cast computes it
    (vp9recon.c:508): int64 tensors."""
    return (a.to(torch.int64) * b) >> 14


def _patches(refs, dims, sel, top, left):
    """The 16x16 source patch of every cell: refs, three int32 planes of
    their own shapes, and dims, their visible (w, h); sel [r4, c4] each
    cell's slot; top, left [r4, c4] its patch's first row and column ->
    (the planes as one flat tensor, [r4, c4, 16, 16] indices into it),
    each row and column clamped to the slot's visible area."""
    dev = sel.device
    flat = torch.cat([r.reshape(-1) for r in refs])
    sizes = [r.numel() for r in refs]
    base = torch.as_tensor([0, sizes[0], sizes[0] + sizes[1]],
                           dtype=torch.int64, device=dev)[sel]
    stride = torch.as_tensor([r.shape[1] for r in refs], dtype=torch.int64,
                             device=dev)[sel]
    dims_t = torch.as_tensor(dims, dtype=torch.int64, device=dev)
    w, h = dims_t[sel, 0], dims_t[sel, 1]
    s16 = torch.arange(16, device=dev)
    rows_i = torch.minimum((top[..., None] + s16).clamp_min(0),
                           h[..., None] - 1)
    cols_i = torch.minimum((left[..., None] + s16).clamp_min(0),
                           w[..., None] - 1)
    return flat, (base[..., None, None] + rows_i[..., :, None]
                  * stride[..., None, None] + cols_i[..., None, :])


def _scaled_anchors_plain(recs, r4, c4, ss_x, ss_y, bidx=None):
    """The scaled call structure of one plane of subsampling (ss_x, ss_y)
    (0, 0 for luma), the counterpart of the JAX package's
    _scaled_anchor_grids: recs [N, 36] block records (the last row a pad
    row), r4, c4 the luma cell grid -> (ay, ax, by, bx, pw, ph), each
    [r4 >> ss_y, c4 >> ss_x] int64: the cell's call anchor, its parent
    block's corner and its span, in this plane's pixels. Cell (i, j)
    takes the record of luma cell (i << ss_y, j << ss_x); a sub-8x8 block
    is four 4x4 quadrant calls, split only along an axis that is not
    subsampled. bidx: the [r4, c4] record index when the caller has it."""
    dev = recs.device
    recs = recs.to(torch.int64)
    if bidx is None:
        bidx = _record_index_plain(recs.to(torch.int32), r4, c4)
    b = bidx[::1 << ss_y, ::1 << ss_x][:r4 >> ss_y, :c4 >> ss_x]
    row, col, bs = recs[b, 0], recs[b, 1], recs[b, 3]
    sub8 = bs > 9
    bwh = _const("bwh", dev).to(torch.int64)
    bsc = bs.clamp(0, 12)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    by, bx = (row * 8) >> ss_y, (col * 8) >> ss_x
    ii = torch.arange(b.shape[0], device=dev)[:, None]
    jj = torch.arange(b.shape[1], device=dev)[None, :]
    ay = by + (torch.where(sub8, ((ii - row * 2) & 1) * 4, zero)
               if not ss_y else 0)
    ax = bx + (torch.where(sub8, ((jj - col * 2) & 1) * 4, zero)
               if not ss_x else 0)
    pw = (bwh[bsc, 0] * 8) >> ss_x
    ph = (bwh[bsc, 1] * 8) >> ss_y
    return ay, ax, by, bx, pw, ph


def _mc_patch_pass(flat, idx, tapsx, tapsy, relx, rely, bpp):
    """The two 8-tap passes of every cell over its patch: flat[idx] [r4,
    c4, 16, 16] source pixels, tapsx / tapsy [r4, c4, 4, 8] each pixel
    column's and row's taps, relx / rely [r4, c4, 4] each one's first
    patch column and row -> [r4, c4, 4, 4], each pass rounded and
    clipped."""
    patch = flat[idx]
    maxp = (1 << bpp) - 1
    r4, c4 = patch.shape[:2]
    acc = torch.zeros((r4, c4, 16, 4), dtype=torch.int32, device=flat.device)
    for k in range(8):
        ck = (relx + k).clamp(0, 15)[:, :, None, :].expand(r4, c4, 16, 4)
        acc = acc + tapsx[:, :, None, :, k] * patch.gather(3, ck)
    tmp = ((acc + 64) >> 7).clamp(0, maxp)
    acc = torch.zeros((r4, c4, 4, 4), dtype=torch.int32, device=flat.device)
    for t in range(8):
        rk = (rely + t).clamp(0, 15)[:, :, :, None].expand(r4, c4, 4, 4)
        acc = acc + tapsy[:, :, :, t, None] * tmp.gather(2, rk)
    return ((acc + 64) >> 7).clamp(0, maxp)


def _mc_ref_scaled(refs, dims, mvraw, refsel, filt, anchors, scales, steps,
                   cols, rows, bpp, ri, ss_x, ss_y):
    """Scaled MC of one reference direction -> [r4, c4, 4, 4] int32, the
    counterpart of the JAX package's _mc_ref_scaled. refs: three int32
    planes of their own shapes; dims: their visible (w, h); mvraw [r4,
    c4, 2, 2] this plane's raw 1/8-pel MVs; refsel [r4, c4, 2] in 0-2;
    filt [r4, c4] in 0-3; anchors: _scaled_anchors_plain's six grids;
    scales, steps: [3, 2] int64 per-slot 14-bit factors and 1/16-pel
    steps; cols, rows: the frame's 8x8 block columns and rows."""
    dev = mvraw.device
    ay, ax, by, bx, pw, ph = anchors
    r4, c4 = refsel.shape[:2]
    ftab = _const("ftab", dev)
    sel = refsel[:, :, ri].long()
    scx, scy = scales[sel, 0], scales[sel, 1]
    stx, sty = steps[sel, 0], steps[sel, 1]
    mvx = mvraw[:, :, ri, 0].to(torch.int64)
    mvy = mvraw[:, :, ri, 1].to(torch.int64)

    # the MV clamp against the parent block (vp9recon.c:505-506 luma,
    # :574-589 chroma)
    def clamp(mv, b0, span, n8, ss):
        if ss:
            return torch.minimum(torch.maximum(mv, -(b0 + span + 4) * 16),
                                 (n8 * 4 - b0 + 3) * 16)
        return torch.minimum(torch.maximum(mv, -(b0 + span + 4) * 8),
                             (n8 * 8 - b0 + 3) * 8)

    mvx = clamp(mvx, bx, pw, cols, ss_x)
    mvy = clamp(mvy, by, ph, rows, ss_y)

    # the scaled start position and phase (14-bit fixed point, libvpx's
    # rounding; with subsampling the libvpx-820 formula)
    def start(mv, a0, sc, ss):
        if ss:
            return (_mulshift14(mv, sc) + (((a0 * sc) >> 10) & ~15)
                    + (((a0 * sc) >> 9) & 15))
        return _mulshift14(mv * 2, sc) + ((a0 * sc) >> 10)

    tx0 = start(mvx, ax, scx, ss_x)
    ty0 = start(mvy, ay, scy, ss_y)
    # each pixel's position from the call's corner, in closed form
    j4 = torch.arange(4, device=dev)
    kx = (torch.arange(c4, device=dev) * 4)[None, :, None] + j4 - ax[..., None]
    ky = (torch.arange(r4, device=dev) * 4)[:, None, None] + j4 - ay[..., None]
    txk = (tx0 & 15)[..., None] + kx * stx[..., None]
    tyk = (ty0 & 15)[..., None] + ky * sty[..., None]
    offx = (tx0 >> 4)[..., None] + (txk >> 4)
    offy = (ty0 >> 4)[..., None] + (tyk >> 4)

    flat, idx = _patches(refs, dims, sel, offy[..., 0] - 3, offx[..., 0] - 3)
    fl = filt.long()[..., None]
    return _mc_patch_pass(flat, idx, ftab[fl, (txk & 15)],
                          ftab[fl, (tyk & 15)], offx - offx[..., :1],
                          offy - offy[..., :1], bpp)


def _mc_one_ref_unscaled(refs, dims, mvraw, refsel, filt, bpp, ri, mvsx,
                         mvsy):
    """One reference direction of _mc_cells with each slot's own plane
    and visible size (the JAX package's _mc_one_ref_unscaled) -> [r4, c4,
    4, 4] int32; arguments as _mc_ref_scaled's, mvsx / mvsy the MV
    scale to 1/16 pel."""
    dev = mvraw.device
    r4, c4 = refsel.shape[:2]
    ftab = _const("ftab", dev)
    sel = refsel[:, :, ri].long()
    mvx = mvraw[:, :, ri, 0].to(torch.int64) * mvsx
    mvy = mvraw[:, :, ri, 1].to(torch.int64) * mvsy
    ix = (torch.arange(c4, device=dev) * 4)[None, :] + (mvx >> 4)
    iy = (torch.arange(r4, device=dev) * 4)[:, None] + (mvy >> 4)
    flat, idx = _patches(refs, dims, sel, iy - 3, ix - 3)
    fl = filt.long()
    taps_x = ftab[fl, (mvx & 15)][:, :, None, :].expand(r4, c4, 4, 8)
    taps_y = ftab[fl, (mvy & 15)][:, :, None, :].expand(r4, c4, 4, 8)
    j4 = torch.arange(4, device=dev).expand(r4, c4, 4)
    return _mc_patch_pass(flat, idx, taps_x, taps_y, j4, j4, bpp)


def _mc_cells_mixed(refs, dims, mvraw, refsel, comp, filt, anchors, scales,
                    steps, cols, rows, bpp, ss_x, ss_y, has_comp=True):
    """MC every cell of a frame with scaled references (the JAX package's
    _mc_cells_mixed): per cell and reference, a same-size slot (scale 0)
    takes the unscaled path and a resized one the scaled path, then the
    compound average -> [r4 * 4, c4 * 4] int32. refsel and filt are
    clamped to their ranges (cells that are not inter carry any values);
    has_comp=False skips the second reference."""
    refsel = refsel.long().clamp(0, 2)
    filt = filt.long().clamp(0, 3)
    r4, c4 = refsel.shape[:2]
    scale_nz = scales[:, 0] != 0
    mvs = (2 >> ss_x, 2 >> ss_y)

    def one_ref(ri):
        un = _mc_one_ref_unscaled(refs, dims, mvraw, refsel, filt, bpp, ri,
                                  *mvs)
        sc = _mc_ref_scaled(refs, dims, mvraw, refsel, filt, anchors,
                            scales, steps, cols, rows, bpp, ri, ss_x, ss_y)
        return torch.where(scale_nz[refsel[:, :, ri]][..., None, None], sc,
                           un)

    out = one_ref(0)
    if has_comp:
        out = torch.where(comp.bool()[..., None, None],
                          (out + one_ref(1) + 1) >> 1, out)
    return out.permute(0, 2, 1, 3).reshape(r4 * 4, c4 * 4)


def _luma_cells(jobs):
    """The luma cell grid (r4, c4) of mc_planes_scaled's jobs."""
    residual, *_rest, ss_x, ss_y = jobs[0]
    return (residual.shape[0] // 4) << ss_y, (residual.shape[1] // 4) << ss_x


def mc_planes_scaled_plain(jobs, bpp, has_comp, recs, scales, steps, cols,
                           rows):
    """The plain inter pass of a frame with scaled references, the
    anchors, _mc_cells_mixed and the apply per plane: arguments as
    mc_planes_scaled takes them (index is not needed) -> per job the
    plane clip(mc + residual) on inter cells and 0 elsewhere."""
    dev = jobs[0][0].device
    maxp = (1 << bpp) - 1
    scales = torch.as_tensor(scales, dtype=torch.int64, device=dev)
    steps = torch.as_tensor(steps, dtype=torch.int64, device=dev)
    recs = recs.to(torch.int32)
    r4, c4 = _luma_cells(jobs)
    bidx = _record_index_plain(recs, r4, c4)
    outs = []
    for residual, inter4, comp, filt, refsel, mvraw, refs, dims, ss_x, \
            ss_y in jobs:
        anchors = _scaled_anchors_plain(recs, r4, c4, ss_x, ss_y, bidx)
        mc = _mc_cells_mixed(refs, dims, mvraw, refsel, comp, filt, anchors,
                             scales, steps, cols, rows, bpp, ss_x, ss_y,
                             has_comp)
        mcfull = (mc + residual).clamp(0, maxp)
        mask = inter4.bool().repeat_interleave(4, 0).repeat_interleave(4, 1)
        outs.append(torch.where(mask, mcfull, torch.zeros_like(mcfull)))
    return outs


def mc_planes_scaled(jobs, bpp, has_comp, recs, scales, steps, cols, rows,
                     index=None, paths=None):
    """The inter pass of a frame's planes when a reference has another
    size than the frame -> an [H, W] int32 plane a job. jobs: [(residual
    [H, W] int32, inter4 [H/4, W/4] bool, comp bool, filt int32, refsel
    [H/4, W/4, 2] int32, mvraw [H/4, W/4, 2, 2] int32 (the splat's MV
    grid: 1/8 pel of luma), refs (the three reference planes, int32, each
    of its own shape [Hr, Wr]), dims (each slot's visible (w, h)), ss_x,
    ss_y (the plane's subsampling: 0, 0 for luma))]. Frame: recs [N, 36]
    int16 block records (the last row a pad row) from which the grids
    were splatted; scales, steps: [3][2] per-slot 14-bit scale factors
    (0 for a slot of the frame's size) and 1/16-pel steps; cols, rows:
    the frame's 8x8 block columns and rows; index: on a card, the
    recon_cuda.SplatState of the splat that made the grids, read at its
    current epoch (the cells' records); paths: on a card, None or an int64
    [2] tensor there, to which the kernel's warps add their tile passes
    (a reference of a 16x16 tile that some cell uses) on the window path
    ([0]) and on the walk ([1]). has_comp=False leaves comp
    unread. CPU tensors take mc_planes_scaled_plain; any other device the
    kernel (csrc/mc.cu mc_planes_scaled, one launch for all the planes),
    which takes CUDA tensors only: it reads the residual, the output and
    mvraw as 16-byte vectors and refsel as 8-byte pairs, so those must be
    aligned to them. A slot of another size steps 1-32 a pixel (the
    decoder refuses a frame whose blocks use one beyond; an unused one
    may step anywhere)."""
    if not jobs:
        return []
    if jobs[0][0].device.type == "cpu":
        return mc_planes_scaled_plain(jobs, bpp, has_comp, recs, scales,
                                      steps, cols, rows)
    if not 8 <= bpp <= 12:
        raise ValueError(f"bpp={bpp}")
    if len(jobs) > recon_cuda.MC_MAX_PLANES:
        raise ValueError(f"{len(jobs)} planes, the kernel takes at most "
                         f"{recon_cuda.MC_MAX_PLANES}")
    dev = jobs[0][0].device
    r4, c4 = _luma_cells(jobs)
    if index is None or index.bidx.device != dev or index.epoch < 1 \
            or index.bidx.numel() != ((r4 + 1) // 2) * ((c4 + 1) // 2):
        raise ValueError("the kernel reads the cells' records from the "
                         f"splat's index state of the {r4}x{c4} cell grid, "
                         "after the splat of this frame")
    if recs.dim() != 2 or recs.shape[0] < 1:
        raise ValueError(f"recs has shape {tuple(recs.shape)}")
    recs = check_tensor(recs, (torch.int16,), (recs.shape[0], 36), dev,
                        "recs")
    if np.shape(scales) != (3, 2) or np.shape(steps) != (3, 2):
        raise ValueError("scales and steps are [3][2]")
    i32 = (torch.int32,)
    checked, outs = [], []
    for residual, inter4, comp, filt, refsel, mvraw, refs, dims, ss_x, \
            ss_y in jobs:
        if residual.dim() != 2 or residual.shape[0] % 4 \
                or residual.shape[1] % 4:
            raise ValueError(f"residual has shape {tuple(residual.shape)}, "
                             "expected [H, W] in 4x4 cells")
        H, W = residual.shape
        cells = (H // 4, W // 4)
        if ss_x not in (0, 1) or ss_y not in (0, 1) \
                or (cells[0] << ss_y, cells[1] << ss_x) != (r4, c4):
            raise ValueError(f"an {H}x{W} plane of subsampling ({ss_x}, "
                             f"{ss_y}) in a {r4}x{c4} cell grid")
        residual = check_tensor(residual, i32, (H, W), dev, "residual")
        inter4 = check_tensor(inter4, (torch.bool,), cells, dev, "inter4")
        comp = check_tensor(comp, (torch.bool,), cells, dev, "comp") \
            if has_comp else None
        filt = check_tensor(filt, i32, cells, dev, "filt")
        refsel = check_tensor(refsel, i32, cells + (2,), dev, "refsel")
        mvraw = check_tensor(mvraw, i32, cells + (2, 2), dev, "mvraw")
        if len(refs) != 3 or len(dims) != 3:
            raise ValueError("expected three reference planes and sizes")
        refs = tuple(check_tensor(r, i32, r.shape, dev, f"ref{i}")
                     for i, r in enumerate(refs))
        for r, (w, h) in zip(refs, dims):
            if r.dim() != 2 or not (1 <= w <= r.shape[1]
                                    and 1 <= h <= r.shape[0]):
                raise ValueError(f"visible size {w}x{h} in a reference of "
                                 f"shape {tuple(r.shape)}")
        out = torch.empty((H, W), dtype=torch.int32, device=dev)
        for t, name, size in ((residual, "residual", 16), (out, "out", 16),
                              (mvraw, "mvraw", 16), (refsel, "refsel", 8)):
            if t.data_ptr() % size:
                raise ValueError(f"{name} is not {size}-byte aligned")
        checked.append((residual, inter4, comp, filt, refsel, mvraw, refs,
                        tuple(dims), ss_x, ss_y))
        outs.append(out)
    if paths is not None:
        paths = check_tensor(paths, (torch.int64,), (2,), dev, "paths")
    recon_cuda.mc_scaled(checked, outs, bpp, has_comp, recs, index, scales,
                         steps, cols, rows, paths)
    return outs


# ---------------------------------------------------------------------------
# intra wavefront


def _build_intra_schedule(s, plane_idx):
    """Host: per-tx-block entries with dependency levels.

    Returns list of levels; each level is a dict sz -> list of entries
    (py, px, mode_final, have_top, have_left, have_right, n_have_top,
    n_have_left).
    """
    from ..codecs.vp9.golden import MODE_CONV
    h = s.header
    ss_h = h.ss_h if plane_idx else 0
    ss_v = h.ss_v if plane_idx else 0
    plane_shape = s.cur_frame_obj.planes[plane_idx].shape
    Wp = plane_shape[1]
    r4 = plane_shape[0] // 4
    c4 = Wp // 4
    LW = np.zeros((r4 + 8, c4 + 8), np.int32)
    levels = []

    recs = getattr(s, "block_records", None)
    if recs is not None:
        # native pass A: filter intra blocks in numpy, skip Block objects
        intra_iter = (
            (int(r[0]), int(r[1]), int(r[2]), int(r[3]), int(r[7]),
             int(r[8]),
             (int(r[9]), int(r[10]), int(r[11]), int(r[12])), int(r[13]))
            for r in recs[recs[:, 6] != 0])
    else:
        intra_iter = ((row, col, tcs, b.bs, b.tx, b.uvtx, b.mode,
                       b.uvmode)
                      for row, col, tcs, b in s.blocks if b.intra)
    for row, col, tcs, bbs, btx, buvtx, bmode, buvmode in intra_iter:
        if plane_idx == 0:
            w4 = int(T.BWH_TAB[1, bbs, 0]) << 1
            h4 = int(T.BWH_TAB[1, bbs, 1]) << 1
            end_x = min(2 * (s.cols - col), w4)
            end_y = min(2 * (s.rows - row), h4)
            tx = btx
        else:
            w4 = (int(T.BWH_TAB[1, bbs, 0]) << 1) >> ss_h
            h4 = (int(T.BWH_TAB[1, bbs, 1]) << 1) >> ss_v
            end_x = min(2 * (s.cols - col), int(T.BWH_TAB[1, bbs, 0]) << 1
                        ) >> ss_h
            end_y = min(2 * (s.rows - row), int(T.BWH_TAB[1, bbs, 1]) << 1
                        ) >> ss_v
            tx = buvtx
        step = 1 << tx
        sz = 4 << tx
        for y in range(0, end_y, step):
            for x in range(0, end_x, step):
                if plane_idx == 0:
                    mode = bmode[y * 2 + x if (bbs > 9 and tx == 0)
                                 else 0]
                    py = row * 8 + y * 4
                    px = col * 8 + x * 4
                    have_top = row > 0 or y > 0
                    have_left = col > tcs or x > 0
                    have_right = x < w4 - 1
                    n_have_top = ((s.cols - col) * 2 - x) * 4
                    n_have_left = ((s.rows - row) * 2 - y) * 4
                else:
                    mode = buvmode
                    py = ((row * 8) >> ss_v) + y * 4
                    px = ((col * 8) >> ss_h) + x * 4
                    have_top = row > 0 or y > 0
                    have_left = col > tcs or x > 0
                    have_right = x < w4 - 1
                    n_have_top = (((s.cols - col) << (0 if ss_h else 1))
                                  - x) * 4
                    n_have_left = (((s.rows - row) << (0 if ss_v else 1))
                                   - y) * 4
                m = MODE_CONV[mode][1 if have_left else 0][
                    1 if have_top else 0]
                # dependency level from read cells
                cy0, cx0 = py // 4, px // 4
                k = sz // 4
                lvl = 0
                if have_top:
                    lvl = max(lvl, LW[cy0 - 1 if cy0 else 0,
                                      max(cx0 - 1, 0):cx0 + 2 * k].max()
                              if cy0 else 0)
                if have_left and cx0:
                    lvl = max(lvl, LW[cy0:cy0 + k, cx0 - 1].max())
                lvl += 1
                LW[cy0:cy0 + k, cx0:cx0 + k] = lvl
                while len(levels) < lvl:
                    levels.append({})
                levels[lvl - 1].setdefault(sz, []).append(
                    (py, px, m, int(have_top), int(have_left),
                     int(have_right), n_have_top, n_have_left))
    return levels


def _intra_flat_native(s, plane_idx):
    """The native scheduler's flat (entries, (level, sz) keys) output,
    or None when unavailable."""
    if getattr(s, "use_native", False) \
            and getattr(s, "block_records", None) is not None:
        from ..passa_native import intra_schedule_native
        plane_shape = s.cur_frame_obj.planes[plane_idx].shape
        r4 = plane_shape[0] // 4
        c4 = plane_shape[1] // 4
        return intra_schedule_native(s, plane_idx, r4, c4)
    return None


def _build_intra_schedule_fast(s, plane_idx):
    """Native (C) schedule build when block records exist; same levels
    structure as _build_intra_schedule (entries grouped by dependency
    level then size — blocks within a level are independent, so the
    size order within a level is free)."""
    res = _intra_flat_native(s, plane_idx)
    if res is None:
        return _build_intra_schedule(s, plane_idx)
    ents, keys = res
    if not len(ents):
        return []
    order = np.lexsort((keys[:, 1], keys[:, 0]))
    ents = ents[order]
    keys = keys[order]
    change = np.empty(len(keys), bool)
    change[0] = True
    change[1:] = (keys[1:] != keys[:-1]).any(axis=1)
    starts = np.nonzero(change)[0]
    ends = np.append(starts[1:], len(keys))
    levels = []
    for a, b in zip(starts, ends):
        lvl, sz = int(keys[a, 0]), int(keys[a, 1])
        while len(levels) < lvl:
            levels.append({})
        levels[lvl - 1][sz] = ents[a:b]
    return levels


def _edge_spec_dev(ent, sz, Wp, bpp):
    """Device edge-vector gather spec from compact entries.

    ent: [N, 8] int32 (py, px, m, have_top, have_left, have_right,
    n_have_top, n_have_left). Returns (idx [N, ne] int32, cmask bool,
    cval int32) implementing check_intra_mode's edge assembly
    (reference: vp9recon.c:98-217)."""
    dev = ent.device
    ent = ent.to(torch.int32)
    py, px, m, ht, hl, hr, nht, nhl = (ent[:, i][:, None]
                                       for i in range(8))
    base = 128 << (bpp - 8)
    ta = 2 * sz if sz == 4 else sz
    ne = it.edge_len(sz)
    ED = _const("edges", dev)
    msel = m.clamp(0, 14).long()[:, 0]
    needs_left = (ED[msel, 0] != 0)[:, None]
    needs_top = (ED[msel, 1] != 0)[:, None]
    needs_tl = (ED[msel, 2] != 0)[:, None]
    needs_tr = (ED[msel, 3] != 0)[:, None]
    ht = ht != 0
    hl = hl != 0
    hr = hr != 0

    def i32(v):
        return torch.as_tensor(v, dtype=torch.int32, device=dev)

    j = _iota(ne, dev)[None, :]
    N = ent.shape[0]
    idx = torch.zeros((N, ne), dtype=torch.int32, device=dev)
    cmask = torch.ones((N, ne), dtype=torch.bool, device=dev)
    cval = torch.zeros((N, ne), dtype=torch.int32, device=dev)
    false = torch.zeros((), dtype=torch.bool, device=dev)

    # top entries 1..ta (the first sz are real pixels clamped by
    # n_have_top; for sz==4 entries 5..8 are the top-right zone)
    i = j - 1
    in_main = (j >= 1) & (i < sz)
    src = torch.minimum(i, nht - 1)
    top_idx = (py - 1) * Wp + px + src
    sel = needs_top & ht & in_main
    idx = torch.where(sel, top_idx, idx)
    cmask = torch.where(sel, false, cmask)
    if sz == 4:
        in_tr = (j >= 5) & (j <= 8)
        tr_real = hr & (nht >= sz + 4)
        idx4 = (py - 1) * Wp + px + (nht - 1).clamp(max=3)  # entry 4
        tr_idx = torch.where(tr_real, (py - 1) * Wp + px + 4 + (j - 5),
                             idx4)
        sel = needs_top & ht & needs_tr & in_tr
        idx = torch.where(sel, tr_idx, idx)
        cmask = torch.where(sel, false, cmask)
    in_top = (j >= 1) & (j <= ta)
    sel = needs_top & ~ht & in_top
    cval = torch.where(sel, i32(base - 1), cval)
    # topleft entry 0
    is0 = j == 0
    sel = needs_tl & hl & ht & is0
    idx = torch.where(sel, (py - 1) * Wp + px - 1, idx)
    cmask = torch.where(sel, false, cmask)
    sel = needs_tl & ~(hl & ht) & is0
    cval = torch.where(sel, torch.where(ht, i32(base + 1), i32(base - 1)),
                       cval)
    # left entries off..off+sz-1 (canonical bottom-up; shortage rows
    # replicate the oldest available row)
    off = 1 + ta
    r = j - off
    in_left = (r >= 0) & (r < sz)
    npx = nhl.clamp(max=sz)
    i_eff = torch.where(r >= sz - npx, sz - 1 - r, npx - 1)
    left_idx = (py + i_eff) * Wp + px - 1
    sel = needs_left & hl & in_left
    idx = torch.where(sel, left_idx, idx)
    cmask = torch.where(sel, false, cmask)
    sel = needs_left & ~hl & in_left
    cval = torch.where(sel, i32(base + 1), cval)
    # constants
    cval = torch.where(j == off + sz, i32(base), cval)
    cval = torch.where(j == off + sz + 1, i32(1), cval)
    idx = torch.where(cmask, i32(0), idx)
    return idx, cmask, cval


def _intra_batch_apply(ext, d, sz, bpp):
    """Predict + residual-add + scatter one batch of same-size tx blocks
    into `ext` (a flat plane plus its dump slot), in place.
    d: eidx/emask/econst [N, ne] (edge gather spec), modes and is_tm
    [N], res [N, sz*sz] (the blocks' residual) and dest [N, sz*sz]
    (flat destinations; inert rows point at the dump slot)."""
    maxp = (1 << bpp) - 1
    e = torch.where(d["emask"], d["econst"], ext[d["eidx"]])
    Wsel = _wall(sz, ext.device)[d["modes"]]  # [N, ne, P]
    pred = torch.floor((torch.bmm(e.to(torch.float32)[:, None, :],
                                  Wsel)[:, 0] + 32) / 64)
    pred = pred.to(torch.int32).reshape(-1, sz, sz)
    # TM special: clip(top[x] + left[sz-1-y] - tl)
    ta = 2 * sz if sz == 4 else sz
    tl = e[:, 0][:, None, None]
    top = e[:, 1:1 + sz][:, None, :]
    left = e[:, 1 + ta:1 + ta + sz].flip(1)[:, :, None]
    tm = (top + left - tl).clamp(0, maxp)
    pred = torch.where(d["is_tm"][:, None, None], tm, pred)
    out = (pred.reshape(len(pred), -1) + d["res"]).clamp(0, maxp)
    ext[d["dest"]] = out


def _intra_scan_plain(plane, residual, packed, L, sizes, caps, bpp):
    """The whole intra wavefront of one plane: a Python loop over the
    dependency levels.

    packed is laid out as per-size slabs of L levels x cap rows each:
    rows for size sizes[s] of level i live at
    [L*sum(caps[:s]) + i*caps[s], caps[s]). Rows are [py, px, m,
    have_top, have_left, have_right, n_have_top, n_have_left] int16;
    unused slots hold inert rows (out-of-plane py/px). Everything that
    does not depend on the plane's pixels (edge specs, residual gathers,
    destinations) is computed once for the whole slab; a level then
    costs one edge gather, one batched product and one scatter per
    size. `plane` is not modified; the result is a new tensor."""
    dev = plane.device
    H, W = plane.shape
    HW = H * W
    # the plane plus one dump slot that inert rows scatter into (JAX
    # drops those writes; torch would raise on the index)
    ext = torch.empty(HW + 1, dtype=torch.int32, device=dev)
    ext[:HW] = plane.reshape(-1)
    ext[HW] = 0
    res_flat = residual.reshape(-1).to(torch.int32)
    slabs = []
    base = 0
    for sz, cap in zip(sizes, caps):
        rows = packed[base:base + L * cap].to(torch.int32)
        eidx, emask, econst = _edge_spec_dev(rows, sz, W, bpp)
        modes = rows[:, 2].long()
        ar = torch.arange(sz, device=dev)
        rr = rows[:, 0].long()[:, None, None] + ar[None, :, None]
        cc = rows[:, 1].long()[:, None, None] + ar[None, None, :]
        inside = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
        src = rr.clamp(0, H - 1) * W + cc.clamp(0, W - 1)
        slabs.append((sz, cap, {
            "eidx": eidx.clamp(0, HW - 1).long(), "emask": emask,
            "econst": econst, "modes": modes, "is_tm": modes == 9,
            "dest": torch.where(inside, rr * W + cc, HW).reshape(
                L * cap, -1),
            "res": res_flat[src.reshape(L * cap, -1)]}))
        base += L * cap
    for i in range(L):
        for sz, cap, d in slabs:
            level = {k: v[i * cap:(i + 1) * cap] for k, v in d.items()}
            _intra_batch_apply(ext, level, sz, bpp)
    return ext[:HW].view(H, W)


def _intra_scan_planes(jobs, bpp):
    """The intra wavefronts of a frame's planes: jobs [(plane, residual,
    packed, L, sizes, caps)], each in the slab layout of
    _intra_scan_plain -> a new [H, W] int32 plane per job; no plane is
    modified. CPU tensors take _intra_scan_plain, one call per plane; any
    other device the kernel (csrc/intra.cu: one launch for all the
    planes, side by side, on copies), which takes CUDA tensors only."""
    if not jobs:
        return []
    if jobs[0][0].device.type == "cpu":
        return [_intra_scan_plain(*job, bpp) for job in jobs]
    if not 8 <= bpp <= 12:
        raise ValueError(f"bpp={bpp}")
    if len(jobs) > recon_cuda.INTRA_MAX_PLANES:
        raise ValueError(f"{len(jobs)} planes, the kernel takes at most "
                         f"{recon_cuda.INTRA_MAX_PLANES}")
    dev = jobs[0][0].device
    i32 = (torch.int32,)
    checked = []
    for plane, residual, packed, L, sizes, caps in jobs:
        if len(sizes) != len(caps) or not sizes or len(set(sizes)) != len(
                sizes) or not set(sizes) <= set(recon_cuda.INTRA_SIZES) \
                or min(caps) < 1 or L < 1:
            raise ValueError(f"slab sections sizes={sizes} caps={caps} "
                             f"L={L}")
        if plane.dim() != 2:
            raise ValueError(f"plane has shape {tuple(plane.shape)}, "
                             "expected [H, W]")
        H, W = plane.shape
        residual = check_tensor(residual, i32, (H, W), dev, "residual")
        if packed.dim() != 2 or packed.shape[0] < L * sum(caps):
            raise ValueError(f"slab has shape {tuple(packed.shape)}, "
                             f"expected [>= {L * sum(caps)}, 8]")
        packed = check_tensor(packed, (torch.int16,), (packed.shape[0], 8),
                              dev, "slab")
        out = check_tensor(plane, i32, (H, W), dev, "plane").clone()
        checked.append((out, residual, packed, L, sizes, caps))
    recon_cuda.intra(checked, bpp, _const("edges", dev))
    return [job[0] for job in checked]


def _intra_scan(plane, residual, packed, L, sizes, caps, bpp):
    """_intra_scan_planes for one plane -> its new [H, W] int32 plane."""
    return _intra_scan_planes([(plane, residual, packed, L, sizes, caps)],
                              bpp)[0]


def _pad_to_bucket(n, base=8, mult=4):
    """Coarse shape buckets (the JAX package bounds its compile variety
    with them; here they keep the slab layout identical)."""
    b = base
    while b < n:
        b *= mult
    return b


def pack_intra_slab_flat(ents, keys, Hp, Wp):
    """Vectorized slab pack straight from the native scheduler's flat
    (entries [n, 8], keys [n, 2] = (level, sz)) output. Produces
    byte-identical slabs to pack_intra_slab on the same schedule —
    within a (level, size) group both keep the native emission order —
    but without the per-level dict walk."""
    if not len(ents):
        return None
    # sort by (sz, level); np.lexsort is stable so within-group order
    # (the native emission order) is preserved
    order = np.lexsort((keys[:, 0], keys[:, 1]))
    e = ents[order]
    lvls = keys[order, 0].astype(np.int64)
    szs = keys[order, 1]
    L = int(lvls.max())
    sizes = tuple(int(v) for v in np.unique(szs))
    caps = []
    for sz in sizes:
        cnt = np.bincount(lvls[szs == sz], minlength=L + 1)[1:]
        caps.append(_pad_to_bucket(int(cnt.max()), base=8, mult=2))
    caps = tuple(caps)
    tot = _pad_to_bucket(L * sum(caps), base=64, mult=2)
    buf = np.zeros((tot, 8), np.int16)
    buf[:, 0] = Hp + 64
    buf[:, 1] = Wp + 64
    buf[:, 2] = 2  # DC
    buf[:, 6:8] = 1
    dest = np.empty(len(e), np.int64)
    base = 0
    pos = 0
    for sz, cap in zip(sizes, caps):
        m = szs == sz
        lv = lvls[m]
        n = int(m.sum())
        idx = np.arange(n)
        change = np.empty(n, bool)
        change[0] = True
        change[1:] = lv[1:] != lv[:-1]
        gstart = np.maximum.accumulate(np.where(change, idx, 0))
        dest[pos:pos + n] = base + (lv - 1) * cap + (idx - gstart)
        pos += n
        base += L * cap
    buf[dest] = e
    return buf, L, sizes, caps


def pack_intra_slab(levels, Hp, Wp):
    """Host-side half of the intra wavefront: pack the dependency
    levels into one [tot, 8] int16 slab (per-size [L, cap] sections).
    Pure function of the schedule, so the precompute worker thread runs
    it off the critical path; U and V share one slab (same schedule).
    Returns (buf, L, sizes, caps) or None when the plane has no intra
    blocks."""
    L = len(levels)
    maxn = {}
    for lvl in levels:
        for sz, entries in lvl.items():
            n = len(entries)
            if n:
                maxn[sz] = max(maxn.get(sz, 0), n)
    if not maxn:
        return None
    sizes = tuple(sorted(maxn))
    caps = tuple(_pad_to_bucket(maxn[sz], base=8, mult=2)
                 for sz in sizes)
    tot = _pad_to_bucket(L * sum(caps), base=64, mult=2)
    buf = np.zeros((tot, 8), np.int16)
    # inert rows: out-of-plane py/px (scatter-dumped), consts-only
    # edges (no gathers), valid clamp inputs
    buf[:, 0] = Hp + 64
    buf[:, 1] = Wp + 64
    buf[:, 2] = 2  # DC
    buf[:, 6:8] = 1
    base = 0
    for sz, cap in zip(sizes, caps):
        for i, lvl in enumerate(levels):
            entries = lvl.get(sz)
            if entries is not None and len(entries):
                o = base + i * cap
                buf[o:o + len(entries)] = entries
        base += L * cap
    return buf, L, sizes, caps


def run_intra(s, planes, residuals):
    """The intra wavefronts of a frame's three planes, one
    _intra_scan_planes call (V takes U's slab: the same schedule) ->
    the three planes; one without intra blocks passes unchanged."""
    pre = s.pre
    jobs, which = [], []
    for plane_idx, (plane, residual) in enumerate(zip(planes, residuals)):
        k = min(plane_idx, 1)
        slab = pre["slabs"][k]
        if slab is None:
            continue
        buf, L, sizes, caps = slab
        jobs.append((plane, residual, pre["dev"]["slabs"][k], L, sizes,
                     caps))
        which.append(plane_idx)
        metrics.add("intra.nrows", buf.shape[0])
        metrics.add("intra.levels", L)
    out = list(planes)
    if not jobs:
        return out
    metrics.add("intra.ncalls", 1)
    with metrics.timer("intra.level_dispatch"):
        for plane_idx, plane in zip(which,
                                    _intra_scan_planes(jobs, s.header.bpp)):
            out[plane_idx] = plane
    return out


# ---------------------------------------------------------------------------
# device-side metadata splat
#
# The compact per-block records from pass A (~72 B/block, one block per
# leaf) ship, and the dense grids are rebuilt on the device: a scatter
# assigns each cell its covering record index (leaves never overlap),
# then every grid is a gather of record fields. This mirrors the host
# splat in decoder.record_block / native vp9_entropy_main.h:90-165
# exactly, including the sub-8x8 chroma MV averaging rules and the
# libvpx 4:2:2 bug (vp9_mc_template.c:107-114).


def _rdiv2(s):
    """ROUNDED_DIV(a+b, 2) with C round-half-away-from-zero (torch `//`
    floors, as jnp's does)."""
    return torch.where(s >= 0, (s + 1) // 2, -((-s + 1) // 2))


def _rdiv4(s):
    return torch.where(s >= 0, (s + 2) // 4, -((-s + 2) // 4))


def _record_index_plain(recs, r4, c4):
    """The record of every cell of an [r4, c4] grid: recs [N, 36] int32
    block records (the last row a pad row) -> [r4, c4] int64, the highest
    record index that covers the cell, or N - 1 (a pad row) where none
    does."""
    dev = recs.device
    N = recs.shape[0]
    row, col, bs = recs[:, 0], recs[:, 1], recs[:, 3]
    valid = bs >= 0
    bwh = _const("bwh", dev)  # [13, 2] 8px units
    bsc = bs.clamp(0, 12).long()
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    w4 = torch.where(valid, bwh[bsc, 0] * 2, zero)   # cells (4px units)
    h4 = torch.where(valid, bwh[bsc, 1] * 2, zero)
    r0, c0 = row * 2, col * 2

    # scatter-max of the record index over the cells each record
    # covers; off-grid and pad cells go to a dump slot (JAX: mode=drop)
    dy = _iota(16, dev)
    rr = r0[:, None, None] + dy[None, :, None]
    cc = c0[:, None, None] + dy[None, None, :]
    inb = ((dy[None, :, None] < h4[:, None, None])
           & (dy[None, None, :] < w4[:, None, None])
           & (rr < r4) & (cc < c4))
    dest = torch.where(inb, rr * c4 + cc, r4 * c4).reshape(-1).long()
    n = _iota(N, dev)
    bidx = torch.full((r4 * c4 + 1,), -1, dtype=torch.int32, device=dev)
    bidx.scatter_reduce_(0, dest, n[:, None, None].expand(N, 16, 16)
                         .reshape(-1), reduce="amax", include_self=True)
    bidx = bidx[:r4 * c4].view(r4, c4)
    # uncovered cells read recs[-1], a pad row (bs == -1), as JAX's
    # negative-index wraparound does
    return torch.where(bidx < 0, bidx + N, bidx).long()


def _grids_from_records_plain(recs, r4, c4, ss_h, ss_v):
    """recs: [N, 36] int16 block records (pad rows have bs == -1; the
    LAST row must always be a pad row). Returns the dense per-cell grids
    for the Y plane ([r4, c4]) and the chroma planes ([r4u, c4u])."""
    dev = recs.device
    recs = recs.to(torch.int32)
    bs = recs[:, 3]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    bidx = _record_index_plain(recs, r4, c4)

    def g(f, b=bidx):
        return recs[b, f]

    covered = g(3) >= 0
    intra = (g(6) != 0) & covered
    inter4 = (g(6) == 0) & covered
    txsz4 = g(7)
    # per-cell quadrant (sub-8x8 leaves are exactly 2x2 cells)
    celldy = (_iota(r4, dev)[:, None] - g(0) * 2) & 1
    celldx = (_iota(c4, dev)[None, :] - g(1) * 2) & 1
    q = celldy * 2 + celldx
    sub8 = g(3) > 9
    q_eff = torch.where(sub8 & (txsz4 == 0), q, zero)
    mode_cell = recs[bidx, (9 + q_eff).long()]
    itt = _const("itt", dev)
    txtype4 = torch.where(intra, itt[mode_cell.clamp(0, 13).long()], zero)
    comp4 = (g(14) != 0) & inter4
    filter4 = g(17)
    refsel = torch.stack([g(15).clamp(0, 2),
                          torch.where(comp4, g(16), zero).clamp(0, 2)], -1)
    # luma MV per cell: quadrant for sub-8x8, else mv[0]
    qmv = torch.where(sub8, q, zero).long()
    mv16 = torch.stack([
        torch.stack([recs[bidx, 18 + qmv * 4], recs[bidx, 19 + qmv * 4]],
                    -1),
        torch.stack([recs[bidx, 20 + qmv * 4], recs[bidx, 21 + qmv * 4]],
                    -1),
    ], -2)  # [r4, c4, 2(ref), 2(xy)]

    # ---- chroma ----
    sv, sh = 1 << ss_v, 1 << ss_h
    bidx_uv = bidx[::sv, ::sh]
    uvtx4 = recs[bidx_uv, 8]
    inter4uv = (recs[bidx_uv, 6] == 0) & (recs[bidx_uv, 3] >= 0)
    comp_uv = (recs[bidx_uv, 14] != 0) & inter4uv
    filt_uv = recs[bidx_uv, 17]
    refsel_uv = torch.stack([
        recs[bidx_uv, 15].clamp(0, 2),
        torch.where(comp_uv, recs[bidx_uv, 16], zero).clamp(0, 2)], -1)

    # per-record 2x2 uv-cell MV table V[N, dy, dx, ref, xy], replicating
    # decoder._splat_sub8x8_mv (reference: vp9_mc_template.c:24-230)
    m = [[torch.stack([recs[:, 18 + qq * 4 + ri * 2],
                       recs[:, 19 + qq * 4 + ri * 2]], -1)
          for ri in range(2)] for qq in range(4)]  # m[q][ri] -> [N, 2]
    where = torch.where

    def per_ref(ri):
        m0, m1, m2, m3 = m[0][ri], m[1][ri], m[2][ri], m[3][ri]
        a02 = _rdiv2(m0 + m2)
        a01 = _rdiv2(m0 + m1)
        a13 = _rdiv2(m1 + m3)
        a12 = _rdiv2(m1 + m2)
        a0123 = _rdiv4(m0 + m1 + m2 + m3)
        bsr = bs[:, None]
        # defaults (bs <= 9): every uv cell uses mv[0]
        if ss_v:
            top_l = where(bsr == 10, a02,
                          where(bsr == 11, a01 if ss_h else m0,
                                where(bsr == 12, a0123 if ss_h else a02,
                                      m0)))
            top_r = where(bsr == 10, a02,
                          where(bsr == 11, m1,
                                where(bsr == 12, a13, m0)))
            V = [[top_l, top_r], [top_l, top_r]]
        elif ss_h:
            # 4:2:2: BS_4x4 bottom uses avg(mv1, mv2) (libvpx bug)
            tl = where(bsr == 10, m0,
                       where(bsr == 11, a01, where(bsr == 12, a01, m0)))
            bl = where(bsr == 10, a02,
                       where(bsr == 11, a01, where(bsr == 12, a12, m0)))
            V = [[tl, tl], [bl, bl]]
        else:
            tl = m0
            tr = where(bsr == 11, m1, where(bsr == 12, m1, m0))
            bl = where(bsr == 10, m2, where(bsr == 12, m2, m0))
            br = where(bsr == 10, m2,
                       where(bsr == 11, m1, where(bsr == 12, m3, m0)))
            V = [[tl, tr], [bl, br]]
        return torch.stack([torch.stack(Vr, 0) for Vr in V], 0)

    Vt = torch.stack([per_ref(0), per_ref(1)], -2)  # [2, 2, N, 2, 2]
    r4u, c4u = r4 >> ss_v, c4 >> ss_h
    ur0 = (recs[bidx_uv, 0] * 2) >> ss_v
    uc0 = (recs[bidx_uv, 1] * 2) >> ss_h
    udy = (_iota(r4u, dev)[:, None] - ur0).clamp(0, 1).long()
    udx = (_iota(c4u, dev)[None, :] - uc0).clamp(0, 1).long()
    uvmv = Vt[udy, udx, bidx_uv]  # [r4u, c4u, 2, 2]

    return (inter4, txsz4, txtype4, comp4, filter4, refsel, mv16,
            inter4uv, uvtx4, torch.zeros_like(uvtx4), comp_uv, filt_uv,
            refsel_uv, uvmv)


def _grids_from_records(recs, r4, c4, ss_h, ss_v, states=None):
    """The 14 per-cell grids of a frame's block records recs [N, 36]
    (the last row a pad row): Y [r4, c4], chroma [r4 >> ss_v, c4 >>
    ss_h]. CPU tensors take _grids_from_records_plain; any other device
    the kernel (csrc/splat.cu, one call), which takes int16 CUDA records
    only, on the index state of the caller's store `states` (a decoder's
    splat_states: recon_cuda.SplatState, kept per device and geometry,
    one stream only), or on a fresh one of this call when states is
    None. Both give the same shapes and dtypes."""
    if recs.device.type == "cpu":
        return _grids_from_records_plain(recs, r4, c4, ss_h, ss_v)
    if recs.dim() != 2 or recs.shape[0] < 1:
        raise ValueError(f"recs has shape {tuple(recs.shape)}, expected "
                         "[N >= 1, 36]")
    if ss_h not in (0, 1) or ss_v not in (0, 1) or r4 < 1 or c4 < 1 \
            or r4 % (1 << ss_v) or c4 % (1 << ss_h):
        raise ValueError(f"a {r4}x{c4} cell grid under subsampling "
                         f"({ss_h}, {ss_v})")
    recs = check_tensor(recs, (torch.int16,), (recs.shape[0], 36),
                        recs.device, "recs")
    return recon_cuda.splat(recs, r4, c4, ss_h, ss_v, states)


def _records_from_blocks(s):
    """Synthesize the native record array from Python Block objects
    (pure-Python pass A path)."""
    n = len(s.blocks)
    recs = np.zeros((n, 36), np.int16)
    for i, (row, col, tcs, b) in enumerate(s.blocks):
        r = recs[i]
        r[0], r[1], r[2] = row, col, tcs
        r[3], r[4], r[5] = b.bs, b.seg_id, b.skip
        r[6], r[7], r[8] = b.intra, b.tx, b.uvtx
        r[9:13] = b.mode
        r[13], r[14] = b.uvmode, b.comp
        r[15], r[16], r[17] = b.ref[0], b.ref[1], b.filter
        for qq in range(4):
            r[18 + qq * 4] = b.mv[qq][0][0]
            r[19 + qq * 4] = b.mv[qq][0][1]
            r[20 + qq * 4] = b.mv[qq][1][0]
            r[21 + qq * 4] = b.mv[qq][1][1]
    return recs


def _pack_records(s):
    """Bucket-padded record array (pad rows have bs=-1; at least one)."""
    recs = s.block_records
    if recs is None:
        recs = _records_from_blocks(s)
    n = len(recs)
    nb = _pad_to_bucket(n + 1, base=256, mult=2)
    out = np.zeros((nb, 36), np.int16)
    out[:n] = recs[:, :36]
    out[n:, 3] = -1
    return out


# ---------------------------------------------------------------------------
# coefficient pairs


def _scatter_pairs16(pv, H, W):
    """Rebuild a dense int16 [H, W] array from (pos-hi, pos-lo, value)
    int16 triples (pad rows have pos-hi < 0 -> dump slot)."""
    pos = ((pv[:, 0].to(torch.int32) << 16)
           | (pv[:, 1].to(torch.int32) & 0xffff))
    n = H * W
    pos = torch.where((pos >= 0) & (pos < n), pos, n).long()
    out = torch.zeros((n + 1,), dtype=torch.int16, device=pv.device)
    out[pos] = pv[:, 2].to(torch.int16)
    return out[:n].view(H, W)


def _scatter_pairs32(pv, H, W):
    """Wide variant for 10/12-bit dctcoefs (int32 values shipped as hi/lo
    int16 halves): rows are (pos-hi, pos-lo, val-hi, val-lo)."""
    pos = ((pv[:, 0].to(torch.int32) << 16)
           | (pv[:, 1].to(torch.int32) & 0xffff))
    n = H * W
    pos = torch.where((pos >= 0) & (pos < n), pos, n).long()
    val = ((pv[:, 2].to(torch.int32) << 16)
           | (pv[:, 3].to(torch.int32) & 0xffff))
    out = torch.zeros((n + 1,), dtype=torch.int32, device=pv.device)
    out[pos] = val
    return out[:n].view(H, W)


def scatter_coef(cp, ep, nc, ne):
    """The dense coefficients [nc] and eob cells [ne] of pair rows: cp
    [N, 3] int16 rows (pos-hi, pos-lo, value) -> int16 coefficients, or
    [N, 4] rows (pos-hi, pos-lo, value-hi, value-lo) -> int32; ep [M, 3]
    int16 rows -> int16 eob cells. A row with a negative position (a pad
    row) or one past the end is dropped; every other position is 0. The
    counterpart of the JAX package's _scatter_pairs16/_scatter_pairs32,
    into fresh buffers; recon_frame scatters into kept ones with
    scatter_frame. CPU tensors take _scatter_pairs16/_scatter_pairs32;
    any other device the kernel (csrc/itxfm.cu: a memset pair and one
    launch), which takes CUDA tensors only."""
    wide = cp.dim() == 2 and cp.shape[1] == 4
    if cp.device.type == "cpu":
        scat = _scatter_pairs32 if wide else _scatter_pairs16
        return scat(cp, 1, nc)[0], _scatter_pairs16(ep, 1, ne)[0]
    if not (0 < nc < 1 << 31 and 0 < ne < 1 << 31):
        raise ValueError(f"buffers of {nc} and {ne} entries")
    if cp.dim() != 2 or ep.dim() != 2:
        raise ValueError("pair rows are [N, 3 or 4] and [M, 3]")
    dev = cp.device
    cp = check_tensor(cp, (torch.int16,), (cp.shape[0], 4 if wide else 3),
                      dev, "cp")
    ep = check_tensor(ep, (torch.int16,), (ep.shape[0], 3), dev, "ep")
    flat_c = torch.empty(nc, dtype=torch.int32 if wide else torch.int16,
                         device=dev)
    flat_e = torch.empty(ne, dtype=torch.int16, device=dev)
    recon_cuda.scatter(cp, ep, flat_c, flat_e)
    return flat_c, flat_e


# zero-fills of kept coefficient buffers before a scatter, by cause: the
# last scatter into them was not consumed (a frame raised between its
# scatter and its residual), or the consuming residual found a stray
COEF_FILLS = {"unconsumed": 0, "stray": 0}


class CoefBuffers:
    """The dense coefficient and eob buffers that one scatter slot of
    recon_frame keeps from frame to frame on one device for one decoder
    (coef_buffers: the decoder's coef_bufs holds them): zero when made,
    and zero again after each consuming residual_planes, so that the next
    scatter needs no memset. consumed: whether the last scatter into
    them was consumed; strays: an int32 flag that the consuming residual
    sets where a nonzero eob cell was no root it transformed (in pinned
    host memory on a card, which the kernel writes); done: on a card, an
    event after the consuming residual, which the next scatter waits for
    before it reads the flag. The kernels update the buffers in stream
    order, so one set serves one stream only."""

    def __init__(self, dev, nc, ne, wide):
        self.flat_c = torch.zeros(
            nc, dtype=torch.int32 if wide else torch.int16, device=dev)
        self.flat_e = torch.zeros(ne, dtype=torch.int16, device=dev)
        cuda = dev.type == "cuda"
        self.strays = torch.zeros(1, dtype=torch.int32, pin_memory=cuda)
        self.done = torch.cuda.Event() if cuda else None
        self.consumed = True

    def fill_cause(self):
        """Why the buffers may hold a nonzero ("unconsumed", "stray"), or
        None when they read zero."""
        if not self.consumed:
            return "unconsumed"
        if self.done is not None:
            self.done.synchronize()
        return "stray" if int(self.strays[0]) else None

    def read_zero(self):
        """Whether both buffers read zero (a check; it synchronises)."""
        return not (bool(self.flat_c.any()) or bool(self.flat_e.any()))


def coef_buffers(store, dev, slot, nc, ne, wide):
    """The CoefBuffers of (device, slot, lengths, width) in `store` (a
    dict: a decoder's coef_bufs, which its FrameJobs carry), made at
    first use. recon_frame's slots: "merged" for the merged pair rows,
    0-2 for the per-plane rows of the pure-Python pass A (U and V have
    one geometry, so the slot tells them apart)."""
    dev = torch.device(dev)
    key = (dev, slot, nc, ne, bool(wide))
    bufs = store.get(key)
    if bufs is None:
        bufs = store[key] = CoefBuffers(dev, nc, ne, wide)
    return bufs


def scatter_frame(bufs, cp, ep):
    """The pair rows cp, ep (as scatter_coef takes them) scattered into
    the kept buffers bufs (a CoefBuffers of their width and lengths),
    which a consuming residual_planes must read before the next call.
    Where the buffers may hold a nonzero (bufs.fill_cause()), they are
    zero-filled first and COEF_FILLS counts it. CPU tensors take
    scatter_coef's plain version, copied into the buffers; any other
    device the kernel (csrc/itxfm.cu: one
    launch, with a memset pair before it only for a fill), which takes
    CUDA tensors only. Returns (flat_c, flat_e)."""
    wide = cp.dim() == 2 and cp.shape[1] == 4
    if (bufs.flat_c.dtype == torch.int32) != wide:
        raise ValueError("pair rows of another width than the buffers")
    cause = bufs.fill_cause()
    if cause:
        COEF_FILLS[cause] += 1
        bufs.strays[0] = 0
    if cp.device.type == "cpu":
        flat_c, flat_e = scatter_coef(cp, ep, bufs.flat_c.numel(),
                                      bufs.flat_e.numel())
        bufs.flat_c.copy_(flat_c)
        bufs.flat_e.copy_(flat_e)
    else:
        dev = cp.device
        if cp.dim() != 2 or ep.dim() != 2:
            raise ValueError("pair rows are [N, 3 or 4] and [M, 3]")
        cp = check_tensor(cp, (torch.int16,),
                          (cp.shape[0], 4 if wide else 3), dev, "cp")
        ep = check_tensor(ep, (torch.int16,), (ep.shape[0], 3), dev, "ep")
        if bufs.flat_c.device != dev:
            raise ValueError(f"buffers on {bufs.flat_c.device}, rows on "
                             f"{dev}")
        recon_cuda.scatter(cp, ep, bufs.flat_c, bufs.flat_e,
                           zero_fill=bool(cause))
    bufs.consumed = False
    return bufs.flat_c, bufs.flat_e


def _fill_pairs(out, pos, val, n):
    out[:n, 0] = pos >> 16
    out[:n, 1] = pos & 0xffff
    if out.shape[1] == 4:
        out[:n, 2] = val >> 16
        out[:n, 3] = val & 0xffff
    else:
        out[:n, 2] = val


def _merged_from_pairs(s):
    """Build the merged (cp, ep, geoms) upload from the pair rows the
    native pass A emitted during the coefficient decode itself (Ctx
    emit_pairs mode): no dense-plane walk at all — just pad the rows
    into the coarse shape buckets."""
    pairs = getattr(s, "coef_pairs", None)
    if pairs is None:
        return None
    cp_src, ep_src = pairs
    nc, ne = len(cp_src), len(ep_src)
    # np.empty + tail-only -1 fill: rows past the terminator go to the
    # dump slot (pos<0), their value lanes are dead
    cp = np.empty((_pad_to_bucket(nc + 1, base=1024, mult=2),
                   cp_src.shape[1]), np.int16)
    ep = np.empty((_pad_to_bucket(ne + 1, base=256, mult=2), 3),
                  np.int16)
    cp[nc:, 0] = -1
    ep[ne:, 0] = -1
    cp[:nc] = cp_src
    ep[:ne] = ep_src
    ys, us = s.coef_y.size, s.coef_u.size
    ey, eu = s.eob_y.size, s.eob_u.size
    geoms = [(s.coef_y.shape, s.eob_y.shape, 0, 0),
             (s.coef_u.shape, s.eob_u.shape, ys, ey),
             (s.coef_v.shape, s.eob_v.shape, ys + us, ey + eu)]
    return cp, ep, geoms


def _pack_coef_merged(s, wide):
    """Pack all three planes' nonzero coefficients (and eob cells) into
    ONE position-offset pair buffer each: a single upload and a single
    scatter rebuild every plane. Positions are offset by each plane's
    flat base; returns (cp, ep, geoms) or None without native pass A."""
    from ..passa_native import count_pairs_native, pack_pairs_native
    planes = [(s.coef_y, s.eob_y, s.txsz4),
              (s.coef_u, s.eob_u, s.uvtx4),
              (s.coef_v, s.eob_v, s.uvtx4)]
    cc = getattr(s, "coef_counts", None)
    if cc is None:
        cc = []
        for coef, eob4, txg in planes:
            c = count_pairs_native(coef, eob4, txg)
            if c is None:
                return None
            cc.append(c)
    ncols = 4 if wide else 3
    nc_tot = sum(c[0] for c in cc)
    ne_tot = sum(c[1] for c in cc)
    cp = np.zeros((_pad_to_bucket(nc_tot + 1, base=1024, mult=2), ncols),
                  np.int16)
    ep = np.zeros((_pad_to_bucket(ne_tot + 1, base=256, mult=2), 3),
                  np.int16)
    cp[:, 0] = -1
    ep[:, 0] = -1
    cbase = ebase = 0
    co = eo = 0
    geoms = []
    for (coef, eob4, txg), (nc, ne) in zip(planes, cc):
        pack_pairs_native(coef, eob4, txg, cp[co:co + nc],
                          ep[eo:eo + ne], cbase, ebase)
        geoms.append((coef.shape, eob4.shape, cbase, ebase))
        co += nc
        eo += ne
        cbase += coef.size
        ebase += eob4.size
    return cp, ep, geoms


def _slice_plane(flat_c, flat_e, bc, be, H, W, r4, c4):
    """Carve a plane's dense coef + eob grids out of the merged flat
    scatters."""
    return (flat_c[0, bc:bc + H * W].reshape(H, W),
            flat_e[0, be:be + r4 * c4].reshape(r4, c4))


def _pack_coef_host(coef, eob4, txg, wide=False, counts=None):
    """Pack the plane's nonzero dequantized coefficients and the eob
    grid as (position, value) int16 triples. The walk is eob-driven
    (only coded tx blocks' areas are read), so stale pooled-buffer
    content is never shipped."""
    H, W = coef.shape
    ncols = 4 if wide else 3
    from ..passa_native import count_pairs_native, pack_pairs_native
    if counts is None:
        counts = count_pairs_native(coef, eob4, txg)
    if counts is not None:
        nc, ne = counts
        cp = np.zeros((_pad_to_bucket(nc + 1, base=1024, mult=2), ncols),
                      np.int16)
        ep = np.zeros((_pad_to_bucket(ne + 1, base=256, mult=2), 3),
                      np.int16)
        cp[:, 0] = -1
        ep[:, 0] = -1
        pack_pairs_native(coef, eob4, txg, cp, ep)
        return cp, ep
    # pure-Python pass A writes fresh zeroed buffers: every nonzero in
    # the plane is a coded coefficient
    py, px = np.nonzero(coef)
    pos = (py * W + px).astype(np.int64)
    val = coef[py, px]
    nc = len(pos)
    cp = np.zeros((_pad_to_bucket(nc + 1, base=1024, mult=2), ncols),
                  np.int16)
    cp[:, 0] = -1
    _fill_pairs(cp, pos, val, nc)
    er, ec = np.nonzero(eob4)
    epos = (er * eob4.shape[1] + ec).astype(np.int64)
    ne = len(epos)
    ep = np.zeros((_pad_to_bucket(ne + 1, base=256, mult=2), 3),
                  np.int16)
    ep[:, 0] = -1
    _fill_pairs(ep, epos, eob4[er, ec], ne)
    return cp, ep


# ---------------------------------------------------------------------------
# host precompute, upload, frame orchestration


def precompute_host(s):
    """Pass-B host-only products, computed at the end of pass A so the
    pipelined decode overlaps them with the previous frame's pass B:
    the intra wavefront slabs and the sparse coefficient (pos, value)
    packing. Results land in s.pre; recon_frame uses them."""
    h = s.header
    pre = {"levels": [None, None], "pairs": [None] * 3,
           "pairs_merged": None, "slabs": [None, None]}
    # slab straight from the native flat schedule when available
    Hy, Wy = s.sb_rows * 64, s.sb_cols * 64
    dims = ((Hy, Wy), (Hy >> h.ss_v, Wy >> h.ss_h))
    done_fast = False
    if getattr(s, "use_native", False) \
            and getattr(s, "block_records", None) is not None:
        with metrics.timer("recon.intra_pack"):
            flats = [_intra_flat_native(s, i) for i in (0, 1)]
            if all(f is not None for f in flats):
                for i in (0, 1):
                    ents, keys = flats[i]
                    pre["slabs"][i] = pack_intra_slab_flat(
                        ents, keys, *dims[i])
                    pre["levels"][i] = [] if pre["slabs"][i] is None \
                        else None
                done_fast = True
    if not done_fast:
        with metrics.timer("recon.intra_sched"):
            pre["levels"][0] = _build_intra_schedule_fast(s, 0)
            pre["levels"][1] = _build_intra_schedule_fast(s, 1)
        with metrics.timer("recon.intra_pack"):
            # U and V share one slab (identical schedule, diff.
            # residuals)
            pre["slabs"][0] = pack_intra_slab(pre["levels"][0],
                                              *dims[0])
            pre["slabs"][1] = pack_intra_slab(pre["levels"][1],
                                              *dims[1])
    with metrics.timer("recon.coef_pack"):
        merged = _merged_from_pairs(s)
        if merged is None and getattr(s, "use_native", False):
            merged = _pack_coef_merged(s, wide=h.bpp > 8)
        if merged is not None:
            pre["pairs_merged"] = merged
        else:
            for plane_idx in range(3):
                coef = (s.coef_y, s.coef_u, s.coef_v)[plane_idx]
                eob4 = (s.eob_y, s.eob_u, s.eob_v)[plane_idx]
                txg = s.txsz4 if plane_idx == 0 else s.uvtx4
                pre["pairs"][plane_idx] = _pack_coef_host(
                    coef, eob4, txg, wide=h.bpp > 8)
    if h.filter_level:
        _pack_lf(s, pre)
    with metrics.timer("recon.recs_pack"):
        pre["recs"] = _pack_records(s)
    # merge every upload into one flat buffer (one copy per frame)
    with metrics.timer("recon.flat_pack"):
        pre["flat"] = _pack_flat_upload(pre)
    s.pre = pre


def _pack_lf(s, pre):
    """Loop-filter part of the host precompute: the plane-set flags
    and, when either is set, the level/mask/LUT buffers that
    lpf_masks.grids_device takes."""
    with metrics.timer("recon.lf_flags"):
        pre["lf_masks"] = lpf_masks.lf_flags(s)
        if pre["lf_masks"][0] or pre["lf_masks"][1]:
            pre["lf_bufs"] = lpf_masks.lf_buffers(s)


def _lf_views(pre):
    """The lf_bufs arrays that go up with the frame, by upload name."""
    lfm = pre.get("lf_masks")
    if lfm is None or not (lfm[0] or lfm[1]):
        return {}
    return dict(zip(("lfl", "lfm", "lfluts"), pre["lf_bufs"]))


def _pack_flat_upload(pre):
    """Concatenate every pass-B input array into ONE flat int16 host
    buffer + slicing spec: one host-to-device copy per frame. int32
    arrays ride as little-endian int16 pairs at an even offset and are
    viewed back as int32 on the device."""
    parts, spec = [], {}
    off = 0

    def add(name, arr):
        nonlocal off
        if arr.dtype == np.int32:
            if off % 2:
                parts.append(np.zeros(1, np.int16))
                off += 1
            spec[name] = (off, arr.shape, np.int32)
            flat = arr.reshape(-1).view(np.int16)
        else:
            spec[name] = (off, arr.shape, None)
            flat = arr.reshape(-1)
        parts.append(flat)
        off += flat.size

    add("recs", pre["recs"])
    merged = pre.get("pairs_merged")
    if merged is None:
        return None  # pure-python pairs path keeps per-array uploads
    cp_m, ep_m, _geoms = merged
    add("cp", cp_m)
    add("ep", ep_m)
    for i in (0, 1):
        sl = pre["slabs"][i]
        if sl is not None:
            add("slab%d" % i, sl[0])
    for name, arr in _lf_views(pre).items():
        add(name, arr)
    return np.concatenate(parts), spec


def upload_job(s):
    """Copy the frame's pass-B inputs to its device. The copy is
    synchronous on the default stream and reads only this frame's
    freshly packed buffers. Device handles land in s.pre["dev"]."""
    pre = getattr(s, "pre", None)
    if pre is None or "dev" in pre:
        return
    device = s.device
    dev = {}
    flat = pre.get("flat")
    if flat is not None:
        buf, spec = flat
        with metrics.timer("upload.flat"):
            fdev = torch.from_numpy(buf).to(device)
        views = {}
        for name, (off, shape, wide) in spec.items():
            n = int(np.prod(shape))
            if wide is np.int32:
                views[name] = fdev[off:off + 2 * n].view(torch.int32) \
                    .view(shape)
            else:
                views[name] = fdev[off:off + n].view(shape)
        dev["recs"] = views["recs"]
        dev["cp"] = views["cp"]
        dev["ep"] = views["ep"]
        dev["slabs"] = [views.get("slab0"), views.get("slab1")]
        for name in _lf_views(pre):
            dev[name] = views[name]
    else:
        with metrics.timer("upload.arrays"):
            dev["recs"] = torch.from_numpy(pre["recs"]).to(device)
            dev["pairs"] = [
                (torch.from_numpy(p[0]).to(device),
                 torch.from_numpy(p[1]).to(device))
                for p in pre["pairs"]]
            dev["slabs"] = [torch.from_numpy(sl[0]).to(device)
                            if sl is not None else None
                            for sl in pre["slabs"]]
            for name, arr in _lf_views(pre).items():
                dev[name] = torch.from_numpy(arr).to(device)
    pre["dev"] = dev


def _loop_filter(s, outs, dev):
    """The loop filter on the device: dense parameter grids from the
    uploaded levels and masks, then the wavefront filter on Y and U+V,
    in place on the planes this frame has just reconstructed (one
    lf_frame_ call). Returns them, filtered."""
    h = s.header
    y_any, uv_any = s.pre["lf_masks"][:2]
    if not (y_any or uv_any):
        return outs
    with metrics.timer("recon.lf_grids"):
        Vy, Hy, Vu, Hu = lpf_masks.grids_device(
            dev["lfl"], dev["lfm"], dev["lfluts"], s.sb_rows, s.sb_cols,
            h.ss_h, h.ss_v)
    with metrics.timer("recon.lf"):
        lpf_dense.lf_frame_(*outs, Vy, Hy, Vu, Hu, s.sb_rows, s.sb_cols,
                            h.ss_h, h.ss_v, h.bpp, bool(y_any),
                            bool(uv_any), schedules=s.lf_schedules)
    return outs


def scatter_planes(s):
    """The pair rows of an uploaded frame (s: a FrameJob) scattered into
    the kept buffers of its decoder (s.coef_bufs, scatter_frame): the
    merged rows into one set, or each plane's rows into a set of its
    own. Returns ([(coef, eob4)] views a plane, [CoefBuffers] a plane)
    for the consuming residual_planes."""
    dev = s.pre["dev"]
    merged = s.pre.get("pairs_merged")
    if merged is not None:
        _cp, _ep, geoms_m = merged
        Lc = sum(sh[0] * sh[1] for sh, _e, _b, _eb in geoms_m)
        Le = sum(e[0] * e[1] for _sh, e, _b, _eb in geoms_m)
        bufs = coef_buffers(s.coef_bufs, dev["cp"].device, "merged", Lc, Le,
                            dev["cp"].shape[1] == 4)
        flat_c, flat_e = scatter_frame(bufs, dev["cp"], dev["ep"])
        return [_slice_plane(flat_c[None], flat_e[None], bc, be, sh[0],
                             sh[1], esh[0], esh[1])
                for sh, esh, bc, be in geoms_m], [bufs] * 3
    planes_cf = ((s.coef_y, s.eob_y), (s.coef_u, s.eob_u),
                 (s.coef_v, s.eob_v))
    coefs, consume = [], []
    for k, ((coef, eob4), (cp_d, ep_d)) in enumerate(
            zip(planes_cf, dev["pairs"])):
        bufs = coef_buffers(s.coef_bufs, cp_d.device, k, coef.size,
                            eob4.size, cp_d.shape[1] == 4)
        flat_c, flat_e = scatter_frame(bufs, cp_d, ep_d)
        coefs.append((flat_c.view(coef.shape), flat_e.view(eob4.shape)))
        consume.append(bufs)
    return coefs, consume


def _ref_planes(s, plane_idx, ss_x, ss_y):
    """The three reference planes of plane plane_idx of a frame (s: a
    FrameJob), on its device, with each one's visible (w, h). The planes
    stay on the device across frames."""
    h = s.header
    planes, dims = [], []
    for i in range(3):
        rf = s.refs[h.refidx[i]]
        if rf is None:
            planes.append(None)
            dims.append(None)
            continue
        if rf.dev is not None:
            planes.append(rf.dev[plane_idx])
        else:
            planes.append(torch.as_tensor(rf.planes[plane_idx],
                                          dtype=torch.int32, device=s.device))
        rw, rh = rf.size
        dims.append(((rw + ss_x) >> ss_x, (rh + ss_y) >> ss_y))
    k = next(i for i, p in enumerate(planes) if p is not None)
    return (tuple(p if p is not None else planes[k] for p in planes),
            tuple(d if d is not None else dims[k] for d in dims))


def frame_residuals(s):
    """The first stages of a frame's pass B on its device (s: a
    FrameJob, made ready by precompute_host and upload_job): the splat of
    its block records into the cell grids, the scatter of its coefficient
    pairs into the decoder's kept buffers and the consuming residuals of
    the three planes. Returns (plane_grids: per plane (inter4, txsz4,
    txtype4, comp, filt, refsel, mv16), residuals: per plane [H, W]
    int32, has_inter_frame, has_comp)."""
    h = s.header
    pre = s.pre
    dev = pre["dev"]
    r4, c4 = s.txsz4.shape
    with metrics.timer("recon.splat"):
        (inter4_d, txsz4_d, txtype4_d, comp4_d, filt4_d, refsel_d, mv16_d,
         inter4uv_d, uvtx4_d, txtypeuv_d, compuv_d, filtuv_d, refseluv_d,
         uvmv_d) = _grids_from_records(dev["recs"], r4, c4, h.ss_h,
                                       h.ss_v, states=s.splat_states)

    recs_host = pre["recs"]
    has_inter_frame = not (h.keyframe or h.intraonly) and bool(
        ((recs_host[:, 6] == 0) & (recs_host[:, 3] >= 0)).any())
    has_comp = bool((recs_host[:, 14] != 0).any())

    # the dense buffers are kept from frame to frame and read zero: the
    # residual below consumes what the scatter writes
    with metrics.timer("recon.scatter_coef"):
        coefs, consume = scatter_planes(s)

    grids = ((inter4_d, txsz4_d, txtype4_d, comp4_d, filt4_d, refsel_d,
              mv16_d),
             (inter4uv_d, uvtx4_d, txtypeuv_d, compuv_d, filtuv_d,
              refseluv_d, uvmv_d))
    plane_grids = (grids[0], grids[1], grids[1])
    with metrics.timer("recon.residual"):
        residuals = residual_planes(
            [(coef, eob, g[1], g[2])
             for (coef, eob), g in zip(coefs, plane_grids)],
            bool(h.lossless), h.bpp, consume=consume)
    return plane_grids, residuals, has_inter_frame, has_comp


def inter_planes_scaled(s, plane_grids, residuals, has_comp):
    """The inter pass of a frame with a reference of another size than
    its own (mc_planes_scaled, each slot at its own size) on the frame's
    planes: arguments as frame_residuals returns them."""
    h = s.header
    dev = s.pre["dev"]
    r4, c4 = s.txsz4.shape
    jobs = []
    for plane_idx, (residual, g) in enumerate(zip(residuals, plane_grids)):
        ss_x, ss_y = (h.ss_h, h.ss_v) if plane_idx else (0, 0)
        refplanes, dims = _ref_planes(s, plane_idx, ss_x, ss_y)
        inter4_p, _tx, _tt, comp_p, filt_p, refsel_p, mv16_p = g
        jobs.append((residual, inter4_p, comp_p, filt_p, refsel_p, mv16_p,
                     refplanes, dims, ss_x, ss_y))
    index = None if s.device.type == "cpu" else \
        recon_cuda.splat_state(s.splat_states, dev["recs"].device, r4, c4)
    return mc_planes_scaled(jobs, h.bpp, has_comp, dev["recs"], s.mvscale,
                            s.mvstep, s.cols, s.rows, index)


def recon_frame(s):
    """Reconstruct one frame on its device from the pass-A snapshot
    (s: a FrameJob). Sets s.cur_frame_obj.dev to the three int32
    planes. A frame whose inter blocks use a reference of invalid
    dimensions raises ValueError before any launch."""
    h = s.header
    bpp = h.bpp
    device = s.device
    cur = s.cur_frame_obj
    if getattr(s, "pre", None) is None:
        precompute_host(s)
    pre = s.pre
    _check_refs(s, pre["recs"])
    upload_job(s)
    dev = pre["dev"]
    plane_grids, residuals, has_inter_frame, has_comp = frame_residuals(s)

    if has_inter_frame:
        with metrics.timer("recon.mc"):
            # a reference of another size than the frame (mvscale
            # nonzero) takes the scaled inter pass, each slot at its own
            # size
            if any(sc[0] for sc in s.mvscale):
                outs = inter_planes_scaled(s, plane_grids, residuals,
                                           has_comp)
            else:
                jobs = []
                for plane_idx, (residual, g) in enumerate(
                        zip(residuals, plane_grids)):
                    ss_x, ss_y = (h.ss_h, h.ss_v) if plane_idx else (0, 0)
                    w, hh = cur.size
                    w, hh = (w + ss_x) >> ss_x, (hh + ss_y) >> ss_y
                    refplanes, _dims = _ref_planes(s, plane_idx, ss_x,
                                                   ss_y)
                    inter4_p, _tx, _tt, comp_p, filt_p, refsel_p, \
                        mv16_p = g
                    jobs.append((residual, inter4_p, comp_p, filt_p,
                                 refsel_p, mv16_p, refplanes, w, hh,
                                 2 >> ss_x, 2 >> ss_y))
                outs = mc_planes(jobs, bpp, has_comp)
    else:
        outs = [torch.zeros(r.shape, dtype=torch.int32, device=device)
                for r in residuals]

    # the three planes' wavefronts in one call
    with metrics.timer("recon.intra_run"):
        outs = run_intra(s, outs, residuals)

    if h.filter_level:
        outs = _loop_filter(s, outs, dev)
    cur.dev = outs
    cur._host_stale = True
