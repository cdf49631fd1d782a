"""The bytes each pass-B kernel of a frame needs: each input read once
and each output written once, counted from the arguments that the
decoder hands the kernel's wrapper. A frozen copy of the byte counts of
chip_smoke.py (splat_phase, residual_phase, residual_work, clear_bytes,
rows_in, mc_work, mc_scaled_work, intra_work, the grids and lpf phases),
operations left out: the benchmark's roofline is bytes over the HBM
rate. The count depends on the frame, not on how a kernel is written.

`capture(decoder, packets)` decodes packets with the wrappers counting
and returns one {kernel: bytes} a frame.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

# H100 SXM published HBM3 bandwidth (NVIDIA data sheet, 700 W), bytes/s
HBM_BPS = 3.35e12
# bytes of one cell's grids that MC reads: inter4 and comp (bool), filt
# (int32), refsel (2 x int32), mv16 (4 x int32)
MC_CELL_BYTES = 30


def _np(t):
    return t.cpu().numpy()


def splat_bytes(recs, outs):
    """_grids_from_records: the records read, the grids written."""
    return recs.numel() * 2 + sum(o.numel() * o.element_size()
                                  for o in outs)


def rows_in(rows, n):
    """Pair rows whose position lies in a buffer of n entries."""
    r = _np(rows).astype(np.int64)
    pos = (r[:, 0] << 16) | (r[:, 1] & 0xffff)
    return int(((pos >= 0) & (pos < n)).sum())


def scatter_bytes(cp, ep, nc, ne):
    """scatter_frame: the pair rows read, the positions they name written
    (buffers of nc coefficient and ne eob entries)."""
    wide = cp.shape[1] == 4
    return (cp.numel() + ep.numel()) * 2 \
        + rows_in(cp, nc) * (4 if wide else 2) + rows_in(ep, ne) * 2


def residual_work_bytes(coef, eob4, txsz4, txtype4, lossless):
    """One plane of residual_planes: the three grids read once, of the
    coefficients only the first eob (in scan order) of each coded block,
    the int32 residual written once."""
    nbytes = sum(g.numel() * g.element_size()
                 for g in (eob4, txsz4, txtype4)) + coef.numel() * 4
    e, t = (_np(g).astype(np.int64) for g in (eob4, txsz4))
    r4, c4 = e.shape
    yy, xx = np.mgrid[:r4, :c4]
    for tx in ((0,) if lossless else range(4)):
        k, sz = 1 << tx, 4 << tx
        root = (t == tx) & (e > 0) & (yy % k == 0) & (xx % k == 0)
        nbytes += int(np.minimum(e[root], sz * sz).sum()) \
            * coef.element_size()
    return nbytes


def clear_bytes(coef, eob4, txsz4, txtype4, lossless):
    """Bytes a consuming residual launch writes to clear one plane: each
    4-pixel quad of a transformed root that is not DC-only and holds a
    nonzero, the first quad of each DC-only root, and each nonzero eob
    cell."""
    e, t, ty = (_np(g).astype(np.int64) for g in (eob4, txsz4, txtype4))
    r4, c4 = e.shape
    yy, xx = np.mgrid[:r4, :c4]
    full = np.zeros((r4, c4), bool)
    ndc = 0
    for tx in ((0,) if lossless else range(4)):
        k = 1 << tx
        root = ((t == tx) & (e > 0) & (yy % k == 0) & (xx % k == 0)
                & (yy + k <= r4) & (xx + k <= c4))
        dc = root & (e == 1) & ((ty == 0) | (tx == 3)) & (not lossless)
        full |= (root & ~dc)[::k, ::k].repeat(k, 0).repeat(k, 1)[:r4, :c4]
        ndc += int(dc.sum())
    nz = _np(coef).reshape(coef.shape[0], c4, 4).any(-1)
    quads = int((nz & full.repeat(4, 0)).sum()) + ndc
    return quads * 4 * coef.element_size() + int((e != 0).sum()) * \
        eob4.element_size()


def residual_bytes(jobs, lossless):
    """residual_planes (8-bit or high bit depth, consuming): each plane's
    residual_work_bytes and clear_bytes."""
    return sum(residual_work_bytes(*job[:4], lossless)
               + clear_bytes(*job[:4], lossless) for job in jobs)


def mc_bytes(jobs, has_comp):
    """mc_planes: per plane the output written once; per pixel of an
    inter cell its residual and one reference pixel per reference read;
    MC_CELL_BYTES of grids a cell (no comp byte without has_comp)."""
    total = 0
    for job in jobs:
        residual, inter4, comp = job[:3]
        H, W = residual.shape
        inter = _np(inter4)
        cmp = inter & _np(comp) if has_comp else np.zeros_like(inter)
        refs = int(inter.sum()) + int(cmp.sum())
        total += H * W * 4 + int(inter.sum()) * 16 * 4 + refs * 16 * 4 \
            + inter.size * (MC_CELL_BYTES - (0 if has_comp else 1))
    return total


def mc_scaled_bytes(jobs, has_comp, recs, scales, steps, index):
    """mc_planes_scaled: each output pixel written once; per inter pixel
    its residual; the grids (MC_CELL_BYTES a cell); the records and the
    index; per inter pixel and reference the reference pixels it covers,
    (step_x / 16) x (step_y / 16) of them scaled and one unscaled, each
    reference plane at most its visible area."""
    nbytes = recs.numel() * 2 + index.bidx.numel() * 8
    for residual, inter4, comp, _f, refsel, _mv, refs, dims, _sx, \
            _sy in jobs:
        H, W = residual.shape
        inter = _np(inter4)
        act = [inter, inter & _np(comp) if has_comp else inter & False]
        sel = _np(refsel).clip(0, 2)
        covered = {}
        for ri, a in enumerate(act):
            for k in range(3):
                n = int((a & (sel[..., ri] == k)).sum())
                if not n:
                    continue
                sx, sy = steps[k] if scales[k][0] else (16, 16)
                key = refs[k].data_ptr()
                covered[key] = min(covered.get(key, 0)
                                   + 16 * n * sx * sy / 256,
                                   dims[k][0] * dims[k][1])
        nbytes += H * W * 4 + int(inter.sum()) * 64 \
            + inter.size * MC_CELL_BYTES + 4 * sum(covered.values())
    return int(nbytes)


def intra_bytes(jobs):
    """_intra_scan_planes: each new plane written once; the old plane
    read only where no intra block writes, the residual only where one
    does; the slab rows of real blocks (a slab two planes share, once)
    and, once per (size, mode) pair used, its tap words (directional
    modes) or its weight column (the DC family) from the kernel's tap
    table."""
    from ffmpeg_hybrid_tpu_torch.ops import intra_tables as it
    from ffmpeg_hybrid_tpu_torch.ops import recon_cuda as RC
    table, toff = RC.tap_table(), RC.tap_offsets()
    nbytes = 0
    pairs, slabs = set(), set()
    for plane, _residual, slab, L, sizes, caps in jobs:
        buf = _np(slab).astype(np.int64)
        H, W = plane.shape
        nbytes += 2 * H * W * 4
        new_slab = slab.data_ptr() not in slabs
        slabs.add(slab.data_ptr())
        base = 0
        for sz, cap in zip(sizes, caps):
            rows = buf[base:base + L * cap]
            base += L * cap
            rows = rows[(rows[:, 0] < H) & (rows[:, 1] < W)]
            nbytes += len(rows) * 16 if new_slab else 0
            part = table[toff[sz]:]
            npx = sz * sz
            for m in np.unique(rows[:, 2]):
                kind, o = int(part[m]) >> 24, int(part[m]) & 0xffffff
                if kind == RC.TAPS:
                    held = 4 * npx
                elif kind == RC.COLUMN:
                    held = 4 * len(part[o:o + it.edge_len(sz)])
                else:
                    held = 0
                if (sz, int(m)) not in pairs:
                    pairs.add((sz, int(m)))
                    nbytes += held
    return nbytes


def lf_grids_bytes(lfl, lfm, luts, grids):
    """grids_device: levels, masks and tables read, four grids written
    (16 B a quad)."""
    quads = sum(g.numel() // 4 for g in grids)
    return lfl.numel() * 2 + (lfm.numel() + luts.numel()) * 4 + quads * 16


def lf_bytes(planes, grids):
    """lf_frame_: each plane read and written once, each grid read once."""
    return sum(2 * p.numel() * 4 for p in planes) + sum(
        g.numel() * 4 for g in grids)


def _wrappers(frame):
    """{(module, name): wrapper} that add each call's bytes to the dict
    `frame` under the kernel's name and call the real function."""
    from ffmpeg_hybrid_tpu_torch.ops import lpf_dense, lpf_masks, recon

    def before(mod, name, count):
        real = getattr(mod, name)

        def wrapper(*args, **kwargs):
            frame[name] = frame.get(name, 0) + count(*args, **kwargs)
            return real(*args, **kwargs)
        return wrapper

    def after(mod, name, count):
        real = getattr(mod, name)

        def wrapper(*args, **kwargs):
            out = real(*args, **kwargs)
            frame[name] = frame.get(name, 0) + count(out, *args, **kwargs)
            return out
        return wrapper

    return {
        (recon, "_grids_from_records"): after(
            recon, "_grids_from_records",
            lambda out, recs, *a, **k: splat_bytes(recs, out)),
        (recon, "scatter_frame"): before(
            recon, "scatter_frame", lambda bufs, cp, ep: scatter_bytes(
                cp, ep, bufs.flat_c.numel(), bufs.flat_e.numel())),
        (recon, "residual_planes"): before(
            recon, "residual_planes",
            lambda jobs, lossless, bpp, consume=None: residual_bytes(
                jobs, lossless)),
        (recon, "mc_planes"): before(
            recon, "mc_planes",
            lambda jobs, bpp, has_comp: mc_bytes(jobs, has_comp)),
        (recon, "mc_planes_scaled"): before(
            recon, "mc_planes_scaled",
            lambda jobs, bpp, has_comp, recs, scales, steps, cols, rows,
            index: mc_scaled_bytes(jobs, has_comp, recs, scales, steps,
                                   index)),
        (recon, "_intra_scan_planes"): before(
            recon, "_intra_scan_planes", lambda jobs, bpp: intra_bytes(jobs)),
        (lpf_masks, "grids_device"): after(
            lpf_masks, "grids_device",
            lambda out, lfl, lfm, luts, *a: lf_grids_bytes(lfl, lfm, luts,
                                                           out)),
        (lpf_dense, "lf_frame_"): after(
            lpf_dense, "lf_frame_",
            lambda out, y, u, v, Vy, Hy, Vu, Hu, *a, **k: lf_bytes(
                (y, u, v), (Vy, Hy, Vu, Hu))),
    }


@contextlib.contextmanager
def counting(frame):
    """Within the block, every pass-B kernel wrapper the decoder calls
    adds its call's bytes to `frame`."""
    wrappers = _wrappers(frame)
    reals = {key: getattr(*key) for key in wrappers}
    for (mod, name), fn in wrappers.items():
        setattr(mod, name, fn)
    try:
        yield frame
    finally:
        for (mod, name), fn in reals.items():
            setattr(mod, name, fn)


def capture(decoder, packets):
    """[{kernel wrapper: bytes}] of each packet that `decoder` decodes
    one after another (decode, the serial path), in order."""
    frames = []
    for data in packets:
        frame = {}
        with counting(frame):
            decoder.decode(data)
        if decoder.device.type == "cuda":
            torch.cuda.synchronize(decoder.device)
        frames.append(frame)
    return frames
