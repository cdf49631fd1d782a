"""Scaled references in the port (ffmpeg_hybrid_tpu_torch): frames that
predict from a reference of another size than their own (dynamic
resize), against the JAX package with tolerance 0.

Function level: the exact 14-bit product (_mulshift14) against Python
integers; the scaled per-reference MC (_mc_ref_scaled) against the JAX
package's, called eagerly, on seeded inputs (a 2x downscale at step 32,
a 16x upscale at step 1 and an odd ratio, every filter bank, MVs past
both clamp limits, the four layouts, 8/10/12 bits); the anchor derivation
against _scaled_anchor_grids on records with sub-8x8 blocks; a numpy
model of csrc/mc.cu's scaled kernel (a thread per 4-pixel column, the
record read from the splat's epoch-tagged unit index) against the JAX
package's _mc_cells_mixed; mc_planes_scaled_plain against the jitted
_mc_cells_mixed with compound cells that mix a scaled and a same-size
slot.

End to end: VP9Decoder(device="cpu") against the JAX package's golden
decoder, plane for plane, on small mini-encoder streams: 64 -> 128 up,
128 -> 64 (2x down), 130x70 -> 98x66 (odd sizes), compound with a scaled
and a same-size reference, a resize chain; a reference of invalid size
that a block uses raises the golden decoder's ValueError, one that no
block uses decodes; a stream that returns to a size reuses that size's
kept coefficient buffers. `cuda` tests hold the kernel to its plain
version on the card."""
import os
import re
import sys

import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

import jax.numpy as jnp

from ffmpeg_hybrid_tpu.ops import recon_tpu as J
from ffmpeg_hybrid_tpu_torch.ops import recon as R
from ffmpeg_hybrid_tpu_torch.ops import recon_cuda as RC
from ffmpeg_hybrid_tpu_torch.codecs.vp9 import tables as T

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
LAYOUTS = ((1, 1), (1, 0), (0, 1), (0, 0))   # 4:2:0, 4:2:2, 4:4:0, 4:4:4


def _mini():
    sys.path.insert(0, TOOLS)
    try:
        import mini_encoder
    finally:
        sys.path.pop(0)
    return mini_encoder


# ---------------------------------------------------------------------------
# seeded inputs


def _random_records(rng, rows8, cols8):
    """Block records of a random partition of a rows8 x cols8 grid of 8x8
    units (superblock by superblock, every block size, sub-8x8 included),
    inter blocks with random refs, filters and MVs, bucket-padded with
    pad rows (bs -1) as recon._pack_records leaves them."""
    recs = []

    def leaf(r, c, bs):
        if r < rows8 and c < cols8:
            rec = np.zeros(36, np.int16)
            rec[0], rec[1], rec[3] = r, c, bs
            rec[14] = rng.randint(0, 2)
            rec[15], rec[16] = rng.randint(0, 3, 2)
            rec[17] = rng.randint(0, 4)
            rec[18:34] = rng.randint(-300, 300, 16)
            recs.append(rec)

    def part(r, c, lvl):                 # lvl: 0 = 64x64 ... 3 = 8x8
        if r >= rows8 or c >= cols8:
            return
        n = 8 >> lvl
        if lvl == 3:
            leaf(r, c, 9 + rng.randint(0, 4))
            return
        p = rng.choice(4, p=(0.2, 0.15, 0.15, 0.5))
        sq = 3 * lvl
        if p == 0:
            leaf(r, c, sq)
        elif p == 1:
            leaf(r, c, sq + 1)
            leaf(r + n // 2, c, sq + 1)
        elif p == 2:
            leaf(r, c, sq + 2)
            leaf(r, c + n // 2, sq + 2)
        else:
            for dr in (0, n // 2):
                for dc in (0, n // 2):
                    part(r + dr, c + dc, lvl + 1)

    for r in range(0, rows8, 8):
        for c in range(0, cols8, 8):
            part(r, c, 0)
    n = len(recs)
    out = np.zeros((R._pad_to_bucket(n + 1, base=256, mult=2), 36), np.int16)
    out[:n] = recs
    out[n:, 3] = -1
    return out


def _mvs(rng, shape):
    """Raw MVs: half small, half far past both clamp limits."""
    small = rng.randint(-64, 65, shape)
    wide = rng.randint(-2000, 2001, shape)
    return np.where(rng.rand(*shape) < 0.5, small, wide).astype(np.int32)


def _scales(frame, refs):
    w, h = frame
    sc = [[(rw << 14) // w, (rh << 14) // h] if (rw, rh) != (w, h)
          else [0, 0] for rw, rh in refs]
    st = [[16 * a >> 14, 16 * b >> 14] for a, b in sc]
    return np.asarray(sc, np.int32), np.asarray(st, np.int32)


def _plane_dims(size, ss_x, ss_y):
    w, h = size
    return (w + ss_x) >> ss_x, (h + ss_y) >> ss_y


# the plane's size in its own pixels, whatever the layout, so that the
# JAX package's eager ops compile once for every case; the references
# a 2x downscale (step 32), a 16x upscale (step 1) and an odd ratio
# (steps 24 and 20), or with MIXED the frame's own size in slot 1
PLANE = (64, 48)
SCALED, MIXED = "scaled", "mixed"


def _case(seed, ss_x, ss_y, bpp, refs=SCALED, plane=PLANE):
    """Seeded inputs of one plane of subsampling (ss_x, ss_y): records,
    grids, reference planes of their own sizes (padded to 64 px of luma,
    random beyond the visible area as a decoder's are), scales and
    steps."""
    rng = np.random.RandomState(seed)
    frame = (plane[0] << ss_x, plane[1] << ss_y)
    w, h = frame
    sizes = ((2 * w, 2 * h), (w, h) if refs == MIXED else
             ((w + 15) // 16, (h + 15) // 16), (w * 3 // 2, h * 5 // 4))
    cols, rows = (w + 7) >> 3, (h + 7) >> 3
    r4, c4 = ((h + 63) >> 6) * 16, ((w + 63) >> 6) * 16
    pr4, pc4 = r4 >> ss_y, c4 >> ss_x
    recs = _random_records(rng, rows, cols)
    planes, dims = [], []
    for size in sizes:
        Hp = ((size[1] + 63) >> 6) * 64 >> ss_y
        Wp = ((size[0] + 63) >> 6) * 64 >> ss_x
        planes.append(rng.randint(0, 1 << bpp, (Hp, Wp)).astype(np.int32))
        dims.append(_plane_dims(size, ss_x, ss_y))
    scales, steps = _scales(frame, sizes)
    mvraw = _mvs(rng, (pr4, pc4, 2, 2))
    refsel = rng.randint(0, 3, (pr4, pc4, 2)).astype(np.int32)
    if refs == MIXED:
        # the same-size slot's MVs are pass A's, clamped: keep them near
        mvraw = np.where((refsel == 1)[..., None], mvraw // 8, mvraw)
    return dict(
        recs=recs, r4=r4, c4=c4, cols=cols, rows=rows, planes=planes,
        dims=dims, scales=scales, steps=steps, mvraw=mvraw.astype(np.int32),
        refsel=refsel, filt=rng.randint(0, 4, (pr4, pc4)).astype(np.int32),
        comp=rng.rand(pr4, pc4) < 0.5, inter=rng.rand(pr4, pc4) < 0.8,
        residual=rng.randint(-300, 300, (pr4 * 4, pc4 * 4)).astype(np.int32))


def _stack(planes):
    """The JAX package's common reference stack, of one shape for every
    case."""
    out = np.zeros((3, 256, 256), np.int32)
    for k, p in enumerate(planes):
        out[k, :p.shape[0], :p.shape[1]] = p
    return jnp.asarray(out)


def _jax_anchors(c, ss_x, ss_y, chroma=True):
    """_scaled_anchor_grids' six grids of a chroma plane of subsampling
    (ss_x, ss_y), or of luma."""
    a = J._scaled_anchor_grids(jnp.asarray(c["recs"]), c["r4"], c["c4"],
                               ss_x, ss_y)
    return [np.asarray(x) for x in (a[6:] if chroma else a[:6])]


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# function level


def test_mulshift14_is_exact():
    rng = np.random.RandomState(0)
    a = np.concatenate([rng.randint(-(1 << 24) + 1, 1 << 24, 200),
                        [(1 << 24) - 1, -(1 << 24) + 1, -1, 0, 1]])
    b = np.concatenate([rng.randint(0, 1 << 15, 200),
                        [(1 << 15) - 1, (1 << 15) - 1, 1 << 14, 3, 0]])
    want = [int(x) * int(y) >> 14 for x, y in zip(a, b)]
    got = R._mulshift14(torch.as_tensor(a), torch.as_tensor(b))
    assert got.tolist() == want
    # the JAX package's int32 split form agrees where it applies
    assert np.asarray(J._mulshift14(jnp.asarray(a, jnp.int32),
                                    jnp.asarray(b, jnp.int32))).tolist() \
        == want


@pytest.mark.parametrize("layout", range(4))
def test_anchors_match_jax(layout):
    ss_x, ss_y = LAYOUTS[layout]
    c = _case(10 + layout, ss_x, ss_y, 8, plane=(100, 68))
    assert (c["recs"][:, 3] > 9).any()
    for ss, chroma in (((0, 0), False), ((ss_x, ss_y), True)):
        got = R._scaled_anchors_plain(_t(c["recs"]), c["r4"], c["c4"], *ss)
        for g, w in zip(got, _jax_anchors(c, ss_x, ss_y, chroma)):
            assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("layout,bpp", [(0, 8), (1, 10), (2, 12), (3, 8)])
def test_mc_ref_scaled_matches_jax(layout, bpp):
    """Every slot scaled (steps 32, 1 and 24/20), both directions."""
    ss_x, ss_y = LAYOUTS[layout]
    c = _case(20 + layout, ss_x, ss_y, bpp)
    anchors = _jax_anchors(c, ss_x, ss_y)
    refw = jnp.asarray([d[0] for d in c["dims"]], jnp.int32)
    refh = jnp.asarray([d[1] for d in c["dims"]], jnp.int32)
    stack = _stack(c["planes"])
    mine_anchors = tuple(_t(a).to(torch.int64) for a in anchors)
    for ri in (0, 1):
        want = J._mc_ref_scaled(
            stack, jnp.asarray(c["mvraw"]), jnp.asarray(c["refsel"]),
            jnp.asarray(c["filt"]), *[jnp.asarray(a) for a in anchors],
            jnp.asarray(c["scales"]), jnp.asarray(c["steps"]), refw, refh,
            c["cols"], c["rows"], bpp, ri, ss_x, ss_y)
        got = R._mc_ref_scaled(
            [_t(p) for p in c["planes"]], c["dims"], _t(c["mvraw"]),
            _t(c["refsel"]), _t(c["filt"]), mine_anchors,
            _t(c["scales"]).long(), _t(c["steps"]).long(), c["cols"],
            c["rows"], bpp, ri, ss_x, ss_y)
        assert np.array_equal(got.numpy(), np.asarray(want))


def _jax_mixed(c, ss_x, ss_y, bpp):
    anchors = _jax_anchors(c, ss_x, ss_y)
    sc = np.asarray(c["scales"])
    return np.asarray(J._mc_cells_mixed(
        _stack(c["planes"]), jnp.asarray(c["mvraw"]),
        jnp.asarray(c["refsel"]), jnp.asarray(c["comp"]),
        jnp.asarray(c["filt"]), *[jnp.asarray(a) for a in anchors],
        jnp.asarray(sc), jnp.asarray(c["steps"]),
        jnp.asarray([d[0] for d in c["dims"]], jnp.int32),
        jnp.asarray([d[1] for d in c["dims"]], jnp.int32),
        jnp.asarray(sc[:, 0] != 0), c["cols"], c["rows"], bpp,
        2 >> ss_x, 2 >> ss_y, ss_x, ss_y))


def _apply(mc, c, bpp):
    mask = np.repeat(np.repeat(c["inter"], 4, 0), 4, 1)
    return np.where(mask, np.clip(mc + c["residual"], 0, (1 << bpp) - 1), 0)


def _job(c, ss_x, ss_y):
    return (_t(c["residual"]), _t(c["inter"]), _t(c["comp"]),
            _t(c["filt"]), _t(c["refsel"]), _t(c["mvraw"]),
            tuple(_t(p) for p in c["planes"]), tuple(c["dims"]), ss_x, ss_y)


# ---------------------------------------------------------------------------
# a numpy model of csrc/mc.cu's scaled kernel


def _unit_index(recs, r4, c4, epoch, stale_epoch):
    """The splat's index grid as the kernel reads it: an entry an 8x8
    unit, (epoch << 32) | b for the highest record b that covers it, and
    entries a record of this frame does not cover left at an older
    epoch."""
    r8, c8 = (r4 + 1) // 2, (c4 + 1) // 2
    idx = np.full((r8, c8), (stale_epoch << 32) | 7, np.uint64)
    bwh = np.asarray(T.BWH_TAB[1])
    for b, rec in enumerate(recs):
        if rec[3] < 0:
            continue
        w8, h8 = bwh[rec[3]]
        idx[rec[0]:rec[0] + h8, rec[1]:rec[1] + w8] = (epoch << 32) | b
    return idx


def _mc_consts():
    """csrc/mc.cu's scaled window and patch sizes and its largest step."""
    src = open(os.path.join(os.path.dirname(R.__file__), "..", "csrc",
                            "mc.cu")).read()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("kSWin", "kSPatch", "kMaxStep")}


def _call(c, i, j, ss_x, ss_y, index, epoch):
    """The call structure of plane cell (i, j) from its record, read from
    the unit index as the kernel reads it: (ay, ax, by, bx, ph, pw)."""
    bwh = np.asarray(T.BWH_TAB[1])
    recs = c["recs"].astype(np.int64)
    e = int(index[(i << ss_y) >> 1, (j << ss_x) >> 1])
    b = min(e & 0xffffffff, len(recs) - 1) if e >> 32 == epoch \
        else len(recs) - 1
    brow, bcol, bs = recs[b, 0], recs[b, 1], recs[b, 3]
    sub8 = bs > 9
    bsc = min(max(bs, 0), 12)
    by, bx = (brow * 8) >> ss_y, (bcol * 8) >> ss_x
    ay = by + (((i - brow * 2) & 1) * 4 if sub8 and not ss_y else 0)
    ax = bx + (((j - bcol * 2) & 1) * 4 if sub8 and not ss_x else 0)
    return ay, ax, by, bx, (bwh[bsc, 1] * 8) >> ss_y, (bwh[bsc, 0] * 8) >> ss_x


def _motion(c, i, j, ri, ss_x, ss_y, call):
    """A cell's motion for reference ri, as the kernel's lanes derive it:
    (slot, bank, the 1/16-pel position of its first pixel column and
    row, the slot's steps)."""
    sel = min(max(int(c["refsel"][i, j, ri]), 0), 2)
    bank = min(max(int(c["filt"][i, j]), 0), 3)
    mvx, mvy = (int(v) for v in c["mvraw"][i, j, ri])
    if int(c["scales"][sel][0]) == 0:
        return (sel, bank, 16 * 4 * j + mvx * (2 >> ss_x),
                16 * 4 * i + mvy * (2 >> ss_y), 16, 16)
    ay, ax, by, bx, ph, pw = call

    def clamp(mv, b0, span, n8, ss):
        if ss:
            return min(max(mv, -(b0 + span + 4) * 16), (n8 * 4 - b0 + 3) * 16)
        return min(max(mv, -(b0 + span + 4) * 8), (n8 * 8 - b0 + 3) * 8)

    def start(mv, a0, sc, ss):
        pa = int(a0) * sc
        if ss:
            return ((mv * sc) >> 14) + ((pa >> 10) & ~15) + ((pa >> 9) & 15)
        return ((mv * 2 * sc) >> 14) + (pa >> 10)

    scx, scy = (int(v) for v in c["scales"][sel])
    stx, sty = (int(v) for v in c["steps"][sel])
    tx0 = start(clamp(mvx, bx, pw, c["cols"], ss_x), ax, scx, ss_x)
    ty0 = start(clamp(mvy, by, ph, c["rows"], ss_y), ay, scy, ss_y)
    return (sel, bank, 16 * (tx0 >> 4) + (tx0 & 15) + (4 * j - ax) * stx,
            16 * (ty0 >> 4) + (ty0 & 15) + (4 * i - ay) * sty, stx, sty)


def _passes(c, sel, bank, px, py, sx, sy, n, bpp, most):
    """The prediction [n, n] of n x n pixels whose first pixel reads the
    1/16-pel position (px, py), as the kernel computes it: the slot's
    window of ((phase + (n - 1) step) >> 4) + 8 rows and columns (at most
    `most`), each clamped to the slot's visible size; the horizontal pass
    of each output column at its phase over the window's rows, the
    vertical pass of each row at its phase."""
    ftab = R._FTAB
    maxp = (1 << bpp) - 1
    fx, fy = px & 15, py & 15
    ncol, nrow = ((fx + (n - 1) * sx) >> 4) + 8, ((fy + (n - 1) * sy) >> 4) + 8
    assert ncol <= most and nrow <= most
    ref = c["planes"][sel].astype(np.int64)
    w, h = c["dims"][sel]
    win = ref[np.clip((py >> 4) - 3 + np.arange(nrow), 0, h - 1)][
        :, np.clip((px >> 4) - 3 + np.arange(ncol), 0, w - 1)]
    hv = np.zeros((nrow, n), np.int64)
    for x in range(n):
        tk = fx + x * sx
        acc = win[:, (tk >> 4) + np.arange(8)] @ ftab[bank, tk & 15]
        hv[:, x] = np.clip((acc + 64) >> 7, 0, maxp)
    out = np.zeros((n, n), np.int64)
    for y in range(n):
        tk = fy + y * sy
        acc = ftab[bank, tk & 15] @ hv[(tk >> 4) + np.arange(8)]
        out[y] = np.clip((acc + 64) >> 7, 0, maxp)
    return out


def _kernel_model(c, ss_x, ss_y, bpp, index, epoch, paths=None):
    """csrc/mc.cu's scaled kernel in numpy, a warp per 16x16 tile: each
    cell's record from the unit index, its motion for each reference
    (_motion) and its key, the motion's line at the tile's origin; where
    every cell of the tile that uses the reference has one key, the
    window path (_passes over the tile, a window of at most kSWin), else
    the walk (_passes over each cell, a patch of at most kSPatch); the
    compound average, the residual and the clip. paths: a dict counting
    the window and walk passes."""
    k = _mc_consts()
    maxp = (1 << bpp) - 1
    pr4, pc4 = c["inter"].shape
    out = np.zeros((pr4 * 4, pc4 * 4), np.int64)
    for ty in range(0, pr4, 4):
        for tx in range(0, pc4, 4):
            cells = [(i, j) for i in range(ty, min(ty + 4, pr4))
                     for j in range(tx, min(tx + 4, pc4)) if c["inter"][i, j]]
            calls = {ij: _call(c, *ij, ss_x, ss_y, index, epoch)
                     for ij in cells}
            pred = {}
            for ri in (0, 1):
                use = [ij for ij in cells if ri == 0 or c["comp"][ij]]
                if not use:
                    continue
                m = {ij: _motion(c, *ij, ri, ss_x, ss_y, calls[ij])
                     for ij in use}
                keys = {(s, b, px + (4 * tx - 4 * j) * sx,
                         py + (4 * ty - 4 * i) * sy)
                        for (i, j), (s, b, px, py, sx, sy) in m.items()}
                if len(keys) == 1:
                    (s, b, px, py), = keys
                    sx, sy = next(iter(m.values()))[4:]
                    tile = _passes(c, s, b, px, py, sx, sy, 16, bpp,
                                   k["kSWin"])
                    v = {(i, j): tile[4 * (i - ty):4 * (i - ty) + 4,
                                      4 * (j - tx):4 * (j - tx) + 4]
                         for i, j in use}
                else:
                    v = {ij: _passes(c, s, b, px, py, sx, sy, 4, bpp,
                                     k["kSPatch"])
                         for ij, (s, b, px, py, sx, sy) in m.items()}
                if paths is not None:
                    paths["window" if len(keys) == 1 else "walk"] += 1
                for ij in use:
                    pred[ij] = v[ij] if ri == 0 else (pred[ij] + v[ij] + 1) >> 1
            for (i, j), p in pred.items():
                out[4 * i:4 * i + 4, 4 * j:4 * j + 4] = np.clip(
                    p + c["residual"][4 * i:4 * i + 4, 4 * j:4 * j + 4], 0,
                    maxp)
    return out


def _tiles_case(seed, ss_x, ss_y, bpp):
    """A _case whose records are 32x32 blocks and whose cells carry their
    block's references, bank, compound flag and MVs (a luma cell's block;
    a chroma cell's, that of its luma cell), so that every 16x16 tile of
    every plane has one motion a reference."""
    c = _case(seed, ss_x, ss_y, bpp)
    rng = np.random.RandomState(seed + 1000)
    rows8, cols8 = c["rows"], c["cols"]
    recs = []
    for r in range(0, rows8, 4):
        for col in range(0, cols8, 4):
            rec = np.zeros(36, np.int16)
            rec[0], rec[1], rec[3] = r, col, 3
            recs.append(rec)
    n = len(recs)
    out = np.zeros((R._pad_to_bucket(n + 1, base=256, mult=2), 36), np.int16)
    out[:n] = recs
    out[n:, 3] = -1
    c["recs"] = out
    pr4, pc4 = c["inter"].shape
    blk = (((np.arange(pr4)[:, None] << ss_y) // 8) * ((cols8 + 3) // 4)
           + ((np.arange(pc4)[None, :] << ss_x) // 8))
    nb = int(blk.max()) + 1
    c["refsel"] = rng.randint(0, 3, (nb, 2)).astype(np.int32)[blk]
    c["filt"] = rng.randint(0, 4, nb).astype(np.int32)[blk]
    c["comp"] = (rng.rand(nb) < 0.5)[blk]
    c["mvraw"] = _mvs(rng, (nb, 2, 2))[blk]
    return c


@pytest.mark.parametrize("layout,bpp", [(0, 8), (1, 12)])
def test_mixed_plain_and_kernel_model_match_jitted_mixed(layout, bpp):
    """mc_planes_scaled_plain and the kernel's model against the jitted
    _mc_cells_mixed and its apply, on compound cells that mix a scaled
    and a same-size slot; the unit index holds entries of an older
    epoch where no record covers a unit."""
    ss_x, ss_y = LAYOUTS[layout]
    c = _case(30 + layout, ss_x, ss_y, bpp, refs=MIXED)
    mixed = (c["comp"] & (c["refsel"] == 1).any(-1)
             & (c["refsel"] != 1).any(-1))
    assert mixed.any()
    want = _apply(_jax_mixed(c, ss_x, ss_y, bpp), c, bpp)
    [got] = R.mc_planes_scaled_plain(
        [_job(c, ss_x, ss_y)], bpp, True, _t(c["recs"]), c["scales"],
        c["steps"], c["cols"], c["rows"])
    assert np.array_equal(got.numpy(), want)
    epoch = 5
    index = _unit_index(c["recs"], c["r4"], c["c4"], epoch, epoch - 1)
    assert np.array_equal(_kernel_model(c, ss_x, ss_y, bpp, index, epoch),
                          want)


@pytest.mark.parametrize("layout,bpp", [(0, 8), (3, 10)])
def test_kernel_model_window_path_matches_jitted_mixed(layout, bpp):
    """Records of 32x32 blocks whose cells carry their block's motion:
    every tile pass of the kernel's model takes the window path, and the
    model equals the jitted _mc_cells_mixed and its apply."""
    ss_x, ss_y = LAYOUTS[layout]
    c = _tiles_case(40 + layout, ss_x, ss_y, bpp)
    want = _apply(_jax_mixed(c, ss_x, ss_y, bpp), c, bpp)
    epoch = 9
    index = _unit_index(c["recs"], c["r4"], c["c4"], epoch, epoch - 1)
    paths = {"window": 0, "walk": 0}
    got = _kernel_model(c, ss_x, ss_y, bpp, index, epoch, paths)
    assert np.array_equal(got, want)
    assert paths["window"] and not paths["walk"]


def test_window_and_patch_fit_their_slices():
    """For every step from 1 to kMaxStep (32) and every start phase, the
    window of a 16-pixel tile and the patch of a 4-pixel cell fit the
    kernel's kSWin and kSPatch, and every tap the passes read lies in
    them; for any anchor offset and 64-bit start, a cell's own source
    columns and phases equal those of its key, its line at the tile's
    origin."""
    k = _mc_consts()
    assert k["kMaxStep"] == 32
    for step in range(1, 33):
        for f in range(16):
            for n, most in ((16, k["kSWin"]), (4, k["kSPatch"])):
                span = ((f + (n - 1) * step) >> 4) + 8
                assert span <= most
                reads = [((f + x * step) >> 4) + t for x in range(n)
                         for t in range(8)]
                assert 0 <= min(reads) and max(reads) < span
    assert ((15 + 15 * 32) >> 4) + 8 == k["kSWin"]
    assert ((15 + 3 * 32) >> 4) + 8 == k["kSPatch"]
    t0 = np.arange(-4003, 4004, 37)[:, None, None]
    off = np.arange(0, 64, 4)[None, :, None]         # xc - ax
    cell = np.arange(0, 16, 4)[None, None, :]        # xc - x0
    for step in range(1, 33):
        key = 16 * (t0 >> 4) + (t0 & 15) + off * step - cell * step
        for x in range(4):
            own = (t0 & 15) + (off + x) * step + 0 * cell
            pos = key + (cell + x) * step
            assert np.array_equal((t0 >> 4) + (own >> 4), pos >> 4)
            assert np.array_equal(own & 15, pos & 15)


def test_kernel_tables_match_the_port():
    src = open(os.path.join(os.path.dirname(R.__file__), "..", "csrc",
                            "mc.cu")).read()
    body = src[src.index("kBwh[13][2] = {"):]
    body = body[body.index("{") + 1:body.index("};")]
    vals = [int(v) for v in body.replace("{", " ").replace("}", " ")
            .replace(",", " ").split()]
    assert vals == np.asarray(T.BWH_TAB[1]).reshape(-1).tolist()


# ---------------------------------------------------------------------------
# end to end, against the JAX package's golden decoder


def _kf(w, h, seed):
    """A lossless keyframe of random content (fills every slot)."""
    r = np.random.RandomState(seed)
    return _mini().encode_keyframe_lossless(
        r.randint(0, 256, (h, w)),
        r.randint(0, 256, ((h + 1) // 2, (w + 1) // 2)),
        r.randint(0, 256, ((h + 1) // 2, (w + 1) // 2)), 8)


def _flex(w, h, seed, **kw):
    return _mini().encode_inter_flex(w, h, seed=seed, **kw)


_STREAMS = {
    # 64 -> 128 up, all-skip ZEROMV (the mini_scaled vector)
    "up_64_128": lambda m: [_kf(64, 64, 9), m.encode_inter_zeromv(128, 128)],
    # 128 -> 64, 2x down (step 32), random partitions and NEWMV
    "down_128_64": lambda m: [_kf(128, 128, 23),
                              m.encode_inter_random(64, 64, seed=23)[0]],
    # odd sizes: chroma rounding, MV clamps at the frame's edge
    "odd_130x70_98x66": lambda m: [
        _kf(130, 70, 24), m.encode_inter_random(98, 66, seed=24)[0]],
    # compound: first both references scaled (96 -> 128), then LAST and
    # ALTREF scaled with GOLDEN of the frame's size, so that compound
    # cells mix a scaled and a same-size slot; loop filter, switchable
    # filters, intra blocks and coefficients
    "compound": lambda m: [
        _kf(96, 96, 141),
        _flex(96, 96, 142, refresh_mask=0x02, mv_mags=(0, 2, 8)),
        _flex(128, 128, 143, comppredmode=1, signbias=(0, 0, 1),
              refidx=(0, 1, 0), refresh_mask=0x04, mv_mags=(0, 2, 8, 32)),
        _flex(128, 128, 144, comppredmode=2, signbias=(0, 0, 1),
              refidx=(0, 2, 0), refresh_mask=0, filtermode=4,
              filter_level=20, coeffs=True, p_intra=0.2,
              mv_mags=(0, 2, 8, 32))],
    # a resize chain as tools/make_fate_vectors.py gen_resize builds it, at
    # half its size: each frame predicts from the one before (/2, x1.5,
    # /2, x1.78)
    "chain": lambda m: [_kf(96, 96, 888)] + [
        _flex(sz, sz, 777 + i, refidx=(0, 0, 0), refresh_mask=0x01,
              coeffs=True, p_skip=0.2, mv_mags=(0, 2, 8, 24))
        for i, sz in enumerate((48, 72, 36, 64))],
}

_BUILT = {}


def _stream(name):
    if name not in _BUILT:
        _BUILT[name] = _STREAMS[name](_mini())
    return _BUILT[name]


def _golden(pkts):
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder
    dec = VP9Decoder(recon_backend="golden")
    return [f for p in pkts for f in dec.decode(p)]


def _port(pkts, device="cpu", dec=None):
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    dec = dec or VP9Decoder(device=device)
    return list(dec.decode_stream(iter(pkts)))


def _same_frames(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.size == b.size
        for pa, pb in zip(a.crop(), b.crop()):
            assert pa.shape == pb.shape
            assert np.array_equal(pa.astype(np.int64), pb.astype(np.int64))


@pytest.mark.parametrize("name", sorted(_STREAMS))
def test_stream_matches_golden(name):
    pkts = _stream(name)
    RC.reset_launches()
    _same_frames(_golden(pkts), _port(pkts))


def _invalid_ref_stream(force_last):
    """64x64 keyframe; 32x32 from it (slot 1); then 24x24 with LAST in
    slot 1 (valid: 1.33x down) and GOLDEN and ALTREF in slot 0 (64 px:
    more than twice the frame, an invalid size). force_last: the
    segmentation REF feature puts every block on LAST, so that no block
    uses the invalid slot."""
    seg = [(None, None, 1, False)] * 8 if force_last else None
    return [_kf(64, 64, 51),
            _flex(32, 32, 52, refresh_mask=0x02, mv_mags=(0, 2, 8)),
            _flex(24, 24, 53, refidx=(1, 0, 0), refresh_mask=0,
                  mv_mags=(0, 2, 8), seg_feat=seg)]


def test_used_invalid_reference_raises_as_golden():
    pkts = _invalid_ref_stream(False)
    with pytest.raises(ValueError, match="invalid dimensions") as want:
        _golden(pkts)
    with pytest.raises(ValueError, match="invalid dimensions") as got:
        _port(pkts)
    assert str(got.value) == str(want.value)


def test_unused_invalid_reference_decodes():
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    pkts = _invalid_ref_stream(True)
    dec = VP9Decoder(device="cpu")
    jobs = [dec.decode_pass_a(p) for p in pkts]
    assert [sc[0] for sc in jobs[2].mvscale] == [(32 << 14) // 24, -1, -1]
    _same_frames(_golden(pkts), _port(pkts))


def test_a_size_returned_to_reuses_its_buffers():
    """96 -> 64 -> 96: the third frame finds the first one's kept
    coefficient buffers, reading zero (no new set, no zero-fill)."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    pkts = [_kf(96, 96, 61),
            _flex(64, 64, 62, refresh_mask=0x02, coeffs=True,
                  mv_mags=(0, 2, 8)),
            _flex(96, 96, 63, refidx=(1, 1, 1), refresh_mask=0,
                  coeffs=True, mv_mags=(0, 2, 8))]
    dec = VP9Decoder(device="cpu")
    fills = dict(R.COEF_FILLS)
    made = []
    for i, p in enumerate(pkts):
        dec.decode(p)
        made.append(dict(dec.coef_bufs))
    assert len(made[0]) == 1 and len(made[1]) == 2
    assert made[2].keys() == made[1].keys()
    assert all(made[2][k] is v for k, v in made[1].items())
    assert R.COEF_FILLS == fills
    assert all(b.read_zero() for b in dec.coef_bufs.values())


def test_wrapper_takes_the_kernel_off_the_cpu(monkeypatch):
    """Tensors off the CPU reach one launch of csrc/mc.cu's scaled entry
    for the planes, with the splat's index state and a null path counter
    unless one is given; without the state the wrapper raises. (The launch is recorded, not run: the CPU has no card.)"""
    from ffmpeg_hybrid_tpu_torch.ops import _cuda
    c = _case(50, 1, 1, 8, refs=MIXED)
    jobs = [_job(c, 1, 1)]
    launched = []

    def fake_launch(source, _sig, name, *args):
        launched.append((source, name, args))

    monkeypatch.setattr(_cuda, "launch", fake_launch)
    fake = torch.device("meta")
    meta = [tuple(x.to(fake) if torch.is_tensor(x) else
                  tuple(y.to(fake) for y in x) if isinstance(x, tuple)
                  and x and torch.is_tensor(x[0]) else x for x in job)
            for job in jobs]
    state = RC.SplatState(fake, ((c["r4"] + 1) // 2) * ((c["c4"] + 1) // 2))
    state.epoch = 3
    RC.reset_launches()
    R.mc_planes_scaled(meta, 8, True, _t(c["recs"]).to(fake), c["scales"],
                       c["steps"], c["cols"], c["rows"], state)
    assert [(s, n) for s, n, _a in launched] == [("mc.cu",
                                                  "mc_planes_scaled")]
    assert RC.LAUNCHES["mc_scaled"] == 1
    ptrs, _dims, n, frame = launched[0][2][:4]
    assert n == 1 and len(ptrs) == 13 and ptrs[-2] is state.bidx
    assert ptrs[-1] is None     # no path counter: the decode's launch
    paths = torch.zeros(2, dtype=torch.int64, device=fake)
    R.mc_planes_scaled(meta, 8, True, _t(c["recs"]).to(fake), c["scales"],
                       c["steps"], c["cols"], c["rows"], state, paths)
    assert launched[1][2][0][-1] is paths
    state.epoch = 0     # no splat has run on it
    for index in (None, state):
        with pytest.raises(ValueError, match="index state"):
            R.mc_planes_scaled(meta, 8, True, _t(c["recs"]).to(fake),
                               c["scales"], c["steps"], c["cols"], c["rows"],
                               index)


# ---------------------------------------------------------------------------
# on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("layout,bpp", [(0, 8), (1, 10), (2, 12), (3, 8)])
def test_kernel_matches_plain_on_the_card(layout, bpp):
    """The kernel against its plain version on seeded inputs, its record
    index made by the splat kernel from the case's records."""
    dev = _card()
    ss_x, ss_y = LAYOUTS[layout]
    for refs in (SCALED, MIXED):
        c = _case(60 + layout, ss_x, ss_y, bpp, refs=refs)
        job = [tuple(x.to(dev) if torch.is_tensor(x) else
                     tuple(y.to(dev) for y in x) if isinstance(x, tuple)
                     and x and torch.is_tensor(x[0]) else x
                     for x in _job(c, ss_x, ss_y))]
        recs = _t(c["recs"]).to(dev)
        states = {}
        R._grids_from_records(recs, c["r4"], c["c4"], 1, 1, states=states)
        index = RC.splat_state(states, torch.device(dev), c["r4"], c["c4"])
        args = (bpp, True, recs, c["scales"], c["steps"], c["cols"],
                c["rows"])
        want = R.mc_planes_scaled_plain(job, *args)
        RC.reset_launches()
        got = R.mc_planes_scaled(job, *args, index)
        assert RC.LAUNCHES["mc_scaled"] == 1
        assert torch.equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["window", "walk"])
def test_kernel_paths_match_plain_on_the_card(path):
    """The kernel against its plain version on cases whose tiles take one
    path, by the model's count: every tile pass the window (32x32 blocks,
    a motion a tile) or most of them the walk (a motion a cell); the
    kernel's own count of its paths equals the model's."""
    dev = _card()
    for layout, bpp in ((0, 8), (3, 12)):
        ss_x, ss_y = LAYOUTS[layout]
        c = _tiles_case(80 + layout, ss_x, ss_y, bpp) if path == "window" \
            else _case(80 + layout, ss_x, ss_y, bpp, refs=MIXED)
        epoch = 5
        paths = {"window": 0, "walk": 0}
        _kernel_model(c, ss_x, ss_y, bpp, _unit_index(
            c["recs"], c["r4"], c["c4"], epoch, epoch - 1), epoch, paths)
        assert (not paths["walk"]) if path == "window" \
            else paths["walk"] > paths["window"]
        job = [tuple(x.to(dev) if torch.is_tensor(x) else
                     tuple(y.to(dev) for y in x) if isinstance(x, tuple)
                     and x and torch.is_tensor(x[0]) else x
                     for x in _job(c, ss_x, ss_y))]
        recs = _t(c["recs"]).to(dev)
        states = {}
        R._grids_from_records(recs, c["r4"], c["c4"], 1, 1, states=states)
        index = RC.splat_state(states, torch.device(dev), c["r4"], c["c4"])
        args = (bpp, True, recs, c["scales"], c["steps"], c["cols"],
                c["rows"])
        want = R.mc_planes_scaled_plain(job, *args)
        RC.reset_launches()
        counted = torch.zeros(2, dtype=torch.int64, device=dev)
        got = R.mc_planes_scaled(job, *args, index, counted)
        assert RC.LAUNCHES["mc_scaled"] == 1
        assert torch.equal(got[0], want[0])
        assert counted.tolist() == [paths["window"], paths["walk"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name,mc,mc_scaled", [("compound", 1, 2),
                                               ("chain", 0, 4),
                                               ("invalid_unused", 0, 2)])
def test_stream_on_the_card_matches_golden(name, mc, mc_scaled,
                                           monkeypatch):
    """A scaled stream decoded on the card, with the plain versions set
    to raise: one scaled-MC launch per frame with a reference of another
    size, one unscaled launch per other inter frame. invalid_unused: its
    last frame, whose invalid slot no block uses, comes through the
    native pass A without pair emission (the merged packer)."""
    _card()

    def plain_called(*a, **k):
        raise AssertionError("a plain version ran on the card")

    for fn in ("mc_planes_plain", "mc_planes_scaled_plain"):
        monkeypatch.setattr(R, fn, plain_called)
    pkts = _invalid_ref_stream(True) if name == "invalid_unused" \
        else _stream(name)
    RC.reset_launches()
    got = _port(pkts, device="cuda")
    _same_frames(_golden(pkts), got)
    assert (RC.LAUNCHES["mc"], RC.LAUNCHES["mc_scaled"]) == (mc, mc_scaled)
