"""On-device pass A: the block-syntax walk of S tile streams of a frame,
keyframes, intra-only and inter frames — the counterpart of the JAX
package's ops/passa_device.py (`_decode_jit`, inter=0 and inter=1).

Every lane is one independent VP9 tile bool stream (vp9.c:1342). A lane
runs a phase machine, one bounded quantum a step:

  PART  one partition-tree node: the partition symbol (full tree, the
        edge-forced single bit or the forced split, vp9.c:1115-1193),
        or the node's next child or leaf block;
  MODE  the mode bundle of one block (seg id, with temporal prediction
        on inter frames; skip; the intra/inter flag; the tx ladder; the
        keyframe's context-coupled intra mode trees, or on inter frames
        the fixed-table intra modes, the compound and single reference
        with their context chains, the whole-block inter mode and the
        interpolation filter; the SET_CTXS splats, vp9block.c:80-802);
  MV    one (sub-block, reference) of an inter block: the sub-block's
        inter mode, the find_ref_mvs candidate scan over the frame's
        MV grid, hp rounding and a NEWMV's joint and components
        (vp9mvs.c:37-365); after the last, the deferred context splats
        and the grid write-back (vp9block.c:682-801);
  COEF  one scan position of the current transform block (the token
        cascade of vp9block.c:805-923), with transform-block and plane
        transitions folded into the quantum; an inter block of 8x8 or
        more that codes no coefficient is skipped after the fact
        (vp9block.c:1310-1314);
  DONE  the tile is drained (or the lane stopped on an error).

Outputs per lane: block records in the native 34-column layout (row,
col, tile_col_start, bs, seg, skip, intra, tx, uvtx, mode[4], uvmode,
comp, ref[2], filter, mv[4][2][2]), nonzero coefficient pairs (flat
plane position with its plane base, dequantized value), eob pairs (flat
eob-grid position with its plane base, count), the symbol counts of the
vp9prob.c taxonomy when the frame adapts, and an error word; on inter
frames also the frame's MV and reference grids, in the host decoder's
layout (codecs/vp9/decoder.py Frame.mv and Frame.refs), as the native
pass A leaves them (vp9block.c:777-801).

`decode_frame` runs the walk: on a CUDA device one launch of the
hand-written kernel csrc/passa.cu (a block of one warp a lane, one
thread walking it with its contexts in shared memory, the warp joining
for an inter block's MV candidate scan and grid writes; its tables as
packed_scans and coef16_rows stage them), on the CPU the
plain version `decode_frame_plain`, which runs the same phase machine a
lane after another in Python integers, as the kernel's threads do. (The
JAX walk's lockstep form, every lane's state a tensor and every branch a
mask, pays an eager PyTorch dispatch for each of some hundred operations
a step, a step a scan position: far too slow for the CPU tests.) Kernel
launches are counted in LAUNCHES.

The bool reads differ in form and not in value: the plain version's is
the JAX walk's halfword-fed decoder (_rac_get_prob), resumed from a host
snapshot after each tile's marker bool, its bit buffer masked to 32
bits; the kernel's is csrc/rac_window.cuh's byte-fed Window, started at
the tile's first byte, reading the marker itself. Both take the spec
decoder's bits: the first byte that would make them differ (0xff) sets
the marker, an error on either.

Reference: vp9block.c:80-923 (decode_mode / decode_coeffs /
decode_block), vp9.c:1115-1193 (decode_sb), vp9mvs.c:37-365 (MV
prediction and decode), vp9prob.c (the count taxonomy), vpx_rac.h:83-94
(the bool decoder).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _cuda
from ..codecs.vp9 import tables as T
from ..codecs.vp9.blockdec import (ABOVE_CTX, LEFT_CTX, MAX_TX_FOR_BL_BP,
                                   BAND_COUNTS, INTER_MODE_CTX_LUT)
from ..codecs.vp9.mvs import MV_REF_BLK_OFF

# phases (the numbering of the JAX walk)
PART, MODE, COEF, DONE, MV = 0, 1, 2, 3, 4

# err bits of a lane
ERR_OVERFLOW, ERR_END, ERR_MARKER = 1, 2, 4

# kernel launches of decode_frame since the last reset_launches()
LAUNCHES = {"passa": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# static tables


def _band_tables():
    """[4, 1024] band index at each scan position per tx size."""
    out = np.zeros((4, 1024), np.int32)
    for tx in range(4):
        n = (4 << tx) ** 2
        counts = BAND_COUNTS[tx]
        band, left = 0, counts[0]
        for i in range(n):
            out[tx, i] = min(band, 5)
            left -= 1
            if not left and band < 5:
                band += 1
                left = counts[band]
    return out


_BANDS = _band_tables()
_BWH = np.asarray(T.BWH_TAB, np.int32)          # [2][13][2]
_MAXTX = np.asarray(MAX_TX_FOR_BL_BP, np.int32)
_ACTX = np.asarray(ABOVE_CTX, np.int32)
_LCTX = np.asarray(LEFT_CTX, np.int32)
_ITX = np.asarray(T.INTRA_TXFM_TYPE, np.int32)  # mode -> txtype


def _tree_arrays(tree):
    """(tree [N, 2] int32, the most bools a symbol takes)."""
    t = np.asarray(tree, np.int32)

    def depth(i):
        if i <= 0:
            return 0
        best = 0
        for b in range(2):
            n = t[i][b]
            best = max(best, 1 + (depth(n) if n > 0 else 0))
        return best
    d = 1 + max((depth(t[0][b]) if t[0][b] > 0 else 0) for b in range(2))
    return t, d


_PTREE, _PDEPTH = _tree_arrays(T.PARTITION_TREE)
_MTREE, _MDEPTH = _tree_arrays(T.INTRAMODE_TREE)
_STREE, _SDEPTH = _tree_arrays(T.SEGMENTATION_TREE)
_IMTREE, _IMDEPTH = _tree_arrays(T.INTER_MODE_TREE)
_FTREE, _FDEPTH = _tree_arrays(T.FILTER_TREE)
_JTREE, _JDEPTH = _tree_arrays(T.MV_JOINT_TREE)
_CLTREE, _CLDEPTH = _tree_arrays(T.MV_CLASS_TREE)
_FPTREE, _FPDEPTH = _tree_arrays(T.MV_FP_TREE)
# size group of a block size (an inter frame's y-mode context)
_SZGROUP = np.asarray([3, 3, 3, 3, 2, 2, 2, 1, 1, 1, 0, 0, 0], np.int32)
_FLUT = np.asarray(T.FILTER_LUT, np.int32)          # filter symbol -> type
_IMCTX = np.asarray(INTER_MODE_CTX_LUT, np.int32)   # [14, 14]
# the inter-mode context reads the above/left mode context this far into
# a 64x64 or 32x32 block (SUB8X8_OFF, vp9block.c:584)
_MOFF = np.asarray([3, 0, 0, 1] + [0] * 9, np.int32)
# the mv and mode slot each sub-block takes after the MV phase
# (vp9block.c:732-766): 8x4 copies slots 0 and 2, 4x8 slots 0 and 1
_SUBSRC = np.asarray([[0, 0, 0, 0]] * 10 + [[0, 0, 2, 2], [0, 1, 0, 1],
                                            [0, 1, 2, 3]], np.int32)
# find_ref_mvs' candidates (vp9mvs.c:37-234) as a fixed list of 32 slots
# walked in order, the first that returns ending the scan. Kinds: 0 a
# direct sub-block mv of this block, 1 the above mv context, 2 the left
# one, 3 a spatial neighbour with the same reference, 4 the previous
# frame's mv here with the same reference, 5/6 a spatial neighbour's
# first/second mv with another reference, 7/8 the previous frame's.
# PAR: the direct slot's sub-block, or the neighbour's MV_REF_BLK_OFF row.
_SLOT_KIND = np.asarray([0, 0, 0, 1, 2] + [3] * 8 + [4]
                        + [v for _i in range(8) for v in (5, 6)] + [7, 8],
                        np.int32)
_SLOT_PAR = np.asarray([2, 1, 0, 0, 0] + list(range(8)) + [0]
                       + [i for i in range(8) for _ in (0, 1)] + [0, 0],
                       np.int32)
_MVREF = np.asarray(MV_REF_BLK_OFF, np.int32)       # [13, 8, (col, row)]

_CAT6_8 = [254, 254, 254, 252, 249, 243, 230, 196, 177, 153,
           140, 133, 130, 129]
_CAT6 = {8: _CAT6_8, 10: [255, 255] + _CAT6_8,
         12: [255, 255, 255, 255] + _CAT6_8}
_CAT_PROBS = [[], [159], [165, 145], [173, 148, 140],
              [176, 155, 140, 135], [180, 157, 141, 134, 130]]
_CAT_BASE = np.asarray([0, 5, 7, 11, 19, 35, 67], np.int32)
_CAT_NBITS = {b: np.asarray([0, 1, 2, 3, 4, 5, len(_CAT6[b])], np.int32)
              for b in (8, 10, 12)}


def _cat_table(bpp):
    """[7, K] per-class extra-bit prob ladders (row 0 unused)."""
    rows = _CAT_PROBS + [_CAT6[bpp]]
    K = len(_CAT6[bpp])
    out = np.zeros((7, K), np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


# flattened per-lane symbol-count layout mirroring codecs/vp9/counts.py
# (the full vp9prob.c count taxonomy); merged across lanes on the host
# (the vp9.c:1816-1819 tile merge)
_CNT_SPEC = [
    ("y_mode", (4, 10)), ("uv_mode", (10, 10)), ("filter", (4, 3)),
    ("mv_mode", (7, 4)), ("intra", (4, 2)), ("comp", (5, 2)),
    ("single_ref", (5, 2, 2)), ("comp_ref", (5, 2)),
    ("tx32p", (2, 4)), ("tx16p", (2, 3)), ("tx8p", (2, 2)),
    ("skip", (3, 2)), ("mv_joint", (4,)), ("partition", (4, 4, 4)),
    ("coef", (4, 2, 2, 6, 6, 3)), ("eob", (4, 2, 2, 6, 6, 2)),
    ("mv_sign", (2, 2)), ("mv_classes", (2, 11)),
    ("mv_class0", (2, 2)), ("mv_bits", (2, 10, 2)),
    ("mv_class0_fp", (2, 2, 4)), ("mv_fp", (2, 4)),
    ("mv_class0_hp", (2, 2)), ("mv_hp", (2, 2)),
]
CNT_OFF = {}
_o = 0
for _n, _sh in _CNT_SPEC:
    CNT_OFF[_n] = _o
    _o += int(np.prod(_sh))
CNT_TOTAL = _o
CNT_COEF = CNT_OFF["coef"]
CNT_EOB = CNT_OFF["eob"]
del _o, _n, _sh


def counts_from_device(cnt_lanes, out):
    """Sum per-lane counts [S, CNT_TOTAL] into a Counts object (in
    place)."""
    tot = np.asarray(cnt_lanes, np.int64).sum(axis=0)
    for n, sh in _CNT_SPEC:
        o = CNT_OFF[n]
        getattr(out, n)[...] = tot[o:o + int(np.prod(sh))].reshape(sh)
    return out


_SC_CACHE = None


def _scans_i32():
    """(scans [20, 1024], neighbours [20, 1024, 2]) int32, row (4 *
    lossless + tx) * 4 + txtype."""
    global _SC_CACHE
    if _SC_CACHE is None:
        from ..passa_native import _padded_scans
        sc, nb = _padded_scans()
        _SC_CACHE = (np.asarray(sc, np.int32).reshape(20, 1024),
                     np.asarray(nb, np.int32).reshape(20, 1024, 2))
    return _SC_CACHE


# ---------------------------------------------------------------------------
# host preparation


def tile_lanes(dec, data):
    """The tiles of a frame's packet as lanes: [(tile bytes, offset of
    the tile in the packet, r0, r1, c0, c1)] in tile order (b8 bounds).
    Raises ValueError on a tile size that the packet does not hold, as
    the host pass A does (codecs/vp9/decoder.py _decode_tiles)."""
    from ..codecs.vp9.decoder import _tile_offset
    h = dec.header
    base = h.uncompressed_header_size + h.compressed_header_size
    tile_data = data[base:]
    size = len(tile_data)
    pos = 0
    lanes = []
    for tr in range(h.tile_rows):
        r0, r1 = _tile_offset(tr, h.log2_tile_rows, dec.sb_rows)
        for tc in range(h.tile_cols):
            if tc == h.tile_cols - 1 and tr == h.tile_rows - 1:
                tsz = size - pos
            else:
                if pos + 4 > size:
                    raise ValueError("truncated tile header")
                tsz = int.from_bytes(tile_data[pos:pos + 4], "big")
                pos += 4
            if tsz > size - pos:
                raise ValueError("invalid tile size")
            c0, c1 = _tile_offset(tc, h.log2_tile_cols, dec.sb_cols)
            lanes.append((tile_data[pos:pos + tsz], base + pos, r0, r1,
                          c0, c1))
            pos += tsz
    return lanes


def prep_keyframe(dec, data):
    """Host prep after the headers of an intra frame are parsed (the
    decoder `dec` has header, probs, coef11 and geometry set for this
    frame): the per-tile bool streams and every probability table the
    walk needs. Returns (inputs, meta) for decode_frame."""
    h = dec.header
    if not (h.keyframe or h.intraonly):
        raise ValueError("prep_keyframe takes keyframes and intra-only "
                         "frames")
    return _prep_common(dec, data)


def prep_inter(dec, data):
    """Host prep of an inter frame (neither keyframe nor intra-only):
    prep_keyframe's inputs plus inputs["aux"], the frame's probability
    set, the coefficient probabilities of both reference kinds, the
    previous frame's MV, reference and segmentation grids (the JAX
    walk's layout: a cell a row of rows x cols, padded to gmax rows),
    and the header scalars the inter syntax reads (vp9block.c:80-802,
    vp9mvs.c); meta gains inter=1 and gmax. The previous grids are
    those the decoder's state names: its prev_mv and prev_ref when the
    frame uses the last frame's MVs, its prev_segmap unless the frame is
    error resilient. aux is JAX's array for array; the port's walks read
    the previous grids in the host layout instead, the frame's own
    grids' (grid_shapes): inputs["prev_grids"] holds the decoder's
    arrays (prev_mv, prev_ref, prev_segmap), each None where the frame
    does not read it."""
    h = dec.header
    if h.keyframe or h.intraonly:
        raise ValueError("prep_inter takes inter frames")
    inputs, meta = _prep_common(dec, data)
    p = dec.probs
    rows, cols = dec.rows, dec.cols
    gmax = 1024
    while gmax < rows * cols:
        gmax *= 2
    prev_mv = np.zeros((gmax, 2, 2), np.int32)
    prev_ref = np.full((gmax, 2), -1, np.int32)
    prev_seg = np.zeros(gmax, np.int32)
    use_prev = int(h.use_last_frame_mvs and dec.prev_mv is not None)
    if use_prev:
        prev_mv[:rows * cols] = np.asarray(
            dec.prev_mv[:rows, :cols], np.int32).reshape(-1, 2, 2)
        prev_ref[:rows * cols] = np.asarray(
            dec.prev_ref[:rows, :cols], np.int32).reshape(-1, 2)
    have_prevseg = int(not h.errorres and dec.prev_segmap is not None)
    if have_prevseg:
        prev_seg[:rows * cols] = np.asarray(
            dec.prev_segmap[:rows, :cols], np.int32).reshape(-1)
    # a frame reads the previous grids only at its own size (the header's
    # use_last_frame_mvs asks for it; the decoder drops its segmap frame
    # on a size change)
    grids = (dec.prev_mv if use_prev else None,
             dec.prev_ref if use_prev else None,
             dec.prev_segmap if have_prevseg else None)
    for g in grids:
        if g is not None and g.shape[:2] != (dec.sb_rows * 8,
                                             dec.sb_cols * 8):
            raise ValueError("a previous grid of another frame size")
    inputs["prev_grids"] = grids
    segf = h.seg_feat
    refseg_en = np.zeros(8, np.int32)
    refseg_val = np.zeros(8, np.int32)
    for sid in range(8):
        refseg_en[sid] = int(h.seg_enabled and segf[sid].ref_enabled)
        refseg_val[sid] = int(segf[sid].ref_val)
    hflags = np.asarray([
        int(h.seg_enabled), int(h.seg_update_map), int(h.seg_temporal),
        have_prevseg, int(h.comppredmode), int(h.fixcompref),
        int(h.varcompref[0]), int(h.varcompref[1]),
        int(h.signbias[0]), int(h.signbias[1]), int(h.signbias[2]),
        int(h.filtermode), int(h.highprecisionmvs), use_prev,
    ], np.int32)
    i32 = np.int32
    inputs["aux"] = dict(
        coef11i=np.asarray(dec.coef11, i32).reshape(16, 36, 11),
        prev_mv=prev_mv, prev_ref=prev_ref, prev_seg=prev_seg,
        hflags=hflags, refseg_en=refseg_en, refseg_val=refseg_val,
        segpredp=np.asarray(h.seg_pred_prob, i32),
        partp=np.asarray(p.partition, i32),
        intrap=np.asarray(p.intra, i32),
        compp=np.asarray(p.comp, i32),
        comprefp=np.asarray(p.comp_ref, i32),
        singlerefp=np.asarray(p.single_ref, i32),
        ymodep=np.asarray(p.y_mode, i32),
        uvmodep=np.asarray(p.uv_mode, i32),
        mvmodep=np.asarray(p.mv_mode, i32),
        filterp=np.asarray(p.filter, i32),
        mvjointp=np.asarray(p.mv_joint, i32),
        mvsignp=np.asarray(p.mv_sign, i32),
        mvclassesp=np.asarray(p.mv_classes, i32),
        mvclass0p=np.asarray(p.mv_class0, i32),
        mvbitsp=np.asarray(p.mv_bits, i32),
        mvc0fpp=np.asarray(p.mv_class0_fp, i32),
        mvfpp=np.asarray(p.mv_fp, i32),
        mvc0hpp=np.asarray(p.mv_class0_hp, i32),
        mvhpp=np.asarray(p.mv_hp, i32),
    )
    meta["inter"] = 1
    meta["gmax"] = gmax
    return inputs, meta


def _prep_common(dec, data):
    from ..codecs.vp9.rac import BoolDecoder
    from .rac import pack_windows, snapshot_to_state
    h = dec.header
    lanes = tile_lanes(dec, data)
    S = len(lanes)
    snaps = []
    for d, *_ in lanes:
        bd = BoolDecoder(d)
        if bd.get():
            raise ValueError("marker bit set in tile")
        snaps.append((d, bd.byte_pos, bd.bit_pos, bd.value, bd.range))
    starts = [s[1] + (1 if s[2] else 0) for s in snaps]
    half16 = pack_windows([s[0] for s in snaps], starts)
    value0, rng0, bitbuf0, nbits0 = snapshot_to_state(snaps, starts)

    p = dec.probs
    # coef probs for is_inter=0, flattened rows [8(tx*2+pl), 36, 11]
    coef11 = np.asarray(dec.coef11, np.int32) \
        .reshape(4, 2, 2, 6, 6, 11)[:, :, 0] \
        .reshape(8, 36, 11)
    segf = h.seg_feat
    qmul = np.zeros((8, 4), np.int32)
    skipseg = np.zeros(8, np.int32)
    for sid in range(8):
        qmul[sid] = np.asarray(segf[sid].qmul, np.int32).reshape(4)
        skipseg[sid] = int(h.seg_enabled and segf[sid].skip_enabled)
    sc, nb = _scans_i32()
    inputs = dict(
        half16=half16,
        rac0=np.stack([value0, rng0, bitbuf0, nbits0,
                       np.zeros(S, np.int32)]),
        # b8 units (the _tile_offset values are already b8)
        bounds=np.asarray([[r0, r1, c0, c1]
                           for _d, _o, r0, r1, c0, c1 in lanes], np.int32),
        skipp=np.asarray(p.skip, np.int32),
        tx8p=np.asarray(p.tx8p, np.int32).reshape(2, -1),
        tx16p=np.asarray(p.tx16p, np.int32).reshape(2, -1),
        tx32p=np.asarray(p.tx32p, np.int32).reshape(2, -1),
        coef11=coef11,
        qmul=qmul,
        skipseg=skipseg,
        segprob=np.asarray(
            h.seg_prob if h.seg_enabled and h.seg_update_map
            else [128] * 7, np.int32),
        scans=sc,
        nbs=nb,
        # the kernel's form of the streams: the packet and each tile's
        # place in it; the plain version's end test: each window's
        # first byte and each tile's size
        packet=np.frombuffer(bytearray(data), np.uint8),
        tile_off=np.asarray([o for _d, o, *_r in lanes], np.int64),
        tile_len=np.asarray([len(d) for d, *_r in lanes], np.int32),
        win_start=np.asarray(starts, np.int32),
    )
    meta = dict(S=S, rows=dec.rows, cols=dec.cols,
                seg=int(h.seg_enabled and h.seg_update_map),
                txfmmode=int(h.txfmmode), lossless=int(h.lossless),
                bpp=int(h.bpp), ss_h=int(h.ss_h), ss_v=int(h.ss_v),
                sb_cols=dec.sb_cols, sb_rows=dec.sb_rows,
                # backward adaptation consumes symbol counts
                # (vp9.c:1821-1824); emit them only when it will run
                want_counts=int(h.refreshctx and not h.parallelmode))
    return inputs, meta


def lane_caps(inputs, meta):
    """The output rows a lane can need, from its tile alone: (blocks,
    coefficient pairs, eob pairs) [S] int64. A block covers at least
    one 8x8 cell of its tile; a nonzero coefficient or a coded 4x4 eob
    cell is one distinct position of the tile's superblock-aligned
    area in one plane (luma, and both chroma planes at the frame's
    subsampling). So no lane can overflow them."""
    b = np.asarray(inputs["bounds"], np.int64)
    cells = (b[:, 1] - b[:, 0]) * (b[:, 3] - b[:, 2])
    ss = meta["ss_h"] + meta["ss_v"]
    luma = 64 * cells
    cells4 = 4 * cells
    return (cells, luma + 2 * (luma >> ss), cells4 + 2 * (cells4 >> ss))


def _frame_dims(meta):
    """Flat plane and eob-grid sizes: (W64, W64uv, c16, c16uv, ysz, usz,
    eysz, eusz)."""
    ss_h, ss_v = meta["ss_h"], meta["ss_v"]
    W64 = meta["sb_cols"] * 64
    H64 = meta["sb_rows"] * 64
    W64uv = W64 >> ss_h
    c16 = meta["sb_cols"] * 16
    c16uv = c16 >> ss_h
    ysz = H64 * W64
    usz = (H64 >> ss_v) * W64uv
    eysz = (H64 // 4) * c16
    eusz = ((H64 >> ss_v) // 4) * c16uv
    return W64, W64uv, c16, c16uv, ysz, usz, eysz, eusz


# ---------------------------------------------------------------------------
# the plain version: each lane's phase machine, one lane after another


_NORM = [int(v) for v in T.NORM_SHIFT]   # 8 - bit_length(range)


def _i32(v):
    """v as a wrapping int32."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


class _Tables:
    """A frame's tables as Python lists, shared by its lanes."""

    def __init__(self, inputs, meta):
        def lst(a):
            return np.asarray(a).astype(np.int64).tolist()
        self.skipp = lst(inputs["skipp"])
        self.tx8p, self.tx16p, self.tx32p = (
            lst(inputs[k]) for k in ("tx8p", "tx16p", "tx32p"))
        self.qmul = lst(inputs["qmul"])
        self.skipseg = lst(inputs["skipseg"])
        self.segprob = lst(inputs["segprob"])
        self.scans = lst(np.asarray(inputs["scans"]).reshape(-1))
        self.nbs = lst(np.asarray(inputs["nbs"]).reshape(-1))
        self.kf_ym = lst(T.DEFAULT_KF_YMODE_PROBS)           # [10][10][9]
        self.kf_uvm = lst(T.DEFAULT_KF_UVMODE_PROBS)         # [10][9]
        self.bwh = lst(_BWH)
        self.bands = lst(_BANDS.reshape(-1))
        self.cat = lst(_cat_table(meta["bpp"]))
        self.catn = lst(_CAT_NBITS[meta["bpp"]])
        aux = inputs.get("aux") if meta.get("inter") else None
        if aux is None:
            # coefficient rows (tx * 2 + plane type) * 2 + is_inter: an
            # intra frame's blocks take the is_inter=0 rows alone
            coef = np.zeros((8, 2, 36, 11), np.int64)
            coef[:, 0] = np.asarray(inputs["coef11"]).reshape(8, 36, 11)
            self.coef = lst(coef.reshape(576, 11))
            self.part = lst(T.DEFAULT_KF_PARTITION_PROBS)    # [4][4][3]
            return
        self.coef = lst(np.asarray(aux["coef11i"]).reshape(576, 11))
        self.part = lst(aux["partp"])
        for k in ("hflags", "refseg_en", "refseg_val", "segpredp", "intrap",
                  "compp", "comprefp", "singlerefp", "ymodep", "uvmodep",
                  "mvmodep", "filterp", "mvjointp", "mvsignp", "mvclassesp",
                  "mvclass0p", "mvbitsp", "mvc0fpp", "mvfpp", "mvc0hpp",
                  "mvhpp"):
            setattr(self, k, lst(aux[k]))
        # the previous grids in the host layout, C8 cells a row, as the
        # frame's own (empty where the frame reads none)
        pmv, pref, pseg = inputs["prev_grids"]
        self.prev_mv = [] if pmv is None else lst(pmv.reshape(-1, 4))
        self.prev_ref = [] if pref is None else lst(pref.reshape(-1, 2))
        self.prev_seg = [] if pseg is None else lst(pseg.reshape(-1))
        self.mvref = lst(_MVREF)
        self.imctx = lst(_IMCTX)


def _walk_lane(tb, meta, half16, rac0, win_start, tile_len, bounds, caps,
               grid):
    """One lane's walk (the kernel's thread): its records, coefficient
    and eob pairs, counts, err word and bools read, as lists. On an
    inter frame `grid` is the frame's (mv, ref) grids as flat lists in
    the host layout, which the lane writes its blocks into."""
    rows, cols = meta["rows"], meta["cols"]
    ss_h, ss_v, bpp = meta["ss_h"], meta["ss_v"], meta["bpp"]
    lossless, txfmmode = meta["lossless"], meta["txfmmode"]
    seg, want_counts = meta["seg"], meta["want_counts"]
    inter = bool(meta.get("inter"))
    W64, W64uv, c16, c16uv, ysz, usz, eysz, eusz = _frame_dims(meta)
    bcap, ccap, ecap = caps
    r0, r1, c0, c1 = bounds
    h16 = half16
    Lh = len(h16)
    NORM = _NORM
    # the halfword-fed decoder (the JAX walk's), resumed after the
    # marker; the bit buffer is kept to its low 32 bits
    value, rng, bitbuf, nbits, pos = rac0
    bools = 0

    def rd(prob):
        nonlocal value, rng, bitbuf, nbits, pos, bools
        if nbits < 8:
            bitbuf = ((bitbuf << 16) | (h16[pos] if pos < Lh else 0)) \
                & 0xFFFFFFFF
            nbits += 16
            pos += 1
        split = 1 + (((rng - 1) * prob) >> 8)
        if value >= split:
            value -= split
            r = rng - split
            bit = 1
        else:
            r = split
            bit = 0
        sh = NORM[r]
        value = (value << sh) | ((bitbuf >> (nbits - sh)) & ((1 << sh) - 1))
        rng = r << sh
        nbits -= sh
        bools += 1
        return bit

    def tree(t, probs):
        i = 0
        while True:
            n = t[i][rd(probs[i])]
            if n <= 0:
                return -n
            i = n

    ptree, mtree, stree = (_PTREE.tolist(), _MTREE.tolist(),
                           _STREE.tolist())
    cnts = [0] * CNT_TOTAL
    O = CNT_OFF
    blocks, cpairs, epairs = [], [], []
    # above ctx, frame-absolute; left ctx, per superblock row. The mode
    # contexts start at DC_PRED on intra frames, NEARESTMV on inter
    # frames (vp9.c:1720-1730)
    mode0 = 10 if inter else 2
    W = cols + 16
    a_part, a_skip, a_txfm = [0] * W, [0] * W, [0] * W
    a_mode = [mode0] * (2 * W)
    a_nnz = [[0] * (2 * W) for _ in range(3)]
    l_part, l_skip, l_txfm = [0] * 8, [0] * 8, [0] * 8
    l_mode = [mode0] * 16
    l_nnz = [[0] * 16 for _ in range(3)]
    if inter:
        (seg_en, seg_upd, seg_tmp, have_pseg, comppredmode, fixref,
         varref0, varref1, sb0, sb1, sb2, filtermode, highprec,
         use_prev) = tb.hflags
        sbias = (sb0, sb1, sb2)
        imtree, ftree, jtree = (_IMTREE.tolist(), _FTREE.tolist(),
                                _JTREE.tolist())
        cltree, fptree = _CLTREE.tolist(), _FPTREE.tolist()
        gmv, gref = grid
        C8 = meta["sb_cols"] * 8
        a_intra, a_comp, a_ref, a_filter, a_segpred = (
            [0] * W for _ in range(5))
        l_intra, l_comp, l_ref, l_filter, l_segpred = (
            [0] * 8 for _ in range(5))
        zero2 = ((0, 0), (0, 0))
        a_mv = [zero2] * (2 * W)        # [ref][x, y] a 4x4 column
        l_mv = [zero2] * 16
    # the current block; on inter frames its fields that a block does not
    # write keep the last block's values, as the reference's one Block
    b_uvmode, b_comp, b_ref, b_filter, b_filterid = 0, 0, [0, 0], 0, 0
    b_mv = [[(0, 0), (0, 0)] for _ in range(4)]
    b_modectx = anycoef = intra = 0
    mv_k = mv_z = 0
    bwh = tb.bwh
    err = 0
    phase = PART
    sb_r, sb_c = r0, c0
    stack = []          # partition nodes: [bl, r, c, bp, emitted]

    def read_mv_comp(comp, hp):
        """One MV component (vp9mvs.c:236-289), with libvpx's count of
        an hp bit that is not coded (vp9mvs.c:263-266)."""
        sign = rd(tb.mvsignp[comp])
        cl = tree(cltree, tb.mvclassesp[comp])
        if want_counts:
            cnts[O["mv_sign"] + comp * 2 + sign] += 1
            cnts[O["mv_classes"] + comp * 11 + cl] += 1
        if cl:
            n = 0
            for m in range(cl):
                bit = rd(tb.mvbitsp[comp][m])
                n |= bit << m
                if want_counts:
                    cnts[O["mv_bits"] + comp * 20 + m * 2 + bit] += 1
            fp = tree(fptree, tb.mvfpp[comp])
            hpb = rd(tb.mvhpp[comp]) if hp else 1
            n = ((n << 3) | (fp << 1) | hpb) + (8 << cl)
            if want_counts:
                cnts[O["mv_fp"] + comp * 4 + fp] += 1
                cnts[O["mv_hp"] + comp * 2 + hpb] += 1
        else:
            n0 = rd(tb.mvclass0p[comp])
            fp = tree(fptree, tb.mvc0fpp[comp][n0])
            hpb = rd(tb.mvc0hpp[comp]) if hp else 1
            n = (n0 << 3) | (fp << 1) | hpb
            if want_counts:
                cnts[O["mv_class0"] + comp * 2 + n0] += 1
                cnts[O["mv_class0_fp"] + comp * 8 + n0 * 4 + fp] += 1
                cnts[O["mv_class0_hp"] + comp * 2 + hpb] += 1
        return -(n + 1) if sign else n + 1

    def find_ref_mv(refz, z, idxn, sbp):
        """find_ref_mvs (vp9mvs.c:37-234) over the 32 candidate slots:
        the predicted (x, y) for reference `refz`, NEARMV's second
        distinct candidate when idxn, sub-block sbp (-1: the whole
        block), with the reference decoder's quirks."""
        bw8, bh8 = bwh[1][bs]
        minx, miny = -(128 + bc * 64), -(128 + br * 64)
        maxx = 128 + (cols - bc - bw8) * 64
        maxy = 128 + (rows - br - bh8) * 64
        offs = tb.mvref[bs]
        sbc = min(max(sbp, 0), 3)
        pi = br * C8 + bc
        msets = m8s = False
        mx = my = m8x = m8y = 0
        for j in range(32):
            kind, par = _SLOT_KIND_L[j], _SLOT_PAR_L[j]
            flip = False
            if kind == 0:
                if not (sbp >= 1 if par == 0 else sbp == 3):
                    continue
                vx, vy = b_mv[par][z]
            elif kind == 1 or kind == 2:
                if sbp < 0 or (br == 0 if kind == 1 else bc <= c0):
                    continue
                gi = (br - 1) * C8 + bc if kind == 1 else br * C8 + bc - 1
                g0, g1 = gref[2 * gi], gref[2 * gi + 1]
                if g0 != refz and g1 != refz:
                    continue
                ctx = a_mv[2 * bc + (sbc & 1)] if kind == 1 \
                    else l_mv[2 * row7 + (sbc >> 1)]
                vx, vy = ctx[0 if g0 == refz else 1]
            elif kind == 3 or kind == 5 or kind == 6:
                if kind == 3 and sbp >= 0 and par < 2:
                    continue
                nc, nr = bc + offs[par][0], br + offs[par][1]
                if not (c0 <= nc < cols and 0 <= nr < rows):
                    continue
                gi = nr * C8 + nc
                g0, g1 = gref[2 * gi], gref[2 * gi + 1]
                v0 = (gmv[4 * gi], gmv[4 * gi + 1])
                v1 = (gmv[4 * gi + 2], gmv[4 * gi + 3])
                if kind == 3:
                    if g0 != refz and g1 != refz:
                        continue
                    vx, vy = v0 if g0 == refz else v1
                elif kind == 5:
                    if g0 < 0 or g0 == refz:
                        continue
                    vx, vy = v0
                    flip = sbias[g0] != sbias[refz]
                else:
                    # libvpx's condition, whether or not the first mv was
                    # taken (vp9mvs.c:206-208)
                    if g1 < 0 or g1 == refz or v0 == v1:
                        continue
                    vx, vy = v1
                    flip = sbias[g1] != sbias[refz]
            else:
                if not use_prev:
                    continue
                p0, p1 = tb.prev_ref[pi]
                pm = tb.prev_mv[pi]
                v0, v1 = (pm[0], pm[1]), (pm[2], pm[3])
                if kind == 4:
                    if p0 != refz and p1 != refz:
                        continue
                    vx, vy = v0 if p0 == refz else v1
                elif kind == 7:
                    if p0 < 0 or p0 == refz:
                        continue
                    vx, vy = v0
                    flip = sbias[p0] != sbias[refz]
                else:
                    if p1 < 0 or p1 == refz or v0 == v1:
                        continue
                    vx, vy = v1
                    flip = sbias[p1] != sbias[refz]
            if flip:
                vx, vy = -vx, -vy
            if kind == 0:
                # RETURN_DIRECT_MV: unclamped
                if not idxn:
                    return vx, vy
                if not msets:
                    msets, mx, my = True, vx, vy
                elif (vx, vy) != (mx, my):
                    return vx, vy
                continue
            # RETURN_MV: clamped; a sub-block past the first compares in
            # two stages, with libvpx's zero return
            cx = min(max(vx, minx), maxx)
            cy = min(max(vy, miny), maxy)
            if sbp > 0:
                memdif = not msets or (cx, cy) != (mx, my)
                if not m8s:
                    if memdif:
                        return cx, cy
                    m8s, m8x, m8y = True, vx, vy
                elif (vx, vy) != (m8x, m8y):
                    return (cx, cy) if memdif else (0, 0)
            elif not idxn:
                return cx, cy
            elif not msets:
                msets, mx, my = True, vx, vy
            elif (vx, vy) != (mx, my):
                return cx, cy
        return min(max(0, minx), maxx), min(max(0, miny), maxy)

    def splat(arr, b0, v, n):
        arr[b0:b0 + n] = [v] * n

    def set_ctxs_nonkf():
        """The non-keyframe SET_CTXS and the write-back of the block's
        mvs and references into the frame grid (vp9block.c:682-801)."""
        nw, nh = bwh[1][bs]
        w4c, h4c = min(cols - bc, nw), min(rows - br, nh)
        splat(a_intra, bc, intra, nw)
        splat(a_comp, bc, b_comp, nw)
        splat(a_mode, bc, modes[3], nw)
        splat(l_intra, row7, intra, nh)
        splat(l_comp, row7, b_comp, nh)
        splat(l_mode, row7, modes[3], nh)
        if not intra:
            vref = b_ref[sbias[varref0]] if b_comp else b_ref[0]
            splat(a_ref, bc, vref, nw)
            splat(l_ref, row7, vref, nh)
            if filtermode == 4:
                splat(a_filter, bc, b_filterid, nw)
                splat(l_filter, row7, b_filterid, nh)
            mv1, mv2, mv3 = (tuple(b_mv[q]) for q in (1, 2, 3))
            if bs > 9:
                l_mv[2 * row7], l_mv[2 * row7 + 1] = mv1, mv3
                a_mv[2 * bc], a_mv[2 * bc + 1] = mv2, mv3
            else:
                splat(a_mv, 2 * bc, mv3, 2 * w4c)
                splat(l_mv, 2 * row7, mv3, 2 * h4c)
        g0 = -1 if intra else b_ref[0]
        g1 = b_ref[1] if not intra and b_comp else -1
        for y in range(h4c):
            for x in range(w4c):
                gi = (br + y) * C8 + bc + x
                gref[2 * gi], gref[2 * gi + 1] = g0, g1
                if not intra:
                    gmv[4 * gi], gmv[4 * gi + 1] = b_mv[3][0]
                    if b_comp:
                        gmv[4 * gi + 2], gmv[4 * gi + 3] = b_mv[3][1]

    def record():
        if inter:
            tail = [b_uvmode, b_comp, b_ref[0], b_ref[1], b_filter] \
                + [v for q in range(4) for p in b_mv[q] for v in p]
        else:
            tail = [b_uvmode] + [0] * 20
        return [br, bc, c0, bs, seg_id, skip, intra, tx, uvtx] + modes \
            + tail

    def zero_nnz():
        """A skipped block zeroes its nnz contexts (vp9block.c:1316)."""
        bw4, bh4 = bwh[1][bs]
        for arr, b0, n in ((a_nnz[0], bc * 2, bw4 * 2),
                           (l_nnz[0], row7 * 2, bh4 * 2),
                           (a_nnz[1], (bc * 2) >> ss_h, (bw4 * 2) >> ss_h),
                           (a_nnz[2], (bc * 2) >> ss_h, (bw4 * 2) >> ss_h),
                           (l_nnz[1], (row7 * 2) >> ss_v, (bh4 * 2) >> ss_v),
                           (l_nnz[2], (row7 * 2) >> ss_v,
                            (bh4 * 2) >> ss_v)):
            arr[b0:b0 + n] = [0] * n

    while phase != DONE:
        if phase == PART:
            if not stack:
                if sb_r >= r1:
                    phase = DONE
                    continue
                # the end test before each superblock (vp9.c:1413,
                # vpx_rac_is_end: more than 10 bits read past the end)
                if 8 * win_start + 16 * pos - nbits > 8 * tile_len + 10:
                    err |= ERR_END
                    phase = DONE
                    continue
                stack.append([0, sb_r, sb_c, -1, 0])
            node = stack[-1]
            bl, r, c, bp, em = node
            hbs = 4 >> bl
            col_in = c + hbs < cols
            row_in = r + hbs < rows
            if bp < 0:
                pctx = ((a_part[c] >> (3 - bl)) & 1) \
                    | (((l_part[r & 7] >> (3 - bl)) & 1) << 1)
                pp = tb.part[bl][pctx]
                if bl == 3 or (col_in and row_in):
                    bp = tree(ptree, pp)
                elif col_in:
                    bp = 3 if rd(pp[1]) else 1
                elif row_in:
                    bp = 3 if rd(pp[2]) else 2
                else:
                    bp = 3
                node[3] = bp
                if want_counts:
                    cnts[O["partition"] + (bl * 4 + pctx) * 4 + bp] += 1
            split = bp == 3 and bl < 3
            if split:
                kids = [(0, 0)] + ([(0, 1)] if col_in else []) \
                    + ([(1, 0)] if row_in else []) \
                    + ([(1, 1)] if col_in and row_in else [])
                n_items = len(kids)
            elif bl == 3 or bp == 0:
                n_items = 1
            else:
                n_items = 1 + (row_in if bp == 1 else col_in)
            if em >= n_items:
                # the node's items are exhausted: pop; the root's pop
                # takes the next superblock
                stack.pop()
                if not stack:
                    sb_c += 8
                    if sb_c >= c1:
                        sb_c = c0
                        sb_r += 8
                        l_part, l_skip = [0] * 8, [0] * 8
                        l_mode = [mode0] * 16
                        l_nnz = [[0] * 16 for _ in range(3)]
                        if inter:
                            l_segpred = [0] * 8
                continue
            node[4] = em + 1
            if split:
                dr, dc = kids[em]
                stack.append([bl + 1, r + dr * hbs, c + dc * hbs, -1, 0])
                continue
            br = r + (hbs if bp == 1 and em == 1 else 0)
            bc = c + (hbs if bp == 2 and em == 1 else 0)
            bs = 9 + bp if bl == 3 else (bl * 3 if bp == 0 else bl * 3 + bp)
            phase = MODE
            continue

        if phase == MODE:
            row7 = br & 7
            bw4, bh4 = bwh[1][bs]
            have_a, have_l = br > 0, bc > c0
            # --- seg id; on inter frames with temporal prediction from
            # the previous frame's map (vp9block.c:101-142) ---
            if inter:
                use_pred = m_tree = False
                if seg_en:
                    pbit = 0
                    if seg_upd and seg_tmp:
                        pbit = rd(tb.segpredp[a_segpred[bc]
                                              + l_segpred[row7]])
                    use_pred = not seg_upd or (seg_tmp and pbit)
                    m_tree = seg_upd and not (seg_tmp and pbit)
                w4c, h4c = min(cols - bc, bw4), min(rows - br, bh4)
                if use_pred:
                    # the least id of the previous map over the clipped
                    # block (vp9block.c:115-127)
                    ps = tb.prev_seg
                    seg_id = min(ps[(br + y) * C8 + bc + x]
                                 for y in range(h4c)
                                 for x in range(w4c)) if have_pseg else 0
                elif m_tree:
                    seg_id = tree(stree, tb.segprob)
                else:
                    seg_id = 0
                if seg_en:
                    splat(a_segpred, bc, int(use_pred), w4c)
                    splat(l_segpred, row7, int(use_pred), h4c)
            else:
                seg_id = tree(stree, tb.segprob) if seg else 0
            # --- skip ---
            forced_skip = tb.skipseg[seg_id]
            if forced_skip:
                skip = 1
            else:
                sctx = l_skip[row7] + a_skip[bc]
                skip = rd(tb.skipp[sctx])
                if want_counts:
                    cnts[O["skip"] + sctx * 2 + skip] += 1
            # --- the intra/inter flag (vp9block.c:283-298); the seg REF
            # feature sets it without a bool ---
            if inter:
                rs_en, rs_val = tb.refseg_en[seg_id], tb.refseg_val[seg_id]
                a_in, l_in = a_intra[bc], l_intra[row7]
                if rs_en:
                    intra = int(rs_val == 0)
                else:
                    if have_a and have_l:
                        ctx = a_in + l_in + (a_in + l_in == 2)
                    elif have_a or have_l:
                        ctx = 2 * (a_in if have_a else l_in)
                    else:
                        ctx = 0
                    ibit = rd(tb.intrap[ctx])
                    intra = 1 - ibit
                    if want_counts:
                        cnts[O["intra"] + ctx * 2 + ibit] += 1
            else:
                intra = 1
            # --- tx size: coded when switchable, on an inter frame only
            # for intra blocks and blocks that are not skipped ---
            mtx = _MAXTX[bs]
            if txfmmode == 4 and (intra or not skip):
                a_sk, l_sk = a_skip[bc], l_skip[row7]
                a_t = mtx if a_sk else a_txfm[bc]
                l_t = mtx if l_sk else l_txfm[row7]
                if have_a and have_l:
                    txctx = int(a_t + l_t > mtx)
                elif have_a:
                    txctx = 1 if a_sk else int(a_t * 2 > mtx)
                elif have_l:
                    txctx = 1 if l_sk else int(l_t * 2 > mtx)
                else:
                    txctx = 1
                if mtx == 3:
                    p = tb.tx32p[txctx]
                    tx = rd(p[0])
                    if tx:
                        tx += rd(p[1])
                        if tx == 2:
                            tx += rd(p[2])
                    cidx = O["tx32p"] + txctx * 4 + tx
                elif mtx == 2:
                    p = tb.tx16p[txctx]
                    tx = rd(p[0])
                    if tx:
                        tx += rd(p[1])
                    cidx = O["tx16p"] + txctx * 3 + tx
                elif mtx == 1:
                    tx = rd(tb.tx8p[txctx][0])
                    cidx = O["tx8p"] + txctx * 2 + tx
                else:
                    tx, cidx = 0, -1
                if want_counts and cidx >= 0:
                    cnts[cidx] += 1
            else:
                tx = min(mtx, txfmmode)
            uvtx = tx - int((ss_h and bw4 * 2 == (1 << tx))
                            or (ss_v and bh4 * 2 == (1 << tx)))
            if not inter:
                # --- keyframe modes: the context-coupled trees ---
                a0, a1, l0, l1 = bc * 2, bc * 2 + 1, row7 * 2, row7 * 2 + 1
                kf_ym = tb.kf_ym
                if bs > 9:      # sub-8x8: per-4x4 mode slots
                    m0 = tree(mtree, kf_ym[a_mode[a0]][l_mode[l0]])
                    a_mode[a0] = m0
                    m1 = m0 if bs == 10 else \
                        tree(mtree, kf_ym[a_mode[a1]][m0])
                    l_mode[l0] = a_mode[a1] = m1
                    if bs == 11:
                        m2 = m0
                    else:
                        m2 = tree(mtree, kf_ym[a_mode[a0]][l_mode[l1]])
                        a_mode[a0] = m2
                    if bs == 11:
                        m3 = m1
                    elif bs == 10:
                        m3 = m2
                    else:
                        m3 = tree(mtree, kf_ym[a_mode[a1]][m2])
                    l_mode[l1] = a_mode[a1] = m3
                    modes = [m0, m1, m2, m3]
                else:
                    m = tree(mtree, kf_ym[a_mode[a0]][l_mode[l0]])
                    n4w, n4h = bwh[0][bs]
                    a_mode[a0:a0 + n4w] = [m] * n4w
                    l_mode[l0:l0 + n4h] = [m] * n4h
                    modes = [m] * 4
                b_uvmode = tree(mtree, tb.kf_uvm[modes[3]])
            elif intra:
                # --- an intra block of an inter frame: the frame's fixed
                # tables, no above/left coupling (vp9block.c:380-411) ---
                yp0 = tb.ymodep[0]
                if bs > 9:
                    ms = [tree(mtree, yp0)]
                    ms.append(ms[0] if bs == 10 else tree(mtree, yp0))
                    ms.append(ms[0] if bs == 11 else tree(mtree, yp0))
                    ms.append(ms[1] if bs == 11 else ms[2] if bs == 10
                              else tree(mtree, yp0))
                    if want_counts:
                        coded = [True, bs != 10, bs != 11,
                                 bs != 10 and bs != 11]
                        for m, cd in zip(ms, coded):
                            if cd:
                                cnts[O["y_mode"] + m] += 1
                    modes = ms
                else:
                    szg = int(_SZGROUP[bs])
                    m = tree(mtree, tb.ymodep[szg])
                    if want_counts:
                        cnts[O["y_mode"] + szg * 10 + m] += 1
                    modes = [m] * 4
                b_uvmode = tree(mtree, tb.uvmodep[modes[3]])
                if want_counts:
                    cnts[O["uv_mode"] + modes[3] * 10 + b_uvmode] += 1
                b_comp = 0
            else:
                # --- an inter block: compound flag and references
                # (vp9block.c:331-575), the whole-block inter mode, the
                # interpolation filter ---
                a_cm, l_cm = a_comp[bc], l_comp[row7]
                a_rf, l_rf = a_ref[bc], l_ref[row7]
                if rs_en:
                    b_comp, b_ref = 0, [rs_val - 1, 0]
                else:
                    if comppredmode == 2:
                        if have_a and have_l:
                            if a_cm and l_cm:
                                ctx = 4
                            elif a_cm:
                                ctx = 2 + (l_in == 1 or l_rf == fixref)
                            elif l_cm:
                                ctx = 2 + (a_in == 1 or a_rf == fixref)
                            else:
                                ctx = int((a_in == 0 and a_rf == fixref)
                                          != (l_in == 0 and l_rf == fixref))
                        elif have_a:
                            ctx = 3 if a_cm else int(a_in == 0
                                                     and a_rf == fixref)
                        elif have_l:
                            ctx = 3 if l_cm else int(l_in == 0
                                                     and l_rf == fixref)
                        else:
                            ctx = 1
                        b_comp = rd(tb.compp[ctx])
                        if want_counts:
                            cnts[O["comp"] + ctx * 2 + b_comp] += 1
                    else:
                        b_comp = int(comppredmode == 1)
                    if b_comp:
                        ctx = _comp_ref_ctx(have_a, have_l, a_in, l_in,
                                            a_cm, l_cm, a_rf, l_rf, fixref,
                                            varref0, varref1)
                        bit = rd(tb.comprefp[ctx])
                        if want_counts:
                            cnts[O["comp_ref"] + ctx * 2 + bit] += 1
                        var = varref1 if bit else varref0
                        b_ref = [fixref, var] if sbias[fixref] == 0 \
                            else [var, fixref]
                    else:
                        ctx = _single_ref_ctx1(have_a, have_l, a_in, l_in,
                                               a_cm, l_cm, a_rf, l_rf,
                                               fixref)
                        bit0 = rd(tb.singlerefp[ctx][0])
                        if want_counts:
                            cnts[O["single_ref"] + ctx * 4 + bit0] += 1
                        ref0 = 0
                        if bit0:
                            ctx = _single_ref_ctx2(have_a, have_l, a_in,
                                                   l_in, a_cm, l_cm, a_rf,
                                                   l_rf, fixref)
                            bit1 = rd(tb.singlerefp[ctx][1])
                            if want_counts:
                                cnts[O["single_ref"] + ctx * 4 + 2
                                     + bit1] += 1
                            ref0 = 1 + bit1
                        b_ref = [ref0, 0]
                # the mode context reads into a 64x64 or 32x32 block
                moff = int(_MOFF[bs])
                b_modectx = tb.imctx[a_mode[bc + moff]][l_mode[row7 + moff]]
                if bs <= 9:
                    if forced_skip:
                        m = 12          # the seg SKIP feature: ZEROMV
                    else:
                        m = tree(imtree, tb.mvmodep[b_modectx])
                        if want_counts:
                            cnts[O["mv_mode"] + b_modectx * 4 + m - 10] += 1
                    modes = [m] * 4
                else:
                    modes = [0] * 4     # read sub-block by sub-block
                if filtermode == 4:
                    ca = have_a and a_mode[bc] >= 10
                    cl_ = have_l and l_mode[row7] >= 10
                    af, lf = a_filter[bc], l_filter[row7]
                    if ca:
                        ctx = (lf if af == lf else 3) if cl_ else af
                    else:
                        ctx = lf if cl_ else 3
                    b_filterid = tree(ftree, tb.filterp[ctx])
                    if want_counts:
                        cnts[O["filter"] + ctx * 3 + b_filterid] += 1
                    b_filter = int(_FLUT[b_filterid])
                else:
                    b_filter, b_filterid = filtermode, 0
            # --- SET_CTXS splats ---
            splat(a_skip, bc, skip, bw4)
            splat(a_txfm, bc, tx, bw4)
            splat(a_part, bc, int(_ACTX[bs]), bw4)
            splat(l_skip, row7, skip, bh4)
            splat(l_txfm, row7, tx, bh4)
            splat(l_part, row7, int(_LCTX[bs]), bh4)
            if inter and not intra:
                # an inter block's mvs come next, a quantum a
                # (sub-block, reference)
                mv_k = mv_z = 0
                phase = MV
                continue
            if inter:
                set_ctxs_nonkf()
            # --- the record; then a skipped block zeroes its nnz ctx and
            # takes the next node, the others walk their coefficients ---
            if len(blocks) >= bcap:
                err |= ERR_OVERFLOW
                phase = DONE
                continue
            blocks.append(record())
            if skip:
                zero_nnz()
                phase = PART
                continue
            c_pl, c_x, c_y, c_modeidx, c_init = 0, 0, 0, 0, True
            phase = COEF
            continue

        if phase == MV:
            # ============ MV: one (sub-block k, reference z) ============
            sub8 = bs > 9
            if sub8 and mv_z == 0:
                m = tree(imtree, tb.mvmodep[b_modectx])
                if want_counts:
                    cnts[O["mv_mode"] + b_modectx * 4 + m - 10] += 1
                modes[mv_k] = m
            mode_k = modes[mv_k]
            if mode_k == 12:
                # ZEROMV zeroes both references' mvs
                b_mv[mv_k] = [(0, 0), (0, 0)]
            else:
                rx, ry = find_ref_mv(b_ref[mv_z], mv_z, mode_k == 11,
                                     -1 if mode_k == 13 or not sub8
                                     else mv_k)
                hp = highprec and abs(rx) < 64 and abs(ry) < 64
                if (mode_k == 13 or not sub8) and not hp:
                    # odd components rounded toward zero (vp9mvs.c:
                    # 300-321)
                    if ry & 1:
                        ry += 1 if ry < 0 else -1
                    if rx & 1:
                        rx += 1 if rx < 0 else -1
                if mode_k == 13:
                    j = tree(jtree, tb.mvjointp)
                    if want_counts:
                        cnts[O["mv_joint"] + j] += 1
                    if j >= 2:
                        ry += read_mv_comp(0, hp)
                    if j & 1:
                        rx += read_mv_comp(1, hp)
                b_mv[mv_k][mv_z] = (rx, ry)
            if b_comp and mv_z == 0 and mode_k != 12:
                mv_z = 1
                continue
            mv_z = 0
            nk = mv_k + (2 if bs == 10 else 1)
            if sub8 and nk <= (3 if bs == 12 else 1 if bs == 11 else 2):
                mv_k = nk
                continue
            # the last (sub-block, reference): the shared slots, the
            # deferred contexts and grids; then the skip or coef path
            src = _SUBSRC[bs]
            b_mv = [list(b_mv[q]) for q in src]
            modes = [modes[q] for q in src]
            set_ctxs_nonkf()
            anycoef = 0
            if skip:
                zero_nnz()
                if len(blocks) >= bcap:
                    err |= ERR_OVERFLOW
                    phase = DONE
                    continue
                blocks.append(record())
                phase = PART
                continue
            c_pl, c_x, c_y, c_modeidx, c_init = 0, 0, 0, 0, True
            phase = COEF
            continue

        # ============ COEF: one scan position ============
        if c_init:
            # the transform block's constants; the nnz pre-merge once at
            # the start of each plane walk (every step-anchor entry
            # becomes any() of its range)
            is_y = c_pl == 0
            sshp, ssvp = (0, 0) if is_y else (ss_h, ss_v)
            tx_p = tx if is_y else uvtx
            step = 1 << tx_p
            end_x = min(2 * (cols - bc), bwh[1][bs][0] * 2) >> sshp
            end_y = min(2 * (rows - br), bwh[1][bs][1] * 2) >> ssvp
            a_arr, l_arr = a_nnz[c_pl], l_nnz[c_pl]
            a_base = bc * 2 if is_y else (bc * 2) >> ss_h
            l_base = (br & 7) * 2 if is_y else ((br & 7) * 2) >> ss_v
            if c_x == 0 and c_y == 0 and step > 1:
                for arr, b0, end in ((a_arr, a_base, end_x),
                                     (l_arr, l_base, end_y)):
                    for apos in range(0, min(8 * step, end + step - 1),
                                      step):
                        if apos < end:
                            arr[b0 + apos] = int(any(
                                arr[b0 + apos:b0 + apos + step]))
            nnz = a_arr[a_base + c_x] + l_arr[l_base + c_y]
            txtp = _ITX[modes[c_modeidx if bs > 9 and tx == 0 else 0]] \
                if is_y else 0
            scfg = (4 * lossless + tx_p) * 4 + txtp
            scan_o = scfg * 1024
            band_o = tx_p * 1024
            # coefficient rows (tx * 2 + plane type) * 2 + is_inter
            prow = ((tx_p * 2 + (0 if is_y else 1)) * 2 + 1 - intra) * 36
            n_tot = 16 << (2 * tx_p)
            qs = tb.qmul[seg_id]
            qdc, qac = (qs[0], qs[1]) if is_y else (qs[2], qs[3])
            if is_y:
                cpos0 = (br * 8 + c_y * 4) * W64 + bc * 8 + c_x * 4
                Wp = W64
                epos = (br * 2 + c_y) * c16 + bc * 2 + c_x
            else:
                cpos0 = (ysz if c_pl == 1 else ysz + usz) \
                    + (((br * 8) >> ss_v) + c_y * 4) * W64uv \
                    + ((bc * 8) >> ss_h) + c_x * 4
                Wp = W64uv
                epos = (eysz if c_pl == 1 else eysz + eusz) \
                    + (((br * 2) >> ss_v) + c_y) * c16uv \
                    + ((bc * 2) >> ss_h) + c_x
            shift = 2 + tx_p
            cache = [0] * 1024
            ci = 0
            skipeob = False
            c_count = 0
            c_init = False
        bc36 = tb.bands[band_o + ci] * 6 + nnz
        tp = tb.coef[prow + bc36]
        done = False
        if not skipeob:
            bb = rd(tp[0])
            if want_counts:
                cnts[CNT_EOB + (prow + bc36) * 2 + bb] += 1
            done = bb == 0
        if not done:
            sc = tb.scans[scan_o + ci]
            if not rd(tp[1]):
                tok, energy = 0, 0
                skipeob = True
            else:
                skipeob = False
                tok = 2
                if not rd(tp[2]):
                    val = energy = tok = 1
                elif not rd(tp[3]):
                    if not rd(tp[4]):
                        val = energy = 2
                    else:
                        val = 3 + rd(tp[5])
                        energy = 3
                else:
                    if not rd(tp[6]):
                        cls = 1 + rd(tp[7])
                        energy = 4
                    else:
                        energy = 5
                        cls = 3 + rd(tp[9]) if not rd(tp[8]) \
                            else 5 + rd(tp[10])
                    eb = 0
                    for k in range(tb.catn[cls]):
                        eb = (eb << 1) | rd(tb.cat[cls][k])
                    val = int(_CAT_BASE[cls]) + eb
                if rd(128):
                    val = -val
                # int32 products, as the reference's (they wrap)
                prod = _i32(val * (qdc if ci == 0 else qac))
                if tx_p == 3:
                    prod = _i32(-(_i32(-prod) >> 1)) if prod < 0 \
                        else prod >> 1
                if bpp == 8:
                    prod = ((prod + 0x8000) & 0xFFFF) - 0x8000
                if prod:
                    if len(cpairs) >= ccap:
                        err |= ERR_OVERFLOW
                        phase = DONE
                        continue
                    cpairs.append((cpos0 + (sc >> shift) * Wp
                                   + (sc & ((1 << shift) - 1)), prod))
            if want_counts:
                cnts[CNT_COEF + (prow + bc36) * 3 + tok] += 1
            cache[sc] = energy
            c_count = ci + 1
            nb = (scan_o + ci) * 2
            nnz = (1 + cache[tb.nbs[nb]] + cache[tb.nbs[nb + 1]]) >> 1
            ci += 1
            done = ci >= n_tot
        if not done:
            continue
        # ---- the transform block's finish: nnz writeback (the anchor
        # and its step range, cut at the visible edge), eob pair,
        # advance ----
        nzf = int(c_count > 0)
        for arr, b0, cc, end in ((a_arr, a_base, c_x, end_x),
                                 (l_arr, l_base, c_y, end_y)):
            n = min(step, end - cc)
            arr[b0 + cc:b0 + cc + n] = [nzf] * n
        if c_count:
            anycoef = 1
            if len(epairs) >= ecap:
                err |= ERR_OVERFLOW
                phase = DONE
                continue
            epairs.append((epos, c_count))
        if is_y:
            c_modeidx += step * step
        c_x += step
        c_init = True
        if c_x >= end_x:
            c_x = 0
            c_y += step
            if c_y >= end_y:
                c_y = 0
                c_pl += 1
                if c_pl == 3:
                    phase = PART
                    if inter and not intra:
                        # an inter block of 8x8 or more without a
                        # coefficient is skipped after the fact; its
                        # record follows its coefficients
                        if bs <= 9 and not anycoef:
                            skip = 1
                            splat(a_skip, bc, 1, min(cols - bc,
                                                     bwh[1][bs][0]))
                            splat(l_skip, row7, 1, min(rows - br,
                                                       bwh[1][bs][1]))
                        if len(blocks) >= bcap:
                            err |= ERR_OVERFLOW
                            phase = DONE
                            continue
                        blocks.append(record())
    return blocks, cpairs, epairs, cnts, err, bools


_SLOT_KIND_L = _SLOT_KIND.tolist()
_SLOT_PAR_L = _SLOT_PAR.tolist()


def _comp_ref_ctx(have_a, have_l, a_in, l_in, a_cm, l_cm, a_rf, l_rf,
                  fixref, varref0, varref1):
    """The compound reference's context (vp9block.c:414-477)."""
    if have_a and have_l:
        if a_in:
            return 2 if l_in else 1 + 2 * (l_rf != varref1)
        if l_in:
            return 1 + 2 * (a_rf != varref1)
        if l_rf == a_rf and a_rf == varref1:
            return 0
        if not l_cm and not a_cm:
            if (a_rf == fixref and l_rf == varref0) or \
                    (l_rf == fixref and a_rf == varref0):
                return 4
            return 3 if a_rf == l_rf else 1
        if not l_cm:
            if a_rf == varref1 and l_rf != varref1:
                return 1
            return 2 if l_rf == varref1 and a_rf != varref1 else 4
        if not a_cm:
            if l_rf == varref1 and a_rf != varref1:
                return 1
            return 2 if a_rf == varref1 and l_rf != varref1 else 4
        return 4 if l_rf == a_rf else 2
    if have_a or have_l:
        inn, cm, rf = (a_in, a_cm, a_rf) if have_a else (l_in, l_cm, l_rf)
        if inn:
            return 2
        return (4 if cm else 3) * (rf != varref1)
    return 2


def _single_ref_ctx1(have_a, have_l, a_in, l_in, a_cm, l_cm, a_rf, l_rf,
                     fixref):
    """The first single-reference bit's context (vp9block.c:479-520)."""
    nf, nlr, nar = fixref == 0, l_rf == 0, a_rf == 0
    a_ok, l_ok = have_a and not a_in, have_l and not l_in
    if a_ok and l_ok:
        if l_cm:
            return 1 + (nf or nlr or nar) if a_cm \
                else 3 * nar + (nf or nlr)
        return 3 * nlr + (nf or nar) if a_cm else 2 * nlr + 2 * nar
    if a_ok:
        return 1 + (nf or nar) if a_cm else 4 * nar
    if l_ok:
        return 1 + (nf or nlr) if l_cm else 4 * nlr
    return 2


def _single_ref_ctx2(have_a, have_l, a_in, l_in, a_cm, l_cm, a_rf, l_rf,
                     fixref):
    """The second single-reference bit's context (vp9block.c:522-572),
    with the reference's dead arms."""
    f1, ar1, lr1 = fixref == 1, a_rf == 1, l_rf == 1
    nar, nlr = a_rf == 0, l_rf == 0
    if have_a and have_l:
        if l_in:
            if a_in:
                return 2
            if a_cm:
                return 1 + 2 * (f1 or ar1)
            return 3 if nar else 4 * ar1
        if a_in:
            if l_cm:
                return 1 + 2 * (f1 or lr1)
            return 3 if nlr else 4 * lr1
        if a_cm:
            if l_cm:
                return 3 * (f1 or lr1) if l_rf == a_rf else 2
            return 1 + 2 * (f1 or ar1) if nlr else 3 * lr1 + (f1 or ar1)
        if l_cm:
            return 1 + 2 * (f1 or lr1) if nar else 3 * ar1 + (f1 or lr1)
        if nar:
            return 3 if nlr else 4 * lr1
        return 4 * ar1 if nlr else 2 * lr1 + 2 * ar1
    if have_a or have_l:
        inn, cm, n0, r1 = (a_in, a_cm, nar, ar1) if have_a \
            else (l_in, l_cm, nlr, lr1)
        if inn or (not cm and n0):
            return 2
        return 3 * (f1 or r1) if cm else 4 * r1
    return 2


def grid_shapes(meta):
    """The frame's MV grid [R8, C8, 2, 2] and reference grid [R8, C8, 2]
    in the host layout (codecs/vp9/decoder.py Frame.mv, Frame.refs)."""
    R8, C8 = meta["sb_rows"] * 8, meta["sb_cols"] * 8
    return (R8, C8, 2, 2), (R8, C8, 2)


def decode_frame_plain(inputs, meta, device="cpu"):
    """The walk in plain Python, each lane's phase machine in turn (the
    kernel's thread, one after another), its outputs as decode_frame's
    on `device`, each lane's rows sized by lane_caps."""
    S = meta["S"]
    inter = bool(meta.get("inter"))
    caps = lane_caps(inputs, meta)
    tb = _Tables(inputs, meta)
    grid = None
    if inter:
        mv_shape, ref_shape = grid_shapes(meta)
        grid = ([0] * int(np.prod(mv_shape)),
                [-1] * int(np.prod(ref_shape)))
    half16 = np.asarray(inputs["half16"]).tolist()
    rac0 = np.asarray(inputs["rac0"], np.int64)
    bounds = np.asarray(inputs["bounds"]).tolist()
    res = [_walk_lane(tb, meta, half16[s], [int(v) for v in rac0[:, s]],
                      int(inputs["win_start"][s]),
                      int(inputs["tile_len"][s]), bounds[s],
                      [int(c[s]) for c in caps], grid)
           for s in range(S)]
    nbmax, ncmax, nemax = (int(np.max(c)) if S else 0 for c in caps)
    blocks = np.zeros((S, nbmax, 34), np.int32)
    cpairs = np.zeros((S, ncmax, 2), np.int32)
    epairs = np.zeros((S, nemax, 2), np.int32)
    counts = np.zeros((S, CNT_TOTAL), np.int32)
    n = np.zeros((4, S), np.int32)
    stats = np.zeros((S, 3), np.int64)
    for s, (blk, cp, ep, cn, err, bools) in enumerate(res):
        for arr, rows in ((blocks, blk), (cpairs, cp), (epairs, ep)):
            if rows:
                arr[s, :len(rows)] = rows
        counts[s] = cn
        n[:, s] = len(blk), len(cp), len(ep), err
        stats[s, 0] = bools
    arrs = [blocks, n[0], cpairs, n[1], epairs, n[2], counts, n[3], stats]
    if inter:
        arrs += [np.asarray(grid[0], np.int16).reshape(mv_shape),
                 np.asarray(grid[1], np.int8).reshape(ref_shape)]
    dev = torch.device(device)
    return tuple(torch.as_tensor(a, device=dev) for a in arrs)


# ---------------------------------------------------------------------------
# the kernel (csrc/passa.cu)

_P, _I = ctypes.c_void_p, ctypes.c_int
# packet, tile_off, tile_len, bounds, caps, probs8, coef16, qmul, scanw,
# scan_off, prev_mv, prev_ref, prev_seg, hflags (a host array); nprobs, S,
# rows, cols, sb_cols, sb_rows, txfmmode, seg, lossless, bpp, ss_h, ss_v,
# want_counts, inter, bmax, cmax, emax; blocks, nblk, cpairs, ncp,
# epairs, nep, counts, err, stats, grid_mv, grid_ref, sections; stream
_SIGNATURES = {"passa_walk": [_P] * 14 + [_I] * 17 + [_P] * 12 + [_P]}

# the kernel's debug sections (csrc/passa.cu enum Sec), a lane's int64
# row of decode_frame_sections: clock64 cycles of the PART quanta, the
# MODE quanta, the MV candidate scans without their bools, the rest of
# the MV quanta, the COEF token loops outside and inside the runs of ZERO
# tokens (a bool a position), the rest of COEF, the records' emit and the
# warp's handovers around an MV quantum; the bools read in PART, MODE, MV
# and COEF; the MV scans; the positions of the ZERO runs
SECTIONS = ("part", "mode", "mv_scan", "mv", "coef_loop", "coef_run",
            "coef", "emit", "sync", "bools_part", "bools_mode", "bools_mv",
            "bools_coef", "mv_scans", "run_positions")

# the kernel's shared-memory above ctx holds a tile this wide (b8): VP9
# tiles are at most 64 superblocks wide (MAX_TILE_WIDTH_B64)
MAX_TILE_B8 = 512

# an inter frame's tables in probs8, after the intra frame's
_INTER_PROBS = ("partp", "intrap", "compp", "comprefp", "singlerefp",
                "ymodep", "uvmodep", "mvmodep", "filterp", "mvjointp",
                "mvsignp", "mvclassesp", "mvclass0p", "mvbitsp", "mvc0fpp",
                "mvfpp", "mvc0hpp", "mvhpp", "segpredp", "refseg_en",
                "refseg_val")


def probs8(inputs):
    """The frame's probability tables in the kernel's one uint8 array:
    skip[3], tx8p[2][1], tx16p[2][2], tx32p[2][3], segprob[7],
    skipseg[8], kf partition[4][4][3], kf y mode[10][10][9], kf uv
    mode[10][9], coef[8][36][11] (intra blocks'); on an inter frame
    (inputs with "aux") then the inter blocks' coef[8][36][11], the
    frame's partition[4][4][3], intra[4], comp[5], comp_ref[5],
    single_ref[5][2], y mode[4][9], uv mode[10][9], mv mode[7][3],
    filter[4][2], the MV tables (joint[3], sign[2], classes[2][10],
    class0[2], bits[2][10], class0_fp[2][2][3], fp[2][3], class0_hp[2],
    hp[2]), seg_pred_prob[3] and the seg REF feature's enables[8] and
    values[8]."""
    parts = [inputs["skipp"], inputs["tx8p"], inputs["tx16p"],
             inputs["tx32p"], inputs["segprob"], inputs["skipseg"],
             T.DEFAULT_KF_PARTITION_PROBS, T.DEFAULT_KF_YMODE_PROBS,
             T.DEFAULT_KF_UVMODE_PROBS, inputs["coef11"]]
    aux = inputs.get("aux")
    if aux is not None:
        parts.append(np.asarray(aux["coef11i"]).reshape(8, 2, 36, 11)[:, 1])
        parts += [aux[k] for k in _INTER_PROBS]
    return np.concatenate([np.asarray(p).reshape(-1) for p in parts]) \
        .astype(np.uint8)


# the kernel's staged scan words (csrc/passa.cu kScanWords, kScanRows)
SCAN_WORDS, SCAN_ROWS = 2048, 20
_PACKED = None


def packed_scans():
    """The token loop's scan tables as the kernel stages them: (words
    uint32 [SCAN_WORDS], offs int32 [SCAN_ROWS]). Row r = (4 * lossless
    + tx) * 4 + txtype of _scans_i32 starts at words[offs[r]]; position
    i's word holds its scan index (bits 0-9) and the two neighbours its
    context reads (bits 10-19, 20-29: those _scans_i32's neighbour table
    gives at i - 1; 0 at position 0). Rows of equal content share their
    words (the 32x32 rows are one, the lossless WHT's the 4x4 DCT's), and
    three words of padding follow the last, which the kernel reads past a
    row's end and never uses."""
    global _PACKED
    if _PACKED is None:
        sc, nb = _scans_i32()
        words, offs, seen = [], np.zeros(SCAN_ROWS, np.int32), {}
        for r in range(SCAN_ROWS):
            tx = r // 4
            n = 16 << (2 * tx) if tx < 4 else 16
            w = sc[r, :n].astype(np.uint32).copy()
            w[1:] |= (nb[r, :n - 1, 0].astype(np.uint32) << 10) \
                | (nb[r, :n - 1, 1].astype(np.uint32) << 20)
            key = w.tobytes()
            if key not in seen:
                seen[key] = len(words)
                words.extend(w.tolist())
            offs[r] = seen[key]
        if len(words) + 3 > SCAN_WORDS:
            raise RuntimeError("the packed scans outgrow kScanWords")
        _PACKED = (np.asarray(words + [0] * (SCAN_WORDS - len(words)),
                              np.uint32), offs)
    return _PACKED


# probs8's coefficient tables: [8 (tx * 2 + plane type)][36 (band * 6 +
# context)][11] for intra blocks, then on inter frames for inter blocks
_COEF_OFF, _COEF_OFF_INTER, _COEF_ROWS = 1068, 4236, 8 * 36


def coef16_rows(p8):
    """probs8's coefficient probability rows padded to 16 bytes, as the
    kernel stages them: uint8 [2 (intra, inter block), 288, 16]; an intra
    frame's inter rows are 0 (none of its blocks reads them)."""
    out = np.zeros((2, _COEF_ROWS, 16), np.uint8)
    for k, off in enumerate((_COEF_OFF, _COEF_OFF_INTER)):
        if off + _COEF_ROWS * 11 <= len(p8):
            out[k, :, :11] = p8[off:off + _COEF_ROWS * 11].reshape(-1, 11)
    return out


_TABLES = {}


def _tables_dev(dev):
    """The packed scan words and their rows' offsets on `dev` (int32
    tensors of packed_scans' arrays), copied there once."""
    tabs = _TABLES.get(dev)
    if tabs is None:
        words, offs = packed_scans()
        tabs = (torch.as_tensor(words.view(np.int32), device=dev),
                torch.as_tensor(offs, device=dev))
        _TABLES[dev] = tabs
    return tabs


def _launch(inputs, meta, dev, sections=None):
    """One launch of csrc/passa.cu on CUDA device `dev`: decode_frame's
    outputs, each lane's rows sized by lane_caps, stats [S, 3] int64
    (bools read, clock64 cycles of the lane's walk and of its MV
    quanta), and on an inter frame the grids, made on `dev` with 0 and
    -1 before the launch. With `sections` (int64 [S, len(SECTIONS)] on
    `dev`) the kernel's instance that times its sections fills it."""
    S = meta["S"]
    inter = int(bool(meta.get("inter")))
    caps = lane_caps(inputs, meta)
    b = np.asarray(inputs["bounds"])
    if S and int((b[:, 3] - b[:, 2]).max()) > MAX_TILE_B8:
        raise ValueError(f"a tile wider than {MAX_TILE_B8} 8x8 columns")
    bcap, ccap, ecap = (int(np.max(c)) if S else 0 for c in caps)
    if S and max(bcap, ccap, ecap) >= 1 << 31:
        raise ValueError("the outputs of a lane exceed int32 indexing")
    packet = torch.as_tensor(inputs["packet"], device=dev)
    tile_off = torch.as_tensor(np.asarray(inputs["tile_off"], np.int64),
                               device=dev)
    tile_len = torch.as_tensor(np.asarray(inputs["tile_len"], np.int32),
                               device=dev)
    bounds = torch.as_tensor(np.ascontiguousarray(b, np.int32), device=dev)
    caps_d = torch.as_tensor(np.stack([np.asarray(c, np.int32) for c in caps],
                                      1), device=dev)
    p8np = probs8(inputs)
    p8 = torch.as_tensor(p8np, device=dev)
    coef16 = torch.as_tensor(coef16_rows(p8np), device=dev)
    qmul = torch.as_tensor(np.asarray(inputs["qmul"], np.int32), device=dev)
    scanw, scan_off = _tables_dev(dev)
    i32 = torch.int32
    blocks = torch.empty((S, bcap, 34), dtype=i32, device=dev)
    cpairs = torch.empty((S, ccap, 2), dtype=i32, device=dev)
    epairs = torch.empty((S, ecap, 2), dtype=i32, device=dev)
    nblk, ncp, nep, err = (torch.empty(S, dtype=i32, device=dev)
                           for _ in range(4))
    counts = torch.empty((S, CNT_TOTAL), dtype=i32, device=dev)
    stats = torch.empty((S, 3), dtype=torch.int64, device=dev)
    prev = (None, None, None)
    grids = (None, None)
    hflags = None
    if inter:
        aux = inputs["aux"]
        prev = tuple(None if g is None else torch.as_tensor(
            np.ascontiguousarray(g, dt), device=dev)
            for g, dt in zip(inputs["prev_grids"],
                             (np.int16, np.int8, np.uint8)))
        mv_shape, ref_shape = grid_shapes(meta)
        grids = (torch.zeros(mv_shape, dtype=torch.int16, device=dev),
                 torch.full(ref_shape, -1, dtype=torch.int8, device=dev))
        hflags = np.ascontiguousarray(aux["hflags"], np.int32)
    if S:
        _cuda.launch("passa.cu", _SIGNATURES, "passa_walk", packet,
                     tile_off, tile_len, bounds, caps_d, p8, coef16, qmul,
                     scanw, scan_off, *prev,
                     hflags.ctypes.data if inter else None, len(p8np), S,
                     meta["rows"], meta["cols"], meta["sb_cols"],
                     meta["sb_rows"], meta["txfmmode"], meta["seg"],
                     meta["lossless"], meta["bpp"], meta["ss_h"],
                     meta["ss_v"], meta["want_counts"], inter, bcap, ccap,
                     ecap, blocks, nblk, cpairs, ncp, epairs, nep, counts,
                     err, stats, *grids, sections)
        LAUNCHES["passa"] += 1
    out = (blocks, nblk, cpairs, ncp, epairs, nep, counts, err, stats)
    return out + grids if inter else out


def decode_frame(inputs, meta, device):
    """Run the walk on `device`: the kernel on a CUDA device, the plain
    version on the CPU. inputs, meta: prep_keyframe's or prep_inter's.
    Each lane may write the rows lane_caps gives it (blocks, coefficient
    pairs, eob pairs), which no tile can overflow. Returns torch tensors
    on `device`: (blocks [S, bmax, 34], nblk [S], cpairs [S, cmax, 2],
    ncp [S], epairs [S, emax, 2], nep [S], counts [S, CNT_TOTAL] (zeros
    unless meta['want_counts']), err [S] int32 (ERR_* bits), stats [S,
    3] int64 (a lane's bools; the kernel's clock64 cycles of the lane's
    walk and of its MV phases, 0 on the CPU)); on an inter frame then
    the frame's MV grid and reference grid (grid_shapes, int16 and
    int8: the host decoder's cur_mv and cur_ref after the frame)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cpu":
        return decode_frame_plain(inputs, meta, dev)
    return _launch(inputs, meta, dev)


def decode_frame_sections(inputs, meta, device):
    """decode_frame on a CUDA device through the kernel's instance that
    times its debug sections: (decode_frame's outputs, sections [S,
    len(SECTIONS)] int64 on the host). Slower than decode_frame by the
    clock reads; for measurement alone."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the sections are the kernel's: a CUDA device")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    sec = torch.zeros((meta["S"], len(SECTIONS)), dtype=torch.int64,
                      device=dev)
    out = _launch(inputs, meta, dev, sec)
    return out, sec.cpu().numpy()


def check_err(err):
    """Raise ValueError for a walk's err word [S] (host numpy)."""
    e = int(np.bitwise_or.reduce(np.asarray(err, np.int64))) \
        if len(err) else 0
    if e & ERR_MARKER:
        raise ValueError("marker bit set in tile")
    if e & ERR_END:
        raise ValueError("bitstream end mid-tile")
    if e & ERR_OVERFLOW:
        raise ValueError("device pass A buffer overflow")
