"""On-device pass A for intra frames: the keyframe block-syntax walk of
S tile streams — the counterpart of the intra half of the JAX package's
ops/passa_device.py (`_decode_jit` with inter=0).

Every lane is one independent VP9 tile bool stream (vp9.c:1342). A lane
runs a phase machine, one bounded quantum a step:

  PART  one partition-tree node: the partition symbol (full tree, the
        edge-forced single bit or the forced split, vp9.c:1115-1193),
        or the node's next child or leaf block;
  MODE  the keyframe mode bundle of one block (seg id, skip, the tx
        ladder, the context-coupled intra mode trees, the uv mode and
        the SET_CTXS splats, vp9block.c:80-330);
  COEF  one scan position of the current transform block (the token
        cascade of vp9block.c:805-923), with transform-block and plane
        transitions folded into the quantum;
  DONE  the tile is drained (or the lane stopped on an error);
  MV    reserved for the inter walk (the same numbering as JAX's).

Outputs per lane: block records in the native 34-column layout (row,
col, tile_col_start, bs, seg, skip, intra, tx, uvtx, mode[4], uvmode,
comp, ref[2], filter, mv[4][2][2]), nonzero coefficient pairs (flat
plane position with its plane base, dequantized value), eob pairs (flat
eob-grid position with its plane base, count), the symbol counts of the
vp9prob.c taxonomy when the frame adapts, and an error word.

`decode_frame` runs the walk: on a CUDA device one launch of the
hand-written kernel csrc/passa.cu (a block of one warp a lane, one
thread walking it with its contexts in shared memory), on the CPU the
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
decode_block), vp9.c:1115-1193 (decode_sb), vp9prob.c (the count
taxonomy), vpx_rac.h:83-94 (the bool decoder).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _cuda
from ..codecs.vp9 import tables as T
from ..codecs.vp9.blockdec import (ABOVE_CTX, LEFT_CTX, MAX_TX_FOR_BL_BP,
                                   BAND_COUNTS)

# phases (MV is the inter walk's, kept so that it extends this machine)
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
# size group of a block size (the inter walk's y-mode context)
_SZGROUP = np.asarray([3, 3, 3, 3, 2, 2, 2, 1, 1, 1, 0, 0, 0], np.int32)

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
        self.coef = lst(np.asarray(inputs["coef11"]).reshape(288, 11))
        self.qmul = lst(inputs["qmul"])
        self.skipseg = lst(inputs["skipseg"])
        self.segprob = lst(inputs["segprob"])
        self.scans = lst(np.asarray(inputs["scans"]).reshape(-1))
        self.nbs = lst(np.asarray(inputs["nbs"]).reshape(-1))
        self.kf_part = lst(T.DEFAULT_KF_PARTITION_PROBS)     # [4][4][3]
        self.kf_ym = lst(T.DEFAULT_KF_YMODE_PROBS)           # [10][10][9]
        self.kf_uvm = lst(T.DEFAULT_KF_UVMODE_PROBS)         # [10][9]
        self.bwh = lst(_BWH)
        self.bands = lst(_BANDS.reshape(-1))
        self.cat = lst(_cat_table(meta["bpp"]))
        self.catn = lst(_CAT_NBITS[meta["bpp"]])


def _walk_lane(tb, meta, half16, rac0, win_start, tile_len, bounds,
               caps):
    """One lane's walk (the kernel's thread): its records, coefficient
    and eob pairs, counts, err word and bools read, as lists."""
    rows, cols = meta["rows"], meta["cols"]
    ss_h, ss_v, bpp = meta["ss_h"], meta["ss_v"], meta["bpp"]
    lossless, txfmmode = meta["lossless"], meta["txfmmode"]
    seg, want_counts = meta["seg"], meta["want_counts"]
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
    blocks, cpairs, epairs = [], [], []
    # above ctx, frame-absolute; left ctx, per superblock row
    W = cols + 16
    a_part, a_skip, a_txfm = [0] * W, [0] * W, [0] * W
    a_mode = [2] * (2 * W)
    a_nnz = [[0] * (2 * W) for _ in range(3)]
    l_part, l_skip, l_txfm = [0] * 8, [0] * 8, [0] * 8
    l_mode = [2] * 16
    l_nnz = [[0] * 16 for _ in range(3)]
    bwh = tb.bwh
    err = 0
    phase = PART
    sb_r, sb_c = r0, c0
    stack = []          # partition nodes: [bl, r, c, bp, emitted]
    blk = None          # the current block's record (34 values)
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
                pp = tb.kf_part[bl][pctx]
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
                    cnts[CNT_OFF["partition"] + (bl * 4 + pctx) * 4
                         + bp] += 1
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
                        l_mode = [2] * 16
                        l_nnz = [[0] * 16 for _ in range(3)]
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
            seg_id = tree(stree, tb.segprob) if seg else 0
            # --- skip ---
            if tb.skipseg[seg_id]:
                skip = 1
            else:
                sctx = l_skip[row7] + a_skip[bc]
                skip = rd(tb.skipp[sctx])
                if want_counts:
                    cnts[CNT_OFF["skip"] + sctx * 2 + skip] += 1
            # --- tx size ---
            mtx = _MAXTX[bs]
            if txfmmode == 4:
                have_a, have_l = br > 0, bc > c0
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
                    cidx = CNT_OFF["tx32p"] + txctx * 4 + tx
                elif mtx == 2:
                    p = tb.tx16p[txctx]
                    tx = rd(p[0])
                    if tx:
                        tx += rd(p[1])
                    cidx = CNT_OFF["tx16p"] + txctx * 3 + tx
                elif mtx == 1:
                    tx = rd(tb.tx8p[txctx][0])
                    cidx = CNT_OFF["tx8p"] + txctx * 2 + tx
                else:
                    tx, cidx = 0, -1
                if want_counts and cidx >= 0:
                    cnts[cidx] += 1
            else:
                tx = min(mtx, txfmmode)
            uvtx = tx - int((ss_h and bw4 * 2 == (1 << tx))
                            or (ss_v and bh4 * 2 == (1 << tx)))
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
            uvmode = tree(mtree, tb.kf_uvm[modes[3]])
            # --- SET_CTXS splats ---
            a_skip[bc:bc + bw4] = [skip] * bw4
            a_txfm[bc:bc + bw4] = [tx] * bw4
            a_part[bc:bc + bw4] = [_ACTX[bs]] * bw4
            l_skip[row7:row7 + bh4] = [skip] * bh4
            l_txfm[row7:row7 + bh4] = [tx] * bh4
            l_part[row7:row7 + bh4] = [_LCTX[bs]] * bh4
            # --- the record; then a skipped block zeroes its nnz ctx
            # (vp9block.c:1316) and takes the next node, the others walk
            # their coefficients ---
            if len(blocks) >= bcap:
                err |= ERR_OVERFLOW
                phase = DONE
                continue
            blocks.append([br, bc, c0, bs, seg_id, skip, 1, tx, uvtx]
                          + modes + [uvmode] + [0] * 20)
            if skip:
                for arr, b0, n in ((a_nnz[0], bc * 2, bw4 * 2),
                                   (l_nnz[0], row7 * 2, bh4 * 2),
                                   (a_nnz[1], (bc * 2) >> ss_h,
                                    (bw4 * 2) >> ss_h),
                                   (a_nnz[2], (bc * 2) >> ss_h,
                                    (bw4 * 2) >> ss_h),
                                   (l_nnz[1], (row7 * 2) >> ss_v,
                                    (bh4 * 2) >> ss_v),
                                   (l_nnz[2], (row7 * 2) >> ss_v,
                                    (bh4 * 2) >> ss_v)):
                    arr[b0:b0 + n] = [0] * n
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
            prow = tx_p * 2 + (0 if is_y else 1)
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
        tp = tb.coef[prow * 36 + bc36]
        done = False
        if not skipeob:
            bb = rd(tp[0])
            if want_counts:
                cnts[CNT_EOB + ((prow * 2 * 36) + bc36) * 2 + bb] += 1
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
                cnts[CNT_COEF + ((prow * 2 * 36) + bc36) * 3 + tok] += 1
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
    return blocks, cpairs, epairs, cnts, err, bools


def decode_frame_plain(inputs, meta, device="cpu"):
    """The walk in plain Python, each lane's phase machine in turn (the
    kernel's thread, one after another), its outputs as decode_frame's
    on `device`, each lane's rows sized by lane_caps."""
    S = meta["S"]
    caps = lane_caps(inputs, meta)
    tb = _Tables(inputs, meta)
    half16 = np.asarray(inputs["half16"]).tolist()
    rac0 = np.asarray(inputs["rac0"], np.int64)
    bounds = np.asarray(inputs["bounds"]).tolist()
    res = [_walk_lane(tb, meta, half16[s], [int(v) for v in rac0[:, s]],
                      int(inputs["win_start"][s]),
                      int(inputs["tile_len"][s]), bounds[s],
                      [int(c[s]) for c in caps])
           for s in range(S)]
    nbmax, ncmax, nemax = (int(np.max(c)) if S else 0 for c in caps)
    blocks = np.zeros((S, nbmax, 34), np.int32)
    cpairs = np.zeros((S, ncmax, 2), np.int32)
    epairs = np.zeros((S, nemax, 2), np.int32)
    counts = np.zeros((S, CNT_TOTAL), np.int32)
    n = np.zeros((4, S), np.int32)
    stats = np.zeros((S, 2), np.int64)
    for s, (blk, cp, ep, cn, err, bools) in enumerate(res):
        for arr, rows in ((blocks, blk), (cpairs, cp), (epairs, ep)):
            if rows:
                arr[s, :len(rows)] = rows
        counts[s] = cn
        n[:, s] = len(blk), len(cp), len(ep), err
        stats[s, 0] = bools
    dev = torch.device(device)
    out = [torch.as_tensor(a, device=dev) for a in (
        blocks, n[0], cpairs, n[1], epairs, n[2], counts, n[3], stats)]
    return tuple(out)


# ---------------------------------------------------------------------------
# the kernel (csrc/passa.cu)

_P, _I = ctypes.c_void_p, ctypes.c_int
# packet, tile_off, tile_len, bounds, caps, probs8, qmul, scans, nbs,
# bands, S, rows, cols, sb_cols, sb_rows, txfmmode, seg, lossless, bpp,
# ss_h, ss_v, want_counts, bmax, cmax, emax, blocks, nblk, cpairs, ncp,
# epairs, nep, counts, err, stats, stream
_SIGNATURES = {"passa_walk": [_P] * 10 + [_I] * 15 + [_P] * 9 + [_P]}

# the kernel's shared-memory above ctx holds a tile this wide (b8): VP9
# tiles are at most 64 superblocks wide (MAX_TILE_WIDTH_B64)
MAX_TILE_B8 = 512


def probs8(inputs):
    """The frame's probability tables in the kernel's one uint8 array:
    skip[3], tx8p[2][1], tx16p[2][2], tx32p[2][3], segprob[7],
    skipseg[8], kf partition[4][4][3], kf y mode[10][10][9], kf uv
    mode[10][9], coef[8][36][11]."""
    parts = [inputs["skipp"], inputs["tx8p"], inputs["tx16p"],
             inputs["tx32p"], inputs["segprob"], inputs["skipseg"],
             T.DEFAULT_KF_PARTITION_PROBS, T.DEFAULT_KF_YMODE_PROBS,
             T.DEFAULT_KF_UVMODE_PROBS, inputs["coef11"]]
    return np.concatenate([np.asarray(p).reshape(-1) for p in parts]) \
        .astype(np.uint8)


_TABLES = {}


def _tables_dev(dev):
    """The scan, neighbour and band tables on `dev` (int16, int16,
    uint8), copied there once."""
    tabs = _TABLES.get(dev)
    if tabs is None:
        sc, nb = _scans_i32()
        tabs = (torch.as_tensor(sc.astype(np.int16), device=dev),
                torch.as_tensor(nb.astype(np.int16), device=dev),
                torch.as_tensor(_BANDS.astype(np.uint8), device=dev))
        _TABLES[dev] = tabs
    return tabs


def _launch(inputs, meta, dev):
    """One launch of csrc/passa.cu on CUDA device `dev`: decode_frame's
    outputs, each lane's rows sized by lane_caps, and stats [S, 2] int64
    (bools read, clock64 cycles of the lane's walk)."""
    S = meta["S"]
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
    p8 = torch.as_tensor(probs8(inputs), device=dev)
    qmul = torch.as_tensor(np.asarray(inputs["qmul"], np.int32), device=dev)
    scans, nbs, bands = _tables_dev(dev)
    i32 = torch.int32
    blocks = torch.empty((S, bcap, 34), dtype=i32, device=dev)
    cpairs = torch.empty((S, ccap, 2), dtype=i32, device=dev)
    epairs = torch.empty((S, ecap, 2), dtype=i32, device=dev)
    nblk, ncp, nep, err = (torch.empty(S, dtype=i32, device=dev)
                           for _ in range(4))
    counts = torch.empty((S, CNT_TOTAL), dtype=i32, device=dev)
    stats = torch.empty((S, 2), dtype=torch.int64, device=dev)
    if S:
        _cuda.launch("passa.cu", _SIGNATURES, "passa_walk", packet,
                     tile_off, tile_len, bounds, caps_d, p8, qmul, scans, nbs,
                     bands, S, meta["rows"], meta["cols"], meta["sb_cols"],
                     meta["sb_rows"], meta["txfmmode"], meta["seg"],
                     meta["lossless"], meta["bpp"], meta["ss_h"],
                     meta["ss_v"], meta["want_counts"], bcap, ccap, ecap,
                     blocks, nblk, cpairs, ncp, epairs, nep, counts, err,
                     stats)
        LAUNCHES["passa"] += 1
    return (blocks, nblk, cpairs, ncp, epairs, nep, counts, err, stats)


def decode_frame(inputs, meta, device, stats=False):
    """Run the walk on `device`: the kernel on a CUDA device, the plain
    version on the CPU. inputs, meta: prep_keyframe's. Each lane may
    write the rows lane_caps gives it (blocks, coefficient pairs, eob
    pairs), which no tile can overflow. Returns torch tensors on
    `device`: (blocks [S, bmax, 34], nblk [S], cpairs [S, cmax, 2], ncp
    [S], epairs [S, emax, 2], nep [S], counts [S, CNT_TOTAL] (zeros
    unless meta['want_counts']), err [S] int32 (ERR_* bits)), and with
    stats=True also [S, 2] int64 (bools a lane; the kernel's clock64
    cycles a lane, 0 on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cpu":
        out = decode_frame_plain(inputs, meta, dev)
    else:
        out = _launch(inputs, meta, dev)
    return out if stats else out[:8]


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
