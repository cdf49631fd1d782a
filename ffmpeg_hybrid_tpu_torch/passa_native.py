"""ctypes bridge to the native pass-A entropy decoder (vp9_entropy.c).

Field order of `NativeCtx` mirrors the C `Ctx` struct exactly.
"""
import ctypes as C
import os

import numpy as np

from .codecs.vp9 import tables as T

_LIB = None

u8p = C.POINTER(C.c_uint8)
i8p = C.POINTER(C.c_int8)
i16p = C.POINTER(C.c_int16)
i32p = C.POINTER(C.c_int32)
u32p = C.POINTER(C.c_uint32)


class NativeCtx(C.Structure):
    _fields_ = (
        [("cols", C.c_int32), ("rows", C.c_int32),
         ("sb_cols", C.c_int32), ("sb_rows", C.c_int32),
         ("ss_h", C.c_int32), ("ss_v", C.c_int32), ("bpp", C.c_int32),
         ("keyframe", C.c_int32), ("intraonly", C.c_int32),
         ("lossless", C.c_int32), ("txfmmode", C.c_int32),
         ("filtermode", C.c_int32), ("comppredmode", C.c_int32),
         ("allowcompinter", C.c_int32), ("fixcompref", C.c_int32),
         ("varcompref0", C.c_int32), ("varcompref1", C.c_int32),
         ("signbias", C.c_int32 * 3),
         ("highprecisionmvs", C.c_int32), ("errorres", C.c_int32),
         ("use_last_frame_mvs", C.c_int32), ("filter_level", C.c_int32),
         ("seg_enabled", C.c_int32), ("seg_update_map", C.c_int32),
         ("seg_temporal", C.c_int32), ("seg_absolute_vals", C.c_int32),
         ("tile_cols", C.c_int32), ("tile_rows", C.c_int32),
         ("log2_tile_cols", C.c_int32), ("log2_tile_rows", C.c_int32),
         ("seg_prob", C.c_uint8 * 7), ("seg_pred_prob", C.c_uint8 * 3),
         ("seg_skip_en", C.c_int32 * 8), ("seg_ref_en", C.c_int32 * 8),
         ("seg_ref_val", C.c_int32 * 8),
         ("qmul", (C.c_int32 * 2 * 2) * 8),
         ("lflvl", (C.c_uint8 * 2 * 4) * 8)]
        + [(n, u8p) for n in
           ("p_ymode", "p_uvmode", "p_filter", "p_mvmode", "p_intra",
            "p_comp", "p_single_ref", "p_comp_ref", "p_tx32", "p_tx16",
            "p_tx8", "p_skip", "p_mv_joint", "p_partition", "p_mv_sign",
            "p_mv_classes", "p_mv_class0", "p_mv_bits", "p_mv_c0fp",
            "p_mv_fp", "p_mv_c0hp", "p_mv_hp", "coef11")]
        + [("t_partition_tree", i8p), ("t_kf_part_probs", u8p),
           ("t_seg_tree", i8p), ("t_intramode_tree", i8p),
           ("t_kf_ymode", u8p), ("t_kf_uvmode", u8p),
           ("t_inter_mode_tree", i8p), ("t_filter_tree", i8p),
           ("t_filter_lut", u8p), ("t_mv_joint_tree", i8p),
           ("t_mv_class_tree", i8p), ("t_mv_fp_tree", i8p),
           ("t_intra_txfm_type", u8p), ("t_scans", i16p),
           ("t_scans_nb", i16p)]
        + [("coef_y", i32p), ("coef_u", i32p), ("coef_v", i32p),
           ("eob_y", i32p), ("eob_u", i32p), ("eob_v", i32p),
           ("txsz4", i8p), ("txtype4", i8p), ("uvtx4", i8p),
           ("inter4", u8p), ("inter4uv", u8p),
           ("mv4", i16p), ("uvmv4", i16p), ("ref4", i8p),
           ("comp4", u8p), ("filter4", i8p),
           ("lf_level", u8p), ("lf_mask", i32p),
           ("segmap", u8p), ("prev_segmap", u8p),
           ("cur_mv", i16p), ("cur_ref", i8p),
           ("prev_mv", i16p), ("prev_ref", i8p),
           ("a_partition", u8p), ("a_skip", u8p), ("a_txfm", u8p),
           ("a_segpred", u8p), ("a_intra", u8p), ("a_comp", u8p),
           ("a_ref", u8p), ("a_filter", u8p), ("a_mode", u8p),
           ("a_ynnz", u8p), ("a_uvnnz0", u8p), ("a_uvnnz1", u8p),
           ("a_mv", i32p)]
        + [(n, u32p) for n in
           ("c_ymode", "c_uvmode", "c_filter", "c_mvmode", "c_intra",
            "c_comp", "c_single_ref", "c_comp_ref", "c_tx32", "c_tx16",
            "c_tx8", "c_skip", "c_mv_joint", "c_partition", "c_coef",
            "c_eob", "c_mv_sign", "c_mv_classes", "c_mv_class0",
            "c_mv_bits", "c_mv_c0fp", "c_mv_fp", "c_mv_c0hp", "c_mv_hp")]
        + [("blocks_out", i16p), ("max_blocks", C.c_int32),
           ("n_blocks", C.c_int32), ("error", C.c_int32),
           ("nnz_cnt", C.c_int32 * 3), ("eob_cnt", C.c_int32 * 3),
           # direct (pos, value) pair emission (GPU pass-B mode)
           ("emit_pairs", C.c_int32), ("pairs_wide", C.c_int32),
           ("pairs_out", i16p), ("pairs_cap", C.c_int32),
           ("n_pairs", C.c_int32), ("eobp_out", i16p),
           ("eobp_cap", C.c_int32), ("n_eobp", C.c_int32),
           ("cbase", C.c_int32 * 3), ("ebase", C.c_int32 * 3),
           ("cur_cbase", C.c_int32), ("skip_counts", C.c_int32),
           ("row_counts", i32p), ("records_sorted", C.c_int32)]
    )


# The C sources live in the repo's native/ directory; the port builds
# its own copy of the library into its build directory (never into
# native/), with the flags native/build.sh uses.
NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "build")
_SOURCES = ("vp9_entropy.c", "vp9_lpf.c")
_FLAGS = (["-O3", "-march=native", "-funroll-loops", "-fPIC", "-shared",
           "-Wall", "-Wno-unused-function", "-Wno-unused-const-variable"],
          ["-O3", "-fPIC", "-shared", "-Wall", "-Wno-unused-function"])


def _native_srchash(nat_dir):
    """sha256 over the C sources (the ABI the ctypes mirror tracks)."""
    import hashlib
    h = hashlib.sha256()
    for name in sorted(os.listdir(nat_dir)):
        if name.endswith((".c", ".h")):
            with open(os.path.join(nat_dir, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read() + b"\0")
    return h.hexdigest()


def _build(path):
    """gcc the pass-A library to a temporary name, then rename it into
    place, so concurrent builders (test workers) never load a partial
    file."""
    import subprocess
    import tempfile
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    srcs = [os.path.join(NATIVE_DIR, n) for n in _SOURCES]
    try:
        for flags in _FLAGS:
            r = subprocess.run(["gcc", *flags, *srcs, "-o", tmp],
                               capture_output=True, text=True)
            if r.returncode == 0:
                break
        else:
            raise OSError("native pass-A build failed:\n" + r.stderr)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def lib():
    """Load (building at first use, or when the C sources changed) the
    native pass-A library. The library's file name carries the source
    hash, so a stale binary is never loaded (a mismatched one would
    desync from the ctypes `Ctx` mirror and corrupt memory)."""
    global _LIB
    if _LIB is None:
        want = _native_srchash(NATIVE_DIR)
        path = os.path.join(BUILD_DIR, f"libvp9passa-{want[:16]}.so")
        if not os.path.exists(path):
            _build(path)
        _LIB = C.CDLL(path)
        _LIB.vp9_decode_tiles.restype = C.c_int
    return _LIB


def available() -> bool:
    try:
        lib()
        return True
    except Exception:
        return False


# normative tables in C-friendly contiguous layouts (built once)
_SCANS_PADDED = None
_SCANS_NB_PADDED = None


def _padded_scans():
    global _SCANS_PADDED, _SCANS_NB_PADDED
    if _SCANS_PADDED is None:
        sc = np.zeros((5, 4, 1024), np.int16)
        nb = np.zeros((5, 4, 1024, 2), np.int16)
        for tx in range(5):
            for tt in range(4):
                a = T.SCANS[tx][tt]
                sc[tx, tt, :a.size] = a
                b = T.SCANS_NB[tx][tt]
                nb[tx, tt, :b.shape[0]] = b
        _SCANS_PADDED = np.ascontiguousarray(sc)
        _SCANS_NB_PADDED = np.ascontiguousarray(nb)
    return _SCANS_PADDED, _SCANS_NB_PADDED


def _p(arr, typ):
    return arr.ctypes.data_as(typ)


_KEEPALIVE_TABLES = {}


def _tbl(name, arr, typ):
    if name not in _KEEPALIVE_TABLES:
        _KEEPALIVE_TABLES[name] = np.ascontiguousarray(arr)
    return _p(_KEEPALIVE_TABLES[name], typ)


def _marshal_stable(s, ctx, keep):
    """Marshal the pointers that are stable for one (geometry, slot):
    probs/counts slot arrays, pooled output grids, above-ctx lines,
    normative tables, the pooled block-record buffer. ~80 ctypes
    pointer conversions — cached per slot so frames pay only the
    scalar updates (_marshal_frame)."""
    p = s.probs

    def arr(a, typ):
        a = np.ascontiguousarray(a)
        keep.append(a)
        return _p(a, typ)

    ctx.p_ymode = arr(p.y_mode, u8p)
    ctx.p_uvmode = arr(p.uv_mode, u8p)
    ctx.p_filter = arr(p.filter, u8p)
    ctx.p_mvmode = arr(p.mv_mode, u8p)
    ctx.p_intra = arr(p.intra, u8p)
    ctx.p_comp = arr(p.comp, u8p)
    ctx.p_single_ref = arr(p.single_ref, u8p)
    ctx.p_comp_ref = arr(p.comp_ref, u8p)
    ctx.p_tx32 = arr(p.tx32p, u8p)
    ctx.p_tx16 = arr(p.tx16p, u8p)
    ctx.p_tx8 = arr(p.tx8p, u8p)
    ctx.p_skip = arr(p.skip, u8p)
    ctx.p_mv_joint = arr(p.mv_joint, u8p)
    ctx.p_partition = arr(p.partition, u8p)
    ctx.p_mv_sign = arr(p.mv_sign, u8p)
    ctx.p_mv_classes = arr(p.mv_classes, u8p)
    ctx.p_mv_class0 = arr(p.mv_class0, u8p)
    ctx.p_mv_bits = arr(p.mv_bits, u8p)
    ctx.p_mv_c0fp = arr(p.mv_class0_fp, u8p)
    ctx.p_mv_fp = arr(p.mv_fp, u8p)
    ctx.p_mv_c0hp = arr(p.mv_class0_hp, u8p)
    ctx.p_mv_hp = arr(p.mv_hp, u8p)

    ctx.t_partition_tree = _tbl("ptree", T.PARTITION_TREE, i8p)
    ctx.t_kf_part_probs = _tbl("kfpart", T.DEFAULT_KF_PARTITION_PROBS, u8p)
    ctx.t_seg_tree = _tbl("segtree", T.SEGMENTATION_TREE, i8p)
    ctx.t_intramode_tree = _tbl("imtree", T.INTRAMODE_TREE, i8p)
    ctx.t_kf_ymode = _tbl("kfy", T.DEFAULT_KF_YMODE_PROBS, u8p)
    ctx.t_kf_uvmode = _tbl("kfuv", T.DEFAULT_KF_UVMODE_PROBS, u8p)
    ctx.t_inter_mode_tree = _tbl("intree", T.INTER_MODE_TREE, i8p)
    ctx.t_filter_tree = _tbl("ftree", T.FILTER_TREE, i8p)
    ctx.t_filter_lut = _tbl("flut", T.FILTER_LUT.astype(np.uint8), u8p)
    ctx.t_mv_joint_tree = _tbl("mvjt", T.MV_JOINT_TREE, i8p)
    ctx.t_mv_class_tree = _tbl("mvct", T.MV_CLASS_TREE, i8p)
    ctx.t_mv_fp_tree = _tbl("mvft", T.MV_FP_TREE, i8p)
    ctx.t_intra_txfm_type = _tbl("itt", T.INTRA_TXFM_TYPE.astype(np.uint8),
                                 u8p)
    sc, nb = _padded_scans()
    ctx.t_scans = _p(sc, i16p)
    ctx.t_scans_nb = _p(nb, i16p)

    ctx.coef_y = _p(s.coef_y, i32p)
    ctx.coef_u = _p(s.coef_u, i32p)
    ctx.coef_v = _p(s.coef_v, i32p)
    ctx.eob_y = _p(s.eob_y, i32p)
    ctx.eob_u = _p(s.eob_u, i32p)
    ctx.eob_v = _p(s.eob_v, i32p)
    ctx.txsz4 = _p(s.txsz4, i8p)
    ctx.txtype4 = _p(s.txtype4, i8p)
    ctx.uvtx4 = _p(s.uvtx4, i8p)
    ctx.inter4 = _p(s.inter4.view(np.uint8), u8p)
    ctx.inter4uv = _p(s.inter4uv.view(np.uint8), u8p)
    ctx.mv4 = _p(s.mv4, i16p)
    ctx.uvmv4 = _p(s.uvmv4, i16p)
    ctx.ref4 = _p(s.ref4, i8p)
    ctx.comp4 = _p(s.comp4.view(np.uint8), u8p)
    ctx.filter4 = _p(s.filter4, i8p)
    ctx.lf_level = _p(s.lf_level, u8p)
    ctx.lf_mask = _p(s.lf_mask, i32p)

    ctx.a_partition = _p(s.above_partition_ctx, u8p)
    ctx.a_skip = _p(s.above_skip_ctx, u8p)
    ctx.a_txfm = _p(s.above_txfm_ctx, u8p)
    ctx.a_segpred = _p(s.above_segpred_ctx, u8p)
    ctx.a_intra = _p(s.above_intra_ctx, u8p)
    ctx.a_comp = _p(s.above_comp_ctx, u8p)
    ctx.a_ref = _p(s.above_ref_ctx, u8p)
    ctx.a_filter = _p(s.above_filter_ctx, u8p)
    ctx.a_mode = _p(s.above_mode_ctx, u8p)
    ctx.a_ynnz = _p(s.above_y_nnz_ctx, u8p)
    ctx.a_uvnnz0 = _p(s.above_uv_nnz_ctx[0], u8p)
    ctx.a_uvnnz1 = _p(s.above_uv_nnz_ctx[1], u8p)
    ctx.a_mv = _p(s.above_mv_ctx, i32p)

    cnt = s.native_counts
    ctx.c_ymode = _p(cnt.y_mode, u32p)
    ctx.c_uvmode = _p(cnt.uv_mode, u32p)
    ctx.c_filter = _p(cnt.filter, u32p)
    ctx.c_mvmode = _p(cnt.mv_mode, u32p)
    ctx.c_intra = _p(cnt.intra, u32p)
    ctx.c_comp = _p(cnt.comp, u32p)
    ctx.c_single_ref = _p(cnt.single_ref, u32p)
    ctx.c_comp_ref = _p(cnt.comp_ref, u32p)
    ctx.c_tx32 = _p(cnt.tx32p, u32p)
    ctx.c_tx16 = _p(cnt.tx16p, u32p)
    ctx.c_tx8 = _p(cnt.tx8p, u32p)
    ctx.c_skip = _p(cnt.skip, u32p)
    ctx.c_mv_joint = _p(cnt.mv_joint, u32p)
    ctx.c_partition = _p(cnt.partition, u32p)
    ctx.c_coef = _p(cnt.coef, u32p)
    ctx.c_eob = _p(cnt.eob, u32p)
    ctx.c_mv_sign = _p(cnt.mv_sign, u32p)
    ctx.c_mv_classes = _p(cnt.mv_classes, u32p)
    ctx.c_mv_class0 = _p(cnt.mv_class0, u32p)
    ctx.c_mv_bits = _p(cnt.mv_bits, u32p)
    ctx.c_mv_c0fp = _p(cnt.mv_class0_fp, u32p)
    ctx.c_mv_fp = _p(cnt.mv_fp, u32p)
    ctx.c_mv_c0hp = _p(cnt.mv_class0_hp, u32p)
    ctx.c_mv_hp = _p(cnt.mv_hp, u32p)


def _marshal_frame(s, ctx):
    """Per-frame scalar/pointer updates on a (possibly cached) ctx."""
    h = s.header
    ctx.cols, ctx.rows = s.cols, s.rows
    ctx.sb_cols, ctx.sb_rows = s.sb_cols, s.sb_rows
    ctx.ss_h, ctx.ss_v, ctx.bpp = s.ss_h, s.ss_v, h.bpp
    ctx.keyframe, ctx.intraonly = int(h.keyframe), int(h.intraonly)
    ctx.lossless, ctx.txfmmode = int(h.lossless), int(h.txfmmode)
    ctx.filtermode = int(h.filtermode)
    ctx.comppredmode = int(h.comppredmode)
    ctx.allowcompinter = int(h.allowcompinter)
    ctx.fixcompref = int(h.fixcompref)
    ctx.varcompref0, ctx.varcompref1 = int(h.varcompref[0]), \
        int(h.varcompref[1])
    for i in range(3):
        ctx.signbias[i] = int(h.signbias[i])
    ctx.highprecisionmvs = int(h.highprecisionmvs)
    ctx.errorres = int(h.errorres)
    ctx.use_last_frame_mvs = int(bool(h.use_last_frame_mvs)
                                 and s.prev_mv is not None)
    ctx.filter_level = int(h.filter_level)
    ctx.seg_enabled = int(h.seg_enabled)
    ctx.seg_update_map = int(h.seg_update_map)
    ctx.seg_temporal = int(h.seg_temporal)
    ctx.seg_absolute_vals = int(h.seg_absolute_vals)
    ctx.tile_cols, ctx.tile_rows = h.tile_cols, h.tile_rows
    ctx.log2_tile_cols, ctx.log2_tile_rows = h.log2_tile_cols, \
        h.log2_tile_rows
    for i in range(7):
        ctx.seg_prob[i] = h.seg_prob[i]
    for i in range(3):
        ctx.seg_pred_prob[i] = h.seg_pred_prob[i]
    # segment features: only segment 0 is reachable when segmentation
    # is off (seg_id stays 0), so skip marshalling the other 7
    nseg = 8 if h.seg_enabled else 1
    for i in range(nseg):
        f = h.seg_feat[i]
        ctx.seg_skip_en[i] = int(f.skip_enabled)
        ctx.seg_ref_en[i] = int(f.ref_enabled)
        ctx.seg_ref_val[i] = int(f.ref_val)
        qm = f.qmul
        for a in range(2):
            for b in range(2):
                ctx.qmul[i][a][b] = int(qm[a, b])
        lf = f.lflvl
        for a in range(4):
            for b in range(2):
                ctx.lflvl[i][a][b] = int(lf[a, b])

    ctx.coef11 = _p(s.coef11, u8p)
    ctx.segmap = _p(s.cur_segmap, u8p)
    ctx.prev_segmap = (_p(s.prev_segmap, u8p)
                       if s.prev_segmap is not None else None)
    ctx.cur_mv = _p(s.cur_mv, i16p)
    ctx.cur_ref = _p(s.cur_ref, i8p)
    ctx.prev_mv = _p(s.prev_mv, i16p) if s.prev_mv is not None else None
    ctx.prev_ref = _p(s.prev_ref, i8p) if s.prev_ref is not None else None


def decode_tiles_native(s, data: bytes) -> bool:
    """Run the native pass A over the tile data. Fills the same output
    tensors as the Python TileDecoder path. Returns True on success."""
    if not available():
        return False
    from .utils.metrics import metrics
    _t_marshal = metrics.timer("passa.marshal")
    _t_marshal.__enter__()
    h = s.header

    # per-(geometry, slot) cached ctx: every pooled-array pointer is
    # stable across the pool period, so only _marshal_frame runs per
    # frame (the full pointer marshal costs ~0.8 ms/frame)
    geom_key = s._geom_pool[0] if getattr(s, "_geom_pool", None) else None
    cacheable = (geom_key is not None
                 and s._probs_pool is not None
                 and s.probs is s._probs_pool[s._slot]
                 and s._counts_pool is not None
                 and s.native_counts is s._counts_pool[s._slot])
    if cacheable:
        cache = getattr(s, "_nctx_cache", None)
        if cache is None or cache[0] != geom_key:
            cache = (geom_key, {})
            s._nctx_cache = cache
        ent = cache[1].get(s._slot)
        if ent is None:
            ctx = NativeCtx()
            keep = []
            _marshal_stable(s, ctx, keep)
            blocks = s.blocks_buf
            ctx.blocks_out = _p(blocks, i16p)
            ctx.max_blocks = blocks.shape[0]
            cache[1][s._slot] = (ctx, keep, blocks)
        else:
            ctx, keep, blocks = ent
    else:
        ctx = NativeCtx()
        keep = []
        _marshal_stable(s, ctx, keep)
        max_blocks = s.cols * s.rows + 64
        blocks = np.zeros((max_blocks, 36), np.int16)
        ctx.blocks_out = _p(blocks, i16p)
        ctx.max_blocks = max_blocks
    _marshal_frame(s, ctx)

    # direct (pos, value) pair emission: the GPU pass B consumes the
    # merged pair buffers, never the dense coef planes, so pass A emits
    # the upload rows itself (skipping the dense splats and the
    # separate pack pass). Disabled for invalid-scale frames.
    emit = (getattr(s, "coef_pairs_buf", None) is not None
            and not getattr(s, "_emit_disable", False)
            and not any(sc[0] == -1
                        for sc in getattr(s, "mvscale", [])))
    s.coef_pairs = None
    pbuf = ebuf = None
    ctx.emit_pairs = 0  # cached ctx: clear last frame's flag
    if emit:
        wide = h.bpp > 8
        pw = 4 if wide else 3
        pbuf = s.coef_pairs_buf
        ebuf = s.eob_pairs_buf
        ctx.emit_pairs = 1
        ctx.pairs_wide = int(wide)
        ctx.pairs_out = _p(pbuf, i16p)
        ctx.pairs_cap = pbuf.size // pw
        ctx.eobp_out = _p(ebuf, i16p)
        ctx.eobp_cap = ebuf.shape[0]
        ys, us = s.coef_y.size, s.coef_u.size
        ey, eu = s.eob_y.size, s.eob_u.size
        ctx.cbase[0], ctx.cbase[1], ctx.cbase[2] = 0, ys, ys + us
        ctx.ebase[0], ctx.ebase[1], ctx.ebase[2] = 0, ey, ey + eu

    # backward adaptation (the only counts consumer) runs iff
    # refreshctx && !parallelmode (reference: vp9.c:1821-1824)
    ctx.skip_counts = int(not (h.refreshctx and not h.parallelmode))

    buf = np.frombuffer(data, np.uint8)
    _t_marshal.__exit__(None, None, None)
    with metrics.timer("passa.c_decode"):
        rc = lib().vp9_decode_tiles(C.byref(ctx), _p(buf, u8p), len(data))
    if rc == -3:
        # pathological frame: >1/3 of all coefficients nonzero. Re-run
        # densely; safe because pass A is restartable (bool coders
        # re-init from the packet, every per-frame output grid is
        # rewritten, the C entry re-zeroes the pooled count arrays, and
        # the above-ctx subset that carries state is re-reset here
        # exactly as at frame entry). native_counts stays the pooled
        # slot object (the cached ctx points at its arrays).
        s._reset_above_ctx()
        if s._counts_pool is None or \
                s.native_counts is not s._counts_pool[s._slot]:
            s.native_counts = s.counts_factory()
        s._emit_disable = True
        try:
            return decode_tiles_native(s, data)
        finally:
            s._emit_disable = False
    if rc != 0:
        raise ValueError(f"native pass A failed: {rc}")
    _t_post = metrics.timer("passa.post")
    _t_post.__enter__()
    if emit:
        pw = 4 if ctx.pairs_wide else 3
        s.coef_pairs = (pbuf[:ctx.n_pairs * pw].reshape(ctx.n_pairs, pw),
                        ebuf[:ctx.n_eobp])

    # keep the raw record array for the recon backends. The C decoder
    # merges threaded tile columns' records in (sb-row, tile) order
    # itself; the host sort only remains as a fallback for frames the
    # merge declined (sb_rows > 512 / scratch alloc failure). Python
    # Block objects are only materialized lazily (the GPU path reads
    # the records directly).
    if h.tile_cols > 1 and ctx.n_blocks and not ctx.records_sorted:
        view = blocks[:ctx.n_blocks]
        keys = (view[:, 0].astype(np.int64) // 8) * (1 << 16) \
            + view[:, 2].astype(np.int64)
        order = np.argsort(keys, kind="stable")
        blocks[:ctx.n_blocks] = view[order]
    s.block_records = blocks[:ctx.n_blocks]
    s.blocks = LazyBlocks(s.block_records)
    # per-plane (nonzero coef, coded tx block) counts from the decode
    # itself — lets the pair packer skip its counting pass
    s.coef_counts = [(int(ctx.nnz_cnt[i]), int(ctx.eob_cnt[i]))
                     for i in range(3)]
    _t_post.__exit__(None, None, None)
    return True


class LazyBlocks:
    """List-like view over the native block records; converts to Python
    Block tuples only if actually iterated."""

    def __init__(self, records):
        self._records = records
        self._list = None

    def _materialize(self):
        if self._list is None:
            from .codecs.vp9.blockdec import Block
            blks = []
            for r in self._records:
                b = Block()
                b.bs = int(r[3])
                b.seg_id = int(r[4])
                b.skip = int(r[5])
                b.intra = int(r[6])
                b.tx = int(r[7])
                b.uvtx = int(r[8])
                b.mode = [int(r[9]), int(r[10]), int(r[11]), int(r[12])]
                b.uvmode = int(r[13])
                b.comp = int(r[14])
                b.ref = [int(r[15]), int(r[16])]
                b.filter = int(r[17])
                b.mv = [[(int(r[18 + q * 4]), int(r[19 + q * 4])),
                         (int(r[20 + q * 4]), int(r[21 + q * 4]))]
                        for q in range(4)]
                blks.append((int(r[0]), int(r[1]), int(r[2]), b))
            self._list = blks
        return self._list

    def __iter__(self):
        return iter(self._materialize())

    def __len__(self):
        return len(self._records)


def count_pairs_native(coef, eob4, txg):
    """Count (nonzero coef, coded tx block) pairs. None if no native."""
    if not available():
        return None
    counts = np.zeros(2, np.int32)
    r4, c4 = eob4.shape
    lib().vp9_count_pairs(
        _p(coef, i32p), C.c_int(coef.shape[1]),
        _p(eob4, i32p), _p(txg, i8p), C.c_int(r4), C.c_int(c4),
        _p(counts, i32p))
    return int(counts[0]), int(counts[1])


def pack_pairs_native(coef, eob4, txg, cp_out, ep_out, cbase=0,
                      ebase=0) -> bool:
    """cbase/ebase offset every emitted position — lets the three
    planes pack into one merged buffer for a single upload+scatter."""
    if not available():
        return False
    r4, c4 = eob4.shape
    fn = (lib().vp9_pack_pairs_wide if cp_out.shape[1] == 4
          else lib().vp9_pack_pairs)
    rc = fn(
        _p(coef, i32p), C.c_int(coef.shape[1]),
        _p(eob4, i32p), _p(txg, i8p), C.c_int(r4), C.c_int(c4),
        C.c_int32(cbase), C.c_int32(ebase),
        _p(cp_out, i16p), C.c_int(cp_out.shape[0]),
        _p(ep_out, i16p), C.c_int(ep_out.shape[0]))
    if rc != 0:
        raise ValueError("pair packing overflow")
    return True


def lpf_record_native(s):
    """Record the loop-filter edge-call sequence for the replay
    (ops/lpf_replay.py): native/vp9_lpf.c's vp9_lpf_record walks the
    frame's level and mask grids in the reference's order. Returns
    (y_recs, ny, uv_recs, nuv) int16 [n, 8] arrays (sb, py, px, dir, wd,
    E, I, H)."""
    h = s.header
    y_max = uv_max = 1 << 19
    y_rec = np.zeros((y_max, 8), np.int16)
    uv_rec = np.zeros((uv_max, 8), np.int16)
    ny = C.c_int32(0)
    nuv = C.c_int32(0)
    lim = np.ascontiguousarray(s.lim_lut.astype(np.int32))
    mblim = np.ascontiguousarray(s.mblim_lut.astype(np.int32))
    lib().vp9_lpf_record(
        _p(s.lf_level, u8p), _p(s.lf_mask, i32p),
        C.c_int(s.sb_rows), C.c_int(s.sb_cols),
        C.c_int(s.ss_h), C.c_int(s.ss_v),
        _p(lim, i32p), _p(mblim, i32p), C.c_int(h.bpp),
        _p(y_rec, i16p), C.c_int(y_max), C.byref(ny),
        _p(uv_rec, i16p), C.c_int(uv_max), C.byref(nuv))
    if ny.value >= y_max or nuv.value >= uv_max:
        # the recorder stops at a full buffer: the stream would be cut
        raise RuntimeError(f"loop-filter recorder overflow ({ny.value}, "
                           f"{nuv.value} records)")
    return y_rec, ny.value, uv_rec, nuv.value


_MODE_CONV_ARR = None


def _mode_conv_arr():
    global _MODE_CONV_ARR
    if _MODE_CONV_ARR is None:
        from .codecs.vp9.golden import MODE_CONV
        a = np.zeros((10, 2, 2), np.int8)
        for m, (no_l, has_l) in MODE_CONV.items():
            # MODE_CONV[mode][have_left][have_top]
            a[m, 0, 0], a[m, 0, 1] = no_l
            a[m, 1, 0], a[m, 1, 1] = has_l
        _MODE_CONV_ARR = a
    return _MODE_CONV_ARR


def intra_schedule_native(s, plane_idx, r4, c4):
    """C intra wavefront schedule (entries + (level, sz) keys) from the
    native block records. Returns (entries [n, 8] int16, keys [n, 2]
    int32) or None when unavailable."""
    if not available() or s.block_records is None:
        return None
    recs = np.ascontiguousarray(s.block_records, np.int16)
    cap = r4 * c4 + 64
    ents = np.empty((cap, 8), np.int16)
    keys = np.empty((cap, 2), np.int32)
    lw = np.zeros((r4 + 8) * (c4 + 8), np.int32)
    n = lib().vp9_intra_schedule(
        _p(recs, i16p), C.c_int(len(recs)),
        C.c_int(s.cols), C.c_int(s.rows),
        C.c_int(s.ss_h), C.c_int(s.ss_v),
        C.c_int(plane_idx), C.c_int(r4), C.c_int(c4),
        _p(_mode_conv_arr(), i8p), _p(lw, i32p),
        _p(ents, i16p), _p(keys, i32p), C.c_int(cap))
    if n < 0:
        return None
    return ents[:n], keys[:n]


def _chdr_prob_ptrs(p):
    return (
        _p(p.tx8p, u8p), _p(p.tx16p, u8p), _p(p.tx32p, u8p),
        _p(p.coef, u8p), _p(p.skip, u8p), _p(p.mv_mode, u8p),
        _p(p.filter, u8p), _p(p.intra, u8p), _p(p.comp, u8p),
        _p(p.single_ref, u8p), _p(p.comp_ref, u8p), _p(p.y_mode, u8p),
        _p(p.partition, u8p), _p(p.mv_joint, u8p), _p(p.mv_sign, u8p),
        _p(p.mv_classes, u8p), _p(p.mv_class0, u8p), _p(p.mv_bits, u8p),
        _p(p.mv_class0_fp, u8p), _p(p.mv_fp, u8p),
        _p(p.mv_class0_hp, u8p), _p(p.mv_hp, u8p))


def parse_chdr_native(data: bytes, h, probs, dec=None) -> bool:
    """Native compressed-header parse (txfm mode + all prob updates),
    updating `probs` arrays in place and h.txfmmode/h.comppredmode —
    mirrors header.parse_compressed_header (reference: vp9.c:908-1113).
    Returns False when the native library is unavailable. When `dec`
    is the owning decoder and `probs` is one of its pooled slots, the
    22 probability-array pointers are cached per slot."""
    if not available():
        return False
    interframe = not (h.keyframe or h.intraonly)
    buf = np.frombuffer(data, np.uint8)
    txfm = C.c_int32(0)
    cpm = C.c_int32(0)
    ptrs = None
    if dec is not None and dec._probs_pool is not None \
            and probs is dec._probs_pool[dec._slot]:
        cache = getattr(dec, "_chdr_ptr_cache", None)
        if cache is None:
            cache = dec._chdr_ptr_cache = {}
        ptrs = cache.get(dec._slot)
        if ptrs is None:
            ptrs = cache[dec._slot] = _chdr_prob_ptrs(probs)
    if ptrs is None:
        ptrs = _chdr_prob_ptrs(probs)
    rc = lib().vp9_parse_chdr(
        _p(buf, u8p), C.c_int(len(data)),
        C.c_int(int(h.lossless)), C.c_int(int(interframe)),
        C.c_int(int(h.filtermode == 4)),          # FILTER_SWITCHABLE
        C.c_int(int(getattr(h, "allowcompinter", 0) or 0)),
        C.c_int(int(h.highprecisionmvs)),
        C.byref(txfm), C.byref(cpm), *ptrs)
    if rc != 0:
        raise ValueError("Marker bit was set")
    h.txfmmode = txfm.value
    if interframe:
        h.comppredmode = cpm.value
    return True
