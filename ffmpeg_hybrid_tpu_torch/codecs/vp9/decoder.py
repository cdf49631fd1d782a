"""VP9 frame decoder orchestration: header parse, pass-A tile entropy
decode into dense tensors, pass-B reconstruction on the card (PyTorch,
ops/recon.py), reference-slot rotation, probability adaptation.

Behavioral reference: vp9_decode_frame / decode_tiles
(libavcodec/vp9.c:1302-1863). The architecture differs deliberately:
instead of interleaved per-superblock recon, pass A entropy-decodes the
whole frame into dense per-frame tensors, then pass B reconstructs the
frame in bulk (intra wavefront + batched transforms) — the
accelerator-native generalization of the reference's 2-pass and
WebGPU accumulate-then-dispatch modes (vp9.c:1731, vp9_webgpu.c:2956).
"""
from __future__ import annotations

import numpy as np
import torch

from . import tables as T
from .blockdec import TileDecoder, Block
from .header import (Header, parse_uncompressed_header,
                     parse_compressed_header)
from .probs import Probs
from .prob import adapt_probs
from ...utils.metrics import metrics
from .rac import BoolDecoder
from .counts import Counts


# Frame host buffers are recycled through a geometry-keyed pool (the
# reference's refstruct frame pool, vp9.c:120-130): fresh 8MB mmap'd
# allocations cost ~200ms/frame on this host.  Buffers return to the
# pool when the owning Frame is garbage-collected (weakref.finalize), so
# frames held by the caller stay valid indefinitely.
_FRAME_POOL: dict = {}
_FRAME_POOL_MAX = 16


def _pool_return(key, bufs):
    lst = _FRAME_POOL.setdefault(key, [])
    if len(lst) < _FRAME_POOL_MAX:
        lst.append(bufs)


class Frame:
    """One decoded frame slot: planes + cross-frame prediction state
    (mirrors VP9Frame: ProgressFrame + segmentation_map + mv grid,
    reference: vp9shared.h:66-77)."""

    def __init__(self, w, h, ss_h, ss_v, bpp):
        import weakref
        self.size = (w, h)
        self.ss_h, self.ss_v = ss_h, ss_v
        self.bpp = bpp
        sb_cols = (w + 63) >> 6
        sb_rows = (h + 63) >> 6
        self.sb_cols, self.sb_rows = sb_cols, sb_rows
        H, W = sb_rows * 64, sb_cols * 64
        key = (H, W, ss_h, ss_v)
        lst = _FRAME_POOL.get(key)
        if lst:
            bufs = lst.pop()
        else:
            dt = np.int32
            # np.empty: every pixel read downstream is first written by
            # recon (MC/intra clamp reads to the coded area)
            bufs = {
                "planes": [np.empty((H, W), dt),
                           np.empty((H >> ss_v, W >> ss_h), dt),
                           np.empty((H >> ss_v, W >> ss_h), dt)],
                "seg_map": np.empty((sb_rows * 8, sb_cols * 8), np.uint8),
                "mv": np.empty((sb_rows * 8, sb_cols * 8, 2, 2), np.int16),
                "refs": np.empty((sb_rows * 8, sb_cols * 8, 2), np.int8),
            }
        self.planes = bufs["planes"]
        self.seg_map = bufs["seg_map"]
        self.mv = bufs["mv"]
        self.refs = bufs["refs"]
        # cross-frame state grids must start deterministic (cells beyond
        # the coded area are never splatted but are read clamped)
        self.seg_map.fill(0)
        self.mv.fill(0)
        self.refs.fill(-1)
        weakref.finalize(self, _pool_return, key, bufs)
        # device-resident planes: int32 torch tensors set by pass B;
        # host `planes` are synced lazily on first pixel access
        self.dev = None
        self._host_stale = False
        # encode-params side data (set when the decoder was opened with
        # export_enc_params; show-existing re-outputs the donor frame's
        # data, matching av_frame_ref side-data copy semantics)
        self.enc_params = None

    def sync_host(self):
        if self._host_stale and self.dev is not None:
            # cast to the narrow output dtype and crop on the device
            # before pulling (4x+ fewer bytes than the padded int32
            # planes)
            w, h = self.size
            # pull the full 8px-aligned coded area, not just the
            # visible crop: the loop filter (and intra edges) touch
            # coded-but-invisible bottom/right pixels whose values feed
            # visible ones
            cw, ch = ((w + 7) >> 3) * 8, ((h + 7) >> 3) * 8
            dt = torch.uint8 if self.bpp == 8 else torch.int16
            for i in range(3):
                ph = ch if i == 0 else ch >> self.ss_v
                pw = cw if i == 0 else cw >> self.ss_h
                small = self.dev[i][:ph, :pw].to(dt)
                self.planes[i][:ph, :pw] = small.cpu().numpy()
            self._host_stale = False

    def crop(self):
        self.sync_host()
        w, h = self.size
        y = self.planes[0][:h, :w]
        cw = (w + self.ss_h) >> self.ss_h
        ch = (h + self.ss_v) >> self.ss_v
        u = self.planes[1][:ch, :cw]
        v = self.planes[2][:ch, :cw]
        return y, u, v

    def to_bytes(self) -> bytes:
        """Raw video bytes (planar YUV, 8-bit or 16-bit LE) as the
        rawvideo encoder produces for framemd5."""
        if self._host_stale and self.dev is not None:
            # the visible planes, cast and joined on the device, in one
            # copy of the output's own bytes (the host planes stay
            # stale: sync_host pulls them for whoever reads them)
            w, h = self.size
            cw = (w + self.ss_h) >> self.ss_h
            ch = (h + self.ss_v) >> self.ss_v
            dt = torch.uint8 if self.bpp == 8 else torch.int16
            flat = torch.cat([p[:ph, :pw].to(dt).reshape(-1) for p, ph, pw
                              in zip(self.dev, (h, ch, ch), (w, cw, cw))])
            raw = flat.cpu().numpy()
            return (raw if self.bpp == 8 else raw.astype("<u2")).tobytes()
        y, u, v = self.crop()
        if self.bpp == 8:
            return (y.astype(np.uint8).tobytes()
                    + u.astype(np.uint8).tobytes()
                    + v.astype(np.uint8).tobytes())
        return (y.astype("<u2").tobytes() + u.astype("<u2").tobytes()
                + v.astype("<u2").tobytes())


class FrameJob:
    """Snapshot of one frame's pass-A outputs — everything pass-B
    reconstruction reads. Lets pass A of the next frame run (and mutate
    the decoder) while this frame's pass B is still dispatching."""
    __slots__ = ("ready", "outputs", "refs", "lim_lut", "mblim_lut",
                 "device", "pre", "_uv_levels", "coef_bufs",
                 "splat_states", "lf_schedules") + tuple(
        a for a in (
            "header", "cur_frame_obj", "mvscale", "mvstep", "blocks",
            "block_records", "coef_y", "coef_u", "coef_v", "eob_y",
            "eob_u", "eob_v", "txsz4", "txtype4", "uvtx4", "inter4",
            "inter4uv", "mv4", "uvmv4", "ref4", "comp4", "filter4",
            "lf_level", "lf_mask", "cols", "rows", "sb_cols", "sb_rows",
            "ss_h", "ss_v", "use_native", "coef_counts", "coef_pairs"))

    def __init__(self):
        self.pre = None
        # the dense coefficient buffers pass B scatters into (recon's
        # CoefBuffers by key): the decoder's own, kept from frame to
        # frame; a job made elsewhere starts with none. splat_states
        # likewise: the splat's index state (recon_cuda.SplatState by key),
        # and lf_schedules the loop filter's (lpf_dense.schedule_state)
        self.coef_bufs = {}
        self.splat_states = {}
        self.lf_schedules = {}


_JOB_ATTRS = (
    "header", "cur_frame_obj", "mvscale", "mvstep", "blocks",
    "block_records", "coef_y", "coef_u", "coef_v", "eob_y", "eob_u",
    "eob_v", "txsz4", "txtype4", "uvtx4", "inter4", "inter4uv", "mv4",
    "uvmv4", "ref4", "comp4", "filter4", "lf_level", "lf_mask",
    "cols", "rows", "sb_cols", "sb_rows", "ss_h", "ss_v", "use_native",
    "coef_counts", "coef_pairs", "lim_lut", "mblim_lut")


# pipeline depth the buffer pools must cover (see _setup_arrays)
POOL_DEPTH = 8


class VP9Decoder:
    """Stateful VP9 decoder. decode(packet) -> list of output Frames."""

    def __init__(self, device=None, use_native=None, pass_a_impl=None,
                 export_enc_params=False):
        # pass B runs on `device`: the card unless "cpu" is asked for
        from ...device import resolve
        self.device = resolve(device)
        self.export_enc_params = export_enc_params
        if use_native is None:
            from ...passa_native import available
            use_native = available()
        self.use_native = use_native
        # pass A on the host (native C or pure Python), or with
        # pass_a_impl="device" the walk of ops/passa_device.py on
        # self.device (the kernel on the card, its plain version on the
        # CPU), for every frame with one tile row
        if pass_a_impl not in (None, "host", "device"):
            raise ValueError(f"unknown pass_a_impl {pass_a_impl!r}")
        self.pass_a_impl = pass_a_impl or "host"
        # the frames the device pass A sent to the host pass A
        self.pass_a_host_frames = 0
        self.header: Header | None = None
        self.prob_ctx = [None, None, None, None]  # 4 frame contexts
        self.refs: list[Frame | None] = [None] * 8
        self.cur_frame: Frame | None = None   # last decoded (CUR slot)
        self.mvpair_frame: Frame | None = None
        self.segmap_frame: Frame | None = None
        self.last_keyframe = 0
        self.lim_lut = np.zeros(64, np.int32)
        self.mblim_lut = np.zeros(64, np.int32)
        # per-frame state set up in _setup_frame
        self.probs: Probs | None = None
        self.coef11 = None
        # per-frame pool slot (native fast path): probs/counts/coef11
        # slots and the geometry pool rotate together so the native
        # pass A can cache its marshalled ctx per (geometry, slot)
        self._slot = 0
        self._probs_pool = None
        self._counts_pool = None
        # pass B's kept dense coefficient buffers (ops/recon.py
        # CoefBuffers), this decoder's alone: its frames' scatters and
        # consuming residuals alternate on them in decode order; and the
        # splat's index state (ops/recon_cuda.py SplatState), which two
        # decoders of one geometry on two threads must not share, and the
        # loop filter's schedule states (ops/lpf_dense.py schedule_state),
        # which two decoders on two streams must not share
        self.coef_bufs = {}
        self.splat_states = {}
        self.lf_schedules = {}

    # -- pass A frame context API used by TileDecoder ------------------
    def counts_factory(self):
        return Counts()

    def _reset_above_ctx(self):
        """Per-frame reset of the above-ctx subset that carries state
        (reference: vp9.c:1720-1730); also used to restart pass A after
        a pair-buffer overflow retry."""
        cols = self.cols
        h = self.header
        sb_cols = self.sb_cols
        self.above_partition_ctx[:cols] = 0
        self.above_skip_ctx[:cols] = 0
        if h.keyframe or h.intraonly:
            self.above_mode_ctx[:cols * 2] = 2  # DC_PRED
        else:
            self.above_mode_ctx[:cols] = 10  # NEARESTMV
        self.above_y_nnz_ctx[:sb_cols * 16] = 0
        self.above_uv_nnz_ctx[0, :sb_cols * 16 >> self.ss_h] = 0
        self.above_uv_nnz_ctx[1, :sb_cols * 16 >> self.ss_h] = 0
        self.above_segpred_ctx[:cols] = 0

    def _setup_arrays(self):
        sb_cols, sb_rows = self.sb_cols, self.sb_rows
        n8 = sb_cols * 8
        # above-ctx arrays persist across frames at constant geometry;
        # only a subset is reset per frame (reference: vp9.c:1720-1730)
        if getattr(self, "_above_n8", None) != n8:
            self._above_n8 = n8
            self.above_partition_ctx = np.zeros(n8, np.uint8)
            self.above_skip_ctx = np.zeros(n8, np.uint8)
            self.above_txfm_ctx = np.zeros(n8, np.uint8)
            self.above_segpred_ctx = np.zeros(n8, np.uint8)
            self.above_intra_ctx = np.zeros(n8, np.uint8)
            self.above_comp_ctx = np.zeros(n8, np.uint8)
            self.above_ref_ctx = np.zeros(n8, np.uint8)
            self.above_filter_ctx = np.zeros(n8, np.uint8)
            self.above_mode_ctx = np.zeros(2 * n8, np.uint8)
            self.above_y_nnz_ctx = np.zeros(2 * n8, np.uint8)
            self.above_uv_nnz_ctx = np.zeros((2, 2 * n8), np.uint8)
            self.above_mv_ctx = np.zeros((2 * n8 + 2, 2, 2), np.int32)
        self._reset_above_ctx()
        h = self.header
        # per-frame output tensors.  With the native pass A the big
        # dense buffers are drawn from a small rotating pool at constant
        # geometry: the C decoder zeroes each coded block's coefficient
        # region itself, stale cells elsewhere are masked out by the
        # (re-zeroed) eob grids, and the 3-deep rotation keeps a buffer
        # alive until any in-flight async device upload of it has long
        # completed.  The pure-Python pass A writes sparsely and keeps
        # fresh allocations.
        H64, W64 = sb_rows * 64, sb_cols * 64
        ss_h, ss_v = self.ss_h, self.ss_v
        r4, c4 = sb_rows * 16, sb_cols * 16
        r4u, c4u = r4 >> ss_v, c4 >> ss_h

        def alloc():
            # pair-emission buffers: capacity for 1/3 of all
            # coefficients nonzero (observed content peaks ~12%; the
            # native decode retries densely on overflow), exact bound
            # for the eob cells
            npix = H64 * W64 + 2 * ((H64 >> ss_v) * (W64 >> ss_h))
            ncell = r4 * c4 + 2 * r4u * c4u
            return {
                "coef_pairs_buf": np.zeros(((npix // 3) * 4,), np.int16),
                "eob_pairs_buf": np.zeros((ncell, 3), np.int16),
                "coef_y": np.zeros((H64, W64), np.int32),
                "coef_u": np.zeros((H64 >> ss_v, W64 >> ss_h), np.int32),
                "coef_v": np.zeros((H64 >> ss_v, W64 >> ss_h), np.int32),
                "eob_y": np.zeros((r4, c4), np.int32),
                "eob_u": np.zeros((r4u, c4u), np.int32),
                "eob_v": np.zeros((r4u, c4u), np.int32),
                "lf_level": np.zeros((sb_rows, sb_cols, 8, 8), np.uint8),
                "lf_mask": np.zeros((sb_rows, sb_cols, 2, 2, 8, 4),
                                    np.int32),
                "txsz4": np.zeros((r4, c4), np.int8),
                "txtype4": np.zeros((r4, c4), np.int8),
                "uvtx4": np.zeros((r4u, c4u), np.int8),
                "inter4": np.zeros((r4, c4), bool),
                "inter4uv": np.zeros((r4u, c4u), bool),
                "mv4": np.zeros((r4, c4, 2, 2), np.int16),
                "uvmv4": np.zeros((r4u, c4u, 2, 2), np.int16),
                "ref4": np.zeros((r4, c4, 2), np.int8),
                "comp4": np.zeros((r4, c4), bool),
                "filter4": np.zeros((r4, c4), np.int8),
                # native block records (C writes every emitted row incl.
                # the 2 pad slots, so stale content never leaks)
                "blocks_buf": np.empty(
                    (sb_cols * 8 * sb_rows * 8 + 64, 36), np.int16),
            }

        key = (H64, W64, ss_h, ss_v)
        if self.use_native:
            # 8-deep: the 4-stage pipelined mode keeps up to 7 frames'
            # buffers live (pass-A in-progress, qa slot, precompute
            # current, qb slot, upload current, qc slot, pass-B
            # current) plus one of margin for in-flight async device
            # uploads. All pools rotate on the shared per-frame _slot
            # so the native pass A can cache its ctx per slot.
            pool = getattr(self, "_geom_pool", None)
            if pool is None or pool[0] != key:
                pool = (key, [alloc() for _ in range(POOL_DEPTH)])
                self._geom_pool = pool
            gen = pool[1][self._slot]
            for name, arr in gen.items():
                setattr(self, name, arr)
            # grids whose stale content is NOT fully overwritten or
            # masked (eob planes, lf_mask) are re-zeroed inside
            # vp9_decode_tiles, with the GIL released
        else:
            for name, arr in alloc().items():
                setattr(self, name, arr)
        self.blocks: list = []
        self.block_records = None
        # cross-block state grids
        self.cur_segmap = self.cur_frame_obj.seg_map
        self.cur_mv = self.cur_frame_obj.mv
        self.cur_ref = self.cur_frame_obj.refs
        if self.mvpair_frame is not None and self.header.use_last_frame_mvs:
            self.prev_mv = self.mvpair_frame.mv
            self.prev_ref = self.mvpair_frame.refs
        else:
            self.prev_mv = self.prev_ref = None
        self.prev_segmap = (self.segmap_frame.seg_map
                            if self.segmap_frame is not None else None)

    def record_block(self, td: TileDecoder, b: Block):
        """Store one decoded block's state into the frame tensors/list."""
        blk = Block()
        blk.bs, blk.bl, blk.bp = b.bs, b.bl, b.bp
        blk.seg_id, blk.skip, blk.intra = b.seg_id, b.skip, b.intra
        blk.tx, blk.uvtx = b.tx, b.uvtx
        blk.mode = list(b.mode)
        blk.uvmode = b.uvmode
        blk.comp = b.comp
        blk.ref = list(b.ref)
        blk.filter = b.filter
        blk.mv = [list(m) for m in b.mv]
        row, col = td.row, td.col
        self.blocks.append((row, col, td.tile_col_start, blk))

        # dense grid splat (pass-B inputs)
        from . import tables as _T
        h = self.header
        ss_h, ss_v = self.ss_h, self.ss_v
        w4 = int(_T.BWH_TAB[1, b.bs, 0]) * 2  # b4 units
        h4 = int(_T.BWH_TAB[1, b.bs, 1]) * 2
        r0, c0 = row * 2, col * 2
        self.txsz4[r0:r0 + h4, c0:c0 + w4] = b.tx
        ur0, uc0 = r0 >> ss_v, c0 >> ss_h
        uh4 = max(1, h4 >> ss_v)
        uw4 = max(1, w4 >> ss_h)
        self.uvtx4[ur0:ur0 + uh4, uc0:uc0 + uw4] = b.uvtx
        if b.intra:
            # per-b4 prediction mode -> transform type (sub-8x8 blocks have
            # per-quadrant modes; reference: intra_recon mode indexing)
            if b.bs > 9 and b.tx == 0:  # sub-8x8, TX_4X4
                for dy in range(h4):
                    for dx in range(w4):
                        m = b.mode[(dy & 1) * 2 + (dx & 1)]
                        self.txtype4[r0 + dy, c0 + dx] = \
                            _T.INTRA_TXFM_TYPE[m]
            else:
                self.txtype4[r0:r0 + h4, c0:c0 + w4] = \
                    _T.INTRA_TXFM_TYPE[b.mode[0]]
        else:
            self.txtype4[r0:r0 + h4, c0:c0 + w4] = 0
            self.inter4[r0:r0 + h4, c0:c0 + w4] = True
            self.inter4uv[ur0:ur0 + uh4, uc0:uc0 + uw4] = True
            self.comp4[r0:r0 + h4, c0:c0 + w4] = b.comp
            self.filter4[r0:r0 + h4, c0:c0 + w4] = b.filter
            self.ref4[r0:r0 + h4, c0:c0 + w4, 0] = b.ref[0]
            self.ref4[r0:r0 + h4, c0:c0 + w4, 1] = \
                b.ref[1] if b.comp else -1
            if b.bs <= 9:  # 8x8 and larger: single MV
                for ri in range(2):
                    self.mv4[r0:r0 + h4, c0:c0 + w4, ri, 0] = b.mv[0][ri][0]
                    self.mv4[r0:r0 + h4, c0:c0 + w4, ri, 1] = b.mv[0][ri][1]
                    self.uvmv4[ur0:ur0 + uh4, uc0:uc0 + uw4, ri, 0] = \
                        b.mv[0][ri][0]
                    self.uvmv4[ur0:ur0 + uh4, uc0:uc0 + uw4, ri, 1] = \
                        b.mv[0][ri][1]
            else:
                self._splat_sub8x8_mv(b, r0, c0, ur0, uc0)

    def _splat_sub8x8_mv(self, b, r0, c0, ur0, uc0):
        """Per-quadrant luma MVs + chroma MV averaging rules (incl. the
        libvpx 4:2:2 bug), mirroring vp9_mc_template.c:58-230."""
        from .inter import _avg_mv2, _avg_mv4
        ss_h, ss_v = self.ss_h, self.ss_v
        for ri in range(2):
            # luma: quadrant mapping
            for dy in range(2):
                for dx in range(2):
                    q = dy * 2 + dx
                    self.mv4[r0 + dy, c0 + dx, ri] = b.mv[q][ri]
            # chroma
            bs = b.bs
            if bs == 10:  # BS_8x4
                if ss_v:
                    uv = _avg_mv2(b.mv[0][ri], b.mv[2][ri])
                    self.uvmv4[ur0, uc0:uc0 + (2 >> ss_h), ri] = uv
                    if not ss_h:
                        self.uvmv4[ur0, uc0 + 1, ri] = uv
                else:
                    top = b.mv[0][ri]
                    bot = b.mv[2][ri] if ss_h == 0 else \
                        _avg_mv2(b.mv[0][ri], b.mv[2][ri])
                    for dx in range(2 >> ss_h):
                        self.uvmv4[ur0, uc0 + dx, ri] = top
                        self.uvmv4[ur0 + 1, uc0 + dx, ri] = bot
            elif bs == 11:  # BS_4x8
                if ss_h:
                    uv = _avg_mv2(b.mv[0][ri], b.mv[1][ri])
                    for dy in range(2 >> ss_v):
                        self.uvmv4[ur0 + dy, uc0, ri] = uv
                else:
                    for dy in range(2 >> ss_v):
                        self.uvmv4[ur0 + dy, uc0, ri] = b.mv[0][ri]
                        self.uvmv4[ur0 + dy, uc0 + 1, ri] = b.mv[1][ri]
            else:  # BS_4x4
                if ss_v:
                    if ss_h:
                        self.uvmv4[ur0, uc0, ri] = _avg_mv4(
                            b.mv[0][ri], b.mv[1][ri], b.mv[2][ri],
                            b.mv[3][ri])
                    else:
                        self.uvmv4[ur0, uc0, ri] = _avg_mv2(
                            b.mv[0][ri], b.mv[2][ri])
                        self.uvmv4[ur0, uc0 + 1, ri] = _avg_mv2(
                            b.mv[1][ri], b.mv[3][ri])
                else:
                    if ss_h:
                        self.uvmv4[ur0, uc0, ri] = _avg_mv2(
                            b.mv[0][ri], b.mv[1][ri])
                        # BUG (kept): wrong sub-block for 4:2:2 bottom
                        self.uvmv4[ur0 + 1, uc0, ri] = _avg_mv2(
                            b.mv[1][ri], b.mv[2][ri])
                    else:
                        for dy in range(2):
                            for dx in range(2):
                                self.uvmv4[ur0 + dy, uc0 + dx, ri] = \
                                    b.mv[dy * 2 + dx][ri]

    # ------------------------------------------------------------------
    def decode(self, data: bytes):
        """Decode one (non-superframe) packet. Returns list of Frames to
        output (0 or 1)."""
        return self.decode_pass_b(self.precompute_job(
            self.decode_pass_a(data)))

    def precompute_job(self, job: "FrameJob") -> "FrameJob":
        """Host precompute stage between pass A and pass B: intra
        schedule build and coefficient pair packing. Pure function of
        the job snapshot (fresh per-frame arrays + stateless native
        calls), so the pipelined mode runs it on its own thread,
        overlapped with BOTH the next frame's pass A and the previous
        frame's pass B."""
        if job.ready is None:
            from ...ops import recon
            with metrics.timer("decode.pass_b_precompute"):
                recon.precompute_host(job)
        return job

    def decode_stream(self, packets):
        """Pipelined decode of an iterable of packets: a 3-stage
        pipeline over threads. Stage 1 (worker): pass A host entropy
        decode of frame N+2 — frame-serial by spec (passA ->
        adapt_probs -> passA, reference: vp9.c:1821-1824). Stage 2
        (worker): pass-B host precompute of frame N+1 (pure function of
        the stage-1 snapshot). Stage 3 (calling thread): the upload of
        frame N's pass-B inputs and its pass B on the card. The upload
        is a synchronous copy on the default stream from the frame's
        own freshly packed host buffer, so the pooled pass-A buffers
        are never read by an in-flight copy. This is the form of the
        reference's frame threading (pthread_frame.c:501: header+
        entropy of N+1 overlaps recon of N). Yields output Frames in
        order."""
        import queue
        import threading

        err: list = []
        stop = threading.Event()
        _END = object()

        def put(q, item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def get(q):
            while not stop.is_set():
                try:
                    return q.get(timeout=0.05)
                except queue.Empty:
                    pass
            return _END

        qa: queue.Queue = queue.Queue(maxsize=1)
        qb: queue.Queue = queue.Queue(maxsize=1)

        def worker_a():
            try:
                for fd in packets:
                    if stop.is_set():
                        return
                    with metrics.timer("stage.a"):
                        job = self.decode_pass_a(fd)
                    if not put(qa, job):
                        return
            except BaseException as e:  # noqa: BLE001 - propagated below
                err.append(e)
            finally:
                put(qa, _END)

        def worker_pre():
            try:
                while True:
                    job = get(qa)
                    if job is _END:
                        break
                    with metrics.timer("stage.pre"):
                        job = self.precompute_job(job)
                    if not put(qb, job):
                        return
            except BaseException as e:  # noqa: BLE001 - propagated below
                err.append(e)
            finally:
                put(qb, _END)

        ta = threading.Thread(target=worker_a, daemon=True)
        tp = threading.Thread(target=worker_pre, daemon=True)
        ta.start()
        tp.start()
        try:
            while True:
                job = qb.get()
                if job is _END:
                    break
                with metrics.timer("stage.b"):
                    out = self.decode_pass_b(job)
                yield from out
        finally:
            # consumer may abandon the generator mid-stream (e.g. a
            # time-budgeted benchmark): unblock and reap the workers
            stop.set()
            ta.join()
            tp.join()
        if err:
            raise err[0]

    def decode_pass_a(self, data: bytes) -> "FrameJob":
        """Host stage: header parse, tile entropy decode into dense
        tensors, probability adaptation, ref-slot rotation, and pass-B
        host precomputation (intra schedule, coefficient packing, loop
        filter schedule). Returns a FrameJob snapshot that
        decode_pass_b can reconstruct independently of decoder state."""
        with metrics.timer("decode.hdr_uncomp"):
            h = parse_uncompressed_header(data, self)

        if h.show_existing_idx >= 0:
            f = self.refs[h.show_existing_idx]
            if f is None:
                raise ValueError("show-existing ref not available")
            job = FrameJob()
            job.ready = [f]
            return job

        # advance the shared pool slot (geometry arrays, probs, counts)
        self._slot = (self._slot + 1) % POOL_DEPTH

        # retain_segmap uses the *previous* frame's segmentation flags
        # (reference: vp9.c:1616-1617 evaluated before header parse)
        prev = self.header
        retain_segmap = (self.segmap_frame is not None and prev is not None
                         and (not prev.seg_enabled
                              or not prev.seg_update_map))
        self.header = h
        self.w, self.hgt = h.width, h.height
        self.cols = (h.width + 7) >> 3
        self.rows = (h.height + 7) >> 3
        self.sb_cols = (h.width + 63) >> 6
        self.sb_rows = (h.height + 63) >> 6
        self.ss_h, self.ss_v = h.ss_h, h.ss_v

        # frame slot rotation (reference: vp9.c:1656-1664)
        src = self.cur_frame if not (h.keyframe or h.intraonly or h.errorres)\
            else None
        if not retain_segmap or h.keyframe or h.intraonly:
            self.segmap_frame = src
        self.mvpair_frame = src
        self.cur_frame_obj = Frame(h.width, h.height, h.ss_h, h.ss_v, h.bpp)
        if (self.mvpair_frame is None
                or self.mvpair_frame.size != self.cur_frame_obj.size):
            self.segmap_frame = None

        # ref scale factors (reference: vp9.c:845-880)
        self.mvscale = [[0, 0] for _ in range(3)]
        self.mvstep = [[0, 0] for _ in range(3)]
        if not h.keyframe and not h.intraonly:
            valid = 0
            for i in range(3):
                ref = self.refs[h.refidx[i]]
                refw, refh = ref.size
                if refw == h.width and refh == h.height:
                    self.mvscale[i] = [0, 0]
                elif (h.width * 2 < refw or h.height * 2 < refh
                      or h.width > 16 * refw or h.height > 16 * refh):
                    self.mvscale[i] = [-1, -1]  # REF_INVALID_SCALE
                    continue
                else:
                    self.mvscale[i] = [(refw << 14) // h.width,
                                       (refh << 14) // h.height]
                    self.mvstep[i] = [16 * self.mvscale[i][0] >> 14,
                                      16 * self.mvscale[i][1] >> 14]
                valid += 1
            if not valid:
                raise ValueError("no valid reference frame")

        # frame context resets (reference: vp9.c:882-897)
        c = h.framectxid
        if any(p is None for p in self.prob_ctx):
            self.prob_ctx = [Probs.defaults() for _ in range(4)]
        if h.keyframe or h.errorres or (h.intraonly and h.resetctx == 3):
            self.prob_ctx = [Probs.defaults() for _ in range(4)]
        elif h.intraonly and h.resetctx == 2:
            self.prob_ctx[c] = Probs.defaults()

        # compressed header
        chdr = data[h.uncompressed_header_size:
                    h.uncompressed_header_size + h.compressed_header_size]
        if self.use_native:
            # pooled slot: stable array pointers for the cached native ctx
            if self._probs_pool is None:
                self._probs_pool = [Probs() for _ in range(POOL_DEPTH)]
            self.probs = self.prob_ctx[c].copy_into(
                self._probs_pool[self._slot])
        else:
            self.probs = self.prob_ctx[c].copy()
        with metrics.timer("decode.hdr_comp"):
            done = False
            if self.use_native:
                from ...passa_native import parse_chdr_native
                done = parse_chdr_native(chdr, h, self.probs, dec=self)
            if done:
                from .probs import coef_full
                self.coef11 = coef_full(self.probs.coef)
            else:
                self.coef11, _ = parse_compressed_header(chdr, h,
                                                         self.probs)

        with metrics.timer("decode.setup_arrays"):
            self._setup_arrays()

        # forward context refresh in parallel mode (reference: vp9.c:1738-52)
        if h.refreshctx and h.parallelmode:
            ctx = self.prob_ctx[c]
            for i in range(4):
                ctx.coef[i] = self.probs.coef[i].copy()
                if h.txfmmode == i:
                    break
            for fld in Probs.FIELDS:
                getattr(ctx, fld)[...] = getattr(self.probs, fld)

        # pass A: tile entropy decode (native C fast path when built)
        tile_data = data[h.uncompressed_header_size
                         + h.compressed_header_size:]
        self.coef_counts = None  # set by the native pass A
        self.coef_pairs = None    # set by the native pass A (pair emission)
        if self.pass_a_impl == "device" and h.tile_rows > 1:
            # the walk gives each tile-row lane its own zeroed above
            # ctx; the reference carries it across tile rows
            # (vp9.c:1720): such frames take the host pass A
            self.pass_a_host_frames += 1
        with metrics.timer("decode.pass_a"):
            if self.pass_a_impl == "device" and h.tile_rows == 1:
                counts = self._decode_tiles_device(data)
            elif self.use_native:
                from ...passa_native import decode_tiles_native
                if self._counts_pool is None:
                    self._counts_pool = [Counts()
                                         for _ in range(POOL_DEPTH)]
                # pooled slot; the C entry zeroes the count arrays
                self.native_counts = self._counts_pool[self._slot]
                decode_tiles_native(self, tile_data)
                counts = self.native_counts
            else:
                counts = self._decode_tiles(tile_data)

        # backward probability adaptation (reference: vp9.c:1821-1824)
        self.last_counts = counts
        if h.refreshctx and not h.parallelmode:
            with metrics.timer("decode.adapt_probs"):
                adapt_probs(self.prob_ctx[c], self.probs, counts, h,
                            self.last_keyframe)

        if self.export_enc_params:
            from .encparams import build_enc_params
            self.cur_frame_obj.enc_params = build_enc_params(self)

        # snapshot everything pass B reads (pass A of the next frame
        # mutates decoder state while pass B of this one may still run)
        job = FrameJob()
        job.ready = None
        with metrics.timer("decode.snapshot"):
            for a in _JOB_ATTRS:
                setattr(job, a, getattr(self, a))
            job.refs = list(self.refs)          # pre-rotation view
            job.lim_lut = self.lim_lut.copy()   # refilled per frame
            job.mblim_lut = self.mblim_lut.copy()
            job.device = self.device
            job.coef_bufs = self.coef_bufs
            job.splat_states = self.splat_states
            job.lf_schedules = self.lf_schedules
            job.outputs = [] if h.invisible else [self.cur_frame_obj]

        # reference slot rotation (reference: vp9.c:1688-1692, 1849-1851)
        # happens at end of pass A: the next frame's pass A (header, MV
        # prediction) needs the updated slots; pass B of this frame uses
        # the pre-rotation snapshot in job.refs
        for i in range(8):
            if h.refreshrefmask & (1 << i):
                self.refs[i] = self.cur_frame_obj
        self.cur_frame = self.cur_frame_obj
        return job

    def decode_pass_b(self, job: "FrameJob"):
        """Device stage: upload the frame's pass-B inputs and
        reconstruct it on the card from the pass-A snapshot. Returns
        the list of Frames to output (0 or 1)."""
        if job.ready is not None:
            return job.ready
        from ...ops import recon
        with metrics.timer("decode.pass_b"):
            recon.upload_job(job)
            recon.recon_frame(job)
        return job.outputs

    # ------------------------------------------------------------------
    def _decode_tiles_device(self, data: bytes) -> Counts:
        """Pass A of a frame with one tile row by the walk of
        ops/passa_device.py on self.device (on the card one launch, on
        the current stream): prep_keyframe for intra frames, prep_inter
        for inter frames. The walk returns block records and coefficient
        and eob pairs, and on inter frames the frame's MV and reference
        grids, which become cur_mv and cur_ref in one copy each (the
        next frame's prev_mv and prev_ref, whichever pass A decodes it).
        The replay (timer decode.pass_a_replay) hands pass B the native
        pass A's layouts: the records as 36-column int16 rows in decode
        order (tile-row band, superblock row, tile column, within-lane
        order: vp9.c:1302-1438), the pairs as the native emitter's rows,
        the loop filter's levels and masks (mask_edges, block by block)
        and the segmentation map. When backward adaptation will run, the
        walk's per-lane counts are merged (the vp9.c:1816-1819 tile
        merge). Raises ValueError on a tile size the packet does not
        hold, a stream that ends before a superblock or a full output."""
        from ...ops import passa_device as PD
        from ...passa_native import LazyBlocks
        from .blockdec import mask_edges
        h = self.header
        if h.keyframe or h.intraonly:
            inputs, meta = PD.prep_keyframe(self, data)
        else:
            inputs, meta = PD.prep_inter(self, data)
        out = PD.decode_frame(inputs, meta, self.device)
        recs, lane, cp, ep, cnts, err = (
            v.numpy() if torch.is_tensor(v) else v
            for v in _walk_to_host(out[:8]))
        PD.check_err(err)
        if meta.get("inter"):
            self.cur_mv[...] = out[9].cpu().numpy()
            self.cur_ref[...] = out[10].cpu().numpy()
        with metrics.timer("decode.pass_a_replay"):
            S = meta["S"]
            order = np.argsort((recs[:, 0] >> 3) * S + lane, kind="stable")
            rec36 = np.zeros((len(recs), 36), np.int16)
            rec36[:, :34] = recs[order]
            self.block_records = rec36
            self.blocks = LazyBlocks(rec36)
            wide = h.bpp > 8
            cprow = np.empty((len(cp), 4 if wide else 3), np.int16)
            pos, val = cp[:, 0].astype(np.int64), cp[:, 1].astype(np.int64)
            cprow[:, 0], cprow[:, 1] = pos >> 16, pos & 0xffff
            if wide:
                cprow[:, 2], cprow[:, 3] = val >> 16, val & 0xffff
            else:
                cprow[:, 2] = val
            eprow = np.empty((len(ep), 3), np.int16)
            epos = ep[:, 0].astype(np.int64)
            eprow[:, 0], eprow[:, 1], eprow[:, 2] = \
                epos >> 16, epos & 0xffff, ep[:, 1]
            self.coef_pairs = (cprow, eprow)
            # the loop filter's levels and masks, and the segmentation
            # map, from the records (vp9block.c:1142-1262, 777-801)
            self.lf_level.fill(0)
            self.lf_mask.fill(0)
            seg_write = h.seg_enabled and (h.seg_update_map or h.keyframe
                                           or h.intraonly)
            if h.filter_level or seg_write:
                self._replay_lf_seg(rec36, seg_write, mask_edges)
        counts = Counts()
        if meta["want_counts"]:
            PD.counts_from_device(cnts, counts)
        return counts

    def _replay_lf_seg(self, recs, seg_write, mask_edges):
        """Levels, edge masks and segment ids of a frame's records: the
        level by segment, reference (intra 0, else ref[0] + 1) and mode
        (ZEROMV or not), the masks without the inner edges of a skipped
        inter block (JAX decoder.py _decode_tiles_device)."""
        from .blockdec import ZEROMV
        h = self.header
        cols, rows = self.cols, self.rows
        for r in recs.tolist():
            row, col, bs, seg_id, skip, intra, tx, uvtx = \
                r[0], r[1], r[3], r[4], r[5], r[6], r[7], r[8]
            bw4, bh4 = int(T.BWH_TAB[1, bs, 0]), int(T.BWH_TAB[1, bs, 1])
            if seg_write:
                self.cur_segmap[row:row + bh4, col:col + bw4] = seg_id
            if not h.filter_level:
                continue
            lvl = int(h.seg_feat[seg_id].lflvl[0 if intra else r[15] + 1,
                                               int(r[12] != ZEROMV)])
            if lvl <= 0:
                continue
            skip_inter = bool(skip and not intra)
            x_end, y_end = min(cols - col, bw4), min(rows - row, bh4)
            row7, col7 = row & 7, col & 7
            sbr, sbc = row >> 3, col >> 3
            self.lf_level[sbr, sbc, row7:row7 + bh4, col7:col7 + bw4] = lvl
            mask_edges(self.lf_mask[sbr, sbc, 0], 0, 0, row7, col7, x_end,
                       y_end, 0, 0, tx, skip_inter)
            if self.ss_h or self.ss_v:
                mask_edges(
                    self.lf_mask[sbr, sbc, 1], self.ss_h, self.ss_v, row7,
                    col7, x_end, y_end,
                    (cols & 7) if (cols & 1) and col + bw4 >= cols else 0,
                    (rows & 7) if (rows & 1) and row + bh4 >= rows else 0,
                    uvtx, skip_inter)

    # ------------------------------------------------------------------
    def _decode_tiles(self, data: bytes) -> Counts:
        """reference: decode_tiles (vp9.c:1302-1438)."""
        h = self.header
        td = TileDecoder(self)
        total_counts = td.counts
        size = len(data)
        pos = 0

        for tile_row in range(h.tile_rows):
            row_start, row_end = _tile_offset(tile_row, h.log2_tile_rows,
                                              self.sb_rows)
            # per-tile-col range decoders for this tile row
            coders = []
            for tile_col in range(h.tile_cols):
                if (tile_col == h.tile_cols - 1
                        and tile_row == h.tile_rows - 1):
                    tsz = size - pos
                else:
                    if pos + 4 > size:
                        raise ValueError("truncated tile header")
                    tsz = int.from_bytes(data[pos:pos + 4], "big")
                    pos += 4
                if tsz > size - pos:
                    raise ValueError("invalid tile size")
                dec = BoolDecoder(data[pos:pos + tsz])
                if dec.get():
                    raise ValueError("marker bit set in tile")
                coders.append(dec)
                pos += tsz

            for row in range(row_start, row_end, 8):
                for tile_col in range(h.tile_cols):
                    col_start, col_end = _tile_offset(
                        tile_col, h.log2_tile_cols, self.sb_cols)
                    td.tile_col_start = col_start
                    td.reset_left()
                    td.c = coders[tile_col]
                    for col in range(col_start, col_end, 8):
                        if td.c.is_end():
                            raise ValueError("bitstream end mid-tile")
                        td.decode_sb(row, col, 0)
        return total_counts


def _walk_to_host(out):
    """The walk's outputs (ops/passa_device.decode_frame) on the host:
    (records [n, 34] int32 in lane order, each record's lane [n],
    coefficient pairs [nc, 2], eob pairs [ne, 2], counts [S, CNT_TOTAL],
    err [S]): the counts read back first, then every lane's rows in one
    copy each."""
    blocks, nblk, cpairs, ncp, epairs, nep, cnts, err = out
    n = torch.stack([nblk, ncp, nep, err]).cpu().numpy()
    S = n.shape[1]

    def rows(t, k):
        return torch.cat([t[s, :int(n[k, s])] for s in range(S)]).cpu()
    lane = np.repeat(np.arange(S), n[0])
    return (rows(blocks, 0), lane, rows(cpairs, 1), rows(epairs, 2),
            cnts.cpu(), n[3])


def _tile_offset(idx, log2_n, n_sb):
    """reference: set_tile_offset (vp9.c:1244-1250)."""
    start = (idx * n_sb) >> log2_n
    end = ((idx + 1) * n_sb) >> log2_n
    return min(start, n_sb) * 8, min(end, n_sb) * 8
