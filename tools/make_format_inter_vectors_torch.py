#!/usr/bin/env python3
"""Inter frames of VP9 profiles 1-3 at 1080p for the PyTorch/CUDA port.

Five clips at 1920x1080 in 4 tile columns, one for each format beyond
profile 0. Each is a keyframe from the mini encoder's random-syntax
generator (encode_keyframe_random) at the clip's format, then three
inter frames from encode_inter_fmt below:

  1. lossless: NEWMV/NEARESTMV/NEARMV/ZEROMV with MVs to 1024 (1/8 px),
     some past the frame's edges, sub-8x8 partitions, compound
     prediction per block under sign biases that allow it, switchable
     filters, hp MVs, intra blocks with coefficients;
  2. lossy (yac_qi 60, txfmmode 3: every transform size from 4x4 to
     32x32, no per-block size syntax), loop-filter level 36 with
     sharpness and lf_deltas;
  3. lossy, from frame 2 through a second reference slot, so that the
     previous frame's MVs are candidates.

    clip                     bpp  layout  profile
    fmt_inter_422_1080p        8  4:2:2   1
    fmt_inter_440_1080p        8  4:4:0   1
    fmt_inter_444_1080p        8  4:4:4   1
    fmt_inter_420_10_1080p    10  4:2:0   2
    fmt_inter_444_12_1080p    12  4:4:4   3

encode_inter_fmt is the mini encoder's encode_inter_flex
(tools/mini_encoder.py) extended to these formats: the profile from
(bpp, layout) as its keyframe header writes it (an inter frame carries
no colour config: it inherits bit depth and subsampling from the
keyframe), the long cat6 tokens at 10/12 bits, the clip's chroma
subsampling in the coefficient walk (4:4:4 sub-8x8 blocks code a 2x2
of 4x4 chroma transforms), and a lossy variant (yac_qi > 0,
ALLOW_32X32). Every probability that a context selects is set to 128
in the compressed header, so no context needs tracking here.

The clips' frames are the cases of tests/test_torch_format_inter.py,
which encodes them itself from CASES and packets() here at small sizes
and holds the committed clips' headers to the recipes. The .framemd5 of
each clip comes from the JAX package's golden decoder
(VP9Decoder(recon_backend="golden")), whose header line says so.
Encoding and the golden decode take some 5 minutes a clip on a CPU;
run them in parallel, a process a clip:

    python3 tools/make_format_inter_vectors_torch.py [clip ...]
"""
import os
import queue
import sys
import threading

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

W, H, TILE_COLS_LOG2 = 1920, 1080, 2
# name: (bpp, ss_h, ss_v)
CASES = {
    "fmt_inter_422_1080p": (8, 1, 0),
    "fmt_inter_440_1080p": (8, 0, 1),
    "fmt_inter_444_1080p": (8, 0, 0),
    "fmt_inter_420_10_1080p": (10, 1, 1),
    "fmt_inter_444_12_1080p": (12, 0, 0),
}
NAMES = tuple(CASES)
BIG = (0, 2, 4, 8, 16, 64, 256, 1024)
LF_DELTAS = ([2, -3, 5, -5], [3, -2])
YAC_QI = 60
# the frames after the keyframe: kwargs of encode_inter_fmt (the seed is
# added per clip)
INTER = (
    dict(seed=1, comppredmode=2, signbias=(0, 0, 1), filtermode=4, hp=1,
         p_intra=0.15, p_skip=0.85, mv_mags=BIG, refresh_mask=0x02),
    dict(seed=2, yac_qi=YAC_QI, comppredmode=2, signbias=(0, 1, 1),
         refidx=(0, 1, 0), filtermode=4, p_intra=0.15, p_skip=0.6,
         mv_mags=BIG, filter_level=36, sharpness=3, lf_deltas=LF_DELTAS,
         refresh_mask=0x04),
    dict(seed=3, yac_qi=YAC_QI, refidx=(1, 2, 0), filtermode=1, hp=1,
         p_intra=0.1, p_skip=0.6, mv_mags=(0, 2, 4, 16, 64),
         filter_level=24, refresh_mask=0x08),
)
# the keyframe: kwargs of encode_keyframe_random; segments 3-7 carry the
# SKIP feature, which keeps the clips small (the five under 8 MB)
KEY = dict(txfmmode=3, yac_qi=YAC_QI, filter_level=24,
           seg_feat=[(None, None, None, sid >= 3) for sid in range(8)])


def profile_of(bpp, ss_h, ss_v):
    """The VP9 profile of a format (as the keyframe header writes it)."""
    return (0 if bpp == 8 else 2) + (0 if ss_h and ss_v else 1)


def rand_tokens(rng, sz, lossless):
    """Sparse random tokens of an sz x sz transform (raster order): the
    lossless frame's as encode_inter_flex draws them, the lossy frames'
    with up to 16 nonzeros and magnitudes to 300 (cat6)."""
    n = sz * sz
    vals = np.zeros(n, np.int64)
    if lossless:
        k = int(rng.randint(0, 6))
        mags, p = [1, 2, 3, 5, 9, 20, 80], None
    else:
        k = min(n, int(rng.choice([0, 1, 2, 4, 8, 16])))
        mags = [1, 2, 3, 5, 9, 20, 40, 80, 300]
        p = [.3, .2, .12, .1, .1, .08, .05, .03, .02]
    if k:
        pos = rng.choice(n, size=k, replace=False)
        vals[pos] = rng.choice(mags, size=k, p=p) * rng.choice([-1, 1], k)
    return vals.reshape(sz, sz)


def _coef_chdr(c, ntx):
    """Coefficient probability updates to 128 for transform sizes
    0..ntx-1 (the loop ends at txfmmode, vp9.c)."""
    import mini_encoder as M
    T = M.T
    D = T.DEFAULT_COEF_PROBS
    for i in range(ntx):
        c.put(1, 128)                   # update flag for tx i
        for j in range(2):
            for k in range(2):
                for l in range(6):
                    for m in range(6):
                        if m >= 3 and l == 0:
                            break
                        for n in range(3):
                            M._gated_update(c, int(D[i, j, k, l, m, n]), 128)


def _flat_chdr(allowcomp, comppredmode, filt_switch, hp, lossless):
    """The mini encoder's _flat_chdr with a lossy variant: txfmmode 3
    (ALLOW_32X32) and every transform size's coefficient probabilities
    set to 128."""
    import mini_encoder as M
    T = M.T
    FLAT = 128
    c = M.BoolEncoder()
    c.put(0, 128)                       # marker
    if lossless:
        _coef_chdr(c, 1)                # txfmmode implied TX_4X4
    else:
        c.put(1, 128)                   # txfmmode: 2-bit literal 3
        c.put(1, 128)
        c.put(0, 128)                   # ... not TX_SWITCHABLE
        _coef_chdr(c, 4)
    for i in range(3):                  # skip
        M._gated_update(c, int(T.PROBS_SKIP[i]), FLAT)
    for i in range(7):                  # mv_mode (inter mode tree)
        for j in range(3):
            M._gated_update(c, int(T.PROBS_MV_MODE[i, j]), FLAT)
    if filt_switch:
        for i in range(4):
            for j in range(2):
                M._gated_update(c, int(T.PROBS_FILTER[i, j]), FLAT)
    for i in range(4):                  # is_inter
        M._gated_update(c, int(T.PROBS_INTRA[i]), FLAT)
    if allowcomp:
        c.put(1 if comppredmode else 0, 128)
        if comppredmode:
            c.put(1 if comppredmode == 2 else 0, 128)
        if comppredmode == 2:
            for i in range(5):
                M._gated_update(c, int(T.PROBS_COMP[i]), FLAT)
    if comppredmode != 1:
        for i in range(5):
            for j in range(2):
                M._gated_update(c, int(T.PROBS_SINGLE_REF[i, j]), FLAT)
    if comppredmode != 0:
        for i in range(5):
            M._gated_update(c, int(T.PROBS_COMP_REF[i]), FLAT)
    for i in range(4):                  # y_mode (intra-in-inter)
        for j in range(9):
            M._gated_update(c, int(T.PROBS_Y_MODE[i, j]), FLAT)
    for i in range(4):                  # partition
        for j in range(4):
            for k in range(3):
                M._gated_update(c, int(T.PROBS_PARTITION[3 - i, j, k]),
                                FLAT)
    # mv probs: keep defaults (no context indexing -> nothing to flatten)
    n_gates = 3 + 2 * (1 + 10 + 1 + 10) + 2 * (2 * 3 + 3)
    if hp:
        n_gates += 2 * 2
    for _ in range(n_gates):
        c.put(0, 252)
    return c.bytes()


# seconds a side of the lockstep waits for the other before it gives up
LOCKSTEP_TIMEOUT = 600


class Lockstep:
    """The JAX package's pure-Python pass A of a frame, run in a thread
    beside the encoder of that frame: the decoder that the encoder must
    agree with. The encoder's tile coders hand it each bool with its
    probability (tee), and it reads them as its tiles' bools, raising at
    the first probability that differs from the one it would read with.
    Its MV reads tell the encoder whether an MV component carries its
    high-precision bit: the decoder reads one only where the component's
    predicted MV is small (vp9mvs.c, usehp), which depends on every
    earlier block and the previous frame. `shadow` is a JAX VP9Decoder
    (use_native=False) that has decoded the frames before this one."""

    def __init__(self, shadow, ntiles):
        self.shadow = shadow
        self.tiles = [queue.SimpleQueue() for _ in range(ntiles)]
        self.hp = queue.SimpleQueue()
        self.err = []
        self.thread = None

    def start(self, hdr, chdr):
        """Decode a packet of this header whose tiles are the queues."""
        import ffmpeg_hybrid_tpu.codecs.vp9.decoder as JD
        from ffmpeg_hybrid_tpu.codecs.vp9 import mvs
        from ffmpeg_hybrid_tpu.codecs.vp9.rac import BoolDecoder
        tiles = iter(self.tiles)
        hp_q, err = self.hp, self.err

        class Steered(BoolDecoder):
            def __init__(self, _data):
                self.q = next(tiles)

            def get_prob(self, prob):
                bit, p = self.q.get(timeout=LOCKSTEP_TIMEOUT)
                if p != int(prob):
                    raise RuntimeError(f"the encoder wrote a bool at "
                                       f"probability {p}, the decoder reads "
                                       f"one at {int(prob)}")
                return bit

            def is_end(self):
                return False

        read = mvs.read_mv_component

        def tapped(td, idx, hp):
            hp_q.put(bool(hp))
            return read(td, idx, hp)

        n = len(self.tiles)
        packet = hdr + chdr + b"\0\0\0\1\0" * (n - 1) + b"\0"

        def run():
            try:
                self.shadow.decode_pass_a(packet)
            except BaseException as e:  # noqa: BLE001 - raised in finish()
                err.append(e)
            finally:
                hp_q.put(None)

        self._restore = (JD.BoolDecoder, mvs.read_mv_component)
        JD.BoolDecoder, mvs.read_mv_component = Steered, tapped
        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def usehp(self):
        """Whether the decoder reads the next MV component's hp bit."""
        v = self.hp.get(timeout=LOCKSTEP_TIMEOUT)
        if v is None:
            self.finish()
            raise RuntimeError("the decoder ended before the encoder")
        return v

    def finish(self):
        import ffmpeg_hybrid_tpu.codecs.vp9.decoder as JD
        from ffmpeg_hybrid_tpu.codecs.vp9 import mvs
        self.thread.join(LOCKSTEP_TIMEOUT)
        JD.BoolDecoder, mvs.read_mv_component = self._restore
        if self.thread.is_alive():
            raise RuntimeError("the decoder did not finish the frame")
        if self.err:
            raise RuntimeError("the decoder disagreed with the encoder") \
                from self.err[0]
        if not all(q.empty() for q in self.tiles):
            raise RuntimeError("the encoder wrote bools the decoder did "
                               "not read")


def _tee_encoder(q):
    """A mini-encoder bool coder that also hands each bool to q."""
    import mini_encoder as M

    class Tee(M.BoolEncoder):
        def put(self, bit, prob):
            super().put(bit, prob)
            if self.q is not None:
                self.q.put((int(bit), int(prob)))

    t = Tee()
    t.q = q
    return t


def encode_inter_fmt(w, h, shadow, bpp=8, ss_h=1, ss_v=1, yac_qi=0, seed=0,
                     comppredmode=0, signbias=(0, 0, 0), refidx=(0, 0, 0),
                     refresh_mask=0x02, hp=0, filtermode=0, filter_level=0,
                     sharpness=0, p_intra=0.0, p_skip=0.3,
                     mv_mags=(0, 2, 4, 8, 16, 64, 256), tile_cols_log2=0,
                     lf_deltas=None):
    """A visible inter frame with flat per-context probabilities at any
    VP9 format: lossless (yac_qi 0, 4x4 WHT) or lossy (ALLOW_32X32, the
    largest transform each block allows). The keyframe before it sets
    bpp and the subsampling; see the module docstring. shadow: a JAX
    VP9Decoder (use_native=False) that has decoded the frames before;
    it decodes this one in lockstep with the encoder (Lockstep)."""
    import mini_encoder as M
    from ffmpeg_hybrid_tpu.codecs.vp9.blockdec import (BAND_COUNTS,
                                                       MAX_TX_FOR_BL_BP)
    from ffmpeg_hybrid_tpu.codecs.vp9.probs import Probs, coef_full
    T = M.T

    rng = np.random.RandomState(seed)
    P = Probs.defaults()
    lossless = yac_qi == 0
    allowcomp = int(signbias[0] != signbias[1] or signbias[0] != signbias[2])
    if not allowcomp:
        comppredmode = 0
    filt_switch = filtermode == 4
    profile = profile_of(bpp, ss_h, ss_v)

    # ---- uncompressed header ----
    gb = M.BitWriter()
    gb.put(0b10, 2)
    gb.put(profile & 1, 1)          # profile low bit
    gb.put((profile >> 1) & 1, 1)   # profile high bit
    if profile == 3:
        gb.put(0, 1)                # reserved
    gb.put(0, 1)            # show_existing
    gb.put(1, 1)            # non-keyframe
    gb.put(1, 1)            # show_frame
    gb.put(0, 1)            # error_resilient
    gb.put(0, 2)            # reset_frame_context
    # no colour config: bit depth and subsampling come from the keyframe
    gb.put(refresh_mask, 8)
    for i in range(3):
        gb.put(refidx[i], 3)
        gb.put(signbias[i], 1)
    gb.put(0, 1)            # size from ref0? no
    gb.put(0, 1)
    gb.put(0, 1)
    gb.put(w - 1, 16)
    gb.put(h - 1, 16)
    gb.put(0, 1)            # display size
    gb.put(hp, 1)           # high precision mvs
    if filt_switch:
        gb.put(1, 1)
    else:
        gb.put(0, 1)
        gb.put(filtermode, 2)
    gb.put(0, 1)            # refresh_frame_context
    gb.put(0, 1)            # frame_parallel
    gb.put(0, 2)            # frame_context_idx
    gb.put(filter_level, 6)
    gb.put(sharpness, 3)
    M._put_lf_deltas(gb, lf_deltas)
    gb.put(yac_qi, 8)
    gb.put(0, 1)            # no dc/ac deltas
    gb.put(0, 1)
    gb.put(0, 1)
    gb.put(0, 1)            # segmentation off
    sb_cols = (w + 63) >> 6
    min_log2 = 0
    while sb_cols > (64 << min_log2):
        min_log2 += 1
    mx = 0
    while (sb_cols >> mx) >= 4:
        mx += 1
    mx = max(0, mx - 1)
    lc = max(min_log2, tile_cols_log2)
    assert lc <= mx or lc == min_log2, "tile_cols beyond max"
    for _ in range(lc - min_log2):
        gb.put(1, 1)
    if lc < mx:
        gb.put(0, 1)
    gb.put(0, 1)            # log2_tile_rows

    chdr = _flat_chdr(allowcomp, comppredmode, filt_switch, hp, lossless)
    gb.put(len(chdr), 16)
    hdr = gb.bytes()

    # ---- tile data ----
    sb_rows = (h + 63) >> 6
    cols = (w + 7) >> 3
    rows = (h + 7) >> 3
    NEARESTMV, NEARMV, ZEROMV, NEWMV = 10, 11, 12, 13
    FLAT2 = np.full(3, 128, np.uint8)
    FLAT9 = np.full(9, 128, np.uint8)
    coef11_flat = coef_full(np.full((4, 2, 2, 6, 6, 3), 128, np.uint8))
    st = {}

    def put_mv_comp(idx, v):
        """Inverse of read_mv_component (vp9mvs.c:236-289); without the
        hp bit the decoder sets the magnitude's low bit (v even)."""
        t = st["t"]
        usehp = st["lock"].usehp()
        if not usehp and not abs(v) & 1 == 0:
            v += 1 if v > 0 else -1
        sign = v < 0
        n = abs(v) - 1
        t.put(1 if sign else 0, int(P.mv_sign[idx]))
        if n < 16:
            t.put_tree(T.MV_CLASS_TREE, P.mv_classes[idx], 0)
            t.put(n >> 3, int(P.mv_class0[idx]))
            t.put_tree(T.MV_FP_TREE, P.mv_class0_fp[idx][n >> 3],
                       (n >> 1) & 3)
            if usehp:
                t.put(n & 1, int(P.mv_class0_hp[idx]))
        else:
            cl = (n >> 3).bit_length() - 1
            t.put_tree(T.MV_CLASS_TREE, P.mv_classes[idx], cl)
            off = n - (8 << cl)
            for m in range(cl):
                t.put((off >> (3 + m)) & 1, int(P.mv_bits[idx][m]))
            t.put_tree(T.MV_FP_TREE, P.mv_fp[idx], (off >> 1) & 3)
            if usehp:
                t.put(off & 1, int(P.mv_hp[idx]))

    def put_delta():
        dy = int(rng.choice(mv_mags)) * int(rng.choice([-1, 1]))
        dx = int(rng.choice(mv_mags)) * int(rng.choice([-1, 1]))
        if hp:  # odd magnitudes, where the decoder reads the hp bit
            dy += int(rng.randint(0, 2)) * (1 if dy >= 0 else -1)
            dx += int(rng.randint(0, 2)) * (1 if dx >= 0 else -1)
        j = (2 if dy else 0) | (1 if dx else 0)
        st["t"].put_tree(T.MV_JOINT_TREE, P.mv_joint, j)
        if dy:
            put_mv_comp(0, dy)
        if dx:
            put_mv_comp(1, dx)

    def put_mode():
        mode = int(rng.choice([NEARESTMV, NEARMV, ZEROMV, NEWMV],
                              p=[0.15, 0.15, 0.15, 0.55]))
        st["t"].put_tree(T.INTER_MODE_TREE, FLAT2, mode)
        return mode

    def put_deltas(mode, n_refs):
        if mode == NEWMV:
            for _ in range(n_refs):
                put_delta()

    def enc_plane_coeffs(modes, intra, bs, r, ccol, tx, uv):
        """Mirror of decode_coeffs' per-plane walk over the block's
        transforms; flat probabilities make the nnz context moot."""
        w4 = int(T.BWH_TAB[1][bs][0]) * 2
        h4 = int(T.BWH_TAB[1][bs][1]) * 2
        end_x = min(2 * (cols - ccol), w4)
        end_y = min(2 * (rows - r), h4)
        if uv:
            end_x >>= ss_h
            end_y >>= ss_v
        step = 1 << tx
        probs11 = coef11_flat[tx][1 if uv else 0][0 if intra else 1]
        bc = BAND_COUNTS[tx]
        n = 0
        for _yy in range(0, end_y, step):
            for _xx in range(0, end_x, step):
                if uv or not intra or tx == 3:
                    txtp = 0                    # DCT_DCT
                else:
                    txtp = int(T.INTRA_TXFM_TYPE[modes[n if bs > 9 else 0]])
                sc = 4 if lossless else tx
                toks = rand_tokens(rng, 4 << tx, lossless)
                st["ce"].encode_block(toks, probs11, 0, T.SCANS[sc][txtp],
                                      T.SCANS_NB[sc][txtp], n=16 << (2 * tx),
                                      band_counts=bc)
                n += step

    def encode_block(r, ccol, bl, bp):
        t = st["t"]
        bs = bl * 3 + bp
        skip = bool(rng.rand() < p_skip)
        t.put(1 if skip else 0, 128)        # skip (flat)
        intra = bool(rng.rand() < p_intra)
        t.put(0 if intra else 1, 128)       # is_inter (flat)
        # ALLOW_32X32 (or lossless): no tx size bits
        tx = 0 if lossless else min(MAX_TX_FOR_BL_BP[bs], 3)
        nw = int(T.BWH_TAB[1][bs][0])
        nh = int(T.BWH_TAB[1][bs][1])
        uvtx = 0 if lossless else tx - int(
            (ss_h and nw * 2 == (1 << tx)) or (ss_v and nh * 2 == (1 << tx)))
        modes = [2, 2, 2, 2]
        if intra:
            if bs > 9:
                modes[0] = int(rng.randint(0, 10))
                t.put_tree(T.INTRAMODE_TREE, FLAT9, modes[0])
                if bs != 10:
                    modes[1] = int(rng.randint(0, 10))
                    t.put_tree(T.INTRAMODE_TREE, FLAT9, modes[1])
                else:
                    modes[1] = modes[0]
                if bs != 11:
                    modes[2] = int(rng.randint(0, 10))
                    t.put_tree(T.INTRAMODE_TREE, FLAT9, modes[2])
                    if bs != 10:
                        modes[3] = int(rng.randint(0, 10))
                        t.put_tree(T.INTRAMODE_TREE, FLAT9, modes[3])
                    else:
                        modes[3] = modes[2]
                else:
                    modes[2] = modes[0]
                    modes[3] = modes[1]
            else:
                m = int(rng.randint(0, 10))
                t.put_tree(T.INTRAMODE_TREE, FLAT9, m)
                modes = [m, m, m, m]
            uvm = int(rng.randint(0, 10))
            t.put_tree(T.INTRAMODE_TREE, P.uv_mode[modes[3]], uvm)
        else:
            comp = 0
            if comppredmode == 2:
                comp = int(rng.rand() < 0.5)
                t.put(comp, 128)
            elif comppredmode == 1:
                comp = 1
            if comp:
                t.put(int(rng.rand() < 0.5), 128)   # comp_ref bit
            else:
                bit0 = int(rng.rand() < 0.5)
                t.put(bit0, 128)                    # single_ref bit 0
                if bit0:
                    t.put(int(rng.rand() < 0.5), 128)
            n_refs = 2 if comp else 1
            if bs <= 9:
                modes = [put_mode()] * 4
            if filt_switch:
                t.put_tree(T.FILTER_TREE, FLAT2[:2], int(rng.randint(0, 3)))
            if bs > 9:
                modes[0] = put_mode()
                put_deltas(modes[0], n_refs)
                if bs != 10:
                    modes[1] = put_mode()
                    put_deltas(modes[1], n_refs)
                else:
                    modes[1] = modes[0]
                if bs != 11:
                    modes[2] = put_mode()
                    put_deltas(modes[2], n_refs)
                    if bs != 10:
                        modes[3] = put_mode()
                        put_deltas(modes[3], n_refs)
                    else:
                        modes[3] = modes[2]
                else:
                    modes[2] = modes[0]
                    modes[3] = modes[1]
            else:
                put_deltas(modes[0], n_refs)
        if not skip:
            enc_plane_coeffs(modes, intra, bs, r, ccol, tx, False)
            for _pl in range(2):
                enc_plane_coeffs(modes, intra, bs, r, ccol, uvtx, True)

    def encode_sb(r, ccol, bl):
        t = st["t"]
        hbs = 4 >> bl
        if bl == 3:
            bp = int(rng.choice([0, 1, 2, 3], p=[0.4, 0.2, 0.2, 0.2]))
            t.put_tree(T.PARTITION_TREE, FLAT2, bp)
            encode_block(r, ccol, bl, bp)
        elif ccol + hbs < cols:
            if r + hbs < rows:
                bp = int(rng.choice([0, 1, 2, 3],
                                    p=[0.35, 0.15, 0.15, 0.35]))
                t.put_tree(T.PARTITION_TREE, FLAT2, bp)
                if bp == 0:
                    encode_block(r, ccol, bl, 0)
                elif bp == 1:
                    encode_block(r, ccol, bl, 1)
                    encode_block(r + hbs, ccol, bl, 1)
                elif bp == 2:
                    encode_block(r, ccol, bl, 2)
                    encode_block(r, ccol + hbs, bl, 2)
                else:
                    encode_sb(r, ccol, bl + 1)
                    encode_sb(r, ccol + hbs, bl + 1)
                    encode_sb(r + hbs, ccol, bl + 1)
                    encode_sb(r + hbs, ccol + hbs, bl + 1)
            else:
                split = bool(rng.rand() < 0.5)
                t.put(1 if split else 0, 128)
                if split:
                    encode_sb(r, ccol, bl + 1)
                    encode_sb(r, ccol + hbs, bl + 1)
                else:
                    encode_block(r, ccol, bl, 1)
        elif r + hbs < rows:
            split = bool(rng.rand() < 0.5)
            t.put(1 if split else 0, 128)
            if split:
                encode_sb(r, ccol, bl + 1)
                encode_sb(r + hbs, ccol, bl + 1)
            else:
                encode_block(r, ccol, bl, 2)
        else:
            encode_sb(r, ccol, bl + 1)

    # tile walk in the decoder's order, each superblock row across the
    # tiles (flat probabilities leave no left context to reset)
    ntiles = 1 << lc
    lock = st["lock"] = Lockstep(shadow, ntiles)
    coders = []
    for q in lock.tiles:
        t = _tee_encoder(q)
        t.put(0, 128)                       # marker
        coders.append((t, M.CoeffEncoder(t, bpp)))
    lock.start(hdr, chdr)
    for r in range(0, sb_rows * 8, 8):
        for tc in range(ntiles):
            c0 = min((tc * sb_cols) >> lc, sb_cols) * 8
            c1 = min(((tc + 1) * sb_cols) >> lc, sb_cols) * 8
            st["t"], st["ce"] = coders[tc]
            for ccol in range(c0, c1, 8):
                encode_sb(r, ccol, 0)
    lock.finish()
    tiles = []
    for t, _ce in coders:
        # 32 zero bits after the tile's symbols, as libvpx's
        # vpx_stop_encode writes them: FFmpeg's coder refills two bytes
        # at a time and counts the end checks (vpx_rac_is_end) made
        # after its buffer ran out
        t.q = None
        for _ in range(32):
            t.put(0, 128)
        tiles.append(t.bytes())
    data = b""
    for i, tb in enumerate(tiles):
        if i < len(tiles) - 1:
            data += len(tb).to_bytes(4, "big")
        data += tb
    return M._finish(hdr, chdr, data)


def packets(name, w=W, h=H, tile_cols_log2=TILE_COLS_LOG2):
    """The clip's packets (bytes): its keyframe and three inter frames,
    at the clip's format and the given size and tile columns."""
    import mini_encoder as M
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder
    bpp, ss_h, ss_v = CASES[name]
    base = 2100 + 100 * NAMES.index(name)
    shadow = VP9Decoder(recon_backend="golden", use_native=False)
    out = [M.encode_keyframe_random(w, h, bpp, seed=base, ss_h=ss_h,
                                    ss_v=ss_v, tile_cols_log2=tile_cols_log2,
                                    **KEY)]
    shadow.decode_pass_a(out[0])
    for kw in INTER:
        kw = dict(kw, seed=base + kw["seed"])
        out.append(encode_inter_fmt(w, h, shadow, bpp, ss_h, ss_v,
                                    tile_cols_log2=tile_cols_log2, **kw))
    return out


def make(name):
    from make_format_vectors_torch import framemd5
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu.formats.ivf import write_ivf

    pkts = packets(name)
    for i, p in enumerate(pkts):
        print(f"{name} frame {i}: {len(p)} B", flush=True)
    path = os.path.join(ROOT, "vectors", name + ".ivf")
    write_ivf(path, b"VP90", W, H, 30, 1, list(enumerate(pkts)))
    dec = VP9Decoder(recon_backend="golden")
    frames = [f for p in pkts for f in dec.decode(p)]
    with open(os.path.join(ROOT, "vectors", name + ".framemd5"), "w") as fh:
        fh.write(framemd5(frames, W, H))
    print(f"{name}: {len(frames)} frames, "
          f"{os.path.getsize(path) / 1e6:.2f} MB", flush=True)


def main():
    for name in sys.argv[1:] or NAMES:
        make(name)


if __name__ == "__main__":
    main()
