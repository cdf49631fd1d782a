"""The port's on-device pass A for intra frames
(ffmpeg_hybrid_tpu_torch/ops/passa_device.py) against the JAX package's
ops/passa_device.py on the CPU: the host prep (prep_keyframe) array by
array, and the walk's plain version (decode_frame_plain, which the
decode_frame wrapper runs for the CPU) against JAX's decode_frame_device
on the same inputs: the block records (after the don't-care fields are
zeroed), the coefficient and eob pairs, the err words and, where the
frame adapts, the symbol counts. Every comparison is exact. The cases
are tools/make_passa_vectors_torch.py's (those of the JAX package's
tests/test_passa_device.py, with its sizes, plus 10 and 12 bits, 4:4:4,
lossless and an intra-only frame); the committed vectors/passa_* are
held to them. The tables the kernel stages (packed_scans' words and
offsets, coef16_rows' padded probability rows) are held to JAX's scans,
neighbours, bands and probabilities, and each neighbour to an earlier
scan position (the kernel never zeroes its energy cache). The kernel,
csrc/passa.cu, against this plain version: tests/test_torch_passa_decoder.py's
`cuda` tests and chip_smoke.py."""
import os
import re
import sys

import numpy as np
import pytest
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder as JDec
from ffmpeg_hybrid_tpu.ops import passa_device as JPD
from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
from ffmpeg_hybrid_tpu_torch.formats.ivf import read_ivf
from ffmpeg_hybrid_tpu_torch.formats.superframe import split_superframe
from ffmpeg_hybrid_tpu_torch.ops import passa_device as PD

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOOLS = os.path.join(ROOT, "tools")
VEC = os.path.join(ROOT, "vectors")


def _vectors_tool():
    sys.path.insert(0, TOOLS)
    try:
        import make_passa_vectors_torch
    finally:
        sys.path.pop(0)
    return make_passa_vectors_torch


_PACKETS = {}


def _packets(name):
    """The case's packets, encoded once a module."""
    if name not in _PACKETS:
        _PACKETS[name] = _vectors_tool().packets(name)
    return _PACKETS[name]


def _frames(pkts):
    return [fd for i, p in enumerate(pkts)
            for _pts, fd in split_superframe(p, i)]


def _canon(vals):
    """The record with its don't-care fields zeroed (the JAX test's
    _canon): an intra block's refs, filter and MVs are unused."""
    v = [int(x) for x in vals]
    if v[6]:
        v[15] = v[16] = v[17] = 0
        v[18:] = [0] * 16
    else:
        v[13] = 0
        if not v[14]:
            v[16] = 0
    return v


def _intra_frames(pkts):
    """Both decoders through the packets' pass A; yields (JAX decoder,
    port decoder, frame) at each intra frame (keyframe or intra-only)
    that is not a show-existing one."""
    jd = JDec(recon_backend="golden", use_native=True)
    td = VP9Decoder(device="cpu", use_native=True)
    for fd in _frames(pkts):
        job = td.decode_pass_a(fd)
        jjob = jd.decode_pass_a(fd)
        assert (job.ready is None) == (jjob.ready is None)
        if job.ready is None and (td.header.keyframe
                                  or td.header.intraonly):
            yield jd, td, fd


def _same_prep(jd, td, fd):
    ji, jm = JPD.prep_keyframe(jd, fd)
    ti, tm = PD.prep_keyframe(td, fd)
    for k, v in ji.items():
        assert np.array_equal(np.asarray(v), np.asarray(ti[k])), k
        assert np.asarray(ti[k]).shape == np.asarray(v).shape, k
    for k, v in jm.items():
        assert tm[k] == v, k
    return ji, jm, ti, tm


@pytest.mark.parametrize("name", _vectors_tool().NAMES)
def test_walk_matches_jax(name):
    """prep_keyframe as JAX's; decode_frame on the CPU (the plain walk)
    as decode_frame_device on the same inputs."""
    tool = _vectors_tool()
    n = 0
    for jd, td, fd in _intra_frames(_packets(name)):
        ji, jm, ti, tm = _same_prep(jd, td, fd)
        want = [np.asarray(o) for o in JPD.decode_frame_device(ji, jm)]
        got = [o.numpy() for o in PD.decode_frame(ti, tm, "cpu")]
        assert not want[7].any() and not got[7].any()
        for s in range(tm["S"]):
            nb = int(want[1][s])
            assert int(got[1][s]) == nb, f"lane {s}: block count"
            for k in range(nb):
                assert _canon(got[0][s, k]) == _canon(want[0][s, k]), \
                    f"lane {s} block {k}"
            for i, c in ((2, 3), (4, 5)):
                m = int(want[c][s])
                assert int(got[c][s]) == m, f"lane {s}: output {i} rows"
                assert np.array_equal(got[i][s, :m], want[i][s, :m]), \
                    f"lane {s}: output {i}"
        if tm["want_counts"]:
            assert np.array_equal(got[6], want[6])
            assert got[6].sum() > 0
        n += 1
    assert n == (2 if name == tool.INTRA_ONLY else 1)


def test_prep_matches_jax_on_bench_1080p_lf():
    """The prep of a 1080p keyframe with 4 tile columns (the lanes'
    streams, bounds and every table) as JAX's."""
    _info, pkts = read_ivf(os.path.join(VEC, "bench_1080p_lf.ivf"))
    fd = next(iter(pkts))[1]
    [(jd, td, fd)] = list(_intra_frames([fd]))
    _ji, jm, ti, tm = _same_prep(jd, td, fd)
    assert tm["S"] == 4
    assert list(ti["tile_len"]) == [
        len(fd) - o if k == 3 else int.from_bytes(fd[o - 4:o], "big")
        for k, o in enumerate(ti["tile_off"])]


@pytest.mark.parametrize("name", _vectors_tool().NAMES)
def test_committed_vectors_are_the_cases(name):
    """vectors/passa_*.ivf hold the cases' packets, so the card checks
    the frames these tests check."""
    _info, pkts = read_ivf(os.path.join(VEC, name + ".ivf"))
    assert [bytes(p) for _pts, p in pkts] == _packets(name)


def test_lane_caps_hold_every_lane():
    """lane_caps' rows are what a tile can hold: a block an 8x8 cell,
    a coefficient or an eob cell a position of the tile's superblock
    area; every case's lanes fit in them, and a lane's cells equal its
    tile's."""
    for name in ("passa_s5", "passa_444_12", "passa_wide"):
        for _jd, td, fd in _intra_frames(_packets(name)):
            ti, tm = PD.prep_keyframe(td, fd)
            caps = PD.lane_caps(ti, tm)
            b = ti["bounds"]
            cells = (b[:, 1] - b[:, 0]) * (b[:, 3] - b[:, 2])
            assert list(caps[0]) == list(cells)
            ss = tm["ss_h"] + tm["ss_v"]
            assert list(caps[1]) == list(64 * cells
                                         + 2 * ((64 * cells) >> ss))
            out = PD.decode_frame(ti, tm, "cpu")
            for k, c in ((1, 0), (3, 1), (5, 2)):
                assert (out[k].numpy() <= caps[c]).all()


def test_kernel_constants_match_the_layouts():
    """csrc/passa.cu's count offsets, probability-table offsets and
    phases are CNT_OFF's, probs8's and the module's."""
    src = open(os.path.join(ROOT, "ffmpeg_hybrid_tpu_torch", "csrc",
                            "passa.cu")).read()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))
    assert const("kCntTotal") == PD.CNT_TOTAL
    for k, n in (("kCntTx32", "tx32p"), ("kCntTx16", "tx16p"),
                 ("kCntTx8", "tx8p"), ("kCntSkip", "skip"),
                 ("kCntPartition", "partition"), ("kCntCoef", "coef"),
                 ("kCntEob", "eob")):
        assert const(k) == PD.CNT_OFF[n], k
    sizes = [3, 2, 4, 6, 7, 8, 48, 900, 90, 3168]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    for k, o in zip(("kPSkip", "kPTx8", "kPTx16", "kPTx32", "kPSeg",
                     "kPSkipSeg", "kPKfPart", "kPKfY", "kPKfUv", "kPCoef",
                     "kProbBytes"), offs):
        assert const(k) == o, k
    for k, v in (("kPart", PD.PART), ("kMode", PD.MODE),
                 ("kCoef", PD.COEF), ("kDone", PD.DONE),
                 ("kErrOverflow", PD.ERR_OVERFLOW), ("kErrEnd", PD.ERR_END),
                 ("kErrMarker", PD.ERR_MARKER),
                 ("kMaxTileB8", PD.MAX_TILE_B8),
                 ("kScanWords", PD.SCAN_WORDS), ("kScanRows", PD.SCAN_ROWS),
                 ("kCoefRows", 2 * PD._COEF_ROWS),
                 ("kPCoef", PD._COEF_OFF)):
        assert const(k) == v, k
    # the debug sections: the kernel's enum Sec in SECTIONS' order
    sec = re.search(r"enum Sec \{([^}]*)\}", src).group(1)
    names = [n.strip() for n in sec.split(",")]
    assert names[-1] == "kNumSec" and len(names) - 1 == len(PD.SECTIONS)
    camel = {"part": "Part", "mode": "Mode", "mv_scan": "MvScan",
             "mv": "Mv", "coef_loop": "CoefLoop", "coef_run": "CoefRun",
             "coef": "Coef", "run_positions": "RunPos",
             "emit": "Emit", "sync": "Sync", "bools_part": "BPart",
             "bools_mode": "BMode",
             "bools_mv": "BMv", "bools_coef": "BCoef", "mv_scans": "Scans"}
    assert names[:-1] == ["kSec" + camel[n] for n in PD.SECTIONS]
    tool = _vectors_tool()
    [(_jd, td, fd)] = list(_intra_frames(_packets("passa_seg")))
    ti, _tm = PD.prep_keyframe(td, fd)
    assert len(PD.probs8(ti)) == offs[-1]


def test_packed_scans_hold_the_scans_and_neighbours():
    """packed_scans' words give each scan row of JAX's tables (every
    transform size and type, lossless WHT included) position by position:
    the scan index, and the two neighbours that JAX's table lists at the
    position before (the context of this one); every neighbour is an
    earlier position of the row, so the kernel's energy cache never needs
    zeroing; three words follow the last row."""
    sc, nb = JPD._scans_i32()
    words, offs = PD.packed_scans()
    assert words.dtype == np.uint32 and words.shape == (PD.SCAN_WORDS,)
    assert offs.shape == (PD.SCAN_ROWS,) == (sc.shape[0],)
    end = 0
    for r in range(PD.SCAN_ROWS):
        tx = r // 4
        n = 16 << (2 * tx) if tx < 4 else 16
        w = words[offs[r]:offs[r] + n].astype(np.int64)
        assert np.array_equal(w & 0x3ff, sc[r, :n]), r
        assert np.array_equal((w[1:] >> 10) & 0x3ff, nb[r, :n - 1, 0]), r
        assert np.array_equal(w[1:] >> 20, nb[r, :n - 1, 1]), r
        assert not (w[0] >> 10)
        order = np.empty(1024, np.int64)
        order[sc[r, :n]] = np.arange(n)
        for k in range(2):
            assert (order[nb[r, :n - 1, k]] < np.arange(1, n)).all(), r
        end = max(end, int(offs[r]) + n)
    assert end + 3 <= PD.SCAN_WORDS


def test_kernel_bands_match_the_band_tables():
    """The token loop's band of a position (csrc/passa.cu: kBands, 3 bits
    a position up to 20, then 5 from band5) is JAX's band table at every
    position of every transform size."""
    src = open(os.path.join(ROOT, "ffmpeg_hybrid_tpu_torch", "csrc",
                            "passa.cu")).read()
    bands = int(re.search(r"kBands = (0x[0-9a-f]+)ull;", src).group(1), 16)
    b5 = re.search(r"band5 = tx_p == 0 \? (\d+) : (\d+);", src)
    for tx in range(4):
        band5 = int(b5.group(1 if tx == 0 else 2))
        assert band5 <= 21
        for i in range(1, (4 << tx) ** 2):
            band = 5 if i >= band5 else (bands >> (3 * i)) & 7
            assert band == JPD._BANDS[tx, i], (tx, i)


def test_coef16_rows_hold_the_coefficient_probabilities():
    """coef16_rows pads each (band, context) row of probs8's coefficient
    probabilities to 16 bytes: on a keyframe JAX's coef11 rows, the rest
    0, and no inter rows."""
    [(jd, td, fd)] = list(_intra_frames(_packets("passa_seg")))
    ji, _jm = JPD.prep_keyframe(jd, fd)
    ti, _tm = PD.prep_keyframe(td, fd)
    rows = PD.coef16_rows(PD.probs8(ti))
    assert rows.shape == (2, PD._COEF_ROWS, 16) and rows.dtype == np.uint8
    assert np.array_equal(rows[0, :, :11],
                          np.asarray(ji["coef11"]).reshape(-1, 11))
    assert not rows[0, :, 11:].any() and not rows[1].any()
