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
held to them. The kernel, csrc/passa.cu, against this plain version:
tests/test_torch_passa_decoder.py's `cuda` tests and chip_smoke.py."""
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
                 ("kMaxTileB8", PD.MAX_TILE_B8)):
        assert const(k) == v, k
    tool = _vectors_tool()
    [(_jd, td, fd)] = list(_intra_frames(_packets("passa_seg")))
    ti, _tm = PD.prep_keyframe(td, fd)
    assert len(PD.probs8(ti)) == offs[-1]
