"""The port's on-device pass A for inter frames
(ffmpeg_hybrid_tpu_torch/ops/passa_device.py: prep_inter and the inter
half of the walk) against the JAX package's ops/passa_device.py on the
CPU: prep_inter array by array on the small inter clips and on
bench_1080p frames 1 and 6; the walk's plain version (decode_frame_plain,
which decode_frame runs for the CPU) against JAX's decode_frame_device
with inter=1 on every inter frame of the clips, the symbol counts forced
on on both sides: the block records (after the fields a block does not
write are zeroed), the coefficient and eob pairs, the err words and the
counts; the same counts and each lane's bools against the port's
pure-Python host pass A, which counts every symbol; and the plain walk
against the native pass A on bench_1080p frames 1-5 (full-width inter
frames of a few thousand bools): records, coefficient planes, eob grids
and the frame's MV and reference grids (cur_mv, cur_ref). Every
comparison is exact. The clips are tools/make_passa_inter_vectors_torch.py's
cases; the committed vectors/passa_inter_* are held to them. The kernel,
csrc/passa.cu, against this plain version: the `cuda` tests of
tests/test_torch_passa_decoder.py and chip_smoke.py."""
import itertools
import os
import re
import sys

import numpy as np
import pytest
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder as JDec
from ffmpeg_hybrid_tpu.ops import passa_device as JPD
from ffmpeg_hybrid_tpu_torch.codecs.vp9 import rac as R
from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
from ffmpeg_hybrid_tpu_torch.formats.ivf import read_ivf
from ffmpeg_hybrid_tpu_torch.formats.superframe import split_superframe
from ffmpeg_hybrid_tpu_torch.ops import passa_device as PD

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOOLS = os.path.join(ROOT, "tools")
VEC = os.path.join(ROOT, "vectors")
# JAX's walk compiles once for each set of its static arguments and array
# shapes: every call here takes these output sizes (those of the largest
# clip, 512x64) and stream width, so the clips' frames share two
# executables (one lane, two lanes)
JAX_CAPS = dict(bmax=1024, cmax=1 << 18, emax=4096)
JAX_HALF16 = 8192


def _tool():
    sys.path.insert(0, TOOLS)
    try:
        import make_passa_inter_vectors_torch
    finally:
        sys.path.pop(0)
    return make_passa_inter_vectors_torch


_PACKETS = {}


def _packets(name):
    """The case's packets, encoded once a module."""
    if name not in _PACKETS:
        _PACKETS[name] = _tool().packets(name)
    return _PACKETS[name]


def _bench_frames(n):
    _info, pkts = read_ivf(os.path.join(VEC, "bench_1080p.ivf"))
    return list(itertools.islice((fd for pts, data in pkts
                                  for _p, fd in split_superframe(data, pts)),
                                 n))


def _canon(vals):
    """The record with the fields a block does not write zeroed (the JAX
    test's _canon): an intra block's refs, filter and MVs, an inter
    block's uv mode, a single-reference block's second ref."""
    v = [int(x) for x in vals]
    if v[6]:
        v[15] = v[16] = v[17] = 0
        v[18:] = [0] * 16
    else:
        v[13] = 0
        if not v[14]:
            v[16] = 0
    return v


def _inter_frames(frames):
    """Both decoders through the frames' pass A (the native one); yields
    (JAX decoder, port decoder, frame) at each inter frame."""
    jd = JDec(recon_backend="golden", use_native=True)
    td = VP9Decoder(device="cpu", use_native=True)
    for fd in frames:
        job = td.decode_pass_a(fd)
        jjob = jd.decode_pass_a(fd)
        assert (job.ready is None) == (jjob.ready is None)
        if job.ready is None and not (td.header.keyframe
                                      or td.header.intraonly):
            yield jd, td, fd


def _same_prep(jd, td, fd):
    """prep_inter's inputs and meta as JAX's, array by array (dtypes and
    shapes too)."""
    ji, jm = JPD.prep_inter(jd, fd)
    ti, tm = PD.prep_inter(td, fd)
    for k, v in ji.items():
        if k == "aux":
            assert set(ti["aux"]) == set(v)
            for a, arr in v.items():
                got = ti["aux"][a]
                assert got.dtype == arr.dtype and got.shape == arr.shape, a
                assert np.array_equal(got, arr), a
        else:
            assert np.asarray(ti[k]).shape == np.asarray(v).shape, k
            assert np.array_equal(np.asarray(v), np.asarray(ti[k])), k
    for k, v in jm.items():
        assert tm[k] == v, k
    assert tm["inter"] == 1
    return ji, jm, ti, tm


@pytest.mark.parametrize("name", _tool().NAMES)
def test_prep_inter_matches_jax(name):
    n = 0
    for jd, td, fd in _inter_frames(_packets(name)):
        _same_prep(jd, td, fd)
        n += 1
    assert n == len(_tool().CASES[name][2]) - 1


def test_prep_inter_matches_jax_on_bench_1080p():
    """Frames 1 (a typical P frame) and 6 (the densest): 4 tile columns,
    the previous frame's grids at full width."""
    seen = []
    for k, (jd, td, fd) in enumerate(_inter_frames(_bench_frames(7)), 1):
        if k in (1, 6):
            _ji, _jm, ti, tm = _same_prep(jd, td, fd)
            assert tm["S"] == 4 and ti["aux"]["hflags"][13] == 1
            seen.append(k)
    assert seen == [1, 6]


def _jax_walk(ji, jm):
    """JAX's walk on prep_inter's inputs, the counts forced on, on the
    shared output sizes and stream width (JAX_CAPS): padding the
    halfword windows with zeros changes no read (past a window both
    walks read zeros). meta's seg only picks the keyframe's segment tree,
    which an inter frame never reads (its flags are in aux's hflags), so
    both clip kinds share an executable."""
    ji = dict(ji)
    h16 = np.asarray(ji["half16"])
    assert h16.shape[1] <= JAX_HALF16
    ji["half16"] = np.pad(h16, ((0, 0), (0, JAX_HALF16 - h16.shape[1])))
    jm = dict(jm, want_counts=1, seg=0)
    return [np.asarray(o) for o in JPD.decode_frame_device(ji, jm,
                                                           **JAX_CAPS)]


@pytest.mark.parametrize("name", _tool().NAMES)
def test_walk_matches_jax(name):
    """decode_frame on the CPU (the plain walk) as decode_frame_device
    with inter=1 on the same inputs, the counts forced on both sides."""
    n = 0
    for jd, td, fd in _inter_frames(_packets(name)):
        ji, jm, ti, tm = _same_prep(jd, td, fd)
        want = _jax_walk(ji, jm)
        tm["want_counts"] = 1
        got = [o.numpy() for o in PD.decode_frame(ti, tm, "cpu")]
        assert len(got) == 11
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
        assert np.array_equal(got[6], want[6])
        joint = PD.CNT_OFF["mv_joint"]
        assert got[6][:, joint:joint + 4].sum() > 0
        n += 1
    assert n == len(_tool().CASES[name][2]) - 1


@pytest.mark.parametrize("name", _tool().NAMES)
def test_counts_and_bools_match_the_host_python_pass_a(name, monkeypatch):
    """The walk's forced counts merged over its lanes equal the
    pure-Python host pass A's counts of the frame (it counts every
    symbol), field by field; each lane's bools equal those the host's
    decoder of that tile read after its marker bool."""
    made, reads = [], {}
    init, get_prob = R.BoolDecoder.__init__, R.BoolDecoder.get_prob

    def counted_init(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    def counted_get_prob(self, prob):
        reads[id(self)] = reads.get(id(self), 0) + 1
        return get_prob(self, prob)
    monkeypatch.setattr(R.BoolDecoder, "__init__", counted_init)
    monkeypatch.setattr(R.BoolDecoder, "get_prob", counted_get_prob)
    dec = VP9Decoder(device="cpu", use_native=False)
    n = 0
    for fd in _packets(name):
        del made[:]
        reads.clear()
        dec.decode_pass_a(fd)
        h = dec.header
        if h.keyframe or h.intraonly:
            continue
        # the tiles' decoders, the last the host pass A made (prep
        # makes its own)
        tiles = made[-h.tile_cols * h.tile_rows:]
        inputs, meta = PD.prep_inter(dec, fd)
        meta["want_counts"] = 1
        out = PD.decode_frame(inputs, meta, "cpu")
        assert not out[7].any()
        counts = PD.counts_from_device(out[6].numpy(), dec.counts_factory())
        for fld, _shape in PD._CNT_SPEC:
            assert np.array_equal(getattr(counts, fld),
                                  getattr(dec.last_counts, fld)), fld
        assert out[8][:, 0].tolist() == [reads[id(t)] - 1 for t in tiles]
        n += 1
    assert n == len(_tool().CASES[name][2]) - 1


def _canon_all(recs):
    return [_canon(r) for r in recs]


def test_walk_matches_native_on_bench_1080p():
    """Frames 1-5 of bench_1080p, each after the native pass A of the
    frames before it: the plain walk's records (in decode order), dense
    coefficient planes and eob grids equal the native pass A's, and its
    grids equal cur_mv and cur_ref."""
    dec = VP9Decoder(device="cpu", use_native=True)
    n = 0
    for fd in _bench_frames(6):
        dec.decode_pass_a(fd)
        if dec.header.keyframe:
            continue
        inputs, meta = PD.prep_inter(dec, fd)
        out = [o.numpy() for o in PD.decode_frame(inputs, meta, "cpu")]
        blocks, nblk, cp, ncp, ep, nep, _cnt, err, _st, gmv, gref = out
        assert not err.any()
        S = meta["S"]
        recs = np.concatenate([blocks[s, :nblk[s]] for s in range(S)])
        lane = np.repeat(np.arange(S), nblk)
        recs = recs[np.argsort((recs[:, 0] >> 3) * S + lane, kind="stable")]
        assert _canon_all(recs) == _canon_all(dec.block_records[:, :34])
        _W64, _W64uv, _c16, _c16uv, ysz, usz, eysz, eusz = \
            PD._frame_dims(meta)
        for pairs, counts, rows, size in ((cp, ncp, dec.coef_pairs[0],
                                           ysz + 2 * usz),
                                          (ep, nep, dec.coef_pairs[1],
                                           eysz + 2 * eusz)):
            walk = np.zeros(size, np.int64)
            for s in range(S):
                walk[pairs[s, :counts[s], 0]] = pairs[s, :counts[s], 1]
            native = np.zeros(size, np.int64)
            pos = (rows[:, 0].astype(np.int64) << 16) \
                | (rows[:, 1].astype(np.int64) & 0xffff)
            native[pos] = rows[:, 2]
            assert np.array_equal(walk, native)
        assert np.array_equal(gmv, dec.cur_mv)
        assert np.array_equal(gref, dec.cur_ref)
        n += 1
    assert n == 5


@pytest.mark.parametrize("name", _tool().NAMES)
def test_committed_vectors_are_the_cases(name):
    """vectors/passa_inter_*.ivf hold the cases' packets, so the card
    checks the frames these tests check."""
    _info, pkts = read_ivf(os.path.join(VEC, name + ".ivf"))
    assert [bytes(p) for _pts, p in pkts] == _packets(name)


def test_kernel_inter_constants_match_the_layouts():
    """csrc/passa.cu's inter count offsets, its inter probability
    offsets, its MV phase and the hflags it reads are CNT_OFF's,
    probs8's, the module's and prep_inter's."""
    src = open(os.path.join(ROOT, "ffmpeg_hybrid_tpu_torch", "csrc",
                            "passa.cu")).read()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))
    for k, n in (("kCntYMode", "y_mode"), ("kCntUvMode", "uv_mode"),
                 ("kCntFilter", "filter"), ("kCntMvMode", "mv_mode"),
                 ("kCntIntra", "intra"), ("kCntComp", "comp"),
                 ("kCntSingleRef", "single_ref"), ("kCntCompRef", "comp_ref"),
                 ("kCntMvJoint", "mv_joint"), ("kCntMvSign", "mv_sign"),
                 ("kCntMvClasses", "mv_classes"),
                 ("kCntMvClass0", "mv_class0"), ("kCntMvBits", "mv_bits"),
                 ("kCntMvClass0Fp", "mv_class0_fp"), ("kCntMvFp", "mv_fp"),
                 ("kCntMvClass0Hp", "mv_class0_hp"), ("kCntMvHp", "mv_hp")):
        assert const(k) == PD.CNT_OFF[n], k
    assert const("kMv") == PD.MV
    [(_jd, td, fd)] = list(itertools.islice(
        _inter_frames(_packets("passa_inter_seg")), 1))
    ti, _tm = PD.prep_inter(td, fd)
    aux = ti["aux"]
    sizes = [3168] + [np.asarray(aux[k]).size for k in PD._INTER_PROBS]
    offs = const("kProbBytes") + np.concatenate([[0], np.cumsum(sizes)])
    names = ("kPCoefI", "kPPartI", "kPIntra", "kPComp", "kPCompRef",
             "kPSingleRef", "kPYMode", "kPUvMode", "kPMvMode", "kPFilter",
             "kPMvJoint", "kPMvSign", "kPMvClasses", "kPMvClass0",
             "kPMvBits", "kPMvC0Fp", "kPMvFp", "kPMvC0Hp", "kPMvHp",
             "kPSegPred", "kPRefSegEn", "kPRefSegVal", "kProbBytesInter")
    assert len(names) == len(offs)
    for k, o in zip(names, offs):
        assert const(k) == o, k
    p8 = PD.probs8(ti)
    assert len(p8) == offs[-1]
    assert np.array_equal(p8[offs[2]:offs[3]], aux["intrap"])
    def table(name):
        body = re.search(rf"\b{name}\[[^=]*= \{{(.*?)\}};", src,
                         re.S).group(1)
        return [int(v) for v in re.findall(r"-?\d+", body)]
    from ffmpeg_hybrid_tpu_torch.codecs.vp9 import tables as T
    for k, want in (("kMvRef", PD._MVREF), ("kSlotKind", PD._SLOT_KIND),
                    ("kSlotPar", PD._SLOT_PAR), ("kSubSrc", PD._SUBSRC),
                    ("kInterModeCtx", PD._IMCTX), ("kModeOff", PD._MOFF),
                    ("kSzGroup", PD._SZGROUP), ("kFilterLut", PD._FLUT),
                    ("kInterModeTree", T.INTER_MODE_TREE),
                    ("kFilterTree", T.FILTER_TREE),
                    ("kMvJointTree", T.MV_JOINT_TREE),
                    ("kMvClassTree", T.MV_CLASS_TREE),
                    ("kMvFpTree", T.MV_FP_TREE)):
        assert table(k) == np.asarray(want).reshape(-1).tolist(), k
    flags = re.search(r"enum HFlag \{([^}]*)\}", src).group(1)
    assert [f.strip() for f in flags.split(",")][-1] == "kNumHFlags"
    assert len(flags.split(",")) - 1 == len(aux["hflags"])
