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
cases; the committed vectors/passa_inter_* are held to them. A numpy
model of the kernel's candidate scan (each of the 32 find_ref_mvs slots
evaluated on its own, a lane each, then chosen by masks in slot order as
its ballots choose) is held to the plain walk's serial scan: on every
scan of the committed inter clips and of bench_1080p frames 1-3, on
hypothesis-drawn neighbourhoods (sub-8x8 blocks, both references, sign
biases) and on handcrafted ones through the rare branches of the
reference's two-stage compare, the last two through the plain walk's own
closure. The kernel, csrc/passa.cu,
against this plain version: the `cuda` tests of
tests/test_torch_passa_decoder.py and chip_smoke.py."""
import itertools
import os
import re
import sys
import types

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
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
    assert const("kPCoefI") == PD._COEF_OFF_INTER
    # the padded rows of both kinds of block, as probs8 holds them
    rows = PD.coef16_rows(PD.probs8(ti))
    coef = np.asarray(aux["coef11i"]).reshape(8, 2, 36, 11)
    for k in range(2):
        assert np.array_equal(rows[k, :, :11], coef[:, k].reshape(-1, 11))
    assert not rows[:, :, 11:].any()
    flags = re.search(r"enum HFlag \{([^}]*)\}", src).group(1)
    assert [f.strip() for f in flags.split(",")][-1] == "kNumHFlags"
    assert len(flags.split(",")) - 1 == len(aux["hflags"])


# ---------------------------------------------------------------------------
# the kernel's candidate scan (csrc/passa.cu find_ref_mv): a slot a lane,
# chosen by ballots


_FIND_REF_MV = next(c for c in PD._walk_lane.__code__.co_consts
                    if isinstance(c, types.CodeType)
                    and c.co_name == "find_ref_mv")


def _plain_find_ref_mv(state):
    """The plain walk's serial scan (the find_ref_mv closure of
    _walk_lane) over `state`, the values of its free variables."""
    cells = tuple(types.CellType(state[n])
                  for n in _FIND_REF_MV.co_freevars)
    return types.FunctionType(_FIND_REF_MV, PD.__dict__, "find_ref_mv",
                              None, cells)


def _slots(S, refz, z, sbp):
    """Each of the 32 slots on its own, as the kernel's lane j loads and
    classifies it: (valid [32] bool, v [32, 2] int64, the sign-bias flip
    applied). S: the plain walk's state (_plain_find_ref_mv's)."""
    bs, br, bc, c0 = S["bs"], S["br"], S["bc"], S["c0"]
    C8, tb, sbias = S["C8"], S["tb"], S["sbias"]
    gref, gmv = S["gref"], S["gmv"]
    sbc = min(max(sbp, 0), 3)
    valid = np.zeros(32, bool)
    v = np.zeros((32, 2), np.int64)
    for j in range(32):
        kind, par = int(PD._SLOT_KIND[j]), int(PD._SLOT_PAR[j])
        other = -1
        if kind == 0:
            valid[j] = sbp >= 1 if par == 0 else sbp == 3
            v[j] = S["b_mv"][par][z]
        elif kind <= 2:
            if sbp >= 0 and (br > 0 if kind == 1 else bc > c0):
                gi = (br - 1) * C8 + bc if kind == 1 else br * C8 + bc - 1
                g0, g1 = gref[2 * gi], gref[2 * gi + 1]
                valid[j] = refz in (g0, g1)
                ctx = S["a_mv"][2 * bc + (sbc & 1)] if kind == 1 \
                    else S["l_mv"][2 * S["row7"] + (sbc >> 1)]
                v[j] = ctx[0 if g0 == refz else 1]
        else:
            if kind in (3, 5, 6):
                if kind == 3 and sbp >= 0 and par < 2:
                    continue
                nc = bc + tb.mvref[bs][par][0]
                nr = br + tb.mvref[bs][par][1]
                if not (c0 <= nc < S["cols"] and 0 <= nr < S["rows"]):
                    continue
                gi = nr * C8 + nc
                g0, g1 = gref[2 * gi], gref[2 * gi + 1]
                m = gmv[4 * gi:4 * gi + 4]
            else:
                if not S["use_prev"]:
                    continue
                pi = br * C8 + bc
                g0, g1 = tb.prev_ref[pi]
                m = tb.prev_mv[pi]
            v0, v1 = (m[0], m[1]), (m[2], m[3])
            if kind in (3, 4):
                valid[j] = refz in (g0, g1)
                v[j] = v0 if g0 == refz else v1
            elif kind in (5, 7):
                valid[j] = 0 <= g0 != refz
                v[j], other = v0, g0
            else:
                valid[j] = 0 <= g1 != refz and v0 != v1
                v[j], other = v1, g1
        if valid[j] and other >= 0 and sbias[other] != sbias[refz]:
            v[j] = -v[j]
    return valid, v


def _select(valid, v, lo, hi, idxn, sbp):
    """The kernel's choice among the slots: masks (its ballots) and the
    first set lane of each (__ffs), a direct slot (lanes 0-2) unclamped,
    the others clamped to [lo, hi]."""
    c = np.clip(v, lo, hi)
    zero = tuple(int(x) for x in np.clip([0, 0], lo, hi))
    lanes = np.arange(32)

    def first(m):
        return int(np.flatnonzero(m)[0]) if m.any() else None

    def out(a):
        return int(a[0]), int(a[1])
    if sbp <= 0:
        f = first(valid)
        if f is None:
            return zero
        if not idxn:
            return out(c[f])
        k = first(valid & (lanes > f) & (v != v[f]).any(1))
        return zero if k is None else out(c[k])
    if not idxn:
        f = first(valid)
        if f is None:
            return zero
        return out(v[f] if f < 3 else c[f])
    direct = valid & (lanes < 3)
    m = None
    if direct.any():
        d1 = first(direct)
        m = v[d1]
        k = first(direct & (lanes > d1) & (v != m).any(1))
        if k is not None:
            return out(v[k])
    k1 = first(valid & (lanes >= 3))
    if k1 is None:
        return zero
    if m is None or (c[k1] != m).any():
        return out(c[k1])
    k = first(valid & (lanes > k1) & (v != v[k1]).any(1))
    if k is None:
        return zero
    return out(c[k]) if (c[k] != m).any() else (0, 0)


def _model_find_ref_mv(S, refz, z, idxn, sbp):
    bw8, bh8 = S["bwh"][1][S["bs"]]
    lo = (-(128 + S["bc"] * 64), -(128 + S["br"] * 64))
    hi = (128 + (S["cols"] - S["bc"] - bw8) * 64,
          128 + (S["rows"] - S["br"] - bh8) * 64)
    valid, v = _slots(S, refz, z, sbp)
    return _select(valid, v, lo, hi, idxn, sbp)


def _scans_of(frames, native=True):
    """Every find_ref_mv call of the plain walk over the inter frames of
    `frames`: (its state, arguments, return value)."""
    calls, stack = [], []

    def prof(frame, event, arg):
        if frame.f_code is not _FIND_REF_MV:
            return
        if event == "call":
            loc = frame.f_locals
            S = {n: loc[n] for n in _FIND_REF_MV.co_freevars}
            # the grids and contexts as they stand at the call
            for n in ("gref", "gmv", "a_mv", "l_mv"):
                S[n] = list(S[n])
            S["b_mv"] = [list(q) for q in S["b_mv"]]
            stack.append((S, tuple(loc[a] for a in ("refz", "z", "idxn",
                                                    "sbp"))))
        elif event == "return":
            S, args = stack.pop()
            calls.append((S, args, tuple(arg)))
    dec = VP9Decoder(device="cpu", use_native=native)
    for fd in frames:
        if dec.decode_pass_a(fd).ready is not None:
            continue
        if dec.header.keyframe or dec.header.intraonly:
            continue
        inputs, meta = PD.prep_inter(dec, fd)
        sys.setprofile(prof)
        try:
            PD.decode_frame(inputs, meta, "cpu")
        finally:
            sys.setprofile(None)
    return calls


@pytest.mark.parametrize("name", _tool().NAMES + ("bench_1080p",))
def test_slot_parallel_scan_matches_the_plain_scan(name):
    """The model of the kernel's slot-parallel candidate scan returns
    what the plain walk's serial scan returned, on every scan of the
    clip's inter frames (bench_1080p: frames 1-3); sub-8x8 sub-blocks,
    NEARMV and both references of compound blocks among them."""
    frames = _bench_frames(4) if name == "bench_1080p" else _packets(name)
    calls = _scans_of(frames)
    assert calls
    for S, (refz, z, idxn, sbp), want in calls:
        assert _model_find_ref_mv(S, refz, z, idxn, sbp) == want, \
            (S["br"], S["bc"], S["bs"], refz, z, idxn, sbp)
    if name == "passa_inter_modes":
        kinds = {(args[2], args[3] > 0, args[1]) for _S, args, _w in calls}
        assert {(True, True, 0), (False, True, 0), (True, False, 0),
                (False, False, 1)} <= kinds


class _Tb:
    """The tables the plain scan reads from its _Tables."""

    def __init__(self, mvref, prev_ref, prev_mv):
        self.mvref, self.prev_ref, self.prev_mv = mvref, prev_ref, prev_mv


# mv components drawn for the neighbourhoods: few values, so candidates
# repeat, some past any clamp
_MVS = np.asarray([0, 1, -1, 2, 6, -6, 130, -200, 700, -900])


@st.composite
def _neighbourhoods(draw):
    """A block in a small frame, its position, size, mode, reference and
    the frame's sign biases drawn; every grid cell, mv context, earlier
    sub-block mv and previous-frame cell from a drawn seed, each from few
    values (so that candidates repeat and clamp)."""
    rows, cols = draw(st.integers(1, 12)), draw(st.integers(1, 12))
    C8 = 16
    bs = draw(st.integers(0, 12))
    br, bc = draw(st.integers(0, rows - 1)), draw(st.integers(0, cols - 1))
    c0 = draw(st.integers(0, bc))
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 32 - 1)))
    ncell = C8 * 16

    def mvs(*shape):
        return _MVS[rng.integers(0, len(_MVS), shape)].tolist()

    def refs(*shape):
        return rng.integers(-1, 3, shape).tolist()

    def ctx(n):
        return [tuple(tuple(p) for p in q) for q in mvs(n, 2, 2)]
    S = dict(C8=C8, a_mv=ctx(2 * (cols + 16)), b_mv=[list(q) for q in ctx(4)],
             bc=bc, br=br, bs=bs, bwh=PD._BWH.tolist(), c0=c0, cols=cols,
             gmv=mvs(4 * ncell), gref=refs(2 * ncell), l_mv=ctx(16),
             row7=br & 7, rows=rows,
             sbias=tuple(draw(st.lists(st.integers(0, 1), min_size=3,
                                       max_size=3))),
             tb=_Tb(PD._MVREF.tolist(), refs(ncell, 2), mvs(ncell, 4)),
             use_prev=draw(st.booleans()))
    # a sub-block past the first only where the block has one: 4x8 (11)
    # has sub-block 1, 8x4 (10) sub-block 2, 4x4 (12) all four
    sbp = draw(st.sampled_from({10: [-1, 0, 2], 11: [-1, 0, 1],
                                12: [-1, 0, 1, 2, 3]}.get(bs, [-1])))
    return (S, draw(st.integers(0, 2)), draw(st.integers(0, 1)),
            draw(st.booleans()), sbp)


@settings(max_examples=400, deadline=None)
@given(_neighbourhoods())
def test_slot_parallel_scan_matches_the_plain_scan_drawn(case):
    """The model of the kernel's scan against the plain walk's own scan
    (its closure, called on the drawn state) on drawn neighbourhoods."""
    S, refz, z, idxn, sbp = case
    want = _plain_find_ref_mv(S)(refz, z, idxn, sbp)
    assert _model_find_ref_mv(S, refz, z, idxn, sbp) == tuple(want)


def _empty_state(**kw):
    """A 12x12-cell frame with no candidate anywhere (every grid cell's
    references -1, no previous frame), a 4x4 block (bs 12) at cell (2, 2)
    of tile 0; `kw` overrides any of the scan's free variables."""
    ncell = 16 * 16
    zero = ((0, 0), (0, 0))
    S = dict(C8=16, a_mv=[zero] * 64, b_mv=[[(0, 0), (0, 0)]] * 4, bc=2,
             br=2, bs=12, bwh=PD._BWH.tolist(), c0=0, cols=12,
             gmv=[0] * (4 * ncell), gref=[-1] * (2 * ncell), l_mv=[zero] * 16,
             row7=2, rows=12, sbias=(0, 0, 0),
             tb=_Tb(PD._MVREF.tolist(), [[-1, -1]] * ncell,
                    [[0] * 4] * ncell),
             use_prev=False)
    S.update(kw)
    return S


def _with_ctx(S, above, left):
    """S with the block's above and left cells on reference 0 and the mv
    contexts of sub-block 3 (column 5, row 5) set to `above` and `left`."""
    gref = list(S["gref"])
    for r, c in ((S["br"] - 1, S["bc"]), (S["br"], S["bc"] - 1)):
        gref[2 * (r * S["C8"] + c)] = 0
    a_mv, l_mv = list(S["a_mv"]), list(S["l_mv"])
    a_mv[5] = (above, (0, 0))
    l_mv[5] = (left, (0, 0))
    return dict(S, gref=gref, a_mv=a_mv, l_mv=l_mv)


# the edge of the block's clamp: maxx for a 4x4 block at column 2 of 12
_EDGE = 128 + (12 - 2 - 1) * 64


@pytest.mark.parametrize("case", ["zero_return", "second_direct",
                                  "clamped_after_direct", "m8_differs"])
def test_slot_parallel_scan_rare_branches(case):
    """NEARMV on sub-block 3 of a 4x4 block (every direct slot valid)
    through the rare branches of the reference's two-stage compare
    (vp9mvs.c:95-124): the model of the kernel's ballots returns what the
    plain walk's closure returns, and each case reaches its branch."""
    m = (_EDGE, 0)
    b_mv_same = [[m, (0, 0)]] * 4
    if case == "zero_return":
        # the first clamped candidate equals the direct ones (m8 = m), a
        # later one differs from m8 but clamps to m: (0, 0)
        S = _with_ctx(_empty_state(b_mv=b_mv_same), m, (_EDGE + 300, 0))
        want = (0, 0)
    elif case == "second_direct":
        # the second direct candidate differs from the first: unclamped
        b_mv = [[(8, 8), (0, 0)], [(_EDGE + 64, 0), (0, 0)], [m, (0, 0)],
                [m, (0, 0)]]
        S = _with_ctx(_empty_state(b_mv=b_mv), m, m)
        want = (_EDGE + 64, 0)
    elif case == "clamped_after_direct":
        # no direct differs; the first clamped candidate does: clamped
        S = _with_ctx(_empty_state(b_mv=b_mv_same), (-4, 6), m)
        want = (-4, 6)
    else:
        # m8 from the first clamped candidate (equal to m), the next
        # differs from m8 and from m once clamped: that one
        S = _with_ctx(_empty_state(b_mv=b_mv_same), m, (16, -2))
        want = (16, -2)
    got = _plain_find_ref_mv(S)(0, 0, True, 3)
    assert tuple(got) == want
    assert _model_find_ref_mv(S, 0, 0, True, 3) == want
