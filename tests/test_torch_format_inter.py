"""Inter frames of VP9 profiles 1-3 in the port (ffmpeg_hybrid_tpu_torch)
against the JAX package on the CPU, with tolerance 0.

The cases are tools/make_format_inter_vectors_torch.py's recipes (a
keyframe, a lossless inter frame with every inter syntax element, two
lossy ones with every transform size and the loop filter) for 4:2:2,
4:4:0 and 4:4:4 at 8 bits, 4:2:0 at 10 and 4:4:4 at 12, encoded here at
128x96 in one tile column, and one at 512x64 in two:

- the port's VP9Decoder(device="cpu") decode_stream against the JAX
  package's golden decoder, frame by frame by the MD5 of the output;
- the host pass A, native and pure-Python, on every inter frame: the
  block records, the coefficient pairs (as dense planes), the eob
  grids, the MV and reference grids and the per-4x4 grids against the
  JAX package's pass A;
- the device pass A on every inter frame: the port's prep_inter and its
  plain walk against JAX's prep_inter and decode_frame_device with
  inter=1 (the counts forced on);
- the committed 1080p clips' headers against the recipes.

The kernels on these frames: chip_smoke.py on the card."""
import hashlib
import os
import sys

import numpy as np
import pytest
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder as JDec
from ffmpeg_hybrid_tpu.ops import passa_device as JPD
from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
from ffmpeg_hybrid_tpu_torch.formats.ivf import read_ivf
from ffmpeg_hybrid_tpu_torch.ops import passa_device as PD

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOOLS = os.path.join(ROOT, "tools")
VEC = os.path.join(ROOT, "vectors")


def _tool():
    sys.path.insert(0, TOOLS)
    try:
        import make_format_inter_vectors_torch
    finally:
        sys.path.pop(0)
    return make_format_inter_vectors_torch


# (clip recipe, width, height, log2 of the tile columns)
SMALL = [(name, 128, 96, 0) for name in _tool().NAMES] \
    + [("fmt_inter_444_12_1080p", 512, 64, 1)]
IDS = [f"{n[len('fmt_inter_'):-len('_1080p')]}-{w}x{h}"
       for n, w, h, _t in SMALL]
_PACKETS = {}


def _packets(case):
    """The case's packets, encoded once a module."""
    if case not in _PACKETS:
        name, w, h, tc = case
        _PACKETS[case] = _tool().packets(name, w, h, tc)
    return _PACKETS[case]


@pytest.mark.parametrize("case", SMALL, ids=IDS)
def test_decode_matches_the_golden_decoder(case):
    pkts = _packets(case)
    jd = JDec(recon_backend="golden")
    want = [hashlib.md5(f.to_bytes()).hexdigest()
            for p in pkts for f in jd.decode(p)]
    td = VP9Decoder(device="cpu")
    got = [hashlib.md5(f.to_bytes()).hexdigest()
           for f in td.decode_stream(iter(pkts))]
    assert len(want) == 4
    assert got == want


def _dense(rows, sizes, wide):
    """Pair rows (position in two halfwords, then the value in one or
    two) as the dense planes they fill, split by `sizes`."""
    out = np.zeros(sum(sizes), np.int64)
    pos = (rows[:, 0].astype(np.int64) << 16) \
        | (rows[:, 1].astype(np.int64) & 0xffff)
    val = rows[:, 2].astype(np.int64)
    if wide:
        val = (val << 16) | (rows[:, 3].astype(np.int64) & 0xffff)
    out[pos] = val
    return np.split(out, np.cumsum(sizes)[:-1])


# the per-4x4 grids and block-level arrays of a pass A that both
# packages fill the same way in each mode
GRIDS = ("eob_y", "eob_u", "eob_v", "lf_level", "lf_mask")
PY_GRIDS = GRIDS + ("coef_y", "coef_u", "coef_v", "txsz4", "txtype4",
                    "uvtx4", "inter4", "inter4uv", "mv4", "uvmv4", "ref4",
                    "comp4", "filter4")


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("case", SMALL, ids=IDS)
def test_host_pass_a_matches_jax(case, native):
    """Each inter frame's pass A, the port's against the JAX package's
    in the same mode (the JAX golden decoder's dense coefficient planes
    against the port's native pair rows)."""
    jd = JDec(recon_backend="golden", use_native=native)
    td = VP9Decoder(device="cpu", use_native=native)
    n = 0
    for fd in _packets(case):
        jj, tj = jd.decode_pass_a(fd), td.decode_pass_a(fd)
        h = td.header
        assert (h.profile, h.bpp, h.ss_h, h.ss_v) == (
            jd.header.profile, jd.header.bpp, jd.header.ss_h,
            jd.header.ss_v)
        if h.keyframe:
            continue
        for a in PY_GRIDS if not native else GRIDS:
            assert np.array_equal(getattr(tj, a), getattr(jj, a)), a
        assert np.array_equal(td.cur_mv, jd.cur_mv)
        assert np.array_equal(td.cur_ref, jd.cur_ref)
        if native:
            assert np.array_equal(tj.block_records, jj.block_records)
            cp, ep = tj.coef_pairs
            planes = (jj.coef_y, jj.coef_u, jj.coef_v)
            got = _dense(cp, [p.size for p in planes], cp.shape[1] == 4)
            for g, p in zip(got, planes):
                assert np.array_equal(g, p.reshape(-1))
            eobs = (jj.eob_y, jj.eob_u, jj.eob_v)
            got = _dense(ep, [e.size for e in eobs], False)
            for g, e in zip(got, eobs):
                assert np.array_equal(g, e.reshape(-1))
            assert (cp.shape[1] == 4) == (h.bpp > 8)
        n += 1
    assert n == 3


def _canon(vals):
    """The record with the fields a block does not write zeroed (as
    tests/test_torch_passa_inter.py)."""
    v = [int(x) for x in vals]
    if v[6]:
        v[15] = v[16] = v[17] = 0
        v[18:] = [0] * 16
    else:
        v[13] = 0
        if not v[14]:
            v[16] = 0
    return v


# the inter frame of each case that the walk also takes against JAX's
# walk: the lossless one, with every inter syntax element (the lossy
# frames' transform sizes and tokens are held to the native pass A on
# every frame); JAX compiles its walk once for each format, lossless flag
# and lane count, some 10 s each here, so the 12-bit 4:4:4 format takes
# it on its two-lane case alone
JAX_WALK_FRAME = 1
JAX_WALK_CASES = [c for c in SMALL if c != ("fmt_inter_444_12_1080p", 128,
                                            96, 0)]


def _walk_vs_jax(ji, jm, ti, tm):
    jm = dict(jm, want_counts=1)
    tm = dict(tm, want_counts=1)
    want = [np.asarray(o) for o in JPD.decode_frame_device(ji, jm)]
    got = [o.numpy() for o in PD.decode_frame(ti, tm, "cpu")]
    assert not want[7].any() and not got[7].any()
    for s in range(tm["S"]):
        nb = int(want[1][s])
        assert int(got[1][s]) == nb
        assert [_canon(r) for r in got[0][s, :nb]] == \
            [_canon(r) for r in want[0][s, :nb]], f"lane {s}"
        for i, c in ((2, 3), (4, 5)):
            m = int(want[c][s])
            assert int(got[c][s]) == m
            assert np.array_equal(got[i][s, :m], want[i][s, :m])
    assert np.array_equal(got[6], want[6])


def _walk_vs_host(td, job, ti, tm):
    """The plain walk's records (in decode order), coefficient and eob
    pairs and MV and reference grids as the native host pass A's."""
    out = [o.numpy() for o in PD.decode_frame(ti, tm, "cpu")]
    blocks, nblk, cp, ncp, ep, nep, _cnt, err, _st, gmv, gref = out
    assert not err.any()
    S = tm["S"]
    recs = np.concatenate([blocks[s, :nblk[s]] for s in range(S)])
    lane = np.repeat(np.arange(S), nblk)
    recs = recs[np.argsort((recs[:, 0] >> 3) * S + lane, kind="stable")]
    assert [_canon(r) for r in recs] == \
        [_canon(r) for r in job.block_records[:, :34]]
    _W64, _W64uv, _c16, _c16uv, ysz, usz, eysz, eusz = PD._frame_dims(tm)
    for pairs, counts, rows, sizes in (
            (cp, ncp, job.coef_pairs[0], [ysz, usz, usz]),
            (ep, nep, job.coef_pairs[1], [eysz, eusz, eusz])):
        walk = np.zeros(sum(sizes), np.int64)
        for s in range(S):
            walk[pairs[s, :counts[s], 0]] = pairs[s, :counts[s], 1]
        native = np.concatenate(_dense(rows, sizes, rows.shape[1] == 4))
        assert np.array_equal(walk, native)
    assert np.array_equal(gmv, td.cur_mv)
    assert np.array_equal(gref, td.cur_ref)


@pytest.mark.parametrize("case", SMALL, ids=IDS)
def test_device_walk_matches_jax(case):
    """On every inter frame, prep_inter's inputs and meta as JAX's, array
    by array, and the plain walk (decode_frame on the CPU) as the native
    host pass A: records, pairs, MV and reference grids. On the lossless
    frame (JAX_WALK_FRAME) of JAX_WALK_CASES, the plain walk as JAX's decode_frame_device
    with inter=1 on the same inputs, the counts forced on both sides:
    records, pairs, counts and err words."""
    jd = JDec(recon_backend="golden", use_native=True)
    td = VP9Decoder(device="cpu", use_native=True)
    n = 0
    for k, fd in enumerate(_packets(case)):
        jd.decode_pass_a(fd)
        job = td.decode_pass_a(fd)
        if td.header.keyframe:
            continue
        ji, jm = JPD.prep_inter(jd, fd)
        ti, tm = PD.prep_inter(td, fd)
        for key, v in ji.items():
            if key == "aux":
                assert set(ti["aux"]) == set(v)
                for a, arr in v.items():
                    assert np.array_equal(ti["aux"][a], arr), a
            else:
                assert np.array_equal(np.asarray(ti[key]), np.asarray(v)), \
                    key
        assert {key: tm[key] for key in jm} == jm
        assert tm["inter"] == 1
        _walk_vs_host(td, job, ti, tm)
        if k == JAX_WALK_FRAME and case in JAX_WALK_CASES:
            _walk_vs_jax(ji, jm, ti, tm)
        n += 1
    assert n == 3


@pytest.mark.parametrize("name", _tool().NAMES)
def test_committed_clips_are_the_recipes(name):
    """vectors/<clip>.ivf: 1920x1080, 4 tile columns, a keyframe and
    three inter frames at the clip's profile, bit depth and layout, the
    quantiser of each recipe; its framemd5 has four frames."""
    tool = _tool()
    bpp, ss_h, ss_v = tool.CASES[name]
    _info, pkts = read_ivf(os.path.join(VEC, name + ".ivf"))
    pkts = list(pkts)
    assert len(pkts) == 4
    dec = VP9Decoder(device="cpu", use_native=True)
    for i, (_pts, data) in enumerate(pkts):
        dec.decode_pass_a(bytes(data))
        h = dec.header
        want_qi = tool.KEY["yac_qi"] if i == 0 \
            else tool.INTER[i - 1].get("yac_qi", 0)
        assert (h.keyframe, h.profile, h.bpp, h.ss_h, h.ss_v) == (
            i == 0, tool.profile_of(bpp, ss_h, ss_v), bpp, ss_h, ss_v)
        assert (h.width, h.height, h.tile_cols) == (tool.W, tool.H, 4)
        assert h.yac_qi == want_qi
    md5 = [line for line in open(os.path.join(VEC, name + ".framemd5"))
           if line.strip() and not line.startswith("#")]
    assert len(md5) == 4
    assert "golden decoder" in open(os.path.join(VEC, name + ".framemd5"))\
        .read()
    size = sum(os.path.getsize(os.path.join(VEC, n + ".ivf"))
               for n in tool.NAMES)
    assert size < 8 << 20
