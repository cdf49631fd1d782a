"""The port's full-frame sharded pass B (parallel/fullframe.py) on CPU
meshes, bit-exact (tolerance 0): against the JAX package's
sharded_decode_pass_b on the virtual CPU devices (the twin of
test_gop_and_tile_sharded: gop rows of independent frames), and against
the port's serial decode, whose frames tests/test_torch_decoder.py holds
to the JAX package: 10 bits, show-existing frames passed through beside
an active gop row on one tile column, the mismatches that raise. The
host-side helpers are held to their JAX counterparts. Chains of frames
(2 and 4 tile columns, scaled references, mixed geometry) are
test_torch_fullframe_chains.py. Streams come from tools/mini_encoder.py
in process."""
import os
import sys
from functools import lru_cache

import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
from ffmpeg_hybrid_tpu_torch.parallel import fullframe as PF
from ffmpeg_hybrid_tpu_torch.parallel.mesh import make_mesh

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")


def _mini():
    sys.path.insert(0, TOOLS)
    try:
        import mini_encoder
    finally:
        sys.path.pop(0)
    return mini_encoder


def _mesh(gop, ntile):
    return make_mesh(gop * ntile, gop, device="cpu")


def _coded(frame, i):
    w, h = frame.size
    cw, ch = ((w + 7) >> 3) * 8, ((h + 7) >> 3) * 8
    if i:
        cw, ch = cw >> frame.ss_h, ch >> frame.ss_v
    return ch, cw


def _assert_frames_equal(frame, planes, ctx=""):
    """The serial frame's planes (on the CPU) against sharded planes, on
    the coded area."""
    for i in range(3):
        ch, cw = _coded(frame, i)
        a = frame.dev[i][:ch, :cw] if frame.dev is not None else \
            torch.as_tensor(frame.planes[i][:ch, :cw])
        b = torch.as_tensor(np.asarray(planes[i]))[:ch, :cw]
        assert torch.equal(a.to(torch.int32), b.to(torch.int32)), \
            f"{ctx} plane {i}: {int((a != b).sum())} mismatches"


def _run(packets, ntile, check_kept=True):
    """Decode packets serially and sharded over a (1, ntile) mesh, one
    frame a step, each sharded output installed as its frame's planes;
    every frame equal. Returns the sharded decoder."""
    ser = VP9Decoder(device="cpu")
    shd = VP9Decoder(device="cpu")
    mesh = _mesh(1, ntile)
    for n, data in enumerate(packets):
        js = ser.decode_pass_a(data)
        ser.decode_pass_b(ser.precompute_job(js))
        j = shd.decode_pass_a(data)
        [planes] = PF.sharded_decode_pass_b([j], mesh)
        PF.install(j, planes)
        _assert_frames_equal(js.cur_frame_obj, planes, f"frame {n}")
        if check_kept:
            # the residual consumed the decoder's kept buffers
            assert all(b.read_zero() and b.consumed
                       for b in shd.coef_bufs.values())
    return shd


@lru_cache(maxsize=None)
def _gop_stream():
    m = _mini()
    w, h = 512, 128
    k = m.encode_keyframe_random(w, h, seed=7, filter_level=24,
                                 tile_cols_log2=1)
    # refresh_mask=0: both inter frames reference only the keyframe
    f1 = m.encode_inter_flex(w, h, seed=8, refresh_mask=0, filter_level=20,
                             coeffs=True, p_intra=0.2,
                             mv_mags=(0, 2, 4, 8, 16), tile_cols_log2=1)
    f2 = m.encode_inter_flex(w, h, seed=9, refresh_mask=0, filter_level=31,
                             coeffs=True, p_intra=0.1,
                             mv_mags=(0, 2, 8, 32), tile_cols_log2=1)
    return k, f1, f2


def test_gop_and_tile_sharded_matches_jax():
    """Two independent inter frames x 2 tile stripes on a (2, 2) mesh:
    each frame equal to the JAX package's sharded_decode_pass_b on four
    virtual CPU devices and to the serial decode; the keyframe on (1,
    2)."""
    import jax
    from jax.sharding import Mesh
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder as JD
    from ffmpeg_hybrid_tpu.parallel.fullframe import \
        sharded_decode_pass_b as jax_sharded
    k, f1, f2 = _gop_stream()
    ser = VP9Decoder(device="cpu")
    serial = []
    for data in (k, f1, f2):
        serial.extend(ser.decode(data))
    shd = VP9Decoder(device="cpu")
    jk = shd.decode_pass_a(k)
    [kplanes] = PF.sharded_decode_pass_b([jk], _mesh(1, 2))
    PF.install(jk, kplanes)
    _assert_frames_equal(serial[0], kplanes, "gop kf")
    j1, j2 = shd.decode_pass_a(f1), shd.decode_pass_a(f2)
    outs = PF.sharded_decode_pass_b([j1, j2], _mesh(2, 2))
    _assert_frames_equal(serial[1], outs[0], "gop f1")
    _assert_frames_equal(serial[2], outs[1], "gop f2")
    jd = JD(recon_backend="golden")
    jjk = jd.decode_pass_a(k)
    jd.decode_pass_b(jjk)
    jj1, jj2 = jd.decode_pass_a(f1), jd.decode_pass_a(f2)
    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    want = jax_sharded([jj1, jj2], Mesh(devs, ("gop", "tile")))
    for got, w in zip(outs, want):
        for p in range(3):
            assert np.array_equal(got[p].numpy(), w[p])


def test_sharded_10bit():
    """A profile-2 10-bit keyframe (wide coefficients, high-bit-depth
    transforms and loop filter), 2 tile columns."""
    k = _mini().encode_keyframe_random(512, 128, bpp=10, seed=24,
                                       filter_level=30, yac_qi=80,
                                       tile_cols_log2=1)
    _run([k], 2)


def test_show_existing_passthrough():
    """A show-existing frame (a one-byte packet: profile 0, slot 1) on a
    gop row passes its referenced frame's planes through beside an active
    row; a packet that shows nothing gives None; one tile column (the
    replay's serial form)."""
    m = _mini()
    w, h = 256, 128
    k = m.encode_keyframe_random(w, h, seed=31, filter_level=20)
    f1 = m.encode_inter_flex(w, h, seed=32, refresh_mask=0x02,
                             filter_level=16, coeffs=True, p_intra=0.1,
                             mv_mags=(0, 2, 8), show=False)
    show1 = bytes([0x88 | 1])
    f2 = m.encode_inter_flex(w, h, seed=33, refresh_mask=0x04,
                             filter_level=26, coeffs=True, mv_mags=(0, 4))
    ser = VP9Decoder(device="cpu")
    truth = []
    for d in (k, f1, show1, f2):
        truth.append(ser.decode_pass_b(ser.precompute_job(
            ser.decode_pass_a(d))))
    assert truth[1] == [] and len(truth[2]) == 1
    shd = VP9Decoder(device="cpu")
    mesh = _mesh(1, 1)
    planes = {}
    for n, d in enumerate((k, f1)):
        j = shd.decode_pass_a(d)
        [planes[n]] = PF.sharded_decode_pass_b([j], mesh)
        PF.install(j, planes[n])
    _assert_frames_equal(truth[0][0], planes[0], "kf")
    js, j2 = shd.decode_pass_a(show1), shd.decode_pass_a(f2)
    outs = PF.sharded_decode_pass_b([js, j2], _mesh(2, 1))
    _assert_frames_equal(truth[2][0], outs[0], "show-existing")
    assert all(torch.equal(a, b) for a, b in zip(outs[0], planes[1]))
    _assert_frames_equal(truth[3][0], outs[1], "after")
    quiet = shd.decode_pass_a(show1)
    quiet.ready = []
    assert PF.sharded_decode_pass_b([quiet], mesh) == [None]


def test_frame_mismatches_raise():
    """Rows must share bpp, lossless, subsampling and tile count, and
    the mesh its tile count; a row's decoder must be on the row's
    device."""
    k, _f1, _f2 = _gop_stream()
    k10 = _mini().encode_keyframe_random(512, 128, bpp=10, seed=1,
                                         filter_level=10, tile_cols_log2=1)
    ja = VP9Decoder(device="cpu").decode_pass_a(k)
    jb = VP9Decoder(device="cpu").decode_pass_a(k10)
    with pytest.raises(ValueError, match="must share"):
        PF.sharded_decode_pass_b([ja, jb], _mesh(2, 2))
    with pytest.raises(ValueError, match="tile cols"):
        PF.sharded_decode_pass_b([ja], _mesh(1, 4))
    with pytest.raises(ValueError, match="jobs for"):
        PF.sharded_decode_pass_b([ja], _mesh(2, 2))
    meta = make_mesh(2, 1, device="cpu")
    meta.devices[0, :] = torch.device("meta")
    with pytest.raises(ValueError, match="gop row 0"):
        PF.sharded_decode_pass_b([ja], meta)


def test_helpers_match_jax():
    """The coefficient planes (test_torch_tiles._dense_coef), the intra
    schedules and the tile bounds against the JAX package's on the
    keyframe and an inter frame; the port's stripe slab (_stripe_slab)
    holds, for each stripe, the rows that the JAX package's _split_levels
    keeps, with their levels."""
    from test_torch_tiles import _dense_coef
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder as JD
    from ffmpeg_hybrid_tpu.ops import recon_tpu
    from ffmpeg_hybrid_tpu.parallel import fullframe as JF
    from ffmpeg_hybrid_tpu_torch.ops import recon
    k, f1, _f2 = _gop_stream()
    dec, jd = VP9Decoder(device="cpu"), JD(recon_backend="golden")
    for data in (k, f1):
        s, js = dec.decode_pass_a(data), jd.decode_pass_a(data)
        for (c, e), (jc, je) in zip(_dense_coef(s), JF._dense_coef(js)):
            assert np.array_equal(c, jc) and np.array_equal(e, je)
        bounds = PF._tile_bounds(s)
        assert bounds == JF._tile_bounds(js)
        x0 = np.asarray([b * 64 for b in bounds[:-1]])
        wreal = np.diff(np.asarray(bounds)) * 64
        recon.precompute_host(s)
        for p in (0, 1):
            levels = recon._build_intra_schedule_fast(s, p)
            jlevels = recon_tpu._build_intra_schedule_fast(js, p)
            assert len(levels) == len(jlevels)
            for la, lb in zip(levels, jlevels):
                assert la.keys() == lb.keys()
                assert all(np.array_equal(
                    np.asarray(la[z], np.int32).reshape(-1, 8),
                    np.asarray(lb[z], np.int32).reshape(-1, 8)) for z in la)
            xs, ws = (x0 >> s.ss_h, wreal >> s.ss_h) if p else (x0, wreal)
            jlv = [JF._split_levels(jlevels, int(a), int(a + w))
                   for a, w in zip(xs, ws)]
            slab = s.pre["slabs"][p]
            if slab is None:
                assert not any(lvl for lv in jlv for lvl in lv)
                continue
            Hp = s.cur_frame_obj.planes[p].shape[0]
            buf, L, sizes, caps = PF._stripe_slab(slab, xs, Hp, int(ws.max()))
            real = buf[:, 0] < len(xs) * Hp
            for t in range(len(xs)):
                rows = buf[real & (buf[:, 0] // Hp == t)].astype(np.int32)
                rows[:, 0] -= t * Hp
                want_rows = np.concatenate([
                    np.asarray(e, np.int32).reshape(-1, 8)
                    for lvl in jlv[t] for e in lvl.values()])
                assert sorted(map(tuple, rows)) == sorted(map(tuple,
                                                              want_rows))


@pytest.mark.cuda
def test_cuda_sharded_matches_serial():
    """On the card: the chained 2-tile stream and the (2, 2) gop step,
    sharded against the serial decode, with the replay kernel launched
    once a plane set a filtered frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from ffmpeg_hybrid_tpu_torch.ops import lpf_replay
    k, f1, f2 = _gop_stream()
    ser = VP9Decoder(device="cuda")
    serial = [f for d in (k, f1, f2) for f in ser.decode(d)]
    shd = VP9Decoder(device="cuda")
    mesh = make_mesh(2, 1)
    lpf_replay.reset_launches()
    jk = shd.decode_pass_a(k)
    [kp] = PF.sharded_decode_pass_b([jk], mesh)
    PF.install(jk, kp)
    assert lpf_replay.LAUNCHES["lf_replay"] == 2
    _assert_frames_equal(serial[0], kp, "kf")
    j1, j2 = shd.decode_pass_a(f1), shd.decode_pass_a(f2)
    outs = PF.sharded_decode_pass_b([j1, j2], make_mesh(4, 2))
    assert lpf_replay.LAUNCHES["lf_replay"] == 6
    _assert_frames_equal(serial[1], outs[0], "f1")
    _assert_frames_equal(serial[2], outs[1], "f2")
