"""The record-replay loop filter of the port (ops/lpf_replay.py, the
recorders of parallel/fullframe.py, passa_native.lpf_record_native)
against the JAX package's ops/lpf_tpu.py and parallel/fullframe.py, with
tolerance 0, on mini_encoder keyframes (4:2:0 at 8 bits, 4:4:4, 10 bits;
2 tile columns): the native and Python recorders against JAX's
record_lf, pack_schedule and pack_schedule_tiles, lf_scan_plain against
_lf_scan, apply_step_plain against _lf_apply_step,
lf_scan_sharded_plain against _lf_scan_sharded under shard_map on the
virtual CPU devices, and the sharded replay against the serial one. The kernel's wrappers route CUDA tensors to one launch
a call (recorded here; the `cuda` tests run it on the card)."""
import os
import sys
from functools import lru_cache

import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from ffmpeg_hybrid_tpu_torch.ops import _cuda, lpf_replay as LR
from ffmpeg_hybrid_tpu_torch.parallel import fullframe as PF

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")

# (name, mini_encoder keyframe arguments): 512 x 128, 2 tile columns
FRAMES = {
    "420": dict(bpp=8, seed=7, filter_level=24),
    "444": dict(bpp=8, seed=8, filter_level=36, ss_h=0, ss_v=0),
    "420_10": dict(bpp=10, seed=9, filter_level=30, yac_qi=80),
}


def _mini():
    sys.path.insert(0, TOOLS)
    try:
        import mini_encoder
    finally:
        sys.path.pop(0)
    return mini_encoder


@lru_cache(maxsize=None)
def _packet(name):
    return _mini().encode_keyframe_random(512, 128, tile_cols_log2=1,
                                          **FRAMES[name])


def _jobs(name, native=True):
    """The pass-A jobs of the frame from the port's decoder and the JAX
    package's."""
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder as JD
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    pkt = _packet(name)
    port = VP9Decoder(device="cpu", use_native=native).decode_pass_a(pkt)
    jax_job = JD(recon_backend="golden",
                 use_native=native).decode_pass_a(pkt)
    return port, jax_job


@lru_cache(maxsize=None)
def _records(name):
    from ffmpeg_hybrid_tpu.parallel import fullframe as JF
    port, jax_job = _jobs(name)
    return PF.record_lf(port), JF.record_lf_python(jax_job), port


def _planes(rng, B, H, W, bpp):
    """Smooth random planes, so that the wide filters fire."""
    base = rng.randint(0, 1 << bpp, (B, 1, 1))
    walk = np.cumsum(rng.randint(-2, 3, (B, H, W)), axis=2) // 3
    return np.clip(base + walk, 0, (1 << bpp) - 1).astype(np.int32)


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_recorders_match_jax(name):
    """Both recorders give JAX's record stream: the native one
    (lpf_record_native, through record_lf) and the Python walker
    (record_lf_python) of the same frame."""
    from ffmpeg_hybrid_tpu.parallel import fullframe as JF
    got_native, want, port = _records(name)
    got_py = PF.record_lf_python(port)
    yw, nyw, uvw, nuvw = want
    assert nyw > 200 and nuvw > 50
    for got in (got_native, got_py):
        y, ny, uv, nuv = got
        assert (ny, nuv) == (nyw, nuvw)
        assert np.array_equal(y[:ny], yw[:nyw])
        assert np.array_equal(uv[:nuv], uvw[:nuvw])
    if name != "420":
        return
    port_py, jax_py = _jobs(name, native=False)
    y, ny, uv, nuv = PF.record_lf(port_py)    # a Python pass A: the walker
    assert np.array_equal(y[:ny], yw[:nyw]) and np.array_equal(uv[:nuv],
                                                               uvw[:nuvw])
    jn = JF.record_lf(jax_py)
    assert np.array_equal(jn[0][:jn[1]], yw[:nyw])


def test_native_recorder_failure_raises(monkeypatch):
    """record_lf does not fall back: a failing native recorder raises."""
    from ffmpeg_hybrid_tpu_torch import passa_native

    def broken(_s):
        raise OSError("no library")

    monkeypatch.setattr(passa_native, "lpf_record_native", broken)
    port, _ = _jobs("420")
    with pytest.raises(OSError):
        PF.record_lf(port)


@pytest.mark.parametrize("name", sorted(FRAMES))
@pytest.mark.parametrize("bucket", [True, False])
def test_pack_schedule_matches_jax(name, bucket):
    from ffmpeg_hybrid_tpu.ops import lpf_tpu
    from ffmpeg_hybrid_tpu.parallel import fullframe as JF
    (y, ny, uv, nuv), _want, port = _records(name)
    for recs, n in ((y, ny), (uv, nuv)):
        assert np.array_equal(LR.pack_schedule(recs, n, port.sb_cols, bucket),
                              lpf_tpu.pack_schedule(recs, n, port.sb_cols,
                                                    bucket))
    bounds = PF._tile_bounds(port)
    assert bounds == JF._tile_bounds(port) == [0, 4, 8]
    for recs, n, x0 in ((y, ny, [0, 256]), (uv, nuv,
                                            [0, 256 >> port.ss_h])):
        got = PF.pack_schedule_tiles(recs, n, port.sb_cols, bounds, x0)
        assert np.array_equal(got, JF.pack_schedule_tiles(
            recs, n, port.sb_cols, bounds, x0))
    assert LR.pack_schedule(y, 0, 8).shape == (0, 1, 7)
    assert PF.pack_schedule_tiles(y, 0, 8, bounds, [0, 256]).shape == (
        2, 64, 1, 7)


def _serial_case(name, seed):
    """The frame's records packed serially, with seeded planes: (Y
    planes [1, H, W], Y steps, U+V planes [2, ...], U+V steps, bpp)."""
    (y, ny, uv, nuv), _w, port = _records(name)
    bpp = FRAMES[name]["bpp"]
    rng = np.random.RandomState(seed)
    H, W = port.sb_rows * 64, port.sb_cols * 64
    Hu, Wu = H >> port.ss_v, W >> port.ss_h
    return (_planes(rng, 1, H, W, bpp), LR.pack_schedule(y, ny, port.sb_cols),
            _planes(rng, 2, Hu, Wu, bpp),
            LR.pack_schedule(uv, nuv, port.sb_cols), bpp)


@pytest.mark.parametrize("name", ["420", "420_10"])
def test_lf_scan_plain_matches_jax(name):
    """lf_scan_plain (and lf_scan, its wrapper, on CPU tensors) against
    lpf_tpu._lf_scan on the frame's recorded steps, Y and U+V."""
    from ffmpeg_hybrid_tpu.ops import lpf_tpu
    ypl, ysteps, uvpl, uvsteps, bpp = _serial_case(name, 3)
    for planes, steps in ((ypl, ysteps), (uvpl, uvsteps)):
        want = np.asarray(lpf_tpu._lf_scan(jnp.asarray(planes),
                                           jnp.asarray(steps), bpp))
        assert not np.array_equal(want, planes)
        got = LR.lf_scan(torch.from_numpy(planes), steps, bpp)
        assert np.array_equal(got.numpy(), want)


def _stripes(planes, x0, wreal, wpad):
    """Stripe buffers [T, B, H, HALO + wpad] of planes [B, H, W]."""
    B, H, _W = planes.shape
    buf = np.zeros((len(x0), B, H, LR.HALO + wpad), np.int32)
    for t, (a, w) in enumerate(zip(x0, wreal)):
        buf[t, :, :, LR.HALO:LR.HALO + w] = planes[:, :, a:a + w]
    return buf


def _jax_sharded(buf, steps, wreal, bpp):
    """The JAX package's _lf_scan_sharded under shard_map over a
    ("tile",) mesh of len(buf) virtual CPU devices."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from ffmpeg_hybrid_tpu.parallel import fullframe as JF
    ntile = len(buf)
    mesh = Mesh(np.array(jax.devices()[:ntile]), ("tile",))

    def body(pl, st, wr):
        return JF._lf_scan_sharded(pl[0], st[0], wr[0], ntile, bpp)[None]

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("tile"),) * 3,
                          out_specs=P("tile"), check_rep=False))
    return np.asarray(f(jnp.asarray(buf), jnp.asarray(steps),
                        jnp.asarray(np.asarray(wreal, np.int32))))


def test_lf_scan_sharded_matches_jax_and_serial():
    """lf_scan_sharded_plain (through lf_scan_sharded) on the frame's two
    tile stripes, Y and U+V: equal to the JAX package's _lf_scan_sharded,
    and its stripes joined equal to the serial replay of the frame."""
    name = "420"
    (y, ny, uv, nuv), _w, port = _records(name)
    ypl, ysteps, uvpl, uvsteps, bpp = _serial_case(name, 5)
    bounds = PF._tile_bounds(port)
    for planes, steps, recs, n, sh in ((ypl, ysteps, y, ny, 0),
                                       (uvpl, uvsteps, uv, nuv, port.ss_h)):
        x0 = [b * (64 >> sh) for b in bounds[:-1]]
        wreal = [(b1 - b0) * (64 >> sh) for b0, b1 in zip(bounds, bounds[1:])]
        tsteps = PF.pack_schedule_tiles(recs, n, port.sb_cols, bounds, x0)
        buf = _stripes(planes, x0, wreal, max(wreal))
        got = LR.lf_scan_sharded(torch.from_numpy(buf), tsteps, wreal,
                                 bpp).numpy()
        assert np.array_equal(got, _jax_sharded(buf, tsteps, wreal, bpp))
        joined = np.concatenate([got[t, :, :, LR.HALO:LR.HALO + w]
                                 for t, w in enumerate(wreal)], axis=2)
        serial = LR.lf_scan_plain(torch.from_numpy(planes), steps, bpp)
        assert np.array_equal(joined, serial.numpy())
        # the halo of stripe 1 ends as a copy of stripe 0's tail
        assert np.array_equal(got[1, :, :, :LR.HALO],
                              got[0, :, :, wreal[0]:wreal[0] + LR.HALO])


def test_apply_step_writes_the_filtered_range_only():
    """One record of each direction and width: the samples outside its
    write range (and every sample of a wd 0 record) keep their values,
    and the records whose windows lie inside the plane give the JAX
    package's _lf_apply_step (which wraps a negative row index, as no
    recorded edge has one)."""
    rng = np.random.RandomState(1)
    pl = torch.from_numpy(_planes(rng, 1, 48, 64, 8))
    recs = torch.tensor([[16, 24, 0, 16, 60, 30, 2], [16, 40, 1, 8, 60, 30, 2],
                         [0, 8, 1, 4, 255, 63, 3], [32, 8, 0, 0, 60, 30, 2]],
                        dtype=torch.int32)
    got = LR.apply_step_plain(pl.clone()[None], recs[None], 8)[0]
    from ffmpeg_hybrid_tpu.parallel import fullframe as JF
    inside = recs[[0, 1, 3]]
    want = JF._lf_apply_step(jnp.asarray(pl.numpy()),
                             jnp.asarray(inside.numpy()), 8)
    assert np.array_equal(
        LR.apply_step_plain(pl.clone()[None], inside[None], 8)[0].numpy(),
        np.asarray(want))
    changed = (got != pl)[0]
    assert changed.any()
    allowed = torch.zeros_like(changed)
    allowed[16:24, 24 - 7:24 + 7] = True     # V, wd 16: columns 1..14
    allowed[16 - 3:16 + 3, 40:48] = True     # H, wd 8: rows 5..10
    allowed[0:2, 8:16] = True                # H at the top, wd 4: rows 6..9
    assert not (changed & ~allowed).any()


def test_steps_run_trims_the_bucket():
    steps = np.zeros((2, 64, 3, 7), np.int32)
    assert LR.steps_run(steps) == 0
    steps[1, 40, 2, 3] = 4
    steps[0, 7, 0, 3] = 8
    assert LR.steps_run(steps) == 41
    assert LR._live_steps(steps) == [7, 40]


def _recorded_launch(monkeypatch):
    calls = []

    def recorded(source, signatures, name, *args):
        calls.append((source, name, args))

    monkeypatch.setattr(_cuda, "launch", recorded)
    return calls


def test_cuda_tensors_go_to_one_launch(monkeypatch):
    """On tensors off the CPU each wrapper makes one launch of
    csrc/lpf_replay.cu (recorded here), counted in LAUNCHES, with the
    bucket's trailing no-op steps left out of its run; the plain versions
    never run. Wrong shapes, dtypes and stripe counts raise."""
    calls = _recorded_launch(monkeypatch)
    monkeypatch.setattr(LR, "lf_scan_sharded_plain", None)
    monkeypatch.setattr(LR, "lf_scan_plain", None)
    meta = dict(dtype=torch.int32, device="meta")
    steps = np.zeros((2, 64, 2, 7), np.int32)
    steps[0, 9, 1, 3] = 4
    LR.reset_launches()
    buf = torch.zeros((2, 2, 64, 8 + 256), **meta)
    assert LR.lf_scan_sharded(buf, steps, [256, 192], 10) is buf
    out = LR.lf_scan(torch.zeros((1, 64, 512), **meta), steps[0], 8)
    assert out.shape == (1, 64, 512)
    assert LR.LAUNCHES["lf_replay"] == 2
    (src, name, a), (_s, _n, b) = calls
    assert (src, name) == ("lpf_replay.cu", "lf_replay")
    assert a[3:] == (2, 2, 64, 264, 10, 2, 10, 1, 10)
    assert b[3:] == (1, 1, 64, 512, 10, 2, 10, 0, 8)
    assert tuple(a[1].shape) == (2, 10, 2, 7)
    with pytest.raises(ValueError):
        LR.lf_scan_sharded(torch.zeros((9, 1, 64, 72), **meta),
                           np.zeros((9, 64, 1, 7), np.int32), [64] * 9, 8)
    with pytest.raises(ValueError):
        LR.lf_scan_sharded(buf, steps, [256, 260], 8)
    with pytest.raises(TypeError):
        LR.lf_scan_sharded(buf.to(torch.int16), steps, [256, 192], 8)
    with pytest.raises(ValueError):
        LR.lf_scan(torch.zeros((3, 64, 512), **meta), steps[0], 8)
    assert len(calls) == 2


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The kernel on the card against the plain versions on the frames'
    recorded steps: serial (one stripe) and sharded (two stripes), Y and
    U+V, at 8 and 10 bits, five launches each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for name in ("420", "420_10"):
        (y, ny, uv, nuv), _w, port = _records(name)
        ypl, ysteps, uvpl, uvsteps, bpp = _serial_case(name, 7)
        bounds = PF._tile_bounds(port)
        for planes, steps, recs, n, sh in ((ypl, ysteps, y, ny, 0),
                                           (uvpl, uvsteps, uv, nuv, 1)):
            want = LR.lf_scan_plain(torch.from_numpy(planes), steps, bpp)
            for _ in range(5):
                got = LR.lf_scan(torch.from_numpy(planes).cuda(), steps, bpp)
                assert torch.equal(got.cpu(), want)
            x0 = [b * (64 >> sh) for b in bounds[:-1]]
            wreal = [(b1 - b0) * (64 >> sh)
                     for b0, b1 in zip(bounds, bounds[1:])]
            tsteps = PF.pack_schedule_tiles(recs, n, port.sb_cols, bounds, x0)
            buf = torch.from_numpy(_stripes(planes, x0, wreal, max(wreal)))
            want = LR.lf_scan_sharded_plain(buf, tsteps, wreal, bpp)
            for _ in range(5):
                got = LR.lf_scan_sharded(buf.cuda(), tsteps, wreal, bpp)
                assert torch.equal(got.cpu(), want)
