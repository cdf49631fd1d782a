"""The record-replay loop filter of the port (ops/lpf_replay.py, the
recorders of parallel/fullframe.py, passa_native.lpf_record_native)
against the JAX package's ops/lpf_tpu.py and parallel/fullframe.py, with
tolerance 0, on mini_encoder keyframes (4:2:0 at 8 bits, 4:4:4, 10 bits;
2 tile columns): the native and Python recorders against JAX's
record_lf, pack_schedule and pack_schedule_tiles, lf_scan_plain against
_lf_scan, apply_step_plain against _lf_apply_step,
lf_scan_sharded_plain against _lf_scan_sharded under shard_map on the
virtual CPU devices, and the sharded replay against the serial one. The
kernel's tickets (build_tickets): every record in one ticket in order,
the waits ordering every pair of overlapping windows, and a host
emulation of the kernel's dataflow in seeded random orders against the
plain versions and the JAX scans, whole runs and a rank's segments. The
kernel's wrappers route CUDA tensors to one launch a call (recorded
here; the `cuda` tests run it on the card)."""
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
    for planes, steps, sb in ((ypl, ysteps, (64, 64)),
                              (uvpl, uvsteps, (32, 32))):
        want = np.asarray(lpf_tpu._lf_scan(jnp.asarray(planes),
                                           jnp.asarray(steps), bpp))
        assert not np.array_equal(want, planes)
        got = LR.lf_scan(torch.from_numpy(planes), steps, bpp, sb)
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
                                 bpp, (64 >> sh, 64 >> sh)).numpy()
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
    csrc/lpf_replay.cu (recorded here), counted in LAUNCHES, on the
    tickets of the steps' live records (the bucket's trailing no-op
    steps make none); the plain versions never run. Wrong shapes, dtypes,
    stripe counts and superblock sizes raise, and so do buffers whose
    width, real widths or start the kernel's int4 cannot take."""
    calls = _recorded_launch(monkeypatch)
    monkeypatch.setattr(LR, "lf_scan_sharded_plain", None)
    monkeypatch.setattr(LR, "lf_scan_plain", None)
    meta = dict(dtype=torch.int32, device="meta")
    steps = np.zeros((2, 64, 2, 7), np.int32)
    steps[0, 9, 1] = (8, 72, 0, 4, 60, 30, 2)
    LR.reset_launches()
    buf = torch.zeros((2, 2, 128, 8 + 256), **meta)
    assert LR.lf_scan_sharded(buf, steps, [256, 192], 10, (32, 32)) is buf
    out = LR.lf_scan(torch.zeros((1, 128, 512), **meta), steps[0, :, :, :],
                     8, (64, 64))
    assert out.shape == (1, 128, 512)
    assert LR.LAUNCHES["lf_replay"] == 2
    (src, name, a), (_s, _n, b) = calls
    assert (src, name) == ("lpf_replay.cu", "lf_replay")
    # T, B, H, Wb, tickets, most records, most levels, sbw, sbh, halo,
    # bpp
    assert a[5:16] == (2, 2, 128, 264, 1, 1, 1, 32, 32, 1, 10)
    assert b[5:16] == (1, 1, 128, 512, 1, 1, 1, 64, 64, 0, 8)
    # the ticket (stripe 0, lane 1: row 1, px 72 - HALO = 64: column 2 of
    # 32) waits for none; its load box the record's footprint, its write
    # box columns 70-73, both widened to int4 columns
    tk = LR.Replay(steps, buf.shape, (32, 32), [256, 192], LR.HALO,
                   True).parts["tickets"]
    assert len(tk) == 1 and tk[0, 4:8].tolist() == [-1] * 4
    assert tk[0, 8:16].tolist() == [8, 64, 8, 16, 8, 68, 8, 8]
    assert tuple(a[3].shape) == (4,)
    with pytest.raises(ValueError):
        LR.lf_scan_sharded(torch.zeros((9, 1, 64, 72), **meta),
                           np.zeros((9, 64, 1, 7), np.int32), [64] * 9, 8,
                           (64, 64))
    with pytest.raises(ValueError):
        LR.lf_scan_sharded(buf, steps, [256, 260], 8, (32, 32))
    with pytest.raises(TypeError):
        LR.lf_scan_sharded(buf.to(torch.int16), steps, [256, 192], 8,
                           (32, 32))
    with pytest.raises(ValueError):
        LR.lf_scan(torch.zeros((3, 64, 512), **meta), steps[0], 8, (64, 64))
    with pytest.raises(ValueError):
        LR.lf_scan_sharded(buf, steps, [256, 192], 8, (16, 32))
    # int4 only: a buffer width or a real width off 4 columns, a buffer
    # off 16 bytes
    with pytest.raises(ValueError, match="multiples of 4"):
        LR.lf_scan_sharded(torch.zeros((2, 2, 128, 8 + 254), **meta), steps,
                           [252, 192], 8, (32, 32))
    with pytest.raises(ValueError, match="multiples of 4"):
        LR.lf_scan_sharded(buf, steps, [254, 192], 8, (32, 32))
    off = torch.zeros(buf.numel() + 1, **meta)[1:].view(buf.shape)
    with pytest.raises(ValueError, match="16 bytes"):
        LR.lf_scan_sharded(off, steps, [256, 192], 8, (32, 32))
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# the kernel's tickets (build_tickets) and a host emulation of its dataflow

def _sharded_case(name, seed, which):
    """The frame's stripes of one set with their steps: (buffers [T, B, H,
    HALO + Wpad], steps [T, S, D, 7], wreal, sb, bpp)."""
    (y, ny, uv, nuv), _w, port = _records(name)
    ypl, _ys, uvpl, _uvs, bpp = _serial_case(name, seed)
    bounds = PF._tile_bounds(port)
    luma = which == "Y"
    planes, recs, n = (ypl, y, ny) if luma else (uvpl, uv, nuv)
    sh = 0 if luma else port.ss_h
    sb = (64, 64) if luma else (64 >> port.ss_h, 64 >> port.ss_v)
    x0 = [b * (64 >> sh) for b in bounds[:-1]]
    wreal = [(b1 - b0) * (64 >> sh) for b0, b1 in zip(bounds, bounds[1:])]
    tsteps = PF.pack_schedule_tiles(recs, n, port.sb_cols, bounds, x0)
    return _stripes(planes, x0, wreal, max(wreal)), tsteps, wreal, sb, bpp


def _global_cols(rp, tk):
    """A ticket's load box's columns in the frame's columns."""
    x0 = np.concatenate([[0], np.cumsum(rp.wreal)[:-1]])
    off = LR.HALO if rp.halo or rp.shape[-1] != rp.wreal[0] else 0
    c0 = tk[9] - off + x0[tk[0]]
    return c0, c0 + tk[11] - 1


def _check_tickets(rp):
    """build_tickets' invariants on a Replay: every live record of the
    spans in exactly one ticket, in recorded order (two records of a
    ticket whose footprints share a sample run at levels in their order,
    each level's records on disjoint samples); every wait names an
    earlier ticket of its launch; two tickets of a launch whose windows
    overlap (in the frame's columns) are ordered by the waits."""
    p = rp.parts
    tks, lv, recs, src = p["tickets"], p["levels"], p["records"], p["source"]
    st = rp.steps
    live = {tuple(v) for v in np.argwhere(st[..., 3] > 0)
            if any(a <= v[1] < b for a, b in rp.spans)}
    src = np.stack(np.unravel_index(src, st.shape[:3]), 1)
    got = [tuple(v) for v in src]
    assert len(got) == len(set(got)) and set(got) == live
    level = np.zeros(len(recs), np.int64)
    for k in range(len(lv) - 1):
        level[lv[k]:lv[k + 1]] = k
    for lo, hi, _first, most_recs, most_lv in p["launches"]:
        reach = []
        for k in range(lo, hi):
            tk = tks[k]
            r0, n = tk[16], tk[17]
            assert n <= most_recs and tk[2] <= most_lv
            assert lv[tk[1]] == r0 and lv[tk[1] + tk[2]] == r0 + n
            steps_of = src[r0:r0 + n, 1]
            # the footprint of each record, as a set of samples
            foot = []
            for py, px, dw, _p in recs[r0:r0 + n]:
                d = dw & 3
                rows = range(py, py + 8) if d == 0 else range(py - 8, py + 8)
                cols = range(px - 8, px + 8) if d == 0 else range(px, px + 8)
                foot.append({(y, x) for y in rows for x in cols})
            for i in range(n):
                for j in range(n):
                    if steps_of[i] < steps_of[j] and foot[i] & foot[j]:
                        assert level[r0 + i] < level[r0 + j]
            deps = [d for d in tk[4:8] if d >= 0]
            assert all(d < k - lo for d in deps)
            mine = set(deps)
            for d in deps:
                mine |= reach[d]
            reach.append(mine)
        for i in range(lo, hi):
            for j in range(i + 1, hi):
                a, b = tks[i], tks[j]
                ca, cb = _global_cols(rp, a), _global_cols(rp, b)
                rows = (a[8] <= b[8] + b[10] - 1 and b[8] <= a[8] + a[10] - 1)
                if rows and ca[0] <= cb[1] and cb[0] <= ca[1]:
                    assert i - lo in reach[j - lo], (i, j)


def _emulate(pl, rp, k, bpp, seed):
    """Launch k of the Replay rp on the buffers pl [T, B, H, Wb] (in
    place), as the kernel's dataflow may run it: in a seeded random
    order that keeps only the declared waits (the halo copy of a launch
    from step 0 as late as they let it run). A ticket copies the part of
    its load box that its waits do not guard (rows from rt, columns from
    cl) at any time, even before its waits have published; once they
    have (and, next to a stripe boundary, the copy) the rest; any ticket
    holding its window may then run its levels on it (each level's
    records as one step of apply_step_plain), write back its write box
    with the mirrors of tail and halo columns, and publish, while others
    copy in between."""
    rng = np.random.RandomState(seed)
    p = rp.parts
    lo, hi, first, _mr, _ml = p["launches"][k]
    T = pl.shape[0]
    copy = rp.halo and first == 0
    tks = p["tickets"]
    pend, early, held, done = list(range(lo, hi)), {}, {}, set()
    copy_done = not copy
    wreal = rp.wreal

    def ready(t):
        return all(d < 0 or d + lo in done for d in tks[t][4:8]) and (
            copy_done or not tks[t][3] & 1)

    while pend or early or held:
        moves = ([("early", t) for t in pend]
                 + [("late", t) for t in sorted(early) if ready(t)]
                 + [("run", t) for t in sorted(held)])
        if not moves:
            for s in range(1, T):   # the copy, as late as the waits let it
                w = wreal[s - 1]
                pl[s, :, :, :LR.HALO] = pl[s - 1, :, :, w:w + LR.HALO]
            copy_done = True
            continue
        move, t = moves[rng.randint(len(moves))]
        s, r0, c0, nr, nc = (int(v) for v in tks[t][[0, 8, 9, 10, 11]])
        rt, cl = int(tks[t][18]) - r0, int(tks[t][19]) - c0
        if move == "early":
            pend.remove(t)
            early[t] = pl[s, :, r0 + rt:r0 + nr, c0 + cl:c0 + nc].clone()
            continue
        if move == "late":
            win = pl[s, :, r0:r0 + nr, c0:c0 + nc].clone()
            win[:, rt:, cl:] = early.pop(t)
            held[t] = win
            continue
        win = held.pop(t)
        tk = tks[t]
        for lv in range(tk[1], tk[1] + tk[2]):
            r = p["records"][p["levels"][lv]:p["levels"][lv + 1]].astype(
                np.int64)
            rec = np.stack([r[:, 0] - r0, r[:, 1] - c0, r[:, 2] & 3,
                            r[:, 2] >> 2, r[:, 3] & 255, r[:, 3] >> 8 & 255,
                            r[:, 3] >> 16], 1).astype(np.int32)
            LR.apply_step_plain(win[None], torch.from_numpy(rec)[None], bpp)
        wr0, wc0, wnr, wnc = (int(v) for v in tk[12:16])
        if wnr and wnc:
            part = win[:, wr0 - r0:wr0 - r0 + wnr, wc0 - c0:wc0 - c0 + wnc]
            pl[s, :, wr0:wr0 + wnr, wc0:wc0 + wnc] = part
            for x in range(wc0, wc0 + wnc):
                v = part[:, :, x - wc0]
                tail = wreal[s] <= x < wreal[s] + LR.HALO
                if rp.halo and s < T - 1 and tail:
                    pl[s + 1, :, wr0:wr0 + wnr, x - wreal[s]] = v
                if rp.halo and s > 0 and x < LR.HALO:
                    pl[s - 1, :, wr0:wr0 + wnr, wreal[s - 1] + x] = v
        done.add(t)
    if not copy_done:
        for s in range(1, T):
            w = wreal[s - 1]
            pl[s, :, :, :LR.HALO] = pl[s - 1, :, :, w:w + LR.HALO]
    return pl


@pytest.mark.parametrize("name", sorted(FRAMES))
@pytest.mark.parametrize("which", ["Y", "U+V"])
def test_tickets_hold_every_record_in_order(name, which):
    """build_tickets on the frame's serial steps (one stripe, lf_scan's
    buffers) and on its two tile stripes (lf_scan_sharded's): every live
    record in exactly one ticket, in recorded order, every wait on an
    earlier ticket, and every pair of tickets whose windows overlap
    ordered by the waits; the superblocks next to the stripe boundary
    wait for the halo copy."""
    buf, tsteps, wreal, sb, bpp = _sharded_case(name, 3, which)
    ypl, ysteps, uvpl, uvsteps, _bpp = _serial_case(name, 3)
    planes, steps = (ypl, ysteps) if which == "Y" else (uvpl, uvsteps)
    serial = LR.Replay(steps[None], (1,) + planes.shape, sb)
    sharded = LR.Replay(tsteps, buf.shape, sb, wreal, LR.HALO, True)
    for rp in (serial, sharded):
        assert rp.ntickets
        _check_tickets(rp)
    tk = sharded.parts["tickets"]
    cols = set(int(c) for c in (tk[:, 9] + 8 - LR.HALO + np.asarray(
        [0, wreal[0]])[tk[:, 0]]) // sb[0])
    c0 = wreal[0] // sb[0]
    near = ((tk[:, 9] - LR.HALO + 8 + np.asarray([0, wreal[0]])[tk[:, 0]])
            // sb[0])
    assert ((tk[:, 3] & 1) == np.isin(near, [c0 - 1, c0])).all() and cols


@pytest.mark.parametrize("name", sorted(FRAMES))
@pytest.mark.parametrize("which", ["Y", "U+V"])
def test_tickets_refuse_a_wrong_superblock(name, which):
    """build_tickets holds the superblock size to the records: the
    frame's serial steps and its two tile stripes with the other size
    the kernel takes, in width and height at once, raise ValueError."""
    buf, tsteps, wreal, sb, _bpp = _sharded_case(name, 3, which)
    ypl, ysteps, uvpl, uvsteps, _b = _serial_case(name, 3)
    planes, steps = (ypl, ysteps) if which == "Y" else (uvpl, uvsteps)
    wrong = tuple(96 - v for v in sb)
    with pytest.raises(ValueError, match="superblocks"):
        LR.Replay(steps[None], (1,) + planes.shape, wrong)
    with pytest.raises(ValueError, match="superblocks"):
        LR.Replay(tsteps, buf.shape, wrong, wreal, LR.HALO, True)


@pytest.mark.parametrize("name", sorted(FRAMES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_emulated_dataflow_matches_plain_and_jax(name, seed):
    """The tickets' dataflow emulated in seeded random orders that keep
    only the declared waits (tolerance 0): on the serial steps equal to
    lf_scan_plain and the JAX package's _lf_scan, on the two stripes
    equal to lf_scan_sharded_plain and the JAX _lf_scan_sharded, Y and
    U+V; the same tickets with every record a no-op leave the planes as
    they were (a copied halo aside)."""
    from ffmpeg_hybrid_tpu.ops import lpf_tpu
    ypl, ysteps, uvpl, uvsteps, bpp = _serial_case(name, 11)
    for which, planes, steps in (("Y", ypl, ysteps), ("U+V", uvpl, uvsteps)):
        buf, tsteps, wreal, sb, _bpp = _sharded_case(name, 11, which)
        rp = LR.Replay(steps[None], (1,) + planes.shape, sb)
        got = _emulate(torch.from_numpy(planes).clone()[None], rp, 0, bpp,
                       seed)[0]
        want = LR.lf_scan_plain(torch.from_numpy(planes), steps, bpp)
        assert torch.equal(got, want)
        if seed == 0:
            jw = np.asarray(lpf_tpu._lf_scan(jnp.asarray(planes),
                                             jnp.asarray(steps), bpp))
            assert np.array_equal(got.numpy(), jw)
        rs = LR.Replay(tsteps, buf.shape, sb, wreal, LR.HALO, True)
        got = _emulate(torch.from_numpy(buf).clone(), rs, 0, bpp, seed)
        want = LR.lf_scan_sharded_plain(torch.from_numpy(buf), tsteps,
                                        wreal, bpp)
        assert torch.equal(got, want)
        if seed == 0:
            assert np.array_equal(got.numpy(),
                                  _jax_sharded(buf, tsteps, wreal, bpp))
        idle = LR.Replay(tsteps, buf.shape, sb, wreal, LR.HALO, True)
        idle.parts["records"][:, 2] &= 3
        got = _emulate(torch.from_numpy(buf).clone(), idle, 0, bpp, seed)
        copied = buf.copy()
        copied[1, :, :, :LR.HALO] = buf[0, :, :, wreal[0]:wreal[0] + LR.HALO]
        assert np.array_equal(got.numpy(), copied)


def _four_stripes():
    """Seeded stripe buffers of a 1024 x 128 keyframe of four tile
    columns, Y and U+V: [(buffers, steps, wreal, sb)] and its bpp (the
    frame of tests/test_torch_mesh_dist.py)."""
    import test_torch_mesh_dist as MD
    _job, (_t, cfg) = MD._frame()
    out = []
    for which, seed in (("ysteps", 2), ("uvsteps", 3)):
        buf, steps, wreal = MD._buffers(seed, which)
        sb = (64, 64) if which == "ysteps" else (64 >> cfg["ss_h"],
                                                 64 >> cfg["ss_v"])
        out.append((buf, steps, [int(w) for w in wreal], sb))
    return out, MD


@pytest.mark.parametrize("split", [(2, 2), (1, 3)])
def test_emulated_segments_match_plain_and_jax(split):
    """Each rank's segments of segment_plan over two ranks (threads
    swapping through queues), each segment's tickets run by the emulated
    dataflow in a seeded random order: every rank's stripes equal
    lf_scan_sharded_plain's and the JAX _lf_scan_sharded's over all four
    stripes (tolerance 0), Y and U+V; every segment's tickets keep
    _check_tickets' invariants, and a span of no step makes a launch of
    no ticket."""
    sets, MD = _four_stripes()
    ranks = list(np.repeat([0, 1], split))
    for buf, steps, wreal, sb in sets:
        want = LR.lf_scan_sharded_plain(buf, steps, wreal, 8)
        assert np.array_equal(want.numpy(), _jax_sharded(
            buf.numpy(), steps, wreal, 8))

        def rank_scan(ex):
            plan = LR.segment_plan(steps, wreal, ranks, ex.rank)
            lo, hi, _cuts, segs = plan
            pl = buf[lo:hi].clone()
            wl = wreal[lo:hi]
            local = np.asarray(steps)[lo:hi]
            if hi - lo > 1:
                pl[1:, :, :, :LR.HALO] = LR._cols(pl, wl)[:-1]
            rp = LR.Replay(local, pl.shape, sb, wl, LR.HALO, hi - lo > 1,
                           [(a, b) for a, b, _s in segs])
            _check_tickets(rp)
            at = iter(range(len(segs)))

            def replay(first, end):
                k = next(at)
                if rp.halo and first == 0:
                    # the copy was made above, as the plain version makes it
                    rp2 = LR.Replay(local, pl.shape, sb, wl, LR.HALO,
                                    True, [(first, end)])
                    _emulate(pl, rp2, 0, 8, 5 + k)
                else:
                    _emulate(pl, rp, k, 8, 5 + k)

            LR._scan_dist(pl, plan, wreal, ranks, ex, replay)
            return lo, hi, pl

        for lo, hi, got in MD._run_ranks(ranks, rank_scan).values():
            assert torch.equal(got, want[lo:hi]), (split, lo)
    empty = LR.Replay(sets[0][1], sets[0][0].shape, sets[0][3], sets[0][2],
                      LR.HALO, True, [(3, 3)])
    assert empty.ntickets == 0 and empty.launches == [(0, 0, 3, 0, 0)]


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
                got = LR.lf_scan(torch.from_numpy(planes).cuda(), steps, bpp,
                                 (64 >> sh, 64 >> sh))
                assert torch.equal(got.cpu(), want)
            x0 = [b * (64 >> sh) for b in bounds[:-1]]
            wreal = [(b1 - b0) * (64 >> sh)
                     for b0, b1 in zip(bounds, bounds[1:])]
            tsteps = PF.pack_schedule_tiles(recs, n, port.sb_cols, bounds, x0)
            buf = torch.from_numpy(_stripes(planes, x0, wreal, max(wreal)))
            want = LR.lf_scan_sharded_plain(buf, tsteps, wreal, bpp)
            for _ in range(5):
                got = LR.lf_scan_sharded(buf.cuda(), tsteps, wreal, bpp,
                                         (64 >> sh, 64 >> sh))
                assert torch.equal(got.cpu(), want)
