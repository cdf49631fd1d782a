"""The frozen byte counts of vp9bench/passb_bytes.py give the same bytes
as chip_smoke.py's functions for the same kernel inputs, captured from
the port's CPU decode of small clips."""
import os

import numpy as np
import pytest
import torch

from conftest import ROOT
from vp9bench import ivf, passb_bytes as PB


def chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_test", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def captured(clip):
    """{wrapper name: [args]} of every pass-B wrapper call while the
    port decodes `clip` on the CPU, each call's arguments cloned before
    the call and its result kept."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu_torch.ops import lpf_dense, lpf_masks, recon
    targets = [(recon, "_grids_from_records"), (recon, "scatter_frame"),
               (recon, "residual_planes"), (recon, "mc_planes"),
               (recon, "_intra_scan_planes"), (lpf_masks, "grids_device"),
               (lpf_dense, "lf_frame_")]
    calls = {n: [] for _m, n in targets}
    reals = {n: getattr(m, n) for m, n in targets}

    def copy(a):
        if torch.is_tensor(a):
            return a.clone()
        if isinstance(a, (list, tuple)):
            return type(a)(copy(x) for x in a)
        return a

    def wrap(name):
        def f(*args, **kwargs):
            entry = [copy(a) for a in args]
            out = reals[name](*args, **kwargs)
            calls[name].append((entry, copy(out)))
            return out
        return f
    for m, n in targets:
        setattr(m, n, wrap(n))
    try:
        dec = VP9Decoder(device="cpu", pass_a_impl="device")
        _s, packets = ivf.read_clip(os.path.join(ROOT, clip + ".ivf"))
        for p in packets:
            dec.decode(p.data)
    finally:
        for m, n in targets:
            setattr(m, n, reals[n])
    return calls


@pytest.fixture(scope="module")
def calls():
    out = {}
    for clip in ("vectors/passa_inter_modes", "vectors/passa_inter_tiles"):
        for k, v in captured(clip).items():
            out.setdefault(k, []).extend(v)
    return out


def test_every_pass_b_kernel_ran(calls):
    assert all(calls[k] for k in calls)


def test_residual_and_clear(calls):
    cs = chip_smoke()
    for (jobs, lossless, _bpp), _out in calls["residual_planes"]:
        want = sum(cs.residual_work(np, *job, lossless)[0]
                   + cs.clear_bytes(np, *job, lossless) for job in jobs)
        assert PB.residual_bytes(jobs, lossless) == want


def test_scatter(calls):
    cs = chip_smoke()
    for (bufs, cp, ep), _out in calls["scatter_frame"]:
        nc, ne = bufs.flat_c.numel(), bufs.flat_e.numel()
        wide = cp.shape[1] == 4
        # residual_phase's count of one scatter call
        want = (cp.numel() + ep.numel()) * 2 \
            + cs.rows_in(np, cp, nc) * (4 if wide else 2) \
            + cs.rows_in(np, ep, ne) * 2
        assert PB.scatter_bytes(cp, ep, nc, ne) == want


def test_mc(calls):
    cs = chip_smoke()
    for (jobs, _bpp, has_comp), _out in calls["mc_planes"]:
        want = sum(cs.mc_work(np, job, has_comp)[0] for job in jobs)
        assert PB.mc_bytes(jobs, has_comp) == want


def test_intra(calls):
    cs = chip_smoke()
    for (jobs, _bpp), _out in calls["_intra_scan_planes"]:
        assert PB.intra_bytes(jobs) == cs.intra_work(np, jobs)[0]


def test_splat_grids_and_loop_filter(calls):
    for (recs, *_a), out in calls["_grids_from_records"]:
        # splat_phase's count
        assert PB.splat_bytes(recs, out) == recs.numel() * 2 + sum(
            o.numel() * o.element_size() for o in out)
    for (lfl, lfm, luts, *_a), grids in calls["grids_device"]:
        quads = sum(g.numel() // 4 for g in grids)
        assert PB.lf_grids_bytes(lfl, lfm, luts, grids) == \
            lfl.numel() * 2 + (lfm.numel() + luts.numel()) * 4 + quads * 16
    for args, _out in calls["lf_frame_"]:
        planes, grids = args[:3], args[3:7]
        # lpf_phase's count
        assert PB.lf_bytes(planes, grids) == sum(
            2 * p.numel() * 4 for p in planes) + sum(
            g.numel() * 4 for g in grids)


def test_scaled_mc_on_seeded_inputs():
    """mc_planes_scaled's count (no committed small clip scales a
    reference): seeded grids, three references of other sizes."""
    import types
    cs = chip_smoke()
    rng = np.random.RandomState(5)
    jobs = []
    for (H, W) in ((64, 96), (32, 48), (32, 48)):
        r4, c4 = H // 4, W // 4
        t = lambda a: torch.as_tensor(a)  # noqa: E731
        refs = tuple(t(np.zeros((h, w), np.int32))
                     for h, w in ((H * 2, W * 2), (H, W), (H // 2, W // 2)))
        dims = ((W * 2, H * 2), (W, H), (W // 2, H // 2))
        jobs.append((t(np.zeros((H, W), np.int32)),
                     t(rng.rand(r4, c4) < 0.7), t(rng.rand(r4, c4) < 0.5),
                     t(np.zeros((r4, c4), np.int32)),
                     t(rng.randint(0, 3, (r4, c4, 2)).astype(np.int32)),
                     t(np.zeros((r4, c4, 2, 2), np.int32)), refs, dims, 1,
                     1))
    recs = torch.zeros((40, 36), dtype=torch.int16)
    index = types.SimpleNamespace(bidx=torch.zeros(300, dtype=torch.int64))
    scales, steps = ((1, 1), (0, 0), (1, 1)), ((32, 32), (16, 16), (8, 8))
    for has_comp in (False, True):
        want = cs.mc_scaled_work(np, (jobs, 8, has_comp, recs, scales, steps,
                                      0, 0, index))[0]
        assert PB.mc_scaled_bytes(jobs, has_comp, recs, scales, steps,
                                  index) == want


def test_capture_counts_each_frame(calls):
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    _s, packets = ivf.read_clip(os.path.join(
        ROOT, "vectors/passa_inter_tiles.ivf"))
    frames = PB.capture(VP9Decoder(device="cpu", pass_a_impl="device"),
                        [p.data for p in packets])
    assert len(frames) == len(packets)
    assert all(f["residual_planes"] > 0 for f in frames)
    assert "lf_frame_" in frames[-1] and "mc_planes" in frames[-1]
