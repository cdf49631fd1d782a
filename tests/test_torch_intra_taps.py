"""The intra kernel's predictor table and its one launch per frame
(ffmpeg_hybrid_tpu_torch/ops/recon_cuda.py tap_table, ops/recon.py
_intra_scan_planes and run_intra): the table against the JAX package's
dense weights (ffmpeg_hybrid_tpu/ops/intra_tables.py), its predictions
applied as csrc/intra.cu applies them against (e @ W + 32) >> 6 at 8, 10
and 12 bits, and the multi-plane wrapper on the CPU and off it. Every
comparison is exact."""
import types

import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu.ops import intra_tables as JT
from ffmpeg_hybrid_tpu_torch.ops import _cuda
from ffmpeg_hybrid_tpu_torch.ops import intra_tables as it
from ffmpeg_hybrid_tpu_torch.ops import recon as P
from ffmpeg_hybrid_tpu_torch.ops import recon_cuda as RC
from test_torch_recon_kernels import INTRA_CASES, _keyframe_slabs, _t

SIZES = RC.INTRA_SIZES
MODES = [m for m in range(15) if m != it.TM]


def _part(sz):
    table = RC.tap_table()
    return table[RC.tap_offsets()[sz]:]


def _taps(word):
    """The (edge index, weight) taps of one tap word, decoded as
    csrc/intra.cu decodes them."""
    return [((word >> 9 * c) & 127, (((word >> 9 * c + 7) & 3) + 1) * 16)
            for c in range(word >> 27)]


def _dense(sz, m):
    """[ne, sz*sz] weights of (sz, m) rebuilt from the tap table."""
    part = _part(sz)
    kind, o = part[m] >> 24, part[m] & 0xffffff
    ne, npix = it.edge_len(sz), sz * sz
    W = np.zeros((ne, npix), np.int64)
    if kind == RC.COLUMN:
        W[:] = part[o:o + ne, None]
    else:
        assert kind == RC.TAPS
        for p, word in enumerate(part[o:o + npix]):
            for j, w in _taps(int(word)):
                W[j, p] += w
    return W


def _predict(sz, m, e):
    """Predictions [N, sz*sz] of edge vectors e [N, ne] as the kernel
    forms them: three taps per pixel, or the block's one column sum."""
    part = _part(sz)
    kind, o = part[m] >> 24, part[m] & 0xffffff
    if kind == RC.COLUMN:
        acc = e @ part[o:o + it.edge_len(sz)].astype(np.int64)
        return np.repeat(((acc + 32) >> 6)[:, None], sz * sz, axis=1)
    acc = np.zeros((len(e), sz * sz), np.int64)
    for p, word in enumerate(part[o:o + sz * sz]):
        for j, w in _taps(int(word)):
            acc[:, p] += w * e[:, j]
    return (acc + 32) >> 6


@pytest.mark.parametrize("sz,m", [(sz, m) for sz in SIZES for m in MODES])
def test_tap_table_unpacks_to_the_weights(sz, m):
    """Column for column, the table holds the JAX package's weights; the
    directional modes in at most three taps a pixel, the DC family in one
    column a block."""
    want = JT.build_all(sz)[m]
    assert np.array_equal(_dense(sz, m), want)
    kind = _part(sz)[m] >> 24
    assert kind == (RC.COLUMN if m in (it.DC, it.LEFT_DC, it.TOP_DC,
                                       it.DC_128, it.DC_127, it.DC_129)
                    else RC.TAPS)


@pytest.mark.parametrize("bpp,sz", [(b, sz) for b in (8, 10, 12)
                                    for sz in SIZES])
def test_taps_predict_like_the_weights(bpp, sz):
    """Seeded random edge vectors, all-zero and all-maximum ones, with
    the constant entries as the kernel assembles them: the taps and the
    DC columns give (e @ W + 32) >> 6 for every mode."""
    maxp = (1 << bpp) - 1
    ne = it.edge_len(sz)
    rng = np.random.RandomState(bpp * 100 + sz)
    e = rng.randint(0, maxp + 1, (64, ne)).astype(np.int64)
    e[0] = 0
    e[1] = maxp
    e[2, ::2] = maxp
    e[2, 1::2] = 0
    e[:, ne - 2] = 128 << (bpp - 8)
    e[:, ne - 1] = 1
    W = JT.build_all(sz).astype(np.int64)
    for m in MODES:
        want = (e @ W[m] + 32) >> 6
        got = _predict(sz, m, e)
        assert np.array_equal(got, want), (m, np.argwhere(got != want)[:3])
        assert 0 <= want.min() and want.max() <= maxp


def test_tap_table_is_small_and_marks_tm():
    """Some 47 KB for the four sizes (the dense weights took 4.7 MB), in
    int4-aligned parts; TM has no data."""
    table = RC.tap_table()
    assert table.dtype == np.int32
    assert len(table) == sum(16 + 8 * sz * sz + 6 * (-(-it.edge_len(sz)
                                                        // 4) * 4)
                             for sz in SIZES)
    assert table.nbytes < 48 * 1024
    for sz in SIZES:
        part = _part(sz)
        assert part[it.TM] == RC.TM << 24
        # the kernel reads four tap words as one int4
        assert RC.tap_offsets()[sz] % 4 == 0
        assert all((d & 0xffffff) % 4 == 0 for d in part[:15])


@pytest.fixture(scope="module")
def frame_jobs():
    """Two frames' intra jobs (Y, U and V, V on U's slab) from 130x70
    mini_encoder keyframes, with seeded planes and residuals."""
    frames = []
    for txfmmode, seed in sorted({(m, s) for m, s, _k in INTRA_CASES}):
        slabs = _keyframe_slabs(txfmmode, seed)
        rng = np.random.RandomState(seed)
        jobs = []
        for plane_idx in range(3):
            (buf, L, sizes, caps), (Hp, Wp) = slabs[min(plane_idx, 1)]
            plane = rng.randint(0, 256, (Hp, Wp)).astype(np.int32)
            residual = rng.randint(-300, 300, (Hp, Wp)).astype(np.int32)
            jobs.append((plane, residual, buf, L, sizes, caps))
        frames.append(jobs)
    return frames


def _torch_jobs(jobs, device="cpu"):
    return [(_t(p).to(device), _t(r).to(device), _t(b).to(device), L, sz, c)
            for p, r, b, L, sz, c in jobs]


def test_planes_wrapper_on_cpu_is_three_plain_calls(frame_jobs):
    RC.reset_launches()
    for jobs in frame_jobs:
        tj = _torch_jobs(jobs)
        got = P._intra_scan_planes(tj, 8)
        assert len(got) == 3
        for out, job in zip(got, tj):
            assert torch.equal(out, P._intra_scan_plain(*job, 8))
            assert not torch.equal(out, job[0])
    assert RC.LAUNCHES["intra"] == 0


def test_run_intra_off_cpu_is_one_launch_per_frame(monkeypatch,
                                                   frame_jobs):
    """recon_frame's intra stage hands the three planes of a frame to
    one launch (V on U's slab), checked first; a fourth plane raises."""
    launched = []

    def fake_launch(source, signatures, name, *args):
        launched.append((name, args))

    monkeypatch.setattr(_cuda, "launch", fake_launch)
    monkeypatch.setattr(P, "_intra_scan_plain", None)
    meta = torch.device("meta")
    jobs = _torch_jobs(frame_jobs[0], meta)
    slabs = [frame_jobs[0][0][2:], frame_jobs[0][1][2:]]
    s = types.SimpleNamespace(
        header=types.SimpleNamespace(bpp=8),
        pre={"slabs": [(b, L, sz, c) for b, L, sz, c in slabs],
             "dev": {"slabs": [jobs[0][2], jobs[1][2]]}})
    RC.reset_launches()
    outs = P.run_intra(s, [j[0] for j in jobs], [j[1] for j in jobs])
    assert [name for name, _a in launched] == ["intra_scan"]
    assert RC.LAUNCHES == {"residual": 0, "residual_hbd": 0,
                           "intra": 1, "splat": 0, "scatter": 0, "mc": 0,
                           "mc_scaled": 0}
    args = launched[0][1]
    ptrs, n = args[:9], args[11]
    assert n == 3
    for j, (plane, residual, slab, *_rest) in enumerate(jobs):
        assert ptrs[3 * j] is outs[j] and outs[j] is not plane
        assert ptrs[3 * j + 1] is residual
        assert ptrs[3 * j + 2] is (jobs[1][2] if j == 2 else slab)
    # a frame whose planes have no intra blocks launches nothing
    s.pre["slabs"] = [None, None]
    planes = [j[0] for j in jobs]
    assert all(a is b for a, b in zip(P.run_intra(s, planes, planes),
                                      planes))
    assert RC.LAUNCHES["intra"] == 1
    with pytest.raises(ValueError, match="at most 3"):
        P._intra_scan_planes(jobs + jobs[:1], 8)
    with pytest.raises(TypeError):
        P._intra_scan_planes(jobs[:2] + [(jobs[2][0], jobs[2][1].to(
            torch.int16), *jobs[2][2:])], 8)
    assert len(launched) == 1
