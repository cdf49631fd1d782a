"""The residual and intra-wavefront stages of the port
(ffmpeg_hybrid_tpu_torch/ops/recon.py) around their CUDA kernels
(csrc/itxfm.cu, csrc/intra.cu): the plain versions against the JAX
package's ops/recon_tpu.py (CPU-JAX, as tests/conftest.py sets it) at
the inputs where the arithmetic is hardest, the wrappers' choice between
plain version and kernel, and, on a card, each kernel against its plain
version and a decode that never reaches a plain version. Every
comparison is exact."""
import hashlib
import itertools
import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu.ops import recon_tpu as J
from ffmpeg_hybrid_tpu_torch.ops import _cuda
from ffmpeg_hybrid_tpu_torch.ops import intra_tables as it
from ffmpeg_hybrid_tpu_torch.ops import recon as P
from ffmpeg_hybrid_tpu_torch.ops import recon_cuda as RC

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
VEC = os.path.join(os.path.dirname(__file__), "..", "vectors")

# int16 coefficient values where the int32 products and the int16 wrap
# after each pass decide the result
EXTREMES = {"max": [32767, -32768, -32767, 0],
            "mixed": [32767, -32768, 20000, -20000, 1, -1],
            "20000": [20000, -20000]}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(want, got):
    a = np.asarray(want).astype(np.int64)
    b = got.cpu().numpy().astype(np.int64)
    assert a.shape == b.shape
    assert np.array_equal(a, b), np.argwhere(a != b)[:4]


def _residual_inputs(seed, tx, values=None, H=64, W=96):
    """coef [H, W] int16, eob/txsz/txtype [H/4, W/4]: each 32x32 region
    tiled by one size (`tx` in half of them, "lossless": 4x4 only), every
    type, eob 0, 1 (the DC shortcut), small and full. `values`: draw the
    coefficients from these."""
    rng = np.random.RandomState(seed)
    lossless = tx == "lossless"
    r4, c4 = H // 4, W // 4
    coef = rng.randint(-4000, 4000, (H, W)) if values is None \
        else rng.choice(values, (H, W))
    coef = coef.astype(np.int16)
    txsz = np.zeros((r4, c4), np.int8)
    txtype = np.zeros((r4, c4), np.int8)
    eob = np.zeros((r4, c4), np.int16)
    for n, (qy, qx) in enumerate(itertools.product(range(0, r4, 8),
                                                   range(0, c4, 8))):
        sz = 0 if lossless else (tx if n % 2 else rng.randint(0, 4))
        k = 1 << sz
        txsz[qy:qy + 8, qx:qx + 8] = sz
        for y in range(qy, qy + 8, k):
            for x in range(qx, qx + 8, k):
                txtype[y:y + k, x:x + k] = rng.randint(0, 4) if sz < 3 else 0
                eob[y, x] = rng.choice([0, 1, 1, 2, 5, (4 << sz) ** 2])
    return coef, eob, txsz, txtype


def _random_grids(seed, H=64, W=64):
    """Per-cell random grids (roots of every size at once, overlapping
    blocks, out-of-range sizes and types) over int32 coefficients."""
    rng = np.random.RandomState(seed)
    coef = rng.randint(-30000, 30000, (H, W)).astype(np.int32)
    txsz = rng.randint(-1, 5, (H // 4, W // 4)).astype(np.int32)
    txtype = rng.randint(0, 5, (H // 4, W // 4)).astype(np.int16)
    eob = rng.choice([0, 1, 2, 7], (H // 4, W // 4)).astype(np.int32)
    return coef, eob, txsz, txtype


RESIDUAL_CASES = [(tx, v) for tx in (0, 1, 2, 3, "lossless")
                  for v in ("max", "mixed", "20000")]


@pytest.mark.parametrize("tx,values", RESIDUAL_CASES)
def test_residual_plain_matches_jax_at_int16_extremes(tx, values):
    args = _residual_inputs(len(values) * 10 + (5 if tx == "lossless"
                                                else tx), tx,
                            EXTREMES[values])
    lossless = tx == "lossless"
    want = J.residual_plane(*(jnp.asarray(a) for a in args), lossless, 8)
    got = P.residual_plane_plain(*(_t(a) for a in args), lossless, 8)
    _same(want, got)
    assert np.abs(np.asarray(want)).max() > 0


def _mini():
    sys.path.insert(0, TOOLS)
    try:
        import mini_encoder
    finally:
        sys.path.pop(0)
    return mini_encoder


def _keyframe_slabs(txfmmode, seed):
    """The intra slabs of a 130x70 mini_encoder keyframe (its last
    superblock column and row hang over the frame, so blocks at the
    right and bottom edges clamp n_have_top and n_have_left)."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    pkt = _mini().encode_keyframe_random(130, 70, 8, seed=seed,
                                         txfmmode=txfmmode, filter_level=0)
    dec = VP9Decoder(device="cpu")
    job = dec.precompute_job(dec.decode_pass_a(pkt))
    return [(job.pre["slabs"][k], job.cur_frame_obj.planes[k].shape)
            for k in (0, 1)]


def _slab_sizes(slab):
    buf, L, sizes, caps = slab
    szs = np.zeros(len(buf), np.int64)
    base = 0
    for sz, cap in zip(sizes, caps):
        szs[base:base + L * cap] = sz
        base += L * cap
    return szs


INTRA_CASES = [(0, 4, 0), (0, 4, 1), (4, 11, 0), (4, 11, 1)]


@pytest.fixture(scope="module")
def keyframe_slabs():
    return {(m, seed): _keyframe_slabs(m, seed)
            for m, seed in {(m, s) for m, s, _k in INTRA_CASES}}


def _intra_inputs(case, keyframe_slabs):
    txfmmode, seed, k = case
    slab, (Hp, Wp) = keyframe_slabs[(txfmmode, seed)][k]
    rng = np.random.RandomState(seed + k)
    plane = rng.randint(0, 256, (Hp, Wp)).astype(np.int32)
    residual = rng.randint(-300, 300, (Hp, Wp)).astype(np.int32)
    return plane, residual, slab


@pytest.mark.parametrize("case", INTRA_CASES, ids=str)
def test_intra_scan_plain_matches_jax_at_the_frame_edges(case,
                                                         keyframe_slabs):
    plane, residual, slab = _intra_inputs(case, keyframe_slabs)
    buf, L, sizes, caps = slab
    Hp = plane.shape[0]
    real = buf[:, 0] < Hp
    szs = _slab_sizes(slab)
    # 4x4 blocks at the right edge: the top-right zone is not available
    # (n_have_top < 8) although the mode may want it
    assert ((szs == 4) & real & (buf[:, 6] < 8)).any()
    if case[0]:
        # larger blocks hanging over the right and bottom edges
        assert (real & (buf[:, 6] < szs)).any()
        assert (real & (buf[:, 7] < szs)).any()
    want = J._intra_scan(jnp.asarray(plane), jnp.asarray(residual),
                         jnp.asarray(buf), L, sizes, caps, 8)
    got = P._intra_scan_plain(_t(plane), _t(residual), _t(buf), L, sizes,
                              caps, 8)
    _same(want, got)


def test_wrappers_on_cpu_take_the_plain_versions(keyframe_slabs):
    """CPU tensors go to the plain versions; nothing counts a launch."""
    RC.reset_launches()
    args = [_t(a) for a in _residual_inputs(3, 2)]
    assert torch.equal(P.residual_plane(*args, False, 8),
                       P.residual_plane_plain(*args, False, 8))
    plane, residual, (buf, L, sizes, caps) = _intra_inputs(
        INTRA_CASES[0], keyframe_slabs)
    targs = (_t(plane), _t(residual), _t(buf), L, sizes, caps, 8)
    assert torch.equal(P._intra_scan(*targs), P._intra_scan_plain(*targs))
    assert P.LAUNCHES is RC.LAUNCHES
    assert RC.LAUNCHES == {"residual": 0, "residual_hbd": 0,
                           "intra": 0, "splat": 0, "scatter": 0, "mc": 0,
                           "mc_scaled": 0}


def test_wrappers_off_cpu_go_to_the_kernels(monkeypatch):
    """Tensors off the CPU reach the kernel launch (which raises here),
    never the plain versions; shapes and types are checked first; a
    tensor on a device that is not CUDA raises; no launch is counted."""
    meta = dict(device="meta")
    coef = torch.zeros((64, 96), dtype=torch.int16, **meta)
    g = torch.zeros((16, 24), dtype=torch.int32, **meta)
    plane = torch.zeros((64, 96), dtype=torch.int32, **meta)
    slab = torch.zeros((64, 8), dtype=torch.int16, **meta)
    RC.reset_launches()
    with pytest.raises(ValueError, match="not a CUDA device"):
        P.residual_plane(coef, g, g, g, False, 8)
    with pytest.raises(ValueError, match="not a CUDA device"):
        P._intra_scan(plane, plane, slab, 2, (4, 8), (8, 8), 8)
    calls = []

    def no_card(source, signatures, name, *args):
        calls.append(name)
        raise RuntimeError("no card")

    monkeypatch.setattr(_cuda, "launch", no_card)
    monkeypatch.setattr(P, "residual_plane_plain", None)
    monkeypatch.setattr(P, "_intra_scan_plain", None)
    with pytest.raises(RuntimeError, match="no card"):
        P.residual_plane(coef, g.to(torch.int16), g.to(torch.int8), g, True,
                         8)
    with pytest.raises(RuntimeError, match="no card"):
        P._intra_scan(plane, plane, slab, 2, (4, 8), (8, 8), 8)
    with pytest.raises(TypeError):
        P.residual_plane(coef.to(torch.float32), g, g, g, False, 8)
    with pytest.raises(TypeError):
        P.residual_plane(coef, g.to(torch.int64), g, g, False, 8)
    with pytest.raises(ValueError):
        P.residual_plane(coef, g[:8], g, g, False, 8)
    with pytest.raises(ValueError):       # not 32x32 regions
        P.residual_plane(coef[:36], g[:9], g[:9], g[:9], False, 8)
    with pytest.raises(TypeError):        # 10/12 bpp: int32 coefficients
        P.residual_plane(coef, g, g, g, False, 10)
    with pytest.raises(ValueError):
        P.residual_plane(coef.to(torch.int32), g, g, g, False, 9)
    with pytest.raises(RuntimeError, match="no card"):
        P.residual_plane(coef.to(torch.int32), g, g, g, False, 12)
    with pytest.raises(TypeError):
        P._intra_scan(plane, plane.to(torch.int16), slab, 2, (4, 8), (8, 8),
                      8)
    with pytest.raises(ValueError):       # the slab is too short
        P._intra_scan(plane, plane, slab[:31], 2, (4, 8), (8, 8), 8)
    with pytest.raises(ValueError):
        P._intra_scan(plane, plane, slab, 2, (4, 64), (8, 8), 8)
    assert calls == ["residual_planes", "intra_scan", "residual_planes_hbd"]
    assert RC.LAUNCHES == {"residual": 0, "residual_hbd": 0,
                           "intra": 0, "splat": 0, "scatter": 0, "mc": 0,
                           "mc_scaled": 0}


@pytest.mark.parametrize("sizes,caps,L", [((4,), (256,), 3700),
                                          ((4, 8, 16, 32), (64, 32, 8, 8),
                                           900),
                                          ((16, 32), (8, 8), 1)])
def test_intra_meta_describes_the_slab_and_the_table(sizes, caps, L):
    """The layout the intra kernel reads: sections start where
    pack_intra_slab puts them, and each size's part of the tap table
    where the table holds it (16 ints of mode descriptors, then 8
    directional modes of a tap word per pixel and 6 DC-family columns
    padded to a multiple of 4)."""
    meta = RC.intra_meta(sizes, caps, L)
    table = RC.tap_table()
    assert len(meta) == 1 + 5 * len(sizes) <= RC.INTRA_META_LEN
    assert meta[0] == sum(caps)
    base = 0
    for k, (sz, cap) in enumerate(zip(sizes, caps)):
        s_sz, s_cap, s_base, s_ne, s_toff = meta[1 + 5 * k:6 + 5 * k]
        assert (s_sz, s_cap, s_base, s_ne) == (sz, cap, base,
                                               it.edge_len(sz))
        assert s_toff == RC.tap_offsets()[sz]
        desc = table[s_toff:s_toff + 15]
        assert desc[it.TM] == RC.TM << 24
        ends = [16] + [d & 0xffffff for d in desc if d >> 24 != RC.TM]
        assert ends == sorted(ends)
        part = 16 + 8 * sz * sz + 6 * (-(-s_ne // 4) * 4)
        nxt = [o for o in RC.tap_offsets().values() if o > s_toff]
        assert s_toff + part == (min(nxt) if nxt else len(table))
        base += L * cap


@pytest.mark.parametrize("case", INTRA_CASES, ids=str)
def test_spread_slab_keeps_the_wavefront(case, keyframe_slabs):
    """spread_slab moves each level's blocks to other slots of wider
    sections; the plain wavefront over it is the one over the slab as
    packed (at a cap that keeps the CPU's plain version small)."""
    plane, residual, slab = _intra_inputs(case, keyframe_slabs)
    buf, L, sizes, caps = slab
    wide = RC.spread_slab(slab, tuple(4 * c for c in caps), *plane.shape,
                          seed=case[1])
    real = buf[:, 0] < plane.shape[0]
    assert (wide[0][:, 0] < plane.shape[0]).sum() == real.sum()
    args = (_t(plane), _t(residual))
    _same(P._intra_scan_plain(*args, _t(buf), L, sizes, caps, 8),
          P._intra_scan_plain(*args, _t(wide[0]), *wide[1:], 8))


def test_decode_on_cpu_launches_no_kernel():
    """The main path with device="cpu" (a keyframe and inter frames with
    intra blocks) goes through the wrappers, which take the plain
    versions: no launch is counted."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    m = _mini()
    pkts = [m.encode_keyframe_random(64, 64, 8, seed=6, txfmmode=4,
                                     filter_level=0),
            m.encode_inter_flex(64, 64, seed=7, coeffs=True, p_intra=0.3,
                                refresh_mask=0x01, filter_level=0)]
    RC.reset_launches()
    from ffmpeg_hybrid_tpu_torch.utils.metrics import metrics
    metrics.enable()
    metrics.reset()
    try:
        dec = VP9Decoder(device="cpu")
        frames = [f for p in pkts for f in dec.decode(p)]
        rep = metrics.report()
    finally:
        metrics.disable()
    assert len(frames) == 2
    assert RC.LAUNCHES == {"residual": 0, "residual_hbd": 0,
                           "intra": 0, "splat": 0, "scatter": 0, "mc": 0,
                           "mc_scaled": 0}
    assert rep["intra.levels"]["value"] > 0


# ---------------------------------------------------------------------------
# on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.cuda
def test_residual_kernel_matches_plain_on_the_card():
    dev = _card()
    cases = [(_residual_inputs(s, tx, EXTREMES[v] if v else None,
                               H=96, W=128), tx == "lossless")
             for s, (tx, v) in enumerate(itertools.product(
                 (0, 1, 2, 3, "lossless"), (None, "max", "mixed")))]
    cases += [(_random_grids(s), False) for s in range(4)]
    RC.reset_launches()
    for args, lossless in cases:
        want = P.residual_plane_plain(*(_t(a) for a in args), lossless, 8)
        got = P.residual_plane(*(_t(a).to(dev) for a in args), lossless, 8)
        assert torch.equal(got.cpu(), want)
    assert RC.LAUNCHES["residual"] == len(cases)


def _frame_jobs(case, keyframe_slabs, dev):
    """Y, U and V of one keyframe (V on U's slab) as intra jobs, with
    seeded planes and residuals."""
    txfmmode, seed, _k = case
    rng = np.random.RandomState(seed + 7)
    jobs = []
    for plane_idx in range(3):
        (buf, L, sizes, caps), shape = keyframe_slabs[(txfmmode, seed)][
            min(plane_idx, 1)]
        plane = rng.randint(0, 256, shape).astype(np.int32)
        residual = rng.randint(-300, 300, shape).astype(np.int32)
        jobs.append((_t(plane).to(dev), _t(residual).to(dev),
                     _t(buf).to(dev), L, sizes, caps))
    return jobs


def _held_to_plain(jobs):
    """One launch of the intra kernel on `jobs`, each plane equal to its
    plain version, the inputs unchanged."""
    before = [j[0].clone() for j in jobs]
    got = P._intra_scan_planes(jobs, 8)
    for out, job, b in zip(got, jobs, before):
        want = P._intra_scan_plain(*job, 8)
        assert torch.equal(out, want)
        assert torch.equal(job[0], b)


@pytest.mark.cuda
def test_intra_kernel_matches_plain_on_the_card(keyframe_slabs):
    """Y, U and V of each keyframe in one launch."""
    dev = _card()
    RC.reset_launches()
    cases = [c for c in INTRA_CASES if c[2] == 0]
    for case in cases:
        _held_to_plain(_frame_jobs(case, keyframe_slabs, dev))
    assert RC.LAUNCHES["intra"] == len(cases)


@pytest.mark.cuda
def test_intra_kernel_planes_of_one_launch_differ(keyframe_slabs):
    """The planes of one launch differ in shape, L, sizes and caps (one
    of them spread over several windows per level): each block walks
    its own."""
    dev = _card()
    a = _frame_jobs(INTRA_CASES[0], keyframe_slabs, dev)
    b = _frame_jobs(INTRA_CASES[2], keyframe_slabs, dev)
    plane, residual, (buf, L, sizes, caps) = _intra_inputs(INTRA_CASES[3],
                                                           keyframe_slabs)
    wide = RC.spread_slab((buf, L, sizes, caps),
                          tuple((1024 // sum(caps) + 1) * c for c in caps),
                          *plane.shape, seed=3)
    spread = (_t(plane).to(dev), _t(residual).to(dev), _t(wide[0]).to(dev),
              *wide[1:])
    jobs = [b[0], a[1], spread]
    assert len({(j[3], j[4], j[5]) for j in jobs}) == 3
    assert len({tuple(j[0].shape) for j in jobs}) == 2
    RC.reset_launches()
    _held_to_plain(jobs)
    assert RC.LAUNCHES["intra"] == 1


@pytest.mark.cuda
def test_intra_kernel_matches_plain_when_a_level_spans_windows(
        keyframe_slabs):
    """The slabs of test (b) spread to more rows per level than a
    window's 1024 threads: each level's blocks lie in several windows of
    the kernel, and the windows cross the sections."""
    dev = _card()
    edges = P._const("edges", dev)
    for case in INTRA_CASES:
        plane, residual, slab = _intra_inputs(case, keyframe_slabs)
        widen = 1024 // sum(slab[3]) + 1
        buf, L, sizes, caps = RC.spread_slab(
            slab, tuple(widen * c for c in slab[3]), *plane.shape,
            seed=case[1])
        args = [_t(a).to(dev) for a in (plane, residual, buf)]
        want = P._intra_scan_plain(*args, L, sizes, caps, 8)
        got = args[0].clone()
        windows = RC.intra([(got, args[1], args[2], L, sizes, caps)], 8,
                           edges)
        assert windows[0] > 1, case
        assert torch.equal(got, want), case


@pytest.mark.cuda
def test_bench_1080p_on_the_card_never_calls_the_plain_versions(
        monkeypatch):
    dev = _card()
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu_torch.formats.ivf import read_ivf
    from ffmpeg_hybrid_tpu_torch.formats.superframe import split_superframe

    def plain_called(*a, **k):
        raise AssertionError("a plain version ran on the card's main path")

    monkeypatch.setattr(P, "residual_plane_plain", plain_called)
    monkeypatch.setattr(P, "_intra_scan_plain", plain_called)
    monkeypatch.setattr(P, "_grids_from_records_plain", plain_called)
    for name in ("mc_planes_plain", "_scatter_pairs16", "_scatter_pairs32"):
        monkeypatch.setattr(P, name, plain_called)
    _info, pkts = read_ivf(os.path.join(VEC, "bench_1080p.ivf"))
    frames = (fd for pts, data in pkts
              for _p, fd in split_superframe(data, pts))
    want = [line.split(",")[-1].strip() for line in
            open(os.path.join(VEC, "bench_1080p.framemd5"))
            if line.strip() and not line.startswith("#")][:3]
    RC.reset_launches()
    got = [hashlib.md5(f.to_bytes()).hexdigest() for f in
           VP9Decoder(device=dev).decode_stream(itertools.islice(frames,
                                                                 3))]
    assert got == want
    assert RC.LAUNCHES["residual"] == 3
    assert RC.LAUNCHES["scatter"] == 3
    assert RC.LAUNCHES["mc"] == 2
    assert RC.LAUNCHES["intra"] > 0
    assert RC.LAUNCHES["splat"] == 3
