"""Each torch stage of ffmpeg_hybrid_tpu_torch/ops/recon.py against its
counterpart in the JAX package's ops/recon_tpu.py (CPU-JAX, as
tests/conftest.py sets it) on the same numpy inputs. Every stage is
integer math or exact float32, so every comparison is exact."""
import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu.ops import recon_tpu as J
from ffmpeg_hybrid_tpu_torch.ops import recon as P

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(jax_out, torch_out):
    a = np.asarray(jax_out).astype(np.int64)
    b = torch_out.numpy().astype(np.int64)
    assert a.shape == b.shape
    assert np.array_equal(a, b), np.argwhere(a != b)[:4]


def _pass_a_job(inter_seed, w=128, h=128):
    """Pass-A snapshot (with the host precompute) of a mini_encoder
    inter frame that has sub-8x8 inter blocks, compound blocks,
    switchable filters and intra blocks with TM, after its keyframe."""
    sys.path.insert(0, TOOLS)
    try:
        from mini_encoder import encode_keyframe_random, encode_inter_flex
    finally:
        sys.path.pop(0)
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    key = encode_keyframe_random(w, h, 8, seed=3, txfmmode=3, yac_qi=60,
                                 filter_level=0)
    inter = encode_inter_flex(
        w, h, seed=inter_seed, comppredmode=2, signbias=(0, 0, 1),
        filtermode=4, coeffs=True, p_intra=0.2, p_skip=0.2,
        mv_mags=(0, 2, 4, 8, 16, 64), refresh_mask=0x01, filter_level=0)
    dec = VP9Decoder(device="cpu")
    jobs = []
    for pkt in (key, inter):
        job = dec.precompute_job(dec.decode_pass_a(pkt))
        jobs.append(job)
        dec.decode_pass_b(job)
    return jobs


@pytest.fixture(scope="module")
def jobs20():
    return _pass_a_job(20)


@pytest.fixture(scope="module")
def jobs30():
    return _pass_a_job(30)


@pytest.mark.parametrize("wide", [False, True])
def test_scatter_pairs_with_pad_rows(wide):
    rng = np.random.RandomState(1 + wide)
    H, W = 24, 40
    n = 150
    pos = rng.choice(H * W, n, replace=False).astype(np.int64)
    lim = (1 << 20) if wide else 30000
    val = rng.randint(-lim, lim, n)
    rows = np.zeros((n + 20, 4 if wide else 3), np.int16)
    P._fill_pairs(rows, pos, val, n)
    rows[n:n + 10, 0] = -1                      # pad rows
    P._fill_pairs(rows[n + 10:], np.arange(10) + H * W, np.arange(10), 10)
    jf = J._scatter_pairs32 if wide else J._scatter_pairs16
    tf = P._scatter_pairs32 if wide else P._scatter_pairs16
    _same(jf(jnp.asarray(rows), H, W), tf(_t(rows), H, W))
    # and the merged form's carve-out
    flat_j = jf(jnp.asarray(rows), 1, H * W)
    flat_t = tf(_t(rows), 1, H * W)
    for a, b in zip(J._slice_plane(flat_j, flat_j, 40, 80, 8, 20, 4, 10),
                    P._slice_plane(flat_t, flat_t, 40, 80, 8, 20, 4, 10)):
        _same(a, b)


@pytest.mark.parametrize("seed,ss", [(20, (1, 1)), (30, (1, 1)),
                                     (30, (1, 0)), (30, (0, 0))])
def test_grids_from_records(seed, ss, jobs20, jobs30):
    """Real block records (sub-8x8 inter leaves, compound, intra), with
    the MV fields randomized so the chroma averaging sees odd and
    negative sums; every subsampling's averaging rule (incl. the 4:2:2
    bug) is exercised on the same records."""
    job = (jobs20 if seed == 20 else jobs30)[1]
    recs = job.pre["recs"].copy()
    rng = np.random.RandomState(seed)
    recs[:, 18:34] = rng.randint(-301, 302, (len(recs), 16))
    valid = recs[recs[:, 3] >= 0]
    assert (valid[:, 3] >= 10).any() and (valid[:, 14] != 0).any()
    r4, c4 = job.txsz4.shape
    got = P._grids_from_records(_t(recs), r4, c4, *ss)
    want = J._grids_from_records(jnp.asarray(recs), r4, c4, *ss)
    assert len(got) == len(want) == 14
    for a, b in zip(want, got):
        _same(a, b)


def _residual_inputs(rng, tx, lossless):
    H = W = 64
    r4 = c4 = 16
    coef = rng.randint(-4000, 4000, (H, W)).astype(np.int16)
    if lossless:
        coef = (coef // 8).astype(np.int16)
    # per 32x32 quadrant a tx size (this tx in two of them)
    sizes = [tx, (tx + 1) % 4, tx, (tx + 3) % 4] if not lossless \
        else [0] * 4
    txsz4 = np.zeros((r4, c4), np.int8)
    txtype4 = np.zeros((r4, c4), np.int8)
    eob4 = np.zeros((r4, c4), np.int16)
    for q, sz in enumerate(sizes):
        qy, qx = (q >> 1) * 8, (q & 1) * 8
        k = 1 << sz
        txsz4[qy:qy + 8, qx:qx + 8] = sz
        for y in range(qy, qy + 8, k):
            for x in range(qx, qx + 8, k):
                txtype4[y:y + k, x:x + k] = rng.randint(0, 4) if sz < 3 \
                    else 0
                eob4[y, x] = rng.choice([0, 1, 1, 2, 5, (4 << sz) ** 2])
    return coef, eob4, txsz4, txtype4


@pytest.mark.parametrize("tx", [0, 1, 2, 3, "lossless"])
def test_residual_every_size_type_dc_only(tx):
    lossless = tx == "lossless"
    t = 0 if lossless else tx
    rng = np.random.RandomState(7 + (5 if lossless else t))
    args = _residual_inputs(rng, t, lossless)
    jargs = [jnp.asarray(a) for a in args]
    targs = [_t(a) for a in args]
    _same(J._residual_for_size(*jargs, t, lossless, 8, 64, 64),
          P._residual_for_size(*targs, t, lossless, 8))
    _same(J.residual_plane(*jargs, lossless, 8),
          P.residual_plane(*targs, lossless, 8))


@pytest.mark.parametrize("mvs,has_comp", [((2, 2), True), ((1, 1), True),
                                          ((2, 2), False)])
def test_mc_cells_filters_compound_edge_clamps(mvs, has_comp):
    rng = np.random.RandomState(sum(mvs) + has_comp)
    Hp, Wp = 64, 96
    r4, c4 = Hp // 4, Wp // 4
    w, h = 90, 61      # visible area inside the padded plane
    refstack = rng.randint(0, 256, (3, Hp, Wp)).astype(np.int32)
    # up to +-50 px at mvs=2: many patches clamp at every edge
    mv16 = rng.randint(-400, 400, (r4, c4, 2, 2)).astype(np.int16)
    refsel = rng.randint(0, 3, (r4, c4, 2)).astype(np.int32)
    comp = rng.rand(r4, c4) < 0.5
    if not has_comp:
        comp[:] = False
    filt = rng.randint(0, 4, (r4, c4)).astype(np.int8)
    inter = rng.rand(r4, c4) < 0.8
    want = J._mc_cells(jnp.asarray(refstack), jnp.asarray(mv16),
                       jnp.asarray(refsel), jnp.asarray(comp),
                       jnp.asarray(filt), jnp.asarray(inter), w, h, 8,
                       *mvs)
    got = P._mc_cells(_t(refstack), _t(mv16), _t(refsel), _t(comp),
                      _t(filt), _t(inter), w, h, 8, *mvs,
                      has_comp=has_comp)
    _same(want, got)


@pytest.mark.parametrize("which", ["key_y", "key_uv", "inter20_y",
                                   "inter30_uv"])
def test_intra_scan_tm_and_inert_rows(which, jobs20, jobs30):
    """The whole wavefront of one plane from a real schedule (the slab
    carries inert pad rows; the frames have TM blocks), over a random
    starting plane and residual."""
    jobs = jobs30 if which.startswith("inter30") else jobs20
    job = jobs[0] if which.startswith("key") else jobs[1]
    k = 1 if which.endswith("uv") else 0
    buf, L, sizes, caps = job.pre["slabs"][k]
    Hp, Wp = job.cur_frame_obj.planes[k].shape
    real = buf[:, 0] < Hp
    assert not real.all()              # inert rows present
    if k == 0:
        assert (buf[real, 2] == 9).any()   # TM blocks present
    rng = np.random.RandomState(len(which))
    plane = rng.randint(0, 256, (Hp, Wp)).astype(np.int32)
    residual = rng.randint(-300, 300, (Hp, Wp)).astype(np.int32)
    want = J._intra_scan(jnp.asarray(plane), jnp.asarray(residual),
                         jnp.asarray(buf), L, sizes, caps, 8)
    got = P._intra_scan(_t(plane), _t(residual), _t(buf), L, sizes,
                        caps, 8)
    _same(want, got)
    # the edge specs alone, per size, over the whole slab
    base = 0
    for sz, cap in zip(sizes, caps):
        ent = buf[base:base + L * cap].astype(np.int32)
        for a, b in zip(J._edge_spec_dev(jnp.asarray(ent), sz, Wp, 8),
                        P._edge_spec_dev(_t(ent), sz, Wp, 8)):
            _same(a, b)
        base += L * cap
