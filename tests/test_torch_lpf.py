"""The port's loop filter (ffmpeg_hybrid_tpu_torch/ops/lpf_masks.py,
ops/lpf_dense.py) against the JAX package's ops/lpf_masks.py,
ops/lpf_dense.py and ops/lpf_tpu.py on the same numpy inputs (CPU-JAX,
as tests/conftest.py sets it), and the CUDA kernel (csrc/lpf.cu)
against the plain version on the card. Every comparison is exact."""
import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ffmpeg_hybrid_tpu.ops import lpf_dense as JD
from ffmpeg_hybrid_tpu.ops import lpf_masks as JM
from ffmpeg_hybrid_tpu.ops.lpf_tpu import filter_lanes_jnp
from ffmpeg_hybrid_tpu_torch.ops import _cuda
from ffmpeg_hybrid_tpu_torch.ops import lpf_dense as PD
from ffmpeg_hybrid_tpu_torch.ops import lpf_masks as PM

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")


def _mini():
    sys.path.insert(0, TOOLS)
    try:
        import mini_encoder
    finally:
        sys.path.pop(0)
    return mini_encoder


def _same(a, b):
    a = np.asarray(a).astype(np.int64)
    b = b.numpy().astype(np.int64)
    assert a.shape == b.shape
    assert np.array_equal(a, b), np.argwhere(a != b)[:4]


def _keyframe_state(w, h, seed, **kw):
    """The JAX package's pass-A state of a mini_encoder keyframe."""
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder
    data = _mini().encode_keyframe_random(w, h, 8, seed=seed, **kw)
    return VP9Decoder(recon_backend="golden").decode_pass_a(data)


GRID_CASES = [
    dict(w=192, h=128, seed=1, filter_level=24),
    dict(w=128, h=64, seed=2, filter_level=63, sharpness=3),
    dict(w=192, h=128, seed=20, filter_level=40, txfmmode=0),
    dict(w=130, h=70, seed=4, filter_level=31),
    dict(w=192, h=128, seed=31, filter_level=44, ss_h=0, ss_v=0,
         txfmmode=0),
    dict(w=192, h=128, seed=32, filter_level=37, ss_h=1, ss_v=0),
    dict(w=192, h=128, seed=33, filter_level=29, ss_h=0, ss_v=1),
]


@pytest.mark.parametrize("case", GRID_CASES, ids=lambda c: f"s{c['seed']}")
def test_grids_match_jax(case):
    """grids_device and dense_grids against JAX grids_device (jnp) and
    dense_grids(np, ...) on the same pass-A levels and masks; the
    flags against JAX lf_flags."""
    kw = dict(case)
    w, h = kw.pop("w"), kw.pop("h")
    s = _keyframe_state(w, h, **kw)
    hd = s.header
    lfl, lfm, luts = PM.lf_buffers(s)
    want = JM.grids_device(jnp.asarray(lfl), jnp.asarray(lfm),
                           jnp.asarray(luts), s.sb_rows, s.sb_cols,
                           hd.ss_h, hd.ss_v)
    got = PM.grids_device(torch.from_numpy(lfl), torch.from_numpy(lfm),
                          torch.from_numpy(luts), s.sb_rows, s.sb_cols,
                          hd.ss_h, hd.ss_v)
    host = JM.grids_host(s)
    for a, b, c in zip(want, got, PM.grids_host(s)):
        _same(a, b)
        _same(a, c)
    for a, b in zip(host, got):
        _same(a, b)
    assert PM.lf_flags(s) == JM.lf_flags(s)[:2]
    assert got[0][..., 0].any()   # the frame has active edges


def _lanes(seed, bpp, n=384):
    """[n, 8, 16] windows: flat, nearly flat, smooth ramps with a step
    at the edge, and noise; every wd; E/I/H over their ranges."""
    rng = np.random.RandomState(seed)
    maxp = (1 << bpp) - 1
    base = rng.randint(0, maxp + 1, (n, 1, 1))
    amp = np.array([0, 1, 2, 4, 16, 1 << (bpp - 2)])[rng.randint(0, 6, n)]
    win = base + rng.randint(-1, 2, (n, 8, 16)) * amp[:, None, None]
    step = rng.randint(-3, 4, n) * (1 << (bpp - 8))
    win[:, :, 8:] += step[:, None, None]
    win = np.clip(win, 0, maxp).astype(np.int32)
    wd = np.array([0, 4, 8, 16], np.int32)[np.arange(n) % 4]
    L = rng.randint(1, 64, n)
    sharp = rng.randint(0, 8, n)
    lim = np.maximum(np.minimum(L >> ((sharp + 3) >> 2), 9 - sharp), 1)
    lim = np.where(sharp > 0, lim, np.maximum(L, 1))
    E = (2 * (L + 2) + lim).astype(np.int32)
    return win, E, lim.astype(np.int32), (L >> 4).astype(np.int32), wd


@pytest.mark.parametrize("bpp", [8, 10, 12])
def test_filter_lanes_matches_jnp(bpp):
    win, E, I, H, wd = _lanes(bpp, bpp)
    want = filter_lanes_jnp(jnp.asarray(win), jnp.asarray(E), jnp.asarray(I),
                            jnp.asarray(H), jnp.asarray(wd), bpp)
    got = PD.filter_lanes(*(torch.from_numpy(a) for a in (win, E, I, H, wd)),
                          bpp)
    _same(want, got)
    changed = (np.asarray(want) != win).any(-1)
    # every filter width fired somewhere
    for k in (4, 8, 16):
        assert changed[wd == k].any(), k
    assert not changed[wd == 0].any()


def _prefilter_planes(case):
    """A keyframe's reconstructed planes before the loop filter, with
    its real V/H grids, from the JAX package's golden decoder."""
    from ffmpeg_hybrid_tpu.codecs.vp9 import golden
    kw = dict(case)
    w, h = kw.pop("w"), kw.pop("h")
    s = _keyframe_state(w, h, **kw)
    golden.recon_frame(s)
    planes = [np.asarray(p, np.int32) for p in s.cur_frame_obj.planes]
    return s, planes, [g.numpy() for g in PM.grids_host(s)]


def _random_grids(rng, Hp, Wp):
    def grid(shape):
        g = np.zeros(shape + (4,), np.int32)
        g[..., 0] = rng.choice([0, 4, 8, 16], shape)
        g[..., 1] = rng.randint(1, 194, shape)
        g[..., 2] = rng.randint(1, 64, shape)
        g[..., 3] = rng.randint(0, 4, shape)
        return g
    return grid((Hp // 8, Wp // 4)), grid((Hp // 4, Wp // 8))


def _smooth_planes(rng, B, Hp, Wp, bpp):
    base = rng.randint(0, 1 << bpp, (B, 1, 1))
    walk = np.cumsum(rng.randint(-2, 3, (B, Hp, Wp)), axis=2) // 3
    return np.clip(base + walk, 0, (1 << bpp) - 1).astype(np.int32)


def _lf_inputs(which, bpp=8):
    """(planes [B, Hp, Wp], V, H, sb_rows, sb_cols, sbwx, sbwy, bpp) on
    2x3 superblocks: a real keyframe's Y and U+V with all-4x4
    transforms (dense 4px-offset edges), or smooth seeded planes under
    random grids (off-grid edges everywhere, writes into the padding at
    the frame's edges)."""
    if which.startswith("key"):
        s, planes, (Vy, Hy, Vu, Hu) = _prefilter_planes(
            dict(w=192, h=128, seed=20, filter_level=40, txfmmode=0))
        if which == "key_y":
            return planes[0][None], Vy, Hy, 2, 3, 64, 64, 8
        return np.stack(planes[1:]), Vu, Hu, 2, 3, 32, 32, 8
    rng = np.random.RandomState({"rand_y": 7, "rand_uv": 8}[which] + bpp)
    B, sx, sy = (1, 64, 64) if which == "rand_y" else (2, 32, 32)
    V, H = _random_grids(rng, 2 * sy, 3 * sx)
    return _smooth_planes(rng, B, 2 * sy, 3 * sx, bpp), V, H, 2, 3, sx, \
        sy, bpp


@pytest.mark.parametrize("which", ["key_y", "key_uv", "rand_y", "rand_uv"])
def test_lf_dense_plain_matches_jax(which):
    planes, V, H, *geo = _lf_inputs(which)
    assert (V[:, 1::2, 0] > 0).any() and (H[1::2, :, 0] > 0).any()
    want = JD.lf_dense(jnp.asarray(planes), jnp.asarray(V), jnp.asarray(H),
                       *geo)
    got = PD.lf_dense(torch.from_numpy(planes), torch.from_numpy(V),
                      torch.from_numpy(H), *geo)
    _same(want, got)
    assert (np.asarray(want) != planes).any()


@pytest.mark.parametrize("plane", ["y", "uv"])
def test_lf_dense_plain_matches_jax_par_on_8px_grid(plane):
    """Where JAX lf_dense_par applies (no 4px-offset edge), the port's
    one serial filter equals it too."""
    s, planes, (Vy, Hy, Vu, Hu) = _prefilter_planes(
        dict(w=448, h=128, seed=22, filter_level=63))
    if plane == "y":
        pl, V, H, geo = planes[0][None], Vy, Hy, (2, 7, 64, 64, 8)
    else:
        pl, V, H, geo = np.stack(planes[1:]), Vu, Hu, (2, 7, 32, 32, 8)
    V, H = V.copy(), H.copy()
    V[:, 1::2] = 0      # drop the 4px-offset positions
    H[1::2] = 0
    want = JD.lf_dense_par(jnp.asarray(pl), jnp.asarray(V), jnp.asarray(H),
                           *geo)
    got = PD.lf_dense(torch.from_numpy(pl), torch.from_numpy(V),
                      torch.from_numpy(H), *geo)
    _same(want, got)
    assert (np.asarray(want) != pl).any()


def test_dense_params_matches_jax():
    rng = np.random.RandomState(3)
    Hp, Wp, n = 128, 192, 300
    recs = np.zeros((n + 5, 8), np.int32)
    recs[:n, 3] = rng.randint(0, 2, n)
    v = recs[:n, 3] == 0
    recs[:n, 1] = np.where(v, rng.randint(0, Hp // 8, n) * 8,
                           rng.randint(0, Hp // 4, n) * 4)
    recs[:n, 2] = np.where(v, rng.randint(0, Wp // 4, n) * 4,
                           rng.randint(0, Wp // 8, n) * 8)
    recs[:, 4:8] = rng.randint(1, 60, (n + 5, 4))
    for a, b in zip(JD.dense_params(recs, n, Hp, Wp),
                    PD.dense_params(recs, n, Hp, Wp)):
        _same(a, b)


def test_lf_dense_on_the_card_goes_to_the_kernel(monkeypatch):
    """Planes off the CPU go to the kernel launch (which raises here),
    never to the plain version; the counter moves only on a launch."""
    calls = []

    def no_card(source, signatures, name, *args):
        calls.append(name)
        raise RuntimeError("no card")

    monkeypatch.setattr(_cuda, "launch", no_card)
    monkeypatch.setattr(PD, "lf_dense_plain", None)
    PD.reset_launches()
    meta = dict(dtype=torch.int32, device="meta")
    pl = torch.zeros((2, 64, 96), **meta)
    V = torch.zeros((8, 24, 4), **meta)
    H = torch.zeros((16, 12, 4), **meta)
    with pytest.raises(RuntimeError, match="no card"):
        PD.lf_dense(pl, V, H, 2, 3, 32, 32, 8)
    with pytest.raises(TypeError):
        PD.lf_dense(pl.to(torch.int16), V, H, 2, 3, 32, 32, 8)
    with pytest.raises(ValueError):
        PD.lf_dense(pl, V[:4], H, 2, 3, 32, 32, 8)
    assert calls == ["lpf_frame"]
    assert PD.LAUNCHES == {"lf_dense": 0}


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    PD.reset_launches()
    for which, bpp in (("rand_y", 10), ("rand_uv", 12)):
        planes, V, H, *geo = _lf_inputs(which, bpp)
        args = [torch.from_numpy(a) for a in (planes, V, H)]
        want = PD.lf_dense_plain(*args, *geo)
        got = PD.lf_dense(*(a.cuda() for a in args), *geo)
        assert torch.equal(got.cpu(), want), which
    # 2x3 superblocks: waves 0..4, each with at least one superblock
    assert PD.LAUNCHES["lf_dense"] == 10
