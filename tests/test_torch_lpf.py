"""The port's loop filter (ffmpeg_hybrid_tpu_torch/ops/lpf_masks.py,
ops/lpf_dense.py) against the JAX package's ops/lpf_masks.py,
ops/lpf_dense.py and ops/lpf_tpu.py on the same numpy inputs (CPU-JAX,
as tests/conftest.py sets it), and the CUDA kernel (csrc/lpf.cu)
against the plain version on the card. Every comparison is exact. The
frame entry lf_frame_ on the keyframes whose lf_dense shapes no other
test compiles is test_torch_lpf_frame.py, which reads this file's cases
and helpers."""
import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from test_torch_threads import one_torch_thread  # noqa: F401

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


def _closure(table):
    """Per ticket, the bit set of the tickets it waits for, directly or
    through others (bit k = ticket k)."""
    by_flag = {int(row[3]): t for t, row in enumerate(table)}
    anc = []
    for t, row in enumerate(table):
        bits = 0
        for dep in row[4:6]:
            if dep >= 0:
                k = by_flag[int(dep)]
                assert k < t, (t, k)        # topological: earlier tickets
                bits |= anc[k] | (1 << k)
        anc.append(bits)
    return anc


@pytest.mark.parametrize("rows,cols", [(1, 1), (1, 6), (5, 1), (17, 30),
                                       (3, 7), (4, 4), (9, 2)])
@pytest.mark.parametrize("nsets", [1, 2])
def test_schedule_orders_every_overlapping_pair(rows, cols, nsets):
    """The kernel's ticket table: every SB of every set once, its own flag,
    each wait on an earlier ticket of its set, waves of 2r + c in order;
    and every earlier SB whose window overlaps its own (a neighbour)
    among the tickets it waits for, transitively."""
    table = PD.schedule(rows, cols, nsets)
    assert table.dtype == np.int32 and table.shape == (nsets * rows * cols, 8)
    s, r, c, own, _d0, _d1, wave, _z = table.T
    assert sorted(zip(s, r, c)) == [(k, i, j) for k in range(nsets)
                                    for i in range(rows) for j in range(cols)]
    assert np.array_equal(own, (s * rows + r) * cols + c)
    assert np.array_equal(wave, 2 * r + c) and (np.diff(wave) >= 0).all()
    anc = _closure(table)
    for t in range(len(table)):
        for k in range(t):
            if s[k] == s[t] and abs(int(r[k]) - int(r[t])) <= 1 \
                    and abs(int(c[k]) - int(c[t])) <= 1:
                assert anc[t] >> k & 1, (table[t], table[k])
            if s[k] != s[t]:
                assert not anc[t] >> k & 1
        # at most the two flags of the header, and not more than needed
        deps = [d for d in table[t, 4:6] if d >= 0]
        assert len(deps) == int(c[t] > 0) + int(r[t] > 0)


def _replay(sets, sb_rows, sb_cols, bpp):
    """What csrc/lpf.cu does, with the plain per-edge math: superblocks
    in the order of PD.schedule, each filtered in its window (the SB plus
    8 px all round, zeros outside the plane), V positions then H
    positions, after which only rows y0-8 .. y0+sbwy+3 and columns
    x0-8 .. x0+sbwx+3 inside the plane are written back. sets: [(planes
    [B, Hp, Wp], V, H, sbwx, sbwy)] torch. Returns the filtered planes."""
    outs = [p.clone() for p, *_ in sets]
    table = PD.schedule(sb_rows, sb_cols, len(sets))
    for k, r, c, *_ in table.tolist():
        _p, V, H, sx, sy = sets[k]
        out = outs[k]
        B, Hp, Wp = out.shape
        y0, x0 = r * sy - 8, c * sx - 8     # window origin in the plane
        ya, yb = max(y0, 0), min(y0 + sy + 16, Hp)
        xa, xb = max(x0, 0), min(x0 + sx + 16, Wp)
        win = torch.zeros((B, sy + 16, sx + 16), dtype=out.dtype)
        win[:, ya - y0:yb - y0, xa - x0:xb - x0] = out[:, ya:yb, xa:xb]
        nbv, npv = sy // 8, sx // 4
        for t in range(npv):
            sub = win[:, 8:8 + sy, 4 * t:4 * t + 16].reshape(B * nbv, 8, 16)
            par = V[r * nbv:(r + 1) * nbv, c * npv + t].repeat(B, 1)
            win[:, 8:8 + sy, 4 * t:4 * t + 16] = PD._apply_sub2(
                sub, par, bpp)[0].reshape(B, sy, 16)
        nph, nbh = sy // 4, sx // 8
        for t in range(nph):
            sub = win[:, 4 * t:4 * t + 16, 8:8 + sx].reshape(
                B, 16, nbh, 8).permute(0, 2, 3, 1).reshape(B * nbh, 8, 16)
            par = H[r * nph + t, c * nbh:(c + 1) * nbh].repeat(B, 1)
            win[:, 4 * t:4 * t + 16, 8:8 + sx] = PD._apply_sub2(
                sub, par, bpp)[0].reshape(B, nbh, 8, 16).permute(
                    0, 3, 1, 2).reshape(B, 16, sx)
        yb, xb = min(y0 + sy + 12, Hp), min(x0 + sx + 12, Wp)
        out[:, ya:yb, xa:xb] = win[:, ya - y0:yb - y0, xa - x0:xb - x0]
    return outs


@pytest.mark.parametrize("which,bpp", [
    ("key_y", 8), ("key_uv", 8), ("rand_y", 8), ("rand_uv", 8),
    ("rand_y", 10), ("rand_uv", 10), ("rand_y", 12), ("rand_uv", 12)])
def test_schedule_replay_matches_plain_and_jax(which, bpp):
    """Superblock by superblock in ticket order, in windows, equals the
    wave-by-wave lf_dense_plain and the JAX package's lf_dense."""
    planes, V, H, R, C, sx, sy, bpp = _lf_inputs(which, bpp)
    pl, Vt, Ht = (torch.from_numpy(a) for a in (planes, V, H))
    (got,) = _replay([(pl, Vt, Ht, sx, sy)], R, C, bpp)
    want = PD.lf_dense_plain(pl, Vt, Ht, R, C, sx, sy, bpp)
    assert torch.equal(got, want)
    if bpp == 8:    # the shapes test_lf_dense_plain_matches_jax compiles
        _same(JD.lf_dense(jnp.asarray(planes), jnp.asarray(V),
                          jnp.asarray(H), R, C, sx, sy, bpp), got)
    assert (got != pl).any()


def test_schedule_replay_two_sets_interleaved():
    """Y and U+V in one ticket table, as the frame's launch takes them."""
    sets, wants = [], []
    for which in ("key_y", "key_uv"):
        planes, V, H, R, C, sx, sy, bpp = _lf_inputs(which)
        args = [torch.from_numpy(a) for a in (planes, V, H)]
        sets.append((*args, sx, sy))
        wants.append(PD.lf_dense_plain(*args, R, C, sx, sy, bpp))
    for got, want in zip(_replay(sets, R, C, bpp), wants):
        assert torch.equal(got, want)


def lf_frame_case(case):
    """lf_frame_ on CPU planes (its plain version) filters Y and U+V in
    place, equal to the JAX package's lf_dense on Y and on stacked U+V,
    for 4:2:0, 4:4:4, 4:2:2 and 4:4:0 keyframes. The cases whose
    lf_dense shapes no other test here compiles are
    test_torch_lpf_frame.py's."""
    s, planes, (Vy, Hy, Vu, Hu) = _prefilter_planes(case)
    hd = s.header
    y, u, v = (torch.from_numpy(p.copy()) for p in planes)
    ptrs = [p.data_ptr() for p in (y, u, v)]
    assert PD.lf_frame_(y, u, v, *(torch.from_numpy(g) for g in (
        Vy, Hy, Vu, Hu)), s.sb_rows, s.sb_cols, hd.ss_h, hd.ss_v, 8) is None
    assert [p.data_ptr() for p in (y, u, v)] == ptrs
    want_y = JD.lf_dense(jnp.asarray(planes[0][None]), jnp.asarray(Vy),
                         jnp.asarray(Hy), s.sb_rows, s.sb_cols, 64, 64, 8)
    want_uv = JD.lf_dense(jnp.asarray(np.stack(planes[1:])), jnp.asarray(Vu),
                          jnp.asarray(Hu), s.sb_rows, s.sb_cols,
                          64 >> hd.ss_h, 64 >> hd.ss_v, 8)
    _same(want_y, y[None])
    _same(want_uv, torch.stack([u, v]))


# lf_frame_ cases here: those whose Y and U+V shapes the lf_dense tests
# above have compiled already, and 4:2:2 (seed 32); the rest,
# LF_FRAME_ALONE, are test_torch_lpf_frame.py's
LF_FRAME_ALONE = (2, 31, 33)


@pytest.mark.parametrize(
    "case", [c for c in GRID_CASES if c["seed"] not in LF_FRAME_ALONE],
    ids=lambda c: f"s{c['seed']}")
def test_lf_frame_plain_filters_in_place_like_jax(case):
    lf_frame_case(case)


def test_lf_frame_plain_skips_the_sets_not_asked_for():
    s, planes, grids = _prefilter_planes(GRID_CASES[2])
    hd = s.header
    for do_y, do_uv in ((True, False), (False, True), (False, False)):
        y, u, v = (torch.from_numpy(p.copy()) for p in planes)
        PD.lf_frame_(y, u, v, *(torch.from_numpy(g) for g in grids),
                     s.sb_rows, s.sb_cols, hd.ss_h, hd.ss_v, 8, do_y, do_uv)
        assert (y.numpy() != planes[0]).any() == do_y
        assert (u.numpy() != planes[1]).any() == do_uv
        assert np.array_equal(v.numpy(), planes[2]) != do_uv


def _meta_frame():
    meta = dict(dtype=torch.int32, device="meta")
    y = torch.zeros((128, 192), **meta)
    u, v = torch.zeros((64, 96), **meta), torch.zeros((64, 96), **meta)
    grids = (torch.zeros((16, 48, 4), **meta), torch.zeros((32, 24, 4), **meta),
             torch.zeros((8, 24, 4), **meta), torch.zeros((16, 12, 4), **meta))
    return y, u, v, grids


def test_lf_dense_on_the_card_goes_to_the_kernel(monkeypatch):
    """Planes off the CPU go to one kernel launch per call (which raises
    here, or is recorded), never to the plain version: lf_dense with its
    one plane set, lf_frame_ with the sets asked for; wrong dtypes,
    shapes, spans and layouts raise before any launch; the counter moves
    only on a launch."""
    calls = []

    def no_card(source, signatures, name, *args):
        calls.append((name, args[8]))
        raise RuntimeError("no card")

    def recorded(source, signatures, name, *args):
        calls.append((name, args[8]))

    monkeypatch.setattr(_cuda, "launch", no_card)
    monkeypatch.setattr(PD, "lf_dense_plain", None)
    monkeypatch.setattr(PD, "lf_frame_plain_", None)
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
    with pytest.raises(ValueError):
        PD.lf_dense(pl[:, :, :72], V[:, :18], H[:, :9], 2, 3, 24, 32, 8)
    y, u, v, grids = _meta_frame()
    with pytest.raises(RuntimeError, match="no card"):
        PD.lf_frame_(y, u, v, *grids, 2, 3, 1, 1, 8)
    with pytest.raises(ValueError):
        PD.lf_frame_(y, u.t(), v, *grids, 2, 3, 1, 1, 8)
    with pytest.raises(ValueError):
        PD.lf_frame_(y, u, v, *grids, 2, 3, 1, 1, 9)
    assert calls == [("lpf_frame", 1), ("lpf_frame", 2)]
    assert PD.LAUNCHES == {"lf_dense": 0}
    calls.clear()
    monkeypatch.setattr(_cuda, "launch", recorded)
    PD.lf_frame_(y, u, v, *grids, 2, 3, 1, 1, 8)
    PD.lf_frame_(y, u, v, *grids, 2, 3, 1, 1, 8, do_uv=False)
    PD.lf_frame_(y, u, v, *grids, 2, 3, 1, 1, 8, do_y=False)
    PD.lf_frame_(y, u, v, *grids, 2, 3, 1, 1, 8, do_y=False, do_uv=False)
    assert PD.lf_dense(pl, V, H, 2, 3, 32, 32, 8).shape == pl.shape
    assert calls == [("lpf_frame", n) for n in (2, 1, 1, 1)]
    assert PD.LAUNCHES == {"lf_dense": 4}


def test_kernel_state_takes_a_new_epoch_per_launch(monkeypatch):
    """The flags need no reset: each launch of a geometry passes an epoch
    above every earlier one, on one cached table and state per (device,
    geometry, number of sets) in the caller's store; at the wrap the state
    is cleared. A call without a store gets a fresh state of its own."""
    epochs, tables = [], set()

    def recorded(source, signatures, name, *args):
        table, state, epoch = args[12], args[14], args[15]
        tables.add((table.data_ptr(), state.data_ptr(), tuple(state.shape)))
        epochs.append(epoch)

    monkeypatch.setattr(_cuda, "launch", recorded)
    y, u, v, grids = _meta_frame()
    store = {}
    for _ in range(3):
        PD.lf_frame_(y, u, v, *grids, 2, 3, 1, 1, 8, schedules=store)
    assert epochs == [1, 2, 3] and len(tables) == 1
    assert tables.pop()[2] == (2 * 2 * 3 + 2,)
    sch = store[(y.device, 2, 3, 2)]
    sch.epoch = 0x7fffffff
    assert sch.next_epoch() == 1
    made = []
    monkeypatch.setattr(PD, "_Schedule", lambda *a: made.append(a) or sch)
    for _ in range(2):
        PD.lf_frame_(y, u, v, *grids, 2, 3, 1, 1, 8)
    assert len(made) == 2


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """lf_dense and lf_frame_ on the card against the plain versions, at
    10 and 12 bpp; twenty launches of one input give one result; one
    launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for which, bpp in (("rand_y", 10), ("rand_uv", 12)):
        planes, V, H, *geo = _lf_inputs(which, bpp)
        args = [torch.from_numpy(a) for a in (planes, V, H)]
        want = PD.lf_dense_plain(*args, *geo)
        dev = [a.cuda() for a in args]
        for _ in range(20):
            PD.reset_launches()
            got = PD.lf_dense(*dev, *geo)
            assert PD.LAUNCHES["lf_dense"] == 1
            assert torch.equal(got.cpu(), want), which
    for case in GRID_CASES:
        s, planes, grids = _prefilter_planes(case)
        hd = s.header
        want = [torch.from_numpy(p.copy()) for p in planes]
        PD.lf_frame_plain_(*want, *(torch.from_numpy(g) for g in grids),
                           s.sb_rows, s.sb_cols, hd.ss_h, hd.ss_v, 8)
        gd = [torch.from_numpy(g).cuda() for g in grids]
        for _ in range(5):
            yuv = [torch.from_numpy(p).cuda() for p in planes]
            PD.reset_launches()
            PD.lf_frame_(*yuv, *gd, s.sb_rows, s.sb_cols, hd.ss_h, hd.ss_v,
                         8)
            assert PD.LAUNCHES["lf_dense"] == 1
            for got, w in zip(yuv, want):
                assert torch.equal(got.cpu(), w), case
