"""The loop-filter parameter grids of the port (ops/lpf_masks.py
grids_device, its kernel csrc/lf_grids.cu) against the JAX package's
ops/lpf_masks.py grids_device on the same pass-A levels and masks
(CPU-JAX, as tests/conftest.py sets it). Every comparison is exact,
dtypes included.

The kernel runs only on the card, so `_lf_grids_model` below restates
its per-thread arithmetic in numpy (a thread per output quad of the four
grids in their final order: its grid, superblock and position, the mask
bits and level cell it reads, the decision it takes) and is held to the
JAX function here; a `cuda` test holds the kernel to the plain version
on the card."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ffmpeg_hybrid_tpu.ops import lpf_masks as JM
from ffmpeg_hybrid_tpu_torch.ops import _cuda
from ffmpeg_hybrid_tpu_torch.ops import lpf_masks as PM

from test_torch_lpf import GRID_CASES, _keyframe_state


SUBSAMPLINGS = [(1, 1), (1, 0), (0, 1), (0, 0)]


def random_buffers(seed, sb_rows=2, sb_cols=3):
    """Levels and masks drawn at random: a keyframe's levels are the same
    over the frame, so only these show which level cell an edge reads
    (the column and row pairs under subsampling); masks dense enough
    that every class meets every other."""
    rng = np.random.RandomState(seed)
    nSB = sb_rows * sb_cols
    lfl = rng.randint(0, 64, nSB * 64).astype(np.int16)
    lfm = (rng.randint(0, 256, nSB * 128)
           & rng.randint(0, 256, nSB * 128)).astype(np.int32)
    luts = rng.randint(0, 256, 128).astype(np.int32)
    return lfl, lfm, luts


def _jax_grids(bufs, geo):
    return [np.asarray(a) for a in JM.grids_device(
        *(jnp.asarray(b) for b in bufs), *geo)]


@pytest.fixture(scope="module")
def grid_inputs():
    """Per GRID_CASES entry (all four subsamplings, odd sizes, every
    transform size), then random levels and masks under each
    subsampling: the upload buffers, the geometry and JAX's grids."""
    out = []
    for case in GRID_CASES:
        kw = dict(case)
        w, h = kw.pop("w"), kw.pop("h")
        s = _keyframe_state(w, h, **kw)
        bufs = PM.lf_buffers(s)
        geo = (s.sb_rows, s.sb_cols, s.header.ss_h, s.header.ss_v)
        out.append((bufs, geo, _jax_grids(bufs, geo)))
    for k, ss in enumerate(SUBSAMPLINGS):
        bufs = random_buffers(k)
        geo = (2, 3, *ss)
        out.append((bufs, geo, _jax_grids(bufs, geo)))
    return out


IDS = [f"s{c['seed']}" for c in GRID_CASES] + [
    f"random-ss{h}{v}" for h, v in SUBSAMPLINGS]


@pytest.mark.parametrize("k", range(len(IDS)), ids=IDS)
def test_wrapper_on_cpu_matches_jax(k, grid_inputs):
    """CPU tensors take the plain version, equal to JAX's in shape,
    dtype and value, in grid_shapes(); nothing counts a launch."""
    bufs, geo, want = grid_inputs[k]
    PM.reset_launches()
    got = PM.grids_device(*(torch.from_numpy(b) for b in bufs), *geo)
    assert [tuple(g.shape) for g in got] == PM.grid_shapes(*geo)
    for a, b in zip(want, got):
        assert a.dtype == np.int32 and b.dtype == torch.int32
        assert np.array_equal(a, b.numpy()), np.argwhere(a != b.numpy())[:4]
    assert PM.LAUNCHES == {"lf_grids": 0}


def _lf_grids_model(lfl, lfm, luts, sb_rows, sb_cols, ss_h, ss_v):
    """The kernel's threads in numpy, all at once: thread idx walks the
    segments Vy, Hy, Vu, Hu (each rows x cols quads, row-major), takes
    its grid row and column, its superblock and position, reads its mask
    words and level cells and writes (wd, mblim[L], lim[L], L >> 4), or
    zeros where wd == 0."""
    level = lfl.astype(np.int64)
    masks = lfm.astype(np.int64)
    lim, mblim = luts[:64].astype(np.int64), luts[64:].astype(np.int64)

    def quads(wd, L):
        par = np.stack([wd, mblim[L & 63], lim[L & 63], L >> 4], -1)
        return np.where((wd > 0)[:, None], par, 0).astype(np.int32)

    def v_grid(sh, sv, mset):
        Rv, Cv = 8 >> sv, 16 >> sh
        idx = np.arange(sb_rows * Rv * sb_cols * Cv)
        gr, gc = idx // (sb_cols * Cv), idx % (sb_cols * Cv)
        sb = gr // Rv * sb_cols + gc // Cv
        r, cp = gr % Rv, gc % Cv
        cx = cp if sh else cp >> 1
        lc = (cx & ~1) if sh else cx
        ra = (r >> 1) * (2 << sv)
        rb = ra + 1 + sv

        def bit(row, cls):
            return (masks[sb * 128 + mset * 64 + row * 4 + cls] >> cx) & 1

        def lev(row):
            return level[sb * 64 + row * 8 + lc]

        k0a, k1a, k2a = bit(ra, 0), bit(ra, 1), bit(ra, 2)
        k0b, k1b, k2b = bit(rb, 0), bit(rb, 1), bit(rb, 2)
        top = np.where(k0a == 1, 16, np.where(k1a == 1, 8,
                                              np.where(k2a == 1, 4, 0)))
        bot = np.where(k0a == 1, np.where(k0b == 1, 16, 0),
                       np.where(k1b == 1, 8, np.where(k2b == 1, 4, 0)))
        odd = r & 1
        wd = np.where(odd, bot, top)
        L = np.where(odd & ~(k0a & k0b), lev(rb), lev(ra))
        if not sh:
            row = np.where(odd, rb, ra)
            off = (cp & 1) == 1
            wd = np.where(off, bit(row, 3) * 4, wd)
            L = np.where(off, lev(row), L)
        wd = np.where(gc == 0, 0, wd)
        return quads(wd, L).reshape(sb_rows * Rv, sb_cols * Cv, 4)

    def h_grid(sh, sv, mset):
        Rh, Ch = 16 >> sv, 8 >> sh
        idx = np.arange(sb_rows * Rh * sb_cols * Ch)
        gr, gc = idx // (sb_cols * Ch), idx % (sb_cols * Ch)
        sb = gr // Rh * sb_cols + gc // Ch
        rp, c = gr % Rh, gc % Ch
        row = rp if sv else rp >> 1
        lr = (row & ~1) if sv else row
        bl = (c >> 1) * (2 << sh)
        br = bl + 1 + sh

        def bit(col, cls):
            return (masks[sb * 128 + mset * 64 + 32 + row * 4 + cls]
                    >> col) & 1

        def lev(col):
            return level[sb * 64 + lr * 8 + col]

        k0l, k1l, k2l = bit(bl, 0), bit(bl, 1), bit(bl, 2)
        k0r, k1r, k2r = bit(br, 0), bit(br, 1), bit(br, 2)
        left = np.where(k0l == 1, 16, np.where(k1l == 1, 8,
                                               np.where(k2l == 1, 4, 0)))
        right = np.where(k0l == 1, np.where(k0r == 1, 16, 0),
                         np.where((k0r | k1r | k2r) == 1,
                                  np.where(k1r == 1, 8, 4), 0))
        odd = c & 1
        wd = np.where(odd, right, left)
        L = np.where(odd & ~(k0l & k0r), lev(br), lev(bl))
        if not sv:
            col = np.where(odd, br, bl)
            off = (rp & 1) == 1
            wd = np.where(off, bit(col, 3) * 4, wd)
            L = np.where(off, lev(col), L)
        wd = np.where(gr == 0, 0, wd)
        return quads(wd, L).reshape(sb_rows * Rh, sb_cols * Ch, 4)

    uv = 1 if (ss_h | ss_v) else 0
    return [v_grid(0, 0, 0), h_grid(0, 0, 0), v_grid(ss_h, ss_v, uv),
            h_grid(ss_h, ss_v, uv)]


@pytest.mark.parametrize("k", range(len(IDS)), ids=IDS)
def test_kernel_model_matches_jax(k, grid_inputs):
    bufs, geo, want = grid_inputs[k]
    got = _lf_grids_model(*bufs, *geo)
    for a, b in zip(want, got):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(a, b), np.argwhere(a != b)[:4]


def test_cases_reach_every_decision(grid_inputs):
    """Across the cases, each of the four grids holds every width, and
    the 4 px offset positions (odd V columns, odd H rows, where they
    exist) hold edges."""
    widths = [set() for _ in range(4)]
    offsets = [0, 0]
    for _bufs, (_r, _c, ss_h, ss_v), want in grid_inputs:
        for k, g in enumerate(want):
            widths[k] |= set(np.unique(g[..., 0]).tolist())
        offsets[0] += int((want[0][:, 1::2, 0] == 4).sum())
        offsets[1] += int((want[1][1::2, :, 0] == 4).sum())
        if not ss_h:
            offsets[0] += int((want[2][:, 1::2, 0] == 4).sum())
    assert all(w == {0, 4, 8, 16} for w in widths), widths
    assert all(offsets), offsets


def _meta_inputs(sb_rows, sb_cols):
    meta = dict(device="meta")
    nSB = sb_rows * sb_cols
    return (torch.zeros(nSB * 64, dtype=torch.int16, **meta),
            torch.zeros(nSB * 128, dtype=torch.int32, **meta),
            torch.zeros(128, dtype=torch.int32, **meta))


def test_wrapper_off_cpu_goes_to_the_kernel(monkeypatch):
    """Tensors off the CPU reach one launch of csrc/lf_grids.cu for both
    plane sets, with the outputs in grid_shapes() as int32, never the
    plain version; wrong dtypes, shapes and subsamplings raise before any
    launch; the counter moves only on a launch."""
    calls = []

    def no_card(source, signatures, name, *args):
        calls.append(name)
        raise RuntimeError("no card")

    def recorded(source, signatures, name, *args):
        calls.append((source, name, args))

    monkeypatch.setattr(_cuda, "launch", no_card)
    monkeypatch.setattr(PM, "grids_device_plain", None)
    PM.reset_launches()
    lfl, lfm, luts = _meta_inputs(2, 3)
    with pytest.raises(RuntimeError, match="no card"):
        PM.grids_device(lfl, lfm, luts, 2, 3, 1, 1)
    with pytest.raises(TypeError):
        PM.grids_device(lfl.to(torch.int32), lfm, luts, 2, 3, 1, 1)
    with pytest.raises(TypeError):
        PM.grids_device(lfl, lfm.to(torch.int16), luts, 2, 3, 1, 1)
    with pytest.raises(ValueError):
        PM.grids_device(lfl, lfm[:-4], luts, 2, 3, 1, 1)
    with pytest.raises(ValueError):
        PM.grids_device(lfl, lfm, luts[:64], 2, 3, 1, 1)
    with pytest.raises(ValueError):
        PM.grids_device(lfl, lfm, luts, 3, 3, 1, 1)
    with pytest.raises(ValueError):
        PM.grids_device(lfl, lfm, luts, 2, 3, 1, 2)
    assert calls == ["lf_grids"]
    assert PM.LAUNCHES == {"lf_grids": 0}
    calls.clear()
    monkeypatch.setattr(_cuda, "launch", recorded)
    for n, ss in enumerate(((1, 1), (1, 0), (0, 1), (0, 0))):
        outs = PM.grids_device(lfl, lfm, luts, 2, 3, *ss)
        source, name, args = calls[n]
        assert (source, name) == ("lf_grids.cu", "lf_grids")
        assert args[0] is lfl and args[1] is lfm and args[2] is luts
        assert all(a is b for a, b in zip(args[3:7], outs))
        assert [tuple(o.shape) for o in outs] == PM.grid_shapes(2, 3, *ss)
        assert all(o.dtype == torch.int32 for o in outs)
        assert args[7:] == (2, 3, *ss)
    assert PM.LAUNCHES == {"lf_grids": 4}


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(grid_inputs):
    """csrc/lf_grids.cu on the card against the plain version on every
    case: one launch a call, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for bufs, geo, _want in grid_inputs:
        want = PM.grids_device_plain(*(torch.from_numpy(b) for b in bufs),
                                     *geo)
        PM.reset_launches()
        got = PM.grids_device(*(torch.from_numpy(b).cuda() for b in bufs),
                              *geo)
        assert PM.LAUNCHES == {"lf_grids": 1}
        for a, b in zip(want, got):
            assert b.dtype == torch.int32 and torch.equal(a, b.cpu()), geo
