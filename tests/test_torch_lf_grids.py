"""The loop-filter parameter grids of the port (ops/lpf_masks.py
grids_device, its kernel csrc/lf_grids.cu) against the JAX package's
ops/lpf_masks.py grids_device on the same pass-A levels and masks
(CPU-JAX, as tests/conftest.py sets it). Every comparison is exact,
dtypes included.

The kernel runs only on the card, so `_lf_grids_model` below restates
its blocks in numpy (a block per run of superblocks along a row: the
words it stages in shared memory and the slots they land in, then its
threads' items in the store order, each item's superblock and position,
the mask bits and level cell it reads from the staged words, the
decision it takes and the address it writes) and is held to the JAX
function here; a `cuda` test holds the kernel to the plain version on
the card."""
import os
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu.ops import lpf_masks as JM
from ffmpeg_hybrid_tpu_torch.ops import _cuda
from ffmpeg_hybrid_tpu_torch.ops import lpf_masks as PM

from test_torch_lpf import GRID_CASES, _keyframe_state


SUBSAMPLINGS = [(1, 1), (1, 0), (0, 1), (0, 0)]
# superblock grids of one row or one column (geometry, subsampling)
THIN = [((1, 5), (1, 1)), ((4, 1), (0, 0)), ((1, 1), (1, 0))]
LF_GRIDS_CU = os.path.join(os.path.dirname(__file__), "..",
                           "ffmpeg_hybrid_tpu_torch", "csrc", "lf_grids.cu")


def _constant(name):
    """A constexpr int of csrc/lf_grids.cu, as the kernel is built."""
    with open(LF_GRIDS_CU) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


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
    for k, (rc, ss) in enumerate(THIN):
        bufs = random_buffers(10 + k, *rc)
        geo = (*rc, *ss)
        out.append((bufs, geo, _jax_grids(bufs, geo)))
    return out


IDS = [f"s{c['seed']}" for c in GRID_CASES] + [
    f"random-ss{h}{v}" for h, v in SUBSAMPLINGS] + [
    f"thin{r}x{c}-ss{h}{v}" for (r, c), (h, v) in THIN]


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
    """The kernel's blocks in numpy. Block (bx, sbr) takes the run of
    kSbRun superblocks from column bx * kSbRun of superblock row sbr (n
    of them, fewer at the row's end) and stages, slot w of kStageSlots
    per thread, its n * 64 levels (slots 0..), n * 128 mask words (from
    kSbRun * 64) and the 128 LUT words (from kSbRun * 192) as the table
    (mblim, lim); then item i of each grid (Vy, Hy, Vu, Hu; R rows and C
    columns a superblock) is thread i % kThreads's, at row r = i / (n *
    C) and run column x = i % (n * C), written at grid row sbr * R + r,
    column bx * kSbRun * C + x. Every quad must be written exactly
    once."""
    run, nthreads = _constant("kSbRun"), _constant("kThreads")
    luts = luts.astype(np.int64)
    uv = 1 if (ss_h | ss_v) else 0
    sets = [(0, 0, 0), (ss_h, ss_v, uv)]
    dims = [(8 >> sv, 16 >> sh) if h == 0 else (16 >> sv, 8 >> sh)
            for sh, sv, _m in sets for h in (0, 1)]
    grids = [np.zeros((sb_rows * R, sb_cols * C, 4), np.int32)
             for R, C in dims]
    writes = [np.zeros(g.shape[:2], np.int64) for g in grids]
    words = run * (64 + 128) + 128
    slots = -(-words // nthreads)
    for sbr in range(sb_rows):
        for bx in range(-(-sb_cols // run)):
            sbc0 = bx * run
            n = min(run, sb_cols - sbc0)
            sb0 = sbr * sb_cols + sbc0
            lev = np.zeros(run * 64, np.int64)
            msk = np.zeros(run * 128, np.int64)
            tab = np.zeros((64, 2), np.int64)
            for w in range(nthreads * slots):
                if w < run * 64:
                    if w < n * 64:
                        lev[w] = lfl[sb0 * 64 + w]
                elif w < run * 192:
                    if w - run * 64 < n * 128:
                        msk[w - run * 64] = lfm[sb0 * 128 + w - run * 64]
                elif w < run * 192 + 128:
                    lw = w - run * 192
                    tab[lw % 64, 0 if lw >= 64 else 1] = luts[lw]
            for g, ((sh, sv, mset), h) in enumerate(
                    (st, h) for st in sets for h in (0, 1)):
                R, C = dims[g]
                i = np.arange(R * n * C)
                r, x = i // (n * C), i % (n * C)
                sbl, c = x // C, x % C
                m = msk.reshape(run, 128)[sbl, mset * 64:mset * 64 + 64]
                lv = lev.reshape(run, 64)[sbl]
                gr, gc = sbr * R + r, sbc0 * C + x
                wd, L = (_h_item if h else _v_item)(m, lv, r, c, sh, sv)
                wd = np.where((gr if h else gc) == 0, 0, wd)
                par = np.stack([wd, tab[L & 63, 0], tab[L & 63, 1], L >> 4],
                               -1)
                grids[g][gr, gc] = np.where((wd > 0)[:, None], par, 0)
                np.add.at(writes[g], (gr, gc), 1)
    assert all((w == 1).all() for w in writes)
    return grids


def _v_item(m, lev, r, cp, sh, sv):
    """(wd, level) of V items at superblock rows r, columns cp, from
    each item's staged mask words m [.., 64] (cols then rows) and levels
    lev [.., 64]."""
    cx = cp if sh else cp >> 1
    lc = (cx & ~1) if sh else cx
    ra = (r >> 1) * (2 << sv)
    rb = ra + 1 + sv
    k = np.arange(len(r))

    def bit(row, cls):
        return (m[k, row * 4 + cls] >> cx) & 1

    k0a, k1a, k2a = bit(ra, 0), bit(ra, 1), bit(ra, 2)
    k0b, k1b, k2b = bit(rb, 0), bit(rb, 1), bit(rb, 2)
    top = np.where(k0a == 1, 16, np.where(k1a == 1, 8,
                                          np.where(k2a == 1, 4, 0)))
    bot = np.where(k0a == 1, np.where(k0b == 1, 16, 0),
                   np.where(k1b == 1, 8, np.where(k2b == 1, 4, 0)))
    odd = r & 1
    wd = np.where(odd, bot, top)
    L = np.where(odd & ~(k0a & k0b), lev[k, rb * 8 + lc], lev[k, ra * 8 + lc])
    if not sh:
        row = np.where(odd, rb, ra)
        off = (cp & 1) == 1
        wd = np.where(off, bit(row, 3) * 4, wd)
        L = np.where(off, lev[k, row * 8 + lc], L)
    return wd, L


def _h_item(m, lev, rp, c, sh, sv):
    """(wd, level) of H items at superblock rows rp, columns c."""
    row = rp if sv else rp >> 1
    lr = (row & ~1) if sv else row
    bl = (c >> 1) * (2 << sh)
    br = bl + 1 + sh
    k = np.arange(len(rp))

    def bit(col, cls):
        return (m[k, 32 + row * 4 + cls] >> col) & 1

    k0l, k1l, k2l = bit(bl, 0), bit(bl, 1), bit(bl, 2)
    k0r, k1r, k2r = bit(br, 0), bit(br, 1), bit(br, 2)
    left = np.where(k0l == 1, 16, np.where(k1l == 1, 8,
                                           np.where(k2l == 1, 4, 0)))
    right = np.where(k0l == 1, np.where(k0r == 1, 16, 0),
                     np.where((k0r | k1r | k2r) == 1,
                              np.where(k1r == 1, 8, 4), 0))
    odd = c & 1
    wd = np.where(odd, right, left)
    L = np.where(odd & ~(k0l & k0r), lev[k, lr * 8 + br], lev[k, lr * 8 + bl])
    if not sv:
        col = np.where(odd, br, bl)
        off = (rp & 1) == 1
        wd = np.where(off, bit(col, 3) * 4, wd)
        L = np.where(off, lev[k, lr * 8 + col], L)
    return wd, L


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
