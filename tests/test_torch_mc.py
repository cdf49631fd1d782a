"""The inter pass of the port (ffmpeg_hybrid_tpu_torch/ops/recon.py
mc_planes, mc_planes_plain) around its CUDA kernel (csrc/mc.cu): the
plain version of a frame's three planes against the JAX package's
_recon_plane_inter per plane (CPU-JAX, as tests/conftest.py sets it); a
numpy model of the kernel's threads (the tile of 16 x 16 pixels, a cell's
16 threads, its patch and horizontal values in shared memory, the skip of
tiles without inter cells and of the second reference without compound
cells) held to the same function; the kernel's filter table; the
wrapper's choice between plain version and kernel; and, on a card, the
kernel against its plain version. Every comparison is exact."""
import os
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ffmpeg_hybrid_tpu.ops import recon_tpu as J
from ffmpeg_hybrid_tpu_torch.ops import _cuda
from ffmpeg_hybrid_tpu_torch.ops import recon as P
from ffmpeg_hybrid_tpu_torch.ops import recon_cuda as RC

MC_CU = os.path.join(os.path.dirname(__file__), "..", "ffmpeg_hybrid_tpu_torch",
                     "csrc", "mc.cu")
# a 4:2:0 frame: Y padded to 64 x 128, visible 125 x 61, so the chroma
# planes (32 x 64) show an odd 63 x 31
FRAME = {"H": 64, "W": 128, "w": 125, "h": 61}
# name: (largest |MV| in pixels, has_comp, missing reference, every cell
# inter and compound)
CASES = {"near": (12, True, False, False),
         "far": (150, True, False, False),
         "far_no_comp": (150, False, False, False),
         "missing_ref": (150, True, True, False),
         "all_compound": (150, True, False, True)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(want, got):
    a = np.asarray(want).astype(np.int64)
    b = got.cpu().numpy().astype(np.int64) if torch.is_tensor(got) \
        else np.asarray(got).astype(np.int64)
    assert a.shape == b.shape
    assert np.array_equal(a, b), np.argwhere(a != b)[:4]


def _residual_grids(rng, H, W):
    """Small coefficients with per-32x32 tx sizes, types and eobs."""
    coef = rng.randint(-600, 600, (H, W)).astype(np.int16)
    r4, c4 = H // 4, W // 4
    txsz = np.zeros((r4, c4), np.int32)
    for y in range(0, r4, 8):
        for x in range(0, c4, 8):
            txsz[y:y + 8, x:x + 8] = rng.randint(0, 4)
    txtype = rng.randint(0, 4, (r4, c4)).astype(np.int32)
    eob = rng.choice([0, 1, 3, 20], (r4, c4)).astype(np.int16)
    return coef, eob, txsz, txtype


def _frame(name, seed=0):
    """One case of CASES: per plane (Y, U, V) the JAX arguments of
    _recon_plane_inter (coefficients and grids) and the MC inputs,
    numpy. Cells that are not inter carry out-of-range refsel, filter
    and MV values."""
    px, has_comp, missing, all_comp = CASES[name]
    rng = np.random.RandomState(seed + sum(map(ord, name)))
    planes = []
    for i in range(3):
        sub = 1 if i else 0
        H, W = FRAME["H"] >> sub, FRAME["W"] >> sub
        w = (FRAME["w"] + sub) >> sub
        h = (FRAME["h"] + sub) >> sub
        mvs = 1 if i else 2
        r4, c4 = H // 4, W // 4
        refs = [rng.randint(0, 256, (H, W)).astype(np.int32)
                for _ in range(3)]
        if missing:
            refs[1] = refs[0]   # recon_frame's stand-in for an empty slot
        inter = np.ones((r4, c4), bool) if all_comp \
            else rng.rand(r4, c4) < 0.75
        comp = np.ones((r4, c4), bool) if all_comp else rng.rand(r4, c4) < 0.5
        lim = px * 16 // mvs
        mv16 = rng.randint(-lim, lim + 1, (r4, c4, 2, 2)).astype(np.int32)
        refsel = rng.randint(0, 3, (r4, c4, 2)).astype(np.int32)
        filt = rng.randint(0, 4, (r4, c4)).astype(np.int32)
        off = ~inter
        refsel[off] = rng.choice([-9, -1, 3, 7], (int(off.sum()), 2))
        filt[off] = rng.choice([-5, 4, 9], int(off.sum()))
        mv16[off] = rng.choice([-32768, 32767], (int(off.sum()), 2, 2))
        coef, eob, txsz, txtype = _residual_grids(rng, H, W)
        planes.append({"coef": coef, "eob": eob, "txsz": txsz,
                       "txtype": txtype, "inter": inter, "comp": comp,
                       "filt": filt, "refsel": refsel, "mv16": mv16,
                       "refs": refs, "w": w, "h": h, "mvs": mvs})
    return planes, has_comp


def _jax_planes(planes, has_comp):
    out = []
    for p in planes:
        plane, residual = J._recon_plane_inter(
            *(jnp.asarray(p[k]) for k in ("coef", "eob", "inter", "txsz",
                                          "txtype", "comp", "filt",
                                          "refsel", "mv16")),
            *(jnp.asarray(r) for r in p["refs"]), p["w"], p["h"], False, 8,
            p["mvs"], p["mvs"], has_comp=has_comp)
        out.append((np.asarray(plane), np.asarray(residual)))
    return out


def _jobs(planes, device="cpu"):
    """mc_planes' jobs for the planes, their residuals from the port's
    plain residual."""
    jobs = []
    for p in planes:
        residual = P.residual_plane_plain(
            *(_t(p[k]) for k in ("coef", "eob", "txsz", "txtype")), False, 8)
        refs = [_t(r) for r in p["refs"]]
        if p["refs"][1] is p["refs"][0]:
            refs[1] = refs[0]
        jobs.append(tuple(
            x.to(device) if torch.is_tensor(x) else x for x in (
                residual, _t(p["inter"]), _t(p["comp"]), _t(p["filt"]),
                _t(p["refsel"]), _t(p["mv16"])))
            + (tuple(r.to(device) for r in refs), p["w"], p["h"],
               p["mvs"], p["mvs"]))
    return jobs


@pytest.fixture(scope="module")
def frames():
    return {name: _frame(name) for name in CASES}


@pytest.fixture(scope="module")
def jax_out(frames):
    return {name: _jax_planes(*frames[name]) for name in CASES}


@pytest.mark.parametrize("name", list(CASES))
def test_mc_planes_plain_matches_jax(name, frames, jax_out):
    """Far MVs with negative sub-pel phases, every filter bank, compound
    cells with and without has_comp, odd visible chroma, a missing
    reference, out-of-range values in cells that are not inter."""
    planes, has_comp = frames[name]
    jobs = _jobs(planes)
    got = P.mc_planes_plain(jobs, 8, has_comp)
    assert len(got) == 3
    for (want_plane, want_res), job, out in zip(jax_out[name], jobs, got):
        _same(want_res, job[0])
        _same(want_plane, out)
    # the CPU wrapper is the plain version and launches nothing
    RC.reset_launches()
    for a, b in zip(P.mc_planes(jobs, 8, has_comp), got):
        assert torch.equal(a, b)
    assert RC.LAUNCHES["mc"] == 0


def test_cases_reach_what_they_claim(frames):
    """The inputs exercise what the cases are for."""
    planes, _ = frames["far"]
    y = planes[0]
    inter = y["inter"]
    assert (np.abs(y["mv16"][inter]) * 2 >= 140 * 16).any()
    assert ((y["mv16"][inter] & 15) != 0).any() and (y["mv16"][inter] < 0).any()
    assert set(np.unique(y["filt"][inter])) == {0, 1, 2, 3}
    assert ((y["refsel"][~inter] < 0) | (y["refsel"][~inter] > 2)).any()
    assert planes[1]["w"] % 2 and planes[1]["h"] % 2
    assert frames["all_compound"][0][0]["comp"].all()
    assert (frames["far_no_comp"][0][0]["comp"]
            & ~frames["far_no_comp"][0][0]["inter"]).any()


def _ftab_of_source():
    src = open(MC_CU).read()
    body = src[src.index("kFtab[4][16][8] = {"):]
    body = re.sub(r"//[^\n]*", "", body[:body.index("};")])
    vals = [int(v) for v in re.findall(r"-?\d+", body)[3:]]
    return np.asarray(vals, np.int64).reshape(4, 16, 8)


def test_kernel_filter_table_is_the_ports_and_jaxs():
    ftab = _ftab_of_source()
    assert np.array_equal(ftab, P._FTAB)
    assert np.array_equal(ftab, np.asarray(J._FTAB))


def _mc_model(job, bpp, has_comp, ftab):
    """csrc/mc.cu's threads on one plane, in numpy: a block per 16 x 16
    tile, thread t at pixel (t // 16, t % 16), rank (py & 3) * 4 + (px &
    3) in its cell; the cell's patch entries rank + 16 i in shared
    memory, its horizontal values rank + 16 i, then the thread's own
    vertical pass. Shared memory starts as garbage."""
    residual, inter4, comp, filt, refsel, mv16, refs, w, h, mvsx, mvsy = (
        x.numpy().astype(np.int64) if torch.is_tensor(x) else x for x in job)
    refs = np.stack([r.numpy().astype(np.int64) for r in job[6]])
    H, W = residual.shape
    maxp = (1 << bpp) - 1
    out = np.full((H, W), -1, np.int64)
    t = np.arange(256)
    py, px = t // 16, t % 16
    cell = (py >> 2) * 4 + (px >> 2)
    rank = (py & 3) * 4 + (px & 3)
    garbage = np.random.RandomState(5)
    skipped = second = 0
    for ty in range(-(-H // 16)):
        for tx in range(-(-W // 16)):
            y, x = ty * 16 + py, tx * 16 + px
            inside = (y < H) & (x < W)
            gy, gx = np.minimum(y, H - 1) >> 2, np.minimum(x, W - 1) >> 2
            inter = inside & inter4[gy, gx].astype(bool)
            cmp = inter & bool(has_comp) & comp[gy, gx].astype(bool)
            if not inter.any():
                out[y[inside], x[inside]] = 0
                skipped += 1
                continue
            nref = 2 if cmp.any() else 1
            second += nref == 2
            bank = np.where(inter, np.clip(filt[gy, gx], 0, 3), 0)
            pred = np.zeros(256, np.int64)
            for ri in range(nref):
                act = inter if ri == 0 else cmp
                patch = garbage.randint(-999, 999, (16, 121))
                hval = garbage.randint(-999, 999, (16, 44))
                mvx = np.where(act, mv16[gy, gx, ri, 0], 0) * mvsx
                mvy = np.where(act, mv16[gy, gx, ri, 1], 0) * mvsy
                iy = (y & ~3) + (mvy >> 4) - 3
                ix = (x & ~3) + (mvx >> 4) - 3
                mx, my = mvx & 15, mvy & 15
                rs = np.clip(refsel[gy, gx, ri], 0, 2)
                for i in range(8):
                    j = rank + 16 * i
                    ok = act & (j < 121)
                    sy = np.clip(iy + j // 11, 0, h - 1)
                    sx = np.clip(ix + j % 11, 0, w - 1)
                    patch[cell[ok], j[ok]] = refs[rs[ok], sy[ok], sx[ok]]
                for i in range(3):
                    j = rank + 16 * i
                    ok = act & (j < 44)
                    base = (j >> 2) * 11 + (j & 3)
                    acc = sum(ftab[bank, mx, k]
                              * patch[cell, np.minimum(base + k, 120)]
                              for k in range(8))
                    hval[cell[ok], j[ok]] = np.clip((acc + 64) >> 7, 0,
                                                    maxp)[ok]
                src = (py & 3) * 4 + (px & 3)
                acc = sum(ftab[bank, my, k] * hval[cell, src + 4 * k]
                          for k in range(8))
                v = np.clip((acc + 64) >> 7, 0, maxp)
                pred = np.where(act, v if ri == 0 else (pred + v + 1) >> 1,
                                pred)
            val = np.where(inter, np.clip(
                pred + residual[np.minimum(y, H - 1), np.minimum(x, W - 1)],
                0, maxp), 0)
            out[y[inside], x[inside]] = val[inside]
    assert (out >= 0).all()
    return out, skipped, second


@pytest.mark.parametrize("name", ["far", "far_no_comp", "missing_ref"])
def test_kernel_thread_model_matches_jax(name, frames, jax_out):
    planes, has_comp = frames[name]
    ftab = _ftab_of_source()
    skipped = second = 0
    for (want, _res), job in zip(jax_out[name], _jobs(planes)):
        got, sk, sec = _mc_model(job, 8, has_comp, ftab)
        _same(want, got)
        skipped += sk
        second += sec
    assert second if has_comp else not second


def test_kernel_thread_model_skips_tiles_without_inter_cells(frames,
                                                             jax_out):
    """A plane whose inter cells leave whole tiles out: those tiles
    write zeros without a pass."""
    planes, has_comp = frames["far"]
    planes = [dict(p) for p in planes]
    inter = planes[0]["inter"].copy()
    inter[:, :8] = False      # two 16-pixel tile columns
    planes[0]["inter"] = inter
    want = _jax_planes(planes[:1], has_comp)[0][0]
    got, skipped, _ = _mc_model(_jobs(planes[:1])[0], 8, has_comp,
                                _ftab_of_source())
    assert skipped == 8
    _same(want, got)


def test_mc_wrapper_off_cpu_goes_to_the_kernel(monkeypatch, frames):
    """Tensors off the CPU reach one launch of csrc/mc.cu for the three
    planes, never the plain version; comp passes as a null pointer
    without has_comp; arguments are checked first."""
    planes, _ = frames["far"]
    meta = _jobs(planes, "meta")
    RC.reset_launches()
    with pytest.raises(ValueError, match="not a CUDA device"):
        P.mc_planes(meta, 8, True)
    launched = []

    def fake_launch(source, signatures, name, *args):
        launched.append((source, name, args))

    monkeypatch.setattr(_cuda, "launch", fake_launch)
    monkeypatch.setattr(P, "mc_planes_plain", None)
    for has_comp in (True, False):
        launched.clear()
        outs = P.mc_planes(meta, 8, has_comp)
        assert [(s, n) for s, n, _a in launched] == [("mc.cu", "mc_planes")]
        ptrs, _dims, n, bpp, hc = launched[0][2]
        assert (n, bpp, hc) == (3, 8, int(has_comp))
        assert len(ptrs) == 30
        for j, (job, out) in enumerate(zip(meta, outs)):
            q = ptrs[10 * j:10 * j + 10]
            assert all(a is b for a, b in zip(q[:3], job[6]))
            assert q[3] is job[0] and q[4] is out
            assert q[6] is (job[2] if has_comp else None)
            assert out.shape == job[0].shape and out.dtype == torch.int32
    assert RC.LAUNCHES["mc"] == 2
    job = list(meta[0])
    bad = [(1, job[1].to(torch.int32), TypeError),
           (3, job[3].to(torch.int16), TypeError),
           (5, job[5][:, :, :1], ValueError),
           (6, (job[6][0], job[6][1], job[6][2][:8]), ValueError),
           (7, FRAME["W"] + 1, ValueError),
           (9, 3, ValueError)]
    for k, v, exc in bad:
        case = list(job)
        case[k] = v
        with pytest.raises(exc):
            P.mc_planes([tuple(case)], 8, True)
    with pytest.raises(ValueError, match="at most 3"):
        P.mc_planes(meta + meta[:1], 8, True)
    assert RC.LAUNCHES["mc"] == 2


# ---------------------------------------------------------------------------
# on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_mc_kernel_matches_plain_on_the_card(name, frames):
    dev = _card()
    planes, has_comp = frames[name]
    want = P.mc_planes_plain(_jobs(planes), 8, has_comp)
    RC.reset_launches()
    got = P.mc_planes(_jobs(planes, dev), 8, has_comp)
    assert RC.LAUNCHES["mc"] == 1
    for a, b in zip(want, got):
        assert torch.equal(a, b.cpu())


def _inter_chain(w=130, h=70, n_inter=3, seed=11):
    """A keyframe, then inter frames with compound prediction (every
    other frame), switchable filters, sub-8x8 blocks, intra blocks and
    coefficients; an odd visible chroma size."""
    import sys
    tools = os.path.join(os.path.dirname(__file__), "..", "tools")
    sys.path.insert(0, tools)
    try:
        from mini_encoder import encode_inter_flex, encode_keyframe_random
    finally:
        sys.path.pop(0)
    pkts = [encode_keyframe_random(w, h, 8, seed=seed, txfmmode=3,
                                   yac_qi=60, filter_level=0)]
    for i in range(n_inter):
        pkts.append(encode_inter_flex(
            w, h, seed=seed + 5 + i, comppredmode=2 if i % 2 == 0 else 0,
            signbias=(0, 0, 1), filtermode=4, coeffs=True, p_intra=0.2,
            p_skip=0.2, mv_mags=(0, 2, 4, 8, 16, 64),
            refresh_mask=0x01 if i % 2 else 0x05, filter_level=0))
    return pkts


@pytest.mark.cuda
@pytest.mark.parametrize("native", [True, False])
def test_inter_chain_on_the_card_matches_the_cpu(native, monkeypatch):
    """A compound chain decoded on the card equals its CPU decode plane
    for plane, with the plain versions set to raise: one MC launch per
    inter frame, one residual launch per frame, and one scatter per
    frame (native pass A's merged pairs) or per plane (the pure-Python
    pass A's)."""
    dev = _card()
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    pkts = _inter_chain()
    cpu = VP9Decoder(device="cpu", use_native=native)
    want = [[p.clone() for p in f.dev] for pkt in pkts
            for f in cpu.decode(pkt)]

    def plain_called(*a, **k):
        raise AssertionError("a plain version ran on the card")

    for name in ("mc_planes_plain", "residual_plane_plain",
                 "_scatter_pairs16", "_scatter_pairs32"):
        monkeypatch.setattr(P, name, plain_called)
    RC.reset_launches()
    card = VP9Decoder(device=dev, use_native=native)
    got = [[p.cpu() for p in f.dev] for pkt in pkts
           for f in card.decode(pkt)]
    assert len(got) == len(want) == len(pkts)
    for a, b in zip(want, got):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    n = len(pkts)
    assert RC.LAUNCHES["mc"] == n - 1
    assert RC.LAUNCHES["residual"] == n
    assert RC.LAUNCHES["scatter"] == (n if native else 3 * n)
