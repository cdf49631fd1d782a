"""The inter pass of the port (ffmpeg_hybrid_tpu_torch/ops/recon.py
mc_planes, mc_planes_plain) around its CUDA kernel (csrc/mc.cu): the
plain version of a frame's three planes against the JAX package's
_recon_plane_inter per plane (CPU-JAX, as tests/conftest.py sets it); a
numpy model of the kernel's warps (a warp per 16 x 16 tile, a lane's two
quads and their cells, the vote on each reference's motion, the window
of a tile of one motion with its phase-0 skips, the walk of the cells
otherwise, shared memory starting as garbage) held to the same
function, and the paths and traps each case reaches; the kernel's filter
table; the wrapper's choice between plain version and kernel; and, on a
card, the kernel against its plain version. Every comparison is
exact."""
import os
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from test_torch_threads import one_torch_thread  # noqa: F401

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
# inter and compound, one motion a 16 x 16 tile)
CASES = {"near": (12, True, False, False, False),
         "far": (150, True, False, False, False),
         "far_no_comp": (150, False, False, False, False),
         "missing_ref": (150, True, True, False, False),
         "all_compound": (150, True, False, True, False),
         "tiles": (150, True, False, False, True),
         "tiles_no_comp": (150, False, False, False, True)}


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


def _snap_phase(mv, mvs, zero):
    """mv (1/16 pel before the scale mvs) moved to phase 0 of the scaled
    MV where `zero`, and off it elsewhere."""
    v = mv * mvs
    v = np.where(zero, v & ~15, np.where(v & 15, v, v + mvs))
    return v // mvs


def _tile_grids(rng, r4, c4, mvs, px):
    """(inter, comp, mv16, refsel, filt) for cells where each 16 x 16
    tile has one motion a reference: a plane and an MV (half the tiles
    within 12 px, half out to `px`) for each reference and one filter
    bank; each reference's phases drawn from the four classes (mx and my
    both 0, mx alone, my alone, neither); one tile in five with a motion
    of its own for every cell on reference 0, its compound cells still
    sharing reference 1's; inter cells 85%, none in one tile in twelve,
    compound cells half of them."""
    tr, tc = -(-r4 // 4), -(-c4 // 4)

    def cells(a):
        return np.repeat(np.repeat(a, 4, 0), 4, 1)[:r4, :c4]

    lim = np.where(rng.rand(tr, tc) < 0.5, 12, px) * 16 // mvs
    mv = np.stack([rng.randint(-lim, lim + 1) for _ in range(4)], -1)
    cls = rng.randint(0, 4, (tr, tc, 2))
    for ri in range(2):
        for a in range(2):
            mv[..., 2 * ri + a] = _snap_phase(mv[..., 2 * ri + a], mvs,
                                              (cls[..., ri] >> a) & 1)
    mv16 = cells(mv.reshape(tr, tc, 2, 2)).astype(np.int32)
    refsel = cells(rng.randint(0, 3, (tr, tc, 2))).astype(np.int32)
    filt = cells(rng.randint(0, 4, (tr, tc))).astype(np.int32)
    mixed = cells(rng.rand(tr, tc) < 0.2)
    lim0 = px * 16 // mvs
    own = rng.randint(-lim0, lim0 + 1, (r4, c4, 2))
    mv16[mixed, 0] = own[mixed]
    refsel[mixed, 0] = rng.randint(0, 3, int(mixed.sum()))
    inter = (rng.rand(r4, c4) < 0.85) & ~cells(rng.rand(tr, tc) < 1 / 12)
    comp = rng.rand(r4, c4) < 0.5
    return inter, comp, mv16, refsel, filt


def _frame(name, seed=0):
    """One case of CASES: per plane (Y, U, V) the JAX arguments of
    _recon_plane_inter (coefficients and grids) and the MC inputs,
    numpy. Cells that are not inter carry out-of-range refsel, filter
    and MV values. The cases of one motion a tile draw references with
    values out of range too, so that a pass at phase 0 shows its clip."""
    px, has_comp, missing, all_comp, tiles = CASES[name]
    rng = np.random.RandomState(seed + sum(map(ord, name)))
    planes = []
    for i in range(3):
        sub = 1 if i else 0
        H, W = FRAME["H"] >> sub, FRAME["W"] >> sub
        w = (FRAME["w"] + sub) >> sub
        h = (FRAME["h"] + sub) >> sub
        mvs = 1 if i else 2
        r4, c4 = H // 4, W // 4
        lo, hi = (-40, 300) if tiles else (0, 256)
        refs = [rng.randint(lo, hi, (H, W)).astype(np.int32)
                for _ in range(3)]
        if missing:
            refs[1] = refs[0]   # recon_frame's stand-in for an empty slot
        if tiles:
            inter, comp, mv16, refsel, filt = _tile_grids(rng, r4, c4, mvs,
                                                          px)
        else:
            inter = np.ones((r4, c4), bool) if all_comp \
                else rng.rand(r4, c4) < 0.75
            comp = np.ones((r4, c4), bool) if all_comp \
                else rng.rand(r4, c4) < 0.5
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


def _source():
    with open(MC_CU) as f:
        return f.read()


def _ftab_of_source():
    src = _source()
    body = src[src.index("kFtab[4][16][8] = {"):]
    body = re.sub(r"//[^\n]*", "", body[:body.index("};")])
    vals = [int(v) for v in re.findall(r"-?\d+", body)[3:]]
    return np.asarray(vals, np.int64).reshape(4, 16, 8)


def _constant(name):
    """The value of `constexpr int name = <literal>;` in csrc/mc.cu."""
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         _source()).group(1))


def test_kernel_filter_table_is_the_ports_and_jaxs():
    ftab = _ftab_of_source()
    assert np.array_equal(ftab, P._FTAB)
    assert np.array_equal(ftab, np.asarray(J._FTAB))


LANE = np.arange(32)
QUAD = np.arange(4)


class _Warp:
    """csrc/mc.cu's warp on one tile of a plane, in numpy, a value per
    lane: the warp's slice of shared memory, laid out as the kernel lays
    it out and starting each tile as garbage (a warp takes its tiles in
    turn, and a tile finds what the last one left), and the statistics
    of the paths it took (`stats`, a dict of counts)."""

    def __init__(self, job, bpp, has_comp, ftab, stats, garbage):
        (self.residual, self.inter4, self.comp4, self.filt, self.refsel,
         self.mv16, _r, self.w, self.h, self.mvsx, self.mvsy) = (
            x.numpy().astype(np.int64) if torch.is_tensor(x) else x
            for x in job)
        self.refs = np.stack([r.numpy().astype(np.int64) for r in job[6]])
        self.H, self.W = self.residual.shape
        self.maxp = (1 << bpp) - 1
        self.has_comp = bool(has_comp)
        self.ftab = ftab
        self.stats = stats
        self.garbage = garbage
        self.lanes = _constant("kCellLanes")
        self.stride = _constant("kWinStride")
        self.step = 32 // self.lanes
        self.hv = 23 * self.stride
        self.res = self.hv + 23 * 16
        self.cell_hv = self.step * 121
        self.pred = (self.cell_hv + self.step * 44 + 3) & ~3

    def count(self, key):
        self.stats[key] = self.stats.get(key, 0) + 1

    def tile(self, ty, tx):
        """The lane's two quads: (their rows, their column, their four
        values each, whether each lies inside the plane)."""
        H, W, maxp = self.H, self.W, self.maxp
        self.s = self.garbage.randint(-999, 999, self.res + 16 * 16)
        y0, x0 = 16 * ty, 16 * tx
        x = x0 + 4 * (LANE & 3)
        rows = [y0 + (LANE >> 2) + 8 * k for k in range(2)]
        qin, inter, comp, cell = [], [], [], []
        for y in rows:
            ok = (y < H) & (x < W)
            gy, gx = np.minimum(y, H - 1) >> 2, np.minimum(x, W - 1) >> 2
            qin.append(ok)
            inter.append(ok & self.inter4[gy, gx].astype(bool))
            comp.append(inter[-1] & self.comp4[gy, gx].astype(bool)
                        & self.has_comp)
            cell.append((gy, gx))
        self.count("tiles")
        if not (inter[0] | inter[1]).any():
            self.count("skipped")
            return rows, x, [np.zeros((32, 4), np.int64)] * 2, qin
        # the inter quads' residuals into the slice
        at = [self.res + ((LANE >> 2) + 8 * k)[:, None] * 16
              + 4 * (LANE & 3)[:, None] + QUAD for k in range(2)]
        for k, y in enumerate(rows):
            on = inter[k]
            self.s[at[k][on]] = self.residual[y[on, None], x[on, None] + QUAD]
        nref = 2 if (comp[0] | comp[1]).any() else 1
        self.count("second" if nref == 2 else "first_only")
        pred = [None, None]
        paths = []
        for ri in range(nref):
            act = inter if ri == 0 else comp
            keys = [self.motion(gy, gx, ri, a)
                    for (gy, gx), a in zip(cell, act)]
            src = np.flatnonzero(act[0] | act[1])[0]
            k0 = 0 if act[0][src] else 1
            lead = tuple(int(c[src]) for c in keys[k0])
            same = all(
                ((~a) | np.all([c == v for c, v in zip(key, lead)], 0)).all()
                for a, key in zip(act, keys))
            if same:
                v = self.window(lead, y0, x0)
                paths.append("window")
                if ri == 0 and any(((~i) & q).any()
                                   for i, q in zip(inter, qin)):
                    self.count("window_beside_non_inter")
            else:
                cells = 0
                for k, a in enumerate(act):
                    for ln in np.flatnonzero(a):
                        cells |= 1 << int(((ln >> 4) + 2 * k) * 4
                                          + (ln & 3))
                v = self.walk(cells, ri, y0 >> 2, x0 >> 2)
                paths.append("cells")
            self.count(f"{paths[-1]}{ri}")
            for k in range(2):
                pred[k] = v[k] if ri == 0 else np.where(
                    act[k][:, None], (pred[k] + v[k] + 1) >> 1, pred[k])
        if paths == ["cells", "window"]:
            self.count("cells0_window1")
        out = [np.where(inter[k][:, None],
                        np.clip(pred[k] + self.s[at[k]], 0, maxp), 0)
               for k in range(2)]
        return rows, x, out, qin

    def motion(self, gy, gx, ri, act):
        """A lane's (plane, mvx, mvy, bank) of one of its cells for
        reference ri; zeros where the cell does not use it."""
        return (np.where(act, np.clip(self.refsel[gy, gx, ri], 0, 2), 0),
                np.where(act, self.mv16[gy, gx, ri, 0], 0) * self.mvsx,
                np.where(act, self.mv16[gy, gx, ri, 1], 0) * self.mvsy,
                np.where(act, np.clip(self.filt[gy, gx], 0, 3), 0))

    def window(self, lead, y0, x0):
        ref, mvx, mvy, bank = lead
        s, hv, maxp = self.s, self.hv, self.maxp
        mx, my = mvx & 15, mvy & 15
        nr, nc = (23 if my else 16), (23 if mx else 16)
        wy = y0 + (mvy >> 4) - (3 if my else 0)
        wx = x0 + (mvx >> 4) - (3 if mx else 0)
        self.count({(0, 0): "phase00", (0, 1): "phase0x", (1, 0): "phase0y",
                    (1, 1): "phase_xy"}[(bool(mx), bool(my))])
        for edge, crossed in (("top", wy < 0), ("left", wx < 0),
                              ("bottom", wy + nr > self.h),
                              ("right", wx + nc > self.w)):
            if crossed:
                self.count("edge_" + edge)
        # a row a step, lane on column; two rows a step at 16 columns
        c = LANE if mx else LANE & 15
        r0 = 0 if mx else LANE >> 4
        for i in range(23):
            r = r0 + (i if mx else 2 * i)
            ok = (c < nc) & (r < nr)
            val = self.refs[ref, np.clip(wy + r, 0, self.h - 1),
                            np.clip(wx + c, 0, self.w - 1)]
            at = r * self.stride + c if mx else hv + r * 16 + c
            s[at[ok]] = val[ok]
        if mx:
            t = self.ftab[bank, mx]
            for i in range(3):
                j = LANE + 32 * i
                g, qc = j >> 2, j & 3
                r = (g & ~3) | ((g & 1) << 1) | ((g >> 1) & 1)
                ok = r < nr
                base = np.where(ok, r * self.stride + 4 * qc, 0)
                w12 = s[base[:, None] + np.arange(12)]
                o = np.stack([np.clip((w12[:, i:i + 8] @ t + 64) >> 7, 0,
                                      maxp) for i in range(4)], 1)
                dst = hv + r * 16 + 4 * qc
                s[(dst[:, None] + QUAD)[ok]] = o[ok]
        # the vertical pass reads the horizontal values, clipped where
        # the window went in raw (mx == 0)
        def read(at):
            return s[at] if mx else np.clip(s[at], 0, maxp)

        t = self.ftab[bank, my]
        v = []
        for k in range(2):
            y = (LANE >> 2) + 8 * k
            at = hv + 4 * (LANE & 3)[:, None] + QUAD
            if my:
                acc = sum(t[tap] * read(at + ((y + tap) * 16)[:, None])
                          for tap in range(8))
                v.append(np.clip((acc + 64) >> 7, 0, maxp))
            else:
                v.append(read(at + (y * 16)[:, None]))
        return v

    def walk(self, cells, ri, cy0, cx0):
        s, maxp, n = self.s, self.maxp, self.lanes
        grp, rank = LANE // n, LANE % n
        while cells:
            picked = []
            for _ in range(self.step):
                picked.append(((cells & -cells).bit_length() - 1)
                              if cells else -1)
                cells &= cells - 1
            self.count("walk_steps")
            todo = []
            for gi, c in enumerate(picked):
                if c < 0:
                    continue
                gy, gx = cy0 + (c >> 2), cx0 + (c & 3)
                mvx = int(self.mv16[gy, gx, ri, 0]) * self.mvsx
                mvy = int(self.mv16[gy, gx, ri, 1]) * self.mvsy
                ref = int(np.clip(self.refsel[gy, gx, ri], 0, 2))
                bank = int(np.clip(self.filt[gy, gx], 0, 3))
                iy, ix = 4 * gy + (mvy >> 4) - 3, 4 * gx + (mvx >> 4) - 3
                lanes = grp == gi
                # a row a step, the lane on columns rank, rank + n, ...
                cols = np.concatenate([np.arange(c0, 11, n)
                                       for c0 in rank[lanes]])
                r = np.arange(11)[:, None]
                s[gi * 121 + r * 11 + cols] = self.refs[
                    ref, np.clip(iy + r, 0, self.h - 1),
                    np.clip(ix + cols, 0, self.w - 1)]
                todo.append((gi, c, bank, mvx & 15, mvy & 15, lanes))
            for gi, c, bank, mx, my, lanes in todo:
                t = self.ftab[bank, mx]
                for j0 in rank[lanes]:
                    for j in range(j0, 44, n):
                        src = gi * 121 + (j >> 2) * 11 + (j & 3)
                        s[self.cell_hv + gi * 44 + j] = np.clip(
                            (s[src:src + 8] @ t + 64) >> 7, 0, maxp)
            for gi, c, bank, mx, my, lanes in todo:
                t = self.ftab[bank, my]
                for p0 in rank[lanes]:
                    for px in range(p0, 16, n):
                        h8 = s[self.cell_hv + gi * 44 + px
                               + 4 * np.arange(8)]
                        s[self.pred + ((c >> 2) * 4 + (px >> 2)) * 16
                          + (c & 3) * 4 + (px & 3)] = np.clip(
                            (h8 @ t + 64) >> 7, 0, maxp)
        return [s[self.pred + ((LANE >> 2) + 8 * k)[:, None] * 16
                  + 4 * (LANE & 3)[:, None] + QUAD] for k in range(2)]


def _mc_model(job, bpp, has_comp, ftab, stats):
    """csrc/mc.cu on one plane, in numpy: a _Warp per 16 x 16 tile, its
    path statistics added to `stats`."""
    warp = _Warp(job, bpp, has_comp, ftab, stats, np.random.RandomState(5))
    out = np.full((warp.H, warp.W), -1, np.int64)
    for ty in range(-(-warp.H // 16)):
        for tx in range(-(-warp.W // 16)):
            rows, x, vals, qin = warp.tile(ty, tx)
            for y, v, ok in zip(rows, vals, qin):
                out[y[ok, None], x[ok, None] + QUAD] = v[ok]
    assert (out >= 0).all()
    return out


@pytest.fixture(scope="module")
def model_runs(frames):
    """Per case the model's three planes and its path statistics."""
    ftab = _ftab_of_source()
    runs = {}
    for name in CASES:
        planes, has_comp = frames[name]
        stats = {}
        outs = [_mc_model(job, 8, has_comp, ftab, stats)
                for job in _jobs(planes)]
        runs[name] = (outs, stats)
    return runs


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_thread_model_matches_jax(name, frames, jax_out, model_runs):
    outs, stats = model_runs[name]
    for (want, _res), got in zip(jax_out[name], outs):
        _same(want, got)
    has_comp = frames[name][1]
    assert stats.get("second", 0) if has_comp else not stats.get("second")


def test_cases_reach_what_they_claim(frames, model_runs):
    """The inputs exercise what the cases are for, and the model's warps
    take every path and meet every trap of the kernel."""
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
    # the random-motion cases walk the cells, with the odd single-motion
    # tile among them
    for name in ("near", "far", "missing_ref", "all_compound"):
        stats = model_runs[name][1]
        assert stats["cells0"] and stats.get("cells1", 0), name
    # one motion a tile: the window on both references, every phase
    # class, every visible edge crossed (with columns beyond the odd
    # visible width of the padded references), cells that are not inter
    # beside a window, reference 0 mixed while reference 1's compound
    # cells share one motion, the walk and the skipped tiles too
    stats = model_runs["tiles"][1]
    for key in ("window0", "window1", "cells0", "skipped", "phase00",
                "phase0x", "phase0y", "phase_xy", "edge_top", "edge_left",
                "edge_bottom", "edge_right", "window_beside_non_inter",
                "cells0_window1"):
        assert stats.get(key, 0) > 0, key
    assert stats["window0"] > stats["cells0"]
    stats = model_runs["tiles_no_comp"][1]
    assert stats["window0"] and not stats.get("second")
    planes = frames["tiles"][0]
    assert all((p["refs"][0] < 0).any() and (p["refs"][0] > 255).any()
               for p in planes)
    for p in planes:
        assert p["w"] < p["refs"][0].shape[1] and p["h"] < p["refs"][0].shape[0]


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
    stats = {}
    got = _mc_model(_jobs(planes[:1])[0], 8, has_comp, _ftab_of_source(),
                    stats)
    assert stats["skipped"] == 8
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
    # the kernel's vector loads: a residual, mv16 or refsel off their
    # alignment is refused
    for k in (0, 5, 4):
        shape = tuple(job[k].shape)
        bad.append((k, torch.empty(int(np.prod(shape)) + 1, dtype=torch.int32,
                                   device="meta")[1:].view(shape),
                    ValueError))
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
