"""The coefficient scatter and the residual of the port
(ffmpeg_hybrid_tpu_torch/ops/recon.py scatter_coef, residual_planes)
around their CUDA kernels (csrc/itxfm.cu): a frame's merged pair rows
scattered, carved into three planes and transformed, against the JAX
package's _scatter_pairs16/_scatter_pairs32, _slice_plane and
residual_plane (CPU-JAX, as tests/conftest.py sets it); a numpy model of
the residual kernel's threads (the size vote of a region's 64 cells, the
skip of regions without a coded block and of pass a where a size holds
only DC blocks, two lanes per column at 32x32 with the odd half of the
32-point DCT read from the kernel's source) held to the same functions;
the wrappers' choice between plain version and kernel; the buffers that
recon_frame keeps from frame to frame (scatter_frame into them with no
memset, then the consuming residual, in the plain version and in the
model of the kernel's clear), over sequences of frames on one buffer
set, each frame held to the JAX functions on fresh buffers and the
buffers read zero after it; and, on a card, each kernel against its
plain version. Every comparison is exact."""
import os
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu.ops import recon_tpu as J
from ffmpeg_hybrid_tpu_torch.ops import _cuda
from ffmpeg_hybrid_tpu_torch.ops import itxfm
from ffmpeg_hybrid_tpu_torch.ops import recon as P
from ffmpeg_hybrid_tpu_torch.ops import recon_cuda as RC

ITXFM_CU = os.path.join(os.path.dirname(__file__), "..",
                        "ffmpeg_hybrid_tpu_torch", "csrc", "itxfm.cu")
# Y, U, V of a 4:2:0 frame, in 32x32 regions
SHAPES = ((64, 128), (32, 64), (32, 64))
# name: (kind of every region, wide pair rows); "dc<t>": every region
# tiled by size t, every block DC-only
CASES = {"mixed": ("mixed", False), "mixed_wide": ("mixed", True),
         "empty": ("empty", False), "lossless": ("lossless", False),
         "dc0": ("dc0", False), "dc1": ("dc1", False), "dc2": ("dc2", False),
         "dc3": ("dc3", False)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(want, got):
    a = np.asarray(want).astype(np.int64)
    b = got.cpu().numpy().astype(np.int64) if torch.is_tensor(got) \
        else np.asarray(got).astype(np.int64)
    assert a.shape == b.shape
    assert np.array_equal(a, b), np.argwhere(a != b)[:4]


def _plane(rng, H, W, kind, wide):
    """coef, eob, txsz, txtype of one plane: per 32x32 region a size
    (mixed: drawn per region, some regions without a coded block),
    every type, eobs 0, 1 (the DC shortcut), small and full."""
    r4, c4 = H // 4, W // 4
    lim = 1 << 20 if wide else 32768
    coef = rng.randint(-4000, 4000, (H, W))
    coef[rng.rand(H, W) < 0.02] = lim - 1
    coef[rng.rand(H, W) < 0.02] = -lim
    txsz = np.zeros((r4, c4), np.int32)
    txtype = np.zeros((r4, c4), np.int32)
    eob = np.zeros((r4, c4), np.int32)
    if kind == "empty":
        return coef * 0, eob, txsz, txtype
    for qy in range(0, r4, 8):
        for qx in range(0, c4, 8):
            if kind == "lossless":
                sz = 0
            elif kind.startswith(("dc", "full")):
                sz = int(kind[-1])
            else:
                sz = rng.randint(0, 4)
                if rng.rand() < 0.25:
                    continue               # a region with no coded block
            k = 1 << sz
            txsz[qy:qy + 8, qx:qx + 8] = sz
            for y in range(qy, qy + 8, k):
                for x in range(qx, qx + 8, k):
                    txtype[y:y + k, x:x + k] = rng.randint(0, 4)
                    if kind.startswith("dc"):
                        eob[y, x] = 1
                        if sz < 3:
                            txtype[y:y + k, x:x + k] = 0
                    else:
                        eob[y, x] = rng.choice([0, 1, 1, 2, 5, (4 << sz) ** 2])
    if kind == "lossless":
        coef = coef // 8
    return coef, eob, txsz, txtype


def _coded(coef, eob, tx, ty, lossless):
    """coef with every value outside the tiles of the coded roots set to
    0, and in a DC-only root every value but its DC: the planes pass A
    hands over, which the kept buffers' precondition rests on."""
    keep = np.zeros(coef.shape, bool)
    for y, x in zip(*np.nonzero(eob > 0)):
        t = int(tx[y, x])
        sz = 4 << t
        dc = not lossless and eob[y, x] == 1 and (t == 3 or ty[y, x] == 0)
        keep[4 * y:4 * y + (1 if dc else sz), 4 * x:4 * x + (1 if dc else sz)] \
            = True
    return np.where(keep, coef, 0)


def _frame(name, seed=0):
    """Three planes and their merged pair rows: the coefficient rows of
    every nonzero position, the eob rows of every nonzero cell, each
    with pad rows among them and rows whose position lies past the end;
    rows in a random order."""
    kind, wide = CASES[name]
    return _frame_of(kind, wide, seed + sum(map(ord, name)))


def _frame_of(kind, wide, seed, coded=False):
    """_frame of a kind of plane; coded: only the coded roots' values
    (_coded)."""
    rng = np.random.RandomState(seed)
    planes = [_plane(rng, H, W, kind, wide) for H, W in SHAPES]
    if coded:
        planes = [(_coded(c, e, tx, ty, kind == "lossless"), e, tx, ty)
                  for c, e, tx, ty in planes]
    geoms, cbase, ebase = [], 0, 0
    cpos, cval, epos, evals = [], [], [], []
    for coef, eob, _tx, _ty in planes:
        geoms.append((coef.shape, eob.shape, cbase, ebase))
        cy, cx = np.nonzero(coef)
        cpos.append(cbase + cy * coef.shape[1] + cx)
        cval.append(coef[cy, cx])
        ey, ex = np.nonzero(eob)
        epos.append(ebase + ey * eob.shape[1] + ex)
        evals.append(eob[ey, ex])
        cbase += coef.size
        ebase += eob.size

    def rows(pos, val, ncols, end):
        pos, val = np.concatenate(pos), np.concatenate(val)
        n = len(pos)
        out = np.zeros((n + 24, ncols), np.int16)
        P._fill_pairs(out, pos, val, n)
        out[n:n + 12, 0] = rng.randint(-32768, 0, 12)     # pad rows
        out[n:n + 12, 1:] = rng.randint(-32768, 32768, (12, ncols - 1))
        past = end + rng.randint(0, 1 << 20, 12)
        P._fill_pairs(out[n + 12:], past, rng.randint(-999, 999, 12), 12)
        return out[rng.permutation(len(out))]

    cp = rows(cpos, cval, 4 if wide else 3, cbase)
    ep = rows(epos, evals, 3, ebase)
    return planes, cp, ep, geoms


def _jax_residuals(cp, ep, geoms, planes, lossless):
    wide = cp.shape[1] == 4
    Lc = sum(sh[0] * sh[1] for sh, _e, _b, _eb in geoms)
    Le = sum(e[0] * e[1] for _sh, e, _b, _eb in geoms)
    scat = J._scatter_pairs32 if wide else J._scatter_pairs16
    flat_c = scat(jnp.asarray(cp), 1, Lc)
    flat_e = J._scatter_pairs16(jnp.asarray(ep), 1, Le)
    return flat_c, flat_e, [J.residual_plane(
        *J._slice_plane(flat_c, flat_e, bc, be, sh[0], sh[1], esh[0],
                        esh[1]),
        jnp.asarray(tx), jnp.asarray(ty), lossless, 8)
        for (sh, esh, bc, be), (_c, _e, tx, ty) in zip(geoms, planes)]


def _port_residuals(cp, ep, geoms, planes, lossless, device="cpu"):
    Lc = sum(sh[0] * sh[1] for sh, _e, _b, _eb in geoms)
    Le = sum(e[0] * e[1] for _sh, e, _b, _eb in geoms)
    flat_c, flat_e = P.scatter_coef(_t(cp).to(device), _t(ep).to(device),
                                    Lc, Le)
    jobs = [P._slice_plane(flat_c[None], flat_e[None], bc, be, sh[0], sh[1],
                           esh[0], esh[1]) + (_t(tx).to(device),
                                              _t(ty).to(device))
            for (sh, esh, bc, be), (_c, _e, tx, ty) in zip(geoms, planes)]
    return flat_c, flat_e, jobs, P.residual_planes(jobs, lossless, 8)


@pytest.fixture(scope="module")
def frames():
    return {name: _frame(name) for name in CASES}


@pytest.mark.parametrize("name", list(CASES))
def test_scatter_and_residual_match_jax(name, frames):
    """Pad rows in the middle, positions past the end, an empty frame,
    lossless, DC-only blocks at every size, int16 and int32 values."""
    planes, cp, ep, geoms = frames[name]
    lossless = CASES[name][0] == "lossless"
    jc, je, jres = _jax_residuals(cp, ep, geoms, planes, lossless)
    RC.reset_launches()
    flat_c, flat_e, jobs, res = _port_residuals(cp, ep, geoms, planes,
                                                lossless)
    assert set(RC.LAUNCHES.values()) == {0}
    assert flat_c.dtype == (torch.int32 if cp.shape[1] == 4 else torch.int16)
    _same(jc[0], flat_c)
    _same(je[0], flat_e)
    for (coef, eob, _tx, _ty), job, want, got in zip(planes, jobs, jres,
                                                     res):
        # the dense buffers hold the planes' own values
        _same(coef, job[0])
        _same(eob, job[1])
        _same(want, got)
    if name == "empty":
        assert not any(int(r.abs().sum()) for r in res)
    else:
        assert any(int(r.abs().sum()) for r in res)
    # residual_plane is residual_planes of one plane
    _same(jres[0], P.residual_plane(*jobs[0], lossless, 8))


# ---------------------------------------------------------------------------
# a numpy model of csrc/itxfm.cu's residual threads


def _idct32_odd_of_source():
    """csrc/itxfm.cu's idct32_odd (a template of the word T) as a Python
    function over int32 tensors (the uint32 wrap of the kernel's 8-bit
    instantiation is the int32 wrap)."""
    src = open(ITXFM_CU).read()
    body = src[src.index("void idct32_odd(const T* I, T* D) {"):]
    body = body[body.index("{") + 1:body.index("\n}")]
    code = ["def f(I, D):"]
    for line in body.strip().splitlines():
        line = re.sub(r"^T ", "", line.strip().rstrip(";"))
        code.append("    " + re.sub(r"\b0u\b", "0", line))
    ns = {"rs": itxfm._rs}
    exec("\n".join(code), ns)
    return ns["f"]


IDCT32_ODD = _idct32_odd_of_source()


def _cols(xs):
    return torch.stack(xs, -1)


def _pass(tx, wht, lines, adst, first):
    """One 1-D pass over rows of `lines` [N, SZ] int32 (tx < 3, or the
    WHT)."""
    if wht:
        return itxfm.iwht4_1d(itxfm.TORCH, lines, 0 if first else 1)
    fn = itxfm._1D[(tx, "dct")]
    fa = itxfm._1D[(tx, "adst")]
    return torch.where(adst[:, None], fa(itxfm.TORCH, lines),
                       fn(itxfm.TORCH, lines))


def _pair32(ins, half):
    """The two lanes' idct32_pair: ins [N, 16] (even inputs where half is
    0, odd where 1) -> o [N, 16], o[:, j] output j (half 0) or 31 - j
    (half 1), after one exchange between the two lanes of a pair."""
    mine = torch.empty_like(ins)
    ev = ~half
    mine[ev] = itxfm.idct16_1d(itxfm.TORCH, ins[ev])
    D = [None] * 16
    IDCT32_ODD([ins[~ev][:, k] for k in range(16)], D)
    mine[~ev] = _cols(D)
    other = mine.view(-1, 2, 16).flip(1).reshape(-1, 16)   # lane ^ 1
    return torch.where(half[:, None], other - mine, mine + other)


def _residual_model(coef, eob4, txsz4, txtype4, lossless, stats,
                    consume=None):
    """csrc/itxfm.cu's residual threads on one plane: per 32x32 region
    the vote of its 64 cells; a region without a coded block writes
    zeros; each size present runs pass a (only where some block is not
    DC-only) and pass b with thread t on line t % SZ of root t / SZ, or
    at 32x32 on line (t >> 1) % 32 of the one root with lane half t & 1.
    Shared memory starts as garbage. consume: None, or a dict; then, as
    the consuming launch, the vote's thread clears each nonzero eob cell
    of eob4 and sets consume["strays"] where the cell is no transformed
    root, pass a flags each quad where it reads a nonzero and a DC-only
    root the quad of its DC, and after the last size each thread clears
    its quad of coef if flagged (both in place)."""
    coef_in = coef
    coef = torch.as_tensor(coef).to(torch.int32)
    H, W = coef.shape
    out = torch.full((H, W), -(1 << 30), dtype=torch.int32)
    garbage = np.random.RandomState(9)
    tid = torch.arange(256)
    for ry0 in range(0, H, 32):
        for rx0 in range(0, W, 32):
            vote = 0
            cells = {}
            nz = np.zeros((32, 8), bool)
            for c in range(64):
                cy, cx = divmod(c, 8)
                gy, gx = ry0 + 4 * cy, rx0 + 4 * cx
                e, t, ty = (int(g[gy // 4, gx // 4]) for g in
                            (eob4, txsz4, txtype4)) if gy < H and gx < W \
                    else (0, -1, 0)
                cells[c] = (e, t, ty)
                if consume is not None and e:
                    eob4[gy // 4, gx // 4] = 0
                k = 1 << max(t, 0)
                if e <= 0 or not 0 <= t <= (0 if lossless else 3) \
                        or cy % k or cx % k or gy + 4 * k > H \
                        or gx + 4 * k > W:
                    if consume is not None and e:
                        consume["strays"] = 1
                    continue
                dc = not lossless and e == 1 and (t == 3 or ty == 0)
                vote |= (1 << t) | (0 if dc else 16 << t)
            if not vote:
                out[ry0:ry0 + 32, rx0:rx0 + 32] = 0
                stats["skipped"] += 1
                continue
            acc = torch.zeros((32, 32), dtype=torch.int32)
            tmp = torch.as_tensor(garbage.randint(-99999, 99999, (32, 32)),
                                  dtype=torch.int32)
            for tx in range(4):
                if not vote & (1 << tx):
                    continue
                full = lossless or bool(vote & (16 << tx))
                stats["pass_a" if full else "dc_only"] += 1
                SZ, NR = 4 << tx, 8 >> tx
                pair = tx == 3
                shift = 0 if lossless else (4, 5, 6, 6)[tx]
                rnd = 1 << (shift - 1) if shift else 0
                root = tid // (2 * SZ) if pair else tid // SZ
                line = (tid >> 1) % SZ if pair else tid % SZ
                half = (tid & 1).bool() if pair else torch.zeros(256, dtype=bool)
                ok = root < NR * NR
                ry = torch.where(ok, (root // NR) * SZ, 0)
                rx = torch.where(ok, (root % NR) * SZ, 0)
                c = (ry // 4) * 8 + rx // 4
                e = torch.tensor([cells[int(i)][0] if o else 0
                                  for i, o in zip(c, ok)])
                t = torch.tensor([cells[int(i)][1] if o else -1
                                  for i, o in zip(c, ok)])
                ty = torch.tensor([cells[int(i)][2] if o else 0
                                   for i, o in zip(c, ok)])
                act = ok & (t == tx) & (e > 0)
                dconly = (e == 1) & ((ty == 0) | (tx == 3)) & ~torch.tensor(
                    lossless)
                adst_a = (tx < 3) & ((ty == 1) | (ty == 3))
                adst_b = (tx < 3) & ((ty == 2) | (ty == 3))
                nin = SZ // 2 if pair else SZ
                j = torch.arange(nin)
                rows_in = (2 * j[None] + half[:, None]) if pair \
                    else j[None].expand(256, nin)
                if full:
                    a = act & ~dconly
                    ins = coef[ry0 + ry[:, None] + rows_in,
                               rx0 + rx[:, None] + line[:, None]]
                    o = _pair32(ins, half) if pair else _pass(
                        tx, lossless, ins, adst_a, True)
                    cols = torch.where(half[:, None], SZ - 1 - j[None],
                                       j[None]) if pair else j[None]
                    rr = (ry + line)[:, None].expand(-1, nin)
                    cc = rx[:, None] + cols
                    tmp[rr[a], cc[a]] = itxfm._wrap16(o)[a]
                    if consume is not None:   # the quads read nonzero
                        f = (a[:, None] & (ins != 0)).numpy()
                        ly = (ry[:, None] + rows_in).numpy()
                        lx = np.broadcast_to(((rx + line) // 4)[:, None]
                                             .numpy(), ly.shape)
                        nz[ly[f], lx[f]] = True
                # pass b
                d = act & dconly
                dcv = itxfm._rs(itxfm._rs(coef[ry0 + ry, rx0 + rx] * 11585)
                                * 11585)
                dcv = (dcv + rnd) >> shift
                drows = ry[:, None] + j[None] + half[:, None].int() * nin
                dcol = (rx + line)[:, None].expand(-1, nin)
                acc.index_put_((drows[d], dcol[d]),
                               dcv[:, None].expand(-1, nin)[d],
                               accumulate=True)
                f = act & ~dconly
                ins = tmp[ry[:, None] + rows_in, (rx + line)[:, None]]
                o = _pair32(ins, half) if pair else _pass(
                    tx, lossless, ins, adst_b, False)
                orow = ry[:, None] + (torch.where(half[:, None],
                                                  SZ - 1 - j[None], j[None])
                                      if pair else j[None])
                vals = (itxfm._wrap16(o) + rnd) >> shift
                acc.index_put_((orow[f], dcol[f]), vals[f], accumulate=True)
                if consume is not None:          # a DC-only root's DC
                    nz[ry[d].numpy(), (rx[d] // 4).numpy()] = True
            out[ry0:ry0 + 32, rx0:rx0 + 32] = acc[:H - ry0, :W - rx0]
            if consume is None:
                continue
            for t_ in range(256):                 # clear_quad
                oy, ox = t_ // 8, (t_ % 8) * 4
                if nz[oy, ox // 4] and ry0 + oy < H and rx0 + ox < W:
                    coef_in[ry0 + oy, rx0 + ox:rx0 + ox + 4] = 0
    assert int(out.min()) > -(1 << 30)
    return out


def test_idct32_halves_are_the_32_point_dct():
    """idct16 of the even inputs and the kernel's idct32_odd of the odd
    ones, joined as the two lanes join them, are ops/itxfm.py's
    idct32_1d at int16 extremes and random values."""
    rng = np.random.RandomState(3)
    x = np.concatenate([rng.randint(-32768, 32768, (64, 32)),
                        rng.choice([32767, -32768, 0], (64, 32))])
    x = torch.as_tensor(x, dtype=torch.int32)
    want = itxfm.idct32_1d(itxfm.TORCH, x)
    half = torch.arange(2 * len(x)) & 1
    ins = torch.stack([x[:, 0::2], x[:, 1::2]], 1).reshape(-1, 16)
    o = _pair32(ins, half.bool()).view(-1, 2, 16)
    assert torch.equal(o[:, 0], want[:, :16])
    assert torch.equal(o[:, 1], want[:, 16:].flip(-1))


@pytest.mark.parametrize("name", ["mixed", "mixed_wide", "lossless", "dc1",
                                  "dc3"])
def test_residual_thread_model_matches_jax(name, frames):
    planes, cp, ep, geoms = frames[name]
    lossless = CASES[name][0] == "lossless"
    _jc, _je, jres = _jax_residuals(cp, ep, geoms, planes, lossless)
    _c, _e, jobs, _r = _port_residuals(cp, ep, geoms, planes, lossless)
    stats = {"skipped": 0, "pass_a": 0, "dc_only": 0}
    for job, want in zip(jobs, jres):
        _same(want, _residual_model(*job, lossless, stats))
    if name.startswith("mixed"):
        assert stats["skipped"] and stats["pass_a"]
    if name.startswith("dc"):
        assert stats["dc_only"] and not stats["pass_a"]


def test_residual_thread_model_runs_32x32_pairs(frames):
    """The mixed frame has full 32x32 blocks: the lane pairs' path."""
    planes, cp, ep, geoms = frames["mixed"]
    tx, eob = planes[0][2], planes[0][1]
    assert ((tx == 3) & (eob > 1)).any()


# ---------------------------------------------------------------------------
# the buffers recon_frame keeps from frame to frame

# frame sequences on one buffer set: (kind, wide) per frame, each frame
# holding only its coded roots' values (_coded); later frames have fewer
# coefficients and other sizes than the first
SEQUENCES = {
    "32x32_then_4x4": (("full3", False), ("full0", False)),
    "mixed_then_empty": (("mixed", False), ("empty", False),
                         ("dc2", False)),
    "dc_then_mixed": (("dc3", False), ("mixed", False), ("dc0", False)),
    "lossless_then_16x16": (("lossless", False), ("full2", False)),
    "wide": (("mixed", True), ("full1", True)),
}


def _sequence(name):
    return [_frame_of(kind, wide, 97 * k + sum(map(ord, name)), coded=True)
            + (kind == "lossless",)
            for k, (kind, wide) in enumerate(SEQUENCES[name])]


def _lengths(geoms):
    return (sum(sh[0] * sh[1] for sh, _e, _b, _eb in geoms),
            sum(e[0] * e[1] for _sh, e, _b, _eb in geoms))


def _views(flat_c, flat_e, geoms, planes, device="cpu"):
    return [P._slice_plane(flat_c[None], flat_e[None], bc, be, sh[0], sh[1],
                           esh[0], esh[1]) + (_t(tx).to(device),
                                              _t(ty).to(device))
            for (sh, esh, bc, be), (_c, _e, tx, ty) in zip(geoms, planes)]


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_kept_buffers_over_a_sequence_match_jax(name):
    """scatter_frame into one buffer set with no memset, then the
    consuming residual_planes, frame after frame: each frame equals the
    JAX functions on fresh buffers, and both buffers read zero after
    it, with no zero-fill."""
    frames = _sequence(name)
    fills = dict(P.COEF_FILLS)
    Lc, Le = _lengths(frames[0][3])
    bufs = P.CoefBuffers(torch.device("cpu"), Lc, Le, frames[0][1].shape[1] == 4)
    for planes, cp, ep, geoms, lossless in frames:
        _jc, _je, jres = _jax_residuals(cp, ep, geoms, planes, lossless)
        flat_c, flat_e = P.scatter_frame(bufs, _t(cp), _t(ep))
        assert not bufs.consumed
        res = P.residual_planes(_views(flat_c, flat_e, geoms, planes),
                                lossless, 8, consume=[bufs] * 3)
        for want, got in zip(jres, res):
            _same(want, got)
        assert bufs.consumed and bufs.read_zero()
        assert not int(bufs.strays[0])
    assert P.COEF_FILLS == fills


def _model_scatter(flat, rows):
    """The memset-free scatter of the kernel's threads: each row's value
    written at its position, nothing else touched."""
    rows = rows.astype(np.int64)
    pos = (rows[:, 0] << 16) | (rows[:, 1] & 0xffff)
    val = ((rows[:, 2] << 16) | (rows[:, 3] & 0xffff)) \
        if rows.shape[1] == 4 else rows[:, 2]
    ok = (pos >= 0) & (pos < flat.numel())
    flat[torch.as_tensor(pos[ok])] = torch.as_tensor(val[ok]).to(flat.dtype)


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_kernel_model_over_a_sequence_matches_jax(name):
    """The model of the kernels' threads (the memset-free scatter, the
    consuming residual) over the same sequences on one buffer set."""
    frames = _sequence(name)
    Lc, Le = _lengths(frames[0][3])
    wide = frames[0][1].shape[1] == 4
    flat_c = torch.zeros(Lc, dtype=torch.int32 if wide else torch.int16)
    flat_e = torch.zeros(Le, dtype=torch.int16)
    stats = {"skipped": 0, "pass_a": 0, "dc_only": 0}
    for planes, cp, ep, geoms, lossless in frames:
        _jc, _je, jres = _jax_residuals(cp, ep, geoms, planes, lossless)
        _model_scatter(flat_c, cp)
        _model_scatter(flat_e, ep)
        consume = {}
        for job, want in zip(_views(flat_c, flat_e, geoms, planes), jres):
            _same(want, _residual_model(*job, lossless, stats, consume))
        assert not consume and not flat_c.any() and not flat_e.any()


@pytest.mark.parametrize("name", ["mixed", "lossless", "dc1", "dc3"])
def test_kernel_model_clears_what_the_plain_version_clears(name, frames):
    """On frames with values outside every coded root (which pass A
    never hands over), the model's clear and _consume_plain leave the
    same values behind, and both clear every eob cell."""
    planes, cp, ep, geoms = frames[name]
    lossless = CASES[name][0] == "lossless"
    Lc, Le = _lengths(geoms)
    wide = cp.shape[1] == 4
    bufs = [(torch.zeros(Lc, dtype=torch.int32 if wide else torch.int16),
             torch.zeros(Le, dtype=torch.int16)) for _ in range(2)]
    for fc, fe in bufs:
        _model_scatter(fc, cp)
        _model_scatter(fe, ep)
    stats = {"skipped": 0, "pass_a": 0, "dc_only": 0}
    consume = {}
    for job in _views(*bufs[0], geoms, planes):
        _residual_model(*job, lossless, stats, consume)
    strays = [P._consume_plain(*job, lossless)
              for job in _views(*bufs[1], geoms, planes)]
    assert torch.equal(bufs[0][0], bufs[1][0])
    assert not bufs[0][1].any() and not bufs[1][1].any()
    assert bufs[0][0].any()
    assert bool(consume) == any(strays)


def test_a_stray_or_an_unconsumed_scatter_is_zero_filled():
    """A coded root that the residual does not transform (a size past
    3) leaves its values in the buffers and sets the strays flag; a
    scatter with no consuming residual after it leaves them unconsumed.
    Either way the next scatter zero-fills first, COEF_FILLS counts it,
    and the next frame equals the JAX functions."""
    frames = _sequence("dc_then_mixed")
    planes, cp, ep, geoms, lossless = frames[0]
    coef, eob, tx, ty = planes[0]
    y, x = (int(v[0]) for v in np.nonzero((eob > 0) & (tx == 3)))
    tx = tx.copy()
    tx[y, x] = 4
    planes = [(coef, eob, tx, ty)] + list(planes[1:])
    Lc, Le = _lengths(geoms)
    bufs = P.CoefBuffers(torch.device("cpu"), Lc, Le, False)
    fills = dict(P.COEF_FILLS)
    _jc, _je, jres = _jax_residuals(cp, ep, geoms, planes, lossless)
    res = P.residual_planes(_views(*P.scatter_frame(bufs, _t(cp), _t(ep)),
                                   geoms, planes), lossless, 8,
                            consume=[bufs] * 3)
    for want, got in zip(jres, res):
        _same(want, got)
    assert int(bufs.strays[0]) == 1 and not bufs.read_zero()
    for cause in ("stray", "unconsumed"):
        planes, cp, ep, geoms, lossless = frames[1]
        if cause == "unconsumed":
            P.scatter_frame(bufs, _t(cp), _t(ep))
        _jc, _je, jres = _jax_residuals(cp, ep, geoms, planes, lossless)
        res = P.residual_planes(
            _views(*P.scatter_frame(bufs, _t(cp), _t(ep)), geoms, planes),
            lossless, 8, consume=[bufs] * 3)
        for want, got in zip(jres, res):
            _same(want, got)
        fills[cause] += 1
        assert P.COEF_FILLS == fills
        assert bufs.read_zero() and not int(bufs.strays[0])


def _mini():
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    try:
        import mini_encoder
    finally:
        sys.path.pop(0)
    return mini_encoder


@pytest.mark.parametrize("native", [True, False])
def test_decode_leaves_the_kept_buffers_zero(native):
    """A decode on the CPU, frame by frame, with the native pass A
    (merged pair rows, one buffer set) and the pure-Python one (a
    buffer set a plane): every frame equals the JAX golden backend's,
    and after each every kept buffer reads zero with no zero-fill."""
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder as JDec
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder

    m = _mini()
    pkts = [m.encode_keyframe_random(64, 64, 8, seed=11, txfmmode=4,
                                     yac_qi=40, filter_level=0)]
    pkts += [m.encode_inter_flex(64, 64, seed=29 + i, coeffs=True,
                                 p_intra=0.3, p_skip=0.2,
                                 mv_mags=(0, 2, 8), filter_level=0)
             for i in range(2)]
    port = VP9Decoder(device="cpu", use_native=native)
    gold = JDec(recon_backend="golden", use_native=native)
    fills = dict(P.COEF_FILLS)
    for pkt in pkts:
        (got,) = port.decode(pkt)
        (want,) = gold.decode(pkt)
        assert got.to_bytes() == want.to_bytes()
        kept = list(port.coef_bufs.values())
        assert kept and all(b.read_zero() and b.consumed for b in kept)
    assert P.COEF_FILLS == fills
    slots = {k[1] for k in port.coef_bufs}
    assert slots == ({"merged"} if native else {0, 1, 2})


@pytest.mark.parametrize("native", [True, False])
def test_two_decoders_of_one_geometry_interleave(native, monkeypatch):
    """Two decoders of one geometry, their pass B interleaved as two
    threads could interleave them: the second decoder's whole frame
    (scatter and consuming residual) runs between the first's scatter
    and its residual. Each decoder keeps its own buffers, so both
    frames equal the JAX golden backend's, with no zero-fill."""
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder as JDec
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder

    m = _mini()
    streams = [[m.encode_keyframe_random(64, 64, 8, seed=seed, txfmmode=4,
                                         yac_qi=40, filter_level=0)]
               + [m.encode_inter_flex(64, 64, seed=seed + 1, coeffs=True,
                                      p_intra=0.3, p_skip=0.2,
                                      mv_mags=(0, 2, 8), filter_level=0)]
               for seed in (5, 17)]
    decs = [VP9Decoder(device="cpu", use_native=native) for _ in streams]
    golds = [JDec(recon_backend="golden", use_native=native)
             for _ in streams]
    real = P.residual_planes
    pending = []

    def interleaved(*args, **kwargs):
        if pending:
            P.recon_frame(pending.pop())
        return real(*args, **kwargs)

    monkeypatch.setattr(P, "residual_planes", interleaved)
    fills = dict(P.COEF_FILLS)
    for pa, pb in zip(*streams):
        ja, jb = decs[0].decode_pass_a(pa), decs[1].decode_pass_a(pb)
        pending.append(jb)
        P.recon_frame(ja)
        assert not pending
        for job, gold, pkt in ((ja, golds[0], pa), (jb, golds[1], pb)):
            (want,) = gold.decode(pkt)
            assert job.outputs[0].to_bytes() == want.to_bytes()
    assert P.COEF_FILLS == fills
    assert not {id(b) for b in decs[0].coef_bufs.values()} & \
        {id(b) for b in decs[1].coef_bufs.values()}


CLIP_FRAMES = {"bench_1080p": 30, "bench_1080p_lf": 6, "bench_4k": 12}


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("clip", list(CLIP_FRAMES))
def test_pass_a_rows_lie_in_the_tiles_the_residual_clears(clip, native):
    """The precondition of the consuming residual, which its kernel does
    not detect: every nonzero coefficient that pass A ships lies in the
    tile of a root that the residual transforms, and a DC-only root
    ships its DC alone. On the repository's clips (every frame with the
    native pass A, the first with the pure-Python one), each frame's
    rows are scattered into fresh buffers as recon_frame scatters them
    (scatter_planes), and what the consuming residual clears
    (_consume_plain) leaves both buffers zero with no stray eob cell."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu_torch.formats.ivf import read_ivf
    from ffmpeg_hybrid_tpu_torch.formats.superframe import split_superframe

    _info, pkts = read_ivf(os.path.join(os.path.dirname(__file__), "..",
                                        "vectors", clip + ".ivf"))
    frames = [fd for pts, data in pkts
              for _p, fd in split_superframe(data, pts)]
    assert len(frames) == CLIP_FRAMES[clip]
    dec = VP9Decoder(device="cpu", use_native=native)
    coded = 0
    for fd in frames[:None if native else 1]:
        job = dec.decode_pass_a(fd)
        if job.ready is not None:
            continue
        P.precompute_host(job)
        P.upload_job(job)
        job.coef_bufs = {}
        coefs, consume = P.scatter_planes(job)
        r4, c4 = job.txsz4.shape
        g = P._grids_from_records(job.pre["dev"]["recs"], r4, c4, job.ss_h,
                                  job.ss_v)
        lossless = bool(job.header.lossless)
        for (coef, eob4), (tx, ty) in zip(coefs, ((g[1], g[2]),
                                                  (g[8], g[9]),
                                                  (g[8], g[9]))):
            coded += int((eob4 != 0).sum())
            assert not P._consume_plain(coef, eob4, tx, ty, lossless)
        assert all(b.read_zero() for b in consume)
    assert coded


# ---------------------------------------------------------------------------
# the wrappers off the CPU


def test_wrappers_off_cpu_go_to_the_kernels(monkeypatch, frames):
    """Tensors off the CPU reach the scatter (one call: a memset pair and
    a launch) and one residual launch for the three planes, never the
    plain versions; arguments are checked first."""
    planes, cp, ep, geoms = frames["mixed"]
    meta = torch.device("meta")
    cpm, epm = _t(cp).to(meta), _t(ep).to(meta)
    RC.reset_launches()
    with pytest.raises(ValueError, match="not a CUDA device"):
        P.scatter_coef(cpm, epm, 100, 10)
    launched = []

    def fake_launch(source, signatures, name, *args):
        launched.append((source, name, args))

    monkeypatch.setattr(_cuda, "launch", fake_launch)
    for fn in ("_scatter_pairs16", "_scatter_pairs32",
               "residual_plane_plain"):
        monkeypatch.setattr(P, fn, None)
    Lc = sum(sh[0] * sh[1] for sh, _e, _b, _eb in geoms)
    Le = sum(e[0] * e[1] for _sh, e, _b, _eb in geoms)
    flat_c, flat_e = P.scatter_coef(cpm, epm, Lc, Le)
    assert (flat_c.shape, flat_c.dtype) == ((Lc,), torch.int16)
    assert (flat_e.shape, flat_e.dtype) == ((Le,), torch.int16)
    src, name, args = launched[-1]
    assert (src, name) == ("itxfm.cu", "scatter_pairs")
    assert args[0] is cpm and args[3] is epm
    assert args[1:3] == (cp.shape[0], 3) and args[4] == ep.shape[0]
    assert args[5] is flat_c and args[7] is flat_e
    assert args[6::2] == (Lc, Le) and args[9] == 1   # fresh: zero-filled
    wide = P.scatter_coef(cpm.new_zeros((8, 4)), epm, Lc, Le)[0]
    assert wide.dtype == torch.int32
    jobs = [P._slice_plane(flat_c[None], flat_e[None], bc, be, sh[0], sh[1],
                           esh[0], esh[1]) + (_t(tx).to(meta),
                                              _t(ty).to(meta))
            for (sh, esh, bc, be), (_c, _e, tx, ty) in zip(geoms, planes)]
    outs = P.residual_planes(jobs, False, 8)
    src, name, args = launched[-1]
    assert (src, name) == ("itxfm.cu", "residual_planes")
    ptrs, _dims, n, lossless, strays = args
    assert (n, lossless, strays) == (3, 0, None) and len(ptrs) == 15
    for k, (job, out) in enumerate(zip(jobs, outs)):
        assert all(a is b for a, b in zip(ptrs[5 * k:5 * k + 4], job))
        assert ptrs[5 * k + 4] is out and out.shape == job[0].shape
    assert RC.LAUNCHES == {"residual": 1, "residual_hbd": 0,
                           "intra": 0, "splat": 0, "scatter": 2, "mc": 0,
                           "mc_scaled": 0}
    with pytest.raises(TypeError):
        P.scatter_coef(cpm.to(torch.int32), epm, Lc, Le)
    with pytest.raises(ValueError):
        P.scatter_coef(cpm.new_zeros((8, 5)), epm, Lc, Le)
    with pytest.raises(ValueError):
        P.scatter_coef(cpm, epm, 0, Le)
    with pytest.raises(ValueError, match="at most 3"):
        P.residual_planes(jobs + jobs[:1], False, 8)
    assert RC.LAUNCHES["residual"] == 1 and RC.LAUNCHES["scatter"] == 2
    # the kept buffers: one scatter launch with no memset, then a
    # consuming residual launch with the buffers' strays flag a plane
    bufs = P.CoefBuffers(meta, Lc, Le, False)
    fc, fe = P.scatter_frame(bufs, cpm, epm)
    src, name, args = launched[-1]
    assert name == "scatter_pairs" and args[5] is bufs.flat_c is fc
    assert args[7] is bufs.flat_e is fe and args[9] == 0
    P.residual_planes(jobs[:0] + [
        P._slice_plane(fc[None], fe[None], bc, be, sh[0], sh[1], esh[0],
                       esh[1]) + (_t(tx).to(meta), _t(ty).to(meta))
        for (sh, esh, bc, be), (_c, _e, tx, ty) in zip(geoms, planes)],
        False, 8, consume=[bufs] * 3)
    src, name, args = launched[-1]
    assert name == "residual_planes"
    assert args[4] == [bufs.strays.data_ptr()] * 3
    assert bufs.consumed
    P.scatter_frame(bufs, cpm, epm)
    fills = dict(P.COEF_FILLS)
    P.scatter_frame(bufs, cpm, epm)          # the last one unconsumed
    assert launched[-1][2][9] == 1
    assert P.COEF_FILLS["unconsumed"] == fills["unconsumed"] + 1
    assert RC.LAUNCHES["residual"] == 2 and RC.LAUNCHES["scatter"] == 5


# ---------------------------------------------------------------------------
# on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_scatter_and_residual_kernels_match_plain_on_the_card(name, frames):
    dev = _card()
    planes, cp, ep, geoms = frames[name]
    lossless = CASES[name][0] == "lossless"
    want = _port_residuals(cp, ep, geoms, planes, lossless)
    RC.reset_launches()
    got = _port_residuals(cp, ep, geoms, planes, lossless, dev)
    assert RC.LAUNCHES["scatter"] == 1 and RC.LAUNCHES["residual"] == 1
    assert torch.equal(want[0], got[0].cpu())
    assert torch.equal(want[1], got[1].cpu())
    for a, b in zip(want[3], got[3]):
        assert torch.equal(a, b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SEQUENCES))
def test_kept_buffers_on_the_card_over_a_sequence(name):
    """The kernels on one kept buffer set, frame after frame: each frame
    equals the plain version on fresh buffers, one scatter launch (no
    memset) and one consuming residual launch a frame, and both buffers
    read zero after it."""
    dev = _card()
    frames = _sequence(name)
    Lc, Le = _lengths(frames[0][3])
    bufs = P.CoefBuffers(torch.device(dev), Lc, Le,
                         frames[0][1].shape[1] == 4)
    fills = dict(P.COEF_FILLS)
    RC.reset_launches()
    for planes, cp, ep, geoms, lossless in frames:
        want = _port_residuals(cp, ep, geoms, planes, lossless)[3]
        flat_c, flat_e = P.scatter_frame(bufs, _t(cp).to(dev),
                                         _t(ep).to(dev))
        got = P.residual_planes(_views(flat_c, flat_e, geoms, planes, dev),
                                lossless, 8, consume=[bufs] * 3)
        for a, b in zip(want, got):
            assert torch.equal(a, b.cpu())
        assert bufs.read_zero() and bufs.fill_cause() is None
    assert RC.LAUNCHES["scatter"] == RC.LAUNCHES["residual"] == len(frames)
    assert P.COEF_FILLS == fills


@pytest.mark.cuda
def test_a_stray_on_the_card_is_zero_filled():
    """The kernel sets the strays flag (pinned host memory) on a root of
    size 4, and the next scatter zero-fills first."""
    dev = _card()
    frames = _sequence("dc_then_mixed")
    planes, cp, ep, geoms, lossless = frames[0]
    coef, eob, tx, ty = planes[0]
    y, x = (int(v[0]) for v in np.nonzero((eob > 0) & (tx == 3)))
    tx = tx.copy()
    tx[y, x] = 4
    planes = [(coef, eob, tx, ty)] + list(planes[1:])
    Lc, Le = _lengths(geoms)
    bufs = P.CoefBuffers(torch.device(dev), Lc, Le, False)
    P.residual_planes(_views(*P.scatter_frame(bufs, _t(cp).to(dev),
                                              _t(ep).to(dev)), geoms,
                             planes, dev), lossless, 8, consume=[bufs] * 3)
    assert bufs.fill_cause() == "stray" and not bufs.read_zero()
    fills = dict(P.COEF_FILLS)
    planes, cp, ep, geoms, lossless = frames[1]
    want = _port_residuals(cp, ep, geoms, planes, lossless)[3]
    got = P.residual_planes(_views(*P.scatter_frame(bufs, _t(cp).to(dev),
                                                    _t(ep).to(dev)),
                                   geoms, planes, dev), lossless, 8,
                            consume=[bufs] * 3)
    for a, b in zip(want, got):
        assert torch.equal(a, b.cpu())
    assert P.COEF_FILLS["stray"] == fills["stray"] + 1
    assert bufs.read_zero() and bufs.fill_cause() is None


@pytest.mark.cuda
def test_scatter_kernel_rows_unaligned_and_odd():
    """The scatter on views of the pair rows that start at an odd row and
    hold odd counts of rows equals the plain version."""
    dev = _card()
    planes, cp, ep, geoms = _frame("mixed")
    Lc, Le = _lengths(geoms)
    for c0, e0, cn, en in ((0, 0, len(cp), len(ep)), (1, 1, 1001, 77),
                           (0, 1, 1001, 76), (2, 0, 998, 77)):
        c, e = _t(cp)[c0:c0 + cn], _t(ep)[e0:e0 + en]
        got = P.scatter_coef(_t(cp).to(dev)[c0:c0 + cn],
                             _t(ep).to(dev)[e0:e0 + en], Lc, Le)
        want = P.scatter_coef(c, e, Lc, Le)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
