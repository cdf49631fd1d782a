"""VP9 profiles 1-3 in the port (ffmpeg_hybrid_tpu_torch): 4:2:2, 4:4:0
and 4:4:4 at 8 bits, 10 and 12 bits in every layout, on the CPU with
tolerance 0.

- Whole frames: mini_encoder keyframes (loop-filtered, every transform
  size or 4x4 only, one odd size), a 10-bit 4:4:4 lossless keyframe and
  an intra-only frame, decoded by the port (the native pass A, and the
  pure-Python one) against the JAX package's golden decoder, plane by
  plane and by the MD5 of to_bytes().
- The residual's plain version at 10/12 bpp (residual_plane_plain: every
  size and type, the DC shortcut, the lossless WHT, coefficients over the
  whole int32 range) against the numpy int64 arithmetic of the JAX
  package's ops/itxfm.py, which its golden decoder runs.
- mc_planes_plain at 10/12 bpp under each layout's MV scales against the
  JAX package's _mc_cells (CPU-JAX) and the apply.
- The intra predictor's float32 product exact on 12-bit edges.
- On a card (`cuda`): the high-bit-depth residual kernel against its
  plain version, consuming its kept buffers, and the format keyframes
  decoded on the card against the golden decoder.

No JAX `recon_backend="tpu"` decode runs here above 8 bits: its jit
compiles take a minute a format on this CPU."""
import hashlib
import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu.ops import itxfm as JI
from ffmpeg_hybrid_tpu.ops import recon_tpu as J
from ffmpeg_hybrid_tpu_torch.ops import intra_tables as it
from ffmpeg_hybrid_tpu_torch.ops import recon as P
from ffmpeg_hybrid_tpu_torch.ops import recon_cuda as RC

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")

# (w, h, bpp, ss_h, ss_v, txfmmode, filter_level, native pass A)
FRAMES = {
    "422": (64, 64, 8, 1, 0, 3, 36, True),
    "440": (96, 64, 8, 0, 1, 0, 20, True),
    "444-odd": (130, 70, 8, 0, 0, 3, 36, True),
    "420-10": (64, 64, 10, 1, 1, 0, 30, True),
    "422-10": (96, 64, 10, 1, 0, 3, 36, True),
    "444-12": (64, 64, 12, 0, 0, 3, 48, True),
    "440-12-python": (64, 64, 12, 0, 1, 0, 24, False),
}
LAYOUTS = {"420": (1, 1), "422": (1, 0), "440": (0, 1), "444": (0, 0)}


def _mini():
    sys.path.insert(0, TOOLS)
    try:
        import mini_encoder
    finally:
        sys.path.pop(0)
    return mini_encoder


def _golden(pkts):
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder
    dec = VP9Decoder(recon_backend="golden")
    return [f for p in pkts for f in dec.decode(p)]


def _port(pkts, native=True, device="cpu"):
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    dec = VP9Decoder(device=device, use_native=native)
    return list(dec.decode_stream(iter(pkts)))


def _same_frames(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        for pa, pb in zip(a.crop(), b.crop()):
            assert pa.shape == pb.shape
            assert np.array_equal(pa.astype(np.int64), pb.astype(np.int64))
        assert hashlib.md5(a.to_bytes()).hexdigest() == \
            hashlib.md5(b.to_bytes()).hexdigest()


def _keyframe(name, seed=5):
    w, h, bpp, ss_h, ss_v, txm, lvl, _native = FRAMES[name]
    return _mini().encode_keyframe_random(
        w, h, bpp, seed=seed, txfmmode=txm, yac_qi=60, filter_level=lvl,
        sharpness=3 if txm == 0 else 0, ss_h=ss_h, ss_v=ss_v)


@pytest.mark.parametrize("name", list(FRAMES))
def test_keyframe_matches_golden(name):
    """A loop-filtered keyframe of each format, bit-exact."""
    pkt = _keyframe(name)
    _same_frames(_golden([pkt]), _port([pkt], native=FRAMES[name][-1]))


def test_lossless_10bit_444_matches_golden_and_its_source():
    """encode_keyframe_lossless at 10 bits, 4:4:4: the WHT path at high
    bit depth; the frame is its source exactly."""
    rng = np.random.RandomState(7)
    y, u, v = (rng.randint(0, 1024, (48, 80)) for _ in range(3))
    pkt = _mini().encode_keyframe_lossless(y, u, v, bpp=10, ss_h=0, ss_v=0)
    got = _port([pkt])
    _same_frames(_golden([pkt]), got)
    for src, plane in zip((y, u, v), got[0].crop()):
        assert np.array_equal(src, plane.astype(np.int64))


def test_intra_only_frame_matches_golden():
    """A keyframe, then an invisible intra-only frame shown through a
    show-existing frame (a superframe of the two)."""
    from ffmpeg_hybrid_tpu_torch.formats.superframe import split_superframe
    m = _mini()
    rng = np.random.RandomState(8)
    key = m.encode_keyframe_gray(64, 64, 8)
    io = m.encode_keyframe_lossless(rng.randint(0, 256, (64, 64)),
                                    rng.randint(0, 256, (32, 32)),
                                    rng.randint(0, 256, (32, 32)), 8,
                                    intraonly=True)
    show = bytes([(0b10 << 6) | (1 << 3) | 0])
    from ffmpeg_hybrid_tpu.formats.superframe import merge_superframe
    frames = [key] + [fd for _p, fd in split_superframe(
        merge_superframe([io, show]), 0)]
    want, got = _golden(frames), _port(frames)
    assert len(got) == 2
    _same_frames(want, got)


# ---------------------------------------------------------------------------
# the residual at 10/12 bpp against the golden decoder's numpy arithmetic


def _residual_inputs(seed, kind, H=64, W=96):
    """coef (int32 over the whole range, a third at its extremes), eob,
    txsz, txtype of one plane: per 32x32 region a size (kind "mixed":
    drawn; "t<n>": n everywhere; "dc<n>": n, every block DC-only;
    "lossless": 4x4 WHT, smaller values), every type, eobs 0, 1, 2 and
    full at the roots."""
    rng = np.random.RandomState(seed)
    r4, c4 = H // 4, W // 4
    lim = 1 << 31 if kind != "lossless" else 1 << 28
    coef = rng.randint(-lim, lim, (H, W), dtype=np.int64)
    pick = rng.rand(H, W)
    coef[pick < 1 / 6] = -lim
    coef[(pick >= 1 / 6) & (pick < 1 / 3)] = lim - 1
    tx = np.zeros((r4, c4), np.int64)
    for qy in range(0, r4, 8):
        for qx in range(0, c4, 8):
            if kind == "mixed":
                tx[qy:qy + 8, qx:qx + 8] = rng.randint(0, 4)
            elif kind != "lossless":
                tx[qy:qy + 8, qx:qx + 8] = int(kind[-1])
    k = 1 << tx
    yy, xx = np.mgrid[:r4, :c4]
    root = (yy % k == 0) & (xx % k == 0)
    ty = rng.randint(0, 4, (r4, c4))
    full = (4 << tx) ** 2
    eob = np.where(root, np.choose(rng.randint(0, 4, (r4, c4)),
                                   [0 * full, 0 * full + 1, 0 * full + 2,
                                    full]), 0)
    if kind.startswith("dc"):
        eob = root.astype(np.int64)
        ty[:] = 0
    return (coef.astype(np.int32), eob.astype(np.int32), tx.astype(np.int8),
            ty.astype(np.int8))


def _numpy_residual(coef, eob, tx, ty, lossless, bpp):
    """The golden decoder's residual (codecs/vp9/golden.py _add_residual):
    each root with eob > 0 as an int64 block through the JAX package's
    ops/itxfm.py on numpy, the DC shortcut where eob == 1 and the type is
    DCT_DCT or the size 32x32, summed into the plane."""
    out = np.zeros(coef.shape, np.int64)
    r4, c4 = eob.shape
    for t in ((0,) if lossless else range(4)):
        k, sz = 1 << t, 4 << t
        ys, xs = np.nonzero((tx == t) & (eob > 0))
        keep = (ys % k == 0) & (xs % k == 0) & (ys + k <= r4) \
            & (xs + k <= c4)
        for y, x in zip(ys[keep], xs[keep]):
            blk = coef[4 * y:4 * y + sz, 4 * x:4 * x + sz].astype(np.int64)
            if lossless:
                r = JI.itxfm_2d(np, blk, 4, 0, bpp)
            elif eob[y, x] == 1 and (ty[y, x] == 0 or t == 3):
                r = JI.dc_only_residual(blk[0, 0], t)
            else:
                r = JI.round_residual(JI.itxfm_2d(np, blk, t, int(ty[y, x]),
                                                  bpp), t)
            out[4 * y:4 * y + sz, 4 * x:4 * x + sz] += r
    return out


RESIDUAL_KINDS = ["mixed", "t0", "t1", "t2", "t3", "dc0", "dc1", "dc2", "dc3",
                  "lossless"]


@pytest.mark.parametrize("bpp", [10, 12])
@pytest.mark.parametrize("kind", RESIDUAL_KINDS)
def test_residual_plain_matches_golden_numpy(kind, bpp):
    coef, eob, tx, ty = _residual_inputs(bpp * 31 + RESIDUAL_KINDS.index(
        kind), kind)
    lossless = kind == "lossless"
    want = _numpy_residual(coef, eob, tx, ty, lossless, bpp)
    got = P.residual_plane(*(torch.from_numpy(np.ascontiguousarray(a))
                             for a in (coef, eob, tx, ty)), lossless, bpp)
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy().astype(np.int64)), \
        np.argwhere(want != got.numpy())[:4]
    assert want.any()


def test_residual_rounds_in_32_bits_as_the_reference():
    """The final rounding of a 10/12-bit pass-b output is the reference
    wrapper's (int)(v + (1U << (bits - 1))) >> bits, which wraps within
    2^(bits-1) of the int32 maximum (the numpy int64 rounding does not)."""
    v = torch.tensor([2 ** 31 - 1, 2 ** 31 - 33, -2 ** 31, 5, -6],
                     dtype=torch.int64)
    got = P._round_residual(v, 2, 10).tolist()
    assert got == [-2 ** 25, 2 ** 25 - 1, -2 ** 25, 0, 0]
    assert P._round_residual(v, 4, 12).tolist() == v.tolist()  # lossless


# ---------------------------------------------------------------------------
# MC at 10/12 bpp under each layout


@pytest.mark.parametrize("bpp", [10, 12])
@pytest.mark.parametrize("lay", list(LAYOUTS))
def test_mc_planes_plain_matches_jax(lay, bpp):
    """Y and two chroma planes as recon_frame hands them to mc_planes:
    chroma subsampled by the layout, MVs scaled by 2 along each axis that
    is not; compound cells, every filter bank, MVs past the frame's
    edges; held to the JAX _mc_cells and the apply."""
    ss_h, ss_v = LAYOUTS[lay]
    rng = np.random.RandomState(bpp + 7 * len(lay) + ss_h + 2 * ss_v)
    maxp = (1 << bpp) - 1
    jobs, wants = [], []
    for i in range(3):
        H, W = (32 >> (ss_v if i else 0)), (48 >> (ss_h if i else 0))
        w, h = W - 3, H - 2
        mvsx, mvsy = (2, 2) if i == 0 else (1 << (1 - ss_h), 1 << (1 - ss_v))
        r4, c4 = H // 4, W // 4
        refs = rng.randint(0, maxp + 1, (3, H, W)).astype(np.int32)
        mv16 = rng.randint(-300, 300, (r4, c4, 2, 2)).astype(np.int32)
        refsel = rng.randint(0, 3, (r4, c4, 2)).astype(np.int32)
        comp = rng.rand(r4, c4) < 0.5
        filt = rng.randint(0, 4, (r4, c4)).astype(np.int32)
        inter = rng.rand(r4, c4) < 0.8
        residual = rng.randint(-maxp, maxp + 1, (H, W)).astype(np.int32)
        mc = np.asarray(J._mc_cells(
            jnp.asarray(refs), jnp.asarray(mv16), jnp.asarray(refsel),
            jnp.asarray(comp), jnp.asarray(filt), jnp.asarray(inter), w, h,
            bpp, mvsx, mvsy)).astype(np.int64)
        mask = inter.repeat(4, 0).repeat(4, 1)
        wants.append(np.where(mask, np.clip(mc + residual, 0, maxp), 0))
        jobs.append((torch.from_numpy(residual), torch.from_numpy(inter),
                     torch.from_numpy(comp), torch.from_numpy(filt),
                     torch.from_numpy(refsel), torch.from_numpy(mv16),
                     tuple(torch.from_numpy(r) for r in refs), w, h, mvsx,
                     mvsy))
    for want, got in zip(wants, P.mc_planes(jobs, bpp, True)):
        assert np.array_equal(want, got.numpy().astype(np.int64))


# ---------------------------------------------------------------------------
# the intra product at 12 bits


@pytest.mark.parametrize("sz", [4, 8, 16, 32])
def test_intra_float_product_is_exact_at_12_bits(sz):
    """The plain intra predictor is floor((e @ W + 32) / 64) in float32
    (_intra_batch_apply): with 12-bit edges (all 4095, and random) every
    mode's product equals the integer one, since each partial sum stays
    below 2^24; TF32, which would round the edges to 11 bits, is off."""
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    rng = np.random.RandomState(sz)
    ne = it.edge_len(sz)
    edges = rng.randint(0, 4096, (16, ne))
    edges[0] = 4095
    edges[1, ::2] = 4095
    W = it.build_all(sz).astype(np.int64)           # [15, ne, sz*sz]
    n = len(edges) * 15
    e = np.repeat(edges, 15, 0)
    modes = np.tile(np.arange(15), len(edges))
    ext = torch.zeros(n * sz * sz + 1, dtype=torch.int32)
    d = {"eidx": torch.zeros((n, ne), dtype=torch.long),
         "emask": torch.ones((n, ne), dtype=torch.bool),
         "econst": torch.from_numpy(e.astype(np.int32)),
         "modes": torch.from_numpy(modes), "is_tm": torch.zeros(n, dtype=bool),
         "res": torch.zeros((n, sz * sz), dtype=torch.int32),
         "dest": torch.arange(n * sz * sz).reshape(n, sz * sz)}
    P._intra_batch_apply(ext, d, sz, 12)
    prod = np.einsum("ne,nep->np", e, W[modes])
    assert prod.max() < 1 << 24
    want = np.clip((prod + 32) // 64, 0, 4095)
    keep = modes != it.TM
    assert np.array_equal(ext[:-1].numpy().reshape(n, -1)[keep], want[keep])


# ---------------------------------------------------------------------------
# on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _wide_rows(planes):
    """Merged wide pair rows of planes [(coef, eob)] (4 columns: int32
    values), with pad rows, in a random order; the buffers' lengths."""
    cpos, cval, epos, evals, cbase, ebase = [], [], [], [], 0, 0
    for coef, eob in planes:
        cy, cx = np.nonzero(coef)
        cpos.append(cbase + cy * coef.shape[1] + cx)
        cval.append(coef[cy, cx].astype(np.int64))
        ey, ex = np.nonzero(eob)
        epos.append(ebase + ey * eob.shape[1] + ex)
        evals.append(eob[ey, ex])
        cbase += coef.size
        ebase += eob.size
    rng = np.random.RandomState(len(cpos))

    def rows(pos, val, ncols):
        pos, val = np.concatenate(pos), np.concatenate(val)
        out = np.zeros((len(pos) + 40, ncols), np.int16)
        P._fill_pairs(out, pos, val, len(pos))
        out[len(pos):, 0] = -1
        return torch.from_numpy(out[rng.permutation(len(out))])

    return rows(cpos, cval, 4), rows(epos, evals, 3), cbase, ebase


@pytest.mark.cuda
@pytest.mark.parametrize("bpp", [10, 12])
@pytest.mark.parametrize("kind", RESIDUAL_KINDS)
def test_residual_hbd_kernel_matches_plain_on_the_card(kind, bpp):
    """The wide scatter into kept buffers, then one consuming launch of
    residual_planes_hbd over three planes, against residual_plane_plain:
    bit for bit, the buffers zero after it, one launch counted apart."""
    _card()
    lossless = kind == "lossless"
    planes = []
    for p in range(3):
        coef, eob, tx, ty = _residual_inputs(bpp * 7 + p, kind)
        keep = np.zeros(coef.shape, bool)       # only what pass A ships
        for y, x in zip(*np.nonzero(eob)):
            sz = 4 << int(tx[y, x])
            dc = not lossless and eob[y, x] == 1 and (ty[y, x] == 0
                                                      or tx[y, x] == 3)
            keep[4 * y:4 * y + (1 if dc else sz),
                 4 * x:4 * x + (1 if dc else sz)] = True
        planes.append((np.where(keep, coef, 0).astype(np.int32), eob, tx, ty))
    cp, ep, nc, ne = _wide_rows([(c, e) for c, e, _t, _y in planes])
    bufs = P.coef_buffers({}, "cuda", "merged", nc, ne, True)
    flat_c, flat_e = P.scatter_frame(bufs, cp.cuda(), ep.cuda())
    views, bc, be = [], 0, 0
    for coef, eob, tx, ty in planes:
        (H, W), (r4, c4) = coef.shape, eob.shape
        views.append(P._slice_plane(flat_c[None], flat_e[None], bc, be, H, W,
                                    r4, c4) + (torch.from_numpy(tx).cuda(),
                                               torch.from_numpy(ty).cuda()))
        bc += H * W
        be += r4 * c4
    RC.reset_launches()
    got = P.residual_planes(views, lossless, bpp, consume=[bufs] * 3)
    assert RC.LAUNCHES["residual_hbd"] == 1 and RC.LAUNCHES["residual"] == 0
    for (coef, eob, tx, ty), g in zip(planes, got):
        want = P.residual_plane_plain(
            *(torch.from_numpy(np.ascontiguousarray(a))
              for a in (coef, eob, tx, ty)), lossless, bpp)
        assert torch.equal(want, g.cpu())
    assert bufs.read_zero() and bufs.fill_cause() is None


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FRAMES))
def test_keyframe_on_the_card_matches_golden(name):
    """Each format keyframe decoded on the card, every plain version
    unused, against the golden decoder."""
    _card()
    pkt = _keyframe(name)
    RC.reset_launches()
    got = _port([pkt], native=FRAMES[name][-1], device="cuda")
    hbd = FRAMES[name][2] > 8
    assert RC.LAUNCHES["residual_hbd"] == int(hbd)
    assert RC.LAUNCHES["residual"] == int(not hbd)
    _same_frames(_golden([pkt]), got)
