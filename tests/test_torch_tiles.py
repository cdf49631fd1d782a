"""The port's tile-column-sharded recon steps (parallel/tiles.py) on CPU
meshes against the JAX package's, with tolerance 0: sharded_recon_step
on a (2, 4) mesh against the JAX step on the 8 virtual CPU devices, and
its unsharded reference (the twin of tests/parallel_consistency_main.py,
which tests/test_parallel.py runs), with halos and summed counts; and
sharded_frame_recon on a real inter frame's tensors against the port's
serial inter pass (the twin of tests/test_tiles_real.py), on 2 and 4
stripes. The mesh: gop rows of tile slots on one device each."""
import os
import sys

import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from ffmpeg_hybrid_tpu_torch.parallel import tiles as PT
from ffmpeg_hybrid_tpu_torch.parallel.mesh import Mesh, make_mesh

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")


def _dense_coef(s):
    """Dense coefficient planes and eob grids as numpy of a frame's pass
    A, from whichever form it produced (dense host planes, or the native
    emit-mode (pos, value) pair stream): the counterpart of the JAX
    package's fullframe._dense_coef."""
    from ffmpeg_hybrid_tpu_torch.ops import recon
    if getattr(s, "coef_pairs", None) is not None:
        merged = recon._merged_from_pairs(s)
        if merged is not None:
            cp_m, ep_m, geoms = merged
            scat = recon._scatter_pairs32 if cp_m.shape[1] == 4 \
                else recon._scatter_pairs16
            Lc = sum(sh[0] * sh[1] for sh, _e, _b, _eb in geoms)
            Le = sum(e[0] * e[1] for _sh, e, _b, _eb in geoms)
            flat_c = scat(torch.from_numpy(cp_m), 1, Lc)
            flat_e = recon._scatter_pairs16(torch.from_numpy(ep_m), 1, Le)
            out = []
            for p in range(3):
                sh, esh, bc, be = geoms[p]
                c, e = recon._slice_plane(flat_c, flat_e, bc, be, sh[0],
                                          sh[1], esh[0], esh[1])
                out.append((c.numpy(), e.numpy()))
            return out
    return [(np.asarray(s.coef_y, np.int32), np.asarray(s.eob_y)),
            (np.asarray(s.coef_u, np.int32), np.asarray(s.eob_u)),
            (np.asarray(s.coef_v, np.int32), np.asarray(s.eob_v))]


def _inputs(gop, ntile, seed=7, H=64, Ws=64):
    rng = np.random.RandomState(seed)
    W = Ws * ntile
    r4, c4 = H // 4, W // 4
    return (rng.randint(-32, 32, (gop, H, W)).astype(np.int32),
            rng.randint(0, 17, (gop, r4, c4)).astype(np.int32),
            rng.randint(0, 4, (gop, r4, c4)).astype(np.int32),
            rng.randint(-48, 48, (gop, r4, c4, 2, 2)).astype(np.int32),
            rng.randint(0, 3, (gop, r4, c4, 2)).astype(np.int32),
            rng.randint(0, 2, (gop, r4, c4)).astype(np.int32),
            rng.randint(0, 4, (gop, r4, c4)).astype(np.int32),
            rng.randint(0, 2, (gop, r4, c4)).astype(np.int32),
            rng.randint(0, 255, (gop, 3, H, W)).astype(np.int32),
            rng.randint(0, 100, (gop, ntile, 64)).astype(np.int32))


def test_make_mesh():
    """make_mesh: 8 slots as 2 gop rows of 4 tile slots, 6 as 2 x 3, 3 as
    1 x 3; every slot of a row on its device; rows on cpu when asked."""
    m = make_mesh(8, device="cpu")
    assert m.devices.shape == (2, 4)
    assert make_mesh(6, device="cpu").devices.shape == (2, 3)
    assert make_mesh(3, device="cpu").devices.shape == (1, 3)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    with pytest.raises(ValueError):
        make_mesh(6, 4, device="cpu")
    with pytest.raises(ValueError):
        Mesh([[torch.device("cpu"), torch.device("meta")]])


def test_sharded_recon_step_matches_jax():
    """The (gop, tile) step on a (2, 4) mesh: outputs, both halos (the
    cyclic ppermute) and the summed counts equal the JAX step's, and each
    row's output equals the unsharded residual + MC."""
    from ffmpeg_hybrid_tpu.ops import recon_tpu
    from ffmpeg_hybrid_tpu.parallel.mesh import make_mesh as jax_mesh
    from ffmpeg_hybrid_tpu.parallel.tiles import sharded_recon_step as js
    args = _inputs(2, 4)
    want = [np.asarray(a) for a in js(jax_mesh(8), 8)(
        *(jnp.asarray(a) for a in args))]
    got = PT.sharded_recon_step(make_mesh(8, device="cpu"), 8)(
        *(torch.from_numpy(a) for a in args))
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), w)
    coef, eob4, txsz4, mv16, refsel, comp, filt, inter4, refstack, _c = args
    H, W = coef.shape[1:]
    for g in range(2):
        res = recon_tpu.residual_plane(
            jnp.asarray(coef[g]), jnp.asarray(eob4[g]), jnp.asarray(txsz4[g]),
            jnp.zeros(eob4[g].shape, jnp.int32), False, 8)
        mc = recon_tpu._mc_cells(
            jnp.asarray(refstack[g]), jnp.asarray(mv16[g]),
            jnp.asarray(refsel[g]), jnp.asarray(comp[g].astype(bool)),
            jnp.asarray(filt[g]), jnp.asarray(inter4[g].astype(bool)), W, H,
            8)
        assert np.array_equal(got[0][g].numpy(),
                              np.asarray(jnp.clip(mc + res, 0, 255)))
    assert np.array_equal(got[3].numpy()[:, 0], args[-1].sum(axis=1))


@pytest.mark.parametrize("ntile", [2, 4])
def test_sharded_frame_recon_real_frame(ntile):
    """The stripes of a real inter frame (a mini_encoder stream, 512 x
    128) reconstructed with the residual and MC kernels' wrappers, each
    stripe's offset folded into the motion, equal the port's serial inter
    pass on the frame (luma), which tests/test_torch_mc.py holds to the
    JAX package's."""
    sys.path.insert(0, TOOLS)
    try:
        import mini_encoder as m
    finally:
        sys.path.pop(0)
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu_torch.ops import recon
    k = m.encode_keyframe_random(512, 128, seed=3, filter_level=0)
    f1 = m.encode_inter_flex(512, 128, seed=4, refresh_mask=0x02,
                             coeffs=True, p_intra=0.0, p_skip=0.2,
                             mv_mags=(0, 2, 8, 32, 96), comppredmode=2,
                             signbias=(0, 0, 1), filtermode=4)
    dec = VP9Decoder(device="cpu")
    dec.decode(k)
    job = dec.decode_pass_a(f1)
    recon.precompute_host(job)
    h = job.header
    r4, c4 = job.txsz4.shape
    (inter4, txsz4, txtype4, comp, filt, refsel, mv16,
     *_uv) = recon._grids_from_records(torch.from_numpy(job.pre["recs"]),
                                       r4, c4, h.ss_h, h.ss_v)
    coef, eob4 = (torch.from_numpy(a) for a in _dense_coef(job)[0])
    refs = tuple(torch.as_tensor(np.asarray(job.refs[h.refidx[i]].dev[0]))
                 for i in range(3))
    w, hh = job.cur_frame_obj.size
    residual = recon.residual_plane(coef, eob4, txsz4, txtype4,
                                    bool(h.lossless), 8)
    want = recon.mc_planes([(residual, inter4, comp, filt, refsel, mv16,
                             refs, w, hh, 2, 2)], 8, True)[0]
    assert bool(inter4.any())
    step = PT.sharded_frame_recon(make_mesh(ntile, 1, device="cpu"), w,
                                  lossless=bool(h.lossless))
    got = step(coef, eob4, txsz4, txtype4, refsel, mv16, comp, filt, inter4,
               torch.stack(refs))
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_sharded_recon_step_matches_plain():
    """On the card: the (1, 4) step's outputs, halos and counts equal the
    CPU step's (the kernels against their plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    args = _inputs(1, 4, H=64, Ws=128)
    want = PT.sharded_recon_step(make_mesh(4, 1, device="cpu"), 8)(
        *(torch.from_numpy(a) for a in args))
    got = PT.sharded_recon_step(make_mesh(4, 1), 8)(
        *(torch.from_numpy(a).cuda() for a in args))
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)
