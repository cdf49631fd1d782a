"""Parts of the port's chained-GOP stripe pipeline
(parallel/gop_pipeline.py) on the CPU: the scope checks raise
ValueError with the JAX driver's message exactly where the JAX
package's decode_chained_gop asserts, on the same packets, with either
pass A; the forward step, on seeded planes, copies exactly the windows
that the JAX module's ppermute delivers; the mesh and stripe arguments
it refuses; the committed clips of tools/make_chained_vectors_torch.py
against their recipes. The pipeline against JAX and the serial decode
is tests/test_torch_gop_pipeline.py."""
import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from test_torch_gop_pipeline import chained_stream
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu.parallel.gop_pipeline import \
    decode_chained_gop as jax_decode_chained_gop
from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
from ffmpeg_hybrid_tpu_torch.parallel import dryrun
from ffmpeg_hybrid_tpu_torch.parallel.gop_pipeline import (
    build_stripe_pipeline, decode_chained_gop, forward)
from ffmpeg_hybrid_tpu_torch.parallel.mesh import make_mesh

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
G = 4
# streams outside the pipeline's scope: (inter frames, encode_inter_flex
# arguments over the chained recipe's)
OUT_OF_SCOPE = {
    "intra-block": (G, dict(p_intra=0.2)),
    "chain-breaks": (G, dict(refresh_mask=0x02)),
    "mv-beyond-bound": (G, dict(mv_mags=(1024,))),   # 128 px a delta
    "frame-count": (G - 1, {}),
}


def _tool():
    sys.path.insert(0, TOOLS)
    try:
        import make_chained_vectors_torch
    finally:
        sys.path.pop(0)
    return make_chained_vectors_torch


@pytest.mark.parametrize("use_native", [None, False],
                         ids=["native", "python"])
@pytest.mark.parametrize("name", list(OUT_OF_SCOPE))
def test_scope_checks_raise_where_jax_asserts(name, use_native):
    n, kw = OUT_OF_SCOPE[name]
    pkts = chained_stream(128, 192, n, **kw)
    mesh = Mesh(np.asarray(jax.devices()[:G]), ("gop",))
    with pytest.raises(AssertionError) as jax_err:
        jax_decode_chained_gop(pkts, mesh, Hs=64, lag=2)
    with pytest.raises(ValueError) as err:
        decode_chained_gop(pkts, make_mesh(G, G, device="cpu"), Hs=64,
                           lag=2, use_native=use_native)
    assert str(err.value) == str(jax_err.value)


def test_scope_first_packet_keyframe():
    """An intra-only first frame decodes, but roots no chained gop."""
    sys.path.insert(0, TOOLS)
    try:
        from mini_encoder import encode_keyframe_lossless
    finally:
        sys.path.pop(0)
    y = np.full((192, 128), 100, np.int32)
    u = np.full((96, 64), 100, np.int32)
    pkts = chained_stream(128, 192, G)
    first = encode_keyframe_lossless(y, u, u.copy(), intraonly=True)
    with pytest.raises(ValueError, match="the first packet must be a "
                                         "keyframe"):
        decode_chained_gop([first] + pkts[1:], make_mesh(G, G, device="cpu"))


def test_mesh_and_stripes_refused():
    pkts = chained_stream(128, 192, 2)
    with pytest.raises(ValueError, match=r"\[2, 1\] mesh, not \[2, 2\]"):
        decode_chained_gop(pkts, make_mesh(4, 2, device="cpu"))
    with pytest.raises(ValueError, match="multiple of 64"):
        decode_chained_gop(pkts, make_mesh(2, 2, device="cpu"), Hs=96)
    with pytest.raises(ValueError, match="a lag of 0"):
        decode_chained_gop(pkts, make_mesh(2, 2, device="cpu"), lag=0)
    with pytest.raises(ValueError, match=r"\[2, 1\] mesh"):
        build_stripe_pipeline(make_mesh(2, 1, device="cpu"), 2, 3, 64, 2,
                              (192, 128, 128, 192), False, 8, 1, 1)


@pytest.mark.parametrize("Hs_p", [64, 32])
def test_forward_delivers_the_scheduled_windows(Hs_p):
    """Each step the senders' planes change; after step k, row g + 1's
    reference buffer holds, for every step k' <= k at which row g had a
    stripe j' = k' - g * lag, rows [max(j' * Hs_p - 8, 0), + Hs_p + 8)
    of row g's plane as it was at step k' (the later window winning where
    two overlap), and zeros everywhere else; row 0's stays zero
    (gop_pipeline.py:131-153 of the JAX package)."""
    S_f, lag, W = 5, 2, 24
    H = S_f * Hs_p
    rng = np.random.RandomState(19)
    outs = [torch.zeros((H, W), dtype=torch.int32) for _ in range(G)]
    refs = [torch.zeros((H, W), dtype=torch.int32) for _ in range(G)]
    want = [np.zeros((H, W), np.int32) for _ in range(G)]
    for k in range(S_f + (G - 1) * lag):
        for o in outs:
            o.copy_(torch.from_numpy(rng.randint(1, 1 << 10, (H, W))
                                     .astype(np.int32)))
        forward(k, outs, refs, S_f, lag, Hs_p)
        for g in range(G - 1):
            jsrc = k - g * lag
            if 0 <= jsrc < S_f:
                y0 = max(jsrc * Hs_p - 8, 0)
                want[g + 1][y0:y0 + Hs_p + 8] = \
                    outs[g].numpy()[y0:y0 + Hs_p + 8]
        for g in range(G):
            assert np.array_equal(refs[g].numpy(), want[g]), \
                f"step {k}: row {g}'s reference buffer"
    # every row past the first received every row of its predecessor
    assert all((w != 0).all() for w in want[1:])


def test_dryrun_chained_clip_is_its_recipe():
    tool = _tool()
    pkts, w, h = tool.packets("dryrun_chained")
    got, want = dryrun.read_clip("dryrun_chained")
    assert (w, h) == (128, 192)
    assert got == pkts
    assert len(want) == len(pkts) == 5


def test_linear_bool_encoder_writes_the_mini_encoders_bytes():
    """The tool's linear-time bool coder against the mini encoder's on
    seeded runs of bools (carries through runs of 0xff bytes included)
    and on the dryrun_chained recipe, whose committed packets the mini
    encoder's own coder wrote."""
    tool = _tool()
    sys.path.insert(0, TOOLS)
    try:
        import mini_encoder as M
    finally:
        sys.path.pop(0)
    Linear = tool.linear_bool_encoder(M)
    rng = np.random.RandomState(23)
    for n in (0, 1, 7, 100, 5000, 40000):
        a, b = M.BoolEncoder(), Linear()
        probs = rng.choice([1, 2, 128, 254, 255], n)
        probs = np.where(rng.rand(n) < 0.5, rng.randint(1, 256, n), probs)
        bits = rng.rand(n) < np.where(probs > 128, 0.9, 0.2)
        for bit, p in zip(bits.tolist(), probs.tolist()):
            a.put(bit, p)
            b.put(bit, p)
        assert b.bytes() == a.bytes(), n
    original = M.BoolEncoder
    M.BoolEncoder = Linear
    try:
        pkts = tool.chained_packets(128, 192, 4)
    finally:
        M.BoolEncoder = original
    assert pkts == dryrun.read_clip("dryrun_chained")[0]


@pytest.mark.parametrize("n", sorted(dryrun.MESH_CLIPS))
def test_dryrun_mesh_clips_have_their_recipes_shapes(n):
    """Frame sizes and tile columns of the dry-run mesh clips as
    __graft_entry__.py:71-100 shapes them (the 2048x256 frame costs some
    10 s to encode again)."""
    name, (gop, ntile) = dryrun.MESH_CLIPS[n]
    assert _tool().MESH[name] == (gop, ntile)
    pkts, want = dryrun.read_clip(name)
    assert len(pkts) == len(want) == 1 + gop
    w, h = max(256, 256 * ntile), 128
    sizes = [(w, h)] * (1 + gop)
    if gop > 1:
        sizes[-1] = (2 * w, 2 * h)
    dec = VP9Decoder(device="cpu")
    for p, size in zip(pkts, sizes):
        job = dec.decode_pass_a(p)
        hd = job.header
        assert (hd.width, hd.height) == size
        assert hd.tile_cols == ntile
        assert hd.filter_level > 0


def test_chained_1080p_clip_headers():
    """vectors/chained_1080p: the chained recipe at 1920x1080 (a keyframe,
    four inter frames refreshing slot 0 from slot 0 at loop-filter levels
    20, 23, 26, 29)."""
    pkts, want = dryrun.read_clip("chained_1080p")
    assert len(pkts) == len(want) == 5
    dec = VP9Decoder(device="cpu")
    for i, p in enumerate(pkts):
        hd = dec.decode_pass_a(p).header
        assert (hd.width, hd.height) == (1920, 1080)
        assert hd.keyframe == (i == 0)
        assert hd.filter_level == 20 + 3 * max(i - 1, 0)
        if i:
            assert hd.refreshrefmask == 0x01
            assert list(hd.refidx) == [0, 0, 0]
