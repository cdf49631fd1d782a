"""The port's decoder (ffmpeg_hybrid_tpu_torch, on the CPU) end to end:
mini_encoder chains, with and without the loop filter, against the JAX
package's VP9Decoder(recon_backend="tpu") plane by plane and against
the golden decoder's frame bytes; a frame with a scaled reference
against the golden decoder; the first frames of bench_1080p against
their framemd5 lines. Every comparison is exact. Pass-A snapshots
carried across with state.py are test_torch_decoder_state.py, which
reads this file's chains."""
import hashlib
import itertools
import os
import sys

import numpy as np
import pytest
from test_torch_threads import one_torch_thread  # noqa: F401

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
VEC = os.path.join(os.path.dirname(__file__), "..", "vectors")


def _mini():
    sys.path.insert(0, TOOLS)
    try:
        import mini_encoder
    finally:
        sys.path.pop(0)
    return mini_encoder


def _chain(w, h, n_inter, seed=3):
    """Keyframe, then inter frames with compound prediction, switchable
    interpolation filters, intra blocks and coefficients; no loop
    filter (the slice's scope)."""
    m = _mini()
    pkts = [m.encode_keyframe_random(w, h, 8, seed=seed, txfmmode=3,
                                     yac_qi=60, filter_level=0)]
    for i in range(n_inter):
        pkts.append(m.encode_inter_flex(
            w, h, seed=seed + 17 + i, comppredmode=2 if i % 2 else 0,
            signbias=(0, 0, 1), filtermode=4, coeffs=True, p_intra=0.2,
            p_skip=0.3, mv_mags=(0, 2, 4, 8, 16, 64),
            refresh_mask=0x01 if i % 2 else 0x05, filter_level=0))
    return pkts


def _filtered_chain(w, h, n_inter, seed=5):
    """Keyframe, then inter frames, all loop-filtered: lf deltas, a
    segment with an alt-LF feature, mixed sharpness, 4x4 transforms on
    the keyframe (4px-offset edges); the inter frames predict from
    filtered references."""
    m = _mini()
    deltas = ([3, -2, 0, 1], [2, -1])
    seg = [(0, 12, -1, 0)] + [(0, 0, -1, 0)] * 7
    pkts = [m.encode_keyframe_random(w, h, 8, seed=seed, txfmmode=0,
                                     filter_level=36, lf_deltas=deltas,
                                     seg_feat=seg)]
    for i in range(n_inter):
        pkts.append(m.encode_inter_flex(
            w, h, seed=seed + 31 + i, comppredmode=2 if i % 2 else 0,
            signbias=(0, 0, 1), filtermode=4, coeffs=True, p_intra=0.2,
            p_skip=0.3, mv_mags=(0, 2, 4, 8, 16), refresh_mask=0x01,
            filter_level=24 + 13 * i, sharpness=3 * (i % 2),
            lf_deltas=deltas, seg_feat=seg))
    return pkts


def _planes_torch(f):
    return [p.numpy() for p in f.dev]


def _planes_jax(f):
    return [np.asarray(p) for p in f.dev]


@pytest.mark.parametrize("w,h,native,stream", [(128, 128, True, True),
                                               (130, 70, False, False)])
def test_chain_matches_jax_tpu_backend_and_golden(w, h, native, stream):
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder as JDec
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder

    pkts = _chain(w, h, 3)
    port = VP9Decoder(device="cpu", use_native=native)
    if stream:
        got = list(port.decode_stream(iter(pkts)))
    else:
        got = [f for p in pkts for f in port.decode(p)]
    tpu = JDec(recon_backend="tpu", use_native=native)
    gold = JDec(recon_backend="golden", use_native=native)
    assert len(got) == len(pkts)
    for k, pkt in enumerate(pkts):
        (jf,) = tpu.decode(pkt)
        (gf,) = gold.decode(pkt)
        for i, (a, b) in enumerate(zip(_planes_jax(jf),
                                       _planes_torch(got[k]))):
            assert np.array_equal(a, b), (k, i)
        assert got[k].to_bytes() == gf.to_bytes(), k


@pytest.mark.parametrize("native", [True, False])
def test_filtered_chain_matches_jax_tpu_backend_and_golden(native,
                                                           monkeypatch):
    """Every frame loop-filtered (the port's masks path for both pass
    A implementations): MD5 equal to the JAX package's tpu and golden
    backends."""
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder as JDec
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu_torch.ops import lpf_dense

    pkts = _filtered_chain(128, 128 if native else 64, 2)
    port = VP9Decoder(device="cpu", use_native=native)
    jobs = [port.precompute_job(port.decode_pass_a(p)) for p in pkts]
    tpu = JDec(recon_backend="tpu", use_native=native)
    gold = JDec(recon_backend="golden", use_native=native)
    calls = []
    real = lpf_dense.lf_dense_plain

    def counted(*a):
        calls.append(a[0].shape[0])
        return real(*a)

    monkeypatch.setattr(lpf_dense, "lf_dense_plain", counted)
    for k, (pkt, job) in enumerate(zip(pkts, jobs)):
        assert job.header.filter_level and job.pre["lf_masks"] == \
            (True, True), k
        (got,) = port.decode_pass_b(job)
        (jf,) = tpu.decode(pkt)
        (gf,) = gold.decode(pkt)
        md5 = hashlib.md5(got.to_bytes()).hexdigest()
        assert md5 == hashlib.md5(gf.to_bytes()).hexdigest(), k
        assert md5 == hashlib.md5(jf.to_bytes()).hexdigest(), k
    # Y, then U+V stacked, on every frame
    assert calls == [1, 2] * len(pkts)


def test_lossless_keyframe_matches_golden():
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder as JDec
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder

    rng = np.random.RandomState(4)
    y = rng.randint(0, 256, (64, 96)).astype(np.uint8)
    u = rng.randint(0, 256, (32, 48)).astype(np.uint8)
    v = rng.randint(0, 256, (32, 48)).astype(np.uint8)
    pkt = _mini().encode_keyframe_lossless(y, u, v)
    (got,) = VP9Decoder(device="cpu").decode(pkt)
    (want,) = JDec(recon_backend="golden").decode(pkt)
    assert got.to_bytes() == want.to_bytes()
    yy, uu, vv = got.crop()
    assert np.array_equal(yy, y) and np.array_equal(uu, u)


def _decode_all(pkts):
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    dec = VP9Decoder(device="cpu")
    return [f for p in pkts for f in dec.decode(p)]


def test_out_of_slice_frames_raise():
    """No frame of a valid stream is outside the port any more: the
    stream whose scaled reference the port once refused decodes equal to
    the golden decoder. The one frame the port refuses is one that the
    reference refuses too, whose blocks use a reference of invalid size
    (tests/test_torch_scaled.py)."""
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder as JDec
    m = _mini()
    # an inter frame twice the keyframe's size predicts from a scaled
    # reference
    pkts = [m.encode_keyframe_random(64, 64, 8, seed=1, filter_level=0),
            m.encode_inter_flex(128, 128, seed=2, refresh_mask=0,
                                filter_level=0, coeffs=True)]
    gold = JDec(recon_backend="golden")
    want = [f for p in pkts for f in gold.decode(p)]
    got = _decode_all(pkts)
    assert [f.size for f in got] == [(64, 64), (128, 128)]
    for a, b in zip(want, got):
        assert a.to_bytes() == b.to_bytes()


def test_device_pass_a_waits_for_its_slice():
    """pass_a_impl="device" takes intra and inter frames (the walk of
    ops/passa_device.py, its plain version on the CPU): the inter frame
    that waited for the inter walk's slice now decodes on the device pass
    A, as the host pass A decodes it, and never through the host pass A;
    an unknown pass_a_impl raises ValueError."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    pkts = _chain(64, 64, 1)
    dec = VP9Decoder(device="cpu", use_native=False, pass_a_impl="device")
    host = VP9Decoder(device="cpu", use_native=False, pass_a_impl="host")
    for pkt in pkts:
        (got,) = dec.decode(pkt)
        (want,) = host.decode(pkt)
        assert got.to_bytes() == want.to_bytes()
    assert not dec.header.keyframe and dec.pass_a_host_frames == 0
    with pytest.raises(ValueError):
        VP9Decoder(device="cpu", pass_a_impl="gpu")
    VP9Decoder(device="cpu", pass_a_impl="host")  # the host pass A


def _bench_1080p_md5s(device, n):
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu_torch.formats.ivf import read_ivf
    from ffmpeg_hybrid_tpu_torch.formats.superframe import split_superframe

    _info, pkts = read_ivf(os.path.join(VEC, "bench_1080p.ivf"))
    frames = (fd for pts, data in pkts
              for _p, fd in split_superframe(data, pts))
    want = [line.split(",")[-1].strip() for line in
            open(os.path.join(VEC, "bench_1080p.framemd5"))
            if line.strip() and not line.startswith("#")]
    dec = VP9Decoder(device=device)
    got = [hashlib.md5(f.to_bytes()).hexdigest() for f in
           dec.decode_stream(itertools.islice(frames, n))]
    return got, want[:n]


def test_bench_1080p_first_frames_match_framemd5():
    got, want = _bench_1080p_md5s("cpu", 2)
    assert got == want


@pytest.mark.cuda
def test_bench_1080p_on_the_card_matches_framemd5():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    got, want = _bench_1080p_md5s("cuda", 30)
    assert got == want
