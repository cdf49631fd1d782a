"""VP9Decoder(pass_a_impl="device") of the port: frames with one tile
row take the on-device pass A (ops/passa_device.py: the kernel on the
card, its plain version under device="cpu"), whose records and pairs are
replayed into pass B's native layouts, and on inter frames whose MV and
reference grids become the frame's cur_mv and cur_ref. On the CPU:
filtered keyframes bit-exact with the port's host pass A and the JAX
package's golden decoder, with the native and the pure-Python pass A's
buffers; a refreshctx keyframe adapting the frame context as the host
does; the small inter clips (vectors/passa_inter_*) and the inter chains
of tests/test_torch_decoder.py bit-exact with their framemd5 and the
host pass A, with cur_mv, cur_ref, the segmentation map and the loop
filter's levels and masks equal to the native pass A's after every
frame; a frame of two tile rows through the host pass A, counted; a tile
size past the packet, a cut tile and a full output raising ValueError.
On the card (`cuda`, skipped here; no JAX needed): the kernel against
the plain version on every vectors/passa_* frame, intra and inter, and
the decoder on the card on those clips against their framemd5."""
import hashlib
import os
import sys

import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
from ffmpeg_hybrid_tpu_torch.formats.ivf import read_ivf
from ffmpeg_hybrid_tpu_torch.formats.superframe import split_superframe
from ffmpeg_hybrid_tpu_torch.ops import passa_device as PD

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOOLS = os.path.join(ROOT, "tools")
VEC = os.path.join(ROOT, "vectors")
# the passa clips (tools/make_passa_vectors_torch.py)
CLIPS = ("passa_s2", "passa_s4", "passa_s5", "passa_s7", "passa_s41",
         "passa_s42", "passa_s51", "passa_seg", "passa_wide", "passa_10bit",
         "passa_444_12", "passa_lossless", "passa_intraonly")
# the inter clips (tools/make_passa_inter_vectors_torch.py)
INTER_CLIPS = ("passa_inter_modes", "passa_inter_seg", "passa_inter_tiles")


def _mini():
    sys.path.insert(0, TOOLS)
    try:
        import mini_encoder
    finally:
        sys.path.pop(0)
    return mini_encoder


def _keyframe(w, h, bpp=8, **kw):
    return _mini().encode_keyframe_random(w, h, bpp, txfmmode=3, yac_qi=60,
                                          **kw)


def _md5s(dec, pkts):
    return [hashlib.md5(f.to_bytes()).hexdigest()
            for p in pkts for f in dec.decode(p)]


def _golden(pkts):
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder as JDec
    return _md5s(JDec(recon_backend="golden"), pkts)


# the filtered keyframes of the JAX package's test_device_passa_e2e_decode
E2E = {"130x70": (130, 70, dict(seed=4, filter_level=31)),
       "512x128_2tiles": (512, 128, dict(seed=5, filter_level=18,
                                         tile_cols_log2=1)),
       "128x96_10bit": (128, 96, dict(seed=11, filter_level=20, bpp=10))}


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("case", list(E2E))
def test_filtered_keyframe_matches_host_and_golden(case, native):
    """Entropy by the walk, recon and loop filter from the replayed
    records and pairs: the host pass A's frame and the golden
    decoder's, byte for byte, on the pooled buffers of the native pass
    A and on the fresh ones of the pure-Python pass A."""
    w, h, kw = E2E[case]
    kw = dict(kw)
    pkt = _keyframe(w, h, kw.pop("bpp", 8), **kw)
    dec = VP9Decoder(device="cpu", use_native=native, pass_a_impl="device")
    got = _md5s(dec, [pkt])
    assert dec.pass_a_host_frames == 0
    assert got == _md5s(VP9Decoder(device="cpu", use_native=native), [pkt])
    assert got == _golden([pkt])


def test_refreshctx_keyframe_adapts_as_the_host():
    """The walk's counts feed backward adaptation (vp9.c:1821-1824):
    the adapted frame context equals the host pass A's, field by
    field, and so does the frame."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.probs import Probs
    pkt = _keyframe(130, 70, seed=51, filter_level=0, refreshctx=1)
    ref = VP9Decoder(device="cpu", use_native=False)
    dev = VP9Decoder(device="cpu", use_native=False, pass_a_impl="device")
    assert _md5s(ref, [pkt]) == _md5s(dev, [pkt])
    assert ref.header.refreshctx and not ref.header.parallelmode
    for fld in ("coef",) + tuple(Probs.FIELDS):
        assert np.array_equal(getattr(ref.prob_ctx[0], fld),
                              getattr(dev.prob_ctx[0], fld)), fld
    assert (ref.prob_ctx[0].coef != Probs.defaults().coef).any()


def _lockstep(pkts, native):
    """The device pass A's decoder (pure-Python pass B buffers unless
    native) beside the native host pass A's, frame by frame: the state
    each frame's pass A leaves (cur_mv, cur_ref, the segmentation map,
    the loop filter's levels and masks) equal; returns the device
    decoder's MD5s, the host's and the device decoder."""
    dev = VP9Decoder(device="cpu", use_native=native, pass_a_impl="device")
    ref = VP9Decoder(device="cpu", use_native=True)
    got, want = [], []
    for pkt in pkts:
        for fd in (f for _pts, f in split_superframe(pkt, 0)):
            jd, jr = dev.decode_pass_a(fd), ref.decode_pass_a(fd)
            if jd.ready is None:
                for a in ("cur_mv", "cur_ref", "cur_segmap", "lf_level",
                          "lf_mask"):
                    assert np.array_equal(getattr(dev, a), getattr(ref, a)), a
            got += [hashlib.md5(f.to_bytes()).hexdigest()
                    for f in dev.decode_pass_b(jd)]
            want += [hashlib.md5(f.to_bytes()).hexdigest()
                     for f in ref.decode_pass_b(jr)]
    return got, want, dev


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("name", INTER_CLIPS)
def test_inter_clip_matches_framemd5_and_the_native_pass_a(name, native):
    """Every frame of the inter clip through the device pass A (the plain
    walk): its MD5 equals the framemd5's (the golden decoder's) and the
    host pass A's; after every frame the state pass A leaves equals the
    native pass A's; no frame takes the host route."""
    frames, md5s = _clip(name)
    got, want, dev = _lockstep(frames, native)
    assert got == want == md5s
    assert dev.pass_a_host_frames == 0


@pytest.mark.parametrize("chain", ["chain", "filtered_chain"])
def test_decoder_chains_on_the_device_pass_a(chain):
    """tests/test_torch_decoder.py's inter chains (compound prediction,
    switchable filters, intra blocks, coefficients; then loop filter,
    lf deltas and an alt-LF segment) through the device pass A: every
    frame as the host pass A's, every state as the native one's."""
    import test_torch_decoder as D
    pkts = D._chain(128, 128, 3) if chain == "chain" \
        else D._filtered_chain(128, 64, 2)
    got, want, dev = _lockstep(pkts, True)
    assert got == want and len(got) == len(pkts)
    assert dev.pass_a_host_frames == 0


def test_two_tile_rows_take_the_host_pass_a():
    """tile_rows > 1: the reference carries the above contexts across
    tile rows (vp9.c:1720), which the walk's lanes do not: the frame
    takes the host pass A, is counted, and decodes bit-exact."""
    pkt = _keyframe(128, 256, seed=21, filter_level=12, tile_rows_log2=1)
    dec = VP9Decoder(device="cpu", use_native=False, pass_a_impl="device")
    got = _md5s(dec, [pkt])
    assert dec.pass_a_host_frames == 1
    assert got == _md5s(VP9Decoder(device="cpu", use_native=False), [pkt])
    assert got == _golden([pkt])


def _tile_data_offset(pkt):
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.header import \
        parse_uncompressed_header
    h = parse_uncompressed_header(pkt, VP9Decoder(device="cpu"))
    return h.uncompressed_header_size + h.compressed_header_size


def _bad_packet(kind):
    """A 2-tile-column keyframe broken one way: `size`, the first tile's
    size past the packet; `header`, the packet cut inside that size;
    `cut`, the last tile cut to a fifth (the stream ends before its
    last superblocks)."""
    pkt = _keyframe(512, 128, seed=5, filter_level=0, tile_cols_log2=1)
    off = _tile_data_offset(pkt)
    if kind == "size":
        return pkt[:off] + (len(pkt)).to_bytes(4, "big") + pkt[off + 4:]
    if kind == "header":
        return pkt[:off + 2]
    first = int.from_bytes(pkt[off:off + 4], "big")
    last = off + 4 + first
    return pkt[:last + (len(pkt) - last) // 5]


@pytest.mark.parametrize("kind", ["size", "header", "cut"])
def test_bad_tiles_raise_value_error(kind):
    """As the host pass A does (codecs/vp9/decoder.py _decode_tiles), so
    does the device pass A: ValueError, never a partial frame."""
    pkt = _bad_packet(kind)
    said = []
    for impl in ("host", "device"):
        dec = VP9Decoder(device="cpu", use_native=False, pass_a_impl=impl)
        with pytest.raises(ValueError) as e:
            dec.decode(pkt)
        said.append(str(e.value))
    assert said[0] == said[1] == {
        "size": "invalid tile size", "header": "truncated tile header",
        "cut": "bitstream end mid-tile"}[kind]


def test_full_outputs_raise_value_error(monkeypatch):
    """An output that would overflow the rows a lane was given raises
    ValueError (the JAX walk's err, decoder.py:790-791) and never
    truncates: records, coefficient pairs and eob pairs each."""
    pkt = _keyframe(130, 70, seed=4, filter_level=0)
    real = PD.lane_caps
    for which in range(3):
        def small(inputs, meta, which=which):
            caps = [np.array(c) for c in real(inputs, meta)]
            caps[which] = np.minimum(caps[which], 5)
            return tuple(caps)
        monkeypatch.setattr(PD, "lane_caps", small)
        dec = VP9Decoder(device="cpu", use_native=False,
                         pass_a_impl="device")
        with pytest.raises(ValueError, match="overflow"):
            dec.decode(pkt)
    # the walk's own err bits, and a lane that stops leaves the others
    monkeypatch.setattr(PD, "lane_caps", real)
    dec = VP9Decoder(device="cpu", use_native=False)
    dec.decode_pass_a(pkt)
    inputs, meta = PD.prep_keyframe(dec, pkt)

    def few_pairs(inputs, meta):
        caps = [np.array(c) for c in real(inputs, meta)]
        caps[1] = np.minimum(caps[1], 5)
        return tuple(caps)
    monkeypatch.setattr(PD, "lane_caps", few_pairs)
    out = PD.decode_frame(inputs, meta, "cpu")
    assert out[7].tolist() == [PD.ERR_OVERFLOW] and out[3].tolist() == [5]


# ---------------------------------------------------------------------------
# on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _clip(name):
    frames = [fd for pts, data in read_ivf(os.path.join(VEC, name + ".ivf"))[1]
              for _p, fd in split_superframe(data, pts)]
    want = [line.split(",")[-1].strip()
            for line in open(os.path.join(VEC, name + ".framemd5"))
            if line.strip() and not line.startswith("#")]
    return frames, want


@pytest.mark.cuda
@pytest.mark.parametrize("name", CLIPS + INTER_CLIPS)
def test_kernel_matches_plain_on_the_card(name):
    """csrc/passa.cu against decode_frame_plain on each frame of the clip
    that is not a show-existing one, the counts forced on: every output
    row, the err words, the counts, the bools a lane and on inter frames
    the MV and reference grids, exact; one launch a frame."""
    _card()
    frames, _want = _clip(name)
    dec = VP9Decoder(device="cuda", use_native=True)
    n = 0
    for fd in frames:
        if dec.decode_pass_a(fd).ready is not None:
            continue
        h = dec.header
        prep = PD.prep_keyframe if h.keyframe or h.intraonly \
            else PD.prep_inter
        inputs, meta = prep(dec, fd)
        meta["want_counts"] = 1
        PD.reset_launches()
        got = [t.cpu().numpy() for t in PD.decode_frame(
            inputs, meta, "cuda")]
        assert PD.LAUNCHES["passa"] == 1
        want = [t.numpy() for t in PD.decode_frame_plain(inputs, meta)]
        assert len(got) == len(want) == (11 if meta.get("inter") else 9)
        for i, c in ((0, 1), (2, 3), (4, 5)):
            assert np.array_equal(got[c], want[c])
            for s in range(meta["S"]):
                m = int(want[c][s])
                assert np.array_equal(got[i][s, :m], want[i][s, :m])
        assert np.array_equal(got[6], want[6]) and got[6].any()
        assert np.array_equal(got[7], want[7]) and not got[7].any()
        assert np.array_equal(got[8][:, 0], want[8][:, 0])
        for i in range(9, len(got)):
            assert np.array_equal(got[i], want[i])
        n += 1
    assert n == (2 if name == "passa_intraonly" else len(frames))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CLIPS + INTER_CLIPS)
def test_decoder_on_the_card(name):
    """VP9Decoder(device="cuda", pass_a_impl="device").decode_stream on
    the clip: every MD5 as its framemd5, one walk launch a decoded frame
    (not a show-existing one), no frame through the host pass A."""
    _card()
    frames, want = _clip(name)
    PD.reset_launches()
    dec = VP9Decoder(device="cuda", pass_a_impl="device")
    got = [hashlib.md5(f.to_bytes()).hexdigest()
           for f in dec.decode_stream(frames)]
    assert got == want
    assert PD.LAUNCHES["passa"] == (2 if name == "passa_intraonly"
                                    else len(frames))
    assert dec.pass_a_host_frames == 0
