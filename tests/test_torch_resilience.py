"""The reference's error contract in the port (vp9.c:534-546, 904-915,
1340-1346 and the unblock-on-error contract of 1860-1862), on the first
frames of the committed bench_1080p: invalid data raises ValueError and
never crashes or hangs; decode_stream's worker threads shut down when a
frame fails; a failed frame leaves the decoder able to decode the stream
from its keyframe again, bit-exact; the same through
decode_gops_parallel, where the error surfaces at its GOP's place with
every worker joined. Pass A runs the native decoder, pass B the plain
versions on the CPU (a `cuda` case runs the kernels)."""
import hashlib
import os
import threading

import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
from ffmpeg_hybrid_tpu_torch.formats.ivf import read_ivf
from ffmpeg_hybrid_tpu_torch.parallel.gop import decode_gops_parallel

VEC = os.path.join(os.path.dirname(__file__), "..", "vectors")
# bench_1080p's keyframes open its three GOPs
KEYFRAMES = (0, 12, 24)


def _packets():
    return [d for _p, d in read_ivf(os.path.join(VEC, "bench_1080p.ivf"))[1]]


def _want():
    return [ln.split(",")[-1].strip() for ln in open(
        os.path.join(VEC, "bench_1080p.framemd5"))
        if ln.strip() and not ln.startswith("#")]


def _md5(f):
    return hashlib.md5(f.to_bytes()).hexdigest()


def _threads(*names):
    return [t for t in threading.enumerate()
            if any(n in t.name for n in names)]


@pytest.mark.parametrize("cut", [0, 1, 2, 3, 5, 9, 17])
def test_truncated_keyframe_raises(cut):
    """The keyframe cut to 0-17 bytes raises ValueError (its header is
    incomplete); the packet whole decodes."""
    pkt = _packets()[0]
    with pytest.raises(ValueError):
        VP9Decoder(device="cpu").decode_pass_a(pkt[:cut])


@pytest.mark.parametrize("native", [True, False])
def test_cut_mid_tile_raises(native):
    """The keyframe cut in the middle of its tile data, and an inter frame
    cut to 7 bytes, raise ValueError in pass A, native or Python."""
    p = _packets()
    dec = VP9Decoder(device="cpu", use_native=native)
    with pytest.raises(ValueError):
        dec.decode_pass_a(p[0][:len(p[0]) // 2])
    dec = VP9Decoder(device="cpu", use_native=native)
    dec.decode_pass_a(p[0])
    with pytest.raises(ValueError):
        dec.decode_pass_a(p[1][:7])


def test_bitflips_raise_or_decode():
    """Flipped bytes in the keyframe's headers and tile data, and in an
    inter frame, either decode (valid, different syntax) or raise
    ValueError: never another exception, a crash or a hang. Pass A: the
    entropy decode, where the bytes are read; flips at bytes 60 and 120 of
    packet 2 raise."""
    p = _packets()
    raised = 0
    for pos in list(range(0, 200, 7)) + list(range(200, len(p[0]), 4001)):
        for bit in (0x01, 0x80):
            data = bytearray(p[0])
            data[pos] ^= bit
            try:
                VP9Decoder(device="cpu").decode_pass_a(bytes(data))
            except ValueError:
                raised += 1
    assert raised
    for pos in (60, 120):
        dec = VP9Decoder(device="cpu")
        dec.decode_pass_a(p[0])
        dec.decode_pass_a(p[1])
        data = bytearray(p[2])
        data[pos] ^= 0xFF
        with pytest.raises(ValueError):
            dec.decode_pass_a(bytes(data))


def test_decoder_recovers_after_a_bad_frame():
    """A failed keyframe leaves the decoder usable: the same decoder then
    decodes the stream's first frames bit-exact."""
    p, want = _packets(), _want()
    dec = VP9Decoder(device="cpu")
    with pytest.raises(ValueError):
        dec.decode(p[0][:3])
    with pytest.raises(ValueError):
        dec.decode(p[0][:len(p[0]) // 2])
    got = [_md5(f) for pkt in p[:2] for f in dec.decode(pkt)]
    assert got == want[:2]


def test_decode_stream_error_propagates():
    """A frame cut short in the middle of the stream surfaces as
    ValueError from decode_stream after the frames before it, with both
    worker threads joined; a fresh decoder then decodes the stream
    bit-exact."""
    p, want = _packets(), _want()
    bad = [p[0], p[1][:7]] + p[2:4]
    got = []
    dec = VP9Decoder(device="cpu")
    with pytest.raises(ValueError):
        for f in dec.decode_stream(iter(bad)):
            got.append(_md5(f))
    assert got == want[:1]
    assert not _threads("worker_a", "worker_pre")
    got = [_md5(f) for f in VP9Decoder(device="cpu").decode_stream(
        iter(p[:2]))]
    assert got == want[:2]


def test_gop_parallel_error_at_its_place():
    """Three one-frame GOPs (the clip's keyframes), the second cut short:
    decode_gops_parallel yields the first GOP's frame, then raises
    ValueError, with every worker joined."""
    p, want = _packets(), _want()
    stream = [p[0], p[12][:9], p[24]]
    got = []
    with pytest.raises(ValueError):
        for f in decode_gops_parallel(stream, workers=2, device="cpu"):
            got.append(_md5(f))
    assert got == [want[0]]
    assert not _threads("ThreadPoolExecutor")


@pytest.mark.cuda
def test_cuda_errors_and_recovery():
    """On the card: decode_stream raises at the cut frame with its
    workers joined, decode_gops_parallel at its GOP, and fresh decoders
    then decode the first GOP bit-exact through the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p, want = _packets(), _want()
    got = []
    with pytest.raises(ValueError):
        for f in VP9Decoder(device="cuda").decode_stream(
                iter(p[:3] + [p[3][:7]] + p[4:6])):
            got.append(_md5(f))
    assert got == want[:3]
    assert not _threads("worker_a", "worker_pre")
    got = []
    with pytest.raises(ValueError):
        for f in decode_gops_parallel(p[:12] + [p[12][:9]] + p[13:24] + p[24:],
                                      workers=2):
            got.append(_md5(f))
    assert got == want[:12]
    assert not _threads("ThreadPoolExecutor")
    got = [_md5(f) for f in VP9Decoder(device="cuda").decode_stream(
        iter(p[:12]))]
    assert got == want[:12]
