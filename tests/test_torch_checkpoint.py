"""The port's decoder checkpoint (codecs/vp9/checkpoint.py) against the
JAX package's: after every frame of a mini_encoder stream the port's
state_dict equals the golden decoder's field by field (tolerance 0), and
a decoder restored from it continues bit-exactly.

The stream carries every kind of cross-frame state: a segmented keyframe
that adapts its probability context, inter frames refreshing different
slots, a superframe with an invisible frame, a show-existing packet, a
size change (references of another size) and a loop-filtered frame.
"""
import hashlib
import io
import os
import sys

import numpy as np
import pytest
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu.codecs.vp9 import checkpoint as JC
from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder as JDecoder
from ffmpeg_hybrid_tpu_torch.codecs.vp9 import checkpoint as PC
from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
from ffmpeg_hybrid_tpu_torch.codecs.vp9.probs import Probs
from ffmpeg_hybrid_tpu_torch.formats.superframe import (merge_superframe,
                                                        split_superframe)

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
SEG_Q = [(20, 0, -1, 0), (-30, 0, -1, 0), (15, 0, -1, 0),
         (40, 0, -1, 0)] + [(0, 0, -1, 0)] * 4


def _mini():
    sys.path.insert(0, TOOLS)
    try:
        import mini_encoder
    finally:
        sys.path.pop(0)
    return mini_encoder


@pytest.fixture(scope="module")
def frames():
    """The stream's frame packets, superframes split."""
    m = _mini()
    flex = m.encode_inter_flex
    pkts = [
        m.encode_keyframe_random(64, 64, seed=1, filter_level=0,
                                 seg_feat=SEG_Q, refreshctx=1),
        flex(64, 64, seed=2, refresh_mask=0x02, coeffs=True, p_intra=0.2),
        merge_superframe([
            flex(64, 64, seed=3, show=False, refresh_mask=0x04,
                 coeffs=True),
            flex(64, 64, seed=4, refidx=(2, 1, 0), refresh_mask=0x01)]),
        bytes([0x89]),    # show-existing of slot 1
        flex(96, 96, seed=5, refidx=(0, 1, 2), refresh_mask=0x01,
             coeffs=True, filter_level=12),
        flex(96, 96, seed=6, refidx=(0, 0, 0), refresh_mask=0x08,
             coeffs=True)]
    return [fd for p in pkts for _pts, fd in split_superframe(p, 0)]


def _md5s(out):
    return [hashlib.md5(f.to_bytes()).hexdigest() for f in out]


def _assert_same(a, b, where="state"):
    """Field by field: the same keys, lengths and values, arrays by
    np.array_equal."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


def _straight(frames):
    """The port's straight CPU decode: every frame's MD5 and the state
    after each frame."""
    dec = VP9Decoder(device="cpu")
    md5s, states = [], []
    for fd in frames:
        md5s.append(_md5s(dec.decode(fd)))
        states.append(PC.state_dict(dec))
    return md5s, states


def test_state_dict_matches_jax_after_every_frame(frames):
    jdec = JDecoder(recon_backend="golden")
    pdec = VP9Decoder(device="cpu")
    for k, fd in enumerate(frames):
        assert _md5s(pdec.decode(fd)) == _md5s(jdec.decode(fd))
        _assert_same(PC.state_dict(pdec), JC.state_dict(jdec),
                     f"state after frame {k}")
    # the keyframe adapted its context: the state is not the defaults'
    assert not np.array_equal(pdec.prob_ctx[0].coef, Probs.defaults().coef)


def test_resume_at_every_cut_matches_straight_decode(frames):
    md5s, states = _straight(frames)
    for cut in range(1, len(frames)):
        # through npz, to show the state is arrays and scalars
        buf = io.BytesIO()
        np.savez(buf, state=np.array([states[cut - 1]], dtype=object))
        buf.seek(0)
        state = np.load(buf, allow_pickle=True)["state"][0]
        dec = PC.load_state_dict(VP9Decoder(device="cpu"), state)
        assert all(f.dev is not None and not f._host_stale
                   for f in dec.refs if f is not None)
        got = [_md5s(dec.decode(fd)) for fd in frames[cut:]]
        assert got == md5s[cut:], f"resumed after frame {cut - 1}"


def test_checkpoint_counts_frames_once(frames):
    """Aliased slots (cur_frame also in refs) serialize once."""
    dec = VP9Decoder(device="cpu")
    for fd in frames[:3]:
        dec.decode(fd)
    state = PC.state_dict(dec)
    live = {id(f) for f in dec.refs + [dec.cur_frame, dec.mvpair_frame,
                                       dec.segmap_frame] if f is not None}
    assert len(state["frames"]) == len(live) < 8 + 3
    assert state["slots"]["cur_frame"] in state["slots"]["refs"]


def test_wrong_version_raises(frames):
    dec = VP9Decoder(device="cpu")
    dec.decode(frames[0])
    state = dict(PC.state_dict(dec), version=99)
    with pytest.raises(ValueError, match="version 99"):
        PC.load_state_dict(VP9Decoder(device="cpu"), state)


@pytest.mark.cuda
def test_state_moves_between_card_and_cpu(frames):
    """A state taken on the card resumes on the CPU, and the CPU's state
    there resumes on the card, both bit-exactly."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    md5s, _states = _straight(frames)
    gpu = VP9Decoder(device="cuda")
    for fd in frames[:2]:
        gpu.decode(fd)
    cpu = PC.load_state_dict(VP9Decoder(device="cpu"), PC.state_dict(gpu))
    got = [_md5s(cpu.decode(fd)) for fd in frames[2:4]]
    back = PC.load_state_dict(VP9Decoder(device="cuda"),
                              PC.state_dict(cpu))
    assert all(f.dev[0].is_cuda for f in back.refs if f is not None)
    got += [_md5s(back.decode(fd)) for fd in frames[4:]]
    assert got == md5s[2:]
