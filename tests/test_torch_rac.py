"""The port's bool decoders (ffmpeg_hybrid_tpu_torch/ops/rac.py) against
the JAX package's Pallas kernels (ops/rac_pallas.py, interpret mode on
the CPU), the spec decoder and the host pass A. Every comparison is
exact: the functions are integer bit-for-bit definitions.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
are compared with those on the card by the `cuda`-marked test (and by
chip_smoke.py)."""
import os
import sys

import numpy as np
import pytest
import torch

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")


def _mini():
    sys.path.insert(0, TOOLS)
    try:
        import mini_encoder
    finally:
        sys.path.pop(0)
    return mini_encoder


def _bits_streams(seed, S, K):
    BoolEncoder = _mini().BoolEncoder
    rng = np.random.RandomState(seed)
    probs = rng.randint(1, 256, (S, K)).astype(np.uint8)
    bits = rng.randint(0, 2, (S, K))
    streams = []
    for s in range(S):
        e = BoolEncoder()
        for bit, prob in zip(bits[s], probs[s]):
            e.put(int(bit), int(prob))
        streams.append(e.bytes())
    data = np.zeros((S, max(len(b) for b in streams) + 4), np.uint8)
    for s, b in enumerate(streams):
        data[s, :len(b)] = np.frombuffer(b, np.uint8)
    return data, probs, bits


def test_decode_bits_multi_matches_pallas():
    from ffmpeg_hybrid_tpu.ops import rac_pallas
    from ffmpeg_hybrid_tpu_torch.ops import rac

    data, probs, bits = _bits_streams(7, 8, 200)
    rac.reset_launches()
    got = rac.decode_bits_multi(torch.from_numpy(data),
                                torch.from_numpy(probs)).numpy()
    want = np.asarray(rac_pallas.decode_bits_multi(data, probs))
    assert np.array_equal(got, bits)
    assert np.array_equal(got, want)
    # a CPU tensor takes the plain version: no kernel launched
    assert rac.LAUNCHES["decode_bits_multi"] == 0


@pytest.mark.parametrize("tree_name", ["INTRAMODE_TREE", "MV_CLASS_TREE",
                                       "PARTITION_TREE"])
def test_decode_tree_multi_matches_pallas(tree_name):
    from ffmpeg_hybrid_tpu.codecs.vp9 import tables as T
    from ffmpeg_hybrid_tpu.ops import rac_pallas
    from ffmpeg_hybrid_tpu_torch.ops import rac

    BoolEncoder = _mini().BoolEncoder
    tree = np.asarray(getattr(T, tree_name), np.int32)
    rng = np.random.RandomState(sum(map(ord, tree_name)))
    S, K = 8, 48
    probs = rng.randint(40, 220, (S, tree.shape[0])).astype(np.uint8)
    leaves = sorted({-int(v) for v in tree.reshape(-1) if v <= 0})
    syms = rng.choice(leaves, (S, K))
    data = np.zeros((S, 512), np.uint8)
    for s in range(S):
        e = BoolEncoder()
        for v in syms[s]:
            e.put_tree(tree, probs[s], int(v))
        b = e.bytes()
        data[s, :len(b)] = np.frombuffer(b, np.uint8)
    got = rac.decode_tree_multi(torch.from_numpy(data),
                                torch.from_numpy(probs), tree, K).numpy()
    want = np.asarray(rac_pallas.decode_tree_multi(data, probs, tree, K))
    assert np.array_equal(got, syms)
    assert np.array_equal(got, want)


def test_overread_matches_spec():
    """Exhausted lanes keep decoding zero-fed bits like the spec
    decoder and the Pallas kernel."""
    from ffmpeg_hybrid_tpu.ops import rac_pallas
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.rac import BoolDecoder
    from ffmpeg_hybrid_tpu_torch.ops import rac

    rng = np.random.RandomState(3)
    S, K = 4, 64
    probs = np.full((S, K), 128, np.uint8)
    data = rng.randint(0, 256, (S, 3)).astype(np.uint8)
    ref = np.zeros((S, K), np.int64)
    for s in range(S):
        d = BoolDecoder(data[s].tobytes())
        ref[s] = [d.get_prob(128) for _ in range(K)]
    got = rac.decode_bits_multi(torch.from_numpy(data),
                                torch.from_numpy(probs)).numpy()
    assert np.array_equal(got, ref)
    assert np.array_equal(
        got, np.asarray(rac_pallas.decode_bits_multi(data, probs)))


def _keyframe(bpp):
    return _mini().encode_keyframe_random(128, 128, bpp=bpp, seed=3,
                                          txfmmode=3, yac_qi=60,
                                          filter_level=0)


@pytest.mark.parametrize("bpp", [8, 10])
def test_decode_coeffs_multi_matches_host_and_pallas(bpp):
    """Blocks captured from a real keyframe by the port's pure-Python
    pass A, at every tx size: the port's plain decode equals the host
    result on every block, and the Pallas kernel on a few lanes of each
    size (the Pallas kernel's compile per size is the cost here)."""
    import jax.numpy as jnp
    from ffmpeg_hybrid_tpu.ops import rac_pallas
    from ffmpeg_hybrid_tpu_torch.ops import coef_path as CP
    from ffmpeg_hybrid_tpu_torch.ops import rac

    caps = CP.capture_blocks(_keyframe(bpp))
    groups = CP.group_by_tx(caps)
    assert set(groups) == {0, 1, 2, 3}
    inputs = {tx: CP.lane_inputs(g, "cpu") for tx, g in groups.items()}
    out = CP.decode_blocks(groups, inputs, bpp)
    for tx, group in groups.items():
        coef, eob = (t.numpy() for t in out[tx])
        for s, g in enumerate(group):
            assert eob[s] == g["eob"], (tx, s)
            assert np.array_equal(coef[s], g["coef"]), (tx, s)
        lanes = 4 if tx < 3 else 2
        sub = CP.lane_inputs(group[:lanes], "cpu")
        want_c, want_e = rac_pallas.decode_coeffs_multi(
            *(jnp.asarray(t.numpy()) for t in sub), n=(4 << tx) ** 2,
            bpp=bpp, is32=group[0]["is32"])
        assert np.array_equal(coef[:lanes], np.asarray(want_c)), tx
        assert np.array_equal(eob[:lanes], np.asarray(want_e)), tx


def test_capture_matches_jax_pass_a():
    """The port's copied pass A snapshots the same blocks as the JAX
    package's (the host halves are copies; this holds them together)."""
    from ffmpeg_hybrid_tpu.codecs.vp9.blockdec import TileDecoder
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu_torch.ops import coef_path as CP

    pkt = _keyframe(8)
    caps = CP.capture_blocks(pkt)
    seen = []
    orig = TileDecoder.decode_coeffs_block

    def wrapper(self, plane_coef, py, px, tx, *a):
        eob = orig(self, plane_coef, py, px, tx, *a)
        sz = 4 << tx
        seen.append((tx, eob, plane_coef[py:py + sz, px:px + sz]
                     .astype(np.int64).reshape(-1)))
        return eob

    TileDecoder.decode_coeffs_block = wrapper
    try:
        VP9Decoder(recon_backend="golden", use_native=False) \
            .decode_pass_a(pkt)
    finally:
        TileDecoder.decode_coeffs_block = orig
    assert len(seen) == len(caps)
    for c, (tx, eob, coef) in zip(caps, seen):
        assert (c["tx"], c["eob"]) == (tx, eob)
        assert np.array_equal(c["coef"], coef)


def test_capture_work_counts_cover_the_decode():
    """The work a block is counted as needing (stream bytes, probability
    entries read) is enough to decode it: a lane whose window is cut to
    its counted bytes, and whose unread probabilities are overwritten,
    still gives the host coefficients and eob."""
    from ffmpeg_hybrid_tpu_torch.ops import coef_path as CP
    from ffmpeg_hybrid_tpu_torch.ops import rac

    caps = CP.capture_blocks(_keyframe(8), count_work=True)
    for tx, group in CP.group_by_tx(caps).items():
        n = (4 << tx) ** 2
        for g in group[:3]:
            # a short block may consume only bits already held in its
            # snapshot (value and partial byte): 0 bytes of its window
            assert 0 <= g["stream_bytes"] < 4 * n + 64
            assert 0 < len(g["prob_reads"]) <= 36 * 11
            assert g["bools"] > 0
            probs = np.ones(36 * 11, np.int32)
            probs[g["prob_reads"]] = g["probs"].reshape(-1)[g["prob_reads"]]
            lane = dict(g, probs=probs.reshape(36, 11))
            ins = CP.lane_inputs([lane], "cpu", Lw=max(2, g["stream_bytes"]))
            coef, eob = rac.decode_coeffs_multi(*ins, n=n, bpp=8,
                                                is32=g["is32"])
            assert int(eob[0]) == g["eob"], tx
            assert np.array_equal(coef[0].numpy(), g["coef"]), tx


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """With no card, the default device raises instead of running on
    the CPU; "cpu" must be asked for."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu_torch.device import resolve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve(None)
    with pytest.raises(RuntimeError):
        VP9Decoder()
    assert resolve("cpu").type == "cpu"


def test_non_cpu_tensors_launch_the_kernel(monkeypatch):
    """A tensor off the CPU goes to the kernel launch (which raises
    here), never to the plain version; the counters move only on a
    launch."""
    from ffmpeg_hybrid_tpu_torch.ops import _cuda, rac

    calls = []

    def no_card(source, signatures, name, *args):
        calls.append(name)
        raise RuntimeError("no card")

    monkeypatch.setattr(_cuda, "launch", no_card)
    rac.reset_launches()
    meta = dict(device="meta")
    u8 = torch.zeros((2, 8), dtype=torch.uint8, **meta)
    with pytest.raises(RuntimeError):
        rac.decode_bits_multi(u8, torch.zeros((2, 5), dtype=torch.uint8,
                                              **meta))
    with pytest.raises(RuntimeError):
        rac.decode_tree_multi(u8, torch.zeros((2, 3), dtype=torch.uint8,
                                              **meta),
                              np.array([[0, 1], [-1, 2], [-2, -3]]), 4)
    i32 = dict(dtype=torch.int32, **meta)
    S, n = 2, 16
    with pytest.raises(RuntimeError):
        rac.decode_coeffs_multi(
            torch.zeros((S, 8), **i32), *(torch.zeros(S, **i32),) * 4,
            torch.zeros((S, 36, 11), **i32),
            *(torch.zeros((S, n), **i32),) * 3, torch.zeros(S, **i32),
            torch.zeros((S, 2), **i32), n=n, bpp=8, is32=False)
    # a wrong dtype is refused before any launch
    with pytest.raises(TypeError):
        rac.decode_bits_multi(u8.to(torch.int32), u8)
    assert calls == ["rac_decode_bits", "rac_decode_tree",
                     "rac_decode_coeffs"]
    assert set(rac.LAUNCHES.values()) == {0}


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from ffmpeg_hybrid_tpu_torch.codecs.vp9 import tables as T
    from ffmpeg_hybrid_tpu_torch.ops import coef_path as CP
    from ffmpeg_hybrid_tpu_torch.ops import rac

    data, probs, _bits = _bits_streams(11, 16, 300)
    d, p = torch.from_numpy(data).cuda(), torch.from_numpy(probs).cuda()
    rac.reset_launches()
    assert torch.equal(rac.decode_bits_multi(d, p),
                       rac.decode_bits_multi_plain(d, p))
    tree = np.asarray(T.PARTITION_TREE, np.int32)
    pt = torch.randint(1, 256, (16, tree.shape[0]), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(5)).cuda()
    assert torch.equal(rac.decode_tree_multi(d, pt, tree, 40),
                       rac.decode_tree_multi_plain(d, pt, tree, 40))
    for bpp in (8, 10):
        caps = CP.capture_blocks(_keyframe(bpp))
        groups = CP.group_by_tx(caps)
        inputs = {tx: CP.lane_inputs(g, "cuda") for tx, g in
                  groups.items()}
        got = CP.decode_blocks(groups, inputs, bpp)
        want = CP.decode_blocks(groups, inputs, bpp,
                                fn=rac.decode_coeffs_multi_plain)
        for tx in groups:
            assert torch.equal(got[tx][0], want[tx][0])
            assert torch.equal(got[tx][1], want[tx][1])
    assert rac.LAUNCHES["decode_bits_multi"] == 1
    assert rac.LAUNCHES["decode_tree_multi"] == 1
    assert rac.LAUNCHES["decode_coeffs_multi"] == 8
