"""The port's bool decoders (ffmpeg_hybrid_tpu_torch/ops/rac.py) against
the JAX package's Pallas kernels (ops/rac_pallas.py, interpret mode on
the CPU), the spec decoder and the host pass A. Every comparison is
exact: the functions are integer bit-for-bit definitions.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
are compared with those on the card by the `cuda`-marked test (and by
chip_smoke.py). The coefficient kernel walks a frame's lanes in one
launch from a packed form (ops/rac.py pack_lanes: a lane table, a block
table, deduplicated scan and probability tables, a token machine); a
numpy model of its threads walks that form and is held to the host pass
A and the Pallas kernel at 8, 10 and 12 bits."""
import os
import sys

import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

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


def _pallas_lanes(tx):
    """Lanes of each tx size that the Pallas kernel decodes."""
    return 4 if tx < 3 else 2


@pytest.fixture(scope="module")
def keyframe_blocks():
    """Per bpp, made at its first use: the keyframe's blocks captured by
    the port's pure-Python pass A, grouped by tx size, and the Pallas
    kernel's (coef, eob) on the first _pallas_lanes(tx) lanes of each
    group (interpret mode; its compile per size is the cost). At 8 and
    10 bits both tests that hold the port to it read it once, in
    test_torch_rac_coeffs.py; here the walk at 12 bits does."""
    import jax.numpy as jnp
    from ffmpeg_hybrid_tpu.ops import rac_pallas
    from ffmpeg_hybrid_tpu_torch.ops import coef_path as CP

    made = {}

    def get(bpp):
        if bpp not in made:
            groups = CP.group_by_tx(CP.capture_blocks(_keyframe(bpp)))
            pallas = {}
            for tx, group in groups.items():
                sub = CP.lane_inputs(group[:_pallas_lanes(tx)], "cpu")
                c, e = rac_pallas.decode_coeffs_multi(
                    *(jnp.asarray(t.numpy()) for t in sub),
                    n=(4 << tx) ** 2, bpp=bpp, is32=group[0]["is32"])
                pallas[tx] = (np.asarray(c), np.asarray(e))
            made[bpp] = groups, pallas
        return made[bpp]
    return get


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
    from ffmpeg_hybrid_tpu_torch.ops import coef_path as CP

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
    caps = CP.capture_blocks(_keyframe(8))
    groups = CP.group_by_tx(caps)
    fr = CP.frame_inputs(groups, "meta")
    with pytest.raises(RuntimeError):
        CP.decode_blocks(groups, fr, 8)
    # a wrong dtype is refused before any launch
    with pytest.raises(TypeError):
        rac.decode_bits_multi(u8.to(torch.int32), u8)
    assert calls == ["rac_decode_bits", "rac_decode_tree",
                     "rac_decode_coeffs_frame", "rac_decode_coeffs_frame"]
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
    for bpp in (8, 10, 12):
        caps = CP.capture_blocks(_keyframe(bpp))
        groups = CP.group_by_tx(caps)
        for sms in (rac.H100_SMS, 1):     # a lane a block; 28 a block
            inputs = CP.frame_inputs(groups, "cuda", sms)
            got = CP.decode_blocks(groups, inputs, bpp)
            want = CP.decode_blocks(groups, inputs, bpp,
                                    fn=rac.decode_coeffs_multi_plain)
            one = CP.decode_blocks(groups, inputs, bpp,
                                   fn=rac.decode_coeffs_multi)
            for tx, group in groups.items():
                for a, b in ((got, want), (one, want)):
                    assert torch.equal(a[tx][0], b[tx][0])
                    assert torch.equal(a[tx][1], b[tx][1])
                assert [g["eob"] for g in group] == \
                    got[tx][1].cpu().tolist()
    assert rac.LAUNCHES["decode_bits_multi"] == 1
    assert rac.LAUNCHES["decode_tree_multi"] == 1
    # a launch for the frame, and one a group through the one-group entry
    assert rac.LAUNCHES["decode_coeffs_multi"] == 3 * 2 * (1 + 4)


# ---------------------------------------------------------------------------
# a numpy model of csrc/rac.cu's one-launch coefficient walk

from ffmpeg_hybrid_tpu_torch.ops import rac  # noqa: E402


def _w32(v):
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def _walk_model(fr, bpp):
    """csrc/rac.cu decode_coeffs_kernel on a packed frame (a CoefLanes of
    CPU tensors), block by block: the block stages its ranges of tables
    and probability rows (a lane that reads outside them fails here),
    zeroes its output range and energy caches, then each lane walks the
    token machine one bool a step. Outputs start as garbage. Returns
    (coef [nout], eob [S]) and the most bools of a lane."""
    m = rac.coef_machine(bpp).astype(np.int64) & 0xffffffff
    trans, cprob = m[:128].reshape(64, 2), m[128:]
    lanes = fr.lanes.numpy().astype(np.int64)
    half = fr.half.numpy().astype(np.int64)
    tables = fr.tables.numpy().astype(np.int64) & 0xffffffff
    probs = fr.probs.numpy().astype(np.int64)
    coef = np.full(fr.nout, 0x5a5a, np.int64)
    eob = np.full(len(lanes), -1, np.int64)
    longest = 0
    for blk in fr.blocks.numpy().astype(np.int64):
        l0, nl, tlo, thi, plo, phi, olo, ohi, ncache = blk[:9]
        s_tab, s_prob = tables[tlo:thi], probs[plo:phi]
        coef[olo:ohi] = 0
        s_cache = np.zeros(ncache, np.int64)
        for k, L in enumerate(lanes[l0:l0 + nl]):
            tx = L[rac.TX]
            n = 16 << (2 * tx)
            toff, poff = L[rac.TAB_OFF] - tlo, L[rac.PROB_OFF] - plo
            assert 0 <= toff and toff + n <= len(s_tab)
            assert 0 <= poff and poff + rac.PROB_ROW <= len(s_prob)
            coff = L[rac.CACHE_OFF]
            assert coff + n <= ncache
            assert olo <= L[rac.OUT_OFF] and L[rac.OUT_OFF] + n <= ohi
            hoff, hlen = L[rac.HALF_OFF], L[rac.HALF_LEN]
            value, rng, nbits = L[rac.VALUE], L[rac.RNG], L[rac.NBITS]
            bitbuf = L[rac.BITBUF] & 0xffffffff
            pos, nxt = 0, (half[hoff] if hlen > 0 else 0)
            ctx, i, st, base, energy, extra, bools = L[rac.NNZ], 0, 0, 0, 0, \
                0, 0
            # the table word and the neighbours' energies one position
            # ahead, as the kernel loads them
            w = s_tab[toff]
            c0 = s_cache[coff + ((w >> 10) & 1023)]
            c1 = s_cache[coff + (w >> 20)]
            row = ctx * 11
            while True:
                prob = s_prob[poff + row + st] if st < 11 else cprob[st]
                if nbits < 8:
                    bitbuf = ((bitbuf << 16) | nxt) & 0xffffffff
                    nbits += 16
                    pos += 1
                    nxt = half[hoff + pos] if pos < hlen else 0
                split = 1 + (((rng - 1) * prob) >> 8)
                bit = int(value >= split)
                if bit:
                    value -= split
                    rng -= split
                else:
                    rng = split
                sh = 8 - int(rng).bit_length()
                value = (value << sh) | ((bitbuf >> (nbits - sh))
                                         & ((1 << sh) - 1))
                rng <<= sh
                nbits -= sh
                bools += 1
                tw = trans[st, bit]
                if tw & (1 << 9):
                    extra = (extra << 1) | bit
                if tw & (1 << 8):
                    base, energy, extra = (tw >> 16) & 0xff, (tw >> 24) & 7, 0
                st, act = (tw >> 2) & 63, tw & 3
                if act == 0:
                    continue
                if act == 1:
                    count = i
                    break
                rc, e = w & 1023, 0
                if act == 3:
                    e = energy
                    sv = -(base + extra) if bit else base + extra
                    prod = _w32(sv * L[rac.QDC if i == 0 else rac.QAC])
                    if L[rac.IS32]:
                        prod = _w32(-(_w32(-prod) >> 1)) if prod < 0 \
                            else prod >> 1
                    if bpp == 8:
                        prod = (prod + 0x8000) % 0x10000 - 0x8000
                    coef[L[rac.OUT_OFF] + rc] = prod
                s_cache[coff + rc] = e
                ctx = (1 + (e if (w >> 10) & 1023 == rc else c0)
                       + (e if w >> 20 == rc else c1)) >> 1
                i += 1
                if i == n:
                    count = n
                    break
                w = s_tab[toff + i]
                c0 = s_cache[coff + ((w >> 10) & 1023)]
                c1 = s_cache[coff + (w >> 20)]
                band = (i >= 1) + (i >= 3) + (i >= 6) + (i >= 10) + \
                    (i >= (21 if tx else 13))
                row = (band * 6 + ctx) * 11
            eob[l0 + k] = count
            longest = max(longest, bools)
    return coef, eob, longest


def test_band_of_the_kernel_is_band_table():
    """The kernel's band, five compares of the position, is band_table's
    at every position of every size."""
    for tx, n in enumerate((16, 64, 256, 1024)):
        i = np.arange(n)
        got = (i >= 1).astype(int) + (i >= 3) + (i >= 6) + (i >= 10) + \
            (i >= (21 if tx else 13))
        assert np.array_equal(got, rac.band_table(n)), n


def walk_model_case(bpp, keyframe_blocks):
    """The model of the one-launch walk on the packed keyframe, with a
    lane a block (132 SMs) and 28 lanes a block of mixed sizes (1 SM):
    every block's coefficients and eob equal the host pass A's, the
    plain version's on the same packed inputs, and the Pallas kernel's
    on a few lanes of each size. At 8 and 10 bits in
    test_torch_rac_coeffs.py, beside the coefficient test that shares
    the Pallas reference."""
    from ffmpeg_hybrid_tpu_torch.ops import coef_path as CP

    groups, pallas = keyframe_blocks(bpp)
    for sms in (rac.H100_SMS, 1):
        fr = CP.frame_inputs(groups, "cpu", sms)
        coef, eob, _longest = _walk_model(fr, bpp)
        pc, pe = rac.decode_coeffs_frame(fr, bpp)
        assert np.array_equal(coef, pc.numpy())
        assert np.array_equal(eob, pe.numpy())
        for (c, e), (tx, group) in zip(
                rac.split_groups(fr, torch.as_tensor(coef),
                                 torch.as_tensor(eob)), groups.items()):
            for s, g in enumerate(group):
                assert int(e[s]) == g["eob"], (tx, s)
                assert np.array_equal(c[s].numpy(), g["coef"]), (tx, s)
    for tx, group in groups.items():
        lanes = _pallas_lanes(tx)
        want_c, want_e = pallas[tx]
        got = CP.decode_blocks({tx: group[:lanes]},
                               CP.frame_inputs({tx: group[:lanes]}, "cpu"),
                               bpp)[tx]
        assert np.array_equal(got[0].numpy(), want_c), tx
        assert np.array_equal(got[1].numpy(), want_e), tx


@pytest.mark.parametrize("bpp", [12])
def test_walk_model_matches_host_and_pallas(bpp, keyframe_blocks):
    walk_model_case(bpp, keyframe_blocks)


@pytest.mark.parametrize("bpp", [8, 10, 12])
def test_one_group_lanes_packed_by_tensor_ops_walk_alike(bpp):
    """decode_coeffs_multi's packing of one group (group_lanes: tensor
    ops on the lanes' device, a table and a probability row a lane):
    each lane's unpacked inputs equal its own; blocks are dealt as
    pack_lanes deals them; the model of the walk on it equals the host
    pass A, with a lane a block and with many lanes a block."""
    from ffmpeg_hybrid_tpu_torch.ops import coef_path as CP

    caps = CP.capture_blocks(_keyframe(bpp))
    groups = CP.group_by_tx(caps)
    for tx, group in groups.items():
        n = (4 << tx) ** 2
        ins = CP.lane_inputs(group, "cpu")
        for sms in (rac.H100_SMS, 1):
            fr = rac.group_lanes(*ins, n, group[0]["is32"], sms)
            (args,) = rac.group_args(fr)
            for a, b in zip(args, ins):
                assert torch.equal(a, b), tx
            packed = rac.pack_lanes([(*(t.numpy() for t in ins), n,
                                      group[0]["is32"])], sms)
            cols = [rac.LANE0, rac.NLANES, rac.OUT_LO, rac.OUT_HI,
                    rac.CACHE_BYTES]
            assert np.array_equal(fr.blocks[:, cols].numpy(),
                                  packed.blocks[:, cols])
            assert np.array_equal(fr.lanes[:, rac.CACHE_OFF].numpy(),
                                  packed.lanes[:, rac.CACHE_OFF])
            assert fr.smem <= 227 * 1024
            coef, eob, _longest = _walk_model(fr, bpp)
            c, e = coef.reshape(len(group), n), eob
            for s, g in enumerate(group):
                assert int(e[s]) == g["eob"], (tx, s)
                assert np.array_equal(c[s], g["coef"]), (tx, s)


def test_pack_lanes_tables_and_blocks():
    """The packed form: one table per distinct scan order of a size (at
    most three, one at 32x32), one probability row per distinct row,
    every lane's unpacked inputs equal to its own; blocks take
    ceil(S / (4 SMs)) lanes in order, their output ranges contiguous and
    16-int aligned; a 3,075-lane frame spreads over 513 blocks of 6."""
    from ffmpeg_hybrid_tpu_torch.ops import coef_path as CP

    caps = CP.capture_blocks(_keyframe(8))
    groups = CP.group_by_tx(caps)
    fr = CP.frame_inputs(groups, "cpu")
    per = {tx: len({tuple(g["scan"]) + tuple(g["nb"].reshape(-1))
                    for g in group}) for tx, group in groups.items()}
    assert per[3] == 1 and max(per.values()) <= 3
    assert len(fr.tables) == sum((4 << tx) ** 2 * k for tx, k in per.items())
    rows = {c["probs"].tobytes() for c in caps}
    assert len(fr.probs) == rac.PROB_ROW * len(rows)
    for args, (tx, group) in zip(rac.group_args(fr), groups.items()):
        want = CP.lane_inputs(group, "cpu")
        lh = want[0].shape[1]
        assert torch.equal(args[0][:, :lh], want[0])
        for a, b in zip(args[1:], want[1:]):
            assert torch.equal(a, b)
    blocks = fr.blocks.numpy()
    assert blocks[:, rac.NLANES].sum() == len(caps)
    assert (blocks[:, rac.OUT_LO] % 16 == 0).all()
    assert (blocks[1:, rac.OUT_LO] == blocks[:-1, rac.OUT_HI]).all()
    big = [caps[k % len(caps)] for k in range(3075)]
    bg = CP.group_by_tx(big)
    parts = [(np.zeros((len(g), 2), np.int32),) + tuple(
        np.zeros(len(g), np.int32) for _ in range(4)) + (
        np.stack([c["probs"] for c in g]),
        np.stack([c["scan"] for c in g]),
        np.stack([c["nb"][:, 0] for c in g]),
        np.stack([c["nb"][:, 1] for c in g]),
        np.zeros(len(g), np.int32), np.ones((len(g), 2), np.int32),
        (4 << tx) ** 2, tx == 3) for tx, g in bg.items()]
    packed = rac.pack_lanes(parts)
    assert packed.blocks.shape[0] == 513
    assert (packed.blocks[:, rac.NLANES] <= 6).all()
    assert packed.smem <= 48 * 1024
