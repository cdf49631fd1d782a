"""The block-record splat of the port (ops/recon.py _grids_from_records,
its kernel csrc/splat.cu behind ops/recon_cuda.splat) against the JAX
package's ops/recon_tpu.py _grids_from_records on the same numpy
records (CPU-JAX, as tests/conftest.py sets it). Every comparison is
exact, dtypes included.

The kernel runs only on the card, so `_splat_model` below restates its
per-thread arithmetic in numpy (the index phase's records dealt to the
blocks in turn, each group of lanes per record, each lane's 8x8 units
and the epoch-tagged entries they leave in an index grid that lives
from frame to frame; the gather phase's thread per luma or chroma
cell, its unit's entry read under the epoch, the record's nine 8-byte
words and the fields it takes from them) and is held to the JAX
function here, also over two frames of one geometry on one state; a
`cuda` test holds the kernel to the plain version on the card."""
import ctypes
import os
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu.ops import recon_tpu as J
from ffmpeg_hybrid_tpu_torch.codecs.vp9 import tables as T
from ffmpeg_hybrid_tpu_torch.ops import _cuda
from ffmpeg_hybrid_tpu_torch.ops import recon as P
from ffmpeg_hybrid_tpu_torch.ops import recon_cuda as RC

from test_torch_recon import _pass_a_job, _t

SUBSAMPLINGS = [(1, 1), (1, 0), (0, 1), (0, 0)]
BWH = np.asarray(T.BWH_TAB[1], np.int64)
ITT = np.asarray(T.INTRA_TXFM_TYPE, np.int64)
SPLAT_CU = os.path.join(os.path.dirname(__file__), "..",
                        "ffmpeg_hybrid_tpu_torch", "csrc", "splat.cu")


def _constant(name):
    """A constexpr int of csrc/splat.cu, as the kernel is built."""
    with open(SPLAT_CU) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


@pytest.fixture(scope="module")
def real_records():
    """The records of a mini_encoder inter frame (sub-8x8 inter leaves,
    compound, intra) with the MV fields drawn at random, so that the
    chroma averaging sees odd and negative sums; and its cell grid."""
    job = _pass_a_job(30)[1]
    recs = job.pre["recs"].copy()
    recs[:, 18:34] = np.random.RandomState(30).randint(-301, 302,
                                                       (len(recs), 16))
    valid = recs[recs[:, 3] >= 0]
    assert (valid[:, 3] >= 10).any() and (valid[:, 14] != 0).any()
    assert (valid[:, 6] != 0).any()
    return recs, job.txsz4.shape


def _tile(rng, r, c, size, out):
    """Leaves of a random partition of the size x size (8 px units)
    square at (r, c), as (row, col, bs)."""
    sq = {8: 0, 4: 3, 2: 6, 1: 9}[size]
    pick = min(rng.randint(6), 3)        # split half the time
    if size == 1:
        out.append((r, c, int(rng.choice([9, 10, 11, 12]))))
    elif pick == 0:
        out.append((r, c, sq))
    elif pick == 1:                      # two wide halves
        out += [(r, c, sq + 1), (r + size // 2, c, sq + 1)]
    elif pick == 2:                      # two tall halves
        out += [(r, c, sq + 2), (r, c + size // 2, sq + 2)]
    else:
        for dr in (0, size // 2):
            for dc in (0, size // 2):
                _tile(rng, r + dr, c + dc, size // 2, out)


def synthetic_records(seed, empty=(0, 1)):
    """Records over a 3 x 4 superblock area whose cell grid (22 x 28)
    ends inside the last superblock row and column, so blocks reach past
    r4/c4; one superblock, `empty`, left empty (its cells read the last
    row); two
    leaves repeated at other rows with other fields (the index max picks
    the higher row); three pad rows inside the array and one last; every
    field but the geometry drawn at random, modes past 13 and refs
    outside 0..2 included for the clamps."""
    rng = np.random.RandomState(seed)
    leaves = []
    for sr in range(3):
        for sc in range(4):
            if (sr, sc) != empty:
                _tile(rng, sr * 8, sc * 8, 8, leaves)
    L = len(leaves)
    n = L + 6
    recs = rng.randint(-300, 301, (n, 36)).astype(np.int16)
    rows = rng.permutation(n - 1)
    geo = np.asarray(leaves + [leaves[k] for k in rng.choice(L, 2)],
                     np.int16)
    recs[rows[:L + 2], 0:2] = geo[:, :2]
    recs[rows[:L + 2], 3] = geo[:, 2]
    recs[rows[L + 2:], 3] = -1
    recs[-1, 3] = -1
    recs[:, 6] = rng.randint(0, 2, n)                 # intra
    recs[:, 7] = rng.randint(0, 4, n)                 # tx
    recs[:, 9:13] = rng.randint(-1, 16, (n, 4))       # modes
    recs[:, 14] = rng.randint(0, 2, n)                # comp
    recs[:, 15:17] = rng.randint(-1, 4, (n, 2))       # refs
    return recs, (22, 28)


def _all_cases(real):
    """The real records under every subsampling, then synthetic ones."""
    recs, (r4, c4) = real
    out = [(recs, r4, c4, ss) for ss in SUBSAMPLINGS]
    for k, ss in enumerate(SUBSAMPLINGS):
        srecs, (sr4, sc4) = synthetic_records(k)
        out.append((srecs, sr4, sc4, ss))
    return out


_JDTYPE = {np.dtype(np.bool_): torch.bool, np.dtype(np.int32): torch.int32}


def _same_typed(want, got):
    """JAX arrays against tensors: shapes, dtypes and values."""
    assert len(want) == len(got) == 14
    for k, (a, b) in enumerate(zip(want, got)):
        a = np.asarray(a)
        assert _JDTYPE[a.dtype] == b.dtype, k
        assert a.shape == tuple(b.shape), k
        assert np.array_equal(a, b.numpy()), (k, np.argwhere(a != b.numpy())
                                              [:4])


def _jax(recs, r4, c4, ss):
    return J._grids_from_records(jnp.asarray(recs), r4, c4, *ss)


@pytest.mark.parametrize("k", range(8), ids=[
    f"{src}-ss{h}{v}" for src in ("real", "synth")
    for h, v in SUBSAMPLINGS])
def test_wrapper_on_cpu_matches_jax(k, real_records):
    """CPU records take the plain version, equal to JAX's, dtypes
    included, on real and synthetic records under every subsampling;
    nothing counts a launch."""
    recs, r4, c4, ss = _all_cases(real_records)[k]
    RC.reset_launches()
    got = P._grids_from_records(_t(recs), r4, c4, *ss)
    _same_typed(_jax(recs, r4, c4, ss), got)
    assert RC.LAUNCHES["splat"] == 0


# ---------------------------------------------------------------------------
# numpy model of csrc/splat.cu's threads


def _rdiv(s, d):
    return (s + d // 2) // d if s >= 0 else -((-s + d // 2) // d)


def _uv_mv(bs, m0, m1, m2, m3, udy, udx, ss_h, ss_v):
    """uv_mv of csrc/splat.cu, branch for branch."""
    if ss_v:
        if udx == 0:
            if bs == 10:
                return _rdiv(m0 + m2, 2)
            if bs == 11:
                return _rdiv(m0 + m1, 2) if ss_h else m0
            if bs == 12:
                return _rdiv(m0 + m1 + m2 + m3, 4) if ss_h \
                    else _rdiv(m0 + m2, 2)
            return m0
        return {10: _rdiv(m0 + m2, 2), 11: m1,
                12: _rdiv(m1 + m3, 2)}.get(bs, m0)
    if ss_h:
        if udy == 0:
            return _rdiv(m0 + m1, 2) if bs in (11, 12) else m0
        return {10: _rdiv(m0 + m2, 2), 11: _rdiv(m0 + m1, 2),
                12: _rdiv(m1 + m2, 2)}.get(bs, m0)
    if udy == 0:
        return m1 if udx and bs in (11, 12) else m0
    if udx == 0:
        return m2 if bs in (10, 12) else m0
    return {10: m2, 11: m1, 12: m3}.get(bs, m0)


def _half(word, k):
    """int16 k (0-3) of an 8-byte little-endian word."""
    return int(np.uint16((int(word) >> (16 * k)) & 0xffff).astype(np.int16))


def _field(w, f):
    """int16 field f of a record from its words w: word f >> 2's."""
    return _half(w[f >> 2], f & 3)


def new_state(r4, c4):
    """The kernel's state for one geometry: the index grid, an entry an
    8x8 unit, zero, and the last epoch taken."""
    return {"bidx": [0] * (((r4 + 1) // 2) * ((c4 + 1) // 2)), "epoch": 0}


def _splat_model(recs, r4, c4, ss_h, ss_v, state=None):
    """The kernel's threads in numpy, on `state` (a new one if None; it
    carries the index grid to the next call). The call takes the next
    epoch. (a) The index launch: of its B blocks (N * kGroup threads,
    rounded up to whole blocks of kThreads), thread t of block x is lane
    t % kGroup of group t // kGroup, which takes records x + B * (t //
    kGroup), then on by B * kThreads / kGroup: from each record's first
    word (row, col, bs) its units (8x8) in the frame, r8 x c8 (r4 and c4
    halved, rounded up), lane k's k, k + kGroup, ... in row-major order,
    each entry raised to (epoch << 32) | b. (b) The gather launch, a thread a cell: each luma cell, then each
    chroma cell reading luma cell (i << ss_v, j << ss_h), takes its
    unit's record if the entry is of this epoch, else the last row, as
    its nine 8-byte words."""
    if state is None:
        state = new_state(r4, c4)
    epoch = _index_model(recs, r4, c4, state)
    return _gather_model(recs, r4, c4, ss_h, ss_v, state, epoch)


def _words(recs):
    recs = np.ascontiguousarray(recs, dtype="<i2")
    return recs.view("<u8").reshape(len(recs), 9)


def _index_model(recs, r4, c4, state):
    """_splat_model's index launch (a) on `state`, under the next epoch,
    which it returns."""
    nthreads, group = _constant("kThreads"), _constant("kGroup")
    words = _words(recs)
    N = len(recs)
    r8, c8 = (r4 + 1) // 2, (c4 + 1) // 2
    assert len(state["bidx"]) == r8 * c8
    state["epoch"] += 1
    epoch, bidx = state["epoch"], state["bidx"]
    blocks = -(-N * group // nthreads)
    stride = blocks * (nthreads // group)
    for x in range(blocks):
        for t in range(nthreads):
            lane = t % group
            for b in range(x + blocks * (t // group), N, stride):
                w0 = words[b]
                bs = _field(w0, 3)
                if bs < 0:
                    continue
                bsc = min(bs, 12)
                row, col = _field(w0, 0), _field(w0, 1)
                y0 = max(row, 0)
                y1 = min(row + min(int(BWH[bsc, 1]), 8), r8)
                x0 = max(col, 0)
                x1 = min(col + min(int(BWH[bsc, 0]), 8), c8)
                nx = x1 - x0
                if y0 >= y1 or nx <= 0:
                    continue
                for k in range(lane, (y1 - y0) * nx, group):
                    u = (y0 + k // nx) * c8 + x0 + k % nx
                    bidx[u] = max(bidx[u], (epoch << 32) | b)
    return epoch


def _gather_model(recs, r4, c4, ss_h, ss_v, state, epoch):
    """_splat_model's gather launch (b) of the launch of `epoch`, on
    `state`'s index grid as it stands."""
    words = _words(recs)
    N = len(recs)
    c8 = (c4 + 1) // 2
    bidx = state["bidx"]

    def record(i, j):
        """The record of luma cell (i, j), by its unit's entry."""
        e = bidx[(i >> 1) * c8 + (j >> 1)]
        w = words[e & 0xffffffff if e >> 32 == epoch else N - 1]
        return [_field(w, f) for f in range(36)], w

    r4u, c4u = r4 >> ss_v, c4 >> ss_h
    y = [np.zeros(r4 * c4 * n, t) for t, n in
         ((bool, 1), (np.int32, 1), (np.int32, 1), (bool, 1),
          (np.int32, 1), (np.int32, 2), (np.int32, 4))]
    uv = [np.zeros(r4u * c4u * n, t) for t, n in
          ((bool, 1), (np.int32, 1), (np.int32, 1), (bool, 1),
           (np.int32, 1), (np.int32, 2), (np.int32, 4))]
    for idx in range(r4 * c4 + r4u * c4u):
        if idx < r4 * c4:
            i, j = divmod(idx, c4)
            rec, w = record(i, j)
            bs = rec[3]
            intra, inter = rec[6] != 0 and bs >= 0, rec[6] == 0 and bs >= 0
            tx = rec[7]
            q = ((i - rec[0] * 2) & 1) * 2 + ((j - rec[1] * 2) & 1)
            sub8 = bs > 9
            mode = rec[9 + (q if sub8 and tx == 0 else 0)]
            comp = rec[14] != 0 and inter
            y[0][idx], y[1][idx] = inter, tx
            y[2][idx] = ITT[min(max(mode, 0), 13)] if intra else 0
            y[3][idx], y[4][idx] = comp, rec[17]
            y[5][2 * idx:2 * idx + 2] = (min(max(rec[15], 0), 2),
                                         min(max(rec[16] if comp else 0, 0),
                                             2))
            # quadrant qv's MV fields: word 4 + qv's last two, word 5 +
            # qv's first two
            qv = q if sub8 else 0
            y[6][4 * idx:4 * idx + 4] = (_half(w[4 + qv], 2),
                                         _half(w[4 + qv], 3),
                                         _half(w[5 + qv], 0),
                                         _half(w[5 + qv], 1))
            continue
        u = idx - r4 * c4
        i, j = divmod(u, c4u)
        rec, _w = record(i << ss_v, j << ss_h)
        bs = rec[3]
        inter = rec[6] == 0 and bs >= 0
        comp = rec[14] != 0 and inter
        uv[0][u], uv[1][u], uv[3][u], uv[4][u] = inter, rec[8], comp, rec[17]
        uv[5][2 * u:2 * u + 2] = (min(max(rec[15], 0), 2),
                                  min(max(rec[16] if comp else 0, 0), 2))
        udy = min(max(i - ((rec[0] * 2) >> ss_v), 0), 1)
        udx = min(max(j - ((rec[1] * 2) >> ss_h), 0), 1)
        uv[6][4 * u:4 * u + 4] = [
            _uv_mv(bs, *(rec[18 + qq * 4 + c] for qq in range(4)), udy, udx,
                   ss_h, ss_v) for c in range(4)]
    shapes = [()] * 5 + [(2,), (2, 2)]
    return ([a.reshape((r4, c4) + s) for a, s in zip(y, shapes)]
            + [a.reshape((r4u, c4u) + s) for a, s in zip(uv, shapes)])


@pytest.mark.parametrize("k", range(8), ids=[
    f"{src}-ss{h}{v}" for src in ("real", "synth")
    for h, v in SUBSAMPLINGS])
def test_kernel_model_matches_jax(k, real_records):
    recs, r4, c4, ss = _all_cases(real_records)[k]
    want = _jax(recs, r4, c4, ss)
    got = _splat_model(recs, r4, c4, *ss)
    for n, (a, b) in enumerate(zip(want, got)):
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, n
        assert np.array_equal(a, b), (n, np.argwhere(a != b)[:4])


@pytest.mark.parametrize("ss", SUBSAMPLINGS,
                         ids=[f"ss{h}{v}" for h, v in SUBSAMPLINGS])
def test_kernel_model_two_frames_on_one_state(ss):
    """Two frames of one geometry on one state, as the decoder runs
    them: the second leaves empty a superblock that the first covered,
    so its cells hold the first frame's entries; read under the second
    epoch they are no record, and both frames equal JAX's."""
    state = new_state(22, 28)
    for seed, empty in ((40, (2, 3)), (41, (0, 1))):
        recs, (r4, c4) = synthetic_records(seed, empty)
        want = _jax(recs, r4, c4, ss)
        got = _splat_model(recs, r4, c4, *ss, state=state)
        for n, (a, b) in enumerate(zip(want, got)):
            assert np.array_equal(np.asarray(a), b), (n, seed)
    stale = [e >> 32 for e in
             np.asarray(state["bidx"], object).reshape(11, 14)[:8, 8:]
             .ravel()]
    assert state["epoch"] == 2 and set(stale) == {1}


@pytest.mark.parametrize("shared", [True, False],
                         ids=["one shared state", "a state a decoder"])
def test_two_decoders_interleaved_on_the_stream(shared):
    """Two decoders of one geometry on two host threads can reach the
    stream as A's index launch, B's index launch, A's gather, B's
    gather. On one shared state (the module-level state of old) B's
    later epoch wins every unit B covers, and A's gather reads each of
    them as no record; with a state a decoder, both frames equal
    JAX's."""
    recs_a, (r4, c4) = synthetic_records(40, (2, 3))
    recs_b, _ = synthetic_records(41, (0, 1))
    st_a = new_state(r4, c4)
    st_b = st_a if shared else new_state(r4, c4)
    ea = _index_model(recs_a, r4, c4, st_a)
    eb = _index_model(recs_b, r4, c4, st_b)
    got_a = _gather_model(recs_a, r4, c4, 1, 1, st_a, ea)
    got_b = _gather_model(recs_b, r4, c4, 1, 1, st_b, eb)
    want_a = [np.asarray(a) for a in _jax(recs_a, r4, c4, (1, 1))]
    want_b = [np.asarray(a) for a in _jax(recs_b, r4, c4, (1, 1))]
    assert all(np.array_equal(a, b) for a, b in zip(want_b, got_b))
    same_a = [np.array_equal(a, b) for a, b in zip(want_a, got_a)]
    if not shared:
        assert all(same_a)
        return
    # every cell of a unit that B's index raised reads the pad row in
    # A's gather (no inter cell, size 0), and A's grids differ from JAX's
    # there and nowhere else
    assert not all(same_a)
    raised = np.asarray([e >> 32 == eb for e in st_a["bidx"]]).reshape(
        (r4 + 1) // 2, (c4 + 1) // 2)
    cells = raised.repeat(2, 0).repeat(2, 1)[:r4, :c4]
    assert cells.any() and not cells.all()
    assert not got_a[0][cells].any() and not got_a[1][cells].any()
    for a, b in zip(want_a[:7], got_a[:7]):
        assert np.array_equal(a[~cells], b[~cells])
    assert want_a[1][cells].any()


def test_each_decoder_owns_its_splat_state(monkeypatch):
    """The index state is the decoder's (VP9Decoder.splat_states), which
    its FrameJobs carry to _grids_from_records: two decoders never share
    a store, and a direct call with no store gets a private one."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from test_torch_decoder import _mini
    pkt = _mini().encode_keyframe_random(64, 64, 8, seed=3, filter_level=0)
    seen = []
    real = P._grids_from_records

    def spy(*args, states=None):
        seen.append(states)
        return real(*args, states=states)

    monkeypatch.setattr(P, "_grids_from_records", spy)
    decs = [VP9Decoder(device="cpu") for _ in range(2)]
    for dec in decs:
        job = dec.decode_pass_a(pkt)
        assert job.splat_states is dec.splat_states
        dec.decode_pass_b(dec.precompute_job(job))
    assert seen == [decs[0].splat_states, decs[1].splat_states]
    assert seen[0] is decs[0].splat_states and seen[0] is not seen[1]
    calls = []

    def recorded(source, signatures, name, *args):
        calls.append(args[2])

    monkeypatch.setattr(_cuda, "launch", recorded)
    meta = torch.zeros((8, 36), dtype=torch.int16, device="meta")
    for _ in range(2):
        real(meta, 4, 4, 1, 1)
    assert calls[0] is not calls[1]           # a fresh state a call
    store = {}
    for _ in range(2):
        real(meta, 4, 4, 1, 1, states=store)
    assert calls[2] is calls[3] and len(store) == 1


def test_splat_state_clears_on_a_wrapped_epoch():
    """Epochs run 1, 2, ... on a zero index grid; after 2**32 - 1 the
    grid is cleared and the next epoch is 1 again."""
    st = RC.SplatState(torch.device("cpu"), 6)
    assert (st.next_epoch(), st.next_epoch()) == (1, 2)
    assert not st.bidx.any()
    st.bidx.fill_(-5)
    st.epoch = 0xfffffffe
    assert st.next_epoch() == 0xffffffff and (st.bidx == -5).all()
    assert st.next_epoch() == 1 and not st.bidx.any()


def test_synthetic_records_reach_every_rule():
    """The synthetic records hold sub-8x8 blocks, drop cells past the
    grid, leave cells to the last row and cover some cells twice."""
    for seed in range(4):
        recs, (r4, c4) = synthetic_records(seed)
        valid = recs[recs[:, 3] >= 0]
        assert (valid[:, 3] > 9).any()
        bwh = BWH[valid[:, 3]]
        assert ((valid[:, 0] + bwh[:, 1]) * 2 > r4).any()
        assert ((valid[:, 1] + bwh[:, 0]) * 2 > c4).any()
        assert len({(r[0], r[1], r[3]) for r in valid}) < len(valid)
        # the empty superblock's cells: not inter, and read the last row
        grids = _splat_model(recs, r4, c4, 0, 0)
        assert not grids[0][:16, 16:].any()
        assert (grids[6][:16, 16:] == recs[-1, 18:22].reshape(2, 2)).all()


# ---------------------------------------------------------------------------
# the wrapper off the CPU


def test_wrapper_off_cpu_goes_to_the_kernel(monkeypatch, real_records):
    """Records off the CPU reach one launch of csrc/splat.cu with the
    outputs in _grids_from_records' order, shapes and dtypes (those of
    the plain version), never the plain version; wrong dtypes and shapes
    raise before any launch; the counter moves only on a launch."""
    recs, (r4, c4) = real_records
    calls = []

    def no_card(source, signatures, name, *args):
        calls.append(name)
        raise RuntimeError("no card")

    def recorded(source, signatures, name, *args):
        calls.append((source, name, args))

    monkeypatch.setattr(_cuda, "launch", no_card)
    monkeypatch.setattr(P, "_grids_from_records_plain", None)
    RC.reset_launches()
    meta = torch.zeros(recs.shape, dtype=torch.int16, device="meta")
    with pytest.raises(RuntimeError, match="no card"):
        P._grids_from_records(meta, r4, c4, 1, 1)
    with pytest.raises(TypeError):
        P._grids_from_records(meta.to(torch.int32), r4, c4, 1, 1)
    with pytest.raises(ValueError):
        P._grids_from_records(meta[:, :35], r4, c4, 1, 1)
    with pytest.raises(ValueError):
        P._grids_from_records(meta[0], r4, c4, 1, 1)
    with pytest.raises(ValueError):
        P._grids_from_records(meta, r4 + 1, c4, 1, 1)
    with pytest.raises(ValueError):
        P._grids_from_records(meta, r4, c4, 2, 1)
    assert calls == ["splat"]
    assert RC.LAUNCHES == {"residual": 0, "residual_hbd": 0,
                           "intra": 0, "splat": 0, "scatter": 0, "mc": 0,
                           "mc_scaled": 0}
    calls.clear()
    monkeypatch.setattr(_cuda, "launch", recorded)
    plain = J._grids_from_records(jnp.asarray(recs), r4, c4, 1, 0)
    states = {}     # a decoder's store (VP9Decoder.splat_states)
    for n, ss in enumerate(SUBSAMPLINGS):
        outs = P._grids_from_records(meta, r4, c4, *ss, states)
        source, name, args = calls[n]
        assert (source, name) == ("splat.cu", "splat")
        assert args[0] is meta and args[1] == len(recs)
        st = states[(meta.device, r4, c4)]
        assert args[2] is st.bidx
        assert st.bidx.shape == (((r4 + 1) // 2) * ((c4 + 1) // 2),)
        assert st.bidx.dtype == torch.int64
        # one state a geometry: each call takes the next epoch
        assert args[3] == st.epoch and (n == 0 or args[3] == epoch + 1)
        epoch = args[3]
        assert all(a is b for a, b in zip(args[4:18], outs))
        assert args[18:22] == (r4, c4, *ss)
        assert list((ctypes.c_int * 26).from_address(args[22])) \
            == BWH.reshape(-1).tolist()
        assert list((ctypes.c_int * 14).from_address(args[23])) \
            == ITT.tolist()
        if ss == (1, 0):
            for a, b in zip(plain, outs):
                a = np.asarray(a)
                assert a.shape == tuple(b.shape)
                assert _JDTYPE[a.dtype] == b.dtype
    assert RC.LAUNCHES["splat"] == len(SUBSAMPLINGS)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(real_records):
    """csrc/splat.cu on the card against the plain version on the CPU,
    on real and synthetic records under every subsampling, then on two
    frames of one geometry back to back (the second leaves empty a
    superblock the first covered): one launch a call, bit for bit,
    dtypes included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cases = _all_cases(real_records) + [
        (synthetic_records(seed, empty)[0], 22, 28, ss)
        for ss in SUBSAMPLINGS
        for seed, empty in ((40, (2, 3)), (41, (0, 1)))]
    for recs, r4, c4, ss in cases:
        want = P._grids_from_records_plain(_t(recs), r4, c4, *ss)
        RC.reset_launches()
        got = P._grids_from_records(_t(recs).cuda(), r4, c4, *ss)
        assert RC.LAUNCHES["splat"] == 1
        for n, (a, b) in enumerate(zip(want, got)):
            assert a.dtype == b.dtype and torch.equal(a, b.cpu()), (ss, n)


@pytest.mark.cuda
def test_two_decoders_on_two_threads_are_bit_exact():
    """Fault 3.1 on the card: two decoders of one geometry decode at once
    on two host threads, their launches interleaving on the stream; every
    frame equals the same stream decoded alone on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import threading
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from test_torch_decoder import _chain
    streams = [_chain(128, 128, 5, seed=3), _chain(128, 128, 5, seed=9)]
    want = [[f.to_bytes() for f in VP9Decoder(device="cpu").decode_stream(
        iter(s))] for s in streams]
    for _round in range(3):
        got, errs = [None, None], []

        def run(i):
            try:
                dec = VP9Decoder(device="cuda")
                got[i] = [f.to_bytes() for f in
                          dec.decode_stream(iter(streams[i]))]
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errs.append(e)

        threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not errs, errs
        assert got == want
