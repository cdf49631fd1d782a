"""The multi-process mesh's parts in one process, without spawning: the
rank mesh (parallel/mesh.py), the segment plan and the merge of
lf_scan_sharded_dist (ops/lpf_replay.py) with loopback exchanges (two
ranks as two threads of this process, swapping through queues), the
placement of frame_tensors' keys against the JAX package's put_spec, the
slices a rank takes (parallel/fullframe.py), and the backends init
refuses (parallel/dist.py). Tolerance 0. The processes themselves are
tests/test_torch_multiprocess_mesh.py and
tests/test_torch_mesh_mp_decode.py."""
import os
import queue
import sys
import threading
from functools import lru_cache

import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
from ffmpeg_hybrid_tpu_torch.ops import _cuda, lpf_replay as LR
from ffmpeg_hybrid_tpu_torch.parallel import dist as D
from ffmpeg_hybrid_tpu_torch.parallel import fullframe as PF
from ffmpeg_hybrid_tpu_torch.parallel.mesh import (Mesh, make_mesh,
                                                   make_rank_mesh)

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
CPU = torch.device("cpu")


@lru_cache(maxsize=None)
def _frame():
    """A filtered 1024x128 keyframe in 4 tile columns (the JAX package's
    two-process mesh stream's keyframe): its job and frame_tensors."""
    sys.path.insert(0, TOOLS)
    try:
        import mini_encoder
    finally:
        sys.path.pop(0)
    pkt = mini_encoder.encode_keyframe_random(1024, 128, seed=5,
                                              filter_level=24,
                                              tile_cols_log2=2)
    job = VP9Decoder(device="cpu").decode_pass_a(pkt)
    return job, PF.frame_tensors(job)


# the superblock's (width, height) in each set's samples (the frame is
# 4:2:0)
_SB = {"ysteps": (64, 64), "uvsteps": (32, 32)}


def _buffers(seed, which="ysteps"):
    """Seeded smooth stripe buffers for the frame's Y (or U+V) steps:
    (buf [4, B, H, HALO + Wpad], steps, wreal)."""
    _job, (t, cfg) = _frame()
    luma = which == "ysteps"
    B = 1 if luma else 2
    H, wp = (cfg["Hy"], cfg["Wpad"]) if luma else (cfg["Hu"], cfg["Wpadu"])
    wreal = t["wreal" if luma else "wrealu"]
    rng = np.random.RandomState(seed)
    walk = np.cumsum(rng.randint(-2, 3, (4, B, H, LR.HALO + wp)), axis=3)
    buf = np.clip(128 + walk // 3, 0, 255).astype(np.int32)
    return torch.from_numpy(buf), t[which], wreal


class Loopback(D.HaloExchange):
    """A rank of a group of threads in this process: swaps go through
    queues keyed by (sender, receiver)."""

    def __init__(self, rank, queues):
        super().__init__(rank)
        self.queues = queues

    def swap(self, peer, send=None, like=None):
        if send is not None:
            self.queues[(self.rank, peer)].put(send.clone())
        self.exchanges += 1
        return None if like is None else self.queues[(peer, self.rank)].get(
            timeout=60)


def _run_ranks(ranks, fn):
    """fn(exchange) in a thread for each rank of ranks (a row's rank a
    slot) -> {rank: result}; an error in a thread is raised here."""
    world = max(ranks) + 1
    queues = {(a, b): queue.Queue() for a in range(world)
              for b in range(world)}
    out, errs = {}, []

    def body(r):
        try:
            out[r] = fn(Loopback(r, queues))
        except Exception as e:  # noqa: BLE001 - raised below
            errs.append(e)

    threads = [threading.Thread(target=body, args=(r,)) for r in
               range(world)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errs:
        raise errs[0]
    return out


def test_rank_mesh_layout():
    """make_rank_mesh: the JAX package's two-process layout (tiles 0-1 on
    rank 0, 2-3 on rank 1 in every row), its slots and boundaries; an
    uneven split; more ranks than slots raise; one rank is make_mesh's
    mesh; a rank's slots split in a row or on two devices raise."""
    m = make_rank_mesh(2, 4, 2, device="cpu")
    assert m.ranks.tolist() == [[0, 0, 1, 1], [0, 0, 1, 1]]
    assert m.world == 2 and m.devices.shape == (2, 4)
    assert m.local_slots(0) == [(0, 0, 2), (1, 0, 2)]
    assert m.local_slots(1) == [(0, 2, 4), (1, 2, 4)]
    assert m.boundaries(0) == m.boundaries(1) == [(1, 2)]
    assert m.row_device(1, 1) == CPU
    assert m.rows(1).ranks.tolist() == [[0, 0, 1, 1]]
    assert make_rank_mesh(1, 8, 3, "cpu").ranks.tolist() == [
        [0, 0, 0, 1, 1, 1, 2, 2]]
    single = make_mesh(8, 2, device="cpu")
    assert single.world == 1 and single.boundaries(0) == []
    assert single.local_slots(0) == [(0, 0, 4), (1, 0, 4)]
    with pytest.raises(ValueError, match="contiguous"):
        Mesh([[CPU] * 4], [[0, 1, 0, 1]])
    with pytest.raises(ValueError, match="one device"):
        Mesh([[CPU, torch.device("meta"), CPU, CPU]], [[0, 0, 1, 1]])
    with pytest.raises(ValueError):
        make_rank_mesh(1, 4, 5, "cpu")
    with pytest.raises(ValueError, match="owns no slot"):
        single.row_device(0, 1)


def test_segment_plan_cuts_where_the_boundary_changes():
    """The plan's cut steps are boundary_steps of the rank boundary (the
    column rule on it alone), they hold every step after which the
    boundary's columns changed in the serial sharded replay (the plain
    version, step by step), and they end the segments; no rank boundary
    gives one segment, and a row without records none."""
    for which in ("ysteps", "uvsteps"):
        buf, steps, wreal = _buffers(1, which)
        lo, hi, cuts, segs = LR.segment_plan(steps, wreal, [0, 0, 1, 1], 0)
        assert (lo, hi) == (0, 2) and list(cuts) == ["right"]
        assert cuts["right"] == LR.boundary_steps(steps, wreal, 2)
        assert [end - 1 for _f, end, sides in segs if sides] == \
            cuts["right"]
        assert segs[0][0] == 0 and all(a[1] == b[0]
                                       for a, b in zip(segs, segs[1:]))
        assert segs[-1][1] == LR.steps_run(steps)
        live = LR._live_steps(steps)
        assert 0 < len(cuts["right"]) < len(live) // 4
        # the columns on the boundary, step by step
        st = torch.as_tensor(steps)
        idle = steps.copy()
        idle[..., 3] = 0
        pl = LR.lf_scan_sharded_plain(buf, idle, wreal, 8)
        changed = []
        for s in live:
            tail = pl[1, :, :, wreal[1]:wreal[1] + LR.HALO].clone()
            halo = pl[2, :, :, :LR.HALO].clone()
            LR._replay_plain(pl, st, wreal, 8, [s])
            if not (torch.equal(tail, pl[1, :, :, wreal[1]:wreal[1] + 8])
                    and torch.equal(halo, pl[2, :, :, :LR.HALO])):
                changed.append(s)
        assert changed and set(changed) <= set(cuts["right"])
        _lo, _hi, cuts1, segs1 = LR.segment_plan(steps, wreal, [0] * 4, 0)
        assert cuts1 == {} and segs1 == [(0, LR.steps_run(steps), [])]
        assert LR.segment_plan(idle, wreal, [0, 1, 1, 1], 1)[3] == []
    with pytest.raises(ValueError, match="contiguous"):
        LR.segment_plan(steps, wreal, [0, 1, 0, 1], 0)


@lru_cache(maxsize=None)
def _plain(seed, which):
    buf, steps, wreal = _buffers(seed, which)
    return LR.lf_scan_sharded_plain(buf, steps, wreal, 8)


@pytest.mark.parametrize("split", [(1, 2, 1)])
def test_dist_scan_with_loopback_matches_plain(split):
    """lf_scan_sharded_dist on the CPU, each rank a thread swapping
    through queues: three ranks, the middle one with two boundaries (the
    splits 1+3, 2+2 and 3+1 over gloo are
    tests/test_torch_multiprocess_mesh.py's): every rank's stripes equal
    lf_scan_sharded_plain's over all four stripes, Y and U+V; the plan's
    counts are noted."""
    ranks = list(np.repeat(np.arange(len(split)), split))
    for which, seed in (("ysteps", 2), ("uvsteps", 3)):
        buf, steps, wreal = _buffers(seed, which)
        want = _plain(seed, which)

        def rank_scan(ex):
            lo, hi, cuts, segs = LR.segment_plan(steps, wreal, ranks, ex.rank)
            got = LR.lf_scan_sharded_dist(buf[lo:hi], steps, wreal, 8, ranks,
                                          ex, _SB[which])
            assert ex.segments == len(segs) and ex.initial == len(cuts)
            assert ex.cut_steps == sum(len(c) for c in cuts.values())
            assert ex.exchanges == ex.initial + ex.cut_steps
            return lo, hi, got

        for lo, hi, got in _run_ranks(ranks, rank_scan).values():
            assert torch.equal(got, want[lo:hi]), (split, which, lo)


def test_merge_takes_the_neighbours_changed_columns():
    """The merge after a cut: where the neighbour's columns differ from
    the snapshot taken before the segment they win, elsewhere the rank's
    own stay. A rank with stripe 0 of two, whose right neighbour (played
    here) changes half of the halo copy it sends back, and changes
    nothing on the first swap."""
    buf, steps, wreal = _buffers(4)
    ranks = [0, 1, 1, 1]
    _lo, _hi, cuts, segs = LR.segment_plan(steps, wreal, ranks, 0)
    cut = cuts["right"][0]
    w = wreal[0]
    sent = []

    class Neighbour(D.HaloExchange):
        def swap(self, peer, send=None, like=None):
            assert peer == 1
            self.exchanges += 1
            sent.append(send.clone())
            if like is None:
                return None
            back = send.clone()
            if len(sent) == 2:     # the first cut: what the neighbour saw
                back = old.clone()  # before it, half of it changed by it
                back[..., ::2] += 1
            return back

    pl = buf[:1].clone()
    old = pl[0, :, :, w:w + LR.HALO].clone()
    # replay up to the first cut by hand: the rank's own values there
    mine = LR.lf_scan_sharded_plain(pl, steps[:1, :cut + 1], wreal[:1], 8)
    got = LR.lf_scan_sharded_dist(pl, steps[:, :cut + 1], wreal, 8, ranks,
                                  Neighbour(0), (64, 64))
    assert len(sent) == 2 and segs[0][1] == cut + 1
    tail = got[0, :, :, w:w + LR.HALO]
    assert torch.equal(tail[..., ::2], old[..., ::2] + 1)
    assert torch.equal(tail[..., 1::2], mine[0, :, :, w + 1:w + LR.HALO:2])
    assert torch.equal(got[0, :, :, :w], mine[0, :, :, :w])


def test_cuda_tensors_launch_each_segment(monkeypatch):
    """On tensors off the CPU lf_scan_sharded_dist builds the tickets of
    the rank's segments and uploads them once, and launches
    lf_replay_from once a segment, on that segment's tickets (recorded
    here), each counted in LAUNCHES; the plain version never runs."""
    calls = []

    def recorded(source, signatures, name, *args):
        calls.append((source, name, args))

    monkeypatch.setattr(_cuda, "launch", recorded)
    monkeypatch.setattr(LR, "lf_scan_sharded_dist_plain", None)
    _buf, steps, wreal = _buffers(5)
    ranks = [0, 0, 1, 1]
    _lo, _hi, cuts, segs = LR.segment_plan(steps, wreal, ranks, 1)

    class Meta(D.HaloExchange):
        def swap(self, peer, send=None, like=None):
            self.exchanges += 1
            return None if like is None else torch.zeros_like(like)

    LR.reset_launches()
    pl = torch.zeros((2, 1, 128, LR.HALO + 256), dtype=torch.int32,
                     device="meta")
    monkeypatch.setattr(torch, "where", lambda c, a, b: a)
    ex = Meta(1)
    assert LR.lf_scan_sharded_dist(pl, steps, wreal, 8, ranks, ex,
                                   (64, 64)) is pl
    assert LR.LAUNCHES["lf_replay"] == len(segs) == len(calls)
    rp = LR.Replay(np.asarray(steps)[2:4], pl.shape, (64, 64), wreal[2:4],
                   LR.HALO, True, [(a, b) for a, b, _s in segs])
    assert sum(hi - lo for lo, hi, *_r in rp.launches) == rp.ntickets > 0
    for (src, name, a), (first, _end, _s), (lo, hi, _f, most_recs,
                                            most_lv) in zip(
            calls, segs, rp.launches):
        assert (src, name) == ("lpf_replay.cu", "lf_replay_from")
        # T, B, H, Wb, tickets, most records, most levels, sbw, sbh,
        # first, halo, bpp
        assert a[5:17] == (2, 1, 128, 264, hi - lo, most_recs, most_lv, 64,
                           64, first, 1, 8)
        assert a[2] is calls[0][2][2] and a[3] is calls[0][2][3]
    assert ex.exchanges == 1 + len(cuts["left"])


def test_put_spec_matches_jax():
    """Every frame_tensors key is placed as the JAX package's put_spec
    places its counterpart: split along the tile axis. The JAX package's
    replicated tensors have no key here."""
    from ffmpeg_hybrid_tpu.parallel import fullframe as JF
    _job, (t, _cfg) = _frame()
    assert set(PF.TILED) == set(t)
    for k, nd in (("x0", 2), ("x0u", 2), ("wreal", 2), ("wrealu", 2),
                  ("ysteps", 5), ("uvsteps", 5), ("yslab", 4),
                  ("uvslab", 4)):
        assert PF.put_spec(k, nd) == tuple(JF.put_spec(k, nd))
    for k in JF._NON_TILED:
        assert tuple(JF.put_spec(k, 2)) == ("gop",)
        with pytest.raises(KeyError):
            PF.put_spec(k, 2)


def test_local_tensors_take_the_ranks_stripes():
    """local_tensors: the tile-split keys sliced, each slab's rows of the
    rank's stripes moved up to the local stacking and every other row
    inert; the local slabs of the two ranks hold the frame's blocks once
    between them."""
    _job, (t, cfg) = _frame()
    for lo, hi in ((0, 2), (2, 4), (1, 4)):
        lt = PF.local_tensors(t, cfg, lo, hi)
        for k in ("x0", "x0u", "wreal", "wrealu", "ysteps", "uvsteps"):
            assert np.array_equal(lt[k], t[k][lo:hi])
        for k, Hp in (("yslab", cfg["Hy"]), ("uvslab", cfg["Hu"])):
            full, local = t[k][0], lt[k][0]
            assert lt[k][1:] == t[k][1:]
            rows = full[:, 0].astype(np.int64)
            mine = (rows >= lo * Hp) & (rows < hi * Hp)
            assert mine.any()
            assert np.array_equal(local[mine, 0], rows[mine] - lo * Hp)
            assert np.array_equal(local[mine, 1:], full[mine, 1:])
            assert (local[~mine, 0] >= (hi - lo) * Hp).all()


def test_nccl_and_other_backends_raise():
    """init never switches the backend: NCCL on a device two ranks share
    raises ValueError; a rank a card raises NotImplementedError (not
    written yet); an unknown backend raises."""
    with pytest.raises(ValueError, match="NCCL refuses"):
        D.init(0, 2, "unused", backend="nccl",
               devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="NCCL refuses"):
        D.init(0, 2, "unused", backend="nccl", devices=["cpu", "cpu"])
    with pytest.raises(NotImplementedError):
        D.init(0, 2, "unused", backend="nccl",
               devices=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="gloo"):
        D.init(0, 2, "unused", backend="mpi")
    with pytest.raises(ValueError, match="NCCL refuses"):
        D.decode_mesh_multiprocess([], 1, 4, 2, device="cpu",
                                   backend="nccl")


@pytest.mark.cuda
def test_cuda_dist_scan_matches_plain():
    """On the card, ranks as threads swapping through queues: the
    segments' lf_replay_from launches and the merges give
    lf_scan_sharded_plain's stripes, Y and U+V, split 2+2, 1+3 and
    1+2+1; one launch a segment."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for split in ((2, 2), (1, 3), (1, 2, 1)):
        ranks = list(np.repeat(np.arange(len(split)), split))
        for which, seed in (("ysteps", 2), ("uvsteps", 3)):
            buf, steps, wreal = _buffers(seed, which)
            want = _plain(seed, which)
            sb = _SB[which]
            LR.reset_launches()

            def rank_scan(ex):
                lo, hi, _cuts, segs = LR.segment_plan(steps, wreal, ranks,
                                                      ex.rank)
                got = LR.lf_scan_sharded_dist(buf[lo:hi].cuda(), steps,
                                              wreal, 8, ranks, ex, sb)
                torch.cuda.synchronize()
                return lo, hi, got.cpu(), len(segs)

            res = _run_ranks(ranks, rank_scan).values()
            for lo, hi, got, _n in res:
                assert torch.equal(got, want[lo:hi]), (split, which, lo)
            assert LR.LAUNCHES["lf_replay"] == sum(r[3] for r in res)
