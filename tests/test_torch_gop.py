"""GOP-parallel decode in the port (parallel/gop.py) on the CPU, with
tolerance 0: split_gops and packet_is_keyframe against the JAX
package's on the committed clips and their concatenations;
decode_gops_parallel with two workers against the port's serial decode
and the JAX package's decode_gops_parallel on a two-GOP mini_encoder
stream; the multiprocess path with two spawned processes on an IVF
written to tmp_path; an error in a GOP raised at its place with every
worker joined. The loop filter's schedule states are each decoder's own
(fault 3.1): a model of csrc/lpf.cu's ticket counter under two launches
interleaved, and a `cuda` test of two decoders on two streams."""
import hashlib
import os
import sys
import threading
from functools import lru_cache

import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
from ffmpeg_hybrid_tpu_torch.formats.ivf import read_ivf, write_ivf
from ffmpeg_hybrid_tpu_torch.parallel import gop as PG

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
VEC = os.path.join(os.path.dirname(__file__), "..", "vectors")

# the committed clips and their GOPs (keyframe-rooted runs)
CLIP_GOPS = {"bench_1080p": 3, "bench_1080p_lf": 6, "bench_4k": 1,
             "resize_1080p": 1, "fmt_422_1080p": 2, "fmt_440_1080p": 2,
             "fmt_444_1080p": 2, "fmt_420_10_1080p": 2,
             "fmt_444_12_1080p": 2}


def _clip(name):
    return [d for _p, d in read_ivf(os.path.join(VEC, name + ".ivf"))[1]]


def _mini():
    sys.path.insert(0, TOOLS)
    try:
        import mini_encoder
    finally:
        sys.path.pop(0)
    return mini_encoder


@lru_cache(maxsize=None)
def _two_gops():
    """Two GOPs of 256 x 128 frames, each a filtered keyframe and two
    chained inter frames (the second unfiltered), from other seeds."""
    m = _mini()
    out = []
    for g in range(2):
        k = m.encode_keyframe_random(256, 128, seed=40 + g,
                                     filter_level=20 + g)
        f1 = m.encode_inter_flex(256, 128, seed=50 + g, refresh_mask=0x02,
                                 filter_level=16, coeffs=True, p_intra=0.2,
                                 mv_mags=(0, 2, 8))
        f2 = m.encode_inter_flex(256, 128, seed=60 + g, refidx=(1, 0, 0),
                                 refresh_mask=0x04, filter_level=0,
                                 coeffs=True, mv_mags=(0, 4, 16))
        out += [k, f1, f2]
    return tuple(out)


def _md5s(frames):
    return [(len(b), hashlib.md5(b).hexdigest())
            for b in (f.to_bytes() for f in frames)]


def _serial(packets):
    dec = VP9Decoder(device="cpu")
    return _md5s(f for p in packets for f in dec.decode(p))


@pytest.mark.parametrize("name,reps", [(n, 1) for n in sorted(CLIP_GOPS)]
                         + [("bench_1080p", 3), ("fmt_422_1080p", 2),
                            ("bench_1080p_lf", 2)])
def test_split_gops_matches_jax(name, reps):
    from ffmpeg_hybrid_tpu.parallel import gop as JG
    packets = _clip(name) * reps
    assert [PG.packet_is_keyframe(p) for p in packets] == \
        [JG.packet_is_keyframe(p) for p in packets]
    gops = PG.split_gops(packets)
    assert gops == JG.split_gops(packets)
    assert len(gops) == CLIP_GOPS[name] * reps
    assert sum(map(len, gops)) == len(packets)


def test_split_gops_edges():
    """A leading non-keyframe run is its own group; an empty or
    non-frame packet is no keyframe; a show-existing packet neither."""
    k, f1, f2, *_rest = _two_gops()
    assert PG.split_gops([f1, f2, k, f1]) == [[f1, f2], [k, f1]]
    assert not PG.packet_is_keyframe(b"")
    assert not PG.packet_is_keyframe(b"\x00\x01")
    assert not PG.packet_is_keyframe(bytes([0x88 | 1]))
    assert PG.split_gops([]) == []


def test_gop_parallel_matches_serial_and_jax():
    """Two workers (and one) give the serial decode's frames in stream
    order, and the JAX package's decode_gops_parallel gives the same
    bytes."""
    from ffmpeg_hybrid_tpu.parallel.gop import decode_gops_parallel as jg
    packets = list(_two_gops())
    want = _serial(packets)
    assert len(want) == 6
    for workers in (2, 1):
        got = _md5s(PG.decode_gops_parallel(packets, workers=workers,
                                            device="cpu"))
        assert got == want
    assert _md5s(jg(packets, workers=2, recon_backend="golden")) == want


def test_gop_multiprocess_matches_serial(tmp_path):
    """Two spawned processes (each its own interpreter, PyTorch runtime
    and decoder) over the GOP split merge to the serial result."""
    packets = list(_two_gops())
    path = str(tmp_path / "twogop.ivf")
    write_ivf(path, b"VP90", 256, 128, 30, 1, list(enumerate(packets)))
    got = PG.decode_gops_md5_multiprocess(path, n_procs=2, device="cpu")
    assert got == _serial(packets)


def _workers_alive():
    return [t for t in threading.enumerate()
            if t.name.startswith("ThreadPoolExecutor")]


def test_gop_error_raised_at_its_place():
    """A GOP whose packet is cut short raises ValueError from the
    generator at its place: every frame of the GOPs before it comes
    first, and every worker thread is joined when it surfaces; a caller
    that leaves the generator early also joins them."""
    packets = list(_two_gops())
    bad = packets[:4] + [packets[4][:9]] + packets[5:]
    want = _serial(packets[:3])
    got = []
    gen = PG.decode_gops_parallel(bad, workers=2, device="cpu")
    with pytest.raises(ValueError):
        for f in gen:
            got.append(_md5s([f])[0])
    assert got == want
    assert not _workers_alive()
    gen = PG.decode_gops_parallel(packets, workers=2, device="cpu")
    next(gen)
    gen.close()
    assert not _workers_alive()


def test_workers_take_devices_in_turn(monkeypatch):
    """Worker i decodes on cuda:(i % device_count): the devices the pool
    deals out, on a machine of three cards (modelled)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    devs = PG._worker_devices(None)
    assert devs == [torch.device("cuda", i) for i in range(3)]
    assert PG._worker_devices("cpu") == [torch.device("cpu")]
    assert PG._worker_devices("cuda:1") == [torch.device("cuda", 1)]


# ---------------------------------------------------------------------------
# fault 3.1: the loop filter's schedule states are each decoder's own


def _ticket_model(launches, state_of, order):
    """A model of csrc/lpf.cu's ticket counter: each launch's blocks take
    tickets from the counter of its schedule state (state_of[launch])
    until they run out; the last block of a launch to finish resets the
    counter. order: the launch whose block takes the next ticket, step by
    step. Returns the tickets each launch ran."""
    T = 6
    ctr = {id(s): 0 for s in state_of.values()}
    ran = {k: [] for k in launches}
    done = set()
    for k in order:
        if k in done:
            continue
        c = id(state_of[k])
        if ctr[c] >= T:
            done.add(k)
            if all(j in done for j in launches if id(state_of[j]) == c):
                ctr[c] = 0
            continue
        ran[k].append(ctr[c])
        ctr[c] += 1
    return ran


@pytest.mark.parametrize("shared", [True, False])
def test_two_decoders_interleaved_on_two_streams(shared):
    """Two decoders' loop-filter launches on two streams run at once, their
    blocks taking tickets in turn. On one shared schedule state (the
    module-level store of old) the counter deals each ticket to one of
    them, so each launch filters only some superblocks of its frame; with
    a state a decoder each launch takes every ticket."""
    store_a = {}
    store_b = store_a if shared else {}
    from ffmpeg_hybrid_tpu_torch.ops import lpf_dense
    meta = torch.device("meta")
    sa = lpf_dense.schedule_state(store_a, meta, 2, 3, 1)
    sb = lpf_dense.schedule_state(store_b, meta, 2, 3, 1)
    assert (sa is sb) == shared
    ran = _ticket_model(("a", "b"), {"a": sa, "b": sb},
                        ["a", "b"] * 12)
    if shared:
        assert ran["a"] == [0, 2, 4] and ran["b"] == [1, 3, 5]
    else:
        assert ran["a"] == ran["b"] == list(range(6))


def test_each_decoder_owns_its_schedules(monkeypatch):
    """The schedule states are the decoder's (VP9Decoder.lf_schedules),
    which its FrameJobs carry to lf_frame_: two decoders never share a
    store."""
    from ffmpeg_hybrid_tpu_torch.ops import lpf_dense
    seen = []
    real = lpf_dense.lf_frame_

    def spy(*args, **kw):
        seen.append(kw.get("schedules"))
        return real(*args, **kw)

    monkeypatch.setattr(lpf_dense, "lf_frame_", spy)
    k = _two_gops()[0]
    decs = [VP9Decoder(device="cpu") for _ in range(2)]
    for dec in decs:
        job = dec.decode_pass_a(k)
        assert job.lf_schedules is dec.lf_schedules
        dec.decode_pass_b(dec.precompute_job(job))
    assert seen == [decs[0].lf_schedules, decs[1].lf_schedules]
    assert seen[0] is not seen[1]


@pytest.mark.cuda
def test_cuda_two_decoders_on_two_streams():
    """Two decoders, each on its own torch.cuda.Stream, interleaved frame
    by frame on bench_1080p_lf: every frame's MD5 equals its framemd5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    packets = _clip("bench_1080p_lf")
    want = [ln.split(",")[-1].strip() for ln in open(
        os.path.join(VEC, "bench_1080p_lf.framemd5"))
        if ln.strip() and not ln.startswith("#")]
    decs = [VP9Decoder(device="cuda") for _ in range(2)]
    streams = [torch.cuda.Stream() for _ in range(2)]
    got = [[], []]
    for pkt in packets:
        outs = []
        for dec, st in zip(decs, streams):
            with torch.cuda.stream(st):
                outs.append(dec.decode(pkt))
        for i, (st, frames) in enumerate(zip(streams, outs)):
            st.synchronize()
            got[i] += [hashlib.md5(f.to_bytes()).hexdigest() for f in frames]
    assert got[0] == want and got[1] == want
    assert not set(map(id, decs[0].lf_schedules.values())) & set(
        map(id, decs[1].lf_schedules.values()))


@pytest.mark.cuda
def test_cuda_gop_parallel_matches_framemd5():
    """decode_gops_parallel with 2 and 4 workers on bench_1080p_lf (6
    GOPs), each worker on its own stream of the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    packets = _clip("bench_1080p_lf")
    want = [ln.split(",")[-1].strip() for ln in open(
        os.path.join(VEC, "bench_1080p_lf.framemd5"))
        if ln.strip() and not ln.startswith("#")]
    for workers in (2, 4):
        got = [hashlib.md5(f.to_bytes()).hexdigest()
               for f in PG.decode_gops_parallel(packets, workers=workers)]
        assert got == want
