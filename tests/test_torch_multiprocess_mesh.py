"""The port's twin of tests/test_multiprocess_mesh.py: the sharded pass
B across TWO OS processes, torch.distributed gloo ranks on the CPU, with
the TILE axis laid across the process boundary (a [2 gop, 4 tile] mesh,
tiles 0-1 of each row on rank 0, 2-3 on rank 1), so the loop filter's
halo swaps after the steps that write the boundary cross it. The parent
decodes the stream with the JAX package's serial golden decoder and
passes the frames by file; the children import the port only, and each
checks every plane of its own stripes (and the planes the gather
rebuilds) against them. Then lf_scan_sharded_dist on seeded buffers in
two ranks with the splits 1+3, 2+2 and 3+1 against lf_scan_sharded_plain
over all four stripes in one process. Tolerance 0. Each child has its
own timeout; the group meets through a FileStore under tmp_path."""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
from ffmpeg_hybrid_tpu_torch.ops import lpf_replay as LR
from ffmpeg_hybrid_tpu_torch.parallel import dist as D
from ffmpeg_hybrid_tpu_torch.parallel import fullframe as PF

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOOLS = os.path.join(ROOT, "tools")
CHILD_TIMEOUT = 240

PRELUDE = r"""
import os, sys, pickle
import numpy as np
import torch
torch.set_num_threads(1)
from ffmpeg_hybrid_tpu_torch.ops import lpf_replay as LR
from ffmpeg_hybrid_tpu_torch.parallel import dist as D
from ffmpeg_hybrid_tpu_torch.parallel import fullframe as PF
from ffmpeg_hybrid_tpu_torch.parallel.mesh import make_rank_mesh
from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
assert not [m for m in sys.modules
            if m == "jax" or m.startswith(("jax.", "ffmpeg_hybrid_tpu."))]
store, rank, inf, outf = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
D.init(rank, 2, store, timeout=%d)
""" % CHILD_TIMEOUT

CHILD_MESH = PRELUDE + r"""
with open(inf, "rb") as f:
    frames, truth = pickle.load(f)
mesh = make_rank_mesh(2, 4, 2, device="cpu")
ex = D.HaloExchange()
dec = VP9Decoder(device="cpu")
jobs = [dec.decode_pass_a(d) for d in frames]
# the keyframe is serial, as in the JAX test: the mesh step under test is
# the inter frames' gop x tile decode
dec.decode_pass_b(dec.precompute_job(jobs[0]))
outs = PF.sharded_decode_pass_b(jobs[1:], mesh, ex)
nbad = nsh = 0
for g, st in enumerate(outs):
    assert (st.lo, st.hi) == (2 * rank, 2 * rank + 2)
    fr = truth[1 + g]
    cw = ((fr["size"][0] + 7) >> 3) * 8
    ch = ((fr["size"][1] + 7) >> 3) * 8
    full = PF.gather_planes(st, ex)
    for pi, (stripes, wr) in enumerate(zip(st.planes, (st.wreal, st.wrealu,
                                                        st.wrealu))):
        pw = cw if pi == 0 else cw >> fr["ss_h"]
        ph = ch if pi == 0 else ch >> fr["ss_v"]
        x0s = np.concatenate([[0], np.cumsum(wr)[:-1]])
        for i, t in enumerate(range(st.lo, st.hi)):
            x0, w = int(x0s[t]), int(wr[t])
            a = fr["planes"][pi][:ph, x0:min(x0 + w, pw)]
            b = stripes[i].numpy()[:ph, :a.shape[1]]
            nsh += 1
            if not np.array_equal(a, b):
                nbad += 1
                print(f"P{rank} shard g={g} t={t} plane {pi}: MISMATCH",
                      flush=True)
        if not np.array_equal(fr["planes"][pi][:ph, :pw],
                              full[pi].numpy()[:ph, :pw]):
            nbad += 1
            print(f"P{rank} gathered g={g} plane {pi}: MISMATCH", flush=True)
print(f"P{rank}: {nsh} shards checked, {nbad} bad; {ex.exchanges} swaps "
      f"({ex.cut_steps} cross-rank steps, {ex.initial} first), "
      f"{ex.segments} segments", flush=True)
assert ex.exchanges == ex.cut_steps + ex.initial and ex.initial == 4
D.dist.destroy_process_group()
sys.exit(1 if nbad or nsh == 0 else 0)
"""

CHILD_SCAN = PRELUDE + r"""
data = dict(np.load(inf))
out = {}
for split in ((1, 3), (2, 2), (3, 1)):
    ranks = list(np.repeat([0, 1], split))
    for which in ("y", "uv"):
        ex = D.HaloExchange()
        steps, wreal = data[which + "_steps"], data[which + "_wreal"]
        lo, hi, cuts, segs = LR.segment_plan(steps, wreal, ranks, rank)
        got = LR.lf_scan_sharded_dist(
            torch.from_numpy(data[which + "_buf"][lo:hi]), steps, wreal, 8,
            ranks, ex, (64, 64) if which == "y" else (32, 32))
        key = f"{split[0]}{split[1]}_{which}"
        out[key] = got.numpy()
        out[key + "_counts"] = np.asarray(
            [ex.exchanges, ex.cut_steps, ex.initial, ex.segments, len(segs),
             sum(len(c) for c in cuts.values())])
np.savez(outf, **out)
D.dist.destroy_process_group()
"""


def _run_pair(script, tmp_path, inf):
    """The script in two child processes (ranks 0 and 1 of a FileStore
    group under tmp_path), each with its own timeout -> (outputs, out
    files); a child that fails fails the test with both outputs."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"out{r}.npz") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, store, str(r), str(inf), outs[r]],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    texts, ok = [], True
    try:
        for p in procs:
            out, _ = p.communicate(timeout=CHILD_TIMEOUT + 30)
            texts.append(out.decode(errors="replace"))
            ok &= p.returncode == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if not ok:
        raise AssertionError("a rank failed:\n" + "\n---\n".join(texts))
    return texts, outs


def _mini():
    sys.path.insert(0, TOOLS)
    try:
        import mini_encoder
    finally:
        sys.path.pop(0)
    return mini_encoder


def test_two_process_mesh(tmp_path):
    """The JAX test's stream (1024x128 in four tile columns: a filtered
    keyframe, two filtered inter frames with intra blocks and MVs to 16)
    on its [2, 4] mesh split across two ranks: every plane of each rank's
    stripes, and of the gathered frames, equal to the JAX package's
    serial golden decode."""
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder as JD
    mini = _mini()
    w, h = 1024, 128
    kf = mini.encode_keyframe_random(w, h, seed=5, filter_level=24,
                                     tile_cols_log2=2)
    inters = [mini.encode_inter_flex(w, h, seed=30 + g, refresh_mask=0,
                                     filter_level=18 + 7 * g, coeffs=True,
                                     p_intra=0.2, mv_mags=(0, 2, 4, 8, 16),
                                     tile_cols_log2=2)
              for g in range(2)]
    frames = [kf] + inters
    ser = JD(recon_backend="golden")
    truth = []
    for d in frames:
        js = ser.decode_pass_a(d)
        ser.decode_pass_b(js)
        fr = js.cur_frame_obj
        truth.append({"planes": [np.asarray(p) for p in fr.planes],
                      "size": fr.size, "ss_h": fr.ss_h, "ss_v": fr.ss_v})
    inf = tmp_path / "frames.pkl"
    with open(inf, "wb") as f:
        pickle.dump((frames, truth), f)
    texts, _outs = _run_pair(CHILD_MESH, tmp_path, inf)
    for r in range(2):
        assert f"P{r}: 12 shards checked, 0 bad" in texts[r], texts[r]


def test_dist_scan_splits_over_gloo(tmp_path):
    """lf_scan_sharded_dist in two gloo ranks on seeded buffers with the
    steps of the stream's keyframe, Y and U+V, split 1+3, 2+2 and 3+1:
    each rank's stripes equal lf_scan_sharded_plain's over all four in
    this process; each rank's swaps are its cross-rank steps and the
    first one, its segments the plan's. A rank layout that is not
    contiguous raises before any swap."""
    pkt = _mini().encode_keyframe_random(1024, 128, seed=5, filter_level=24,
                                         tile_cols_log2=2)
    t, cfg = PF.frame_tensors(VP9Decoder(device="cpu").decode_pass_a(pkt))
    rng = np.random.RandomState(11)
    data, want = {}, {}
    for which, B, H, wp, wkey in (("y", 1, cfg["Hy"], cfg["Wpad"], "wreal"),
                                  ("uv", 2, cfg["Hu"], cfg["Wpadu"],
                                   "wrealu")):
        walk = np.cumsum(rng.randint(-2, 3, (4, B, H, LR.HALO + wp)), axis=3)
        buf = np.clip(128 + walk // 3, 0, 255).astype(np.int32)
        steps, wreal = t[which + "steps"], t[wkey]
        data.update({which + "_buf": buf, which + "_steps": steps,
                     which + "_wreal": wreal})
        want[which] = LR.lf_scan_sharded_plain(torch.from_numpy(buf), steps,
                                               wreal, 8).numpy()
        with pytest.raises(ValueError, match="contiguous"):
            LR.lf_scan_sharded_dist(torch.from_numpy(buf[:2]), steps, wreal,
                                    8, [0, 1, 0, 1], D.HaloExchange(0),
                                    (64, 64) if which == "y" else (32, 32))
    inf = tmp_path / "buffers.npz"
    np.savez(inf, **data)
    _texts, outs = _run_pair(CHILD_SCAN, tmp_path, inf)
    got = [np.load(o) for o in outs]
    for split in ((1, 3), (2, 2), (3, 1)):
        for which in ("y", "uv"):
            key = f"{split[0]}{split[1]}_{which}"
            assert np.array_equal(got[0][key], want[which][:split[0]]), key
            assert np.array_equal(got[1][key], want[which][split[0]:]), key
            for g in got:
                ex, cut, first, seg, plan_seg, plan_cut = g[key + "_counts"]
                assert first == 1 and cut == plan_cut > 0
                assert ex == cut + first and seg == plan_seg > cut
