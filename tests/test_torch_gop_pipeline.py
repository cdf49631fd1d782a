"""The port's chained-GOP stripe pipeline (parallel/gop_pipeline.py) on a
[4, 1] CPU mesh, bit-exact (tolerance 0) on every frame's coded area,
all three planes: against the JAX package's decode_chained_gop on four
of the virtual CPU devices, on the cases of tests/test_gop_pipeline.py
(128x192 and 130x134, loop-filter levels 0, 24 and 31), and against the
port's serial decode of the same streams with the native and with the
pure-Python pass A. Streams come from tools/mini_encoder.py in process.
The scope checks, the forward step and the committed clips are
tests/test_torch_gop_pipeline_parts.py; the dry runs
tests/test_torch_dryrun.py."""
import os
import sys
from functools import lru_cache

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu.parallel.gop_pipeline import \
    decode_chained_gop as jax_decode_chained_gop
from ffmpeg_hybrid_tpu_torch import passa_native
from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
from ffmpeg_hybrid_tpu_torch.parallel.gop_pipeline import decode_chained_gop
from ffmpeg_hybrid_tpu_torch.parallel.mesh import make_mesh

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
G = 4
# tests/test_gop_pipeline.py's cases: (w, h), loop-filter level
CASES = [((128, 192), 0), ((130, 134), 0), ((128, 192), 24),
         ((130, 134), 31)]
IDS = [f"{w}x{h}-lf{flt}" for (w, h), flt in CASES]


def chained_stream(w, h, n_inter, seed=3, flt=0, **inter):
    """A keyframe and n_inter chained inter frames, as
    tests/test_gop_pipeline.py encodes them; `inter` overrides
    encode_inter_flex's arguments."""
    sys.path.insert(0, TOOLS)
    try:
        from mini_encoder import encode_inter_flex, encode_keyframe_random
    finally:
        sys.path.pop(0)
    kw = dict(coeffs=True, p_intra=0.0, p_skip=0.3, mv_mags=(0, 2, 4, 8, 16),
              refresh_mask=0x01, filter_level=flt)
    kw.update(inter)
    pkts = [encode_keyframe_random(w, h, 8, seed=seed, txfmmode=3,
                                   yac_qi=60, filter_level=flt)]
    for i in range(n_inter):
        pkts.append(encode_inter_flex(w, h, seed=seed + 10 + i, **kw))
    return pkts


def coded(w, h, plane):
    """The coded area (8-pixel units) of a 4:2:0 plane: (rows, cols)."""
    cw, ch = ((w + 7) >> 3) * 8, ((h + 7) >> 3) * 8
    return (ch >> 1, cw >> 1) if plane else (ch, cw)


@lru_cache(maxsize=None)
def _stream(case):
    (w, h), flt = case
    return tuple(chained_stream(w, h, G, flt=flt))


@lru_cache(maxsize=None)
def _serial(case):
    dec = VP9Decoder(device="cpu")
    return [f for p in _stream(case) for f in dec.decode(p)]


@lru_cache(maxsize=None)
def _port(case, use_native):
    return decode_chained_gop(list(_stream(case)), make_mesh(G, G,
                                                             device="cpu"),
                              Hs=64, lag=2, use_native=use_native)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_pipeline_matches_jax(case):
    (w, h), _flt = case
    mesh = Mesh(np.asarray(jax.devices()[:G]), ("gop",))
    want, _jobs = jax_decode_chained_gop(list(_stream(case)), mesh, Hs=64,
                                         lag=2)
    got, _jobs = _port(case, None)
    for g in range(G):
        for p in range(3):
            rows, cols = coded(w, h, p)
            a = got[p][g][:rows, :cols].numpy()
            b = np.asarray(want[p][g])[:rows, :cols]
            assert np.array_equal(a, b), \
                f"frame {g} plane {p}: {int((a != b).sum())} mismatches"


@pytest.mark.parametrize("use_native", [None, False],
                         ids=["native", "python"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_pipeline_matches_serial(case, use_native):
    (w, h), _flt = case
    (oy, ou, ov), jobs = _port(case, use_native)
    assert all(j.use_native == (use_native is None
                                and passa_native.available())
               for j in jobs)
    frames = _serial(case)
    assert oy.shape == (G, 192, 192 if w == 130 else 128)
    assert oy.dtype == ou.dtype == ov.dtype == torch.int32
    for g in range(G):
        for p, out in enumerate((oy, ou, ov)):
            rows, cols = coded(w, h, p)
            want = frames[1 + g].dev[p][:rows, :cols]
            assert torch.equal(out[g][:rows, :cols], want), \
                f"frame {g} plane {p}"
            # the job's frame holds its row's planes
            assert torch.equal(jobs[g].cur_frame_obj.dev[p][:rows, :cols],
                               want)
