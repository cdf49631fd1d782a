"""The device pass-A kernel, csrc/passa.cu, run on the CPU: compiled with
g++ (C++20) against tests/passa_emu/cuda_runtime.h, a stand-in for the
CUDA runtime in which a block's 32 threads are host threads and every
warp intrinsic a barrier round, and launched through
ops/passa_device.py's own launcher on CPU tensors. Each frame's outputs
(records, coefficient and eob pairs in order, counts, err words, bools a
lane and, on inter frames, the MV and reference grids) must equal
decode_frame_plain's: every frame of the small clips (vectors/passa_*,
the inter clips with their symbol counts forced on), bench_1080p frames
1 and 6 and bench_1080p_lf frame 0. This runs the kernel's logic where
there is no card (its packed tables, the pipelined token loop and its
ZERO runs, the slot-parallel candidate scan, the lanes' grid and context
writes and the handovers between lane 0 and the warp), and since the
threads do not run in lockstep it shows a lane that reads what another
may still be writing; timing, alignment and the compiler are the card's
alone (chip_smoke.py's passa phase runs the same source there)."""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu_torch import _build
from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
from ffmpeg_hybrid_tpu_torch.formats.ivf import read_ivf
from ffmpeg_hybrid_tpu_torch.formats.superframe import split_superframe
from ffmpeg_hybrid_tpu_torch.ops import _cuda
from ffmpeg_hybrid_tpu_torch.ops import passa_device as PD

HERE = os.path.dirname(os.path.abspath(__file__))
VEC = os.path.join(HERE, "..", "vectors")
# the small clips of tools/make_passa_vectors_torch.py (their intra
# frames) and tools/make_passa_inter_vectors_torch.py (every frame, the
# counts forced on)
INTRA_CLIPS = ("passa_s2", "passa_s4", "passa_s5", "passa_s7", "passa_s41",
               "passa_s42", "passa_s51", "passa_seg", "passa_wide",
               "passa_10bit", "passa_444_12", "passa_lossless",
               "passa_intraonly")
INTER_CLIPS = ("passa_inter_modes", "passa_inter_seg", "passa_inter_tiles")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/passa.cu built for the host: its launch made a call of the
    stand-in's emulate(), its dynamic shared memory the stand-in's
    buffer."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel for the host")
    with open(os.path.join(_build.CSRC_DIR, "passa.cu")) as f:
        src = f.read()
    for a, b in (("passa_kernel<kSec, kCount><<<S, 32, sizeof(Smem), "
                  "stream>>>(", "emulate(S, passa_kernel<kSec, kCount>, "),
                 ("extern __shared__ __align__(16) unsigned char "
                  "smem_raw[];", "")):
        assert src.count(a) == 1, a
        src = src.replace(a, b)
    out = tmp_path_factory.mktemp("passa_emu")
    cpp = out / "passa_emu.cpp"
    cpp.write_text(src)
    lib = out / "libpassa_emu.so"
    built = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-w",
         "-I", os.path.join(HERE, "passa_emu"), "-I", _build.CSRC_DIR, "-o",
         str(lib), str(cpp)], capture_output=True, text=True, timeout=300)
    assert built.returncode == 0, built.stderr
    dll = ctypes.CDLL(str(lib))
    for name, argtypes in PD._SIGNATURES.items():
        getattr(dll, name).argtypes = argtypes
        getattr(dll, name).restype = ctypes.c_int
    return dll


def _frames(name):
    _info, pkts = read_ivf(os.path.join(VEC, name + ".ivf"))
    return [fd for pts, data in pkts for _p, fd in split_superframe(data, pts)]


def _cases(name):
    """(inputs, meta) of each frame of clip `name` the kernel takes, each
    prepared by a decoder run through the frames before it."""
    dec = VP9Decoder(device="cpu")
    out = []
    for i, fd in enumerate(_frames(name)):
        if dec.decode_pass_a(fd).ready is not None:
            continue
        h = dec.header
        if name in INTER_CLIPS:
            inputs, meta = (PD.prep_keyframe if h.keyframe or h.intraonly
                            else PD.prep_inter)(dec, fd)
            meta["want_counts"] = 1
        elif h.keyframe or h.intraonly:
            inputs, meta = PD.prep_keyframe(dec, fd)
        else:
            continue
        out.append((i, inputs, meta))
    return out


def _one_frame(name, i):
    frames = _frames(name)
    dec = VP9Decoder(device="cpu")
    for fd in frames[:i + 1]:
        dec.decode_pass_a(fd)
    h = dec.header
    prep = PD.prep_keyframe if h.keyframe or h.intraonly else PD.prep_inter
    return [(i, *prep(dec, frames[i]))]


def _run(dll, monkeypatch, cases):
    """Each case through the emulated kernel and the plain walk; every
    output of the two equal."""
    def launch(_source, _signatures, name, *args):
        keep = []
        rc = getattr(dll, name)(*(_cuda._arg(a, keep) for a in args), None)
        assert rc == 0, rc
    monkeypatch.setattr(PD._cuda, "launch", launch)
    assert cases
    for i, inputs, meta in cases:
        got = [t.numpy() for t in PD._launch(inputs, meta,
                                             torch.device("cpu"))]
        want = [t.numpy() for t in PD.decode_frame_plain(inputs, meta)]
        assert len(got) == len(want)
        assert not want[7].any()
        for k in (1, 3, 5):
            assert np.array_equal(got[k], want[k]), (i, k)
            for s in range(meta["S"]):
                m = int(want[k][s])
                assert np.array_equal(got[k - 1][s, :m],
                                      want[k - 1][s, :m]), (i, k, s)
        for k in (6, 7):
            assert np.array_equal(got[k], want[k]), (i, k)
        assert np.array_equal(got[8][:, 0], want[8][:, 0]), i
        for k in range(9, len(want)):
            assert np.array_equal(got[k], want[k]), (i, k)


@pytest.mark.parametrize("name", INTRA_CLIPS + INTER_CLIPS)
def test_emulated_kernel_matches_plain_on_the_small_clips(emulated,
                                                          monkeypatch,
                                                          name):
    _run(emulated, monkeypatch, _cases(name))


@pytest.mark.parametrize("name,i", [("bench_1080p", 1), ("bench_1080p", 6),
                                    ("bench_1080p_lf", 0)])
def test_emulated_kernel_matches_plain_on_1080p_frames(emulated,
                                                       monkeypatch, name,
                                                       i):
    _run(emulated, monkeypatch, _one_frame(name, i))
