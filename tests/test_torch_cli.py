"""The port's command line (`python -m ffmpeg_hybrid_tpu_torch`) and its
container and bitstream-filter modules against the JAX package's, in
process: the JAX CLI with `-b golden`, the port's with `--device cpu`.
Every output must be equal byte for byte (tolerance 0), apart from the
framemd5 `#software:` line, which names each package.

The streams are built here with tools/mini_encoder.py, small enough
that each CLI decodes one in well under a second; none is loop-filtered
(the loop filter's plain version is the slowest stage on the CPU, and
the decoder's tests hold it).
"""
import io
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu import __main__ as JCLI
from ffmpeg_hybrid_tpu.formats import bsf as JB
from ffmpeg_hybrid_tpu.formats import parser as JP
from ffmpeg_hybrid_tpu.formats import reorder as JR
from ffmpeg_hybrid_tpu.formats import webm as JW
from ffmpeg_hybrid_tpu_torch import __main__ as PCLI
from ffmpeg_hybrid_tpu_torch.formats import bsf as PB
from ffmpeg_hybrid_tpu_torch.formats import parser as PP
from ffmpeg_hybrid_tpu_torch.formats import reorder as PR
from ffmpeg_hybrid_tpu_torch.formats import webm as PW
from ffmpeg_hybrid_tpu_torch.formats.ivf import write_ivf
from ffmpeg_hybrid_tpu_torch.formats.superframe import merge_superframe

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOOLS = os.path.join(ROOT, "tools")

# segment features (q, lf, ref, skip) of tests/test_encparams.py's
# two-tile stream: q deltas
SEG_Q = [(20, 0, -1, 0), (-30, 0, -1, 0), (15, 0, -1, 0),
         (40, 0, -1, 0)] + [(0, 0, -1, 0)] * 4
# absolute q values
SEG_ABS = [(90, 0, -1, 0), (30, 0, -1, 0), (140, 0, -1, 0),
           (60, 0, -1, 0)] + [(0, 0, -1, 0)] * 4


def _mini():
    sys.path.insert(0, TOOLS)
    try:
        import mini_encoder
    finally:
        sys.path.pop(0)
    return mini_encoder


def _kf(m, w, h, seed, **kw):
    kw.setdefault("filter_level", 0)
    return m.encode_keyframe_random(w, h, seed=seed, **kw)


def _lossless_kf(m, w, h, seed):
    r = np.random.RandomState(seed)
    return m.encode_keyframe_lossless(
        r.randint(0, 256, (h, w)),
        r.randint(0, 256, ((h + 1) // 2, (w + 1) // 2)),
        r.randint(0, 256, ((h + 1) // 2, (w + 1) // 2)), 8)


def _superframe(m):
    # an invisible inter frame into slot 1 and a visible one predicting
    # from it, merged into one packet
    hidden = m.encode_inter_flex(96, 64, seed=52, show=False,
                                 refresh_mask=0x02, coeffs=True)
    shown = m.encode_inter_flex(96, 64, seed=53, refidx=(1, 1, 1),
                                refresh_mask=0x01)
    return [_kf(m, 96, 64, 51), merge_superframe([hidden, shown])]


# name: (width, height, IVF rate and scale, packets builder); the pts of
# packet i is i, or as listed beside the timebase
_STREAMS = {
    "inter_130x70": (130, 70, (30, 1), lambda m: [
        _kf(m, 130, 70, 1),
        m.encode_inter_flex(130, 70, seed=2, coeffs=True, p_intra=0.2,
                            refresh_mask=0x01),
        m.encode_inter_flex(130, 70, seed=3, coeffs=True,
                            refresh_mask=0x01, mv_mags=(0, 2, 8, 24))]),
    "tiles_512x128": (512, 128, (30, 1), lambda m: [
        _kf(m, 512, 128, 4, tile_cols_log2=1)]),
    "k444": (96, 64, (30, 1), lambda m: [
        _kf(m, 96, 64, 5, ss_h=0, ss_v=0)]),
    "k10": (96, 64, (30, 1), lambda m: [_kf(m, 96, 64, 6, bpp=10)]),
    # 64x64 -> 128x128 (all-skip ZEROMV from the smaller reference)
    "resize": (128, 128, (30, 1), lambda m: [
        _lossless_kf(m, 64, 64, 9), m.encode_inter_zeromv(128, 128)]),
    "superframe": (96, 64, (30, 1), _superframe),
    # a keyframe, then a one-byte packet showing slot 0 again
    "show_existing": (96, 64, (30, 1), lambda m: [
        _kf(m, 96, 64, 7), bytes([0x88])]),
    # IVF timebase 1/1000: the CLIs rescale its pts to 1/30
    "tb_1000": (96, 64, (1000, 1), lambda m: [
        _kf(m, 96, 64, 8),
        m.encode_inter_flex(96, 64, seed=10, refresh_mask=0x01)]),
    "segq": (96, 64, (30, 1), lambda m: [
        _kf(m, 96, 64, 11, seg_feat=SEG_Q),
        m.encode_inter_flex(96, 64, seed=12, seg_feat=SEG_Q,
                            refresh_mask=0x01)]),
    "segabs": (96, 64, (30, 1), lambda m: [
        _kf(m, 96, 64, 13, seg_feat=SEG_ABS, seg_abs=1)]),
    "segtiles": (512, 128, (30, 1), lambda m: [
        _kf(m, 512, 128, 31, txfmmode=3, yac_qi=60, tile_cols_log2=1,
            seg_feat=SEG_Q)]),
}
_PTS = {"tb_1000": [0, 33]}


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """Each stream's IVF path, encoded at its first use."""
    d = tmp_path_factory.mktemp("cli")
    made = {}

    def get(name):
        if name not in made:
            w, h, (rate, scale), build = _STREAMS[name]
            pkts = build(_mini())
            pts = _PTS.get(name, range(len(pkts)))
            made[name] = str(d / (name + ".ivf"))
            write_ivf(made[name], b"VP90", w, h, rate, scale,
                      list(zip(pts, pkts)))
        return made[name]
    return get


def _run(main, argv, fmt, out_dir):
    """(exit code, output) of one CLI call in this process: stdout for
    the text formats, the -o file's bytes for the binary ones."""
    if fmt in ("y4m", "rawvideo"):
        path = os.path.join(out_dir, f"out.{fmt}")
        rc = main([*argv, "-f", fmt, "-o", path])
        with open(path, "rb") as f:
            return rc, f.read()
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main([*argv, "-f", fmt])
    return rc, buf.getvalue()


def _both(argv, fmt, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax = _run(JCLI.main, [*argv, "-b", "golden"], fmt, tmp_path / "jax")
    port = _run(PCLI.main, [*argv, "--device", "cpu"], fmt,
                tmp_path / "port")
    return jax, port


def _software(text, name):
    lines = text.splitlines(keepends=True)
    sw = [i for i, ln in enumerate(lines) if ln.startswith("#software:")]
    assert len(sw) == 1 and lines[sw[0]] == f"#software: {name}\n"
    return lines[:sw[0]] + lines[sw[0] + 1:]


def _same(jax, port, fmt):
    assert jax[0] == port[0]
    if fmt == "framemd5":
        assert (_software(port[1], "ffmpeg_hybrid_tpu_torch")
                == _software(jax[1], "ffmpeg_hybrid_tpu"))
    else:
        assert port[1] == jax[1]


@pytest.mark.parametrize("name,fmt,extra", [
    ("inter_130x70", "framemd5", ()),
    ("inter_130x70", "framemd5", ("--frames", "2")),
    ("inter_130x70", "y4m", ()),
    ("inter_130x70", "rawvideo", ()),
    ("inter_130x70", "encparams", ()),
    ("inter_130x70", "framemd5",
     ("--bsf", "vp9_metadata=color_space=bt709:color_range=pc")),
    ("tiles_512x128", "framemd5", ()),
    ("k444", "framemd5", ()),
    ("k444", "y4m", ()),
    ("k10", "framemd5", ()),
    ("k10", "rawvideo", ()),
    ("k10", "y4m", ()),          # refused: 8-bit only, exit code 1
    ("resize", "framemd5", ()),
    ("resize", "rawvideo", ("--no-pipeline",)),
    ("superframe", "framemd5", ()),
    ("superframe", "framemd5", ("--no-pipeline",)),
    ("superframe", "framemd5",
     ("--bsf", "vp9_superframe_split,vp9_raw_reorder")),
    ("superframe", "framemd5", ("--no-native",)),
    ("show_existing", "framemd5", ()),
    ("show_existing", "framemd5", ("--no-pipeline",)),
    ("show_existing", "encparams", ()),
    ("tb_1000", "framemd5", ()),
])
def test_cli_matches_jax(streams, tmp_path, name, fmt, extra):
    jax, port = _both([streams(name), *extra], fmt, tmp_path)
    _same(jax, port, fmt)
    if fmt == "y4m" and name == "k10":
        assert port == (1, b"")
    else:
        assert port[0] == 0 and port[1]


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("name", ["segq", "segabs", "segtiles"])
def test_cli_encparams_segmentation_matches_jax(streams, tmp_path, name,
                                                native):
    argv = [streams(name)] + ([] if native else ["--no-native"])
    jax, port = _both(argv, "encparams", tmp_path)
    _same(jax, port, "encparams")
    assert "nb_blocks" in port[1]


@pytest.mark.parametrize("layout", [
    {}, {"block_groups": True}, {"lacing": "xiph"}, {"lacing": "ebml"}],
    ids=["simpleblock", "blockgroup", "xiph", "ebml"])
def test_cli_webm_matches_jax(streams, tmp_path, layout):
    """A remux of the superframe stream into WebM (1/1000 timebase)."""
    from ffmpeg_hybrid_tpu_torch.formats.ivf import read_ivf
    _info, pkts = read_ivf(streams("superframe"))
    path = str(tmp_path / "in.webm")
    PW.write_webm(path, 96, 64, [(33 * i + 7, d) for i, (_p, d)
                                 in enumerate(pkts)], **layout)
    jax, port = _both([path], "framemd5", tmp_path)
    _same(jax, port, "framemd5")
    pts = [ln.split(",")[2].strip() for ln in port[1].splitlines()
           if not ln.startswith("#")]
    # a lace's later frames carry no timecode of their own
    assert pts == (["7", "0"] if "lacing" in layout else ["7", "40"])


@pytest.mark.parametrize("layout", [
    {}, {"block_groups": True}, {"lacing": "xiph"}, {"lacing": "ebml"},
    {"lacing": "fixed"}, {"codec": b"V_VP8"}],
    ids=["simpleblock", "blockgroup", "xiph", "ebml", "fixed", "vp8"])
def test_webm_layouts_match_jax(tmp_path, layout):
    """Each package's write_webm writes the same bytes, and each one's
    read_webm gives the same packets from them."""
    sizes = [33] * 5 if layout.get("lacing") == "fixed" else \
        [20 + 7 * i for i in range(5)]
    pkts = [(i * 33, bytes([i]) * n) for i, n in enumerate(sizes)]
    JW.write_webm(str(tmp_path / "j.webm"), 64, 64, pkts, **layout)
    PW.write_webm(str(tmp_path / "p.webm"), 64, 64, pkts, **layout)
    data = (tmp_path / "p.webm").read_bytes()
    assert data == (tmp_path / "j.webm").read_bytes()
    got = list(PW.read_webm(str(tmp_path / "p.webm")))
    assert got == list(JW.read_webm(str(tmp_path / "j.webm")))
    # the packets, in order; a lace's later frames have no pts
    assert [d for _p, d in got] == ([] if "codec" in layout else
                                    [d for _p, d in pkts])


def _outcome(fn, *args):
    """What a call gives: ("ok", its result) or ("raise", the exception's
    type)."""
    try:
        return "ok", fn(*args)
    except Exception as e:  # noqa: BLE001 - the type is the result
        return "raise", type(e)


def test_malformed_webm_raises_as_jax(tmp_path):
    """Every truncation and every flipped header byte of the WebM inputs
    of tests/test_webm.py, and a file that is not EBML: the same packets
    or the same exception type from both packages."""
    src = tmp_path / "t.webm"
    PW.write_webm(str(src), 64, 64, [(i * 33, bytes([i]) * 40)
                                     for i in range(3)], lacing="ebml")
    trunc = src.read_bytes()
    PW.write_webm(str(src), 64, 64, [(0, b"k" * 64), (33, b"l" * 64)])
    flip = src.read_bytes()
    inputs = [b"DKIF" + b"\x00" * 100]
    inputs += [trunc[:cut] for cut in range(1, len(trunc), 7)]
    for pos in range(min(len(flip), 120)):
        mut = bytearray(flip)
        mut[pos] ^= 0xFF
        inputs.append(bytes(mut))
    q = str(tmp_path / "bad.webm")
    kinds = set()
    for data in inputs:
        with open(q, "wb") as f:
            f.write(data)
        want = _outcome(lambda: list(JW.read_webm(q)))
        assert _outcome(lambda: list(PW.read_webm(q))) == want
        kinds.add(want[0])
    assert kinds == {"ok", "raise"}


@pytest.mark.parametrize("data", [
    b"\x00\x00\x00\x00", b"",
    b"\x82\x49\x83\x42" + b"\x00" * 8 + bytes([0xC1, 4, 4, 0xC1])],
    ids=["marker", "empty", "superframe"])
def test_malformed_reorder_raises_as_jax(data):
    want = _outcome(JR.VP9RawReorder().send, 0, data)
    assert want[0] == "raise"
    assert _outcome(PR.VP9RawReorder().send, 0, data) == want


@pytest.mark.parametrize("chain", [
    "vp9_superframe_split",
    "vp9_superframe_split,vp9_superframe",
    "vp9_superframe_split,vp9_raw_reorder",
    "vp9_superframe_split,vp9_raw_reorder,vp9_superframe",
    "vp9_metadata=color_space=bt709:color_range=pc",
    "vp9_metadata=color_space=rgb",
    "vp9_metadata=color_space=bt2020:color_range=tv"])
def test_bsf_chain_packets_match_jax(streams, chain):
    """Each chain's packets on every stream, and the parser's flags for
    each split frame."""
    from ffmpeg_hybrid_tpu_torch.formats.ivf import read_ivf
    for name in ("inter_130x70", "k444", "k10", "superframe",
                 "show_existing", "resize"):
        pkts = list(read_ivf(streams(name))[1])
        got = _outcome(lambda: list(PB.apply_bsf_chain(iter(pkts), chain)))
        assert got == _outcome(
            lambda: list(JB.apply_bsf_chain(iter(pkts), chain)))
        if chain == "vp9_superframe_split":
            for _p, d in got[1]:
                assert _outcome(lambda: vars(PP.parse_frame_flags(d))) \
                    == _outcome(lambda: vars(JP.parse_frame_flags(d)))


@pytest.mark.parametrize("name", ["superframe", "k10"])
def test_framemd5_module_matches_jax(streams, tmp_path, name):
    """formats/framemd5.py: decode_file_md5s on the CPU against the JAX
    package's on the golden backend, on the IVF and on a WebM remux;
    parse_framemd5 reads the CLI's output back to the same pairs."""
    from ffmpeg_hybrid_tpu.formats import framemd5 as JF
    from ffmpeg_hybrid_tpu_torch.formats import framemd5 as PF
    from ffmpeg_hybrid_tpu_torch.formats.ivf import read_ivf
    ivf = streams(name)
    info, pkts = read_ivf(ivf)
    webm = str(tmp_path / "in.webm")
    PW.write_webm(webm, info.width, info.height, list(pkts))
    for path in (ivf, webm):
        got = PF.decode_file_md5s(path, device="cpu")
        assert got == JF.decode_file_md5s(path, backend="golden")
    out = tmp_path / "out.framemd5"
    with open(out, "w") as f, redirect_stdout(f):
        assert PCLI.main([ivf, "--device", "cpu"]) == 0
    assert PF.parse_framemd5(str(out)) == got


def test_cli_default_device_raises_without_a_card(streams, monkeypatch):
    """Without a card the default device raises before any output."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(RuntimeError,
                                             match="no CUDA device"):
        PCLI.main([streams("k444")])
    assert buf.getvalue() == ""


@pytest.mark.cuda
def test_cli_bench_1080p_on_the_card_matches_framemd5():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    vec = os.path.join(ROOT, "vectors", "bench_1080p")
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert PCLI.main([vec + ".ivf"]) == 0
    rows = [ln for ln in buf.getvalue().splitlines()
            if not ln.startswith("#")]
    with open(vec + ".framemd5") as f:
        want = [ln for ln in f.read().splitlines()
                if ln and not ln.startswith("#")]
    assert rows == want
