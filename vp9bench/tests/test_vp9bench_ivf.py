"""The frozen IVF and superframe reader against the committed clips and
the port's own reader."""
import os

import pytest

from conftest import ROOT
from vp9bench import ivf

CLIPS = {"vp9bench/clips/fmt_inter_420_10_1080p": 4,
         "vp9bench/clips/fmt_inter_444_1080p": 4,
         "vectors/passa_inter_modes": 4, "vectors/bench_1080p": 30}


@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_frame_counts_match_the_framemd5(clip):
    (w, h), packets = ivf.read_clip(os.path.join(ROOT, clip + ".ivf"))
    rows = ivf.read_framemd5(os.path.join(ROOT, clip + ".framemd5"))
    assert sum(p.visible for p in packets) == len(rows) == CLIPS[clip]
    assert w > 0 and h > 0


@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_same_payloads_as_the_ports_reader(clip):
    from ffmpeg_hybrid_tpu_torch.formats.ivf import read_ivf
    from ffmpeg_hybrid_tpu_torch.formats.superframe import split_superframe
    _info, pk = read_ivf(os.path.join(ROOT, clip + ".ivf"))
    want = [(fr, pts is not None) for p, d in pk
            for pts, fr in split_superframe(d, p)]
    _size, got = ivf.read_clip(os.path.join(ROOT, clip + ".ivf"))
    assert [(p.data, p.visible) for p in got] == want


def test_superframe_split_and_hidden_frame():
    from ffmpeg_hybrid_tpu_torch.formats.superframe import merge_superframe
    shown = bytes([0x82, 0x49, 0x83]) + bytes(10)      # keyframe, shown
    hidden = bytes([0x84, 0x00]) + bytes(20)           # inter, not shown
    sf = merge_superframe([hidden, shown])
    assert ivf.split_superframe(sf) == [hidden, shown]
    assert ivf.is_visible(shown) and not ivf.is_visible(hidden)
    assert ivf.split_superframe(shown) == [shown]


def test_bench_clips_are_copies_of_the_vectors():
    for name in ("fmt_inter_420_10_1080p", "fmt_inter_444_1080p"):
        for ext in (".ivf", ".framemd5"):
            with open(os.path.join(ROOT, "vp9bench", "clips", name + ext),
                      "rb") as a, open(os.path.join(ROOT, "vectors",
                                                    name + ext), "rb") as b:
                assert a.read() == b.read()
