"""The multi-process decode of the port's rank mesh
(parallel/dist.py, decode_mesh_multiprocess) on the CPU: the committed
clip dryrun_mesh_2x4 (a filtered keyframe in four tile columns, then two
filtered inter frames on the two gop rows at once, the last at twice
the keyframe's size: scaled references) through two spawned gloo ranks
on a [2, 4] mesh split 2+2, the frames chained by the gather and
install; every frame's MD5 equal to the clip's framemd5 and each rank's
swaps, segments and launches as its plans give them. A rank that fails
fails the run. A `cuda` test runs the same on the card."""
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu_torch.parallel import dist as D
from ffmpeg_hybrid_tpu_torch.parallel.dryrun import read_clip

CLIP = "dryrun_mesh_2x4"


def _check(want, md5s, stats, device):
    assert md5s == want
    for r, st in enumerate(stats):
        assert st["rank"] == r and st["frames"] == len(want)
        assert st["slots"] == [(0, 2 * r, 2 * r + 2), (1, 2 * r, 2 * r + 2)]
        # a Y and a U+V replay a frame, each with its first swap
        assert st["initial"] == 2 * len(want)
        assert st["exchanges"] == st["cut_steps"] + st["initial"]
        assert 0 < st["cut_steps"] < st["segments"]
        assert st["launches"]["lf_replay"] == (
            st["segments"] if device != "cpu" else 0)
        assert st["gathers"] == 3 * len(want)


def test_dryrun_mesh_two_ranks_cpu():
    packets, want = read_clip(CLIP)
    md5s, stats = D.decode_mesh_multiprocess(packets, 2, 4, 2, device="cpu",
                                             timeout=300)
    _check(want, md5s, stats, "cpu")


def fail_on_rank_1(rank):
    """rank_setup of the failing run: rank 1 raises."""
    if rank == 1:
        raise ValueError("rank 1 stops here")


def test_a_failing_rank_fails_the_run():
    """Rank 1 raises before it joins the group: the run raises with its
    message, and rank 0, left waiting for it, is stopped."""
    packets, _want = read_clip(CLIP)
    with pytest.raises(RuntimeError, match="rank 1 failed"
                       "(.|\n)*rank 1 stops here"):
        D.decode_mesh_multiprocess(packets[:1], 1, 4, 2, device="cpu",
                                   timeout=120, rank_setup=fail_on_rank_1)


@pytest.mark.cuda
def test_cuda_dryrun_mesh_two_ranks():
    """The same two ranks on the card (both on cuda:0 of a one-card
    machine): the replay kernel once a segment."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    packets, want = read_clip(CLIP)
    md5s, stats = D.decode_mesh_multiprocess(packets, 2, 4, 2, timeout=300)
    _check(want, md5s, stats, "cuda")
