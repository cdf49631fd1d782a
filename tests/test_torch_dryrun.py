"""The port's twin of the JAX driver's multi-device dry run
(parallel/dryrun.py, __graft_entry__.py:57-201 of the JAX package) on
CPU meshes: dryrun_multichip for 2 and 4 slots (the tile-sharded pass
B on (1, 2) and (2, 2) meshes, then its chained leg; 8 slots, some 70 s
here, are tests/test_torch_dryrun_mesh8.py) and dryrun_gop_pipeline(4),
each bit-exact against the port's serial decode
of the committed clips, whose MD5s equal the clips' framemd5; the slot
and frame counts without a clip raise. A `cuda` test runs them, and the
stripe pipeline on vectors/chained_1080p, on the card."""
import hashlib

import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu_torch.parallel import dryrun
from ffmpeg_hybrid_tpu_torch.parallel.gop_pipeline import decode_chained_gop
from ffmpeg_hybrid_tpu_torch.parallel.mesh import make_mesh


def check_multichip(n, capsys):
    """dryrun_multichip(n) on the CPU and the two lines it prints."""
    dryrun.dryrun_multichip(n, device="cpu")
    out = capsys.readouterr().out.splitlines()
    gop, ntile = dryrun.MESH_CLIPS[n][1]
    assert out[0].startswith(f"dryrun_multichip OK: mesh gop={gop} x "
                             f"tile={ntile} on cpu")
    assert out[1].startswith(f"dryrun_gop_pipeline OK: {min(n, 4)} CHAINED")
    assert len(out) == 2


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_cpu(n, capsys):
    check_multichip(n, capsys)


def test_dryrun_gop_pipeline_cpu(capsys):
    dryrun.dryrun_gop_pipeline(4, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and out[0].startswith(
        "dryrun_gop_pipeline OK: 4 CHAINED")


@pytest.mark.parametrize("n", [1, 3, 6, 16])
def test_dryrun_multichip_other_slot_counts_raise(n):
    with pytest.raises(ValueError, match=r"2: \(1, 2\), 4: \(2, 2\), "
                                         r"8: \(2, 4\)"):
        dryrun.dryrun_multichip(n, device="cpu")


@pytest.mark.parametrize("G", [0, 5])
def test_dryrun_gop_pipeline_other_counts_raise(G):
    with pytest.raises(ValueError, match="4 chained"):
        dryrun.dryrun_gop_pipeline(G, device="cpu")


@pytest.mark.cuda
def test_cuda_dryruns_and_chained_1080p():
    """On the card: both dry runs, and the pipeline on the 1080p chained
    clip (17 stripes, 4 gop rows on one card) against its framemd5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dryrun.dryrun_multichip(8)
    dryrun.dryrun_gop_pipeline(4)
    pkts, want = dryrun.read_clip("chained_1080p")
    _planes, jobs = decode_chained_gop(pkts, make_mesh(4, 4))
    got = [hashlib.md5(j.cur_frame_obj.to_bytes()).hexdigest() for j in jobs]
    assert got == want[1:]
