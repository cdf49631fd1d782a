"""Pass-A snapshots of the JAX package's decoder carried across to the
port with ffmpeg_hybrid_tpu_torch/state.py: each reconstructs there
identically to the JAX package's tpu backend, plain and loop-filtered
(test_torch_decoder.py's chains), exact."""
import numpy as np
import pytest
from test_torch_threads import one_torch_thread  # noqa: F401

from test_torch_decoder import (_chain, _filtered_chain, _planes_jax,
                                _planes_torch)


def test_state_carries_one_snapshot_across():
    """One pass-A snapshot of the JAX decoder, with its reference
    planes, reconstructs identically in both packages."""
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder as JDec
    from ffmpeg_hybrid_tpu_torch import state
    from ffmpeg_hybrid_tpu_torch.ops import recon

    pkts = _chain(128, 64, 2, seed=20)
    jd = JDec(recon_backend="tpu")
    for pkt in pkts:
        job = jd.precompute_job(jd.decode_pass_a(pkt))
        snap = state.snapshot(job)
        jd.decode_pass_b(job)
        pj = state.frame_job(snap, device="cpu")
        recon.recon_frame(pj)
        for a, b in zip(_planes_jax(job.cur_frame_obj),
                        _planes_torch(pj.cur_frame_obj)):
            assert np.array_equal(a, b)
    assert len(snap["ref_frames"]) >= 1


@pytest.mark.parametrize("lf_impl", ["dense", "scan"])
def test_state_carries_a_filtered_frame_across(lf_impl):
    """Snapshots of loop-filtered frames (limit tables and the
    loop-filter part of the host precompute included) reconstruct
    identically in both packages, whichever loop-filter route the JAX
    package took for them."""
    import dataclasses
    from ffmpeg_hybrid_tpu.codecs.vp9.decoder import VP9Decoder as JDec
    from ffmpeg_hybrid_tpu.utils.config import get_config, set_config
    from ffmpeg_hybrid_tpu_torch import state
    from ffmpeg_hybrid_tpu_torch.ops import recon

    pkts = _filtered_chain(128, 64, 1, seed=9)
    cfg = get_config()
    set_config(dataclasses.replace(cfg, lf_impl=lf_impl))
    try:
        jd = JDec(recon_backend="tpu")
        for pkt in pkts:
            job = jd.precompute_job(jd.decode_pass_a(pkt))
            snap = state.snapshot(job)
            jd.decode_pass_b(job)
            assert snap["lim_lut"].any() and snap["mblim_lut"].any()
            assert (snap["pre"]["lf_bufs"] is not None) == \
                (lf_impl == "dense")
            pj = state.frame_job(snap, device="cpu")
            recon.recon_frame(pj)
            for a, b in zip(_planes_jax(job.cur_frame_obj),
                            _planes_torch(pj.cur_frame_obj)):
                assert np.array_equal(a, b)
    finally:
        set_config(cfg)
