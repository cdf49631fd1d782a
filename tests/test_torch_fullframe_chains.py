"""The port's full-frame sharded pass B (parallel/fullframe.py) on CPU
meshes against the port's serial decode, bit-exact (tolerance 0), on
chains of frames: 2 tile columns with chained inter frames (the sharded
outputs installed as the frames' planes, so later frames predict from
them; compound prediction, switchable filters), 4 tile columns, and a
(2, 2) step of frames of two geometries, one with a scaled reference.
The twins of tests/test_fullframe.py's test_sharded_tall_geometry,
test_sharded_4tile_wide, test_sharded_scaled_refs and
test_gop_mixed_geometry; test_torch_fullframe.py holds the rest (a
separate file, so that the two run on two test workers)."""
from functools import lru_cache

from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_fullframe import (PF, VP9Decoder, _assert_frames_equal,
                                  _gop_stream, _mesh, _mini, _run)


def test_sharded_vs_serial_2_tiles_chained():
    """A keyframe and two chained inter frames (the second predicting
    from the first's sharded output), 2 tile columns."""
    m = _mini()
    w, h = 512, 128
    k, f1, _f2 = _gop_stream()
    f1 = m.encode_inter_flex(w, h, seed=22, refresh_mask=0x02,
                             filter_level=22, coeffs=True, p_intra=0.15,
                             p_skip=0.7,
                             mv_mags=(0, 2, 4, 8, 16), tile_cols_log2=1)
    f2 = m.encode_inter_flex(w, h, seed=23, refidx=(1, 0, 0),
                             refresh_mask=0x04, filter_level=33,
                             coeffs=True, comppredmode=2, signbias=(0, 0, 1),
                             filtermode=4, mv_mags=(0, 2, 8, 64), p_skip=0.7,
                             tile_cols_log2=1)
    _run([k, f1, f2], 2)


def test_sharded_4_tiles():
    """4 tile columns (1024 x 64): three halo exchanges a step; a
    keyframe and an inter frame."""
    m = _mini()
    w, h = 1024, 64
    k = m.encode_keyframe_random(w, h, seed=25, filter_level=25,
                                 tile_cols_log2=2)
    f1 = m.encode_inter_flex(w, h, seed=26, refresh_mask=0x02,
                             filter_level=19, coeffs=True, p_intra=0.1,
                             p_skip=0.7,
                             mv_mags=(0, 2, 4, 16), tile_cols_log2=2)
    _run([k, f1], 4)


@lru_cache(maxsize=None)
def _scaled_stream():
    m = _mini()
    kf = m.encode_keyframe_random(512, 128, seed=10, filter_level=12)
    f1 = m.encode_inter_flex(1024, 128, seed=11, refresh_mask=0x00,
                             coeffs=True, p_intra=0.15, p_skip=0.7,
                             mv_mags=(0, 2, 8, 24), tile_cols_log2=1,
                             filter_level=18)
    f2 = m.encode_inter_flex(512, 128, seed=12, refresh_mask=0x00,
                             coeffs=True, p_intra=0.1, mv_mags=(0, 4, 16),
                             p_skip=0.7,
                             tile_cols_log2=1, filter_level=31)
    return kf, f1, f2


def test_gop_mixed_geometry_and_scaled_refs():
    """Mixed frame geometries on the gop axis: a 2x-upscale frame with a
    scaled reference (the scaled MC on the frame's columns, stacked into
    the stripes) and a frame of the keyframe's size in one (2, 2) step,
    each equal to the serial decode."""
    kf, f1, f2 = _scaled_stream()
    ser = VP9Decoder(device="cpu")
    truth = [f for d in (kf, f1, f2) for f in ser.decode(d)]
    shd = VP9Decoder(device="cpu")
    shd.decode(kf)
    j1, j2 = shd.decode_pass_a(f1), shd.decode_pass_a(f2)
    assert any(sc[0] != 0 for sc in j1.mvscale)
    outs = PF.sharded_decode_pass_b([j1, j2], _mesh(2, 2))
    _assert_frames_equal(truth[1], outs[0], "resize row")
    _assert_frames_equal(truth[2], outs[1], "same-size row")
