"""The port's coefficient bool decoder (ops/rac.py decode_coeffs_multi
and the one-launch walk's model) against the JAX package's Pallas kernel
(ops/rac_pallas.py decode_coeffs_multi, interpret mode on the CPU) at 8
and 10 bits, exact. Both tests read one Pallas result per bpp (the
keyframe_blocks fixture of test_torch_rac.py, which holds the 12-bit
walk and the other bool-decoder tests): the Pallas kernel's compile, a
few seconds per transform size and bpp, is most of their cost."""
import numpy as np
import pytest
from test_torch_threads import one_torch_thread  # noqa: F401

from test_torch_rac import _pallas_lanes, walk_model_case
# the module-scoped fixture: this module gets its own instance
from test_torch_rac import keyframe_blocks  # noqa: F401


@pytest.mark.parametrize("bpp", [8, 10])
def test_decode_coeffs_multi_matches_host_and_pallas(bpp, keyframe_blocks):
    """Blocks captured from a real keyframe by the port's pure-Python
    pass A, at every tx size: the port's plain decode equals the host
    result on every block, and the Pallas kernel on a few lanes of each
    size."""
    from ffmpeg_hybrid_tpu_torch.ops import coef_path as CP

    groups, pallas = keyframe_blocks(bpp)
    assert set(groups) == {0, 1, 2, 3}
    out = CP.decode_blocks(groups, CP.frame_inputs(groups, "cpu"), bpp)
    for tx, group in groups.items():
        coef, eob = (t.numpy() for t in out[tx])
        for s, g in enumerate(group):
            assert eob[s] == g["eob"], (tx, s)
            assert np.array_equal(coef[s], g["coef"]), (tx, s)
        lanes = _pallas_lanes(tx)
        want_c, want_e = pallas[tx]
        assert np.array_equal(coef[:lanes], want_c), tx
        assert np.array_equal(eob[:lanes], want_e), tx


@pytest.mark.parametrize("bpp", [8, 10])
def test_walk_model_matches_host_and_pallas(bpp, keyframe_blocks):
    walk_model_case(bpp, keyframe_blocks)
