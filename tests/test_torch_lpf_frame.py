"""The loop filter's frame entry on the CPU (ops/lpf_dense.py lf_frame_,
its plain version) against the JAX package's lf_dense, exact, on the
keyframes of test_torch_lpf.py's GRID_CASES whose Y or U+V shapes no
test there compiles (128x64, 4:4:4, 4:4:0): each compiles the JAX
lf_dense for its shapes, most of this file's time. test_torch_lpf.py
holds the other cases and the rest of the loop filter's tests."""
import pytest
from test_torch_threads import one_torch_thread  # noqa: F401

from test_torch_lpf import GRID_CASES, LF_FRAME_ALONE, lf_frame_case


@pytest.mark.parametrize(
    "case", [c for c in GRID_CASES if c["seed"] in LF_FRAME_ALONE],
    ids=lambda c: f"s{c['seed']}")
def test_lf_frame_plain_filters_in_place_like_jax(case):
    lf_frame_case(case)
