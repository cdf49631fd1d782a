"""The port's plane digest (ffmpeg_hybrid_tpu_torch/utils/digest.py)
against the JAX package's: its plain version (torch int64 masked to 32
bits) equals the JAX _make_digest (on the CPU) and the numpy
plane_digest_host on seeded int32 planes, with tolerance 0; the async
pairs come back in their order. On a card (`cuda`): the kernel
(csrc/digest.cu) against the plain version. The JAX package is imported
inside the tests that compare with it, so that the `cuda` test runs
where JAX is not installed."""
import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu_torch.utils import digest as D


def _jax_digest():
    from ffmpeg_hybrid_tpu.utils import digest as JD
    return JD


# (plane shape, crop, values): the pixel extremes of 8/10/12 bits, a
# crop smaller than the plane on both axes, odd crops, a 1080p luma
# plane as the decoder pads it, and the int32 extremes
CASES = [
    ((64, 64), (64, 64), (0,)),
    ((64, 64), (64, 64), (255,)),
    ((96, 128), (90, 120), (1023,)),
    ((96, 128), (96, 128), (4095,)),
    ((70, 70), (66, 66), (0, 255, 1023, 4095)),
    ((128, 192), (101, 177), None),
    ((33, 65), (33, 65), None),
    ((1088, 1920), (1080, 1920), None),
    ((40, 72), (39, 71), (-(1 << 31), (1 << 31) - 1, -1)),
]


def _plane(shape, values, seed):
    rng = np.random.RandomState(seed)
    if values is None:
        return rng.randint(0, 1 << 12, size=shape).astype(np.int32)
    return rng.choice(np.array(values, np.int64), size=shape).astype(
        np.int32)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_plain_digest_matches_jax_and_host(i):
    import jax.numpy as jnp
    JD = _jax_digest()
    shape, (ph, pw), values = CASES[i]
    p = _plane(shape, values, 100 + i)
    want = JD.plane_digest_dev(jnp.asarray(p), ph, pw)
    assert JD.plane_digest_host(p, ph, pw) == want
    assert D.plane_digest_host(p, ph, pw) == want
    got = D.plane_digest_plain(torch.from_numpy(p), ph, pw)
    assert got.dtype == torch.int32 and got.shape == (2,)
    assert tuple(int(v) for v in got.numpy().view(np.uint32)) == want
    # the CPU entry point takes the plain version
    assert D.plane_digest_dev(torch.from_numpy(p), ph, pw) == want


def test_plain_digest_on_a_strided_view():
    """A cropped view (rows strided) digests as its contiguous copy."""
    p = _plane((80, 100), None, 7)
    view = torch.from_numpy(p)[5:70, 3:90]
    assert not view.is_contiguous()
    want = _jax_digest().plane_digest_host(
        np.ascontiguousarray(p[5:70, 3:90]), 60, 81)
    assert D.plane_digest_dev(view, 60, 81) == want


def test_digest_detects_change_inside_the_crop_only():
    p = torch.from_numpy(_plane((64, 64), (0, 255), 8))
    base = D.plane_digest_dev(p, 60, 60)
    for y, x in [(0, 0), (31, 17), (59, 59)]:
        q = p.clone()
        q[y, x] ^= 1
        assert D.plane_digest_dev(q, 60, 60) != base
    q = p.clone()
    q[63, 63] ^= 255
    assert D.plane_digest_dev(q, 60, 60) == base


def test_digests_to_host_keeps_the_order():
    planes = [_plane((20 + k, 30 + k), None, 50 + k) for k in range(6)]
    pairs = [D.plane_digest_dev_async(torch.from_numpy(p), 20, 30)
             for p in planes]
    got = D.digests_to_host(pairs)
    assert got.dtype == np.uint32 and got.shape == (6, 2)
    want = [_jax_digest().plane_digest_host(p, 20, 30) for p in planes]
    assert [tuple(int(v) for v in row) for row in got] == want
    assert D.digests_to_host([]).shape == (0, 2)


def test_bad_crop_raises():
    with pytest.raises(ValueError):
        D.plane_digest_dev_async(torch.zeros(4, 4, dtype=torch.int32), 5, 4)


@pytest.mark.cuda
def test_digest_kernel_matches_plain_on_the_card():
    """csrc/digest.cu against plane_digest_plain on the card, on every
    case and on strided crops, one launch a plane counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    D.reset_launches()
    n = 0
    for i, (shape, (ph, pw), values) in enumerate(CASES):
        p = torch.from_numpy(_plane(shape, values, 100 + i)).cuda()
        for plane, (h, w) in ((p, (ph, pw)), (p[1:, 2:], (ph - 1, pw - 2))):
            got = D.plane_digest_dev_async(plane, h, w)
            want = D.plane_digest_plain(plane, h, w)
            assert torch.equal(got, want), (shape, h, w)
            assert D.plane_digest_dev(plane, h, w) == D.plane_digest_host(
                plane.cpu().numpy(), h, w)
            n += 2
    assert D.LAUNCHES["digest"] == n
