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


def row_split(addr, pw):
    """How csrc/digest.cu reads a row of pw int32 samples starting at
    byte address addr (a multiple of 4): (head, body, tail), the scalar
    samples before the first 16-byte aligned one (at most 3, at most
    pw), the int4 loads after them, and the scalar samples left."""
    head = min(((16 - addr % 16) % 16) // 4, pw)
    body = (pw - head) // 4
    return head, body, pw - head - 4 * body


def plane_digest_split(plane, ph, pw):
    """The digest of a torch plane on the CPU summed as the kernel reads
    it: each row's head, int4 body and tail (row_split of the row's own
    address) at their columns, the three parts' sums added mod 2^32."""
    a = plane.numpy()
    d1 = d2 = 0
    for y in range(ph):
        head, body, tail = row_split(plane[y].data_ptr(), pw)
        for x0, n in ((0, head), (head, 4 * body), (head + 4 * body, tail)):
            if not n:
                continue
            p = a[y, x0:x0 + n].astype(np.uint32)
            x = np.arange(x0, x0 + n, dtype=np.uint32)
            with np.errstate(over="ignore"):
                w = (np.uint32(y) * np.uint32(D._C1) + x * np.uint32(D._C2)
                     + np.uint32(D._C3))
                d1 += int(np.sum(p * w, dtype=np.uint32))
                d2 += int(np.sum(p * ((w ^ np.uint32(D._CX))
                                      * np.uint32(D._C4)), dtype=np.uint32))
    return d1 & D._M32, d2 & D._M32


# (plane shape, view: rows and columns sliced off the top left, crop):
# odd widths, widths under 4, and views whose rows start 4, 8 and 12
# bytes past a 16-byte boundary (and strides that move the start from row
# to row)
SPLITS = [((40, 64), (0, 0), (40, 64)), ((40, 64), (0, 1), (39, 63)),
          ((40, 64), (1, 2), (39, 61)), ((40, 64), (2, 3), (38, 61)),
          ((33, 67), (0, 0), (33, 67)), ((33, 67), (1, 1), (32, 5)),
          ((20, 9), (0, 1), (20, 3)), ((20, 9), (0, 0), (20, 0)),
          ((1088, 1920), (0, 0), (1080, 1917))]


@pytest.mark.parametrize("i", range(len(SPLITS)))
def test_row_split_covers_each_row_once(i):
    """row_split, the kernel's split of a row into a scalar head up to
    the first 16-byte aligned sample, an int4 body and a scalar tail: the
    parts cover the crop once, the body starts aligned; the digest summed
    over the split (plane_digest_split) equals the JAX package's
    plane_digest_host on odd widths and strided views, tolerance 0; so
    does the port's entry on the same view (the plain version here)."""
    shape, (dy, dx), (ph, pw) = SPLITS[i]
    p = torch.from_numpy(_plane(shape, None, 300 + i))
    view = p[dy:, dx:]
    for y in range(min(ph, 8)):
        addr = view[y].data_ptr()
        head, body, tail = row_split(addr, pw)
        assert head + 4 * body + tail == pw and 0 <= tail < 4
        assert head <= 3 and (not body or (addr + 4 * head) % 16 == 0)
    want = _jax_digest().plane_digest_host(
        np.ascontiguousarray(view.numpy()), ph, pw)
    assert plane_digest_split(view, ph, pw) == want
    assert D.plane_digest_dev(view, ph, pw) == want


def test_frame_digest_plain_matches_jax_per_plane():
    """frame_digest_dev_async on CPU planes (frame_digest_plain): a
    frame's three planes, 4:2:0 crops of a 1080p frame and odd crops, each
    row equal to the JAX package's plane_digest_host of its plane."""
    JD = _jax_digest()
    planes = [_plane((1088, 1920), None, 1), _plane((544, 960), None, 2),
              _plane((544, 960), (0, 4095), 3)]
    crops = [(1080, 1920), (540, 960), (539, 957)]
    got = D.frame_digest_dev_async([torch.from_numpy(p) for p in planes],
                                   crops)
    assert got.dtype == torch.int32 and got.shape == (3, 2)
    want = [JD.plane_digest_host(p, *c) for p, c in zip(planes, crops)]
    assert [tuple(int(v) for v in r) for r in got.numpy().view(np.uint32)] \
        == want
    with pytest.raises(ValueError):
        D.frame_digest_dev_async([torch.from_numpy(planes[0])] * 4,
                                 crops + crops[:1])


def test_cuda_planes_go_to_one_launch(monkeypatch):
    """On tensors off the CPU the per-plane and the frame entry each make
    one launch of csrc/digest.cu (recorded here) on the stream's scratch,
    counted in LAUNCHES; the plain versions never run."""
    from ffmpeg_hybrid_tpu_torch.ops import _cuda
    calls = []
    monkeypatch.setattr(_cuda, "launch",
                        lambda src, sig, name, *a: calls.append((src, name,
                                                                 a)))
    monkeypatch.setattr(D, "_scratch", lambda dev: torch.zeros(
        8, dtype=torch.int32, device=dev))
    monkeypatch.setattr(D, "plane_digest_plain", None)
    monkeypatch.setattr(D, "frame_digest_plain", None)
    monkeypatch.setattr(D, "_on", lambda _d: __import__(
        "contextlib").nullcontext())
    meta = torch.zeros((64, 72), dtype=torch.int32, device="meta")
    D.reset_launches()
    assert D.plane_digest_dev_async(meta[:, 1:], 60, 70).shape == (2,)
    assert D.frame_digest_dev_async([meta, meta[:32, :36]],
                                    [(64, 72), (32, 35)]).shape == (2, 2)
    assert D.LAUNCHES["digest"] == 2
    (s0, n0, a0), (s1, n1, a1) = calls
    assert (s0, n0, s1, n1) == ("digest.cu", "plane_digest", "digest.cu",
                                "frame_digest")
    assert a0[1:4] == (72, 60, 70) and a1[4] == 2


@pytest.mark.cuda
def test_frame_digest_kernel_matches_plain_on_the_card():
    """frame_digest_dev_async on the card (one launch of csrc/digest.cu
    for up to three planes) against frame_digest_plain on the split
    cases' views, strided and cropped, and on empty crops; one launch a
    call counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    D.reset_launches()
    n = 0
    for i, (shape, (dy, dx), (ph, pw)) in enumerate(SPLITS):
        p = torch.from_numpy(_plane(shape, None, 300 + i)).cuda()[dy:, dx:]
        planes = [p, p[:ph // 2], p[:, :pw // 2]]
        crops = [(ph, pw), (ph // 2, pw), (ph, pw // 2)]
        got = D.frame_digest_dev_async(planes, crops)
        assert torch.equal(got, D.frame_digest_plain(planes, crops)), i
        n += 1
    assert D.LAUNCHES["digest"] == n
