"""Transfer-free plane equality digests.

To hold a decoded plane on the card to a plane on the host without
moving either, both sides compute the same pair of 32-bit weighted sums
over the cropped plane, and only two words cross. The weights are a
closed-form function of the pixel coordinates, so no weight tensor is
made on either side:

    W(y, x)  = y * 0x9E3779B1 + x * 0x85EBCA77 + 0xC2B2AE3D   (mod 2^32)
    d1       = sum(P * W)                                      (mod 2^32)
    d2       = sum(P * (W ^ 0xA5A5A5A5) * 0x27D4EB2F)          (mod 2^32)

For any difference between two planes, both sums collide with a
probability of about 2^-64 over the pseudo-random weights.

- plane_digest_host: numpy, on a host plane.
- plane_digest_dev / plane_digest_dev_async: a torch plane. On the card
  the kernel runs (csrc/digest.cu, one launch a plane and no memset,
  counted in LAUNCHES); a plane on the CPU takes plane_digest_plain, torch
  int64 arithmetic masked to 32 bits. There is no fallback from the one
  to the other.
- frame_digest_dev_async: up to three planes in one launch of the same
  kernel (frame_digest_plain on the CPU).
- digests_to_host: one stacked copy of many async pairs.
"""
import contextlib
import ctypes

import numpy as np
import torch

_C1 = 0x9E3779B1
_C2 = 0x85EBCA77
_C3 = 0xC2B2AE3D
_CX = 0xA5A5A5A5
_C4 = 0x27D4EB2F
_M32 = 0xFFFFFFFF

# kernel launches of plane_digest_dev(_async) since the last
# reset_launches()
LAUNCHES = {"digest": 0}

_P = ctypes.c_void_p
_SIGNATURES = {
    # plane, stride, ph, pw, scratch, out, stream
    "plane_digest": [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P,
                     _P, _P],
    # planes, strides, ph, pw (host arrays), np, scratch, out, stream
    "frame_digest": [_P, _P, _P, _P, ctypes.c_int, _P, _P, _P],
    # np
    "digest_scratch_words": [ctypes.c_int],
}
# planes one frame_digest launch takes
MAX_PLANES = 3


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def plane_digest_host(plane, ph, pw):
    """(d1, d2) uint32 digest of plane[:ph, :pw] in numpy."""
    p = np.asarray(plane)[:ph, :pw].astype(np.uint32)
    y = np.arange(ph, dtype=np.uint32)[:, None]
    x = np.arange(pw, dtype=np.uint32)[None, :]
    with np.errstate(over="ignore"):
        w = y * np.uint32(_C1) + x * np.uint32(_C2) + np.uint32(_C3)
        d1 = np.sum(p * w, dtype=np.uint32)
        d2 = np.sum(p * ((w ^ np.uint32(_CX)) * np.uint32(_C4)),
                    dtype=np.uint32)
    return int(d1), int(d2)


def _as_int32_words(d):
    """int64 values in [0, 2^32) as the int32 tensor of their bits."""
    return torch.where(d >= 1 << 31, d - (1 << 32), d).to(torch.int32)


def plane_digest_plain(plane, ph, pw):
    """The plain version: (d1, d2) of plane[:ph, :pw] as an int32 [2]
    tensor of the uint32 words' bits, on the plane's device. torch int64
    arithmetic masked to 32 bits after each product and at the end
    (int64 wraps mod 2^64, a multiple of 2^32)."""
    dev = plane.device
    p = plane[:ph, :pw].to(torch.int64) & _M32
    y = torch.arange(ph, dtype=torch.int64, device=dev)[:, None]
    x = torch.arange(pw, dtype=torch.int64, device=dev)[None, :]
    w = (y * _C1 + x * _C2 + _C3) & _M32
    w2 = ((w ^ _CX) * _C4) & _M32
    d1 = ((p * w) & _M32).sum() & _M32
    d2 = ((p * w2) & _M32).sum() & _M32
    return _as_int32_words(torch.stack([d1, d2]))


def _check(plane, ph, pw):
    if plane.dim() != 2 or not (0 <= ph <= plane.shape[0]
                                and 0 <= pw <= plane.shape[1]):
        raise ValueError(f"crop {ph}x{pw} of a plane of shape "
                         f"{tuple(plane.shape)}")


# scratch words a launch needs, by device
_WORDS = {}


def _on(dev):
    """A context that makes dev the current device (none if it is)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _scratch(dev):
    """The kernel's partials and ticket for dev's current stream."""
    from .. import _build
    from ..ops import _cuda
    n = _WORDS.get(dev)
    if n is None:
        with _on(dev):
            n = _build.load("digest.cu", _SIGNATURES).digest_scratch_words(
                MAX_PLANES)
        if n < 0:
            raise RuntimeError("digest_scratch_words: no CUDA device")
        _WORDS[dev] = n
    return _cuda.stream_state("digest", dev, n).buf


def plane_digest_dev_async(plane, ph, pw):
    """(d1, d2) of plane[:ph, :pw] as an int32 [2] tensor of the uint32
    words' bits, on the plane's device, without a sync. plane: a 2-D
    torch tensor (int32 on the card; rows may be strided); a plane on
    the CPU takes plane_digest_plain."""
    _check(plane, ph, pw)
    if plane.device.type == "cpu":
        return plane_digest_plain(plane, ph, pw)
    if plane.dtype != torch.int32:
        raise TypeError(f"plane is {plane.dtype}, the kernel takes int32")
    if plane.stride(1) != 1:
        plane = plane.contiguous()
    from ..ops import _cuda
    out = torch.empty(2, dtype=torch.int32, device=plane.device)
    with _on(plane.device):
        _cuda.launch("digest.cu", _SIGNATURES, "plane_digest", plane,
                     plane.stride(0), ph, pw, _scratch(plane.device), out)
    LAUNCHES["digest"] += 1
    return out


def frame_digest_plain(planes, crops):
    """The plain version of frame_digest_dev_async: int32 [n, 2]."""
    return torch.stack([plane_digest_plain(p, ph, pw)
                        for p, (ph, pw) in zip(planes, crops)])


def frame_digest_dev_async(planes, crops):
    """(d1, d2) of each planes[j][:ph, :pw] (crops[j] = (ph, pw); one to
    three planes, on one device) as an int32 [n, 2] tensor, without a
    sync: one launch of csrc/digest.cu on the card, counted in LAUNCHES;
    planes on the CPU take frame_digest_plain."""
    if not 1 <= len(planes) <= MAX_PLANES or len(crops) != len(planes):
        raise ValueError(f"{len(planes)} planes and {len(crops)} crops: "
                         f"one launch takes 1-{MAX_PLANES}")
    for p, (ph, pw) in zip(planes, crops):
        _check(p, ph, pw)
    dev = planes[0].device
    if dev.type == "cpu":
        return frame_digest_plain(planes, crops)
    if any(p.device != dev or p.dtype != torch.int32 for p in planes):
        raise TypeError("the kernel takes int32 planes on one device")
    planes = [p if p.stride(1) == 1 else p.contiguous() for p in planes]
    from ..ops import _cuda
    n = len(planes)
    strides = (ctypes.c_longlong * n)(*(p.stride(0) for p in planes))
    ph = (ctypes.c_int * n)(*(int(c[0]) for c in crops))
    pw = (ctypes.c_int * n)(*(int(c[1]) for c in crops))
    out = torch.empty((n, 2), dtype=torch.int32, device=dev)
    with _on(dev):
        _cuda.launch("digest.cu", _SIGNATURES, "frame_digest", list(planes),
                     ctypes.addressof(strides), ctypes.addressof(ph),
                     ctypes.addressof(pw), n, _scratch(dev), out)
    LAUNCHES["digest"] += 1
    return out


def plane_digest_dev(plane, ph, pw):
    """(d1, d2) of a torch plane; only the two words come back."""
    d1, d2 = digests_to_host([plane_digest_dev_async(plane, ph, pw)])[0]
    return int(d1), int(d2)


def digests_to_host(pairs):
    """[n, 2] uint32 of the async pairs, in their order, in one copy."""
    if not pairs:
        return np.zeros((0, 2), np.uint32)
    return torch.stack(list(pairs)).cpu().numpy().view(np.uint32)
