"""Launchers of pass B's residual and intra kernels (csrc/itxfm.cu,
csrc/intra.cu): their ctypes signatures, the launch counters and the
host side of the intra kernel's tables. The wrappers that choose between
a kernel and its plain version are ops/recon.py's residual_plane and
_intra_scan; they call these only with tensors off the CPU, and these
raise for anything but CUDA tensors.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import _cuda
from . import intra_tables as it

# kernel launches since the last reset_launches()
LAUNCHES = {"residual": 0, "intra": 0}

# the block sizes the intra weight table holds, in its order
INTRA_SIZES = (4, 8, 16, 32)

_c = ctypes
_P, _I = _c.c_void_p, _c.c_int
_SIGNATURES = {
    # coef, coef16, eob, eob bytes, txsz, txsz bytes, txtype, txtype
    # bytes, out, H, W, lossless, stream
    "itxfm.cu": {"residual_plane": [_P, _I, _P, _I, _P, _I, _P, _I, _P, _I,
                                    _I, _I, _P]},
    # plane, residual, slab, weights, edges, H, W, L, bpp, nsec, meta,
    # slab rows, windows (out), stream
    "intra.cu": {"intra_scan": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                                _c.c_longlong, _P, _P]},
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def residual(coef, eob4, txsz4, txtype4, out, lossless):
    """csrc/itxfm.cu on checked, contiguous tensors: coef [H, W] int16 or
    int32, grids [H/4, W/4] int8/int16/int32, out [H, W] int32."""
    H, W = coef.shape
    _cuda.launch("itxfm.cu", _SIGNATURES["itxfm.cu"], "residual_plane",
                 coef, int(coef.dtype == torch.int16), eob4,
                 eob4.element_size(), txsz4, txsz4.element_size(), txtype4,
                 txtype4.element_size(), out, H, W, int(lossless))
    LAUNCHES["residual"] += 1


def weight_offsets():
    """{sz: offset of that size's [15, ne, sz*sz] block in
    weight_table()}."""
    offs, o = {}, 0
    for sz in INTRA_SIZES:
        offs[sz] = o
        o += 15 * it.edge_len(sz) * sz * sz
    return offs


def weight_table():
    """Every size's predictor weights (ops/intra_tables.build_all), int32,
    concatenated in INTRA_SIZES order."""
    return np.concatenate([it.build_all(sz).reshape(-1)
                           for sz in INTRA_SIZES]).astype(np.int32)


@lru_cache(maxsize=None)
def _weights_on(device):
    return torch.as_tensor(weight_table(), device=device)


def intra_meta(sizes, caps, L):
    """The slab layout as csrc/intra.cu reads it: rows of one level, then
    per section sz, cap, first slab row, edge length and weight
    offset."""
    woff = weight_offsets()
    meta = [sum(caps)]
    base = 0
    for sz, cap in zip(sizes, caps):
        meta += [sz, cap, base, it.edge_len(sz), woff[sz]]
        base += L * cap
    return np.asarray(meta, np.int32)


def intra(plane, residual_, slab, L, sizes, caps, bpp, edges):
    """csrc/intra.cu on checked, contiguous tensors: the wavefront of
    one plane, in place on `plane` [H, W] int32, with the [15, 4] int32
    EDGES table `edges`. Returns the windows the kernel took each level
    in (the rows of a level whose edge vectors fit its shared memory at
    once)."""
    H, W = plane.shape
    meta = intra_meta(sizes, caps, L)
    windows = _c.c_int(0)
    _cuda.launch("intra.cu", _SIGNATURES["intra.cu"], "intra_scan", plane,
                 residual_, slab, _weights_on(plane.device), edges, H, W, L,
                 bpp, len(sizes), meta.ctypes.data, slab.shape[0],
                 _c.addressof(windows))
    LAUNCHES["intra"] += 1
    return windows.value


def spread_slab(slab, caps_to, Hp, Wp, seed=0):
    """The intra slab `slab` = (buf, L, sizes, caps) of an Hp x Wp plane
    re-packed with the wider caps `caps_to`, each level's blocks moved to
    slots drawn at random among its new ones (the order of a level's
    blocks does not matter, since they are independent). With enough
    rows per level, one level spans several of the intra kernel's
    windows; this checks that path on any slab."""
    buf, L, sizes, caps = slab
    rng = np.random.RandomState(seed)
    out = np.zeros((L * sum(caps_to), 8), np.int16)
    out[:] = (Hp + 64, Wp + 64, 2, 0, 0, 0, 1, 1)     # inert rows
    src = dst = 0
    for cap, cap_to in zip(caps, caps_to):
        if cap_to < cap:
            raise ValueError(f"cap {cap_to} < {cap}")
        for lvl in range(L):
            rows = buf[src + lvl * cap:src + (lvl + 1) * cap]
            rows = rows[rows[:, 0] < Hp]
            slots = rng.choice(cap_to, len(rows), replace=False)
            out[dst + lvl * cap_to + slots] = rows
        src += L * cap
        dst += L * cap_to
    return out, L, sizes, tuple(caps_to)
