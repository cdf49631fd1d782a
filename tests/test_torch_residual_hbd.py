"""The 10/12-bit residual kernel of the port (csrc/itxfm.cu
residual_planes_hbd), its design held on the CPU with tolerance 0.

- The float64 word: an interval evaluator runs the port's 1-D
  butterflies (ffmpeg_hybrid_tpu_torch/ops/itxfm.py, written over an
  array module) on intervals, derives for each kernel and pass the bits
  of the largest magnitude any intermediate or output reaches on int32
  inputs, and holds the kernel's kPeakBits table to it: every value stays
  below 2^51, where a double holds every integer exactly.
- A numpy model of the kernel's threads: a 1-D transform a lane, a 32x32
  column on a lane pair (idct16 of the even rows, idct32's odd half of
  the odd rows, joined in 32 bits), on the kernel's word (float64, _rs
  and the shifts exact floors). It is held to the JAX package's itxfm_2d
  (numpy int64) at 10 and 12 bpp on seeded blocks of every size and type,
  with coefficients at the powers of two, one past them and at the int32
  extremes; and on a 64x64 10-bit plane to the JAX package's
  residual_plane (ops/recon_tpu.py, its int32-pair path) and the port's
  plain version.
- On a card (`cuda`): the kernel against its plain version, in one
  consuming launch of three planes at the int32 extremes."""
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu.ops import itxfm as JI
from ffmpeg_hybrid_tpu.ops import recon_tpu as J
from ffmpeg_hybrid_tpu_torch.ops import itxfm as PI
from ffmpeg_hybrid_tpu_torch.ops import recon as P
from ffmpeg_hybrid_tpu_torch.ops import recon_cuda as RC

SRC = os.path.join(os.path.dirname(P.__file__), "..", "csrc", "itxfm.cu")
# kPeakBits' columns: (name, 1-D kernel, inputs)
KERNELS = (("idct4", PI.idct4_1d, 4), ("iadst4", PI.iadst4_1d, 4),
           ("idct8", PI.idct8_1d, 8), ("iadst8", PI.iadst8_1d, 8),
           ("idct16", PI.idct16_1d, 16), ("iadst16", PI.iadst16_1d, 16),
           ("idct32", PI.idct32_1d, 32), ("iwht4", PI.iwht4_1d, 4))
INT32_MAX = (1 << 31) - 1


def _src_table(name):
    src = open(SRC).read()
    body = src[src.index(name):]
    body = body[body.index("{") + 1:body.index("};")]
    return [int(v) for v in body.replace("{", " ").replace("}", " ")
            .replace(",", " ").split()]


# ---------------------------------------------------------------------------
# the peaks, by interval arithmetic


class _Iv:
    """An integer interval; every value made records its magnitude."""
    peak = 0

    def __init__(self, lo, hi):
        self.lo, self.hi = lo, hi
        _Iv.peak = max(_Iv.peak, -lo, hi)

    @staticmethod
    def _of(o):
        return o if isinstance(o, _Iv) else _Iv(o, o)

    def __add__(self, o):
        o = _Iv._of(o)
        return _Iv(self.lo + o.lo, self.hi + o.hi)

    __radd__ = __add__

    def __sub__(self, o):
        o = _Iv._of(o)
        return _Iv(self.lo - o.hi, self.hi - o.lo)

    def __rsub__(self, o):
        return _Iv._of(o) - self

    def __neg__(self):
        return _Iv(-self.hi, -self.lo)

    def __mul__(self, o):
        o = _Iv._of(o)
        p = (self.lo * o.lo, self.lo * o.hi, self.hi * o.lo, self.hi * o.hi)
        return _Iv(min(p), max(p))

    __rmul__ = __mul__

    def __rshift__(self, k):
        return _Iv(self.lo >> k, self.hi >> k)


class _Vec:
    """A vector of intervals as the 1-D kernels index it (X[..., k])."""

    def __init__(self, xs):
        self.xs = xs

    def __getitem__(self, key):
        return self.xs[key[1]]


class _IvXP:
    @staticmethod
    def stack(xs, axis):
        return xs


def _peak(fn, n, m, *args):
    """The largest magnitude of any intermediate or output of fn on inputs
    in [-m, m]."""
    _Iv.peak = 0
    fn(_IvXP, _Vec([_Iv(-m, m) for _ in range(n)]), *args)
    return _Iv.peak


@pytest.mark.parametrize("pass_", [0, 1])
@pytest.mark.parametrize("k", range(len(KERNELS)))
def test_peak_bits_match_the_interval_derivation(k, pass_):
    """kPeakBits[pass][kernel] is the bit length of the largest magnitude
    of any intermediate or output on int32 inputs (iwht4's first pass
    shifts its inputs right by 2 first), and below 51."""
    name, fn, n = KERNELS[k]
    args = (pass_,) if name == "iwht4" else ()
    peak = _peak(fn, n, 1 << 31, *args)
    table = np.asarray(_src_table("kPeakBits[2][kKernels] = {")).reshape(2, 8)
    assert table[pass_, k] == peak.bit_length() <= 50


@pytest.mark.parametrize("k", range(len(KERNELS)))
def test_interval_evaluator_bounds_the_values(k):
    """The evaluator bounds what the butterflies compute: on inputs at the
    ends of the int32 range (seeded sign patterns, and all of either
    end), no output exceeds its peak."""
    name, fn, n = KERNELS[k]
    args = (0,) if name == "iwht4" else ()
    rng = np.random.RandomState(k)
    x = rng.choice([-(1 << 31), (1 << 31) - 1], (64, n)).astype(np.int64)
    x[0], x[1] = -(1 << 31), (1 << 31) - 1
    assert np.abs(fn(np, x, *args)).max() <= _peak(fn, n, 1 << 31, *args)


# ---------------------------------------------------------------------------
# a numpy model of the kernel's threads


class _F64(np.ndarray):
    """float64 values as the kernel's f64 word holds them: the butterflies'
    _rs and shifts (>>) are exact floors."""

    def __rshift__(self, k):
        return np.floor(np.asarray(self) * (1.0 / (1 << k))).view(_F64)


def _lo32(v):
    """The low 32 bits of integer values (int, or float that holds one)."""
    v = np.asarray(v)
    if v.dtype.kind == "f":
        assert np.all(np.abs(v) < 2.0 ** 51) and np.all(v == np.floor(v))
        v = v.astype(np.int64)
    return v.astype(np.int64).astype(np.uint32).view(np.int32)


def _rs(v):
    return (v + (1 << 13)) >> 14


def _stack(v):
    if isinstance(v[0], _F64):
        return np.stack([np.asarray(a) for a in v], -1).view(_F64)
    return np.stack(v, -1)


def _fn1d(tx, kind, *args):
    """A 1-D kernel of ops/itxfm.py on a list of input vectors, returning
    its list of output vectors (tx 4: the WHT)."""
    f = PI.iwht4_1d if tx == 4 else PI._1D[(tx, kind)]
    return lambda v: list(np.moveaxis(np.asarray(f(np, _stack(v), *args)),
                                      -1, 0))


def _run(fn, x):
    """fn over lines x ([lines, n] int32) on the kernel's word (Word,
    float64) -> the low 32 bits of its outputs, [lines, outputs] int32."""
    assert "using Word = f64;" in open(SRC).read()
    v = x.astype(np.float64).view(_F64)
    return np.stack([_lo32(o) for o in fn([v[:, k] for k in
                                           range(x.shape[1])])], 1)


def _pass1(x, tx, adst, pass_):
    """One 1-D pass of a block of size 4 << tx (tx 4: the WHT) in the
    kernel's layout: x [lines, sz] int32, the inputs of each line (a
    column of the coefficients, then of the first pass's output) -> the
    low 32 bits of each line's outputs, [lines, sz] int32. At 32x32 a lane
    pair takes a line: idct16 of the even rows, and idct32's odd half of
    the odd rows (idct32 of the odd rows alone: its even half is zero),
    joined in 32 bits, E + D and E - D."""
    if tx == 4:
        return _run(_fn1d(4, None, pass_), x)
    if tx < 3:
        return _run(_fn1d(tx, "adst" if adst else "dct"), x)
    e = _run(lambda v: _fn1d(2, "dct")(v[0::2]), x).view(np.uint32)
    d = _run(lambda v: _fn1d(3, "dct")(
        [a * 0 if k % 2 == 0 else a for k, a in enumerate(v)])[:16],
        x).view(np.uint32)
    with np.errstate(over="ignore"):
        return np.concatenate([e + d, (e - d)[:, ::-1]], 1).view(np.int32)


def _model_2d(blk, tx, typ):
    """The kernel's two passes of one block (blk [sz, sz] int32, tx 4 the
    WHT) -> its int32 outputs before the final rounding."""
    adst_a = tx < 3 and typ in (1, 3)
    adst_b = tx < 3 and typ in (2, 3)
    tmp = _pass1(blk.T.copy(), tx, adst_a, 0)     # row c: column c
    return _pass1(tmp.T.copy(), tx, adst_b, 1).T


def _round32(v, tx):
    """The kernel's round_out: (int)(v + (1U << (s - 1))) >> s."""
    s = 0 if tx == 4 else JI.FINAL_SHIFT[tx]
    if not s:
        return v.astype(np.int64)
    return _lo32(v.astype(np.int64) + (1 << (s - 1))).astype(np.int64) >> s


def _values(rng, shape, kind):
    """Seeded int32 coefficients: "powers" at + or - a power of two or one
    past it (every magnitude from 1 to 2^30) and zeros, "extremes" over the
    int32 range with a third at its ends."""
    if kind == "powers":
        v = 1 << np.arange(31, dtype=np.int64)
        v = np.concatenate([v, v + 1, -v, -v - 1, [0]])
        return rng.choice(v, shape).astype(np.int32)
    x = rng.randint(-1 << 31, 1 << 31, shape, dtype=np.int64)
    pick = rng.rand(*shape)
    x[pick < 1 / 6] = -1 << 31
    x[(pick >= 1 / 6) & (pick < 1 / 3)] = INT32_MAX
    return x.astype(np.int32)


@pytest.mark.parametrize("bpp", [10, 12])
@pytest.mark.parametrize("tx", [0, 1, 2, 3, 4])
def test_model_matches_jax_itxfm(tx, bpp):
    """Every type of the size (the WHT as tx 4): the model's outputs
    before the final rounding equal the JAX package's itxfm_2d on numpy
    int64."""
    rng = np.random.RandomState(100 * tx + bpp)
    sz = 4 if tx == 4 else 4 << tx
    for typ in ((0,) if tx >= 3 else range(4)):
        for kind in ("powers", "extremes"):
            for blk in _values(rng, (6, sz, sz), kind):
                want = JI.itxfm_2d(np, blk.astype(np.int64), tx, typ, bpp)
                got = _model_2d(blk, tx, typ)
                assert np.array_equal(got.astype(np.int64), want), \
                    (typ, kind)


def _plane(rng, H, W, kind):
    """A seeded H x W plane in the kernel's form: a size a 32x32 region,
    every type, eobs 0, 1 (the DC shortcut), 2 and full at the roots,
    coefficients of _values' kind."""
    r4, c4 = H // 4, W // 4
    tx = np.repeat(np.repeat(rng.randint(0, 4, (H // 32, W // 32)), 8, 0), 8,
                   1)
    k = 1 << tx
    yy, xx = np.mgrid[:r4, :c4]
    root = (yy % k == 0) & (xx % k == 0)
    ty = rng.randint(0, 4, (r4, c4))
    full = (4 << tx) ** 2
    eob = np.where(root, np.choose(rng.randint(0, 4, (r4, c4)),
                                   [0 * full, 0 * full + 1, 0 * full + 2,
                                    full]), 0)
    return (_values(rng, (H, W), kind), eob.astype(np.int32),
            tx.astype(np.int8), ty.astype(np.int8))


def _model_plane(coef, eob, tx, ty):
    """The kernel on a plane: each root with eob > 0, the DC shortcut on
    64-bit words where eob == 1 and the type is DCT_DCT or the size
    32x32, else _model_2d; 32-bit final rounding, summed."""
    out = np.zeros(coef.shape, np.int64)
    r4, c4 = eob.shape
    for t in range(4):
        k, sz = 1 << t, 4 << t
        for y, x in zip(*np.nonzero((tx == t) & (eob > 0))):
            if y % k or x % k or y + k > r4 or x + k > c4:
                continue
            blk = coef[4 * y:4 * y + sz, 4 * x:4 * x + sz]
            if eob[y, x] == 1 and (ty[y, x] == 0 or t == 3):
                r = _round32(np.full((sz, sz), _lo32(_rs(_rs(
                    int(blk[0, 0]) * 11585) * 11585))), t)
            else:
                r = _round32(_model_2d(blk, t, int(ty[y, x])), t)
            out[4 * y:4 * y + sz, 4 * x:4 * x + sz] += r
    return out


def test_model_plane_matches_jax_residual_plane():
    """A 64x64 10-bit plane: the model equals the JAX package's
    residual_plane (its int32-pair path) and the port's plain version."""
    rng = np.random.RandomState(7)
    coef, eob, tx, ty = _plane(rng, 64, 64, "powers")
    got = _model_plane(coef, eob, tx, ty)
    want = np.asarray(J.residual_plane(*(jnp.asarray(a) for a in
                                         (coef, eob, tx, ty)), False, 10))
    assert np.array_equal(got, want.astype(np.int64)) and want.any()
    plain = P.residual_plane_plain(*(torch.from_numpy(a) for a in
                                     (coef, eob, tx, ty)), False, 10)
    assert np.array_equal(plain.numpy().astype(np.int64), got)


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["powers", "extremes"])
@pytest.mark.parametrize("bpp", [10, 12])
def test_kernel_matches_plain_on_the_card(bpp, kind):
    """Three planes in one consuming launch: the kernel equals its plain
    version bit for bit, and the buffers read zero after it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.RandomState(bpp)
    planes = []
    for H, W in ((128, 192), (64, 96), (64, 96)):
        coef, eob, tx, ty = _plane(rng, H, W, kind)
        keep = np.zeros(coef.shape, bool)       # only what pass A ships
        for y, x in zip(*np.nonzero(eob)):
            sz = 4 << int(tx[y, x])
            dc = eob[y, x] == 1 and (ty[y, x] == 0 or tx[y, x] == 3)
            keep[4 * y:4 * y + (1 if dc else sz),
                 4 * x:4 * x + (1 if dc else sz)] = True
        planes.append((np.where(keep, coef, 0).astype(np.int32), eob, tx, ty))
    nc = sum(c.size for c, *_r in planes)
    ne = sum(e.size for _c, e, *_r in planes)
    bufs = P.coef_buffers({}, "cuda", "merged", nc, ne, True)
    bc = be = 0
    views = []
    for coef, eob, tx, ty in planes:
        bufs.flat_c[bc:bc + coef.size] = torch.from_numpy(coef.reshape(-1))
        bufs.flat_e[be:be + eob.size] = torch.from_numpy(
            eob.reshape(-1).astype(np.int16))
        views.append(P._slice_plane(bufs.flat_c[None], bufs.flat_e[None], bc,
                                    be, *coef.shape, *eob.shape)
                     + (torch.from_numpy(tx).cuda(),
                        torch.from_numpy(ty).cuda()))
        bc += coef.size
        be += eob.size
    RC.reset_launches()
    got = P.residual_planes(views, False, bpp, consume=[bufs] * 3)
    assert RC.LAUNCHES["residual_hbd"] == 1
    for (coef, eob, tx, ty), g in zip(planes, got):
        want = P.residual_plane_plain(*(torch.from_numpy(a) for a in
                                        (coef, eob, tx, ty)), False, bpp)
        assert torch.equal(want, g.cpu())
    assert bufs.read_zero() and bufs.fill_cause() is None
