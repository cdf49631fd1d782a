"""VP9 boolean range decoder over S independent streams — the
counterpart of the JAX package's ops/rac_pallas.py.

VP9 tiles are independent entropy streams by spec (one range coder per
tile column, vp9.c:1342), and coefficient blocks can be re-decoded
independently from a snapshot of their tile's decoder, so S lanes decode
at once. Three functions, each with the Pallas kernel's signature and
[S, ...] layouts:

  decode_tree_multi    k tree symbols per stream (byte-fed decoder)
  decode_bits_multi    one bool per (stream, position) (byte-fed)
  decode_coeffs_multi  one transform block's coefficient walk per lane,
                       resumed from a host BoolDecoder snapshot
                       (halfword-fed decoder)

Each has a plain PyTorch version (`*_plain`): the lockstep form of the
Pallas kernel, predication masks and all, which runs on either device.
The public wrapper takes the plain version for tensors on the CPU and
launches the CUDA kernel (csrc/rac.cu) for tensors on the card; it
counts its kernel launches in LAUNCHES. The tree and bits kernels run a
lane a thread, a lane a block; stream_cycles reads each lane's cycles
from them.

The coefficient kernel walks every lane of a frame in one launch, from a
packed form of the frame (pack_lanes: a lane table, deduplicated scan and
probability tables, a token machine) that decode_coeffs_frame takes;
decode_coeffs_multi, the Pallas kernel's signature for one group of
lanes, packs its group on the card (group_lanes, no deduplication) and
launches the same kernel.

State per lane mirrors the spec decoder (codecs/vp9/rac.py): value <
2*range <= 510, range in [128, 255], MSB-first bit feed.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from . import _cuda
from ._cuda import check_tensor

# kernel launches per wrapper since the last reset_launches()
LAUNCHES = {"decode_tree_multi": 0, "decode_bits_multi": 0,
            "decode_coeffs_multi": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# host helpers (numpy)


def snapshot_to_state(snaps, windows_start):
    """Host: BoolDecoder snapshots -> halfword-decoder initial state.

    snaps: list of (data, byte_pos, bit_pos, value, range) per lane;
    windows_start[s] must equal byte_pos + (1 if bit_pos else 0) — the
    byte window each lane's halfword matrix was packed from. Returns
    (value, range, bitbuf, nbits) int32 [S] (pos starts at 0)."""
    S = len(snaps)
    value = np.zeros(S, np.int32)
    rng = np.zeros(S, np.int32)
    bitbuf = np.zeros(S, np.int32)
    nbits = np.zeros(S, np.int32)
    for s, (data, byte_pos, bit_pos, val, r) in enumerate(snaps):
        value[s] = val
        rng[s] = r
        if bit_pos:
            rem = 8 - bit_pos
            cur = data[byte_pos] if byte_pos < len(data) else 0
            bitbuf[s] = cur & ((1 << rem) - 1)
            nbits[s] = rem
        assert windows_start[s] == byte_pos + (1 if bit_pos else 0)
    return value, rng, bitbuf, nbits


def pack_windows(datas, starts, Lw=None):
    """Host: per-lane byte windows -> big-endian halfword matrix
    [S, Lw//2] int32 (zero-padded; beyond-end reads are the spec's
    zero-extension)."""
    S = len(datas)
    if Lw is None:
        Lw = max(len(d) - st for d, st in zip(datas, starts))
    Lw = (Lw + 1) & ~1
    buf = np.zeros((S, Lw), np.uint8)
    for s, (d, st) in enumerate(zip(datas, starts)):
        w = bytes(d[st:st + Lw])
        buf[s, :len(w)] = np.frombuffer(w, np.uint8)
    return ((buf[:, 0::2].astype(np.int32) << 8)
            | buf[:, 1::2].astype(np.int32))


def band_table(n):
    """band index in effect at each scan position (clamped to 5)."""
    tx = {16: 0, 64: 1, 256: 2, 1024: 3}[n]
    from ..codecs.vp9.blockdec import BAND_COUNTS
    counts = BAND_COUNTS[tx]
    out = np.zeros(n, np.int32)
    band, left = 0, counts[0]
    for i in range(n):
        out[i] = min(band, 5)
        left -= 1
        if not left and band < 5:
            band += 1
            left = counts[band]
    return out


# cat6 extra-bit probability ladders per bit depth (vp9block.c:876-899)
_CAT6_PROBS = {
    8: [254, 254, 254, 252, 249, 243, 230, 196, 177, 153, 140, 133,
        130, 129],
    10: [255, 255, 254, 254, 254, 252, 249, 243, 230, 196, 177, 153,
         140, 133, 130, 129],
    12: [255, 255, 255, 255, 254, 254, 254, 252, 249, 243, 230, 196,
         177, 153, 140, 133, 130, 129],
}


# ---------------------------------------------------------------------------
# plain PyTorch versions: S lanes in lockstep, divergence by masks


def _i32(t, device=None):
    return torch.as_tensor(t, device=device).to(torch.int32)


class _MultiRac:
    """Byte-fed decoder over S lockstep streams; `data` is [S, L]
    int32."""

    def __init__(self, data):
        self.data = data
        S = data.shape[0]
        z = torch.zeros(S, dtype=torch.int32, device=data.device)
        st = (z, torch.full_like(z, 255), z, z, z)
        ones = torch.ones(S, dtype=torch.bool, device=data.device)
        v = z
        for _ in range(8):      # init: read 8 bits (rac.py __init__)
            st, b = self._next_bit(st, ones)
            v = (v << 1) | b
        self.state = (v,) + st[1:]

    def _gather_byte(self, pos, need):
        L = self.data.shape[1]
        b = self.data.gather(1, pos.clamp(0, L - 1).long()[:, None])[:, 0]
        return torch.where(need & (pos < L), b, 0)

    def _next_bit(self, state, mask):
        value, rng, cache, cache_n, byte_pos = state
        need = mask & (cache_n == 0)
        b = self._gather_byte(byte_pos, need)
        cache = torch.where(need, b, cache)
        cache_n = torch.where(need, 8, cache_n)
        byte_pos = torch.where(need, byte_pos + 1, byte_pos)
        bit = torch.where(mask, (cache >> (cache_n - 1).clamp(min=0)) & 1,
                          0)
        cache_n = torch.where(mask, cache_n - 1, cache_n)
        return (value, rng, cache, cache_n, byte_pos), bit

    def get_prob(self, prob, mask):
        """vpx_rac_get_prob on masked lanes -> bit [S] int32."""
        value, rng, cache, cache_n, byte_pos = self.state
        split = 1 + (((rng - 1) * prob) >> 8)
        bit = (mask & (value >= split)).to(torch.int32)
        value = torch.where(mask & (bit == 1), value - split, value)
        rng = torch.where(mask, torch.where(bit == 1, rng - split, split),
                          rng)
        st = (value, rng, cache, cache_n, byte_pos)
        # range halves at most 7x (range >= 1, target >= 128)
        for _ in range(7):
            value, rng, cache, cache_n, byte_pos = st
            m = mask & (rng < 128)
            st2, b = self._next_bit(st, m)
            value, rng, cache, cache_n, byte_pos = st2
            value = torch.where(m, (value << 1) | b, value)
            rng = torch.where(m, rng << 1, rng)
            st = (value, rng, cache, cache_n, byte_pos)
        self.state = st
        return bit


def decode_tree_multi_plain(data_u8, probs_u8, tree, k, max_depth=12):
    data = _i32(data_u8)
    probs = _i32(probs_u8, data.device)
    tree = _i32(np.asarray(tree, np.int32), data.device)
    S = data.shape[0]
    rac = _MultiRac(data)
    out = torch.zeros((S, k), dtype=torch.int32, device=data.device)
    for i in range(k):
        node = torch.zeros(S, dtype=torch.long, device=data.device)
        done = torch.zeros(S, dtype=torch.bool, device=data.device)
        val = torch.zeros(S, dtype=torch.int32, device=data.device)
        for _ in range(max_depth):
            if bool(done.all()):  # nothing left to change
                break
            active = ~done
            p = probs.gather(1, node[:, None])[:, 0]
            bit = rac.get_prob(p, active)
            nxt = torch.where(bit == 1, tree[node, 1], tree[node, 0])
            leaf = active & (nxt <= 0)
            val = torch.where(leaf, -nxt, val)
            done = done | leaf
            node = torch.where(active & (nxt > 0), nxt.long(), node)
        out[:, i] = val
    return out


def decode_bits_multi_plain(data_u8, probs_seq_u8):
    data = _i32(data_u8)
    probs_seq = _i32(probs_seq_u8, data.device)
    S, K = probs_seq.shape
    rac = _MultiRac(data)
    ones = torch.ones(S, dtype=torch.bool, device=data.device)
    out = torch.zeros((S, K), dtype=torch.int32, device=data.device)
    for i in range(K):
        out[:, i] = rac.get_prob(probs_seq[:, i], ones)
    return out


class _MultiRac16:
    """Halfword-fed decoder over S lockstep lanes: a bit buffer refilled
    with one 16-bit fetch whenever it holds fewer than 8 bits, and a
    multi-bit renormalization. State: (value, range, bitbuf, nbits,
    pos)."""

    def __init__(self, half16, state):
        self.half16 = half16
        self.state = state

    def _fetch(self, pos, need):
        Lh = self.half16.shape[1]
        h = self.half16.gather(1, pos.clamp(0, Lh - 1).long()[:, None])
        # beyond-end fetches return 0: the spec's zero-extension
        return torch.where(need & (pos < Lh), h[:, 0], 0)

    def get_prob(self, prob, mask):
        value, rng, bitbuf, nbits, pos = self.state
        # refill so the bit buffer covers the worst renorm (7 bits)
        need = mask & (nbits < 8)
        hw = self._fetch(pos, need)
        bitbuf = torch.where(need, (bitbuf << 16) | hw, bitbuf)
        nbits = torch.where(need, nbits + 16, nbits)
        pos = torch.where(need, pos + 1, pos)
        # split compare
        split = 1 + (((rng - 1) * prob) >> 8)
        bit = (mask & (value >= split)).to(torch.int32)
        value = torch.where(mask & (bit == 1), value - split, value)
        rng = torch.where(mask, torch.where(bit == 1, rng - split, split),
                          rng)
        # multi-bit renorm: shift = 8 - bit_length(range)
        sh = ((rng < 128).to(torch.int32) + (rng < 64).to(torch.int32)
              + (rng < 32).to(torch.int32) + (rng < 16).to(torch.int32)
              + (rng < 8).to(torch.int32) + (rng < 4).to(torch.int32)
              + (rng < 2).to(torch.int32))
        sh = torch.where(mask, sh, 0)
        take = (bitbuf >> (nbits - sh)) & ((1 << sh) - 1)
        value = (value << sh) | take
        rng = rng << sh
        nbits = nbits - sh
        self.state = (value, rng, bitbuf, nbits, pos)
        return bit


def decode_coeffs_multi_plain(half16, value0, rng0, bitbuf0, nbits0,
                              probs, scan, nb0, nb1, nnz0, qmul, n, bpp,
                              is32):
    """The whole per-block coefficient walk, S lanes in lockstep (the
    Pallas _coef_kernel_body). Lanes that reached their EOB change
    nothing more, so the walk stops once every lane has."""
    dev = half16.device
    half16 = _i32(half16)
    S = half16.shape[0]
    z = torch.zeros(S, dtype=torch.int32, device=dev)
    rac = _MultiRac16(half16, (_i32(value0), _i32(rng0), _i32(bitbuf0),
                               _i32(nbits0), z))
    probs = _i32(probs).reshape(S, 36, 11)
    scan = scan.long()
    nb0 = nb0.long()
    nb1 = nb1.long()
    qmul = _i32(qmul)
    band_b = band_table(n)
    cat6 = _CAT6_PROBS[bpp]
    lanes = torch.arange(S, device=dev)
    cache = torch.zeros((S, n), dtype=torch.int32, device=dev)
    out = torch.zeros((S, n), dtype=torch.int32, device=dev)
    skip_eob = z
    ctx = _i32(nnz0)
    done = torch.zeros(S, dtype=torch.bool, device=dev)
    count = z

    def get(prob, mask):
        # a bool no lane reads changes nothing: skip its masked ops
        if not bool(mask.any()):
            return z
        return rac.get_prob(prob, mask)

    for i in range(n):
        if i % 16 == 0 and i and bool(done.all()):
            break
        alive = ~done
        sc = scan[:, i]
        tp = probs[lanes, int(band_b[i]) * 6 + ctx.long()]  # [S, 11]
        # 1. EOB bit (skipped right after a zero token)
        m_eob = alive & (skip_eob == 0)
        b = get(tp[:, 0], m_eob)
        hit = m_eob & (b == 0)
        done = done | hit
        alive = alive & ~hit
        # 2. zero bit
        zb = get(tp[:, 1], alive)
        is_zero = alive & (zb == 0)
        nonzero = alive & (zb == 1)
        # 3. token cascade
        b_one = get(tp[:, 2], nonzero)
        m_one = nonzero & (b_one == 0)
        m_big = nonzero & (b_one == 1)
        b3 = get(tp[:, 3], m_big)
        m_234 = m_big & (b3 == 0)
        b4 = get(tp[:, 4], m_234)
        m_2 = m_234 & (b4 == 0)
        m_34 = m_234 & (b4 == 1)
        b5 = get(tp[:, 5], m_34)
        m_cat = m_big & (b3 == 1)
        b6 = get(tp[:, 6], m_cat)
        m_c12 = m_cat & (b6 == 0)
        b7 = get(tp[:, 7], m_c12)
        m_c1 = m_c12 & (b7 == 0)
        e1 = get(159, m_c1)
        m_c2 = m_c12 & (b7 == 1)
        e2a = get(165, m_c2)
        e2b = get(145, m_c2)
        m_c36 = m_cat & (b6 == 1)
        b8 = get(tp[:, 8], m_c36)
        m_c34 = m_c36 & (b8 == 0)
        b9 = get(tp[:, 9], m_c34)
        m_c3 = m_c34 & (b9 == 0)
        c3a = get(173, m_c3)
        c3b = get(148, m_c3)
        c3c = get(140, m_c3)
        m_c4 = m_c34 & (b9 == 1)
        c4a = get(176, m_c4)
        c4b = get(155, m_c4)
        c4c = get(140, m_c4)
        c4d = get(135, m_c4)
        m_c56 = m_c36 & (b8 == 1)
        b10 = get(tp[:, 10], m_c56)
        m_c5 = m_c56 & (b10 == 0)
        c5a = get(180, m_c5)
        c5b = get(157, m_c5)
        c5c = get(141, m_c5)
        c5d = get(134, m_c5)
        c5e = get(130, m_c5)
        m_c6 = m_c56 & (b10 == 1)
        v6 = torch.full_like(z, 67)
        for k, p in enumerate(cat6):
            v6 = v6 + (get(p, m_c6) << (len(cat6) - 1 - k))
        # value per mask
        val = z
        val = torch.where(m_one, 1, val)
        val = torch.where(m_2, 2, val)
        val = torch.where(m_34, 3 + b5, val)
        val = torch.where(m_c1, 5 + e1, val)
        val = torch.where(m_c2, 7 + (e2a << 1) + e2b, val)
        val = torch.where(m_c3, 11 + (c3a << 2) + (c3b << 1) + c3c, val)
        val = torch.where(m_c4, 19 + (c4a << 3) + (c4b << 2)
                          + (c4c << 1) + c4d, val)
        val = torch.where(m_c5, 35 + (c5a << 4) + (c5b << 3) + (c5c << 2)
                          + (c5d << 1) + c5e, val)
        val = torch.where(m_c6, v6, val)
        # sign + dequant (C semantics: int32 wraparound product, 32x32
        # halved toward 0, int16 wrap at 8bpp)
        sgn = get(128, nonzero)
        sv = torch.where(sgn == 1, -val, val)
        q = qmul[:, 0] if i == 0 else qmul[:, 1]
        prod = sv * q
        if is32:
            prod = torch.where(prod < 0, -((-prod) >> 1), prod >> 1)
        if bpp == 8:
            prod = ((prod + 0x8000) & 0xFFFF) - 0x8000
        # energy class for the token cache
        energy = z
        energy = torch.where(m_one, 1, energy)
        energy = torch.where(m_2, 2, energy)
        energy = torch.where(m_34, 3, energy)
        energy = torch.where(m_c12, 4, energy)
        energy = torch.where(m_c36, 5, energy)
        proc = is_zero | nonzero
        cache[lanes, sc] = torch.where(proc, energy, cache[lanes, sc])
        out[lanes, sc] = torch.where(nonzero, prod, out[lanes, sc])
        # next-position context from the token cache via the nb table
        nv0 = cache[lanes, nb0[:, i]]
        nv1 = cache[lanes, nb1[:, i]]
        ctx = torch.where(proc, (1 + nv0 + nv1) >> 1, ctx)
        skip_eob = torch.where(alive, is_zero.to(torch.int32), skip_eob)
        count = torch.where(proc, i + 1, count)
    return out, count


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, CUDA kernel on the card

_c = ctypes
_SIGNATURES = {
    # data, S, L, probs, K, out, cycles, stream
    "rac_decode_bits": [_c.c_void_p, _c.c_int, _c.c_int, _c.c_void_p,
                        _c.c_int] + [_c.c_void_p] * 3,
    # data, S, L, probs, NN, tree, k, max_depth, capped, out, cycles,
    # stream
    "rac_decode_tree": [_c.c_void_p, _c.c_int, _c.c_int, _c.c_void_p,
                        _c.c_int, _c.c_void_p] + [_c.c_int] * 3 +
                       [_c.c_void_p] * 3,
    # lanes, blocks, nblocks, half16, tables, probs, machine, bpp, smem,
    # coef, eob, stream
    "rac_decode_coeffs_frame": [_c.c_void_p, _c.c_void_p, _c.c_int] +
                               [_c.c_void_p] * 4 + [_c.c_int, _c.c_int] +
                               [_c.c_void_p] * 3,
    # half, len, value, rng, bitbuf, nbits, p8, K, cycles, sink, stream
    "rac_bool_chain": [_c.c_void_p] + [_c.c_int] * 5 +
                      [_c.c_void_p, _c.c_int] + [_c.c_void_p] * 3,
}


# shared memory a block of the tree kernel may take: its lane's transition
# table, 32 bytes a node
TREE_SMEM = 227 * 1024


@lru_cache(maxsize=64)
def _tree_dev(tree_bytes, shape, device):
    """A tree table on `device`, copied there once per table."""
    host = np.frombuffer(tree_bytes, np.int32).reshape(shape)
    return torch.as_tensor(host.copy(), device=device)


@lru_cache(maxsize=64)
def tree_depth(tree_bytes, NN):
    """The most bools a symbol of the tree [NN, 2] (int32 bytes) takes
    from the root, or 0 if a cycle is reachable from it."""
    tree = np.frombuffer(tree_bytes, np.int32).reshape(NN, 2)
    state, depth = [0] * NN, [0] * NN      # 0 new, 1 open, 2 done
    stack = [(0, False)]
    while stack:
        n, post = stack.pop()
        if post:
            depth[n] = 1 + max(depth[e] if e > 0 else 0 for e in tree[n])
            state[n] = 2
            continue
        if state[n] == 2:
            continue
        if state[n] == 1:
            return 0
        state[n] = 1
        stack.append((n, True))
        for e in tree[n]:
            if e > 0 and state[e] == 1:
                return 0
            if e > 0 and state[e] == 0:
                stack.append((int(e), False))
    return depth[0]


def _launch_tree(data_u8, probs_u8, tree, k, max_depth, timed):
    """The tree kernel on CUDA tensors: (out [S, k] int32, cycles [S]
    int64 or None, launched)."""
    dev = data_u8.device
    S, L = data_u8.shape
    NN = probs_u8.shape[1]
    u8 = (torch.uint8,)
    data = check_tensor(data_u8, u8, (S, L), dev, "data_u8")
    probs = check_tensor(probs_u8, u8, (S, NN), dev, "probs_u8")
    tree_h = np.ascontiguousarray(tree, np.int32)
    key = tree_h.tobytes()
    if tree_h.shape != (NN, 2) or (tree_h >= NN).any():
        raise ValueError(f"the tree must be [{NN}, 2] with every node "
                         f"entry below {NN}")
    if 32 * NN > TREE_SMEM:
        raise ValueError(f"a {NN}-node tree takes {32 * NN} B of shared "
                         f"memory, more than a block has ({TREE_SMEM})")
    tree_d = _tree_dev(key, tree_h.shape, dev)
    out = torch.empty((S, k), dtype=torch.int32, device=dev)
    cycles = torch.zeros(S, dtype=torch.int64, device=dev) if timed else None
    if not (S and k):
        return out, cycles, False
    # the instance without the cap where no symbol can reach max_depth:
    # 81.9 cycles a bool against the capped one's 86.5 on an H100
    # (tools/rac_streams_ab_torch.py, variant cap, chip_smoke's lanes)
    depth = tree_depth(key, NN)
    capped = int(depth == 0 or depth > max_depth)
    _cuda.launch("rac.cu", _SIGNATURES, "rac_decode_tree", data, S, L,
                 probs, NN, tree_d, k, max_depth, capped, out, cycles)
    return out, cycles, True


def _launch_bits(data_u8, probs_seq_u8, timed):
    """The bits kernel on CUDA tensors: (out [S, K] int32, cycles [S]
    int64 or None, launched)."""
    dev = data_u8.device
    S, L = data_u8.shape
    K = probs_seq_u8.shape[1]
    u8 = (torch.uint8,)
    data = check_tensor(data_u8, u8, (S, L), dev, "data_u8")
    probs = check_tensor(probs_seq_u8, u8, (S, K), dev, "probs_seq_u8")
    out = torch.empty((S, K), dtype=torch.int32, device=dev)
    cycles = torch.zeros(S, dtype=torch.int64, device=dev) if timed else None
    if not (S and K):
        return out, cycles, False
    _cuda.launch("rac.cu", _SIGNATURES, "rac_decode_bits", data, S, L,
                 probs, K, out, cycles)
    return out, cycles, True


def decode_tree_multi(data_u8, probs_u8, tree, k, max_depth=12):
    """Decode k tree symbols from each of S independent streams.

    data_u8: [S, L] uint8 stream bytes. probs_u8: [S, NN] uint8 per-node
    probabilities. tree: [NN, 2] int32 (entry <= 0 encodes leaf -value,
    like codecs/vp9/tables trees; on the card every other entry must be
    a node below NN). Returns [S, k] int32 symbol values.
    """
    if data_u8.device.type == "cpu":
        return decode_tree_multi_plain(data_u8, probs_u8, tree, k,
                                       max_depth)
    out, _cycles, launched = _launch_tree(data_u8, probs_u8, tree, k,
                                          max_depth, False)
    LAUNCHES["decode_tree_multi"] += launched
    return out


def decode_bits_multi(data_u8, probs_seq_u8):
    """Decode one bit per (stream, position) with the given probability
    sequence [S, K] (128 = literal bits). Returns [S, K] int32 bits."""
    if data_u8.device.type == "cpu":
        return decode_bits_multi_plain(data_u8, probs_seq_u8)
    out, _cycles, launched = _launch_bits(data_u8, probs_seq_u8, False)
    LAUNCHES["decode_bits_multi"] += launched
    return out


def stream_cycles(name, data_u8, probs_u8, tree=None, k=None,
                  max_depth=12):
    """The kernel of decode_tree_multi or decode_bits_multi (`name`) on
    CUDA tensors, in its instance that reads the clock: (out, each lane's
    clock64 cycles [S] int64 from its first bool to its last store).
    tree, k and max_depth are the tree's. A measurement, not a path: it
    counts no launch."""
    if name == "decode_tree_multi":
        out, cycles, _ = _launch_tree(data_u8, probs_u8, tree, k, max_depth,
                                      True)
    else:
        out, cycles, _ = _launch_bits(data_u8, probs_u8, True)
    return out, cycles


# ---------------------------------------------------------------------------
# the coefficient walk of a frame in one launch: its packed form

# the token machine of csrc/rac.cu's coefficient walk: states 0-10 the
# nodes of a probability row, _SIGN the sign, then one state per extra
# bit of cat1-cat6; a transition word holds an action, the next state,
# a leaf's base value and energy, and whether the bit shifts into the
# extra bits
_SIGN, _STATES = 11, 64
_CONT, _EOB, _ZERO, _COEF = 0, 1, 2, 3
_LEAF, _SHIFT = 1 << 8, 1 << 9
# cat1-cat5: (base value, extra-bit probabilities); cat6 from _CAT6_PROBS
_CATS = ((5, (159,)), (7, (165, 145)), (11, (173, 148, 140)),
         (19, (176, 155, 140, 135)), (35, (180, 157, 141, 134, 130)))


def _tw(act=_CONT, nxt=0, leaf=None, shift=False):
    w = act | nxt << 2 | (_SHIFT if shift else 0)
    if leaf:
        w |= _LEAF | leaf[0] << 16 | leaf[1] << 24
    return w


@lru_cache(maxsize=None)
def coef_machine(bpp):
    """The token machine for `bpp` as csrc/rac.cu reads it: int32
    [3 * 64], the two transition words of each state (bit 0, bit 1),
    then each state's constant probability (the sign's and the extra
    bits'; 0 for the nodes, whose probability is the lane's row)."""
    trans = np.zeros((_STATES, 2), np.int64)
    cprob = np.zeros(_STATES, np.int64)
    cprob[_SIGN] = 128
    first, st = [], _SIGN + 1
    for _base, ps in _CATS + ((67, tuple(_CAT6_PROBS[bpp])),):
        first.append(st)
        for j, pr in enumerate(ps):
            cprob[st + j] = pr
            nxt = st + j + 1 if j + 1 < len(ps) else _SIGN
            trans[st + j] = _tw(nxt=nxt, shift=True)
        st += len(ps)
    assert st <= _STATES
    c1, c2, c3, c4, c5, c6 = first
    trans[0] = (_tw(_EOB), _tw(nxt=1))                         # EOB
    trans[1] = (_tw(_ZERO, 1), _tw(nxt=2))                     # zero
    trans[2] = (_tw(nxt=_SIGN, leaf=(1, 1)), _tw(nxt=3))       # one
    trans[3] = (_tw(nxt=4), _tw(nxt=6))
    trans[4] = (_tw(nxt=_SIGN, leaf=(2, 2)), _tw(nxt=5, leaf=(3, 3)))
    trans[5] = _tw(nxt=_SIGN, shift=True)                      # 3 or 4
    trans[6] = (_tw(nxt=7), _tw(nxt=8))
    trans[7] = (_tw(nxt=c1, leaf=(5, 4)), _tw(nxt=c2, leaf=(7, 4)))
    trans[8] = (_tw(nxt=9), _tw(nxt=10))
    trans[9] = (_tw(nxt=c3, leaf=(11, 5)), _tw(nxt=c4, leaf=(19, 5)))
    trans[10] = (_tw(nxt=c5, leaf=(35, 5)), _tw(nxt=c6, leaf=(67, 5)))
    trans[_SIGN] = _tw(_COEF, 0)
    return np.concatenate([trans.reshape(-1), cprob]).astype(np.int32)


@lru_cache(maxsize=None)
def _machine_on(bpp, device):
    return torch.as_tensor(coef_machine(bpp), device=device)


# the lane table's columns and the block table's, as csrc/rac.cu reads
# them; the probability row of a lane, in bytes
LANE_COLS, BLOCK_COLS = 16, 10
(HALF_OFF, HALF_LEN, OUT_OFF, TX, TAB_OFF, PROB_OFF, NNZ, QDC, QAC, VALUE,
 RNG, BITBUF, NBITS, CACHE_OFF, IS32) = range(15)
(LANE0, NLANES, TAB_LO, TAB_HI, PROB_LO, PROB_HI, OUT_LO, OUT_HI,
 CACHE_BYTES) = range(9)
PROB_ROW = 36 * 11
# shared bytes of the token machine in a block; the SMs of an H100, over
# which pack_lanes spreads the lanes by default
MACHINE_BYTES = _STATES * 9
H100_SMS = 132
# blocks (one warp each) pack_lanes aims to put on each SM: fewer lanes a
# warp wait less on each other's tokens (measured: tools/coef_ab_torch.py)
BLOCKS_PER_SM = 4


def _r16(v):
    return (v + 15) & ~15


def _lanes_per_block(S, sms):
    """Lanes a block (one warp, so at most 32): as few as spread S lanes
    over BLOCKS_PER_SM blocks on each of `sms` SMs."""
    return max(1, min(32, -(-S // (sms * BLOCKS_PER_SM)))) if S else 1


@dataclass
class CoefLanes:
    """A frame's coefficient lanes in the form csrc/rac.cu's walk reads
    (pack_lanes): lanes [S, LANE_COLS] and blocks [B, BLOCK_COLS] int32,
    half the lanes' halfword windows end to end (int32), tables the
    distinct scan/neighbour tables (int32 words scan | nb0 << 10 | nb1
    << 20), probs the distinct probability rows (uint8, PROB_ROW each);
    smem: the largest block's shared bytes; groups: (n, lanes, output
    offset, first lane, is32, halfwords a lane) per group; nout: the
    outputs' length."""
    lanes: object
    blocks: object
    half: object
    tables: object
    probs: object
    smem: int
    groups: tuple
    nout: int

    def to(self, device):
        """The same lanes with every array a tensor on `device`."""
        arrs = [torch.as_tensor(a, device=device) for a in
                (self.lanes, self.blocks, self.half, self.tables,
                 self.probs)]
        return CoefLanes(*arrs, self.smem, self.groups, self.nout)


def pack_lanes(parts, sms=H100_SMS):
    """Pack groups of lanes into one CoefLanes (numpy). parts: per group
    decode_coeffs_multi's arguments as numpy arrays, then n and is32:
    (half16 [S, Lh], value0, rng0, bitbuf0, nbits0 [S], probs [S, 36,
    11], scan, nb0, nb1 [S, n], nnz0 [S], qmul [S, 2], n, is32). The
    lanes keep their order, group after group, and so do their outputs;
    each group's lanes share its distinct scan/neighbour tables, and all
    lanes the frame's distinct probability rows. Blocks take
    ceil(S / (sms * BLOCKS_PER_SM)) lanes each (at most 32, a warp), so
    that they cover the card's SMs; each lists the ranges of tables, probability rows
    and outputs its lanes use, and its lanes' energy caches (n bytes a
    lane)."""
    S = sum(len(p[0]) for p in parts)
    lanes = np.zeros((S, LANE_COLS), np.int64)
    halves, tables, groups = [], [], []
    lane = out = half_off = tab_off = 0
    probs_all = []
    for half16, v0, r0, bb0, nb0_, probs, scan, nb0, nb1, nnz0, qmul, n, \
            is32 in parts:
        Sg, Lh = half16.shape
        if n not in (16, 64, 256, 1024):
            raise ValueError(f"unsupported block n={n}")
        words = [np.asarray(a, np.int64).reshape(Sg, n)
                 for a in (scan, nb0, nb1)]
        if any(((a < 0) | (a >= n)).any() for a in words):
            raise ValueError("a scan or neighbour entry outside the block")
        key = words[0] | words[1] << 10 | words[2] << 20
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        tables.append(uniq.reshape(-1))
        rows = lanes[lane:lane + Sg]
        rows[:, HALF_OFF] = half_off + Lh * np.arange(Sg)
        rows[:, HALF_LEN] = Lh
        rows[:, OUT_OFF] = out + n * np.arange(Sg)
        rows[:, TX] = {16: 0, 64: 1, 256: 2, 1024: 3}[n]
        rows[:, TAB_OFF] = tab_off + n * np.asarray(inv).reshape(-1)
        rows[:, NNZ] = nnz0
        rows[:, QDC], rows[:, QAC] = np.asarray(qmul).reshape(Sg, 2).T
        rows[:, VALUE], rows[:, RNG] = v0, r0
        rows[:, BITBUF], rows[:, NBITS] = bb0, nb0_
        rows[:, IS32] = int(bool(is32))
        halves.append(np.asarray(half16, np.int32).reshape(-1))
        probs_all.append(np.asarray(probs, np.int64).reshape(Sg, PROB_ROW))
        groups.append((n, Sg, out, lane, bool(is32), Lh))
        lane += Sg
        out += Sg * n
        half_off += Sg * Lh
        tab_off += uniq.size
    probs_all = np.concatenate(probs_all) if probs_all else \
        np.zeros((0, PROB_ROW), np.int64)
    if ((probs_all < 0) | (probs_all > 255)).any():
        raise ValueError("a probability outside 0-255")
    puniq, pinv = np.unique(probs_all, axis=0, return_inverse=True)
    lanes[:, PROB_OFF] = PROB_ROW * np.asarray(pinv).reshape(-1)
    n_of = 16 << (2 * lanes[:, TX])
    lpb = _lanes_per_block(S, sms)
    blocks = np.zeros((-(-S // lpb), BLOCK_COLS), np.int64)
    smem = MACHINE_BYTES
    for b, l0 in enumerate(range(0, S, lpb)):
        l1 = min(S, l0 + lpb)
        r, nn = lanes[l0:l1], n_of[l0:l1]
        r[:, CACHE_OFF] = np.cumsum(nn) - nn
        blk = blocks[b]
        blk[LANE0], blk[NLANES] = l0, l1 - l0
        blk[TAB_LO], blk[TAB_HI] = r[:, TAB_OFF].min(), \
            (r[:, TAB_OFF] + nn).max()
        blk[PROB_LO], blk[PROB_HI] = r[:, PROB_OFF].min(), \
            r[:, PROB_OFF].max() + PROB_ROW
        blk[OUT_LO], blk[OUT_HI] = r[0, OUT_OFF], r[-1, OUT_OFF] + nn[-1]
        blk[CACHE_BYTES] = nn.sum()
        smem = max(smem, MACHINE_BYTES + _r16(4 * (blk[TAB_HI] - blk[TAB_LO]))
                   + _r16(blk[PROB_HI] - blk[PROB_LO]) + blk[CACHE_BYTES])
    tab = np.concatenate(tables) if tables else np.zeros(0, np.int64)
    return CoefLanes(
        lanes.astype(np.int32), blocks.astype(np.int32),
        np.concatenate(halves) if halves else np.zeros(0, np.int32),
        tab.astype(np.int32), puniq.astype(np.uint8).reshape(-1), int(smem),
        tuple(groups), out)


def group_lanes(half16, value0, rng0, bitbuf0, nbits0, probs, scan, nb0,
                nb1, nnz0, qmul, n, is32, sms=H100_SMS):
    """One group of lanes (decode_coeffs_multi's arguments, int32 tensors)
    as a CoefLanes on their own device, with no wait on the device and
    no copy from it. Unlike pack_lanes nothing is deduplicated: each
    lane keeps its own scan/neighbour table and probability row, at
    offsets in lane order, and blocks take lanes as pack_lanes deals
    them. What the shapes fix (offsets, sizes, the block table) is built
    on the host and uploaded from pinned memory in one copy; the lanes'
    own columns (nnz, dequant, state) are stacked into the table on the
    device. Entries are not checked (that would wait on the device):
    scan and neighbour entries are taken modulo n, which keeps the walk
    inside its lane's tables, and probabilities modulo 256."""
    dev = half16.device
    S, Lh = half16.shape
    lpb = _lanes_per_block(S, sms)
    lane = np.arange(S)
    lanes = np.zeros((S, LANE_COLS), np.int64)
    lanes[:, HALF_OFF] = lane * Lh
    lanes[:, HALF_LEN] = Lh
    lanes[:, OUT_OFF] = lanes[:, TAB_OFF] = lane * n
    lanes[:, TX] = {16: 0, 64: 1, 256: 2, 1024: 3}[n]
    lanes[:, PROB_OFF] = lane * PROB_ROW
    lanes[:, CACHE_OFF] = lane % lpb * n
    lanes[:, IS32] = int(bool(is32))
    l0 = np.arange(0, S, lpb)
    nl = np.minimum(S - l0, lpb)
    blocks = np.zeros((len(l0), BLOCK_COLS), np.int64)
    blocks[:, LANE0], blocks[:, NLANES] = l0, nl
    blocks[:, TAB_LO] = blocks[:, OUT_LO] = l0 * n
    blocks[:, TAB_HI] = blocks[:, OUT_HI] = (l0 + nl) * n
    blocks[:, PROB_LO], blocks[:, PROB_HI] = l0 * PROB_ROW, (l0 + nl) * PROB_ROW
    blocks[:, CACHE_BYTES] = nl * n
    host = torch.empty(lanes.size + blocks.size, dtype=torch.int32,
                       pin_memory=dev.type == "cuda")
    host.numpy()[:] = np.concatenate([lanes.reshape(-1), blocks.reshape(-1)])
    table = host.to(dev, non_blocking=True)
    lanes_d = table[:S * LANE_COLS].view(S, LANE_COLS)
    # NNZ-NBITS are adjacent columns, in this order
    lanes_d[:, NNZ:NBITS + 1] = torch.stack(
        (nnz0, qmul[:, 0], qmul[:, 1], value0, rng0, bitbuf0, nbits0), 1)
    t = torch.stack((scan, nb0, nb1)) & (n - 1)
    tables = t[0] | t[1] << 10 | t[2] << 20
    smem = MACHINE_BYTES + _r16(4 * lpb * n) + _r16(lpb * PROB_ROW) + lpb * n
    return CoefLanes(lanes_d, table[S * LANE_COLS:].view(-1, BLOCK_COLS),
                     half16.reshape(-1), tables.reshape(-1),
                     probs.reshape(-1).to(torch.uint8), smem,
                     ((n, S, 0, 0, bool(is32), Lh),), S * n)


def split_groups(fr, coef, eob):
    """The flat outputs of a CoefLanes' walk as [(coef [S, n], eob [S])]
    per group, views."""
    return [(coef[o:o + Sg * n].view(Sg, n), eob[l:l + Sg])
            for n, Sg, o, l, _is32, _lh in fr.groups]


def group_args(fr):
    """decode_coeffs_multi's arguments of each group of a CoefLanes,
    unpacked from its lane table, tables and probability rows (int32
    tensors on its device)."""
    dev = fr.lanes.device
    L = fr.lanes.long()
    probs = fr.probs.long()
    out = []
    for n, Sg, _o, l0, _is32, Lh in fr.groups:
        r = L[l0:l0 + Sg]
        w = fr.tables[r[:, TAB_OFF, None] + torch.arange(n, device=dev)]
        args = (fr.half[r[:, HALF_OFF, None] + torch.arange(Lh, device=dev)],
                r[:, VALUE], r[:, RNG], r[:, BITBUF], r[:, NBITS],
                probs[r[:, PROB_OFF, None]
                      + torch.arange(PROB_ROW, device=dev)]
                .reshape(Sg, 36, 11),
                w & 1023, (w >> 10) & 1023, (w >> 20) & 1023, r[:, NNZ],
                r[:, [QDC, QAC]])
        out.append(tuple(a.to(torch.int32).contiguous() for a in args))
    return out


def decode_coeffs_frame_plain(fr, bpp):
    """The plain version of the frame's walk on the same packed inputs:
    each group's lanes unpacked (group_args), then
    decode_coeffs_multi_plain per group. Returns (coef [nout], eob [S])
    int32."""
    dev = fr.lanes.device
    coef = torch.zeros(fr.nout, dtype=torch.int32, device=dev)
    eob = torch.zeros(fr.lanes.shape[0], dtype=torch.int32, device=dev)
    for (n, Sg, o, l0, is32, _lh), args in zip(fr.groups, group_args(fr)):
        c, e = decode_coeffs_multi_plain(*args, n, bpp, is32)
        coef[o:o + Sg * n] = c.reshape(-1)
        eob[l0:l0 + Sg] = e
    return coef, eob


def decode_coeffs_frame(fr, bpp):
    """Every lane of a packed frame (a CoefLanes of tensors) -> (coef
    [nout] int32, each lane's n outputs in raster order at its output
    offset, eob [S] int32); split_groups cuts them per group. CPU
    tensors take decode_coeffs_frame_plain; any other device the kernel
    (csrc/rac.cu), one launch for every lane, which takes CUDA tensors
    only."""
    if fr.lanes.device.type == "cpu":
        return decode_coeffs_frame_plain(fr, bpp)
    if bpp not in (8, 10, 12):
        raise ValueError(f"unsupported bpp={bpp}")
    dev = fr.lanes.device
    S, B = fr.lanes.shape[0], fr.blocks.shape[0]
    i32 = (torch.int32,)
    args = [check_tensor(fr.lanes, i32, (S, LANE_COLS), dev, "lanes"),
            check_tensor(fr.blocks, i32, (B, BLOCK_COLS), dev, "blocks"),
            check_tensor(fr.half, i32, fr.half.shape[:1], dev, "half"),
            check_tensor(fr.tables, i32, fr.tables.shape[:1], dev, "tables"),
            check_tensor(fr.probs, (torch.uint8,), fr.probs.shape[:1], dev,
                         "probs")]
    if args[4].data_ptr() % 4:
        raise ValueError("probs must be 4-byte aligned")
    coef = torch.empty(fr.nout, dtype=torch.int32, device=dev)
    eob = torch.empty(S, dtype=torch.int32, device=dev)
    if B:
        _cuda.launch("rac.cu", _SIGNATURES, "rac_decode_coeffs_frame",
                     args[0], args[1], B, *args[2:],
                     _machine_on(bpp, dev), bpp, fr.smem, coef, eob)
        LAUNCHES["decode_coeffs_multi"] += 1
    return coef, eob


def decode_coeffs_multi(half16, value0, rng0, bitbuf0, nbits0, probs,
                        scan, nb0, nb1, nnz0, qmul, n, bpp, is32):
    """Decode one transform block's coefficients per lane.

    half16: [S, Lh] int32 halfword windows (pack_windows). value0/rng0/
    bitbuf0/nbits0: [S] resumable bool state (snapshot_to_state).
    probs: [S, 36, 11] int32 — probs11[band][ctx] rows flattened to
    band*6+ctx. scan/nb0/nb1: [S, n] int32 per-lane scan order and
    neighbor tables. nnz0: [S] initial nnz context. qmul: [S, 2] (dc,
    ac) dequant. Returns (coef [S, n] int32 in raster order within the
    block, eob [S] int32). CPU tensors take the plain version; on the
    card the group is packed on the card (group_lanes) and walked by the
    frame kernel, one launch."""
    if half16.device.type == "cpu":
        return decode_coeffs_multi_plain(half16, value0, rng0, bitbuf0,
                                         nbits0, probs, scan, nb0, nb1,
                                         nnz0, qmul, n, bpp, is32)
    if n not in (16, 64, 256, 1024) or bpp not in (8, 10, 12):
        raise ValueError(f"unsupported block n={n} or bpp={bpp}")
    dev = half16.device
    S, Lh = half16.shape
    i32 = torch.int32
    args = [check_tensor(half16, (i32,), (S, Lh), dev, "half16")]
    for name, t in (("value0", value0), ("rng0", rng0),
                    ("bitbuf0", bitbuf0), ("nbits0", nbits0)):
        args.append(check_tensor(t, (i32,), (S,), dev, name))
    args.append(check_tensor(probs, (i32,), (S, 36, 11), dev, "probs"))
    for name, t in (("scan", scan), ("nb0", nb0), ("nb1", nb1)):
        args.append(check_tensor(t, (i32,), (S, n), dev, name))
    args.append(check_tensor(nnz0, (i32,), (S,), dev, "nnz0"))
    args.append(check_tensor(qmul, (i32,), (S, 2), dev, "qmul"))
    if not S:
        return (torch.empty((0, n), dtype=i32, device=dev),
                torch.empty((0,), dtype=i32, device=dev))
    coef, eob = decode_coeffs_frame(group_lanes(*args, n, is32), bpp)
    return coef.view(S, n), eob


def bool_chain_cycles(half, value, rng, bitbuf, nbits, p8, K):
    """Cycles of K bools (a multiple of 8) of one lane's chain on the
    card (csrc/rac.cu bool_chain_kernel): its halfwords half (a CUDA
    int32 tensor, staged in shared memory) from the state (value, rng,
    bitbuf, nbits), under the 8 probabilities p8 (a CUDA int32 [8]) held
    in registers, one thread, timed with clock64. A measurement, not a
    path: it counts no launch. Synchronises."""
    dev = half.device
    half = check_tensor(half, (torch.int32,), half.shape[:1], dev, "half")
    p8 = check_tensor(p8, (torch.int32,), (8,), dev, "p8")
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    _cuda.launch("rac.cu", _SIGNATURES, "rac_bool_chain", half,
                 half.shape[0], int(value), int(rng), int(bitbuf),
                 int(nbits), p8, int(K), cycles, sink)
    return int(cycles.item())
