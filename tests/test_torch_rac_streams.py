"""The tree and bits kernels of the port's bool decoder (csrc/rac.cu
decode_tree_kernel and decode_bits_kernel; wrappers decode_tree_multi
and decode_bits_multi in ffmpeg_hybrid_tpu_torch/ops/rac.py) on the
edges of their semantics.

A model of the kernels' step in numpy and Python integers (_Row,
_Window, _stage_tree, _tree_lane and _bits_lane below: the aligned-word
feed of a row that may start at any byte, the 64-bit lookahead filled a
word at a time every 4 bools, the int32 value, the one-shift
renormalization, the lane's staged transition table and the tree walk
one bool a step with its depth counter, the bits in chunks of 16) is
held, with the wrappers' plain versions, to the spec BoolDecoder and to
the JAX package's Pallas kernels in interpret mode, with tolerance 0,
on: every tree of codecs/vp9/tables.py with its 0 leaves, a max_depth
below the tree's depth, streams read past their L bytes, L not a
multiple of the feed's word, rows at every byte alignment, and
probabilities 0, 1 and 255. On a stream whose first byte is 0xff the
int32 value of the Pallas kernel (and of the plain versions) parts from
the spec decoder's unbounded integer; the model follows the Pallas
kernel there. The `cuda` test holds both kernels to their plain versions
on the same cases."""
import os
import sys

import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

from ffmpeg_hybrid_tpu_torch.codecs.vp9 import tables as T
from ffmpeg_hybrid_tpu_torch.codecs.vp9.rac import BoolDecoder
from ffmpeg_hybrid_tpu_torch.ops import rac

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
M32, M64 = (1 << 32) - 1, (1 << 64) - 1
TREES = ("PARTITION_TREE", "SEGMENTATION_TREE", "INTRAMODE_TREE",
         "INTER_MODE_TREE", "FILTER_TREE", "MV_JOINT_TREE", "MV_CLASS_TREE",
         "MV_FP_TREE")


def _i32(v):
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


class _Row:
    """csrc/rac.cu Row: the row of n bytes at byte `addr` of `mem` (a
    uint8 buffer whose start is word-aligned) read as its aligned words
    as they lie in memory, the bytes at or past the row's end zeroed
    where bytes4 takes them. A load of a word that holds no byte of the
    row fails."""

    def __init__(self, mem, addr, n):
        self.mem, self.addr, self.n = mem, addr, n
        self.w, self.sh = addr // 4, addr % 4 * 8
        self.end = addr % 4 + n if n > 0 else 0

    def load(self, j):
        if 4 * j >= self.end:
            return 0
        i = 4 * (self.w + j)
        assert i < self.addr + self.n and i + 4 > self.addr, "stray load"
        return int.from_bytes(self.mem[i:i + 4].tobytes(), "little")

    def bytes4(self, a, b, m):
        x = ((b << 32 | a) >> self.sh) & M32
        valid = self.n - 4 * m
        return x if valid >= 4 else 0 if valid <= 0 else \
            x & ((1 << 8 * valid) - 1)


def _big_endian(x):
    return int.from_bytes(x.to_bytes(4, "little"), "big")


class _Window:
    """csrc/rac.cu Window on one row: value (int32), range, a 64-bit
    left-aligned lookahead of `count` bits, topped up by fill (before
    every 4 bools) with the next 32-bit stream word when it holds fewer
    than 28."""

    def __init__(self, row):
        self.row = row
        a0 = row.load(0)
        self.a, self.b = row.load(1), row.load(2)
        w0 = _big_endian(row.bytes4(a0, self.a, 0))
        self.value = w0 >> 24
        self.look = ((w0 << 8) & M32) << 32
        self.count, self.k, self.rng = 24, 1, 255

    def fill(self):
        if self.count < 28:
            x = _big_endian(self.row.bytes4(self.a, self.b, self.k))
            self.look |= x << (32 - self.count)
            self.count += 32
            self.a = self.b
            self.k += 1
            self.b = self.row.load(self.k + 1)
        assert self.look <= M64 and self.count >= 28

    def get(self, prob):
        split = (self.rng * prob + (256 - prob)) >> 8
        bit = int(self.value >= split)
        if bit:
            self.value -= split
        r = self.rng - split if bit else split
        top = r.bit_length() - 1
        sh = 7 - top
        assert self.count >= sh
        hi = self.look >> 32
        self.value = _i32(((self.value & M32) << sh | hi >> (32 - sh))
                          & M32)
        self.look = (self.look << sh) & M64
        self.count -= sh
        self.rng = (r << 7) >> top
        return bit


def _mem(data, base, seed):
    """The [S, L] rows end to end at byte `base` of a word-aligned
    buffer whose other bytes are random: a stray byte shows."""
    flat = np.asarray(data, np.uint8).reshape(-1)
    n = base + flat.size
    mem = np.random.RandomState(seed).randint(0, 256, n + 8 - n % 4)
    mem = mem.astype(np.uint8)
    mem[base:n] = flat
    return mem


def _stage_tree(tree, probs, NN):
    """csrc/rac.cu stage_tree for one lane (its table at offset 0):
    entry m at byte 32 m is ((tree[m][0], tree[m][1], the offsets of
    the entries of nodes max(tree[m][b], 0)), (those nodes'
    probabilities)); {offset: entry}."""
    table = {}
    for m in range(NN):
        e0, e1 = int(tree[m][0]), int(tree[m][1])
        n0, n1 = max(e0, 0), max(e1, 0)
        table[32 * m] = ((e0, e1, 32 * n0, 32 * n1),
                         (int(probs[n0]), int(probs[n1])))
    return table


def _tree_lane(win, probs, tree, k, max_depth):
    """decode_tree_kernel's loop for one lane: groups of 4 TreeWalk
    steps, a fill before each, on the lane's staged table; the steps
    after the k-th symbol of a group decode and store nothing."""
    if max_depth <= 0:
        return [0] * k
    table = _stage_tree(tree, probs, len(tree))
    e_root, p_root = table[0]
    prob_root = int(probs[0])
    e, p, prob, depth, out = e_root, p_root, prob_root, 0, []
    while len(out) < k:
        win.fill()
        for _ in range(4):
            (e0, p0), (e1, p1) = table[e[2]], table[e[3]]
            bit = win.get(prob)
            c = e[1] if bit else e[0]
            depth += 1
            cap = depth == max_depth
            done = c <= 0 or cap
            if done:
                if len(out) < k:
                    out.append(_i32(-c) if c <= 0 else 0)
                depth = 0
            prob = prob_root if cap else (p[1] if bit else p[0])
            e, p = (e_root, p_root) if cap else ((e1, p1) if bit
                                                 else (e0, p0))
    return out


def _bits_lane(win, prow):
    """decode_bits_kernel's loop for one lane: 16 bools a chunk (a fill
    every 4) under the probabilities of five aligned words (its row
    `prow`), the value's bits stored where i < K."""
    K = prow.n
    q = [prow.load(j) for j in range(5)]
    out = []
    for i in range(0, K, 16):
        j = i >> 2
        nxt = [prow.load(j + m) for m in range(5, 9)]
        p4 = [prow.bytes4(q[m], q[m + 1], j + m) for m in range(4)]
        v = 0
        for m in range(16):
            if m % 4 == 0:
                win.fill()
            v = (v << 1) | win.get((p4[m >> 2] >> (8 * (m & 3))) & 0xff)
        out += [(v >> (15 - m)) & 1 for m in range(16) if i + m < K]
        q = [q[4]] + nxt
    return out


def model_tree(data, probs, tree, k, max_depth=12, base=0):
    """The tree kernel's outputs [S, k] on rows that start at `base`."""
    S, L = data.shape
    mem = _mem(data, base, 1)
    tree = np.asarray(tree, np.int64)
    out = [_tree_lane(_Window(_Row(mem, base + s * L, L)),
                      probs[s].astype(np.int64), tree, k, max_depth)
           for s in range(S)]
    return np.asarray(out, np.int64).reshape(S, k)


def model_bits(data, probs, base=0):
    """The bits kernel's outputs [S, K] on rows that start at `base`."""
    S, L = data.shape
    K = probs.shape[1]
    mem, pmem = _mem(data, base, 3), _mem(probs, (base + 3) % 4, 4)
    return np.asarray([_bits_lane(_Window(_Row(mem, base + s * L, L)),
                                  _Row(pmem, (base + 3) % 4 + s * K, K))
                       for s in range(S)], np.int64).reshape(S, K)


def spec_tree(data, probs, tree, k, max_depth=12):
    """The spec decoder's symbols, max_depth bools a symbol at most."""
    out = np.zeros((data.shape[0], k), np.int64)
    for s in range(data.shape[0]):
        d = BoolDecoder(data[s].tobytes())
        for i in range(k):
            node = 0
            for _ in range(max_depth):
                nxt = int(tree[node][d.get_prob(int(probs[s, node]))])
                if nxt <= 0:
                    out[s, i] = -nxt
                    break
                node = nxt
    return out


def spec_bits(data, probs):
    out = np.zeros(probs.shape, np.int64)
    for s in range(data.shape[0]):
        d = BoolDecoder(data[s].tobytes())
        out[s] = [d.get_prob(int(p)) for p in probs[s]]
    return out


def plain_tree(data, probs, tree, k, max_depth=12):
    return rac.decode_tree_multi(torch.from_numpy(data),
                                 torch.from_numpy(probs), tree, k,
                                 max_depth).numpy()


def plain_bits(data, probs):
    return rac.decode_bits_multi(torch.from_numpy(data),
                                 torch.from_numpy(probs)).numpy()


def pallas_tree(data, probs, tree, k, max_depth=12):
    from ffmpeg_hybrid_tpu.ops import rac_pallas
    return np.asarray(rac_pallas.decode_tree_multi(data, probs, tree, k,
                                                   max_depth=max_depth))


def pallas_bits(data, probs):
    from ffmpeg_hybrid_tpu.ops import rac_pallas
    return np.asarray(rac_pallas.decode_bits_multi(data, probs))


def _tree(name):
    return np.asarray(getattr(T, name), np.int32)


def _depth(tree):
    """The most bools a symbol of `tree` takes."""
    def walk(node):
        return 1 + max(walk(int(e)) if e > 0 else 0 for e in tree[node])
    return walk(0)


def _encoded_tree_lanes(tree, probs, k, L, seed):
    """One lane per row of probs: k random symbols (every leaf, 0 too)
    encoded under the lane's probabilities; rows [S, L]."""
    sys.path.insert(0, TOOLS)
    try:
        from mini_encoder import BoolEncoder
    finally:
        sys.path.pop(0)
    rng = np.random.RandomState(seed)
    leaves = sorted({-int(v) for v in tree.reshape(-1) if v <= 0})
    syms = rng.choice(leaves, (probs.shape[0], k))
    data = np.zeros((probs.shape[0], L), np.uint8)
    for s in range(probs.shape[0]):
        e = BoolEncoder()
        for v in syms[s]:
            e.put_tree(tree, probs[s], int(v))
        b = e.bytes()
        assert len(b) <= L
        data[s, :len(b)] = np.frombuffer(b, np.uint8)
    return data, syms


def tree_cases():
    """(name, data, probs, tree, k, max_depth) of every edge the tree
    kernel has: every VP9 tree on encoded and random lanes, depth caps,
    overread, probability extremes. Shared with the `cuda` test."""
    cases = []
    for j, name in enumerate(TREES):
        tree = _tree(name)
        rng = np.random.RandomState(100 + j)
        NN, k = tree.shape[0], 24
        probs = rng.randint(40, 220, (6, NN)).astype(np.uint8)
        data, _syms = _encoded_tree_lanes(tree, probs[:3], k, 61, j)
        rand = rng.randint(0, 255, (3, 61)).astype(np.uint8)
        cases.append((name, np.concatenate([data, rand]), probs, tree, k,
                      12))
    for name in ("INTRAMODE_TREE", "MV_CLASS_TREE", "SEGMENTATION_TREE"):
        tree = _tree(name)
        rng = np.random.RandomState(_depth(tree))
        probs = rng.randint(1, 256, (5, tree.shape[0])).astype(np.uint8)
        data = rng.randint(0, 255, (5, 33)).astype(np.uint8)
        for md in (1, _depth(tree) - 1, _depth(tree)):
            cases.append((f"{name}_cap{md}", data, probs, tree, 20, md))
    tree = _tree("MV_CLASS_TREE")
    rng = np.random.RandomState(7)
    NN = tree.shape[0]
    # overread: 5 bytes a lane, far more bools than 40 bits
    cases.append(("overread", rng.randint(0, 255, (4, 5)).astype(np.uint8),
                  rng.randint(1, 256, (4, NN)).astype(np.uint8), tree, 40,
                  12))
    ext = np.stack([np.full(NN, 1), np.full(NN, 255), np.full(NN, 0),
                    np.resize([1, 255], NN)]).astype(np.uint8)
    cases.append(("prob_extremes", rng.randint(0, 255, (4, 23))
                  .astype(np.uint8), ext, tree, 30, 12))
    # a tree with a cycle (node 1 -> 2 -> 1): only the cap ends a symbol
    # that enters it
    cyc = np.array([[1, -1], [2, -2], [1, -3]], np.int32)
    cases.append(("cyclic", rng.randint(0, 255, (4, 19)).astype(np.uint8),
                  rng.randint(1, 256, (4, 3)).astype(np.uint8), cyc, 30, 5))
    # improbable symbols encoded under probabilities 1, 2, 254 and 255:
    # renormalizations of up to 7 bits at every fill of the lookahead
    ext = np.stack([np.full(NN, 1), np.full(NN, 255), np.resize([1, 255],
                                                                NN),
                    np.resize([254, 2, 255], NN)]).astype(np.uint8)
    data, _syms = _encoded_tree_lanes(tree, ext, 30, 160, 5)
    cases.append(("encoded_extremes", data, ext, tree, 30, 12))
    return cases


def bits_cases():
    """(name, data, probs) of the bits kernel's edges: L not a multiple
    of 4, K not a multiple of 16, overread, probability extremes."""
    rng = np.random.RandomState(11)
    K = 150
    probs = rng.randint(1, 256, (5, K)).astype(np.uint8)
    ext = np.stack([np.full(70, 1), np.full(70, 255), np.full(70, 0),
                    np.resize([1, 255, 128], 70), np.resize([255, 0], 70)])
    # random bits encoded under probabilities 1, 2, 128, 254 and 255
    sys.path.insert(0, TOOLS)
    try:
        from mini_encoder import BoolEncoder
    finally:
        sys.path.pop(0)
    eprobs = rng.choice([1, 2, 128, 254, 255], (5, 300)).astype(np.uint8)
    enc = np.zeros((5, 203), np.uint8)
    for s, row in enumerate(eprobs):
        e = BoolEncoder()
        for p in row:
            e.put(int(rng.randint(2)), int(p))
        b = e.bytes()
        assert len(b) <= enc.shape[1]
        enc[s, :len(b)] = np.frombuffer(b, np.uint8)
    return [
        ("encoded_extremes", enc, eprobs),
        ("random_L43", rng.randint(0, 255, (5, 43)).astype(np.uint8), probs),
        ("overread_L3", rng.randint(0, 255, (5, 3)).astype(np.uint8), probs),
        ("overread_L1", rng.randint(0, 255, (3, 1)).astype(np.uint8),
         probs[:3, :37]),
        ("prob_extremes", rng.randint(0, 255, (5, 9)).astype(np.uint8),
         ext.astype(np.uint8)),
    ]


def ff_cases():
    """Lanes whose first byte is 0xff (the value outgrows int32)."""
    rng = np.random.RandomState(13)
    data = rng.randint(0, 256, (4, 27)).astype(np.uint8)
    data[:, 0] = 0xff
    tree = _tree("INTRAMODE_TREE")
    return (data, rng.randint(1, 256, (4, 120)).astype(np.uint8),
            rng.randint(1, 256, (4, tree.shape[0])).astype(np.uint8), tree)


@pytest.mark.parametrize("case", range(len(TREES) + 13))
def test_tree_model_plain_spec_pallas(case):
    """Every VP9 tree, the depth caps, overread and the probability
    extremes: the model (rows at every byte alignment), the plain
    version, the spec decoder and the Pallas kernel agree; encoded
    lanes give back their symbols."""
    name, data, probs, tree, k, md = tree_cases()[case]
    want = spec_tree(data, probs, tree, k, md)
    for base in range(4):
        assert np.array_equal(model_tree(data, probs, tree, k, md, base),
                              want), (name, base)
    assert np.array_equal(plain_tree(data, probs, tree, k, md), want), name
    assert np.array_equal(pallas_tree(data, probs, tree, k, md), want), name
    if case < len(TREES):
        _d, syms = _encoded_tree_lanes(tree, probs[:3], k, 61, case)
        assert np.array_equal(want[:3], syms), name


@pytest.mark.parametrize("case", range(5))
def test_bits_model_plain_spec_pallas(case):
    name, data, probs = bits_cases()[case]
    want = spec_bits(data, probs)
    for base in range(4):
        assert np.array_equal(model_bits(data, probs, base), want), \
            (name, base)
    assert np.array_equal(plain_bits(data, probs), want), name
    assert np.array_equal(pallas_bits(data, probs), want), name


def test_first_byte_ff_follows_pallas():
    """A first byte 0xff: the model follows the Pallas kernel's and the
    plain versions' int32 value, which parts from the spec decoder."""
    data, bprobs, tprobs, tree = ff_cases()
    want = pallas_bits(data, bprobs)
    assert not np.array_equal(want, spec_bits(data, bprobs))
    assert np.array_equal(model_bits(data, bprobs, 2), want)
    assert np.array_equal(plain_bits(data, bprobs), want)
    want = pallas_tree(data, tprobs, tree, 40)
    assert np.array_equal(model_tree(data, tprobs, tree, 40, 12, 1), want)
    assert np.array_equal(plain_tree(data, tprobs, tree, 40), want)


def test_model_on_long_random_streams():
    """Hundreds of bools a lane on random rows of odd length: the
    model's refills (a word every 32 bits) against the spec decoder."""
    rng = np.random.RandomState(17)
    data = rng.randint(0, 255, (6, 45)).astype(np.uint8)
    probs = rng.randint(0, 256, (6, 333)).astype(np.uint8)
    want = spec_bits(data, probs)
    assert np.array_equal(model_bits(data, probs, 3), want)
    tree = _tree("INTRAMODE_TREE")
    tp = rng.randint(20, 236, (6, tree.shape[0])).astype(np.uint8)
    assert np.array_equal(model_tree(data, tp, tree, 120, 12, 1),
                          spec_tree(data, tp, tree, 120))


def test_tree_depth_and_the_cap_instance():
    """rac.tree_depth, which picks the kernel's instance without the cap
    where no symbol can reach max_depth: every VP9 tree's depth, 0 for a
    tree with a cycle reachable from the root, and a cycle that is not
    reachable changes nothing."""
    for name in TREES:
        tree = _tree(name)
        assert rac.tree_depth(tree.tobytes(), len(tree)) == _depth(tree)
    cyc = np.array([[1, -1], [2, -2], [1, -3]], np.int32)
    assert rac.tree_depth(cyc.tobytes(), 3) == 0
    off = np.array([[-1, -2], [2, 0], [1, -3]], np.int32)
    assert rac.tree_depth(off.tobytes(), 3) == 1
    diamond = np.array([[1, 2], [3, -1], [3, -2], [-3, -4]], np.int32)
    assert rac.tree_depth(diamond.tobytes(), 4) == 3


def test_tree_with_a_node_past_its_table_is_refused():
    """On the card the wrapper refuses a tree with a node entry of NN or
    more (the kernel reads node rows unchecked) before any launch."""
    meta = dict(device="meta", dtype=torch.uint8)
    bad = np.array([[1, 3], [-1, -2], [0, -3]], np.int32)
    rac.reset_launches()
    with pytest.raises(ValueError):
        rac.decode_tree_multi(torch.zeros((2, 8), **meta),
                              torch.zeros((2, 3), **meta), bad, 4)
    assert rac.LAUNCHES["decode_tree_multi"] == 0


@pytest.mark.cuda
def test_cuda_stream_kernels_match_plain():
    """Both kernels against their plain versions on the card, on every
    case above, with rows that start at every byte alignment; the
    clock-reading instance gives the same outputs and counts no launch.
    Other lanes a block (kStreamLanes) are held to the plain versions by
    tools/rac_streams_ab_torch.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")

    def on_card(a, base):
        """a on the card as a view that starts `base` bytes into its
        storage."""
        a = torch.from_numpy(np.ascontiguousarray(a))
        big = torch.zeros(a.numel() + base, dtype=a.dtype, device="cuda")
        big[base:] = a.reshape(-1).cuda()
        return big[base:].view(a.shape)

    data, bprobs, tprobs, tree = ff_cases()
    rac.reset_launches()
    cases = [("tree", c) for c in tree_cases()] + \
        [("bits", c) for c in bits_cases()] + \
        [("bits", ("ff", data, bprobs)),
         ("tree", ("ff", data, tprobs, tree, 40, 12))]
    launches = 0
    for kind, case in cases:
        args = case[3:]
        name = f"decode_{kind}_multi"
        want = getattr(rac, name + "_plain")(on_card(case[1], 0),
                                             on_card(case[2], 0), *args)
        for base in range(4):
            d, p = on_card(case[1], base), on_card(case[2], (base + 1) % 4)
            got = getattr(rac, name)(d, p, *args)
            launches += 1
            assert torch.equal(got, want), (kind, case[0], base)
            out, cycles = rac.stream_cycles(name, d, p, *args)
            assert torch.equal(out, want), (kind, case[0], base)
            assert bool((cycles > 0).all())
    assert rac.LAUNCHES["decode_tree_multi"] + \
        rac.LAUNCHES["decode_bits_multi"] == launches
