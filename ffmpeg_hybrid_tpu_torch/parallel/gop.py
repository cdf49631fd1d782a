"""GOP-parallel decode, the counterpart of the JAX package's
parallel/gop.py.

A VP9 keyframe resets every probability context and refreshes all eight
reference slots (vp9.c:882-897), so a stream factors into independent
keyframe-rooted GOPs. This is the analogue of the reference's frame
threading (pthread_frame.c:501 forwards decoder state from thread to
thread; here no state crosses a GOP boundary): each worker decodes whole
GOPs with a private VP9Decoder (its own pass-A entropy state, reference
planes, kept coefficient buffers, splat and loop-filter states), and the
generator yields the frames in stream order.

Within a process the workers are threads: the native pass A releases the
GIL, so the workers spread the host's pass A, which sets the pace of a
decode, over the CPU cores. Worker i decodes on cuda:(i %
device_count), under a CUDA stream of its own (the port's kernels launch
on the current stream); on a machine with one card all workers share it.
Before a GOP's frames are handed over, the worker waits on an event
recorded on its stream after them, so the caller may read them on any
stream. Across processes, `decode_gops_md5_multiprocess` gives each
spawned process a contiguous range of GOPs (nothing shared; the results
merge in stream order).
"""
from __future__ import annotations

import contextlib
import hashlib
import itertools
import threading
from collections import deque

import torch

from ..formats.superframe import split_superframe


def packet_is_keyframe(data: bytes) -> bool:
    """True if the packet's FIRST frame is a keyframe (superframe-aware).
    reference: the frame-marker/profile/show-existing/frame-type bits of
    the uncompressed header (vp9.c:532-552)."""
    sub = split_superframe(data, 0)
    if not sub:
        return False
    d = sub[0][1]
    if len(d) < 1:
        return False
    b0 = d[0]
    if (b0 >> 6) != 0b10:  # frame marker
        return False
    profile = ((b0 >> 5) & 1) | (((b0 >> 4) & 1) << 1)
    bit = 4  # bits consumed so far in b0 (MSB-first)
    if profile == 3:
        bit += 1  # reserved bit
    show_existing = (b0 >> (7 - bit)) & 1
    bit += 1
    if show_existing:
        return False
    frame_type = (b0 >> (7 - bit)) & 1
    return frame_type == 0  # 0 = keyframe


def split_gops(packets):
    """Split a packet list into keyframe-rooted GOPs (list of lists).
    Leading non-keyframe packets (broken stream head) form their own
    group so decode errors surface exactly as in serial decode."""
    gops = []
    cur = []
    for pkt in packets:
        if packet_is_keyframe(pkt) and cur:
            gops.append(cur)
            cur = []
        cur.append(pkt)
    if cur:
        gops.append(cur)
    return gops


def _worker_devices(device):
    """The devices worker i takes in turn: cuda:(i % device_count), or
    the one device asked for when it is not a card."""
    from ..device import resolve
    dev = resolve(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _decode_gop(gop_packets, device, use_native, stream=None):
    """Decode one GOP with a private decoder on `device` (under `stream`
    when given); returns its Frames, whose device work has completed."""
    from ..codecs.vp9.decoder import VP9Decoder

    dec = VP9Decoder(device=device, use_native=use_native)
    cuda = dec.device.type == "cuda"
    frames = []
    with contextlib.ExitStack() as ctx:
        if cuda:
            # the kernels launch on the current device's current stream
            ctx.enter_context(torch.cuda.device(dec.device))
            if stream is not None:
                ctx.enter_context(torch.cuda.stream(stream))
        for pkt in gop_packets:
            for _pts, fd in split_superframe(pkt, 0):
                frames.extend(dec.decode(fd))
        if cuda:
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
    return frames


def decode_gops_parallel(packets, workers=2, device=None, use_native=None):
    """Decode the GOPs of `packets` on a pool of `workers` threads; yields
    the output Frames in stream order. Worker i decodes on
    cuda:(i % device_count) under a stream of its own (device="cpu": on
    the CPU, the plain versions). At most 2 x workers GOPs are in flight,
    so the frames held wait for the caller. An error in a GOP is raised
    from the generator at that GOP's place; every worker has been joined
    by then (and when the caller leaves the generator early)."""
    from concurrent.futures import ThreadPoolExecutor

    gops = split_gops(list(packets))
    devs = _worker_devices(device)
    if len(gops) <= 1 or workers <= 1:
        for g in gops:
            yield from _decode_gop(g, devs[0], use_native)
        return
    local = threading.local()
    ids = itertools.count()

    def init():
        dev = devs[next(ids) % len(devs)]
        local.dev = dev
        local.stream = torch.cuda.Stream(dev) if dev.type == "cuda" \
            else None

    def run(g):
        return _decode_gop(g, local.dev, use_native, local.stream)

    ex = ThreadPoolExecutor(max_workers=workers, initializer=init)
    pending = deque()
    todo = iter(gops)
    try:
        for g in itertools.islice(todo, 2 * workers):
            pending.append(ex.submit(run, g))
        while pending:
            frames = pending.popleft().result()  # stream order
            nxt = next(todo, None)
            if nxt is not None:
                pending.append(ex.submit(run, nxt))
            yield from frames
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


def _gop_md5_worker(args):
    path, lo, hi, device, use_native = args
    from ..formats.ivf import read_ivf

    _info, pkts = read_ivf(path)
    packets = [d for _p, d in pkts]
    gops = split_gops(packets)
    out = []
    for gi in range(lo, hi):
        frames = _decode_gop(gops[gi], device, use_native)
        out.append([(len(b), hashlib.md5(b).hexdigest())
                    for b in (f.to_bytes() for f in frames)])
    return out


def decode_gops_md5_multiprocess(path, n_procs=2, device=None,
                                 use_native=None):
    """An n-host GOP-sharded deployment in spawned processes: each process
    (its own interpreter, PyTorch runtime and decoder; nothing shared)
    decodes a contiguous GOP range of the IVF at `path`, process i on
    cuda:(i % device_count) (device="cpu": on the CPU); results merge in
    stream order. The caller's process builds the native pass A and the
    kernels first, so the processes load the built libraries from the
    package's build directory and build nothing. Returns [(size, md5)]
    per frame."""
    import multiprocessing as mp

    from .. import _build, passa_native
    from ..formats.ivf import read_ivf

    _info, pkts = read_ivf(path)
    gops = split_gops([d for _p, d in pkts])
    n = len(gops)
    n_procs = max(1, min(n_procs, n))
    devs = _worker_devices(device)
    if use_native is None or use_native:
        passa_native.lib()
    if devs[0].type == "cuda":
        _build.build_all()
    bounds = [(i * n) // n_procs for i in range(n_procs + 1)]
    jobs = [(path, bounds[i], bounds[i + 1], str(devs[i % len(devs)]),
             use_native) for i in range(n_procs)]
    ctx = mp.get_context("spawn")
    with ctx.Pool(n_procs) as pool:
        parts = pool.map(_gop_md5_worker, jobs)
    out = []
    for part in parts:
        for gop_md5s in part:
            out.extend(gop_md5s)
    return out
