"""Processes of a mesh whose tile axis crosses them: the counterpart of
the JAX package's `jax.distributed.initialize` and of its `ppermute`
across processes (tests/test_multiprocess_mesh.py of the JAX package
runs two processes of a [2 gop, 4 tile] mesh whose tile axis crosses the
process boundary).

    init(rank, world, store)               # torch.distributed, gloo
    ex = HaloExchange()                     # the halo swaps, counted
    stripes = all_gather_stripes(local, ranks, ex)

`decode_mesh_multiprocess(packets, gop, ntile, world)` is the entry point: it
spawns `world` ranks on a make_rank_mesh, each running its own decoder's
pass A on every frame (as every JAX process runs the whole host side),
the sharded step on its slots (parallel/fullframe.py), whose loop filter
swaps the halos on the boundaries with the other ranks through a
HaloExchange (ops/lpf_replay.py, lf_scan_sharded_dist), and the gather
that rebuilds each frame's planes on every rank, which then become the
frame's own so later frames take them as references.

The transport is torch.distributed's gloo backend, whose point-to-point
calls take CPU tensors: a swap of a card's columns stages them through
pinned host buffers explicitly (a copy down, isend/irecv, a copy up).
The backend is the caller's choice and is never switched: "nccl" raises
(on a device shared by two ranks NCCL refuses; a rank a card waits for a
machine with two cards).
"""
from __future__ import annotations

import hashlib
import os
import pickle
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist


def _device_key(dev):
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return "cuda", 0
    return dev.type, dev.index


def init(rank, world, store, backend="gloo", devices=None, timeout=300):
    """Join the process group of `world` ranks as `rank`: store is the
    rendezvous, a path for a FileStore (file://, absent or empty before
    the group forms) or a URL (tcp://localhost:PORT); timeout in seconds
    bounds every collective and every swap. devices: each rank's device,
    which backend="nccl" reads to raise for a device two ranks share."""
    if backend == "nccl":
        devs = {_device_key(d) for d in (devices or ())}
        if len(devs) < world or any(d[0] != "cuda" for d in devs):
            raise ValueError(f"NCCL refuses a device shared by two ranks: "
                             f"{world} ranks on {sorted(devs)}; use "
                             "backend='gloo'")
        raise NotImplementedError("the rank-a-card NCCL transport is not "
                                  "written yet; use backend='gloo'")
    if backend != "gloo":
        raise ValueError(f"backend {backend!r}: the mesh's transport is "
                         "'gloo'")
    url = store if "://" in store else "file://" + os.path.abspath(store)
    dist.init_process_group("gloo", init_method=url, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout))


class HaloExchange:
    """The loop filter's swaps of boundary columns with neighbour ranks,
    counted: `exchanges` swaps, `bytes` sent and received, `ms` of host
    wall time in them (after the stream's work before each swap is done,
    so a launch's time is not in it: that wait is `sync_ms`), of which
    `wire_ms` in gloo's isend/irecv (with the wait for the peer to reach
    its side of the swap); `segments` and `cut_steps` the
    segment plans' launches and cross-rank steps (lf_scan_sharded_dist),
    `initial` its first swaps; `gathers`, `gather_bytes`, `gather_ms` the
    all_gather_stripes calls. With `timed`, lf_scan_sharded_dist puts a
    pair of CUDA events around each segment's launch into
    `replay_events` (replay_ms sums them)."""

    def __init__(self, rank=None, timed=False):
        self.rank = dist.get_rank() if rank is None else rank
        self.timed = timed
        self.replay_events = []
        self.exchanges = self.bytes = self.segments = self.cut_steps = 0
        self.initial = self.gathers = self.gather_bytes = 0
        self.ms = self.sync_ms = self.wire_ms = self.gather_ms = 0.0
        self._host = {}

    def _pinned(self, kind, like):
        key = (kind, tuple(like.shape), like.dtype)
        if key not in self._host:
            self._host[key] = torch.empty(like.shape, dtype=like.dtype,
                                          pin_memory=True)
        return self._host[key]

    def swap(self, peer, send=None, like=None):
        """Send `send` to rank peer and receive a tensor shaped like
        `like` from it (either may be None: a one-way swap); returns what
        came, on like's device. Card tensors go through pinned host
        buffers; the stream is synchronised first, so the buffers are
        free again (the last swap's copy up has run) and `send` holds
        what the stream wrote."""
        dev = (send if send is not None else like).device
        cuda = dev.type == "cuda"
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.current_stream(dev).synchronize()
            t1 = time.perf_counter()
            self.sync_ms += (t1 - t0) * 1e3
            t0 = t1
        ops, nbytes, out = [], 0, None
        if send is not None:
            sbuf = self._pinned("send", send) if cuda else send.contiguous()
            if cuda:
                sbuf.copy_(send)
            ops.append(dist.isend(sbuf, peer))
            nbytes += sbuf.numel() * sbuf.element_size()
        if like is not None:
            rbuf = self._pinned("recv", like) if cuda else torch.empty(
                like.shape, dtype=like.dtype)
            ops.append(dist.irecv(rbuf, peer))
            nbytes += rbuf.numel() * rbuf.element_size()
        tw = time.perf_counter()
        for op in ops:
            op.wait()
        self.wire_ms += (time.perf_counter() - tw) * 1e3
        if like is not None:
            out = rbuf.to(dev, non_blocking=True) if cuda else rbuf
        self.exchanges += 1
        self.bytes += nbytes
        self.ms += (time.perf_counter() - t0) * 1e3
        return out

    def note_plan(self, segments, cut_steps, initial):
        """One lf_scan_sharded_dist call's plan: its segments (launches),
        cross-rank steps and first swaps."""
        self.segments += segments
        self.cut_steps += cut_steps
        self.initial += initial

    def replay_ms(self):
        """The timed launches' device time, ms (synchronises)."""
        for _a, b in self.replay_events:
            b.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.replay_events)

    def stats(self):
        return {"exchanges": self.exchanges, "exchange_bytes": self.bytes,
                "exchange_ms": self.ms, "sync_ms": self.sync_ms,
                "wire_ms": self.wire_ms, "segments": self.segments,
                "cut_steps": self.cut_steps, "initial": self.initial,
                "gathers": self.gathers, "gather_bytes": self.gather_bytes,
                "gather_ms": self.gather_ms,
                "replay_ms": self.replay_ms() if self.timed else None}


def all_gather_stripes(local, ranks, exchange=None):
    """The stripes of a gop row from every rank: local [n, ...] this
    rank's stripes (its contiguous run of the row's slots, whose ranks
    `ranks` [T] give; n = 0 where it owns none), the trailing shape the
    same on every rank -> [T, ...] in slot order on local's device. Every
    rank of the group calls it (gloo's all_gather, through host
    tensors)."""
    t0 = time.perf_counter()
    ranks = [int(r) for r in ranks]
    world = dist.get_world_size()
    counts = [ranks.count(r) for r in range(world)]
    if len(local) != counts[dist.get_rank()]:
        raise ValueError(f"{len(local)} stripes for {counts[dist.get_rank()]}"
                         " slots")
    host = torch.zeros((max(counts),) + tuple(local.shape[1:]),
                       dtype=local.dtype)
    host[:len(local)] = local.cpu()
    parts = [torch.empty_like(host) for _ in range(world)]
    dist.all_gather(parts, host)
    seen = {r: 0 for r in range(world)}
    rows = []
    for r in ranks:
        rows.append(parts[r][seen[r]])
        seen[r] += 1
    out = torch.stack(rows).to(local.device)
    if exchange is not None:
        exchange.gathers += 1
        exchange.gather_bytes += world * host.numel() * host.element_size()
        exchange.gather_ms += (time.perf_counter() - t0) * 1e3
    return out


# ---------------------------------------------------------------------------
# the multi-process decode


def _depends(job, group):
    """Whether an inter frame's references include a frame of group."""
    h = job.header
    if h.keyframe or h.intraonly:
        return False
    own = {id(j.cur_frame_obj) for j in group}
    return any(id(job.refs[i]) in own for i in h.refidx)


def decode_mesh_rank(packets, mesh, exchange, device):
    """One rank's decode of `packets` on the rank mesh `mesh`: its own
    decoder's pass A of every frame; up to gop frames at a time (a frame
    that references one of them waits for the next step) through
    sharded_decode_pass_b on the rank's slots, every frame's planes
    rebuilt by gather_planes and installed. Returns ([md5 of each output
    frame], {"frames", "ms"}: the frames stepped and the ms a frame of
    the steps, under CUDA events on a card)."""
    from ..codecs.vp9.decoder import VP9Decoder
    from .fullframe import gather_planes, install, sharded_decode_pass_b
    gop = mesh.devices.shape[0]
    dec = VP9Decoder(device=device)
    cuda = dec.device.type == "cuda"
    md5s, group, timing = [], [], {"frames": 0, "ms": 0.0}

    def flush():
        if not group:
            return
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        else:
            t0 = time.perf_counter()
        outs = sharded_decode_pass_b(group, mesh.rows(len(group)), exchange)
        for j, out in zip(group, outs):
            install(j, gather_planes(out, exchange))
        if cuda:
            ev[1].record()
            ev[1].synchronize()
            timing["ms"] += ev[0].elapsed_time(ev[1])
        else:
            timing["ms"] += (time.perf_counter() - t0) * 1e3
        timing["frames"] += len(group)
        for j in group:
            md5s.extend(hashlib.md5(f.to_bytes()).hexdigest()
                        for f in j.outputs)
        group.clear()

    for fd in packets:
        job = dec.decode_pass_a(fd)
        if job.ready is not None:
            flush()
            md5s.extend(hashlib.md5(f.to_bytes()).hexdigest()
                        for f in job.ready)
            continue
        if _depends(job, group):
            flush()
        group.append(job)
        if len(group) == gop:
            flush()
    flush()
    timing["ms"] /= max(timing["frames"], 1)
    return md5s, timing


def _launch_counters():
    """The kernel wrappers' launch counts (each module's LAUNCHES)."""
    from ..ops import lpf_dense, lpf_masks, lpf_replay, passa_device, rac
    from ..ops import recon_cuda
    return [m.LAUNCHES for m in (rac, lpf_dense, lpf_masks, recon_cuda,
                                 lpf_replay, passa_device)]


def _mesh_rank(rank, world, store, args, results):
    """A spawned rank of decode_mesh_multiprocess: puts (rank, True,
    result) or (rank, False, its traceback) on results."""
    started = False
    try:
        (packets_path, gop, ntile, device, backend, timeout, threads,
         rank_setup) = args
        with open(packets_path, "rb") as f:
            packets = pickle.load(f)
        torch.set_num_threads(threads)
        from .mesh import make_rank_mesh
        if rank_setup is not None:
            rank_setup(rank)
        mesh = make_rank_mesh(gop, ntile, world, device)
        dev = mesh.row_device(0, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        init(rank, world, store, backend,
             [mesh.row_device(0, r) for r in range(world)], timeout)
        started = True
        ex = HaloExchange(rank, timed=dev.type == "cuda")
        counters = _launch_counters()
        for c in counters:
            c.update(dict.fromkeys(c, 0))
        md5s, timing = decode_mesh_rank(packets, mesh, ex, dev)
        stats = dict(ex.stats(), **timing, rank=rank, device=str(dev),
                     launches={k: v for c in counters for k, v in c.items()},
                     slots=mesh.local_slots(rank))
        results.put((rank, True, (md5s, stats)))
    except BaseException:  # noqa: BLE001 - sent to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if started:
            dist.destroy_process_group()


def decode_mesh_multiprocess(packets, gop, ntile, world=2, device=None,
                             backend="gloo", timeout=600, rank_setup=None):
    """Decode packets (each one frame's bytes) on a [gop, ntile]
    make_rank_mesh over `world` spawned ranks (device: "cpu", or the
    card, each rank on cuda:(rank % device_count)). The caller's process
    builds the native pass A and the kernels first, so the ranks load
    them and build nothing; each rank takes its share of the caller's
    PyTorch threads; rank_setup, a picklable callable, runs first in each
    rank as rank_setup(rank). Returns ([md5 of each output frame], [each
    rank's stats: HaloExchange.stats, the frames stepped, their ms a
    frame, every kernel's launches from the rank's start, its slots]). A
    rank that fails fails the run: the others are stopped and
    RuntimeError carries its traceback; so does a rank that dies without
    a word, or a run past `timeout` seconds (also each swap's and
    collective's bound). The ranks' MD5s must agree."""
    import multiprocessing as mp
    import queue
    import shutil
    import tempfile

    from .. import _build, passa_native
    from ..device import resolve
    from .mesh import make_rank_mesh
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        resolve(device)
    mesh = make_rank_mesh(gop, ntile, world, "cpu" if cpu else device)
    if backend == "nccl":
        init(0, world, "", backend,
             [mesh.row_device(0, r) for r in range(world)])   # raises
    passa_native.lib()
    if not cpu:
        _build.build_all()
    tmp = tempfile.mkdtemp(prefix="mesh_mp_")
    store = os.path.join(tmp, "store")
    # the packets go by file: a spawned child that fails before it reads
    # its arguments would leave a start that writes more than a pipe holds
    # blocked
    packets_path = os.path.join(tmp, "packets.pkl")
    with open(packets_path, "wb") as f:
        pickle.dump(list(packets), f)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    args = (packets_path, gop, ntile, "cpu" if cpu else device, backend,
            timeout, max(1, torch.get_num_threads() // world), rank_setup)
    procs = [ctx.Process(target=_mesh_rank,
                         args=(r, world, store, args, results))
             for r in range(world)]
    got = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(got) < world:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    # a last word may still be in flight
                    try:
                        rank, ok, payload = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} without a result")
                elif time.monotonic() > deadline:
                    raise RuntimeError(f"the ranks ran past {timeout} s")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            got[rank] = payload
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.pid is None:       # never started
                continue
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    md5s = got[0][0]
    for r in range(1, world):
        if got[r][0] != md5s:
            raise RuntimeError(f"rank {r}'s frames differ from rank 0's")
    return md5s, [got[r][1] for r in range(world)]
