"""The (gop, tile) grid of device slots for parallel decode, the
counterpart of the JAX package's parallel/mesh.py (`make_mesh`).

Parallel axes (the reference's parallelism):
  - "gop":  GOP/frame parallelism (the frame-thread analogue, reference:
            pthread_frame.c): each gop row decodes its own frames.
  - "tile": tile-column parallelism within a frame (the slice-thread
            analogue, reference: vp9.c:1441-1552).

A Mesh holds `devices`, a [gop, tile] numpy array of torch.device, as
the JAX Mesh holds its devices (axes "gop", "tile"), and `ranks`, a
[gop, tile] array of the torch.distributed rank (the process) that owns
each slot, 0 everywhere by default: one process owns the whole mesh.

A rank's slots in a gop row form one contiguous run of tile columns on
one device. Within a run the loop filter's halos go between thread
blocks of one launch (ops/lpf_replay.py), thousands of times a frame; a
boundary between two ranks' runs (`boundaries`) is crossed by an
explicit transport (parallel/dist.py) after each filter step that
writes a column on it, as the JAX package's ppermute crosses its
process boundary. With one rank this is the single-process mesh: every
slot of a row on that row's device, gop row g on cuda:(g %
device_count) (`make_mesh`). `make_rank_mesh` splits the tile axis
across ranks, the layout of the JAX package's two-process mesh
(tests/test_multiprocess_mesh.py).
"""
from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """A [gop, tile] grid of device slots, each owned by a rank."""

    def __init__(self, devices, ranks=None):
        self.devices = np.asarray(devices, dtype=object)
        if self.devices.ndim != 2 or not self.devices.size:
            raise ValueError("a mesh is a non-empty [gop, tile] grid")
        self.ranks = (np.zeros(self.devices.shape, np.int64) if ranks is None
                      else np.asarray(ranks, np.int64))
        if self.ranks.shape != self.devices.shape or self.ranks.min() < 0:
            raise ValueError(f"ranks {self.ranks.tolist()} for a mesh of "
                             f"shape {list(self.devices.shape)}")
        for g, (devs, ranks) in enumerate(zip(self.devices, self.ranks)):
            for r in np.unique(ranks):
                idx = np.nonzero(ranks == r)[0]
                if idx[-1] - idx[0] + 1 != len(idx):
                    raise ValueError(f"the slots of rank {r} in gop row {g} "
                                     "are not one contiguous run of tile "
                                     "columns")
                if any(devs[t] != devs[idx[0]] for t in idx):
                    raise ValueError(f"the slots of rank {r} in gop row {g} "
                                     "are not on one device")

    @property
    def world(self):
        """The number of ranks (processes) the mesh spans."""
        return int(self.ranks.max()) + 1

    def row_device(self, g, rank=0):
        """The device of rank's slots in gop row g."""
        idx = np.nonzero(self.ranks[g] == rank)[0]
        if not len(idx):
            raise ValueError(f"rank {rank} owns no slot of gop row {g}")
        return self.devices[g, idx[0]]

    def local_slots(self, rank):
        """rank's slots: [(g, lo, hi)], tile columns lo .. hi - 1 of gop
        row g, for each row where it owns any."""
        out = []
        for g, ranks in enumerate(self.ranks):
            idx = np.nonzero(ranks == rank)[0]
            if len(idx):
                out.append((g, int(idx[0]), int(idx[-1]) + 1))
        return out

    def boundaries(self, g):
        """The pairs (t - 1, t) of gop row g's tile slots whose ranks
        differ: the boundaries the loop filter's halos cross between
        processes."""
        r = self.ranks[g]
        return [(t - 1, t) for t in range(1, len(r)) if r[t - 1] != r[t]]

    def rows(self, n):
        """The mesh of the first n gop rows."""
        return Mesh(self.devices[:n], self.ranks[:n])


def make_mesh(n_devices=None, gop_axis=None, device=None):
    """A mesh of n_devices slots (default: one per card, or 1 on the CPU)
    as gop_axis rows (default 2 when n >= 4 and even, else 1) of tile
    slots, all owned by rank 0. Gop row g lives on cuda:(g %
    device_count), or on the CPU when device is "cpu"."""
    cpu = device is not None and torch.device(device).type == "cpu"
    count = 1 if cpu else torch.cuda.device_count()
    if not cpu and count == 0:
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to build a mesh of CPU slots")
    n = count if n_devices is None else n_devices
    if gop_axis is None:
        gop_axis = 2 if n >= 4 and n % 2 == 0 else 1
    if n % gop_axis:
        raise ValueError(f"{n} slots do not make {gop_axis} gop rows")
    tile_axis = n // gop_axis
    rows = [torch.device("cpu") if cpu else torch.device("cuda", g % count)
            for g in range(gop_axis)]
    return Mesh([[d] * tile_axis for d in rows])


def make_rank_mesh(gop, ntile, world, device=None):
    """A [gop, ntile] mesh whose tile axis is split across `world` ranks:
    in every row rank r owns a run of ntile // world consecutive tile
    slots (one more for the first ntile % world ranks), so [2, 4] over 2
    ranks puts tiles 0-1 on rank 0 and 2-3 on rank 1, as the JAX
    package's two-process mesh does; all on rank r's device: cuda:(r %
    device_count), so that two ranks share the one card of a one-card
    machine, or the CPU when device is "cpu"."""
    if not 1 <= world <= ntile:
        raise ValueError(f"{ntile} tile slots over {world} ranks")
    split = [ntile // world + (r < ntile % world) for r in range(world)]
    cpu = device is not None and torch.device(device).type == "cpu"
    count = 1 if cpu else torch.cuda.device_count()
    if not cpu and count == 0:
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to build a mesh of CPU slots")
    ranks = np.repeat(np.arange(world), split)
    devs = [torch.device("cpu") if cpu else torch.device("cuda", r % count)
            for r in ranks]
    return Mesh([devs] * gop, [ranks] * gop)
