"""The (gop, tile) grid of device slots for parallel decode, the
counterpart of the JAX package's parallel/mesh.py (`make_mesh`).

Parallel axes (the reference's parallelism):
  - "gop":  GOP/frame parallelism (the frame-thread analogue, reference:
            pthread_frame.c): each gop row decodes its own frames; gop row
            g lives on cuda:(g % device_count).
  - "tile": tile-column parallelism within a frame (the slice-thread
            analogue, reference: vp9.c:1441-1552). Every tile slot of a
            row is on that row's device: the tile axis exchanges the loop
            filter's halos after every filter step, thousands of times a
            frame, and that exchange stays inside one device.

A Mesh holds `devices`, a [gop, tile] numpy array of torch.device, as
the JAX Mesh holds its devices (axes "gop", "tile").
"""
from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """A [gop, tile] grid of device slots."""

    def __init__(self, devices):
        self.devices = np.asarray(devices, dtype=object)
        if self.devices.ndim != 2 or not self.devices.size:
            raise ValueError("a mesh is a non-empty [gop, tile] grid")
        for row in self.devices:
            if any(d != row[0] for d in row):
                raise ValueError("the tile slots of a gop row share one "
                                 "device")

    def row_device(self, g):
        """The device of gop row g."""
        return self.devices[g, 0]


def make_mesh(n_devices=None, gop_axis=None, device=None):
    """A mesh of n_devices slots (default: one per card, or 1 on the CPU)
    as gop_axis rows (default 2 when n >= 4 and even, else 1) of tile
    slots. Gop row g lives on cuda:(g % device_count), or on the CPU when
    device is "cpu"."""
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
