"""Tile-column-sharded pass-B recon steps over a mesh, the counterpart of
the JAX package's parallel/tiles.py.

A plane is split into equal tile-column stripes, one tile slot each. Each
stripe is reconstructed with the port's kernels (the residual
transforms, per-cell 8-tap MC against the replicated reference planes
with the stripe's pixel offset folded into the motion), the 8-pixel
column halos that the cross-tile loop filter needs are exchanged between
neighbours (the JAX ppermute, here a copy), and the per-tile symbol-count
vectors that feed backward probability adaptation are summed over the
tiles (the reference's cross-tile count merge, vp9.c:1816-1819; the JAX
psum).

Every tile slot of a gop row is on the row's device, so a step stacks
the row's stripes one under the other, [T * H, Ws], with each stripe's
row offset folded into the motion too, and calls each kernel once for
all of them (residual_planes, mc_planes). The gop axis runs the same
step over independent frames.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import recon
from ..ops.lpf_replay import HALO
from .fullframe import _fold_motion


def _stripes(a, T):
    """The T equal column stripes of a [R, C, ...] array stacked one under
    the other: [T * R, C / T, ...]."""
    R, C = a.shape[:2]
    ws = C // T
    return torch.cat([a[:, t * ws:(t + 1) * ws] for t in range(T)], dim=0)


def _join(a, T):
    """The inverse of _stripes: [T * R, Ws] -> [R, T * Ws]."""
    return torch.cat(a.chunk(T, dim=0), dim=1)


def _stripe_recon(coef, eob4, txsz4, mv16, refsel, comp, filt, inter4,
                  refstack, counts, bpp=8):
    """Recon of every tile-column stripe of one plane (the JAX function
    runs per shard; here the T stripes of a row at once). coef: [T, H, Ws]
    int32; the grids [T, H/4, Ws/4, ...] at matching granularities;
    refstack [3, H, W] replicated; counts [T, n]. Returns (stripes [T, H,
    Ws] = clip(mc + residual) on every cell, from_left [T, H, 8] (the
    left neighbour's rightmost columns, cyclically), from_right [T, H, 8]
    (the right neighbour's leftmost), total_counts [T, n], each tile's
    copy of the sum)."""
    T, H, Ws = coef.shape
    dev = coef.device
    r4 = H // 4

    def st(a):
        return a.reshape((T * a.shape[1],) + tuple(a.shape[2:]))

    residual = recon.residual_planes(
        [(st(coef), st(eob4), st(txsz4), torch.zeros_like(st(txsz4)))],
        False, bpp)[0]
    # the stripe's absolute position in the (replicated) reference
    # planes, in the motion (1/16 pel)
    mv = _fold_motion(st(mv16).to(torch.int32), T, r4,
                      np.arange(T) * Ws, H, 1, 1)
    cells = (T * r4, Ws // 4)
    # every cell takes MC: the JAX step adds the prediction to the
    # residual everywhere (its _mc_cells leaves inter4 unread)
    out = recon.mc_planes(
        [(residual, torch.ones(cells, dtype=torch.bool, device=dev),
          st(comp).bool(), st(filt).to(torch.int32),
          st(refsel).to(torch.int32), mv,
          tuple(refstack[i].to(torch.int32) for i in range(3)),
          refstack.shape[2], refstack.shape[1], 1, 1)], bpp, True)[0]
    stripes = out.view(T, H, Ws)
    right = stripes[:, :, -HALO:]
    left = stripes[:, :, :HALO]
    from_left = torch.roll(right, 1, dims=0)
    from_right = torch.roll(left, -1, dims=0)
    total = counts.sum(dim=0, keepdim=True).expand_as(counts).clone()
    return stripes, from_left, from_right, total


def sharded_frame_recon(mesh, W_full, bpp=8, mvsx=2, mvsy=2,
                        lossless=False):
    """Tile-column-sharded inter recon of ONE real frame plane: a step
    taking the frame-wide (coef [H, W], eob4, txsz4, txtype4, refsel,
    mv16, comp, filt, inter4, refstack [3, Hr, Wr]) and returning the [H,
    W] plane, clip(mc + residual) on inter cells and 0 elsewhere. Each of
    the mesh's T tile slots takes a stripe of W / T columns, its pixel
    offset folded into the motion (1/16 pel, pre-scale: / mvsx), MC
    clamped at the frame's width W_full. Intra and the loop filter stay
    frame-wide passes after the stripes are joined (the reference's
    filter crosses tile boundaries, vp9.c:1441-1552)."""
    T = mesh.devices.shape[1]

    def step(coef, eob4, txsz4, txtype4, refsel, mv16, comp, filt, inter4,
             refstack):
        H, W = coef.shape
        if W % (4 * T):
            raise ValueError(f"{W} columns do not make {T} stripes of cells")
        ws = W // T
        residual = recon.residual_planes(
            [(_stripes(coef, T), _stripes(eob4, T), _stripes(txsz4, T),
              _stripes(txtype4, T))], lossless, bpp)[0]
        mv = _fold_motion(_stripes(mv16, T).to(torch.int32), T, H // 4,
                          np.arange(T) * ws, H, mvsx, mvsy)
        out = recon.mc_planes(
            [(residual, _stripes(inter4, T).bool(),
              _stripes(comp, T).bool(), _stripes(filt, T).to(torch.int32),
              _stripes(refsel, T).to(torch.int32), mv,
              tuple(refstack[i].to(torch.int32) for i in range(3)),
              W_full, refstack.shape[1], mvsx, mvsy)], bpp, True)[0]
        return _join(out, T)

    return step


def sharded_recon_step(mesh, bpp=8):
    """The tile+gop-sharded recon step of the mesh: step(coef [G, H, W],
    eob4, txsz4, mv16, refsel, comp, filt, inter4 [G, ...], refstack [G,
    3, H, W], counts [G, T, n]) -> (out [G, H, W], from_left [G, H, 8 T],
    from_right [G, H, 8 T], total_counts [G, T, n]): row g's frame on its
    row's device, split into T stripes of W / T columns (_stripe_recon)."""
    G, T = mesh.devices.shape

    def step(coef, eob4, txsz4, mv16, refsel, comp, filt, inter4, refstack,
             counts):
        outs = []
        for g in range(G):
            dev = mesh.row_device(g)

            def split(a):
                a = a[g].to(dev)
                return torch.stack(a.chunk(T, dim=1))

            outs.append(_stripe_recon(
                split(coef), split(eob4), split(txsz4), split(mv16),
                split(refsel), split(comp), split(filt), split(inter4),
                refstack[g].to(dev), counts[g].to(dev), bpp))
        out = torch.stack([torch.cat(list(o[0]), dim=1) for o in outs])
        fl = torch.stack([torch.cat(list(o[1]), dim=1) for o in outs])
        fr = torch.stack([torch.cat(list(o[2]), dim=1) for o in outs])
        tc = torch.stack([o[3] for o in outs])
        return out, fl, fr, tc

    return step
