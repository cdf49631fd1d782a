"""The VP9 loop filter's mask walker: the per-superblock edge walk of
ff_vp9_loopfilter_sb (vp9lpf.c:31-230), a copy of the JAX package's
ops/lpf.py walkers (filter_plane_cols, filter_plane_rows, loopfilter_sb)
with the pixel filter left to the caller. `apply(plane, py, px, dir,
wd, E, I, H, bpp, nlanes)` receives each edge call in the reference's
order; parallel/fullframe.py's record_lf_python records them.
"""


def _eih(level, idx, lim_lut, mblim_lut):
    L = int(level[idx])
    return int(mblim_lut[L]), int(lim_lut[L]), L >> 4


def filter_plane_cols(plane, base_y, base_x, col, ss_h, ss_v, level, mask,
                      lim_lut, mblim_lut, bpp, apply):
    """Vertical-edge pass for one superblock's plane region.
    level: flat [64] uint8 (8x8 grid); mask: [8][4] bitmasks.
    reference: filter_plane_cols (vp9lpf.c:31-105). The reference's
    loop_filter_16 / loop_filter_mix2 compound calls are decomposed into
    their 8-lane halves (identical math, vp9dsp_template.c:1920-1960)."""
    lvl = 0  # flat index into 8x8 level grid
    it = 0
    for y in range(0, 8, 2 << ss_v):
        hmask1 = mask[y]
        hmask2 = mask[y + 1 + ss_v]
        hm1 = int(hmask1[0]) | int(hmask1[1]) | int(hmask1[2])
        hm13 = int(hmask1[3])
        hm2 = int(hmask2[1]) | int(hmask2[2])
        hm23 = int(hmask2[3])
        hm = hm1 | hm2 | hm13 | hm23
        x = 1
        l = lvl
        cx = 0
        py = base_y + it * 16
        while hm & ~(x - 1):
            px = base_x + cx * (8 >> ss_h)
            if col or x > 1:
                if hm1 & x:
                    E, I, H = _eih(level, l, lim_lut, mblim_lut)
                    if int(hmask1[0]) & x:
                        if int(hmask2[0]) & x:
                            apply(plane, py, px, 0, 16, E, I, H, bpp, 16)
                        else:
                            apply(plane, py, px, 0, 16, E, I, H, bpp, 8)
                    elif hm2 & x:
                        wd1 = 8 if int(hmask1[1]) & x else 4
                        wd2 = 8 if int(hmask2[1]) & x else 4
                        apply(plane, py, px, 0, wd1, E, I, H, bpp, 8)
                        E2, I2, H2 = _eih(level, l + (8 << ss_v),
                                          lim_lut, mblim_lut)
                        apply(plane, py + 8, px, 0, wd2, E2, I2, H2, bpp, 8)
                    else:
                        wd1 = 8 if int(hmask1[1]) & x else 4
                        apply(plane, py, px, 0, wd1, E, I, H, bpp, 8)
                elif hm2 & x:
                    E, I, H = _eih(level, l + (8 << ss_v), lim_lut,
                                   mblim_lut)
                    wd2 = 8 if int(hmask2[1]) & x else 4
                    apply(plane, py + 8, px, 0, wd2, E, I, H, bpp, 8)
            if ss_h:
                if x & 0xAA:
                    l += 2
            else:
                if hm13 & x:
                    E, I, H = _eih(level, l, lim_lut, mblim_lut)
                    apply(plane, py, px + 4, 0, 4, E, I, H, bpp, 8)
                    if hm23 & x:
                        E2, I2, H2 = _eih(level, l + (8 << ss_v),
                                          lim_lut, mblim_lut)
                        apply(plane, py + 8, px + 4, 0, 4, E2, I2, H2,
                               bpp, 8)
                elif hm23 & x:
                    E, I, H = _eih(level, l + (8 << ss_v), lim_lut,
                                   mblim_lut)
                    apply(plane, py + 8, px + 4, 0, 4, E, I, H, bpp, 8)
                l += 1
            x <<= 1
            cx += 1
        it += 1
        lvl += 16 << ss_v


def filter_plane_rows(plane, base_y, base_x, row, ss_h, ss_v, level, mask,
                      lim_lut, mblim_lut, bpp, apply):
    """Horizontal-edge pass (reference: filter_plane_rows, vp9lpf.c:107-181).
    """
    lvl = 0
    for y in range(8):
        vmask = mask[y]
        vm = int(vmask[0]) | int(vmask[1]) | int(vmask[2])
        vm3 = int(vmask[3])
        py = base_y + y * (8 >> ss_v)
        x = 1
        l = lvl
        cx = 0
        while vm & ~(x - 1):
            px = base_x + cx * 16
            x2 = x << (1 + ss_h)
            if row or y:
                if vm & x:
                    E, I, H = _eih(level, l, lim_lut, mblim_lut)
                    if int(vmask[0]) & x:
                        if int(vmask[0]) & x2:
                            apply(plane, py, px, 1, 16, E, I, H, bpp, 16)
                        else:
                            apply(plane, py, px, 1, 16, E, I, H, bpp, 8)
                    elif vm & x2:
                        wd1 = 8 if int(vmask[1]) & x else 4
                        wd2 = 8 if int(vmask[1]) & x2 else 4
                        apply(plane, py, px, 1, wd1, E, I, H, bpp, 8)
                        E2, I2, H2 = _eih(level, l + 1 + ss_h,
                                          lim_lut, mblim_lut)
                        apply(plane, py, px + 8, 1, wd2, E2, I2, H2, bpp, 8)
                    else:
                        wd1 = 8 if int(vmask[1]) & x else 4
                        apply(plane, py, px, 1, wd1, E, I, H, bpp, 8)
                elif vm & x2:
                    E, I, H = _eih(level, l + 1 + ss_h, lim_lut, mblim_lut)
                    wd2 = 8 if int(vmask[1]) & x2 else 4
                    apply(plane, py, px + 8, 1, wd2, E, I, H, bpp, 8)
            if not ss_v:
                if vm3 & x:
                    E, I, H = _eih(level, l, lim_lut, mblim_lut)
                    apply(plane, py + 4, px, 1, 4, E, I, H, bpp, 8)
                    if vm3 & x2:
                        E2, I2, H2 = _eih(level, l + 1 + ss_h,
                                          lim_lut, mblim_lut)
                        apply(plane, py + 4, px + 8, 1, 4, E2, I2, H2,
                               bpp, 8)
                elif vm3 & x2:
                    E, I, H = _eih(level, l + 1 + ss_h, lim_lut, mblim_lut)
                    apply(plane, py + 4, px + 8, 1, 4, E, I, H, bpp, 8)
            x <<= 2 << ss_h
            cx += 1
            l += 2 << ss_h
        if ss_v:
            if y & 1:
                lvl += 16
        else:
            lvl += 8


def loopfilter_sb(planes, level, masks, row, col, ss_h, ss_v, lim_lut,
                  mblim_lut, bpp, apply):
    """Filter one 64x64 superblock across Y/U/V.
    planes: [y, u, v], each passed to `apply` as it is. level: [8,8] grid.
    masks: [2][2][8][4] (0=y, 1=uv; 0=col, 1=row).
    reference: ff_vp9_loopfilter_sb (vp9lpf.c:183-230)."""
    lv = level.reshape(-1)
    y0, x0 = row * 8, col * 8
    filter_plane_cols(planes[0], y0, x0, col, 0, 0, lv, masks[0][0],
                      lim_lut, mblim_lut, bpp, apply)
    filter_plane_rows(planes[0], y0, x0, row, 0, 0, lv, masks[0][1],
                      lim_lut, mblim_lut, bpp, apply)
    uvidx = 1 if (ss_h | ss_v) else 0
    uy0, ux0 = y0 >> ss_v, x0 >> ss_h
    for p in (1, 2):
        filter_plane_cols(planes[p], uy0, ux0, col, ss_h, ss_v, lv,
                          masks[uvidx][0], lim_lut, mblim_lut, bpp, apply)
        filter_plane_rows(planes[p], uy0, ux0, row, ss_h, ss_v, lv,
                          masks[uvidx][1], lim_lut, mblim_lut, bpp, apply)
