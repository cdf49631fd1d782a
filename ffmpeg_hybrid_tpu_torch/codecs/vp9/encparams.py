"""Per-frame encode-parameters side-data export.

The port's equivalent of `vp9_export_enc_params` (reference:
libavcodec/vp9.c:1554-1604): frame-level base QP + plane QP deltas,
plus — when segmentation is enabled — one entry per coded block with
its position, size and effective per-segment QP delta.  Formatting
matches tools/venc_data_dump.c byte-for-byte so the export can be
diffed against the oracle decoder (FATE fate-vp9-encparams,
tests/fate/vpx.mak:144).
"""
from __future__ import annotations

from . import tables as T


def build_enc_params(dec) -> dict:
    """Snapshot the current frame's encode parameters at end of pass A
    (cur_segmap is fully populated by then)."""
    h = dec.header
    par = {
        "qp": int(h.yac_qi),
        # delta_qp[plane][0=dc,1=ac]; layout mirrors vp9.c:1570-1574
        "delta_qp": [[int(h.ydc_qdelta), 0],
                     [int(h.uvdc_qdelta), int(h.uvac_qdelta)],
                     [int(h.uvdc_qdelta), int(h.uvac_qdelta)]],
        "blocks": [],
    }
    if not h.seg_enabled:
        return par
    segmap = dec.cur_segmap
    blocks = par["blocks"]
    for row, col, _tcs, b in dec.blocks:
        w8 = int(T.BWH_TAB[1, b.bs, 0])
        h8 = int(T.BWH_TAB[1, b.bs, 1])
        seg_id = int(segmap[row, col])
        f = h.seg_feat[seg_id]
        dq = 0
        if f.q_enabled:
            dq = int(f.q_val)
            if h.seg_absolute_vals:
                dq -= par["qp"]
        blocks.append((col * 8, row * 8, 8 * w8, 8 * h8, dq))
    return par


def format_enc_params(frame_idx: int, par: dict | None) -> str:
    """One frame's dump in the venc_data_dump.c output format."""
    lines = [f"frame {frame_idx}"]
    if par is not None:
        lines.append("AVVideoEncParams 0")  # AV_VIDEO_ENC_PARAMS_VP9
        lines.append(f"qp {par['qp']}")
        for i in range(3):
            for j in range(2):
                v = par["delta_qp"][i][j]
                if v:
                    lines.append(f"delta_qp[{i}][{j}] {v}")
        if par["blocks"]:
            lines.append(f"nb_blocks {len(par['blocks'])}")
            for i, (x, y, w, hh, dq) in enumerate(par["blocks"]):
                lines.append(f"block {i} {x}:{y} {w}x{hh} {dq}")
    return "\n".join(lines) + "\n"
