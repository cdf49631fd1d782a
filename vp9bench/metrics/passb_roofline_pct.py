"""Pass B's kernels' share of their roofline: the bytes a frame needs
(vp9bench/passb_bytes.py, each input read once and each output written
once, mean over the clip's cycle) over the HBM rate, divided by the
kernels' device time a frame."""
from vp9bench import kernels, passb_bytes


def read(ctx):
    if not ctx.passb_bytes:
        return None
    seconds, _n = ctx.trace.kernel_times(kernels.PASS_B)
    _s, frames = ctx.trace.kernel_times(kernels.PASS_B_FRAME)
    if not frames or not seconds:
        return None
    return 100.0 * ctx.passb_bytes / passb_bytes.HBM_BPS / (seconds / frames)
