"""Device ms a frame of pass B's kernels (splat, scatter, residual, MC,
intra, loop-filter grids, loop filter), from the profiler's records in
the traced window over the frames whose residual kernel ran there."""
from vp9bench import kernels


def read(ctx):
    seconds, _n = ctx.trace.kernel_times(kernels.PASS_B)
    _s, frames = ctx.trace.kernel_times(kernels.PASS_B_FRAME)
    return seconds / frames * 1e3 if frames else None
