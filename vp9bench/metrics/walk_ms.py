"""Device ms a frame of the pass-A walk (csrc/passa.cu), from the
profiler's records of the kernel in the traced window, one a frame."""
from vp9bench import kernels


def read(ctx):
    seconds, n = ctx.trace.kernel_times(kernels.WALK)
    return seconds / n * 1e3 if n else None
