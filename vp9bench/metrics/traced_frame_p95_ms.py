"""The 95th percentile, in ms, of hand-over to completion over every
frame completed in the traced window: frame_p95_ms's arithmetic on the
host's clock, with the profiler on. It stands in, per layer, for the
end-to-end frame_p95_ms in a cell whose untraced p95 spreads too widely
from run to run to be held to a bound."""
from vp9bench import stats


def read(ctx):
    if not stats.window_frames(ctx.frames, ctx.t_open, ctx.t_close):
        return None
    return stats.latency_p95_ms(ctx.frames, ctx.t_open, ctx.t_close)
