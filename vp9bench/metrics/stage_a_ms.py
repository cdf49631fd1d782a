"""Host ms a frame of decode_stream's thread A (the Collector's
stage.a: header parse, the walk's host prep and launch, its copy-back
and the replay), mean over the traced window's frames."""


def read(ctx):
    total, n = ctx.collector.get("stage.a", (0.0, 0))
    return total / n * 1e3 if n else None
