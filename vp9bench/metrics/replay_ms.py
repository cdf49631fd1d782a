"""Host ms a frame of the device pass A's replay into the native layouts
(the Collector's decode.pass_a_replay, decoder._decode_tiles_device)."""


def read(ctx):
    total, n = ctx.collector.get("decode.pass_a_replay", (0.0, 0))
    return total / n * 1e3 if n else None
