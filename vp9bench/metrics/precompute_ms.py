"""Host ms a frame of pass B's host precompute (the Collector's
decode.pass_b_precompute, ops/recon.py precompute_host)."""


def read(ctx):
    total, n = ctx.collector.get("decode.pass_b_precompute", (0.0, 0))
    return total / n * 1e3 if n else None
