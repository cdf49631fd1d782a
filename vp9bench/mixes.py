"""The general traffic generator: a mix file of parameters
(traffic/<name>.json) turned into each session's start and the times its
packets are handed over.

Keys of a mix:
- `sessions`: streams decoded at once, a decoder each.
- `phase`: where each session's first measured frame lies in the clip's
  cycle. "spread": the seed draws an offset r, session i starts at
  (r + i * cycle // sessions) mod cycle, and the seed shuffles which
  session gets which, so every seed gives the same set of phases;
  "aligned": every session at the seed's r, so their keyframes coincide.
- `fps_per_session` (optional): an open loop, each session's k-th packet
  of the window due at open + k / fps_per_session, and its frame's
  latency counted from then. Without it the loop is closed: a session
  asks for its next frame when its last one is complete.
"""
from __future__ import annotations

import random

PHASES = ("spread", "aligned")


def phases(mix, seed, cycle):
    """The packet index in the cycle at which each session's window
    starts, from the seed: [sessions] ints in [0, cycle)."""
    n = int(mix["sessions"])
    kind = mix.get("phase", "spread")
    if kind not in PHASES:
        raise ValueError(f"unknown phase {kind!r}, expected one of {PHASES}")
    rng = random.Random(seed)
    r = rng.randrange(cycle)
    if kind == "aligned":
        return [r] * n
    out = [(r + i * cycle // n) % cycle for i in range(n)]
    rng.shuffle(out)
    return out


def due_times(mix, t_open):
    """None for a closed loop; else a function k -> the host time at
    which a session's k-th packet of the window is due."""
    fps = mix.get("fps_per_session")
    if fps is None:
        return None
    period = 1.0 / float(fps)
    return lambda k: t_open + k * period
