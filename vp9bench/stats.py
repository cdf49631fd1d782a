"""The end-to-end arithmetic over a window: every frame that completed
inside it, from all sessions together."""
from __future__ import annotations

import math


def window_frames(frames, t_open, t_close):
    """The (handed_over, completed) pairs whose completion lies in the
    window [t_open, t_close]."""
    return [(a, b) for a, b in frames if t_open <= b <= t_close]


def fps(frames, t_open, t_close):
    """Frames completed in the window over the window's seconds."""
    return len(window_frames(frames, t_open, t_close)) / (t_close - t_open)


def percentile(values, q):
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default)."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def latency_p95_ms(frames, t_open, t_close):
    """The 95th percentile, in ms, of hand-over to completion over every
    frame completed in the window."""
    return percentile([(b - a) * 1e3 for a, b in
                       window_frames(frames, t_open, t_close)], 95)

