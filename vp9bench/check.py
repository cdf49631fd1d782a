"""What decides `correct`: every frame the window decoded, as its three
cropped planes at the output depth (Frame.to_bytes()'s bytes), hashed
with MD5 and compared with the clip's framemd5 row of that frame (frame
k of a session is row k mod the cycle's frames: every cycle starts at
the keyframe). The framemd5 rows are the reference: a raw file that the
program never reads. Run once the window has closed and the program's
state is freed."""
from __future__ import annotations

import concurrent.futures
import hashlib

LIMITS = {
    # frames whose MD5 differs from their framemd5 row: exact, so 0
    "mismatched_frames": 0,
    # frames the window completed without an output to compare
    "unchecked_frames": 0,
    # sessions that completed no frame in the window
    "idle_sessions": 0,
    # sessions whose frame in flight never came (a minute past the close)
    "stalled_sessions": 0,
}


def md5_of(tensor):
    return hashlib.md5(tensor.cpu().numpy().tobytes()).hexdigest()


def compare(sessions, t_open, t_close, stalled=0):
    """{name: (value, limit)} of the checks over all sessions (the
    outputs hashed on a pool of threads: hashlib releases the GIL)."""
    jobs = [(s.expected[n % len(s.expected)], out)
            for s in sessions for n, out in s.outputs]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda j: md5_of(j[1]), jobs))
    mismatched = sum(g != want for g, (want, _o) in zip(got, jobs))
    completed = sum(len(s.frames) for s in sessions)
    idle = sum(not any(t_open <= b <= t_close for _a, b in s.frames)
               for s in sessions)
    values = {"mismatched_frames": mismatched,
              "unchecked_frames": completed - len(jobs),
              "idle_sessions": idle, "stalled_sessions": stalled}
    return {k: (v, LIMITS[k]) for k, v in values.items()}


def passed(checks):
    return all(v <= lim for v, lim in checks.values())
