"""The traced run's readings: torch.profiler over the window (device
activity only), the port's Collector with its timers' intervals kept,
and the reduction of the profiler's trace to device intervals, busy
time, idle gaps and the top device operations.

The trace's clock is tied to the host's by two markers: the harness
calls torch.cuda.synchronize() (cudaDeviceSynchronize, which the decode
path never calls) at the window's opening and closing, right after
reading the host clock.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANON = "(anonymous namespace)::"
MARKER = "cudaDeviceSynchronize"


class Tracer:
    """Profiler and Collector of one traced window; trace files go to
    `outdir`."""

    def __init__(self, outdir):
        self.outdir = outdir
        self.spans = []        # (name, thread id, start, end), host clock
        self.marks = []        # host times of the markers
        self._prof = None
        self._restore = None

    def start(self):
        """Enable the port's Collector, keep its timers' intervals, and
        start the profiler (before the window: its start-up is set-up)."""
        from ffmpeg_hybrid_tpu_torch.utils.metrics import metrics
        real = metrics.timer
        spans = self.spans

        @contextlib.contextmanager
        def timer(name):
            t0 = time.perf_counter()
            try:
                with real(name):
                    yield
            finally:
                spans.append((name, threading.get_native_id(), t0,
                              time.perf_counter()))
        metrics.timer = timer
        metrics.enable()
        self._restore = lambda: (delattr(metrics, "timer"),
                                 metrics.disable())
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()

    def mark(self):
        """A marker: the host time, then cudaDeviceSynchronize."""
        t = time.perf_counter()
        torch.cuda.synchronize()
        self.marks.append(t)
        return t

    def reset_collector(self):
        from ffmpeg_hybrid_tpu_torch.utils.metrics import metrics
        metrics.reset()
        self.spans.clear()

    def collector(self):
        """{stage: (total seconds, count)} of the Collector's timers."""
        from ffmpeg_hybrid_tpu_torch.utils.metrics import metrics
        return {k: (d["total_s"], d["count"])
                for k, d in metrics.report().items() if "total_s" in d}

    def stop(self):
        """Stop the profiler, write its trace and read it back:
        Trace."""
        self._prof.__exit__(None, None, None)
        self._restore()
        os.makedirs(self.outdir, exist_ok=True)
        path = os.path.join(self.outdir, "trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        return Trace(events, self.marks, self.spans,
                     threading.get_native_id())


def union_length(intervals, lo, hi):
    """Length of the union of [start, end) intervals clipped to
    [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi):
    """The [start, end) stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def short_name(name):
    """A device operation's name without its argument list: a kernel's
    function and template arguments; copies and memsets whole."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace(ANON, "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i]
    return name


class Trace:
    """The device intervals of a profiler trace, in microseconds of the
    trace's clock, and the window and host spans on that clock."""

    def __init__(self, events, marks, spans, main_tid):
        self.device = [(e["name"], float(e["ts"]), float(e["ts"])
                        + float(e.get("dur", 0))) for e in events
                       if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        found = sorted(float(e["ts"]) for e in events
                       if e.get("name") == MARKER
                       and e.get("tid") in (main_tid, str(main_tid)))
        if not found:
            found = sorted(float(e["ts"]) for e in events
                           if e.get("name") == MARKER)
        self.aligned = len(found) >= 2 and len(marks) >= 2
        if self.aligned:
            self.w0, self.w1 = found[0], found[-1]
            self.offset = self.w0 - marks[0] * 1e6
        elif self.device:
            self.w0 = min(s for _n, s, _e in self.device)
            self.w1 = max(e for _n, _s, e in self.device)
            self.offset = None
        else:
            self.w0 = self.w1 = 0.0
            self.offset = None
        self.spans = spans

    @property
    def window_s(self):
        return (self.w1 - self.w0) / 1e6

    def busy_s(self):
        """Seconds of the window in which a device operation ran."""
        return union_length([(s, e) for _n, s, e in self.device],
                            self.w0, self.w1) / 1e6

    def kernel_times(self, names):
        """(seconds summed, records) of the device operations in the
        window whose names hold one of `names`."""
        total, n = 0.0, 0
        for name, s, e in self.device:
            if self.w0 <= s < self.w1 and any(k in name for k in names):
                total += e - s
                n += 1
        return total / 1e6, n

    def top_ops(self, k=10):
        """[[name, seconds]] of the device operations that took most time
        in the window, summed by name."""
        acc = collections.Counter()
        for name, s, e in self.device:
            if self.w0 <= s < self.w1:
                acc[short_name(name)] += (e - s) / 1e6
        return [[n, t] for n, t in acc.most_common(k)]

    def idle_gaps(self, k=10):
        """[[label, seconds]] of the longest stretches of the window with
        no device operation, each labelled by the host spans open at its
        middle (the benchmark's and the Collector's, counted by name)."""
        iv = [(s, e) for _n, s, e in self.device]
        longest = sorted(gaps(iv, self.w0, self.w1),
                         key=lambda g: g[0] - g[1])[:k]
        out = []
        for s, e in longest:
            where = f"at +{(s - self.w0) / 1e6:.3f} s"
            if self.offset is None:
                label = "host spans not aligned"
            else:
                mid = ((s + e) / 2 - self.offset) / 1e6
                open_ = collections.Counter(
                    n for n, _tid, a, b in self.spans if a <= mid <= b)
                label = " ".join(f"{n} x{c}" for n, c in
                                 open_.most_common(6)) or "no span open"
            out.append([f"{where}: {label}", (e - s) / 1e6])
        return out
