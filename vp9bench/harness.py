"""One run of one cell: set-up (the port's libraries, the clip, a decoder
and a warm cycle a session), the measured window, the traced window's
readings, and the comparison that decides `correct`.

Set-up runs from process start to the window's opening. The window
drives each session's decode_stream on a thread of its own; a session's
frame counts when it is complete on the card inside the window.
"""
from __future__ import annotations

import gc
import shutil
import sys
import tempfile
import threading
import time
import types

import torch

from vp9bench import check, ivf, mixes, passb_bytes, registry, stats
from vp9bench.sessions import Session

now = time.perf_counter
# top-level module names that no run may have loaded: JAX and the JAX
# package the port was made from (compared whole: the port's own name
# begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "ffmpeg_hybrid_tpu")
# longest the harness waits past the window's close for a session's
# frame in flight; a session still waiting then counts as stalled
JOIN_S = 60.0


def forbidden_modules():
    """Top-level names of loaded modules that are in FORBIDDEN."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def say(msg):
    print(f"[vp9bench] {msg}", file=sys.stderr, flush=True)


def _threads(target, sessions):
    ts = [threading.Thread(target=target, args=(s,), daemon=True)
          for s in sessions]
    for t in ts:
        t.start()
    return ts


def _warm(sessions):
    """The first session's warm cycle alone (first calls, lazy tables),
    then the others' side by side."""
    sessions[0].warm()
    errors = []

    def one(s):
        try:
            s.warm()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
    for t in _threads(one, sessions[1:]):
        t.join()
    if errors:
        raise errors[0]


def _window(sessions, mix, seconds, tracer, device):
    """Open the window once every session is warm, let each session run
    on a thread of its own for `seconds`, and wait up to JOIN_S past the
    close for their frames in flight. Returns (t_open, t_close, the
    sessions still waiting)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    go = threading.Event()
    t_open = tracer.mark() if tracer is not None else now()
    if tracer is not None:
        tracer.reset_collector()
    t_close = t_open + seconds
    due = mixes.due_times(mix, t_open)
    runners = _threads(lambda s: s.run(go, t_close, due), sessions)
    go.set()
    time.sleep(max(0.0, t_close - now()))
    if tracer is not None:
        tracer.mark()
    for t in runners:
        t.join(max(0.0, t_close + JOIN_S - now()))
    stalled = [s for s, t in zip(sessions, runners) if t.is_alive()]
    for s in stalled:
        say(f"session {s.index} stalled: no frame {JOIN_S} s past the "
            "window's close")
        s.frames, s.outputs = list(s.frames), list(s.outputs)
    for s in sessions:
        if s.error is not None:
            raise s.error
    return t_open, t_close, stalled


def _passb_bytes(cfg, cycle, expected, device):
    """The bytes pass B's kernels need for a frame, the mean over the
    clip's cycle, counted on a fresh decoder after the window; None off
    the card."""
    if device.type != "cuda":
        return None
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    dec = VP9Decoder(device=device, pass_a_impl=cfg["pass_a_impl"])
    frames = passb_bytes.capture(dec, [p.data for p in cycle])
    return sum(sum(f.values()) for f in frames) / len(expected)


def _per_layer(tr, collector, per_layer, bench_dir, passb, frames, t_open,
               t_close):
    """{metric: value or None} of each per-layer metric's reader."""
    ctx = types.SimpleNamespace(trace=tr, collector=collector,
                                passb_bytes=passb, frames=frames,
                                t_open=t_open, t_close=t_close)
    return {m["name"]: registry.reader(m["name"], bench_dir)(ctx)
            for m in per_layer}


def run_cell(workload, seed, seconds, trace, device, t_start, *,
             bench=None, bench_dir=registry.BENCH_DIR, root=registry.ROOT,
             output_hook=None):
    """Run cell `workload` on `device` for a window of `seconds`; returns
    the result line's dict. t_start: the host time the process started.
    output_hook, if given, is applied to each output before it is kept
    (the control's lower precision)."""
    bench = registry.benchmark(root) if bench is None else bench
    w, end_to_end, per_layer = registry.cell(bench, workload)
    cfg = registry.config(w["config"], bench_dir)
    mix = registry.traffic(w["traffic"], bench_dir)
    _size, cycle = ivf.read_clip(registry.resolve(cfg["clip"], root))
    expected = ivf.read_framemd5(registry.resolve(cfg["framemd5"], root))
    if sum(p.visible for p in cycle) != len(expected):
        raise ValueError(f"{cfg['clip']}: {sum(p.visible for p in cycle)} "
                         f"frames put out a cycle, {len(expected)} rows in "
                         f"{cfg['framemd5']}")
    phases = mixes.phases(mix, seed, len(cycle))
    say(f"{workload}: {len(phases)} sessions, phases {phases}, seed {seed}")

    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu_torch.utils.metrics import metrics
    cuda = device.type == "cuda"
    if cuda:
        from ffmpeg_hybrid_tpu_torch import _build
        _build.build_all()
    metrics.disable()
    tracer = None
    spans = None
    if trace:
        from vp9bench.trace import Tracer
        tracer = Tracer(tempfile.mkdtemp(prefix="vp9bench-trace-"))
        spans = tracer.spans
    sessions = [Session(i, VP9Decoder(device=device,
                                      pass_a_impl=cfg["pass_a_impl"]),
                        cycle, expected, ph, spans)
                for i, ph in enumerate(phases)]
    _warm(sessions)
    if tracer is not None:
        tracer.start()
    t_open, t_close, stalled = _window(sessions, mix, seconds, tracer, device)
    if output_hook is not None:
        for s in sessions:
            s.outputs = [(n, output_hook(o)) for n, o in s.outputs]

    frames = [f for s in sessions for f in s.frames]
    done = stats.window_frames(frames, t_open, t_close)
    # the decoders' own peak over the window: the outputs were copied to
    # the host as they came (Session._keep)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    host_frames = sum(s.decoder.pass_a_host_frames for s in sessions)
    say(f"pass_a_host_frames={host_frames} (frames the device pass A sent "
        f"to the host pass A, set-up included); frames in the window "
        f"{len(done)}")
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else "cpu", "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    if tracer is None:
        values = {"setup_s": t_open - t_start,
                  "fps": stats.fps(frames, t_open, t_close)}
        if done:
            values["frame_p95_ms"] = stats.latency_p95_ms(frames, t_open,
                                                          t_close)
        wanted = end_to_end
    else:
        tr = tracer.stop()
        shutil.rmtree(tracer.outdir, ignore_errors=True)
        values = _per_layer(tr, tracer.collector(), per_layer, bench_dir,
                            _passb_bytes(cfg, cycle, expected, device),
                            frames, t_open, t_close)
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        say(f"trace: {len(tr.device)} device records, aligned={tr.aligned}")
        wanted = per_layer
    result_metrics = {m["name"]: {"value": values[m["name"]],
                                  "unit": m["unit"]}
                      for m in wanted if values.get(m["name"]) is not None}

    # the program's state freed before the comparison
    for s in sessions:
        if s not in stalled:
            s.decoder = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = check.compare(sessions, t_open, t_close, len(stalled))
    result = {"correct": check.passed(checks),
              "attempted": sum(len(s.frames) for s in sessions),
              "failed": checks["mismatched_frames"][0],
              "metrics": result_metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result
