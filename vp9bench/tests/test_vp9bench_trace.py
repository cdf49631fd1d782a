"""The reduction of a profiler trace: busy time as the union of device
intervals (kernels on several streams overlap), idle gaps labelled by
the host spans open in them, the markers that tie the clocks."""
import pytest

from vp9bench import trace


def ev(name, ts, dur, cat="kernel", tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def test_union_counts_overlap_once():
    assert trace.union_length([(0, 10), (5, 15), (20, 30)], 0, 100) == 25
    assert trace.union_length([(0, 10), (5, 15)], 8, 12) == 4
    assert trace.gaps([(0, 10), (5, 15), (20, 30)], 0, 40) == [
        (15, 20), (30, 40)]


def test_trace_window_busy_and_gaps():
    # markers at 1,000 and 11,000 us (trace clock); host times 5.0, 5.01 s
    events = [ev("cudaDeviceSynchronize", 1000, 5, "cuda_runtime", 7),
              ev("cudaDeviceSynchronize", 11000, 5, "cuda_runtime", 7),
              ev("void (anonymous namespace)::passa_kernel<false, false>"
                 "(int*)", 1000, 4000),
              ev("(anonymous namespace)::mc_kernel((anonymous namespace)"
                 "::Args)", 2000, 1000),
              ev("Memcpy HtoD (Pageable -> Device)", 8000, 1000,
                 "gpu_memcpy"),
              ev("cudaLaunchKernel", 1200, 10, "cuda_runtime", 7)]
    spans = [("stage.a", 3, 5.0055, 5.0075), ("decode.pass_a", 3, 5.005,
                                              5.008)]
    t = trace.Trace(events, [5.0, 5.01], spans, 7)
    assert t.aligned and t.window_s == pytest.approx(0.010)
    assert t.busy_s() == pytest.approx(0.005)
    assert t.kernel_times(("passa_kernel",)) == (pytest.approx(0.004), 1)
    assert [n for n, _s in t.top_ops()] == [
        "passa_kernel<false, false>", "mc_kernel",
        "Memcpy HtoD (Pageable -> Device)"]
    gaps = t.idle_gaps()
    assert [g[1] for g in gaps] == [pytest.approx(0.003),
                                    pytest.approx(0.002)]
    assert "decode.pass_a x1" in gaps[0][0] and "stage.a x1" in gaps[0][0]
    assert "no span open" in gaps[1][0]


def test_unaligned_trace_falls_back_to_the_device_span():
    t = trace.Trace([ev("k", 100, 50), ev("k", 300, 100)], [], [], 1)
    assert not t.aligned and t.window_s == pytest.approx(0.0003)
    assert "not aligned" in t.idle_gaps()[0][0]
