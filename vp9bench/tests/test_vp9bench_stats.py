"""fps and frame_p95_ms over a window, and the seeded phases."""
import types

import pytest

from vp9bench import mixes, registry, stats


def steady(t0, t1, rate, latency):
    """Frames completing every 1/rate s in [t0, t1), each `latency`
    after its hand-over."""
    n = int(round((t1 - t0) * rate))
    return [(t0 + i / rate - latency, t0 + i / rate) for i in range(n)]


def test_a_stall_moves_both_fps_and_p95():
    base = steady(0.0, 30.0, 20.0, 0.100)
    assert stats.fps(base, 0.0, 30.0) == pytest.approx(20.0)
    assert stats.latency_p95_ms(base, 0.0, 30.0) == pytest.approx(100.0)
    # a 3 s stall at 10 s: every later frame completes 3 s later, so
    # 541 of the 600 complete inside the window, 341 of them late
    late = [(a, b + 3.0) if b >= 10.0 else (a, b) for a, b in base]
    assert stats.fps(late, 0.0, 30.0) == pytest.approx(541 / 30)
    assert stats.latency_p95_ms(late, 0.0, 30.0) == pytest.approx(3100.0)


def test_traced_p95_reader_reads_the_window_and_nothing_when_empty():
    read = registry.reader("traced_frame_p95_ms")
    frames = steady(0.0, 30.0, 20.0, 0.100)
    ctx = types.SimpleNamespace(frames=frames, t_open=0.0, t_close=30.0)
    assert read(ctx) == pytest.approx(
        stats.latency_p95_ms(frames, 0.0, 30.0))
    ctx = types.SimpleNamespace(frames=frames, t_open=40.0, t_close=50.0)
    assert read(ctx) is None


def test_window_counts_only_frames_completed_inside_it():
    frames = [(0.0, 0.5), (0.2, 1.0), (1.0, 2.5), (2.0, 3.01)]
    assert stats.window_frames(frames, 1.0, 3.0) == [(0.2, 1.0), (1.0, 2.5)]


def test_percentile_matches_linear_interpolation():
    xs = [float(i) for i in range(1, 101)]
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([7.0], 95) == 7.0


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**31 + 12345, 2**40])
def test_phases_are_deterministic_and_spread_alike(seed):
    mix = {"sessions": 8, "phase": "spread"}
    a = mixes.phases(mix, seed, 4)
    assert a == mixes.phases(mix, seed, 4)
    assert sorted(a) == [0, 0, 1, 1, 2, 2, 3, 3]
    one = mixes.phases({"sessions": 1}, seed, 4)
    assert len(one) == 1 and 0 <= one[0] < 4
    assert len(set(mixes.phases({"sessions": 3, "phase": "aligned"},
                                seed, 4))) == 1


def test_phases_differ_between_seeds():
    mix = {"sessions": 8, "phase": "spread"}
    assert len({tuple(mixes.phases(mix, s, 4)) for s in range(20)}) > 5
    with pytest.raises(ValueError):
        mixes.phases({"sessions": 2, "phase": "bursty"}, 1, 4)


def test_open_loop_due_times():
    assert mixes.due_times({"sessions": 1}, 5.0) is None
    due = mixes.due_times({"sessions": 1, "fps_per_session": 30}, 5.0)
    assert due(0) == 5.0 and due(30) == pytest.approx(6.0)
