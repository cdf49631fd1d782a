"""The harness's comparison catches a broken timed path: a whole run of
a tiny cell on the CPU (the harness's look for a card skipped), once as
it is and once with each fault the cells can have planted in the port
underneath. The cells run on one card, so there is no exchange between
chips to leave out."""
import time

import pytest
import torch

from vp9bench import harness
from vp9bench_helpers import tiny_bench


def run(tmp_path, sessions=2, seconds=4.0, **mix):
    bench, d = tiny_bench(tmp_path, sessions, **mix)
    return harness.run_cell("tiny.mix", 2**31 + 77, seconds, False,
                            torch.device("cpu"), time.perf_counter(),
                            bench=bench, bench_dir=d)


def test_sound_run_is_correct(tmp_path):
    r = run(tmp_path)
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert {"fps", "frame_p95_ms", "setup_s"} <= set(r["metrics"])


def test_open_loop_run_is_paced_by_its_due_times(tmp_path):
    """Two sessions at 1 frame/s each: at most ~2 frames/s complete."""
    r = run(tmp_path, fps_per_session=1.0)
    assert r["correct"]
    assert 0 < r["metrics"]["fps"]["value"] <= 2.0 + 1e-9


def test_an_altered_answer_is_caught(tmp_path, monkeypatch):
    """One sample of each frame's luma altered where it is produced."""
    from ffmpeg_hybrid_tpu_torch.ops import recon
    real = recon.recon_frame

    def altered(s):
        real(s)
        s.cur_frame_obj.dev[0][0, 0] ^= 1
    monkeypatch.setattr(recon, "recon_frame", altered)
    r = run(tmp_path)
    assert not r["correct"]
    assert r["checks"]["mismatched_frames"]["value"] == r["attempted"]


def test_a_step_that_leaves_its_state_unchanged_is_caught(tmp_path,
                                                          monkeypatch):
    """Inter frames put out their last reference's planes unchanged."""
    from ffmpeg_hybrid_tpu_torch.ops import recon
    real = recon.recon_frame

    def unchanged(s):
        real(s)
        if not (s.header.keyframe or s.header.intraonly):
            ref = s.refs[s.header.refidx[0]]
            s.cur_frame_obj.dev = [p.clone() for p in ref.dev]
    monkeypatch.setattr(recon, "recon_frame", unchanged)
    r = run(tmp_path)
    assert not r["correct"]
    assert r["checks"]["mismatched_frames"]["value"] > 0


def test_half_of_the_sessions_left_out_is_caught(tmp_path, monkeypatch):
    """Every second decoder puts no frame out once set-up is done: half
    of the sessions complete nothing, and the rest alone read sound."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from vp9bench import sessions
    real = VP9Decoder.decode_stream
    made = []

    def half(self, packets):
        if self not in made:
            made.append(self)
        if made.index(self) % 2 and getattr(self, "warm_done", False):
            return
        yield from real(self, packets)
    monkeypatch.setattr(VP9Decoder, "decode_stream", half)
    real_warm = sessions.Session.warm

    def warm(self):
        real_warm(self)
        self.decoder.warm_done = True
    monkeypatch.setattr(sessions.Session, "warm", warm)
    r = run(tmp_path, sessions=4)
    assert not r["correct"]
    assert r["checks"]["idle_sessions"]["value"] == 2
    assert r["checks"]["mismatched_frames"]["value"] == 0


@pytest.mark.parametrize("bits", [8, 10])
def test_the_control_clears_low_bits(bits):
    from vp9bench import control
    x = torch.arange(0, 1 << bits, dtype=torch.int16 if bits > 8
                     else torch.uint8)
    y = control.lower_precision(bits)(x)
    assert (y != x).any()
    assert int((x - y).max()) == (3 if bits == 10 else 1)
