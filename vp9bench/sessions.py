"""A session: one decoder, one stream of the clip cycled endlessly, and
the benchmark's spans around the calls into the decoder.

Spans recorded here: a packet handed over (thread A of decode_stream
pulls it from the session's generator), a frame yielded, and the frame
complete on the card (the session waits on an event recorded after the
frame's work before it asks for the next frame).

Each output is copied to host memory as soon as its frame is complete,
and hashed only after the window: the card holds what the decoders hold,
not the window's outputs.
"""
from __future__ import annotations

import collections
import threading
import time

import torch

now = time.perf_counter


def frame_output(frame):
    """The frame's three cropped planes at the output depth, joined, as a
    tensor where they lie: the bytes Frame.to_bytes() gives (planar YUV,
    8-bit, or 16-bit little endian above 8 bits)."""
    w, h = frame.size
    cw = (w + frame.ss_h) >> frame.ss_h
    ch = (h + frame.ss_v) >> frame.ss_v
    dt = torch.uint8 if frame.bpp == 8 else torch.int16
    planes = frame.dev if frame.dev is not None else [
        torch.from_numpy(p) for p in frame.crop()]
    return torch.cat([p[:ph, :pw].to(dt).reshape(-1) for p, ph, pw
                      in zip(planes, (h, ch, ch), (w, cw, cw))])


class Session:
    """Decoder `decoder` on the cycle of Packets `cycle`, whose visible
    frames' MD5s are `expected`; the window starts at packet `phase` of
    the cycle. `spans`, if a list, receives (name, thread id, start,
    end) of the waits for a frame and for its completion."""

    def __init__(self, index, decoder, cycle, expected, phase, spans=None):
        self.index = index
        self.decoder = decoder
        self.cycle = cycle
        self.expected = expected
        self.phase = phase
        self.spans = spans
        self.pos = 0           # packets handed to the decoder so far
        self.shown = 0         # frames put out so far
        self.frames = []       # (handed over, completed) in the window
        self.outputs = []      # (frame number, output on the host)
        self.error = None
        cuda = decoder.device.type == "cuda"
        self._event = torch.cuda.Event() if cuda else None
        # the copies to the host go on a stream of their own: PyTorch's
        # side streams do not wait for the legacy default stream, on which
        # every decoder's work is queued
        self._side = torch.cuda.Stream(decoder.device) if cuda else None

    def _complete(self):
        """Wait until the work enqueued so far on this thread's stream is
        done on the card."""
        if self._event is not None:
            self._event.record()
            self._event.synchronize()

    def _keep(self, frame):
        """The output of a frame complete on the card, in host memory."""
        if self._side is None:
            return frame_output(frame)
        with torch.cuda.stream(self._side):
            return frame_output(frame).cpu()

    def warm(self):
        """Decode one cycle and `phase` packets more through
        decode_stream, as set-up: every frame kind of the clip, every
        shape the window will use."""
        n = len(self.cycle) + self.phase
        data = [self.cycle[k % len(self.cycle)].data for k in range(n)]
        for _frame in self.decoder.decode_stream(data):
            self._complete()
            self.shown += 1
        self.pos = n

    def _feed(self, handed, due, stop):
        """Packets from self.pos on, endlessly; the hand-over time of each
        visible one appended to `handed`: when thread A pulls it, or in an
        open loop when it is due (the generator waits until then)."""
        k = 0
        while not stop.is_set():
            pkt = self.cycle[self.pos % len(self.cycle)]
            t = now()
            if due is not None:
                t = due(k)
                wait = t - now()
                if wait > 0:
                    time.sleep(wait)
            if pkt.visible:
                handed.append(t)
            self.pos += 1
            k += 1
            yield pkt.data

    def run(self, go, t_close, due=None):
        """The window: from `go` until the first frame completed after
        t_close (host clock), every frame's times and output."""
        try:
            go.wait()
            handed = collections.deque()
            stop = threading.Event()
            stream = self.decoder.decode_stream(
                self._feed(handed, due, stop))
            tid = threading.get_native_id()
            try:
                t0 = now()
                for frame in stream:
                    t1 = now()
                    self._complete()
                    t2 = now()
                    if self.spans is not None:
                        self.spans.append(("vp9bench.wait_frame", tid, t0, t1))
                        self.spans.append(("vp9bench.complete", tid, t1, t2))
                    self.frames.append((handed.popleft(), t2))
                    self.outputs.append((self.shown, self._keep(frame)))
                    self.shown += 1
                    if t2 > t_close:
                        break
                    t0 = now()
            finally:
                stop.set()
                stream.close()
        except BaseException as e:  # noqa: BLE001 - reported by the harness
            self.error = e
