"""Decode CLI — the fftools front-end equivalent
(reference: fftools/ffmpeg.c:963 main; output formats mirror the
framemd5 / rawvideo / yuv4mpegpipe muxers used by FATE).

    python -m ffmpeg_hybrid_tpu_torch IN.ivf|IN.webm
           [-f framemd5|y4m|rawvideo|null|encparams] [-o OUT]
           [--device cuda|cpu] [--no-native] [--no-pipeline]
           [--bsf CHAIN] [--frames N] [-v]

framemd5 output is byte-compatible with `ffmpeg -bitexact -f framemd5`,
so `python -m ffmpeg_hybrid_tpu_torch in.ivf | diff - ref.framemd5` is
the conformance check (only the `#software:` line differs).

Pass B runs on the card unless `--device cpu` is given; without a card
the default raises before any output. Frames are written as the decoder
yields them: a writer thread reads each frame back from the device,
hashes it and writes it while pass B goes on with the next ones, behind
a queue of WRITE_DEPTH frames. So at most WRITE_DEPTH decoded frames
wait on the device for the writer, beside the ones the decoder holds as
references, and device memory stays flat over a clip of any length.
"""
import argparse
import hashlib
import queue
import sys
import threading
import time

# frames decoded and not yet written that the writer's queue may hold
WRITE_DEPTH = 4


def _open_packets(path):
    if path.endswith(".webm") or path.endswith(".mkv"):
        from .formats.webm import read_webm
        return None, read_webm(path)
    from .formats.ivf import read_ivf
    info, pkts = read_ivf(path)
    return info, pkts


def _split(pkts, pts_out):
    """Split superframes; append the pts of every output-producing frame
    (visible or show-existing) to pts_out, so output frame N maps to
    pts_out[N] even through the decode pipeline (the vp9_parser.c role —
    formats/parser.py)."""
    from .formats.parser import parse_frame_flags
    from .formats.superframe import split_superframe
    for pts, data in pkts:
        for spts, d in split_superframe(data, pts):
            try:
                if parse_frame_flags(d).shows:
                    pts_out.append(spts if spts is not None else 0)
            except ValueError:
                pass
            yield spts, d


_TB = {"ivf": (1, 30), "webm": (1, 1000)}  # matching the oracle muxers


def write_framemd5_header(out, w, h, bpp, ss_h, ss_v, tb=(1, 30)):
    out.write("#format: frame checksums\n#version: 2\n#hash: MD5\n"
              "#software: ffmpeg_hybrid_tpu_torch\n"
              f"#tb 0: {tb[0]}/{tb[1]}\n#media_type 0: video\n"
              "#codec_id 0: rawvideo\n"
              f"#dimensions 0: {w}x{h}\n#sar 0: 0/1\n"
              "#stream#, dts,        pts, duration,     "
              "size, hash\n")


class _Writer:
    """Writes output frame n in the chosen format. Frames come in
    order, from one thread."""

    def __init__(self, args, out, info, pts_list):
        self.args, self.out = args, out
        self.info, self.pts_list = info, pts_list
        self.hdr_done = False

    def write(self, n, f):
        args, out = self.args, self.out
        w, h = f.size
        if args.format == "framemd5":
            if not self.hdr_done:
                tb = _TB["webm" if args.input.endswith(
                    (".webm", ".mkv")) else "ivf"]
                write_framemd5_header(out, w, h, f.bpp, f.ss_h, f.ss_v, tb)
                self.hdr_done = True
            raw = f.to_bytes()
            pts_list = self.pts_list
            pts = pts_list[n] if n < len(pts_list) else n
            info = self.info
            if info is not None and info.timebase_num:
                # rescale container pts into the output 1/30 tb,
                # nearest (av_rescale semantics)
                num, den = info.timebase_num, info.timebase_den
                pts = (pts * 30 * den + num // 2) // num
            out.write(f"0, {pts:10d}, {pts:10d},        1, "
                      f"{len(raw):8d}, "
                      f"{hashlib.md5(raw).hexdigest()}\n")
        elif args.format == "y4m":
            if not self.hdr_done:
                c = {(1, 1): "420jpeg", (0, 1): "422",
                     (0, 0): "444", (1, 0): "440"}[(f.ss_h, f.ss_v)]
                out.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A0:0 "
                          f"C{c}\n".encode())
                self.hdr_done = True
            out.write(b"FRAME\n")
            out.write(f.to_bytes())
        elif args.format == "rawvideo":
            out.write(f.to_bytes())
        elif args.format == "encparams":
            from .codecs.vp9.encparams import format_enc_params
            out.write(format_enc_params(n, f.enc_params))


def _write_frames(frames, writer, limit):
    """Hand the frames to a writer thread through a queue of
    WRITE_DEPTH; returns how many were written. The writer's first
    exception is raised here, after the thread has ended."""
    q = queue.Queue(maxsize=WRITE_DEPTH)
    err = []

    def run():
        while True:
            item = q.get()
            if item is None:
                return
            if not err:   # after a failure, drain without writing
                try:
                    writer.write(*item)
                except BaseException as e:  # noqa: BLE001 - re-raised
                    err.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    n = 0
    try:
        for f in frames:
            if err:
                break
            q.put((n, f))
            n += 1
            if limit and n >= limit:
                break
    finally:
        q.put(None)
        th.join()
    if err:
        raise err[0]
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m ffmpeg_hybrid_tpu_torch",
        description="VP9 decoder, PyTorch and CUDA")
    ap.add_argument("input", help="input .ivf / .webm")
    ap.add_argument("-f", "--format", default="framemd5",
                    choices=["framemd5", "y4m", "rawvideo", "null",
                             "encparams"],
                    help="output format (default framemd5; encparams "
                         "dumps per-frame encode-parameters side data "
                         "in the venc_data_dump format)")
    ap.add_argument("-o", "--output", default="-",
                    help="output file (default stdout)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where pass B runs (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--no-native", action="store_true",
                    help="pure-Python pass A (no C fast path)")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="decode serially instead of the 3-stage pipeline")
    ap.add_argument("--bsf", default=None,
                    help="bitstream filter chain, e.g. "
                         "vp9_superframe_split,vp9_raw_reorder or "
                         "vp9_metadata=color_space=bt709:color_range=pc")
    ap.add_argument("--frames", type=int, default=0,
                    help="stop after N output frames")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="per-stream stats on stderr")
    args = ap.parse_args(argv)

    from .codecs.vp9.decoder import VP9Decoder

    # before any output: without a card the default device raises here
    dec = VP9Decoder(device=args.device,
                     use_native=not args.no_native,
                     export_enc_params=args.format == "encparams")
    info, pkts = _open_packets(args.input)
    if args.bsf:
        from .formats.bsf import apply_bsf_chain
        pkts = apply_bsf_chain(pkts, args.bsf)

    binary = args.format in ("y4m", "rawvideo")
    if args.output == "-":
        out = sys.stdout.buffer if binary else sys.stdout
    else:
        out = open(args.output, "wb" if binary else "w")

    pts_list = []
    if args.no_pipeline:
        frames = (f for _pts, data in _split(pkts, pts_list)
                  for f in dec.decode(data))
    else:
        frames = dec.decode_stream(p for _pts, p in _split(pkts, pts_list))
    t0 = time.monotonic()
    try:
        if args.format == "y4m":
            # refused from the first frame's header, before a byte of it
            # is written
            first = next(frames, None)
            if first is not None and first.bpp != 8:
                print("y4m output supports 8-bit only", file=sys.stderr)
                return 1
            frames = _chain([] if first is None else [first], frames)
        n = _write_frames(frames, _Writer(args, out, info, pts_list),
                          args.frames)
    finally:
        frames.close()
        if out not in (sys.stdout, getattr(sys.stdout, "buffer", None)):
            out.close()
    if args.verbose:
        if dec.device.type == "cuda":
            import torch
            torch.cuda.synchronize(dec.device)
        dt = time.monotonic() - t0
        print(f"{n} frames in {dt:.2f}s ({n / dt:.1f} fps, "
              f"device={dec.device})", file=sys.stderr)
    return 0


def _chain(head, rest):
    yield from head
    yield from rest


if __name__ == "__main__":
    sys.exit(main())
