#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ffmpeg_hybrid_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, one status line each; any failure exits non-zero:
  1. card      name, power limit, torch and CUDA versions
  2. build     the CUDA kernels (nvcc, sm_90a) and the native pass A
  3. kernels   each kernel against its plain PyTorch version on the
               card:
               - decode_bits_multi / decode_tree_multi on seeded
                 streams, S = 64 lanes (the stream path), and on their
                 edges (every VP9 tree, the depth cap, overread, L not a
                 multiple of 4, probabilities 0, 1 and 255, a first byte
                 0xff, rows at every byte alignment); the longest lane's
                 cycles a bool in the kernel beside its chain alone, and
                 ptxas's registers and spills;
               - decode_coeffs_multi on every coefficient block of
                 bench_1080p frame 0, captured by the port's
                 pure-Python pass A, every lane in one launch (the
                 coefficient path), also against the host
                 coefficients and eob; its time on the card's clock and
                 under CUDA events, and the cycles a bool of its longest
                 lane takes alone (a clock64 loop), a second chain
                 bound;
               with times, launches and token rates beside the native
               C pass A's rate on the same frame;
               - lf_frame_ (csrc/lpf.cu) on the whole of
                 bench_1080p_lf frame 0: its Y and U+V planes as
                 reconstructed before the loop filter, and their grids,
                 both sets in one launch and each set alone (us per
                 wave); then the race stress: 50 launches on those
                 inputs, 10 on a full-size random-grid frame with every
                 edge position active and 10 on one at 10 bpp, each
                 bit-exact;
               - the coefficient scatter and residual_planes
                 (csrc/itxfm.cu: the scatter, into fresh buffers with a
                 memset pair and into the buffers recon_frame keeps from
                 frame to frame with none, then the three planes'
                 residuals in one launch that clears what it read, so
                 the kept buffers read zero after it) on the pair rows
                 and grids of bench_1080p frames 0 (a keyframe) and 1
                 (an inter frame) and bench_1080p_lf frame 0, as
                 recon_frame hands them over, and on a seeded full-size
                 lossless frame;
               - residual_planes_hbd (csrc/itxfm.cu's 10/12-bit kernel:
                 float64 butterflies on int32 coefficients) with the
                 wide scatter before it, on frame 0 of fmt_420_10_1080p
                 and fmt_444_12_1080p as recon_frame hands them over and
                 on a seeded full-size 12-bit 4:4:4 frame whose
                 coefficients reach the int32 extremes; the kept buffers
                 read zero after each; with its coded roots by size and
                 ptxas's registers and spills;
               - mc_planes (csrc/mc.cu: the inter pass of the three
                 planes in one launch) on bench_1080p frames 1-2's own
                 inputs, and on two seeded full-size frames with MVs
                 out to 150 px, every filter bank and out-of-range
                 values in the cells that are not inter: one motion a
                 cell, every inter cell compound; one motion a tile,
                 every phase, compound cells sharing reference 1's;
                 each timed, with the share of its tiles that take the
                 window path; then such frames at 10 and 12 bpp under
                 4:2:2, 4:4:0, 4:4:4 and 4:2:0 MV scales (MC_FORMATS);
               - mc_planes_scaled (csrc/mc.cu's scaled entry: the inter
                 pass of a frame with a reference of another size, the
                 three planes in one launch) on resize_1080p frames 1-5
                 as recon_frame hands them over (with the splat's index
                 as that frame left it), and on seeded 1920x1080 frames
                 whose records the splat kernel indexes: references at
                 2x down (step 32), the frame's size and 1.5x down, or
                 at 16x up (step 1), the frame's size and 2x up; every
                 filter bank, half the cells compound, so that compound
                 cells mix a scaled and a same-size slot; at 8 bpp 4:2:0
                 and at MC_FORMATS' depths and layouts; and a frame of
                 32x32 blocks, a motion a 16x16 tile, at steps 32, 8 and
                 1; each with the share of its tile passes on the window
                 path, as the kernel's warps count them on the card
                 (which must equal the host model's, mc_scaled_paths;
                 the seeded frames of random blocks must take both
                 paths, the frame of 32x32 blocks the window path alone)
                 and ptxas's registers and spills;
               - _intra_scan_planes (csrc/intra.cu) on the planes,
                 residuals and slabs of bench_1080p_lf frame 0 and
                 bench_1080p frame 0 (a keyframe), Y, U and V in one
                 launch as recon_frame hands them over, with each
                 plane's time alone (us per level) and the windows each
                 level took; then with U's slab spread to more rows per
                 level than a window holds, so that every level of U
                 spans two windows or more;
               - _grids_from_records (csrc/splat.cu) on the records of
                 bench_1080p frames 0-1, bench_1080p_lf frame 0 and
                 bench_4k frame 1 as recon_frame hands them over, then
                 on those records with MVs drawn from a seed under the
                 three other chroma subsamplings, all 14 grids bit for
                 bit with dtypes;
               - grids_device (csrc/lf_grids.cu) on the levels and masks
                 of bench_1080p_lf frame 0 and bench_4k frame 0 under
                 all four subsamplings;
               - on frame 0 of each format clip (tools/
                 make_format_vectors_torch.py: 4:2:2, 4:4:0, 4:4:4 at 8
                 bits, 4:2:0 at 10, 4:4:4 at 12), as recon_frame hands
                 them over: the splat, the loop-filter grids, the loop
                 filter, the intra wavefront and, at 8 bits, the scatter
                 and the consuming residual;
               each with its time, bound terms and the plain version's
               time on the same inputs (the last two timed on the card's
               clock with torch.profiler, since their wrappers' host
               work outlasts their kernels, with their device ops per
               call, beside an empty kernel's time in the same harness:
               the launch floor; each profiled reading scaled by the
               kernels launched over the records the profiler kept)
  4. decode    each clip through VP9Decoder(device="cuda")
               .decode_stream, every MD5 against its framemd5: all 30
               frames of vectors/bench_1080p.ivf (no loop filter: the
               loop-filter kernel must not launch), all 6 of
               vectors/bench_1080p_lf.ivf (every frame filtered: it
               must, once per frame, as must the loop-filter grids
               kernel) and all 12 of vectors/bench_4k.ivf (3840x2160;
               its keyframe filtered); the scatter, residual and splat
               kernels must launch once per frame, the MC kernel once
               per frame with inter blocks, the intra kernel once per
               frame with intra blocks; then five timed pipelined passes
               (median fps and its spread, and beside each pass its host
               pass A and pass B ms per frame from the unsynchronised
               stage timers) and a serial pass with the stage timers
               synchronised to the card (per-stage times and the intra
               levels per frame), after each frame of which the kept
               coefficient buffers must read zero; no kept buffer may
               need a zero-fill in the whole phase; then the five
               format clips (two filtered keyframes each) the same way,
               with three timed passes: the high-bit-depth residual must
               launch once per frame of the 10/12-bit clips and the
               8-bit one never there; then vectors/resize_1080p.ivf
               (tools/make_resize_vector_torch.py: 1920x1080, 1280x720,
               960x540, 1920x1080 twice, 960x540, each inter frame from
               a reference of another size) the same way: the scaled MC
               kernel once per inter frame, the unscaled one never, three
               kept coefficient buffer sets and three splat states for
               its three sizes (a size returned to reuses its own), the
               peak device memory over its passes and the card's busy
               share in a serial decode under torch.profiler; then the
               five inter clips of profiles 1-3 (tools/
               make_format_inter_vectors_torch.py: 1080p, 4 tiles, a
               keyframe, a lossless inter frame with every inter syntax
               element and two lossy filtered ones with every transform
               size, at 4:2:2, 4:4:0, 4:4:4, 10-bit 4:2:0 and 12-bit
               4:4:4) the same way, MC once per inter frame, the loop
               filter once per filtered frame (3 of 4). In every clip's
               conformance pass each frame's three visible planes also
               go through the digest (csrc/digest.cu, utils/digest.py:
               two mod-2^32 weighted sums a plane, a frame's three
               planes in one launch of frame_digest, flushed in one
               copy), held to its plain version on the
               card and to plane_digest_host on the frame's bytes; its
               time on the three planes of fmt_inter_444_12_1080p's last
               frame beside its bound and the plain version's
  4b. passa    the on-device pass A (csrc/passa.cu via
               ops/passa_device.py): the walk kernel against
               decode_frame_plain (run on the host CPU) on every intra
               frame of the vectors/passa_* clips
               (tools/make_passa_vectors_torch.py) and every frame of
               the vectors/passa_inter_* clips
               (tools/make_passa_inter_vectors_torch.py) with the symbol
               counts forced on, every output exact, the MV and
               reference grids too; against the native C pass A on
               frame 0 of bench_1080p_lf and each format clip and on
               every inter frame of bench_1080p, bench_4k, resize_1080p
               and the five inter format clips (dense coefficient planes,
               eob grids,
               records, and the grids against cur_mv and cur_ref), each
               inter frame from a decoder run through the frames before
               it; against decode_frame_plain on frame 0 of
               PASSA_PLAIN_CLIPS and on PASSA_INTER_PLAIN (bench_1080p
               frames 1 and 6, resize_1080p frame 4, and an inter frame
               of each inter format clip with the symbol counts forced
               on); timed on those keyframes and on PASSA_INTER_TIMED
               (bench_1080p frames 1 and 6, bench_4k frame 1,
               resize_1080p frames 3 and 4, the inter format frames):
               the time under CUDA events, the bools a lane, the longest
               lane's cycles a bool (clock64) beside the bool chain's
               73.5, the MV quanta's cycles an inter block, the longest
               lane's debug sections (decode_frame_sections, the
               instance that times them, its outputs held to the
               kernel's), bytes and chain bounds and the native pass
               A's time on the same frame; ptxas's registers, stack and
               spills of the kernel's four instances; then
               VP9Decoder(device="cuda", pass_a_impl="device")
               .decode_stream over all fourteen clips with every plain
               version set to raise, every MD5 against its framemd5, the
               walk once a frame and no frame through the host pass A
               (each decoder's pass_a_host_frames); a serial decode of
               bench_1080p_lf with every stage timer synchronised; fps
               with the device pass A and with the host's in turns on
               the fourteen clips, with decode.pass_a, decode.pass_a_replay,
               decode.pass_b and upload.flat ms/frame
  5. threads   two decoders of one geometry on two host threads at once,
               every frame bit-exact (each decoder owns its splat state)
  6. gop       GOP-parallel decode (parallel/gop.py), a worker's decoder
               on its own CUDA stream: two decoders on two streams
               interleaved frame by frame on bench_1080p_lf (each with
               its own loop-filter schedule states); decode_gops_parallel
               with 1, 2 and
               4 workers on bench_1080p_lf (6 GOPs), each format clip (2
               GOPs), bench_1080p three times over (9 GOPs) and
               fmt_inter_422_1080p and fmt_inter_444_12_1080p twice over
               (2 GOPs each), every
               frame bit-exact vs framemd5 with the plain versions set to
               raise; each input's wall fps, host pass A ms/frame and the
               card's busy share (torch.profiler) per worker count;
               decode_gops_md5_multiprocess in 2 spawned processes on
               bench_1080p_lf; a GOP cut short raising ValueError at its
               place with every worker joined
  7. sharded   the tile-sharded pass B (parallel/fullframe.py), every
               frame bit-exact vs framemd5, the outputs installed as the
               frames' planes: bench_1080p_lf on a (1, 4) mesh, the first
               6 frames of bench_1080p (MC with stripe offsets),
               fmt_420_10_1080p, fmt_444_1080p and
               fmt_inter_444_12_1080p, resize_1080p (its
               4-tile frames sharded, the others serial), bench_1080p_lf
               on (2, 4) with two frames a step, bench_4k frame 0 on (1,
               8); the kept coefficient buffers read zero after every
               sharded frame; the launches counted from zero (the replay
               kernel, csrc/lpf_replay.cu, twice a filtered sharded
               frame); then the replay kernel on bench_1080p_lf and
               bench_4k frame 0's own replay inputs against
               lf_scan_sharded_plain, and with one stripe on the serial
               schedule against lf_scan_plain, its time on the card's
               clock beside csrc/lpf.cu's on the same frame, the host
               time to build its superblock tickets, the chain alone (the
               same tickets with every record a no-op), its bound terms
               and ptxas's registers, stack and spills
  7b. gop_pipeline
               the chained-GOP stripe pipeline (parallel/gop_pipeline.py)
               on vectors/chained_1080p.ivf (tools/
               make_chained_vectors_torch.py: a 1080p keyframe and four
               chained, filtered inter frames): decode_chained_gop on a
               [4, 1] mesh of the one card, 17 stripes of 64 rows at a
               lag of 2, on the main path (launches from zero, the plain
               versions set to raise): every frame's MD5 against the
               framemd5 and its coded area against the serial decode of
               the same call; mc_planes launched once a frame's stripe and
               lf_replay once a band of Y and of U+V with a record, as the
               schedule gives, no kernel off the path; the run alone under
               CUDA events after a warm-up beside the serial
               decode_pass_b of the same frames, the replay's steps a
               band and one band's time (us a record); the dry runs
               (parallel/dryrun.py: dryrun_multichip(8),
               dryrun_gop_pipeline(4)); decode_chained_gop on
               vectors/dryrun_chained.ivf on the card equal to the CPU's
               (the plain versions) on the whole padded planes
  7c. mesh_mp  the mesh whose tile axis crosses processes (parallel/
               dist.py, decode_mesh_multiprocess): two spawned gloo ranks
               sharing the card, each with its slots of the mesh, on the
               main path (launches from zero in each rank, the plain
               versions set to raise there): dryrun_mesh_2x4 on [2, 4]
               split 2+2, all frames; bench_1080p_lf on (1, 4) split
               2+2, all 6 frames; bench_4k frame 0 on (1, 8) split 4+4;
               bench_1080p frames 0-5 on (1, 4) split 2+2, chained. Every
               gathered frame's MD5 against the clip's framemd5; in each
               rank the lf_replay launches equal its plans' segments and
               its swaps its cross-rank steps plus the first ones; each
               rank's ms a frame (CUDA events), replay ms, swap ms and
               bytes, gather ms, segments and launches a frame; each
               rank's segments of bench_1080p_lf and bench_4k frame 0
               alone in this process (rank 0's of bench_1080p_lf held to
               the plain version) beside one launch of its stripes;
               whether gloo's send and receive take CUDA tensors (two
               spawned processes, not gated); "nccl" on the shared card
               raising before any rank starts
  8. cli       the command line, `python -m ffmpeg_hybrid_tpu_torch`, on
               the card with every plain version set to raise:
               - a shell run on vectors/bench_1080p.ivf, its rows from
                 the data rows down equal to the framemd5's;
               - main(argv) in this process on each of the fourteen
                 clips,
                 its rows equal to the framemd5's and its kernel
                 launches equal to the decode phase's for that clip;
               - bench_1080p and resize_1080p remuxed to WebM (as
                 SimpleBlocks and xiph-laced): the IVF's (size, md5)
                 pairs, and the timecodes written as pts;
               - -f rawvideo of bench_4k and -f y4m of bench_1080p, each
                 frame's bytes hashing to its framemd5 row, and --bsf
                 vp9_superframe_split,vp9_raw_reorder on bench_1080p;
               - checkpoint resume: bench_1080p after frame 10 and
                 resize_1080p after frame 3, state_dict loaded into a
                 fresh decoder on the card, every MD5 as the framemd5;
               - flat device memory: the peak allocated over a run of
                 all 30 bench_1080p frames within CLI_MEM_SLACK of the
                 peak over --frames 10;
               - the CLI's wall fps on bench_1080p with -f null and -f
                 framemd5 (median of three runs), beside the decode
                 phase's, not gated
  9. a JSON line {"kernels": [...]} and the card line, then the result
     line {"ok": true, "device": {...}}

The script needs the repository around it and a CUDA device; without
either it exits non-zero and prints no result.
"""
import contextlib
import gc
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CLIPS = ("bench_1080p", "bench_1080p_lf", "bench_4k")
# VP9 profiles 1-3 at 1080p (tools/make_format_vectors_torch.py): two
# filtered keyframes each; name: (bpp, ss_h, ss_v)
FORMAT_CLIPS = {"fmt_422_1080p": (8, 1, 0), "fmt_440_1080p": (8, 0, 1),
                "fmt_444_1080p": (8, 0, 0), "fmt_420_10_1080p": (10, 1, 1),
                "fmt_444_12_1080p": (12, 0, 0)}
HBD_CLIPS = ("fmt_420_10_1080p", "fmt_444_12_1080p")
# inter frames of profiles 1-3 at 1080p
# (tools/make_format_inter_vectors_torch.py): a keyframe, a lossless inter
# frame with every inter syntax element, two lossy filtered ones with
# every transform size; name: (bpp, ss_h, ss_v)
FORMAT_INTER_CLIPS = {"fmt_inter_422_1080p": (8, 1, 0),
                      "fmt_inter_440_1080p": (8, 0, 1),
                      "fmt_inter_444_1080p": (8, 0, 0),
                      "fmt_inter_420_10_1080p": (10, 1, 1),
                      "fmt_inter_444_12_1080p": (12, 0, 0)}
# every clip whose residual is the high-bit-depth kernel's
HBD_ALL = HBD_CLIPS + tuple(c for c, (bpp, _h, _v)
                            in FORMAT_INTER_CLIPS.items() if bpp > 8)
PKG = "ffmpeg_hybrid_tpu_torch"
KERNEL_SRC = PKG + "/csrc/rac.cu"
PALLAS_SRC = "ffmpeg_hybrid_tpu/ops/rac_pallas.py"
LPF_SRC = PKG + "/csrc/lpf.cu"
LPF_REPLACES = "ffmpeg_hybrid_tpu/ops/lpf_dense.py:77"
ITXFM_SRC = PKG + "/csrc/itxfm.cu"
ITXFM_REPLACES = "ffmpeg_hybrid_tpu/ops/recon_tpu.py:54"
SCATTER_REPLACES = "ffmpeg_hybrid_tpu/ops/recon_tpu.py:1037"
MC_SRC = PKG + "/csrc/mc.cu"
MC_REPLACES = "ffmpeg_hybrid_tpu/ops/recon_tpu.py:131"
# _mc_cells_mixed, with _mc_ref_scaled, _mulshift14, _mc_one_ref_unscaled
# and _scaled_anchor_grids (204-442) and the apply (1851-1884)
MC_SCALED_REPLACES = "ffmpeg_hybrid_tpu/ops/recon_tpu.py:352"
# the resize clip (tools/make_resize_vector_torch.py): every inter frame
# predicts from a reference of another size
RESIZE_CLIP = "resize_1080p"
# the decode phase's clips, in its order
DECODE_CLIPS = CLIPS + tuple(FORMAT_CLIPS) + (RESIZE_CLIP,) \
    + tuple(FORMAT_INTER_CLIPS)
INTRA_SRC = PKG + "/csrc/intra.cu"
INTRA_REPLACES = "ffmpeg_hybrid_tpu/ops/recon_tpu.py:706"
SPLAT_SRC = PKG + "/csrc/splat.cu"
SPLAT_REPLACES = "ffmpeg_hybrid_tpu/ops/recon_tpu.py:873"
LF_GRIDS_SRC = PKG + "/csrc/lf_grids.cu"
LF_GRIDS_REPLACES = "ffmpeg_hybrid_tpu/ops/lpf_masks.py:172"
# loop-filter launches of the conformance passes, of the filter and of
# its grids: one per filtered frame (Y and U+V in one launch)
LF_LAUNCHES = {"bench_1080p": 0, "bench_1080p_lf": 6, "bench_4k": 1,
               **dict.fromkeys(FORMAT_CLIPS, 2), RESIZE_CLIP: 6,
               **dict.fromkeys(FORMAT_INTER_CLIPS, 3)}
SUBSAMPLINGS = ((1, 1), (1, 0), (0, 1), (0, 0))
# race stress of the loop-filter kernel: launches on bench_1080p_lf frame
# 0's inputs, on a full-size random-grid frame, and on one at 10 bpp
LF_STRESS = (50, 10, 10)

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s;
# int32 outside the tensor cores, 64 lanes per SM against float32's 128
# (Hopper whitepaper), so half of the 67e12 float32 rate, counted the
# same way (a multiply-add as two operations): every kernel here does
# integer work; the boost clock for the serial-chain bound
HBM_BPS = 3.35e12
INT32_OPS = 33.5e12
BOOST_HZ = 1.98e9
SEED = 20261016
# integer operations of one lane's loop-filter edge decision (fm: seven
# differences, absolutes and compares, the weighted p0/q0 term, the ands)
LF_DECISION_OPS = 30
# integer operations of one cell's splat thread, a floor: its quadrant
# (4), mode and transform type (4), the inter, comp and ref tests and
# clamps (8)
SPLAT_CELL_OPS = 16
# integer operations of one loop-filter grid quad's thread, a floor: its
# superblock and position (4), three mask bits (6), the width (2)
LF_GRID_OPS = 12
# integer operations of one scatter row's thread, a floor: its position
# (3), the two bounds tests (2)
SCATTER_ROW_OPS = 5
# multiply-adds of one cell's MC for one reference: 11 x 4 horizontal
# values and 4 x 4 vertical ones, 8 taps each
MC_CELL_MACS = 480
# bytes of one cell's grids that MC reads: inter4 and comp (bool), filt
# (int32), refsel (2 x int32), mv16 (4 x int32)
MC_CELL_BYTES = 30
DEVICE = "cuda"
DIGEST_SRC = PKG + "/csrc/digest.cu"
# _make_digest, a jitted XLA program (no Pallas kernel)
DIGEST_REPLACES = "ffmpeg_hybrid_tpu/utils/digest.py:68"
# integer operations of one pixel's digest: W (2 multiply-adds), the two
# products, the xor and multiply of d2's weight, two adds, the load's
# address
DIGEST_PIXEL_OPS = 10
# the frame the digest is timed on: the last of this clip (three planes)
DIGEST_TIMED = "fmt_inter_444_12_1080p"
# MC on seeded full-size frames of other depths and layouts: (bpp, ss_h,
# ss_v), every bpp and every chroma layout at least once
MC_FORMATS = ((10, 1, 0), (12, 0, 0), (10, 0, 1), (12, 1, 1))
# each 64-bit butterfly operation of the high-bit-depth residual counted
# as this many int32 operations (a 64-bit add is two, a 64-bit product of
# a 32-bit constant two or more)
HBD_OP_WORDS = 2
# timed pipelined passes over the clip (the fps is their median)
WINDOWS = 5
# the CLI phase: the most the peak device memory of a run over all of
# bench_1080p may exceed that of a run over its first CLI_MEM_FRAMES
CLI_MEM_SLACK = 64 << 20
CLI_MEM_FRAMES = 10
# checkpoint resume: the frames decoded before the state is taken
RESUME_AT = {"bench_1080p": 10, RESIZE_CLIP: 3}
# timed in-process CLI runs a format (the fps is their median)
CLI_RUNS = 3
# runs under torch.profiler while a device record is missing, and the
# least share of the launches whose records the best run must keep
PROFILE_TRIES = 3
PROFILE_KEPT = 0.5
# launches in one profiled run of a single-launch call: the profiler lost
# 9-11 device records of each run whatever its length (41 of 50, 11 of
# 20, 9 of 20 on an H100), so runs of 20 fell to PROFILE_KEPT
PROFILE_REPS = 50
# pad launches before and after the body of each profiled run: the
# profiler dropped the device records of the first kernels of a profile
# (4 of 12 kept, 9 of 20) late in a long run (profiled)
PROFILE_PAD = 32
# the gop phase: worker counts of decode_gops_parallel, spawned processes
# of decode_gops_md5_multiprocess
GOP_WORKERS = (1, 2, 4)
GOP_PROCS = 2
# inter clips of profiles 1-3 the gop phase decodes twice over
GOP_INTER_CLIPS = ("fmt_inter_422_1080p", "fmt_inter_444_12_1080p")
# the sharded phase: (label, clip, frames (None: all), mesh (gop, tile),
# frames a step (one a gop row), the tile count of the frames it shards
# (None: every frame; the others decode serially))
SHARDED_RUNS = (
    ("bench_1080p_lf", "bench_1080p_lf", None, (1, 4), 1, None),
    ("bench_1080p", "bench_1080p", 6, (1, 4), 1, None),
    ("fmt_420_10_1080p", "fmt_420_10_1080p", None, (1, 4), 1, None),
    ("fmt_444_1080p", "fmt_444_1080p", None, (1, 4), 1, None),
    ("fmt_inter_444_12_1080p", "fmt_inter_444_12_1080p", None, (1, 4), 1,
     None),
    (RESIZE_CLIP, RESIZE_CLIP, None, (1, 4), 1, 4),
    ("bench_1080p_lf 2 a step", "bench_1080p_lf", None, (2, 4), 2, None),
    ("bench_4k", "bench_4k", 1, (1, 8), 1, None),
)
# the gop_pipeline phase (parallel/gop_pipeline.py): the 1080p chained
# clip (tools/make_chained_vectors_torch.py) on a [PIPE_G, 1] mesh, stripes
# of PIPE_HS rows at a lag of PIPE_LAG steps, PIPE_REPS timed runs after a
# warm-up; the dry runs (parallel/dryrun.py) on DRYRUN_SLOTS slots and
# PIPE_G gop rows
CHAINED_CLIP = "chained_1080p"
PIPE_G, PIPE_HS, PIPE_LAG, PIPE_REPS = 4, 64, 2, 3
DRYRUN_SLOTS = 8
# kernels-line entries and their launch counters on the pipeline's path
PIPE_KERNELS = {"_grids_from_records": "splat", "scatter_coef": "scatter",
                "residual_planes": "residual", "mc_planes": "mc",
                "_intra_scan_planes": "intra", "grids_device": "lf_grids",
                "lf_dense": "lf_dense", "lf_replay": "lf_replay"}
PASSA_SRC = PKG + "/csrc/passa.cu"
# _decode_jit, a jnp program (inter=0 and inter=1)
PASSA_REPLACES = "ffmpeg_hybrid_tpu/ops/passa_device.py:620"
# the walk's small inter clips (tools/make_passa_inter_vectors_torch.py):
# the kernel against its plain version on every frame, counts forced on
PASSA_INTER_CLIPS = ("passa_inter_modes", "passa_inter_seg",
                     "passa_inter_tiles")
# the clips whose every inter frame the kernel takes against the native
# pass A, and the frames also held to the plain walk (a typical and the
# densest P frame of bench_1080p; a compound frame of resize_1080p that
# uses the last frame's MVs)
PASSA_INTER_FRAME_CLIPS = ("bench_1080p", "bench_4k", RESIZE_CLIP) \
    + tuple(FORMAT_INTER_CLIPS)
# the format clips' inter frames held to the plain walk with the symbol
# counts forced on, one a clip: the lossless frames (1) of the 4:4:4
# clips (sub-8x8 chroma, compound, hp MVs), the lossy ones (2) of 4:2:2
# and 10-bit 4:2:0 (the chroma transform size rule, long tokens) and the
# frame of 4:4:0 that takes the previous frame's MVs (3)
PASSA_FORMAT_INTER_PLAIN = (("fmt_inter_422_1080p", 2),
                            ("fmt_inter_440_1080p", 3),
                            ("fmt_inter_444_1080p", 1),
                            ("fmt_inter_420_10_1080p", 2),
                            ("fmt_inter_444_12_1080p", 1))
PASSA_INTER_PLAIN = (("bench_1080p", 1), ("bench_1080p", 6),
                     (RESIZE_CLIP, 4)) + PASSA_FORMAT_INTER_PLAIN
# the inter frames timed against the native pass A
PASSA_INTER_TIMED = (("bench_1080p", 1), ("bench_1080p", 6), ("bench_4k", 1),
                     (RESIZE_CLIP, 3), (RESIZE_CLIP, 4)) \
    + PASSA_FORMAT_INTER_PLAIN
# the walk's small clips (tools/make_passa_vectors_torch.py): the
# kernel against its plain version on every intra frame
PASSA_CLIPS = ("passa_s2", "passa_s4", "passa_s5", "passa_s7", "passa_s41",
               "passa_s42", "passa_s51", "passa_seg", "passa_wide",
               "passa_10bit", "passa_444_12", "passa_lossless",
               "passa_intraonly")
# the keyframe clips of the passa phase: the kernel against the native
# pass A on frame 0
PASSA_FRAME_CLIPS = ("bench_1080p_lf",) + tuple(FORMAT_CLIPS)
# decode_stream with pass_a_impl="device" on the main path: all fourteen
# clips; the fps with each pass A, in turns
PASSA_DECODE_CLIPS = PASSA_FRAME_CLIPS + PASSA_INTER_FRAME_CLIPS
# the 1080p frames also held to the plain walk: the clip the kernels line
# reports, and the frame with the most bools
PASSA_PLAIN_CLIPS = ("bench_1080p_lf", "fmt_444_1080p")
# cycles a bool of the halfword bool chain alone on an H100, as
# rac.bool_chain_cycles measures it: the walk's chain bound
BOOL_CHAIN_CYCLES = 73.5
LF_REPLAY_SRC = PKG + "/csrc/lpf_replay.cu"
# _lf_scan, with the sharded scan of parallel/fullframe.py
# (_lf_apply_step :163, _lf_scan_sharded :201)
LF_REPLAY_REPLACES = "ffmpeg_hybrid_tpu/ops/lpf_tpu.py:115"
# the mesh_mp phase (parallel/dist.py): (clip, frames (None: all), mesh
# (gop, tile)) through two spawned ranks, each with half of a row's tiles
MESH_MP_RUNS = (("dryrun_mesh_2x4", None, (2, 4)),
                ("bench_1080p_lf", None, (1, 4)),
                ("bench_4k", 1, (1, 8)),
                ("bench_1080p", 6, (1, 4)))
MESH_MP_TIMEOUT = 300


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError("nvidia-smi failed: " + r.stderr.strip())
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device ms per call of fn over reps calls, CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(e):
    return getattr(e, "self_device_time_total", None) \
        or getattr(e, "self_cuda_time_total", 0)


def device_counts(prof, keys):
    """{key: the device records the profiler kept whose names hold key}."""
    from torch.autograd import DeviceType
    return {k: sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and k in e.key)
            for k in keys}


def profiled(body, expect):
    """(profiler, result, kept) of body() run under torch.profiler.
    expect: a callable called before each run, which returns a callable
    that gives, after it, {substring: count}, the kernels launched whose
    names hold each substring. The profiler keeps fewer device records
    than were launched, though it keeps every launch's host record: on an
    H100 40 of 50 records of some kernels run after run, 0 to 20 of 20 of
    others (a warm-up step of a schedule, or idle time before the work in
    the profile, changed nothing). So the run is made again, PROFILE_TRIES
    times in all, while a record is missing, and the run that kept the
    largest share of the records is returned, with kept: {substring:
    (records kept, launched)}. Its readings are scaled by launched over
    kept (kept_scale): the mean of the records kept stands for the ones
    lost. A best share under PROFILE_KEPT raises, and so does a record
    more than was launched (the count is wrong). Once load_empty has run,
    each run is padded with PROFILE_PAD launches of pad_kernel before the
    body and after it (left out of every reading): late in a long run the
    profiler dropped the records of a profile's first kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    best = None
    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for pad in _PAD:
                pad()
            counted = expect()
            out = body()
            for pad in _PAD:
                pad()
        want = counted()
        got = device_counts(prof, want)
        if any(got[k] > want[k] for k in want):
            raise RuntimeError(f"the profiler kept device records {got} of "
                               f"{want} launched: a count is wrong")
        launched = sum(want.values())
        share = sum(got.values()) / launched if launched else 1.0
        if best is None or share > best[0]:
            best = (share, prof, out, {k: (got[k], want[k]) for k in want})
        if share == 1.0:
            break
        host = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU
                   and "LaunchKernel" in e.key)
        say("profile", f"run {attempt + 1}: the profiler kept device "
            f"records {got} of {want} launched ({host} kernel-launch calls "
            "recorded on the host)")
    share, prof, out, kept = best
    if share < PROFILE_KEPT:
        raise RuntimeError(f"torch.profiler kept {kept} (records, launched) "
                           f"at best in {PROFILE_TRIES} runs")
    return prof, out, kept


def kept_scale(kept):
    """Launched over kept, over every substring of a profiled run's kept:
    the factor that its device time and op count are scaled by."""
    got = sum(g for g, _w in kept.values())
    want = sum(w for _g, w in kept.values())
    return want / got if got else 1.0


def device_ms(torch, fn, reps, names, per_call=1, kernel=None):
    """(mean device ms, device operations) per call of fn over reps calls:
    the kernels and memsets whose names hold one of `names`, from
    torch.profiler: their summed device time, less the share by which
    their intervals overlap (a programmatic dependent launch runs beside
    the launch before it, and that time counts once). A wrapper whose
    host work outlasts its kernels reads as its host time under CUDA
    events; this reads the card's own. A call launches per_call kernels
    (one by default) whose names hold `kernel` (names[0] when None): the
    time and the ops are scaled by their launches over the records the
    profiler kept (profiled)."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()

    def body():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    key = names[0] if kernel is None else kernel
    prof, _, kept = profiled(body, lambda: lambda: {key: reps * per_call})
    scale = kept_scale(kept)
    us = ops = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and PAD_KERNEL not in e.key \
                and any(k in e.key for k in names):
            us += _device_us(e)
            ops += e.count
    if not us:
        raise RuntimeError(f"the profiler saw no device time of {names}")
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and PAD_KERNEL not in e.name
                   and any(k in e.name for k in names))
    total = sum(b - a for a, b in spans)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    share = busy / total if total > 0 else 1.0
    return us * share * scale / 1e3 / reps, ops * scale / reps


# a kernel that does nothing, one block of one warp: its device time is
# the floor that a small kernel's time is read against; its twin pads
# every profiled run (profiled)
EMPTY_CU = """#include <cuda_runtime.h>
__global__ void empty_kernel() {}
__global__ void pad_kernel() {}
extern "C" int empty(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
extern "C" int pad(int n, cudaStream_t stream) {
  for (int i = 0; i < n; ++i) pad_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
"""
# the pad kernel's name (left out of every profiled reading) and its
# launcher, once load_empty has loaded it
PAD_KERNEL = "pad_kernel"
_PAD = []


def start_empty_build():
    """nvcc of EMPTY_CU into the port's build directory, started:
    (process, library path); load_empty() waits for it."""
    from ffmpeg_hybrid_tpu_torch import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    stem = os.path.join(_build.BUILD_DIR, "empty_kernel")
    with open(stem + ".cu", "w") as f:
        f.write(EMPTY_CU)
    return subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", stem + ".so",
         stem + ".cu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True), stem + ".so"


def load_empty(build):
    """The empty kernel's launcher fn() on the current stream, once its
    build has ended; raises if it failed."""
    import ctypes
    import torch
    proc, path = build
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc of the empty kernel failed:\n{log}")
    lib = ctypes.CDLL(path)
    lib.empty.argtypes = [ctypes.c_void_p]
    lib.empty.restype = ctypes.c_int
    lib.pad.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.pad.restype = ctypes.c_int

    def fn():
        rc = lib.empty(torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"empty kernel: CUDA error {rc}")

    def pad():
        rc = lib.pad(PROFILE_PAD, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if rc:
            raise RuntimeError(f"pad kernel: CUDA error {rc}")
    _PAD[:] = [pad]
    return fn


def launch_floor_ms(torch, empty, reps=50):
    """The empty kernel's device time, in device_ms like any kernel."""
    return device_ms(torch, empty, reps, ("empty_kernel",), 1)[0]


def ptxas_entries(src, kernel):
    """ptxas's stack, spill and register lines of every entry function of
    `src`'s build whose name holds `kernel` (each template instance):
    [(entry name, its lines joined)]."""
    from ffmpeg_hybrid_tpu_torch import _build
    with open(_build.lib_path(os.path.basename(src)) + ".log") as f:
        lines = f.read().splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            props = [ln.split("ptxas info    :")[-1].strip()
                     for ln in lines[i + 1:i + 4]
                     if "spill" in ln or "registers" in ln]
            out.append((line.split("'")[1], "; ".join(props)))
    if not out:
        raise RuntimeError(f"no ptxas report of {kernel} in {src}'s build")
    return out


def ptxas_of(src, kernel):
    """ptxas's registers and spills of the kernel whose entry name holds
    `kernel`, from the build log of `src` (a path in the repository); the
    first such entry."""
    return ptxas_entries(src, kernel)[0][1]


def bounds(nbytes, nops, chain):
    """(bound_ms, bound_by, chain_bound_ms): the bytes the function must
    move over HBM, its integer operations (one per bool for the bool
    decoders) over the int32 rate, and its longest dependent chain
    (bools, loop-filter edge positions or intra levels) at one
    boost-clock cycle per step (a floor no serial implementation
    beats)."""
    bytes_ms = nbytes / HBM_BPS * 1e3
    ops_ms = nops / INT32_OPS * 1e3
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), bound_by, chain / BOOST_HZ * 1e3


def bytes_used(d, length):
    """Stream bytes a spec BoolDecoder `d` has consumed (a started byte
    counts whole), at most the lane's `length`."""
    return min(length, d.byte_pos + (1 if d.bit_pos else 0))


# the stream path's seeded lanes: S lanes of L bytes; bits K bools a
# lane, tree K symbols of the intra-mode tree
STREAM_S, STREAM_L = 64, 1024
STREAM_K = {"bits": 2048, "tree": 512}
# the VP9 trees (codecs/vp9/tables.py), every one held on the card
TREES = ("PARTITION_TREE", "SEGMENTATION_TREE", "INTRAMODE_TREE",
         "INTER_MODE_TREE", "FILTER_TREE", "MV_JOINT_TREE", "MV_CLASS_TREE",
         "MV_FP_TREE")


def spec_stream(np, data, probs, tree=None, k=0, max_depth=12):
    """The spec decoder (codecs/vp9/rac.py) on each lane of data [S, L]:
    the bits under probs [S, K], or, with a tree, k symbols under probs
    [S, NN] with at most max_depth bools a symbol. Returns (outputs, bools
    a lane, stream bytes consumed in all, distinct nodes read in all
    lanes, distinct tree entries taken)."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.rac import BoolDecoder
    S, L = data.shape
    ref = np.zeros((S, k if tree is not None else probs.shape[1]), np.int64)
    lane_bools, used, nodes, entries = [], 0, 0, set()
    for s in range(S):
        d = BoolDecoder(data[s].tobytes())
        if tree is None:
            ref[s] = [d.get_prob(int(p)) for p in probs[s]]
            lane_bools.append(probs.shape[1])
        else:
            nb, visited = 0, set()
            for i in range(k):
                node = 0
                for _ in range(max_depth):
                    bit = d.get_prob(int(probs[s, node]))
                    visited.add(node)
                    entries.add((node, bit))
                    nxt = int(tree[node][bit])
                    nb += 1
                    if nxt <= 0:
                        ref[s, i] = -nxt
                        break
                    node = nxt
            lane_bools.append(nb)
            nodes += len(visited)
        used += bytes_used(d, L)
    return ref, lane_bools, used, nodes, entries


def stream_lanes(np, kind):
    """The stream path's seeded lanes: data [S, L]
    uint8, probs, the tree (None for bits) and K."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9 import tables as T
    rng = np.random.RandomState(SEED + (kind == "tree"))
    data = rng.randint(0, 256, (STREAM_S, STREAM_L)).astype(np.uint8)
    K = STREAM_K[kind]
    if kind == "bits":
        return data, rng.randint(1, 256, (STREAM_S, K)).astype(np.uint8), \
            None, K
    tree = np.asarray(T.INTRAMODE_TREE, np.int32)
    return data, rng.randint(40, 220, (STREAM_S, tree.shape[0])) \
        .astype(np.uint8), tree, K


def stream_chain(rac, torch, np, row, probs8, bools):
    """(cycles a bool, clock in Hz) of one byte-fed lane's chain alone
    (rac.bool_chain_cycles, the halfword-fed loop): the lane's bytes
    after its first as halfwords, from the state the spec decoder's
    init leaves (value its first byte, range 255), under 8 of its
    probabilities, its bools rounded up to a multiple of 8; the clock
    from chain_clock_hz."""
    half = torch.as_tensor(rac.pack_windows([bytes(row)], [1])[0],
                           device=DEVICE)
    p8 = torch.as_tensor(np.resize(np.asarray(probs8, np.int32), 8),
                         device=DEVICE)
    K = -(-bools // 8) * 8
    args = (half, int(row[0]), 255, 0, 0, p8, K)
    rac.bool_chain_cycles(*args)         # warm-up
    cycles = min(rac.bool_chain_cycles(*args) for _ in range(5))
    return cycles / K, chain_clock_hz(rac, torch, args)


def on_card(torch, a, base=0):
    """numpy array a on the card, as a view `base` bytes into a larger
    buffer (a row then starts at another byte alignment)."""
    t = torch.as_tensor(a)
    big = torch.zeros(t.numel() + base, dtype=t.dtype, device=DEVICE)
    big[base:] = t.reshape(-1).to(DEVICE)
    return big[base:].view(t.shape)


def stream_edges(rac, torch, np, kind):
    """Both kernels held to their plain versions and to the spec decoder
    on their edges, each input at the four byte alignments of its rows:
    for a tree, every VP9 tree on random lanes, the depth cap below, at
    and one under the intra-mode and MV-class trees' depths, a tree with
    a cycle, overread (5 bytes a lane) and probabilities 0, 1 and 255
    (the kernel's capped and cap-free instances); for bits, L not a
    multiple of 4 with K not a multiple of 16, overread (1 and 3 bytes a
    lane) and the extreme probabilities; and lanes whose first byte is
    0xff, held to the plain version alone (its int32 value parts there
    from the spec decoder's unbounded one). Returns the cases held."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9 import tables as T
    rng = np.random.RandomState(SEED + 2 + (kind == "tree"))

    def lanes(S, L):
        return rng.randint(0, 255, (S, L)).astype(np.uint8)   # no 0xff

    def depth(tree, node=0):
        return 1 + max(depth(tree, int(e)) if e > 0 else 0
                       for e in tree[node])
    cases = []
    if kind == "tree":
        for name in TREES:
            tree = np.asarray(getattr(T, name), np.int32)
            cases.append((name, lanes(32, 61), rng.randint(
                1, 256, (32, tree.shape[0])).astype(np.uint8), tree, 64, 12))
        for name in ("INTRAMODE_TREE", "MV_CLASS_TREE"):
            tree = np.asarray(getattr(T, name), np.int32)
            probs = rng.randint(1, 256, (16, tree.shape[0])).astype(np.uint8)
            for md in (1, depth(tree) - 1, depth(tree)):
                cases.append((f"{name} max_depth={md}", lanes(16, 33),
                              probs, tree, 40, md))
        cyc = np.array([[1, -1], [2, -2], [1, -3]], np.int32)
        cases.append(("a cycle (max_depth=5)", lanes(16, 19), rng.randint(
            1, 256, (16, 3)).astype(np.uint8), cyc, 40, 5))
        tree = np.asarray(T.MV_CLASS_TREE, np.int32)
        NN = tree.shape[0]
        cases.append(("overread (L=5)", lanes(16, 5), rng.randint(
            1, 256, (16, NN)).astype(np.uint8), tree, 64, 12))
        cases.append(("probabilities 0, 1, 255", lanes(16, 23), rng.choice(
            [0, 1, 255], (16, NN)).astype(np.uint8), tree, 40, 12))
        ff = lanes(16, 27)
        ff[:, 0] = 0xff
        cases.append(("first byte 0xff", ff, rng.randint(
            1, 256, (16, NN)).astype(np.uint8), tree, 40, 12))
    else:
        probs = rng.randint(1, 256, (16, 150)).astype(np.uint8)
        cases += [("L=43, K=150", lanes(16, 43), probs),
                  ("overread (L=3)", lanes(16, 3), probs),
                  ("overread (L=1)", lanes(16, 1), probs[:, :37]),
                  ("probabilities 0, 1, 255", lanes(16, 9), rng.choice(
                      [0, 1, 255], (16, 70)).astype(np.uint8))]
        ff = lanes(16, 27)
        ff[:, 0] = 0xff
        cases.append(("first byte 0xff", ff, probs))
    name = f"decode_{kind}_multi"
    kern = getattr(rac, name)
    plain = getattr(rac, name + "_plain")
    for case in cases:
        label, data, probs, args = case[0], case[1], case[2], case[3:]
        ref = plain(on_card(torch, data), on_card(torch, probs), *args)
        want = None
        if not label.startswith("first byte"):
            want = spec_stream(np, data, probs, *args)[0]
        for base in range(4):
            got = kern(on_card(torch, data, base),
                       on_card(torch, probs, (base + 1) % 4), *args)
            if not torch.equal(got, ref) or (
                    want is not None
                    and not np.array_equal(got.cpu().numpy(), want)):
                raise RuntimeError(f"{name} on {label} (rows {base} bytes "
                                   "off their words): kernel != plain/spec")
    return [c[0] for c in cases]


def stream_phase(rac, torch, np, kind):
    """decode_bits_multi or decode_tree_multi on seeded byte streams:
    the counted run, the plain version, the spec decoder, timings; the
    edge cases (stream_edges); the longest lane's cycles a bool in the
    kernel (its clock-reading instance, rac.stream_cycles) beside its
    chain alone (stream_chain) at the clock that chain kernel ran at;
    ptxas's registers and spills.

    The bytes bound counts what this run's lanes need: the stream bytes
    each spec decoder consumed, the probabilities read (every one for
    bits; the distinct nodes a lane visited for a tree, and the distinct
    tree-table entries taken), and the output."""
    data, probs, tree, K = stream_lanes(np, kind)
    extra = () if tree is None else (tree, K)
    ref, lane_bools, used, nodes, entries = spec_stream(np, data, probs,
                                                        *extra)
    name = f"decode_{kind}_multi"
    kern = getattr(rac, name)
    plain = getattr(rac, name + "_plain")
    if tree is None:
        need = used + STREAM_S * K + STREAM_S * K * 4    # streams, probs, out
    else:
        # streams, probs (uint8), tree entries (int32), out
        need = used + nodes + 4 * len(entries) + STREAM_S * K * 4
    data_d = torch.as_tensor(data, device=DEVICE)
    probs_d = torch.as_tensor(probs, device=DEVICE)
    # the path's run: launches counted from zero
    rac.reset_launches()
    out = kern(data_d, probs_d, *extra)
    torch.cuda.synchronize()
    launches = rac.LAUNCHES[name]
    if launches < 1:
        raise RuntimeError(f"{name} launched no kernel on the card")
    out_plain = plain(data_d, probs_d, *extra)
    err = int((out.long() - out_plain.long()).abs().max())
    if err or not np.array_equal(out.cpu().numpy(), ref):
        raise RuntimeError(f"{name}: kernel != plain/spec (max |diff| "
                           f"{err})")
    edges = stream_edges(rac, torch, np, kind)
    call_ms = cuda_ms(lambda: kern(data_d, probs_d, *extra), 50)
    ms, _ops = device_ms(torch, lambda: kern(data_d, probs_d, *extra), 50,
                         (f"decode_{kind}_kernel",), launches)
    plain_ms = cuda_ms(lambda: plain(data_d, probs_d, *extra), 1)
    nbools = int(sum(lane_bools))
    longest = int(np.argmax(lane_bools))
    bound_ms, bound_by, chain_ms = bounds(need, nbools, lane_bools[longest])
    # cycles in the kernel, its clock-reading instance, the best of five
    timed, cycles = rac.stream_cycles(name, data_d, probs_d, *extra)
    if not torch.equal(timed, out):
        raise RuntimeError(f"{name}: the clock-reading instance differs")
    cyc = min(int(rac.stream_cycles(name, data_d, probs_d, *extra)[1]
                  [longest]) for _ in range(5))
    cpb = cyc / lane_bools[longest]
    chain_cpb, clock_hz = stream_chain(rac, torch, np, data[longest],
                                       probs[longest, :8],
                                       lane_bools[longest])
    chain_clock_ms = lane_bools[longest] * chain_cpb / clock_hz * 1e3
    # the instance the seeded lanes ran: untimed (and, for the tree, the
    # one without the depth cap, as no symbol of theirs can reach it)
    ptx = ptxas_of(KERNEL_SRC, {"bits": "decode_bits_kernelILb0E",
                                "tree": "decode_tree_kernelILb0ELb0E"}[kind])
    # a token: one decoded bit (bits) or one tree symbol (tree)
    say("kernels", f"{name}: S={STREAM_S} K={K} ms={ms:.5f} on the card's "
        f"clock (the wrapper's call under CUDA events {call_ms:.5f}) "
        f"plain_ms={plain_ms:.2f} "
        f"launches={launches} tokens={STREAM_S * K} tokens/s="
        f"{STREAM_S * K / (ms / 1e3):.4g} bools={nbools} bytes needed="
        f"{need} (stream {used}) exact vs plain and spec; the longest lane "
        f"({lane_bools[longest]} bools) {cpb:.2f} cycles a bool in the "
        f"kernel (clock64), its chain alone {chain_cpb:.2f} cycles a bool "
        f"= {chain_clock_ms:.6f} ms at the {clock_hz / 1e9:.3f} GHz that "
        f"chain kernel ran at (kernel/chain {cpb / chain_cpb:.2f}); ptxas "
        f"{ptx}; edges exact vs plain and spec at 4 row alignments: "
        + "; ".join(edges))
    return {"name": name, "route": "cuda", "source": KERNEL_SRC,
            "replaces": PALLAS_SRC + (":189" if kind == "bits" else ":113"),
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "bools": nbools, "chain_bools": lane_bools[longest],
            "chain_bound_ms": chain_ms, "bytes_needed": need,
            "call_ms": call_ms,
            "cycles_per_bool": cpb, "chain_cycles_per_bool": chain_cpb,
            "chain_kernel_clock_hz": clock_hz,
            "chain_bound_measured_at_clock_ms": chain_clock_ms,
            "ptxas": ptx, "edge_cases": edges}


def coef_bytes_needed(groups):
    """Bytes the per-lane form of decode_coeffs_multi (a lane's own int32
    tables and rows, as the kernel read them before the packed form)
    must move for these blocks, counting
    what each lane's walk reads before its EOB (all int32): the
    halfwords holding the stream bytes it consumed, its five scalars
    (state and nnz) and dequant pair, the probability entries it read,
    scan and both neighbour tables at each processed position, the band
    table as far as the longest walk, and the whole coefficient block
    and eob it writes."""
    total = 0
    for tx, group in groups.items():
        n = (4 << tx) ** 2
        total += 4 * min(n, max(g["eob"] + 1 for g in group))   # band
        for g in group:
            total += 4 * (-(-g["stream_bytes"] // 2) + 5 + 2
                          + len(g["prob_reads"]) + 3 * g["eob"] + n + 1)
    return total


def coef_walk_bytes(rac, fr, groups):
    """Bytes the packed walk (rac.decode_coeffs_frame on fr, a CoefLanes
    of these groups) must move, each input read once and each output
    written once: the lane table's columns the kernel reads (15 a lane)
    and the block table's (9 a block); the halfwords holding each lane's
    consumed stream bytes (an int32 each); of each distinct scan and
    neighbour table the words as far as its furthest lane's walk reads
    (eob + 1 positions), and of each distinct probability row the
    entries its lanes read (a byte each); the token machine; every
    coefficient output (its zeros included) and the eob."""
    lanes = fr.lanes.cpu().numpy()
    tab_words, prob_entries = {}, {}
    halves = 0
    for group, (n, _sg, _o, l0, _is32, _lh) in zip(groups.values(),
                                                   fr.groups):
        for s, g in enumerate(group):
            row = lanes[l0 + s]
            halves += -(-g["stream_bytes"] // 2)
            t = int(row[rac.TAB_OFF])
            tab_words[t] = max(tab_words.get(t, 0), min(n, g["eob"] + 1))
            prob_entries.setdefault(int(row[rac.PROB_OFF]), set()).update(
                g["prob_reads"].tolist())
    S, B = lanes.shape[0], fr.blocks.shape[0]
    return (4 * (15 * S + 9 * B + halves + sum(tab_words.values()))
            + sum(len(v) for v in prob_entries.values())
            + rac.coef_machine(8).nbytes + 4 * (fr.nout + S))


# bools of the chain run that reads the card's clock: some 40 ms, so
# that the launch is lost in its time
CLOCK_BOOLS = 1 << 20


def chain_clock_hz(rac, torch, args):
    """The clock the card runs a chain kernel at: the cycles of
    rac.bool_chain_cycles on `args` with CLOCK_BOOLS bools over its time
    under CUDA events (the best of three)."""
    run = args[:-1] + (CLOCK_BOOLS,)
    best = 0.0
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cycles = rac.bool_chain_cycles(*run)
        end.record()
        end.synchronize()
        best = max(best, cycles / (start.elapsed_time(end) / 1e3))
    return best


def chain_cycles(rac, torch, fr, lane, bools):
    """(cycles per bool, clock in Hz) of the longest lane's chain alone
    on the card (rac.bool_chain_cycles): its halfwords staged in shared
    memory, from its snapshot state, under the first 8 probabilities of
    its row held in registers, its bools rounded up to a multiple of 8;
    the clock from chain_clock_hz."""
    row = fr.lanes[lane].cpu().tolist()
    half = fr.half[row[rac.HALF_OFF]:row[rac.HALF_OFF] + row[rac.HALF_LEN]]
    p8 = fr.probs[row[rac.PROB_OFF]:row[rac.PROB_OFF] + 8].to(torch.int32)
    K = -(-bools // 8) * 8
    args = (half, row[rac.VALUE], row[rac.RNG], row[rac.BITBUF],
            row[rac.NBITS], p8, K)
    rac.bool_chain_cycles(*args)         # warm-up
    cycles = min(rac.bool_chain_cycles(*args) for _ in range(5))
    return cycles / K, chain_clock_hz(rac, torch, args)


def coef_phase(rac, torch, np, packet):
    """The coefficient path on every block of one frame: every lane in
    one launch (coef_path.decode_blocks on coef_path.frame_inputs), held
    to the plain version on the same packed inputs and to the host pass
    A; its time on the card's clock (device_ms) with its device ops, and
    decode_blocks' call under CUDA events (the wrapper's host work
    included); the chain bound at one cycle a bool and at the cycles a
    bool of the longest lane takes alone (chain_cycles)."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu_torch.ops import coef_path as CP
    t0 = time.perf_counter()
    caps = CP.capture_blocks(packet, count_work=True)
    groups = CP.group_by_tx(caps)
    say("kernels", f"captured {len(caps)} blocks of frame 0 "
        f"({ {tx: len(g) for tx, g in sorted(groups.items())} } by tx) in "
        f"{time.perf_counter() - t0:.2f} s (pure-Python pass A)")
    fr = CP.frame_inputs(groups, DEVICE,
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count)
    rac.reset_launches()
    out = CP.decode_blocks(groups, fr, bpp=8)
    torch.cuda.synchronize()
    launches = rac.LAUNCHES["decode_coeffs_multi"]
    if launches != 1:
        raise RuntimeError(f"decode_coeffs_multi launched {launches} "
                           "kernels for one frame, expected 1")
    plain = CP.decode_blocks(groups, fr, bpp=8,
                             fn=rac.decode_coeffs_multi_plain)
    err = 0
    for tx, group in groups.items():
        coef, eob = (t.cpu().numpy() for t in out[tx])
        pc, pe = (t.cpu().numpy() for t in plain[tx])
        err = max(err, int(np.abs(coef.astype(np.int64) - pc).max()),
                  int(np.abs(eob.astype(np.int64) - pe).max()))
        for s, g in enumerate(group):
            if eob[s] != g["eob"] or not np.array_equal(coef[s], g["coef"]):
                raise RuntimeError(f"decode_coeffs_multi tx={tx} lane {s}"
                                   " differs from the host pass A")
    if err:
        raise RuntimeError(f"decode_coeffs_multi != plain ({err})")
    # the one-group entry (JAX-shaped: a group a call, its lanes packed
    # on the card by rac.group_lanes): the same outputs, a launch a group
    one = CP.decode_blocks(groups, fr, bpp=8, fn=rac.decode_coeffs_multi)
    for tx in groups:
        if not (torch.equal(one[tx][0], out[tx][0])
                and torch.equal(one[tx][1], out[tx][1])):
            raise RuntimeError(f"decode_coeffs_multi tx={tx}: the one-group "
                               "entry differs from the frame's launch")

    def run():
        CP.decode_blocks(groups, fr, bpp=8)
    k_ms, ops = device_ms(torch, run, PROFILE_REPS, ("decode_coeffs_kernel",),
                          1)
    ms = cuda_ms(run, 20)
    # the one-group entry alone, each group's arguments unpacked first:
    # under CUDA events, and on the card's clock with all its device ops
    # (the packing's tensor ops and the launch) and its kernel alone
    gargs = rac.group_args(fr)

    def one_group():
        for (tx, group), a in zip(groups.items(), gargs):
            rac.decode_coeffs_multi(*a, n=(4 << tx) ** 2, bpp=8,
                                    is32=group[0]["is32"])
    group_ms = cuda_ms(one_group, 20)
    group_dev_ms, group_ops = device_ms(torch, one_group, 20, ("",),
                                       len(groups), "decode_coeffs_kernel")
    group_k_ms, _ops = device_ms(torch, one_group, 20,
                                 ("decode_coeffs_kernel",), len(groups))
    t0 = time.perf_counter()
    CP.decode_blocks(groups, fr, bpp=8, fn=rac.decode_coeffs_multi_plain)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    tokens = sum(c["eob"] + 1 for c in caps)
    nbools = sum(c["bools"] for c in caps)
    chain = max(c["bools"] for c in caps)
    need = coef_walk_bytes(rac, fr, groups)
    bound_ms, bound_by, chain_ms = bounds(need, nbools, chain)
    # the bound before the packed form: per-lane int32 tables and rows
    need_before = coef_bytes_needed(groups)
    bound_before, _by, _chain = bounds(need_before, nbools, chain)
    # the longest lane's index in the packed order (groups in turn)
    longest = id(max(caps, key=lambda c: c["bools"]))
    lane = 0
    for group in groups.values():
        ids = [id(c) for c in group]
        if longest in ids:
            lane += ids.index(longest)
            break
        lane += len(ids)
    cpb, clock_hz = chain_cycles(rac, torch, fr, lane, chain)
    chain2_ms = chain * cpb / BOOST_HZ * 1e3
    chain2_clock_ms = chain * cpb / clock_hz * 1e3
    # the native C pass A on the same packet (whole pass A: syntax walk
    # and coefficients, so it understates the C coefficient rate)
    ts = []
    for _ in range(5):
        dec = VP9Decoder(device=DEVICE, use_native=True)
        t0 = time.perf_counter()
        dec.decode_pass_a(packet)
        ts.append((time.perf_counter() - t0) * 1e3)
    native_ms = sorted(ts)[len(ts) // 2]
    say("kernels", f"decode_coeffs_multi: {len(caps)} blocks in "
        f"{fr.blocks.shape[0]} blocks of at most "
        f"{int(fr.blocks[:, rac.NLANES].max())} lanes, {fr.smem} B shared, "
        f"{launches} launch, ms={k_ms:.5f} on the card's clock in {ops:.2f} "
        f"device ops (decode_blocks under CUDA events {ms:.4f}; the "
        f"one-group entry, a call a group, its lanes packed on the card: "
        f"{group_ms:.4f} under CUDA events, {group_dev_ms:.4f} on the "
        f"card's clock in {group_ops:.2f} device ops, its {len(groups)} "
        f"launches {group_k_ms:.4f}) plain_ms="
        f"{plain_ms:.1f} tokens={tokens} tokens/s={tokens / (k_ms / 1e3):.4g}"
        f" bytes needed={need} bound_ms={bound_ms:.6f} (per-lane tables "
        f"{need_before} B, {bound_before:.6f}); chain {chain} bools:"
        f" {chain_ms:.6f} ms at a cycle a bool, {cpb:.2f} cycles a bool "
        f"alone (clock64) = {chain2_ms:.6f} ms at 1.98 GHz, "
        f"{chain2_clock_ms:.6f} ms at the {clock_hz / 1e9:.3f} GHz that "
        "chain ran at; native C pass A (whole "
        f"frame, one host core) {native_ms:.2f} ms = "
        f"{tokens / (native_ms / 1e3):.4g} tokens/s; exact vs plain and "
        "host pass A")
    return {"name": "decode_coeffs_multi", "route": "cuda",
            "source": KERNEL_SRC, "replaces": PALLAS_SRC + ":523",
            "launches": launches, "max_abs_err": err, "ms": k_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "bools": nbools,
            "device_ops_per_call": ops, "call_ms": ms,
            "one_group_entry_call_ms": group_ms,
            "one_group_entry_device_ms": group_dev_ms,
            "one_group_entry_device_ops": group_ops,
            "one_group_entry_kernel_ms": group_k_ms, "chain_bools": chain, "chain_bound_ms": chain_ms,
            "cycles_per_bool": cpb, "chain_bound_measured_ms": chain2_ms,
            "chain_kernel_clock_hz": clock_hz,
            "chain_bound_measured_at_clock_ms": chain2_clock_ms,
            "tokens": tokens, "native_pass_a_ms": native_ms,
            "bytes_needed": need, "bound_ms_before": bound_before,
            "bytes_needed_before": need_before}


def capture_inputs(torch, targets, packets):
    """Decode `packets` on the card with each (module, name) of
    `targets` wrapped to keep a copy of its arguments, as the decoder
    hands them over. Returns {name: [args, ...]}."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    calls = {name: [] for _mod, name in targets}
    reals = {name: getattr(mod, name) for mod, name in targets}

    from ffmpeg_hybrid_tpu_torch.ops.recon_cuda import SplatState

    def copy(a):
        if torch.is_tensor(a):
            return a.clone()
        if isinstance(a, (list, tuple)):
            return type(a)(copy(x) for x in a)
        if isinstance(a, SplatState):
            # the index as this call reads it: later frames' splats move it
            snap = SplatState.__new__(SplatState)
            snap.bidx, snap.epoch = a.bidx.clone(), a.epoch
            return snap
        return a

    def wrap(name):
        def capture(*args, **kwargs):
            calls[name].append([copy(a) for a in args])
            return reals[name](*args, **kwargs)
        return capture

    for mod, name in targets:
        setattr(mod, name, wrap(name))
    try:
        dec = VP9Decoder(device=DEVICE)
        for packet in packets:
            dec.decode(packet)
        torch.cuda.synchronize()
    finally:
        for mod, name in targets:
            setattr(mod, name, reals[name])
    return calls


def host_ms(torch, fn):
    """Host ms of one synchronised call of fn (the plain versions)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def random_lf_frame(torch, np, seed, sb_rows=17, sb_cols=30, bpp=8):
    """A 4:2:0 frame of sb_rows x sb_cols superblocks (1920x1088 by
    default) for the loop filter, on the card: smooth random planes (so
    the wide filters fire) under random grids with every V and H edge
    position active, wd drawn from 4, 8 and 16, E, I, H over their
    ranges. Returns the lf_frame_ arguments."""
    rng = np.random.RandomState(seed)

    def planes(B, Hp, Wp):
        base = rng.randint(0, 1 << bpp, (B, 1, 1))
        walk = np.cumsum(rng.randint(-2, 3, (B, Hp, Wp)), axis=2) // 3
        return np.clip(base + walk, 0, (1 << bpp) - 1).astype(np.int32)

    def grid(rows, cols):
        g = np.zeros((rows, cols, 4), np.int32)
        g[..., 0] = rng.choice([4, 8, 16], (rows, cols))
        g[..., 1] = rng.randint(1, 194, (rows, cols))
        g[..., 2] = rng.randint(1, 64, (rows, cols))
        g[..., 3] = rng.randint(0, 4, (rows, cols))
        return g

    Hy, Wy = 64 * sb_rows, 64 * sb_cols
    arrays = [planes(1, Hy, Wy)[0], *planes(2, Hy // 2, Wy // 2),
              grid(Hy // 8, Wy // 4), grid(Hy // 4, Wy // 8),
              grid(Hy // 16, Wy // 8), grid(Hy // 8, Wy // 16)]
    return [torch.as_tensor(a, device=DEVICE) for a in arrays] + [
        sb_rows, sb_cols, 1, 1, bpp, True, True]


def lf_run(torch, LD, args):
    """(work planes, run(do_y, do_uv), restore): run() copies the planes
    of the lf_frame_ arguments `args` into the work planes and filters
    them in place with one launch; restore() is its copy alone."""
    planes, rest = args[:3], list(args[3:])
    work = [p.clone() for p in planes]
    # one schedule state for every launch of the run, as a decoder keeps
    schedules = {}

    def restore():
        for w, p in zip(work, planes):
            w.copy_(p)

    def run(do_y=True, do_uv=True):
        restore()
        LD.lf_frame_(*work, *rest[:-2], do_y, do_uv, schedules=schedules)
    return work, run, restore


def lf_stress(torch, LD, args, want, n):
    """n launches on the inputs `args`, each held to `want` bit for bit
    (a missing fence in a dataflow kernel can pass once and fail the
    next time)."""
    work, run, _restore = lf_run(torch, LD, args)
    for i in range(n):
        run()
        for w, ref in zip(work, want):
            if not torch.equal(w, ref):
                raise RuntimeError(f"lf_frame_ launch {i} of {n} != plain "
                                   f"(max |diff| {int((w - ref).abs().max())})")


def lpf_phase(torch, np, calls):
    """lf_frame_ on one frame's real inputs (bench_1080p_lf frame 0
    reconstructed on the card up to the loop filter, its planes and grids
    as the decoder hands them over): the kernel, Y and U+V in one launch,
    against the plain version; its time (CUDA events, the planes' restore
    copy subtracted) in one launch and for each set alone, in us per
    wave; the bound terms (the chain: the longer set's serial positions,
    since the sets run side by side); then the race stress (LF_STRESS)."""
    from ffmpeg_hybrid_tpu_torch.ops import lpf_dense as LD
    if len(calls) != 1:
        raise RuntimeError(f"frame 0 ran {len(calls)} loop-filter calls, "
                           "expected one for Y and U+V")
    args = calls[0]
    planes, (Vy, Hy, Vu, Hu) = args[:3], args[3:7]
    sb_rows, sb_cols, _ss_h, _ss_v, bpp, do_y, do_uv = args[7:]
    if not (do_y and do_uv):
        raise RuntimeError("bench_1080p_lf frame 0 filters only "
                           f"{'Y' if do_y else 'U+V'}")
    want = [p.clone() for p in planes]
    _none, plain_ms = host_ms(torch, lambda: LD.lf_frame_plain_(
        *want, *args[3:]))
    work, run, restore = lf_run(torch, LD, args)
    run()
    err = max(int((w - ref).abs().max()) for w, ref in zip(work, want))
    if err:
        raise RuntimeError(f"lf_frame_: kernel != plain (max |diff| {err})")
    changed = [int((ref != p).sum()) for ref, p in zip(want, planes)]
    if not all(changed):
        raise RuntimeError(f"the loop filter changed {changed} samples")
    copy_ms = cuda_ms(restore, 20)
    ms = cuda_ms(run, 20) - copy_ms
    y_ms = cuda_ms(lambda: run(True, False), 20) - copy_ms
    uv_ms = cuda_ms(lambda: run(False, True), 20) - copy_ms
    nwaves = 2 * (sb_rows - 1) + sb_cols
    # each plane read and written once, each grid read once; the
    # operations are the edge decision (LF_DECISION_OPS) of every lane of
    # every active edge, a floor of what the filter does
    nbytes = sum(2 * p.numel() * 4 for p in planes) + sum(
        g.numel() * 4 for g in (Vy, Hy, Vu, Hu))
    nops = sum((int((V[..., 0] > 0).sum()) + int((H[..., 0] > 0).sum()))
               * 8 * B * LF_DECISION_OPS
               for V, H, B in ((Vy, Hy, 1), (Vu, Hu, 2)))
    chain = nwaves * max(V.shape[1] // sb_cols + H.shape[0] // sb_rows
                         for V, H in ((Vy, Hy), (Vu, Hu)))
    bound_ms, bound_by, chain_ms = bounds(nbytes, nops, chain)
    say("kernels", f"lf_frame_ on bench_1080p_lf frame 0 (Y "
        f"{tuple(planes[0].shape)}, U+V 2 x {tuple(planes[1].shape)}; "
        f"{changed} samples changed): one launch of both sets ms={ms:.4f} "
        f"= {ms * 1e3 / nwaves:.3f} us per wave ({nwaves} waves); alone Y "
        f"{y_ms:.4f} ms = {y_ms * 1e3 / nwaves:.3f} us per wave, U+V "
        f"{uv_ms:.4f} ms = {uv_ms * 1e3 / nwaves:.3f} us per wave (restore "
        f"copy {copy_ms:.4f} ms subtracted) plain_ms={plain_ms:.1f} "
        f"bound_ms={bound_ms:.6f} ({bound_by}, {nbytes} B, {nops} ops) "
        f"chain_ms={chain_ms:.6f} ({chain} serial positions); exact vs "
        "plain")
    t0 = time.perf_counter()
    lf_stress(torch, LD, args, want, LF_STRESS[0])
    rand = random_lf_frame(torch, np, SEED)
    rand_want = [p.clone() for p in rand[:3]]
    LD.lf_frame_plain_(*rand_want, *rand[3:])
    rand_changed = [int((ref != p).sum()) for ref, p in zip(rand_want,
                                                           rand[:3])]
    lf_stress(torch, LD, rand, rand_want, LF_STRESS[1])
    rand10 = random_lf_frame(torch, np, SEED + 1, bpp=10)
    want10 = [p.clone() for p in rand10[:3]]
    LD.lf_frame_plain_(*want10, *rand10[3:])
    lf_stress(torch, LD, rand10, want10, LF_STRESS[2])
    say("kernels", f"lf_frame_ race stress: {LF_STRESS[0]} launches on "
        f"bench_1080p_lf frame 0, {LF_STRESS[1]} on a "
        f"{tuple(rand[0].shape)} random-grid frame (every position active,"
        f" wd 4/8/16; {rand_changed} samples changed) and {LF_STRESS[2]} "
        "on one at 10 bpp, bit-exact vs plain, "
        f"{time.perf_counter() - t0:.1f} s")
    return {"name": "lf_dense", "route": "cuda", "source": LPF_SRC,
            "replaces": LPF_REPLACES, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "per": "frame (Y and U+V in one launch) of bench_1080p_lf "
                   "frame 0",
            "ms_y_alone": y_ms, "ms_uv_alone": uv_ms, "waves": nwaves,
            "us_per_wave": ms * 1e3 / nwaves, "bytes_needed": nbytes,
            "ops": nops, "chain_positions": chain,
            "chain_bound_ms": chain_ms,
            "stress_launches": sum(LF_STRESS)}


class _CountOps:
    """Stands for a value in ops/itxfm.py's 1-D butterflies and counts
    the integer operations (+, -, *, >>, negation) done on it."""
    n = 0

    def _op(self, *_a):
        _CountOps.n += 1
        return self

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _op
    __rshift__ = __neg__ = _op

    def __getitem__(self, _k):
        return _CountOps()

    @staticmethod
    def stack(xs, axis):
        return xs


def butterfly_ops(fn, *args):
    """Integer operations of one 1-D transform of ops/itxfm.py."""
    _CountOps.n = 0
    fn(_CountOps, _CountOps(), *args)
    return _CountOps.n


def residual_work(np, coef, eob4, txsz4, txtype4, lossless):
    """(bytes, operations) one residual_plane call must move and do: the
    three grids read once, of the coefficients only the first eob (in
    scan order) of each coded block, the int32 residual written once;
    per coded block, its two passes of 1-D butterflies (counted from
    ops/itxfm.py), the int16 wrap after each and the final rounding
    (add, shift) of each pixel, or the DC shortcut (4 operations, then
    the rounding of its one value)."""
    from ffmpeg_hybrid_tpu_torch.ops import itxfm
    nbytes = sum(g.numel() * g.element_size()
                 for g in (eob4, txsz4, txtype4)) + coef.numel() * 4
    e, t, ty = (g.cpu().numpy().astype(np.int64)
                for g in (eob4, txsz4, txtype4))
    r4, c4 = e.shape
    yy, xx = np.mgrid[:r4, :c4]
    ops = 0
    for tx in ((0,) if lossless else range(4)):
        k, sz = 1 << tx, 4 << tx
        root = (t == tx) & (e > 0) & (yy % k == 0) & (xx % k == 0)
        nbytes += int(np.minimum(e[root], sz * sz).sum()) \
            * coef.element_size()
        if lossless:
            n = int(root.sum())
            ops += n * (sz * (butterfly_ops(itxfm.iwht4_1d, 0)
                              + butterfly_ops(itxfm.iwht4_1d, 1))
                        + 2 * sz * sz)
            continue
        dc = root & (e == 1) & ((ty == 0) | (tx == 3))
        ops += int(dc.sum()) * 6
        for typ in range(4):
            n = int((root & ~dc & ((ty == typ) if tx < 3 else True)).sum())
            ka, kb = itxfm._TYPE_AB[typ] if tx < 3 else ("dct", "dct")
            ops += n * (sz * (butterfly_ops(itxfm._1D[(tx, ka)])
                              + butterfly_ops(itxfm._1D[(tx, kb)]))
                        + 4 * sz * sz)
            if tx == 3:
                break
    return nbytes, ops


def lossless_pairs_frame(np, rng, shapes):
    """A seeded lossless frame of planes `shapes` in the form recon_frame
    hands to scatter_coef and residual_planes: merged pair rows (in a
    random order, with pad rows among them and rows past the end) and
    per plane its tx size and type grids; 4x4 blocks everywhere, eobs 0,
    1, 2 and 16."""
    planes, geoms, cpos, cval, epos, evals = [], [], [], [], [], []
    cbase = ebase = 0
    for H, W in shapes:
        r4, c4 = H // 4, W // 4
        eob = rng.choice([0, 0, 1, 2, 16], (r4, c4)).astype(np.int32)
        coef = rng.randint(-600, 600, (H, W)) * np.repeat(np.repeat(
            eob > 0, 4, 0), 4, 1)
        geoms.append(((H, W), (r4, c4), cbase, ebase))
        cy, cx = np.nonzero(coef)
        cpos.append(cbase + cy * W + cx)
        cval.append(coef[cy, cx])
        ey, ex = np.nonzero(eob)
        epos.append(ebase + ey * c4 + ex)
        evals.append(eob[ey, ex])
        planes.append((np.zeros((r4, c4), np.int32),
                       np.zeros((r4, c4), np.int32)))
        cbase += H * W
        ebase += r4 * c4

    def rows(pos, val, end):
        pos, val = np.concatenate(pos), np.concatenate(val)
        n = len(pos)
        out = np.zeros((n + 2048, 3), np.int16)
        out[:n, 0], out[:n, 1], out[:n, 2] = pos >> 16, pos & 0xffff, val
        out[n:n + 1024, 0] = -1                       # pad rows
        past = end + rng.randint(0, 1 << 20, 1024)
        out[n + 1024:, 0], out[n + 1024:, 1] = past >> 16, past & 0xffff
        return out[rng.permutation(len(out))]

    return (rows(cpos, cval, cbase), rows(epos, evals, ebase), geoms,
            planes)


def clear_bytes(np, coef, eob4, txsz4, txtype4, lossless):
    """Bytes a consuming residual launch writes to clear one plane
    (csrc/itxfm.cu clear_quad): each 4-pixel quad of a transformed root
    that is not DC-only and holds a nonzero, the first quad of each
    DC-only root, and each nonzero eob cell."""
    e, t, ty = (g.cpu().numpy().astype(np.int64)
                for g in (eob4, txsz4, txtype4))
    r4, c4 = e.shape
    yy, xx = np.mgrid[:r4, :c4]
    full = np.zeros((r4, c4), bool)
    ndc = 0
    for tx in ((0,) if lossless else range(4)):
        k = 1 << tx
        root = ((t == tx) & (e > 0) & (yy % k == 0) & (xx % k == 0)
                & (yy + k <= r4) & (xx + k <= c4))
        dc = root & (e == 1) & ((ty == 0) | (tx == 3)) & (not lossless)
        full |= (root & ~dc)[::k, ::k].repeat(k, 0).repeat(k, 1)[:r4, :c4]
        ndc += int(dc.sum())
    nz = coef.cpu().numpy().reshape(coef.shape[0], c4, 4).any(-1)
    quads = int((nz & full.repeat(4, 0)).sum()) + ndc
    return quads * 4 * coef.element_size() + int((e != 0).sum()) * \
        eob4.element_size()


def rows_in(np, rows, n):
    """Pair rows whose position lies in a buffer of n entries."""
    r = rows.cpu().numpy().astype(np.int64)
    pos = (r[:, 0] << 16) | (r[:, 1] & 0xffff)
    return int(((pos >= 0) & (pos < n)).sum())


def residual_phase(torch, np, scatter_calls, residual_calls):
    """The coefficient scatter and the residual (csrc/itxfm.cu) on the
    real inputs of bench_1080p frames 0 and 1 and bench_1080p_lf frame 0
    ({clip: [args, ...]} of scatter_frame and residual_planes, three
    planes a frame), then on a seeded full-size lossless frame: the
    scatter into fresh buffers (scatter_coef: a memset pair and a
    launch) and into a kept buffer set (scatter_frame: one launch), each
    against its plain version, then the consuming residual on the kept
    set against residual_plane_plain, bit for bit, and the set reading
    zero after it; their device times per frame on the card's clock
    (device_ms) with their device ops, the residual also without the
    clear (no consume), the pair's call under CUDA events and the plain
    versions' times; the bounds: the scatter's pair rows read and the
    positions they name written (before: both dense buffers written
    whole), SCATTER_ROW_OPS a row; residual_work over the three planes
    and the bytes the clear writes (clear_bytes; before: without them).
    Returns the two kernels' rows."""
    from ffmpeg_hybrid_tpu_torch.ops import recon as R
    frames = []
    for clip, calls in scatter_calls.items():
        if len(calls) != len(residual_calls[clip]):
            raise RuntimeError(f"{clip}: {len(calls)} scatter calls, "
                               f"{len(residual_calls[clip])} residual calls")
        for (bufs, cp, ep), rc in zip(calls, residual_calls[clip]):
            frames.append((clip, (cp, ep, bufs.flat_c.numel(),
                                  bufs.flat_e.numel()), rc[:3]))
    rng = np.random.RandomState(SEED + 7)
    cp, ep, geoms, grids = lossless_pairs_frame(
        np, rng, ((1088, 1920), (544, 960), (544, 960)))
    Lc = sum(sh[0] * sh[1] for sh, _e, _b, _eb in geoms)
    Le = sum(e[0] * e[1] for _sh, e, _b, _eb in geoms)
    cp_d, ep_d = (torch.as_tensor(a, device=DEVICE) for a in (cp, ep))
    flat_c, flat_e = R.scatter_coef(cp_d, ep_d, Lc, Le)
    seeded_jobs = [R._slice_plane(flat_c[None], flat_e[None], bc, be, sh[0],
                                  sh[1], esh[0], esh[1]) + tuple(
        torch.as_tensor(g, device=DEVICE) for g in gr)
        for (sh, esh, bc, be), gr in zip(geoms, grids)]
    frames.append(("seeded lossless", (cp_d, ep_d, Lc, Le),
                   (seeded_jobs, True, 8)))
    err = nonzero = 0
    keys = ("ms", "ms_fresh", "ops", "ops_fresh", "call_ms", "plain_ms",
            "bytes", "bytes_before", "int_ops")
    sc = dict.fromkeys(keys, 0.0)
    rs = dict.fromkeys(keys, 0.0)
    shapes = []
    nreal = 0
    for clip, sargs, (jobs, lossless, bpp) in frames:
        cp, ep, nc, ne = sargs
        wide = cp.shape[1] == 4
        got = R.scatter_coef(*sargs)
        scat = R._scatter_pairs32 if wide else R._scatter_pairs16
        want, t_sc = host_ms(torch, lambda: (scat(cp, 1, nc)[0],
                                             R._scatter_pairs16(ep, 1, ne)[0]))
        e = max_diff(got, want)
        # the kept set: its planes are views of its buffers, in order
        bufs = R.CoefBuffers(torch.device(DEVICE), nc, ne, wide)
        kept = R.scatter_frame(bufs, cp, ep)
        e = max(e, max_diff(kept, want))
        err = max(err, e)
        if e:
            raise RuntimeError(f"the scatter on {clip}: kernel != plain "
                               f"(max |diff| {e})")
        views, bc, be = [], 0, 0
        for coef, eob4, txsz4, txtype4 in jobs:
            (H, W), (r4, c4) = coef.shape, eob4.shape
            views.append(R._slice_plane(kept[0][None], kept[1][None], bc, be,
                                        H, W, r4, c4) + (txsz4, txtype4))
            bc += H * W
            be += r4 * c4
        if (bc, be) != (nc, ne):
            raise RuntimeError(f"{clip}: planes of {bc} and {be} entries in "
                               f"buffers of {nc} and {ne}")
        consume = [bufs] * len(views)
        outs = R.residual_planes(views, lossless, bpp, consume=consume)
        wants, t_res = host_ms(torch, lambda: [
            R.residual_plane_plain(*job, lossless, bpp) for job in jobs])
        e = max_diff(outs, wants)
        err = max(err, e)
        if e:
            raise RuntimeError(f"residual_planes on {clip}: kernel != plain "
                               f"(max |diff| {e})")
        if not bufs.read_zero() or bufs.fill_cause() is not None:
            raise RuntimeError(f"{clip}: the kept buffers do not read zero "
                               "after the consuming residual")
        nonzero += sum(int(o.count_nonzero()) for o in outs)
        if clip == "seeded lossless":
            continue
        nreal += 1

        def pair():
            R.scatter_frame(bufs, cp, ep)
            R.residual_planes(views, lossless, bpp, consume=consume)

        def fresh():
            R.scatter_coef(*sargs)

        def residual():
            R.residual_planes(jobs, lossless, bpp)
        k_sc, o_sc = device_ms(torch, pair, 50, ("scatter_kernel", "Memset"),
                               1)
        k_res, o_res = device_ms(torch, pair, 50, ("residual_kernel",), 1)
        k_scf, o_scf = device_ms(torch, fresh, 50, ("scatter_kernel",
                                                    "Memset"), 1)
        k_res0, o_res0 = device_ms(torch, residual, 50, ("residual_kernel",),
                                   1)
        if not bufs.read_zero():
            raise RuntimeError(f"{clip}: the kept buffers do not read zero "
                               "after the timed pairs")
        pair_ms = cuda_ms(pair, 50)
        for d, v in ((sc, (k_sc, k_scf, o_sc, o_scf, t_sc)),
                     (rs, (k_res, k_res0, o_res, o_res0, t_res))):
            for key, x in zip(("ms", "ms_fresh", "ops", "ops_fresh",
                               "plain_ms"), v):
                d[key] += x
            d["call_ms"] += pair_ms
        rows = (cp.numel() + ep.numel()) * 2
        sc["bytes"] += rows + rows_in(np, cp, nc) * (4 if wide else 2) \
            + rows_in(np, ep, ne) * 2
        sc["bytes_before"] += rows + nc * (4 if wide else 2) + ne * 2
        sc["int_ops"] += SCATTER_ROW_OPS * (cp.shape[0] + ep.shape[0])
        for job in jobs:
            b, o = residual_work(np, *job, lossless)
            rs["bytes_before"] += b
            rs["bytes"] += b + clear_bytes(np, *job, lossless)
            rs["int_ops"] += o
        shapes.append(f"{clip} {cp.shape[0]} + {ep.shape[0]} rows, "
                      f"{sum(int(j[1].gt(0).sum()) for j in jobs)} coded "
                      f"cells: scatter {k_sc:.5f} ms in {o_sc:.2f} ops "
                      f"(fresh buffers {k_scf:.5f} in {o_scf:.2f}), residual "
                      f"{k_res:.5f} ms (without the clear {k_res0:.5f})")
    if not nonzero:
        raise RuntimeError("the residuals are zero everywhere")
    out = []
    for name, d, what in (("scatter_coef", sc, "one scatter launch into "
                           "the kept buffers; fresh ones: a memset pair and "
                           "one launch"),
                          ("residual_planes", rs, "one consuming launch of "
                           "the three planes")):
        d = {k: v / nreal for k, v in d.items()}
        bound_ms, bound_by, _chain = bounds(d["bytes"], d["int_ops"], 0)
        before_ms, _by, _chain = bounds(d["bytes_before"], d["int_ops"], 0)
        say("kernels", f"{name}: ms/frame={d['ms']:.5f} on the card in "
            f"{d['ops']:.2f} device ops ({what}; fresh or without the clear "
            f"{d['ms_fresh']:.5f} in {d['ops_fresh']:.2f}; the scatter and "
            f"consuming residual pair under CUDA events {d['call_ms']:.4f}) "
            f"plain_ms/frame={d['plain_ms']:.2f} bound_ms/frame="
            f"{bound_ms:.6f} ({bound_by}, {d['bytes']:.0f} B, "
            f"{d['int_ops']:.0f} ops; before {before_ms:.6f}, "
            f"{d['bytes_before']:.0f} B); exact vs plain, also on a seeded "
            "1920x1088 lossless frame; the kept buffers read zero")
        out.append({
            "name": name, "route": "cuda", "source": ITXFM_SRC,
            "replaces": SCATTER_REPLACES if name == "scatter_coef"
            else ITXFM_REPLACES, "launches": None, "max_abs_err": err,
            "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "per": f"frame ({what}), mean of bench_1080p frames 0-1 and "
                   "bench_1080p_lf frame 0",
            "device_ops_per_call": d["ops"],
            ("ms_fresh_buffers" if name == "scatter_coef"
             else "ms_without_clear"): d["ms_fresh"],
            "bound_ms_before": before_ms, "pair_call_ms": d["call_ms"],
            "bytes_needed": d["bytes"], "ops": d["int_ops"],
            "detail": shapes})
    return out


def mc_work(np, job, has_comp):
    """(bytes, operations) one plane of an mc_planes call must move and
    do: the output written once; per pixel of an inter cell its residual
    and one reference pixel per reference read; MC_CELL_BYTES of grids a
    cell (no comp byte without has_comp); MC_CELL_MACS multiply-adds (two
    operations each) per inter cell and reference."""
    residual, inter4, comp = job[:3]
    H, W = residual.shape
    inter = inter4.cpu().numpy()
    cmp = inter & comp.cpu().numpy() if has_comp else np.zeros_like(inter)
    refs = int(inter.sum()) + int(cmp.sum())
    nbytes = H * W * 4 + int(inter.sum()) * 16 * 4 + refs * 16 * 4 \
        + inter.size * (MC_CELL_BYTES - (0 if has_comp else 1))
    return nbytes, refs * MC_CELL_MACS * 2


def mc_frame(torch, np, rng, shapes, visible, mvs=((2, 2), (1, 1), (1, 1)),
             bpp=8):
    """A seeded frame for mc_planes, on the card: per plane (Y, U, V of
    `shapes`, the visible sizes `visible`, the MV scales `mvs`) random
    `bpp`-bit references and residual; 90% inter cells, every one
    compound, with MVs out to 150 px and every filter bank; the other
    cells carry out-of-range refsel, filter and MV values."""
    jobs = []
    for i, ((H, W), (w, h)) in enumerate(zip(shapes, visible)):
        mvsx, mvsy = mvs[i]
        r4, c4 = H // 4, W // 4
        inter = rng.rand(r4, c4) < 0.9
        lim = 150 * 16 // max(mvsx, mvsy)
        mv16 = rng.randint(-lim, lim + 1, (r4, c4, 2, 2)).astype(np.int32)
        refsel = rng.randint(0, 3, (r4, c4, 2)).astype(np.int32)
        filt = rng.randint(0, 4, (r4, c4)).astype(np.int32)
        off = ~inter
        refsel[off] = rng.choice([-9, 7], (int(off.sum()), 2))
        filt[off] = 9
        mv16[off] = rng.choice([-32768, 32767], (int(off.sum()), 2, 2))
        arrays = [rng.randint(-300 << (bpp - 8), 300 << (bpp - 8),
                              (H, W)).astype(np.int32), inter,
                  inter.copy(), filt, refsel, mv16]
        refs = tuple(torch.as_tensor(rng.randint(0, 1 << bpp, (H, W)).astype(
            np.int32), device=DEVICE) for _ in range(3))
        jobs.append(tuple(torch.as_tensor(a, device=DEVICE) for a in arrays)
                    + (refs, w, h, mvsx, mvsy))
    return jobs


def mc_tile_frame(torch, np, rng, shapes, visible,
                  mvs=((2, 2), (1, 1), (1, 1)), bpp=8):
    """mc_frame's sibling: per 16 x 16 tile one motion a reference (a
    plane, an MV out to 150 px, every phase with 0 one time in four on
    each axis) and one filter bank; 90% inter cells, half of them
    compound and sharing the tile's reference-1 motion; the other cells
    carry out-of-range refsel, filter and MV values."""
    jobs = []
    for i, ((H, W), (w, h)) in enumerate(zip(shapes, visible)):
        mvsx, mvsy = mvs[i]
        r4, c4 = H // 4, W // 4
        tr, tc = -(-r4 // 4), -(-c4 // 4)

        def cells(a):
            return np.repeat(np.repeat(a, 4, 0), 4, 1)[:r4, :c4]

        lim = 150 * 16
        v = rng.randint(-lim, lim + 1, (tr, tc, 2, 2))
        v = np.where(rng.rand(tr, tc, 2, 2) < 0.25, v & ~15, v)
        mv16 = cells(v // np.array([mvsx, mvsy])).astype(np.int32)
        refsel = cells(rng.randint(0, 3, (tr, tc, 2))).astype(np.int32)
        filt = cells(rng.randint(0, 4, (tr, tc))).astype(np.int32)
        inter = rng.rand(r4, c4) < 0.9
        comp = inter & (rng.rand(r4, c4) < 0.5)
        off = ~inter
        refsel[off] = rng.choice([-9, 7], (int(off.sum()), 2))
        filt[off] = 9
        mv16[off] = rng.choice([-32768, 32767], (int(off.sum()), 2, 2))
        arrays = [rng.randint(-300 << (bpp - 8), 300 << (bpp - 8),
                              (H, W)).astype(np.int32), inter,
                  comp, filt, refsel, mv16]
        refs = tuple(torch.as_tensor(rng.randint(0, 1 << bpp, (H, W)).astype(
            np.int32), device=DEVICE) for _ in range(3))
        jobs.append(tuple(torch.as_tensor(a, device=DEVICE) for a in arrays)
                    + (refs, w, h, mvsx, mvsy))
    return jobs


def mc_seeded(torch, np):
    """chip_smoke.py's two seeded 1920x1088 MC frames, on the card:
    (mc_frame's, mc_tile_frame's)."""
    rng = np.random.RandomState(SEED + 11)
    shapes = ((1088, 1920), (544, 960), (544, 960))
    visible = ((1920, 1080), (960, 540), (960, 540))
    return (mc_frame(torch, np, rng, shapes, visible),
            mc_tile_frame(torch, np, rng, shapes, visible))


def layout(ss_h, ss_v):
    """The name of a chroma subsampling."""
    return {(1, 1): "4:2:0", (1, 0): "4:2:2", (0, 1): "4:4:0",
            (0, 0): "4:4:4"}[ss_h, ss_v]


def mc_formats(torch, np, w=1920, h=1080):
    """Seeded w x h (1920x1080: 1088 coded) MC frames of the depths and
    layouts of
    MC_FORMATS, on the card, as recon_frame hands them to mc_planes: the
    chroma planes subsampled by (ss_h, ss_v), their MVs scaled by 2 on
    each axis that is not (mvsx, mvsy). [(name, jobs, bpp)], a motion a
    cell and a motion a tile of each."""
    rng = np.random.RandomState(SEED + 13)
    out = []
    for bpp, ss_h, ss_v in MC_FORMATS:
        H, W = -(-h // 64) * 64, -(-w // 64) * 64
        shapes = ((H, W),) + ((H >> ss_v, W >> ss_h),) * 2
        visible = ((w, h),) + (((w + ss_h) >> ss_h, (h + ss_v) >> ss_v),) * 2
        mvs = ((2, 2),) + ((1 << (1 - ss_h), 1 << (1 - ss_v)),) * 2
        name = f"seeded_{bpp}bit_{layout(ss_h, ss_v)}"
        out.append((name + "_cells", mc_frame(torch, np, rng, shapes,
                                              visible, mvs, bpp), bpp))
        out.append((name + "_tiles", mc_tile_frame(torch, np, rng, shapes,
                                                   visible, mvs, bpp), bpp))
    return out


def mc_paths(np, jobs, has_comp):
    """What csrc/mc.cu's warps do on `jobs`, counted on the host from the
    grids: {tiles, passes (a reference of a tile with a cell that uses
    it), window (passes whose cells share one motion), mx0 and my0
    (window passes at phase 0 on that axis)}."""
    n = dict.fromkeys(("tiles", "passes", "window", "mx0", "my0"), 0)
    for _res, inter4, comp, filt, refsel, mv16, _r, _w, _h, mvsx, \
            mvsy in jobs:
        inter = inter4.cpu().numpy()
        r4, c4 = inter.shape
        tr, tc = -(-r4 // 4), -(-c4 // 4)

        def tiles(a):
            a = np.pad(a, [(0, 4 * tr - r4), (0, 4 * tc - c4)]
                       + [(0, 0)] * (a.ndim - 2))
            return a.reshape(tr, 4, tc, 4, *a.shape[2:]).swapaxes(
                1, 2).reshape(tr, tc, 16, *a.shape[2:])

        n["tiles"] += tr * tc
        cmp = inter & comp.cpu().numpy() if has_comp else inter & False
        mv = mv16.cpu().numpy().astype(np.int64)
        sel = refsel.cpu().numpy()
        bank = tiles(np.clip(filt.cpu().numpy(), 0, 3))
        for ri, act in enumerate((inter, cmp)):
            act = tiles(act)
            key = np.stack([tiles(np.clip(sel[..., ri], 0, 2)),
                            tiles(mv[..., ri, 0] * mvsx),
                            tiles(mv[..., ri, 1] * mvsy), bank], -1)
            used = act.any(-1)
            lead = np.take_along_axis(key, act.argmax(-1)[..., None, None],
                                      2)
            one = (~act | (key == lead).all(-1)).all(-1) & used
            n["passes"] += int(used.sum())
            n["window"] += int(one.sum())
            n["mx0"] += int((one & (lead[:, :, 0, 1] & 15 == 0)).sum())
            n["my0"] += int((one & (lead[:, :, 0, 2] & 15 == 0)).sum())
    return n


def mc_phase(torch, np, calls):
    """mc_planes (csrc/mc.cu) on the real inputs of bench_1080p frames 1
    and 2 (three planes in one launch each), then on two seeded full-size
    frames, one motion a cell (mc_frame) and one a tile (mc_tile_frame):
    the kernel against the plain version on the card, bit for bit; its
    device time per frame on the card's clock (device_ms) on every input,
    the wrapper's call under CUDA events and the plain version's time;
    the bound from mc_work over the three planes; the share of each
    input's tile passes that take the window path, and its phase-0
    skips."""
    from ffmpeg_hybrid_tpu_torch.ops import recon as R
    if len(calls) != 2:
        raise RuntimeError(f"frames 1-2 ran {len(calls)} MC calls, "
                           "expected 2")
    seeded, tiled = mc_seeded(torch, np)
    err = 0
    ms = call_ms = plain_ms = nbytes = nops = 0.0
    notes, seeded_ms = [], {}
    for which, (jobs, bpp, has_comp) in \
            [("bench_1080p", c) for c in calls] \
            + [("seeded_cells", (seeded, 8, True)),
               ("seeded_tiles", (tiled, 8, True))] \
            + [(name, (jobs, bpp, True))
               for name, jobs, bpp in mc_formats(torch, np)]:
        outs = R.mc_planes(jobs, bpp, has_comp)
        wants, t = host_ms(torch, lambda: R.mc_planes_plain(jobs, bpp,
                                                            has_comp))
        e = max_diff(outs, wants)
        err = max(err, e)
        if e:
            raise RuntimeError(f"mc_planes on {which}: kernel != plain "
                               f"(max |diff| {e})")

        def call():
            R.mc_planes(jobs, bpp, has_comp)
        k_ms, _n = device_ms(torch, call, 50, ("mc_kernel",), 1)
        b = o = 0
        for job in jobs:
            jb, jo = mc_work(np, job, has_comp)
            b += jb
            o += jo
        paths = mc_paths(np, jobs, has_comp)
        inter = sum(int(j[1].sum()) for j in jobs)
        comp = sum(int((j[1] & j[2]).sum()) for j in jobs) if has_comp \
            else 0
        say("kernels", f"mc_planes on {which} ({inter} inter cells, {comp} "
            f"compound): {k_ms:.5f} ms on the card, bound "
            f"{bounds(b, o, 0)[0]:.6f}; {paths['window']} of "
            f"{paths['passes']} tile passes "
            f"({paths['window'] / max(paths['passes'], 1):.4f}) take the "
            f"window path, {paths['mx0']} of them skip the horizontal "
            f"pass and {paths['my0']} the vertical ({paths['tiles']} "
            "tiles)")
        if which != "bench_1080p":
            seeded_ms[which] = k_ms
            continue
        ms += k_ms
        call_ms += cuda_ms(call, 50)
        plain_ms += t
        nbytes += b
        nops += o
        notes.append(f"{inter} inter cells ({comp} compound): "
                     f"{k_ms:.5f} ms")
    nf = len(calls)
    bound_ms, bound_by, _chain = bounds(nbytes / nf, nops / nf, 0)
    say("kernels", f"mc_planes on bench_1080p frames 1-2 ({'; '.join(notes)}"
        f"): ms/frame={ms / nf:.5f} on the card (the wrapper's call under "
        f"CUDA events {call_ms / nf:.4f}) plain_ms/frame={plain_ms / nf:.2f} "
        f"bound_ms/frame={bound_ms:.6f} ({bound_by}, {nbytes / nf:.0f} B, "
        f"{nops / nf:.0f} ops); exact vs plain, also on the seeded "
        "1920x1088 frames of a motion a cell (MVs to 150 px, every bank, "
        "every inter cell compound) and a motion a tile, at 8 bpp 4:2:0 and "
        "at " + ", ".join(f"{b} bpp {layout(h, v)}"
                          for b, h, v in MC_FORMATS))
    return {"name": "mc_planes", "route": "cuda", "source": MC_SRC,
            "replaces": MC_REPLACES, "launches": None, "max_abs_err": err,
            "ms": ms / nf, "plain_ms": plain_ms / nf, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "per": "frame (Y, U, V in one launch), mean of bench_1080p "
                   "frames 1 and 2",
            "call_ms": call_ms / nf, "bytes_needed": nbytes / nf,
            "ops": nops / nf, "seeded_ms": seeded_ms}


def random_records(np, rng, rows8, cols8, mv_lim, square=None):
    """Block records of a random partition of a rows8 x cols8 grid of 8x8
    units, superblock by superblock (every block size, sub-8x8 included;
    with `square` (0-3), every block of that square size: 64 >> square
    pixels a side), all inter: half compound, random references and
    filter banks, raw MVs to mv_lim (1/8 pel); bucket-padded with pad
    rows as recon._pack_records leaves them."""
    from ffmpeg_hybrid_tpu_torch.ops import recon as R
    rows = []

    def leaf(r, c, bs):
        if r < rows8 and c < cols8:
            rows.append((r, c, bs))

    def part(r, c, lvl):
        if r >= rows8 or c >= cols8:
            return
        n = 8 >> lvl
        if lvl == square:
            leaf(r, c, 3 * lvl)
            return
        if square is not None:
            for dr in (0, n // 2):
                for dc in (0, n // 2):
                    part(r + dr, c + dc, lvl + 1)
            return
        if lvl == 3:
            leaf(r, c, 9 + rng.randint(0, 4))
            return
        p = rng.choice(4, p=(0.2, 0.15, 0.15, 0.5))
        if p == 0:
            leaf(r, c, 3 * lvl)
        elif p == 1:
            leaf(r, c, 3 * lvl + 1)
            leaf(r + n // 2, c, 3 * lvl + 1)
        elif p == 2:
            leaf(r, c, 3 * lvl + 2)
            leaf(r, c + n // 2, 3 * lvl + 2)
        else:
            for dr in (0, n // 2):
                for dc in (0, n // 2):
                    part(r + dr, c + dc, lvl + 1)

    for r in range(0, rows8, 8):
        for c in range(0, cols8, 8):
            part(r, c, 0)
    n = len(rows)
    recs = np.zeros((R._pad_to_bucket(n + 1, base=256, mult=2), 36), np.int16)
    recs[:n, [0, 1, 3]] = rows
    recs[:n, 14] = rng.rand(n) < 0.5
    recs[:n, 15:17] = rng.randint(0, 3, (n, 2))
    recs[:n, 17] = rng.randint(0, 4, n)
    recs[:n, 18:34] = rng.randint(-mv_lim, mv_lim + 1, (n, 16))
    recs[n:, 3] = -1
    return recs


def ref_sizes(frame, refs):
    """(scales, steps) of references of luma sizes `refs` for a frame of
    luma size `frame`, as the decoder computes them (0 for its size)."""
    w, h = frame
    sc = [[(rw << 14) // w, (rh << 14) // h] if (rw, rh) != (w, h)
          else [0, 0] for rw, rh in refs]
    return sc, [[16 * a >> 14, 16 * b >> 14] for a, b in sc]


def mc_scaled_frame(torch, np, rng, frame, refs, bpp=8, ss_h=1, ss_v=1,
                    square=None):
    """A seeded frame for mc_planes_scaled on the card, as recon_frame
    hands it over: random records of a `frame` (luma w, h) frame
    (random_records, MVs to 500 px; `square` 1: every block 32x32, so
    that a motion covers each 16x16 tile of every plane), the splat
    kernel's grids and index state from them, random `bpp`-bit
    reference planes of the luma sizes `refs` (padded to 64 px) and
    random residuals. Returns the call's arguments, as mc_planes_scaled
    takes them."""
    from ffmpeg_hybrid_tpu_torch.ops import recon as R
    from ffmpeg_hybrid_tpu_torch.ops import recon_cuda as RC
    w, h = frame
    cols, rows = (w + 7) >> 3, (h + 7) >> 3
    r4, c4 = -(-h // 64) * 16, -(-w // 64) * 16
    recs = torch.as_tensor(random_records(np, rng, rows, cols, 4000, square),
                           device=DEVICE)
    states = {}
    grids = R._grids_from_records(recs, r4, c4, ss_h, ss_v, states=states)
    index = RC.splat_state(states, torch.device(DEVICE), r4, c4)
    scales, steps = ref_sizes(frame, refs)
    jobs = []
    for p in range(3):
        ss_x, ss_y = (ss_h, ss_v) if p else (0, 0)
        g = grids[7 * (p > 0):7 * (p > 0) + 7]
        planes, dims = [], []
        for rw, rh in refs:
            Hp, Wp = -(-rh // 64) * 64 >> ss_y, -(-rw // 64) * 64 >> ss_x
            planes.append(torch.as_tensor(rng.randint(
                0, 1 << bpp, (Hp, Wp)).astype(np.int32), device=DEVICE))
            dims.append(((rw + ss_x) >> ss_x, (rh + ss_y) >> ss_y))
        H, W = (r4 * 4) >> ss_y, (c4 * 4) >> ss_x
        residual = torch.as_tensor(rng.randint(
            -300 << (bpp - 8), 300 << (bpp - 8), (H, W)).astype(np.int32),
            device=DEVICE)
        jobs.append((residual, g[0], g[3], g[4], g[5], g[6], tuple(planes),
                     tuple(dims), ss_x, ss_y))
    return [jobs, bpp, True, recs, scales, steps, cols, rows, index]


# seeded scaled-MC frames at 1920x1080: the references' luma sizes (a 2x
# downscale at step 32, the frame's own size, 1.5x down; a 16x upscale at
# step 1, the frame's size, 2x up); "tiles", of 32x32 blocks (a motion a
# 16x16 tile in every plane: the window path), steps 32, 8 and 1
SCALED_REFS = {"down": ((3840, 2160), (1920, 1080), (2880, 1620)),
               "up": ((120, 68), (1920, 1080), (960, 540)),
               "tiles": ((3840, 2160), (960, 540), (120, 68))}


def mc_scaled_work(np, args):
    """(bytes, operations) an mc_planes_scaled call must move and do: each
    output pixel written once; per inter pixel its residual; the grids
    (MC_CELL_BYTES a cell); the records and the index; per inter pixel
    and reference the reference pixels it covers, (step_x / 16) x
    (step_y / 16) of them scaled and one unscaled, each reference plane
    at most its visible area; 8 multiply-adds (two operations each) a
    pixel and reference for the vertical pass, and for the horizontal
    one 8 a row of the rows a 4-pixel column needs (11 unscaled, at most
    8 + ceil(3 step_y / 16) scaled)."""
    jobs, _bpp, has_comp, recs, scales, steps, _c, _r, index = args
    nbytes = recs.numel() * 2 + index.bidx.numel() * 8
    nops = 0
    for residual, inter4, comp, _f, refsel, _mv, refs, dims, _sx, \
            _sy in jobs:
        H, W = residual.shape
        inter = inter4.cpu().numpy()
        act = [inter, inter & comp.cpu().numpy() if has_comp
               else inter & False]
        sel = refsel.cpu().numpy().clip(0, 2)
        covered = {}      # reference plane -> pixels read, at most its area
        for ri, a in enumerate(act):
            for k in range(3):
                n = int((a & (sel[..., ri] == k)).sum())
                if not n:
                    continue
                sx, sy = steps[k] if scales[k][0] else (16, 16)
                key = refs[k].data_ptr()
                covered[key] = min(covered.get(key, 0)
                                   + 16 * n * sx * sy / 256,
                                   dims[k][0] * dims[k][1])
                nrows = 8 + -(-3 * sy // 16) if scales[k][0] else 11
                nops += n * 2 * (16 * 8 + 4 * nrows * 8)
        nbytes += H * W * 4 + int(inter.sum()) * 64 \
            + inter.size * MC_CELL_BYTES + 4 * sum(covered.values())
    return int(nbytes), nops


def mc_scaled_keys(np, job, ri, recs, scales, steps, cols, rows, bidx,
                   epoch):
    """The motion keys of csrc/mc.cu's scaled kernel for reference ri of
    one plane's job, on the host: (act [r4, c4] the cells that use it,
    key [r4, c4, 4]: slot, bank and the map's 1/16-pel position at the
    cell's 16x16 tile's origin, column and row). bidx: the splat's index
    entries (uint64 as int64) at `epoch`; the kernel's arithmetic: the
    record of luma cell (i << ss_y, j << ss_x), the anchor, the MV clamp,
    the 64-bit start, the line through the cell's first pixel."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9 import tables as T
    _res, inter4, comp, filt, refsel, mv, _refs, _dims, ss_x, ss_y = job
    inter = inter4.cpu().numpy().astype(bool)
    act = inter & comp.cpu().numpy().astype(bool) if ri else inter
    r4, c4 = inter.shape
    sel = np.clip(refsel.cpu().numpy()[..., ri], 0, 2).astype(np.int64)
    bank = np.clip(filt.cpu().numpy(), 0, 3).astype(np.int64)
    mvx = mv.cpu().numpy()[..., ri, 0].astype(np.int64)
    mvy = mv.cpu().numpy()[..., ri, 1].astype(np.int64)
    sc = np.asarray(scales, np.int64)[sel]
    st = np.asarray(steps, np.int64)[sel]
    scaled = sc[..., 0] != 0
    ii, jj = np.mgrid[:r4, :c4]
    yc, xc = 4 * ii, 4 * jj
    # the record of each cell, from the unit index
    rc = np.asarray(recs.cpu() if hasattr(recs, "cpu") else recs,
                    np.int64)
    n = len(rc)
    c8 = ((c4 << ss_x) + 1) // 2
    e = np.asarray(bidx, np.int64).reshape(-1)[((ii << ss_y) >> 1) * c8
                                               + ((jj << ss_x) >> 1)]
    b = np.where((e >> 32) & 0xffffffff == epoch,
                 np.minimum(e & 0xffffffff, n - 1), n - 1)
    brow, bcol, bs = rc[b, 0], rc[b, 1], rc[b, 3]
    sub8 = bs > 9
    bwh = np.asarray(T.BWH_TAB[1], np.int64)[np.clip(bs, 0, 12)]
    by, bx = (brow * 8) >> ss_y, (bcol * 8) >> ss_x
    ay = by + (np.where(sub8, ((ii - brow * 2) & 1) * 4, 0) if not ss_y
               else 0)
    ax = bx + (np.where(sub8, ((jj - bcol * 2) & 1) * 4, 0) if not ss_x
               else 0)
    pw, ph = (bwh[..., 0] * 8) >> ss_x, (bwh[..., 1] * 8) >> ss_y

    def axis(mvr, b0, span, n8, ss, a0, s, step, c):
        lo = -(b0 + span + 4) * (16 if ss else 8)
        hi = (n8 * 4 - b0 + 3) * 16 if ss else (n8 * 8 - b0 + 3) * 8
        m = np.clip(mvr, lo, hi)
        pa = a0 * s
        t0 = ((m * s) >> 14) + ((pa >> 10) & ~15) + ((pa >> 9) & 15) \
            if ss else ((m * 2 * s) >> 14) + (pa >> 10)
        pos = 16 * (t0 >> 4) + (t0 & 15) + (c - a0) * step
        return np.where(scaled, pos, 16 * c + mvr * (2 >> ss))
    px = axis(mvx, bx, pw, cols, ss_x, ax, sc[..., 0], st[..., 0], xc)
    py = axis(mvy, by, ph, rows, ss_y, ay, sc[..., 1], st[..., 1], yc)
    stx = np.where(scaled, st[..., 0], 16)
    sty = np.where(scaled, st[..., 1], 16)
    key = np.stack([sel, bank, px + ((xc & ~15) - xc) * stx,
                    py + ((yc & ~15) - yc) * sty], -1)
    return act, key


def mc_scaled_paths(np, args):
    """What csrc/mc.cu's scaled kernel's warps do on an mc_planes_scaled
    call (its arguments), counted on the host: {tiles, passes (a
    reference of a tile with a cell that uses it), window (passes whose
    cells share one motion key: one window), walk (the others)}."""
    jobs, _bpp, has_comp, recs, scales, steps, cols, rows, index = args
    bidx = index.bidx.cpu().numpy()
    n = dict.fromkeys(("tiles", "passes", "window", "walk"), 0)
    for job in jobs:
        r4, c4 = job[1].shape
        tr, tc = -(-r4 // 4), -(-c4 // 4)

        def tiles(a):
            a = np.pad(a, [(0, 4 * tr - r4), (0, 4 * tc - c4)]
                       + [(0, 0)] * (a.ndim - 2))
            return a.reshape(tr, 4, tc, 4, *a.shape[2:]).swapaxes(
                1, 2).reshape(tr, tc, 16, *a.shape[2:])
        n["tiles"] += tr * tc
        for ri in ((0, 1) if has_comp else (0,)):
            act, key = mc_scaled_keys(np, job, ri, recs, scales, steps,
                                      cols, rows, bidx, index.epoch)
            act, key = tiles(act), tiles(key)
            used = act.any(-1)
            lead = np.take_along_axis(key, act.argmax(-1)[..., None, None],
                                      2)
            one = (~act | (key == lead).all(-1)).all(-1) & used
            n["passes"] += int(used.sum())
            n["window"] += int(one.sum())
            n["walk"] += int((used & ~one).sum())
    return n


def kernel_paths(np, which, args, counted):
    """The tile passes of an mc_planes_scaled call (its arguments) by
    path, as the kernel's warps counted them into `counted` (int64 [2]:
    window, walk): {tiles, passes, window, walk}. Raises unless the host
    model (mc_scaled_paths) counts the same."""
    window, walk = (int(v) for v in counted.tolist())
    model = mc_scaled_paths(np, args)
    if (window, walk) != (model["window"], model["walk"]):
        raise RuntimeError(f"mc_planes_scaled on {which}: the kernel's warps"
                           f" counted {window} window and {walk} walk tile "
                           f"passes, the host model {model}")
    return {"tiles": model["tiles"], "passes": window + walk,
            "window": window, "walk": walk}


def mc_scaled_seeded(torch, np):
    """chip_smoke.py's seeded 1920x1080 scaled-MC frames, on the card:
    [(name, mc_planes_scaled's arguments)] for each of SCALED_REFS at 8
    bpp 4:2:0 ("tiles" of 32x32 blocks, a motion a tile), then "down"
    and "up" in turns at MC_FORMATS' depths and layouts."""
    rng = np.random.RandomState(SEED + 17)
    seeded = [(f"seeded_{k}_8bit_4:2:0",
               mc_scaled_frame(torch, np, rng, (1920, 1080), refs,
                               square=1 if k == "tiles" else None))
              for k, refs in SCALED_REFS.items()]
    for i, (bpp, ss_h, ss_v) in enumerate(MC_FORMATS):
        k = ("down", "up")[i % 2]
        seeded.append((f"seeded_{k}_{bpp}bit_{layout(ss_h, ss_v)}",
                       mc_scaled_frame(torch, np, rng, (1920, 1080),
                                       SCALED_REFS[k], bpp, ss_h, ss_v)))
    return seeded


def mc_scaled_phase(torch, np, calls):
    """mc_planes_scaled (csrc/mc.cu's scaled entry) on the real inputs of
    resize_1080p frames 1-5 (each frame's three planes in one launch,
    the index of the splat that made its grids), then on seeded
    1920x1080 frames (SCALED_REFS: steps 32 and 1, every bank, compound
    cells that mix a scaled and a same-size slot) at 8 bpp 4:2:0 and at
    MC_FORMATS' depths and layouts: the kernel against the plain version
    on the card, bit for bit; its device time on the card's clock, the
    wrapper's call under CUDA events, the plain version's time; the
    bound from mc_scaled_work."""
    from ffmpeg_hybrid_tpu_torch.ops import recon as R
    if len(calls) != 5:
        raise RuntimeError(f"{RESIZE_CLIP} ran {len(calls)} scaled-MC calls,"
                           " expected 5")
    seeded = mc_scaled_seeded(torch, np)
    err = 0
    ms = call_ms = plain_ms = nbytes = nops = 0.0
    notes, seeded_ms, paths = [], {}, {}
    card = card_line()
    for which, args in [(f"{RESIZE_CLIP} frame {i + 1}", a)
                        for i, a in enumerate(calls)] + seeded:
        counted = torch.zeros(2, dtype=torch.int64, device="cuda")
        outs = R.mc_planes_scaled(*args, paths=counted)
        wants, t = host_ms(torch, lambda: R.mc_planes_scaled_plain(
            *args[:-1]))
        e = max_diff(outs, wants)
        err = max(err, e)
        if e:
            raise RuntimeError(f"mc_planes_scaled on {which}: kernel != "
                               f"plain (max |diff| {e})")

        def call():
            R.mc_planes_scaled(*args)
        k_ms, _n = device_ms(torch, call, PROFILE_REPS, ("mc_scaled_kernel",),
                             1)
        b, o = mc_scaled_work(np, args)
        jobs = args[0]
        inter = sum(int(j[1].sum()) for j in jobs)
        comp = sum(int((j[1] & j[2]).sum()) for j in jobs)
        n = paths[which] = kernel_paths(np, which, args, counted)
        say("kernels", f"mc_planes_scaled on {which} ({inter} inter cells, "
            f"{comp} compound; steps {args[5]}): {k_ms:.5f} ms on the "
            f"card ({card}), bound {bounds(b, o, 0)[0]:.6f} ({b} B, {o} "
            f"ops; {k_ms / bounds(b, o, 0)[0]:.2f} x); plain {t:.1f} ms; "
            f"paths, as its warps counted them: {n['window']} of "
            f"{n['passes']} tile passes on the window path "
            f"({100 * n['window'] / max(n['passes'], 1):.1f}%), "
            f"{n['walk']} walk the cells (the host model agrees)")
        if which.startswith("seeded"):
            seeded_ms[which] = k_ms
            continue
        ms += k_ms
        call_ms += cuda_ms(call, 20)
        plain_ms += t
        nbytes += b
        nops += o
        notes.append(f"{k_ms:.5f}")
    nf = len(calls)
    bound_ms, bound_by, _chain = bounds(nbytes / nf, nops / nf, 0)
    say("kernels", f"mc_planes_scaled on {RESIZE_CLIP} frames 1-5 "
        f"({', '.join(notes)} ms): ms/frame={ms / nf:.5f} on the card (the "
        f"wrapper's call under CUDA events {call_ms / nf:.4f}) "
        f"plain_ms/frame={plain_ms / nf:.2f} bound_ms/frame={bound_ms:.6f} "
        f"({bound_by}, {nbytes / nf:.0f} B, {nops / nf:.0f} ops); exact vs "
        "plain, also on seeded 1920x1080 frames at steps 32 and 1 with "
        "every bank and compound cells mixing a scaled and a same-size "
        "slot, at 8 bpp 4:2:0 and at "
        + ", ".join(f"{b} bpp {layout(h, v)}" for b, h, v in MC_FORMATS)
        + f", and a frame of a motion a tile at steps 32, 8 and 1; {card}; "
        f"ptxas: {ptxas_of(MC_SRC, 'mc_scaled_kernel')}")
    if not all(paths[k]["window"] and paths[k]["walk"] for k in paths
               if k.startswith(("seeded_down_8", "seeded_up_8"))) \
            or paths["seeded_tiles_8bit_4:2:0"]["walk"]:
        raise RuntimeError(f"mc_planes_scaled: the seeded frames do not "
                           f"drive both paths as meant: {paths}")
    return {"name": "mc_planes_scaled", "route": "cuda", "source": MC_SRC,
            "replaces": MC_SCALED_REPLACES, "launches": None,
            "max_abs_err": err, "ms": ms / nf, "plain_ms": plain_ms / nf,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "per": f"frame (Y, U, V in one launch), mean of {RESIZE_CLIP} "
                   "frames 1-5",
            "call_ms": call_ms / nf, "bytes_needed": nbytes / nf,
            "ops": nops / nf, "seeded_ms": seeded_ms, "paths": paths,
            "ptxas": ptxas_of(MC_SRC, "mc_scaled_kernel")}


def intra_work(np, jobs):
    """(bytes, operations, real blocks, covered pixels) one
    _intra_scan_planes call on `jobs` must move and do: each new plane
    written once; the old plane read only where no intra block writes,
    the residual only where one does; the slab rows of real blocks (a
    slab that two planes share, once) and, once per (size, mode) pair
    used, its tap words (directional modes) or its weight column (the DC
    family) from the tap table. Operations: per pixel of a directional
    block a multiply and an add per tap (at most three) and TM's 3, then
    the rounding, residual add and clip (4); per DC-family block the
    multiply-adds of its column and the rounding (2), then per pixel the
    residual add and clip (2)."""
    from ffmpeg_hybrid_tpu_torch.ops import intra_tables as it
    from ffmpeg_hybrid_tpu_torch.ops import recon_cuda as RC
    table, toff = RC.tap_table(), RC.tap_offsets()
    nbytes = ops = real_blocks = covered_px = 0
    pairs, slabs = set(), set()
    for plane, _residual, slab, L, sizes, caps in jobs:
        buf = slab.cpu().numpy().astype(np.int64)
        H, W = plane.shape
        covered = np.zeros((H, W), bool)
        nbytes += 2 * H * W * 4
        new_slab = slab.data_ptr() not in slabs
        slabs.add(slab.data_ptr())
        base = 0
        for sz, cap in zip(sizes, caps):
            rows = buf[base:base + L * cap]
            base += L * cap
            rows = rows[(rows[:, 0] < H) & (rows[:, 1] < W)]
            for py, px in rows[:, :2]:
                covered[py:py + sz, px:px + sz] = True
            real_blocks += len(rows)
            nbytes += len(rows) * 16 if new_slab else 0
            part = table[toff[sz]:]
            npx = sz * sz
            for m, n in zip(*np.unique(rows[:, 2], return_counts=True)):
                kind, o = int(part[m]) >> 24, int(part[m]) & 0xffffff
                if kind == RC.TAPS:
                    words = part[o:o + npx].astype(np.int64)
                    ops += int(n) * (2 * int((words >> 27).sum()) + 4 * npx)
                    held = 4 * npx
                elif kind == RC.COLUMN:
                    col = part[o:o + it.edge_len(sz)]
                    ops += int(n) * (2 * int(np.count_nonzero(col)) + 2
                                     + 2 * npx)
                    held = 4 * len(col)
                else:
                    ops += int(n) * 7 * npx
                    held = 0
                if (sz, int(m)) not in pairs:
                    pairs.add((sz, int(m)))
                    nbytes += held
        covered_px += int(covered.sum())
    return nbytes, ops, real_blocks, covered_px


def intra_windows(torch, jobs, bpp, wants):
    """The windows per level the intra kernel takes on each of `jobs`,
    from one launch on copies of the planes, whose results must be
    `wants`."""
    from ffmpeg_hybrid_tpu_torch.ops import recon as R
    from ffmpeg_hybrid_tpu_torch.ops import recon_cuda as RC
    outs = [job[0].clone() for job in jobs]
    windows = RC.intra([(o, *job[1:]) for o, job in zip(outs, jobs)], bpp,
                       R._const("edges", outs[0].device))
    for out, want in zip(outs, wants):
        if not torch.equal(out, want):
            raise RuntimeError(f"_intra_scan_planes at {windows} windows "
                               "per level != plain")
    return windows


def intra_phase(torch, np, calls):
    """_intra_scan_planes on the real inputs of bench_1080p_lf frame 0
    and bench_1080p frame 0 (a keyframe), Y, U and V in one launch as
    recon_frame hands them over: the kernel against the plain version on
    the card, bit for bit, with the launch's time, each plane's time
    alone (us per level), the windows per level, and the bound terms
    (bench_1080p_lf frame 0; the chain: the longest plane's levels);
    then Y, U's slab spread so that every level spans two windows or
    more, and V, in one launch."""
    from ffmpeg_hybrid_tpu_torch.ops import recon as R
    from ffmpeg_hybrid_tpu_torch.ops import recon_cuda as RC
    err = 0
    per_clip = {}
    for clip, (jobs, bpp) in calls.items():
        if len(jobs) != 3:
            raise RuntimeError(f"{clip} frame 0 handed {len(jobs)} planes "
                               "to the intra stage, expected Y, U and V")
        outs = R._intra_scan_planes(jobs, bpp)
        wants, plain_ms = host_ms(torch, lambda: [
            R._intra_scan_plain(*job, bpp) for job in jobs])
        for out, want, job in zip(outs, wants, jobs):
            err = max(err, int((out - want).abs().max()))
            if not torch.equal(out, want):
                raise RuntimeError(f"_intra_scan_planes on {clip} "
                                   f"{tuple(job[0].shape)}: kernel != plain"
                                   f" (max |diff| {err})")
            if not int((out != job[0]).sum()):
                raise RuntimeError("the intra wavefront changed no pixel")
        ms = cuda_ms(lambda: R._intra_scan_planes(jobs, bpp), 5)
        alone = [cuda_ms(lambda: R._intra_scan(*job, bpp), 5)
                 for job in jobs]
        windows = intra_windows(torch, jobs, bpp, wants)
        nbytes, nops, nreal, covered = intra_work(np, jobs)
        chain = max(job[3] for job in jobs)
        planes = [f"{name} {tuple(job[0].shape)} L={job[3]} sizes={job[4]}"
                  f" caps={job[5]} {w} window(s) per level: alone "
                  f"{t:.4f} ms = {t * 1e3 / job[3]:.3f} us per level"
                  for name, job, w, t in zip("YUV", jobs, windows, alone)]
        say("kernels", f"_intra_scan_planes on {clip} frame 0 ({nreal} "
            f"blocks over {covered} pixels; {'; '.join(planes)}): one "
            f"launch of the three planes ms={ms:.4f} (sum of the planes "
            f"alone {sum(alone):.4f}) plain_ms={plain_ms:.1f}; exact vs "
            "plain")
        per_clip[clip] = {
            "ms": ms, "plain_ms": plain_ms, "plane_ms_alone": alone,
            "us_per_level": [t * 1e3 / job[3] for t, job in zip(alone,
                                                                jobs)],
            "levels": [job[3] for job in jobs], "windows": windows,
            "bytes_needed": nbytes, "ops": nops, "chain_levels": chain}
    # U's slab spread to more rows per level than a window's 1024
    # threads, launched between Y and V: each of U's levels lies in two
    # windows or more, and the windows cross the sections
    jobs, bpp = calls["bench_1080p_lf"]
    plane, residual, slab, L, sizes, caps = jobs[1]
    wide = RC.spread_slab((slab.cpu().numpy(), L, sizes, caps),
                          tuple((1024 // sum(caps) + 1) * c for c in caps),
                          *plane.shape, seed=SEED)
    spread = [jobs[0], (plane, residual, torch.as_tensor(
        wide[0], device=DEVICE), *wide[1:]), jobs[2]]
    windows = intra_windows(torch, spread, bpp, [
        R._intra_scan_plain(*job, bpp) for job in spread])
    if windows[1] < 2:
        raise RuntimeError(f"the spread slab took {windows[1]} window(s)")
    say("kernels", f"_intra_scan_planes with U spread to caps={wide[3]}: "
        f"windows per level {windows} (Y, U, V), exact vs plain")
    lf = per_clip["bench_1080p_lf"]
    bound_ms, bound_by, chain_ms = bounds(lf["bytes_needed"], lf["ops"],
                                          lf["chain_levels"])
    say("kernels", f"_intra_scan_planes on bench_1080p_lf frame 0: "
        f"ms={lf['ms']:.4f} bound_ms={bound_ms:.6f} ({bound_by}, "
        f"{lf['bytes_needed']} B, {lf['ops']} ops) chain_ms={chain_ms:.6f} "
        f"({lf['chain_levels']} levels, the longest plane)")
    return {"name": "_intra_scan_planes", "route": "cuda",
            "source": INTRA_SRC, "replaces": INTRA_REPLACES,
            "launches": None, "max_abs_err": err, "ms": lf["ms"],
            "plain_ms": lf["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "per": "frame (Y, U, V in one launch) of bench_1080p_lf frame 0",
            "bytes_needed": lf["bytes_needed"], "ops": lf["ops"],
            "chain_levels": lf["chain_levels"], "chain_bound_ms": chain_ms,
            "spread_windows": windows[1], "by_clip": per_clip}


def max_diff(outs, wants):
    """Largest |difference| over pairs of integer or bool tensors; raises
    if a pair differs in dtype or shape."""
    err = 0
    for out, want in zip(outs, wants):
        if out.dtype != want.dtype or out.shape != want.shape:
            raise RuntimeError(f"{out.dtype} {tuple(out.shape)} != "
                               f"{want.dtype} {tuple(want.shape)}")
        err = max(err, int((out.long() - want.long()).abs().max()))
    return err


def splat_phase(torch, np, calls, call_4k):
    """_grids_from_records on the records of bench_1080p frames 0-1 and
    bench_1080p_lf frame 0 as recon_frame hands them over ({clip: [args,
    ...]}), and on those of bench_4k frame 1 (call_4k, an inter frame),
    then on each with MVs drawn from SEED under the three other
    subsamplings: the kernel against the plain version on the card, all
    14 grids bit for bit with their dtypes; its device time and device
    ops per call (device_ms), the wrapper's call under CUDA events and
    the plain version's time, on the clips' own subsampling; the bound:
    the records read and the grids written once, and SPLAT_CELL_OPS a
    cell. The mean over the three 1080p frames is the kernel's line;
    bench_4k is reported beside it."""
    from ffmpeg_hybrid_tpu_torch.ops import recon as R
    rng = np.random.RandomState(SEED)
    err = 0
    ms = call_ms = plain_ms = nbytes = nops = 0.0
    shapes, ops_per_call, k4 = [], [], {}
    states = {}     # the index state, kept across calls as a decoder's
    real = [(clip, args) for clip, cl in calls.items() for args in cl]
    for clip, args in real + [("bench_4k", call_4k)]:
        recs, r4, c4, ss_h, ss_v = args
        if (ss_h, ss_v) != (1, 1):
            raise RuntimeError(f"{clip} is not 4:2:0")
        seeded = recs.clone()
        seeded[:, 18:34] = torch.as_tensor(rng.randint(
            -301, 302, (recs.shape[0], 16)), dtype=torch.int16,
            device=DEVICE)
        for rr, ss in [(recs, (1, 1))] + [(seeded, ss)
                                          for ss in SUBSAMPLINGS[1:]]:
            outs = R._grids_from_records(rr, r4, c4, *ss, states=states)
            wants, t = host_ms(torch, lambda: R._grids_from_records_plain(
                rr, r4, c4, *ss))
            e = max_diff(outs, wants)
            err = max(err, e)
            if e:
                raise RuntimeError(f"_grids_from_records on {clip} under "
                                   f"{ss}: kernel != plain (max |diff| {e})")
            if rr is not recs:
                continue

            def call():
                R._grids_from_records(recs, r4, c4, ss_h, ss_v,
                                      states=states)
            kernel_ms, dev_ops = device_ms(torch, call, 50,
                                           ("splat_", "Memset"), 2)
            b = recs.numel() * 2 + sum(o.numel() * o.element_size()
                                       for o in outs)
            o = SPLAT_CELL_OPS * (r4 * c4 + outs[8].numel())
            ops_per_call.append(dev_ops)
            shapes.append(f"{clip} {tuple(recs.shape)} records, {r4}x{c4} "
                          f"cells: {kernel_ms:.5f} ms on the card in "
                          f"{dev_ops:g} device ops")
            if clip == "bench_4k":
                k4 = {"ms": kernel_ms, "plain_ms": t, "device_ops": dev_ops,
                      "bound_ms": bounds(b, o, 0)[0], "bytes_needed": b,
                      "records": list(recs.shape), "cells": [r4, c4]}
                continue
            plain_ms += t
            ms += kernel_ms
            call_ms += cuda_ms(call, 50)
            nbytes += b
            nops += o
    nf = len(real)
    bound_ms, bound_by, _chain = bounds(nbytes / nf, nops / nf, 0)
    say("kernels", f"_grids_from_records on {'; '.join(shapes)}: "
        f"ms/frame={ms / nf:.5f} over the 1080p frames (the wrapper's "
        f"call, host-bound under CUDA events, {call_ms / nf:.4f}) "
        f"plain_ms/frame={plain_ms / nf:.2f} bound_ms/frame={bound_ms:.6f} "
        f"({bound_by}, {nbytes / nf:.0f} B, {nops / nf:.0f} ops); "
        f"bench_4k frame 1: {k4['ms']:.5f} ms, bound {k4['bound_ms']:.6f}; "
        "exact vs plain (14 grids, dtypes), also with seeded MVs under "
        "4:2:2, 4:4:0 and 4:4:4")
    return {"name": "_grids_from_records", "route": "cuda",
            "source": SPLAT_SRC, "replaces": SPLAT_REPLACES,
            "launches": None, "max_abs_err": err, "ms": ms / nf,
            "plain_ms": plain_ms / nf, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "per": "frame (an index launch and a gather launch), mean of "
                   "bench_1080p frames 0-1 and bench_1080p_lf frame 0",
            "call_ms": call_ms / nf, "bytes_needed": nbytes / nf,
            "ops": nops / nf, "device_ops_per_call": ops_per_call,
            "bench_4k_frame_1": k4}


def lf_grids_phase(torch, np, call, call_4k):
    """grids_device on the levels and masks of bench_1080p_lf frame 0 and
    of bench_4k frame 0 (its filtered keyframe) as the decoder hands
    them over, under all four subsamplings: the kernel against the plain
    version on the card, bit for bit; its device time and device ops per
    call (device_ms), the wrapper's call under CUDA events and the plain
    version's time, under the clip's own subsampling; the bound: the
    levels, masks and tables read and the four grids written once, and
    LF_GRID_OPS a quad. bench_1080p_lf frame 0 is the kernel's line;
    bench_4k is reported beside it."""
    from ffmpeg_hybrid_tpu_torch.ops import lpf_masks as LM
    err = 0
    lines, found = [], {}
    for clip, args in (("bench_1080p_lf", call), ("bench_4k", call_4k)):
        lfl, lfm, luts, sb_rows, sb_cols, ss_h, ss_v = args
        if (ss_h, ss_v) != (1, 1):
            raise RuntimeError(f"{clip} is not 4:2:0")
        for ss in SUBSAMPLINGS:
            outs = LM.grids_device(lfl, lfm, luts, sb_rows, sb_cols, *ss)
            wants, t = host_ms(torch, lambda: LM.grids_device_plain(
                lfl, lfm, luts, sb_rows, sb_cols, *ss))
            e = max_diff(outs, wants)
            err = max(err, e)
            if e:
                raise RuntimeError(f"grids_device on {clip} under {ss}: "
                                   f"kernel != plain (max |diff| {e})")
            if ss == (ss_h, ss_v):
                plain_ms, grids = t, outs
        active = [int((g[..., 0] > 0).sum()) for g in grids]
        if not all(active):
            raise RuntimeError(f"{clip}: grids with no edge: {active} "
                               "active")

        def call_():
            LM.grids_device(lfl, lfm, luts, sb_rows, sb_cols, ss_h, ss_v)
        ms, dev_ops = device_ms(torch, call_, 50, ("lf_grids_kernel",), 1)
        quads = sum(g.numel() // 4 for g in grids)
        nbytes = lfl.numel() * 2 + (lfm.numel() + luts.numel()) * 4 \
            + quads * 16
        bound_ms, bound_by, _chain = bounds(nbytes, LF_GRID_OPS * quads, 0)
        found[clip] = {"ms": ms, "plain_ms": plain_ms, "device_ops": dev_ops,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "bytes_needed": nbytes, "ops": LF_GRID_OPS * quads,
                       "call_ms": cuda_ms(call_, 50),
                       "superblocks": [sb_rows, sb_cols]}
        lines.append(f"{clip} frame 0 ({sb_rows}x{sb_cols} superblocks; "
                     f"grids {[tuple(g.shape) for g in grids]}, {active} "
                     f"active edges): ms={ms:.5f} on the card in "
                     f"{dev_ops:g} device ops (the wrapper's call, "
                     "host-bound under CUDA events, "
                     f"{found[clip]['call_ms']:.4f}) plain_ms={plain_ms:.2f}"
                     f" bound_ms={bound_ms:.6f} ({bound_by}, {nbytes} B, "
                     f"{LF_GRID_OPS * quads} ops)")
    say("kernels", f"grids_device on {'; '.join(lines)}; exact vs plain "
        "under 4:2:0, 4:2:2, 4:4:0 and 4:4:4")
    k = found["bench_1080p_lf"]
    return {"name": "grids_device", "route": "cuda", "source": LF_GRIDS_SRC,
            "replaces": LF_GRIDS_REPLACES, "launches": None,
            "max_abs_err": err, "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None,
            "per": "frame (both plane sets in one launch) of "
                   "bench_1080p_lf frame 0",
            "call_ms": k["call_ms"], "bytes_needed": k["bytes_needed"],
            "ops": k["ops"], "device_ops_per_call": k["device_ops"],
            "bench_4k_frame_0": found["bench_4k"]}


def hbd_pairs_frame(np, rng, shapes):
    """A seeded 12-bit frame of planes `shapes` (Y, U, V) in the form
    recon_frame hands to scatter_frame and residual_planes: merged wide
    pair rows (pos-hi, pos-lo, value-hi, value-lo; in a random order,
    with pad rows among them) and per plane its eob, tx size and type
    grids: a size drawn per 32x32 region, every type, eobs 0, 1 (the DC
    shortcut), 2 and full at the roots; the coefficients of each coded
    root's tile (its DC alone where it is DC-only), the int32 values the
    dequant can wrap to: drawn over the whole int32 range, a third of
    them at INT32_MIN or INT32_MAX."""
    from ffmpeg_hybrid_tpu_torch.ops import recon as R
    planes, cpos, cval, epos, evals = [], [], [], [], []
    cbase = ebase = 0
    for H, W in shapes:
        r4, c4 = H // 4, W // 4
        tx = np.repeat(np.repeat(rng.randint(0, 4, (r4 // 8, c4 // 8)), 8,
                                 0), 8, 1)
        k = 1 << tx
        yy, xx = np.mgrid[:r4, :c4]
        root = (yy % k == 0) & (xx % k == 0)
        ty = rng.randint(0, 4, (r4, c4))
        full = (4 << tx) ** 2
        eob = np.where(root, np.choose(rng.randint(0, 5, (r4, c4)),
                                       [0 * full, 0 * full + 1, 0 * full + 1,
                                        0 * full + 2, full]), 0)
        ry, rx = yy - yy % k, xx - xx % k
        re = eob[ry, rx]
        rdc = (re == 1) & ((ty[ry, rx] == 0) | (tx == 3))
        mask = np.repeat(np.repeat((re > 0) & ~rdc, 4, 0), 4, 1)
        dy, dx = np.nonzero(root & (eob == 1) & ((ty == 0) | (tx == 3)))
        mask[4 * dy, 4 * dx] = True
        coef = rng.randint(-1 << 31, 1 << 31, (H, W), dtype=np.int64)
        pick = rng.rand(H, W)
        coef[pick < 1 / 6] = -1 << 31
        coef[(pick >= 1 / 6) & (pick < 1 / 3)] = (1 << 31) - 1
        coef = np.where(mask, coef, 0)
        cy, cx = np.nonzero(coef)
        cpos.append(cbase + cy * W + cx)
        cval.append(coef[cy, cx])
        ey, ex = np.nonzero(eob)
        epos.append(ebase + ey * c4 + ex)
        evals.append(eob[ey, ex])
        planes.append((eob.astype(np.int32), tx.astype(np.int32),
                       ty.astype(np.int32)))
        cbase += H * W
        ebase += r4 * c4

    def rows(pos, val, ncols):
        pos, val = np.concatenate(pos), np.concatenate(val)
        n = len(pos)
        out = np.zeros((n + 1024, ncols), np.int16)
        R._fill_pairs(out, pos, val, n)
        out[n:, 0] = -1                               # pad rows
        return out[rng.permutation(len(out))]

    return rows(cpos, cval, 4), rows(epos, evals, 3), cbase, ebase, planes


def hbd_roots(np, jobs, lossless):
    """{size: [coded roots, DC-only roots]} of a frame's planes [(coef,
    eob4, txsz4, txtype4)], summed over the planes."""
    out = {}
    for _coef, eob4, txsz4, txtype4 in jobs:
        e, t, ty = (np.asarray(g.cpu() if hasattr(g, "cpu") else g)
                    .astype(np.int64) for g in (eob4, txsz4, txtype4))
        yy, xx = np.mgrid[:e.shape[0], :e.shape[1]]
        for tx in ((0,) if lossless else range(4)):
            k = 1 << tx
            root = (t == tx) & (e > 0) & (yy % k == 0) & (xx % k == 0)
            dc = root & (e == 1) & ((ty == 0) | (tx == 3)) & (not lossless)
            n = out.setdefault(4 << tx, [0, 0])
            n[0] += int(root.sum())
            n[1] += int(dc.sum())
    return out


def kept_pair(torch, what, cp, ep, nc, ne, jobs, lossless, bpp):
    """recon_frame's scatter and consuming residual on a frame's pair rows
    cp, ep (buffers of nc and ne entries) and per plane jobs [(coef,
    eob4, txsz4, txtype4)] (only their grids and shapes are read): the
    scatter into a fresh kept buffer set against _scatter_pairs16/32, the
    consuming launch of the planes against residual_plane_plain, bit for
    bit, and the set reading zero after it. Returns (bufs, views,
    plain_jobs (the scattered planes, copied), outs, plain ms)."""
    from ffmpeg_hybrid_tpu_torch.ops import recon as R
    wide = cp.shape[1] == 4
    bufs = R.CoefBuffers(torch.device(DEVICE), nc, ne, wide)
    kept = R.scatter_frame(bufs, cp, ep)
    e = max_diff(kept, ((R._scatter_pairs32 if wide else R._scatter_pairs16)(
        cp, 1, nc)[0], R._scatter_pairs16(ep, 1, ne)[0]))
    views, bc, be = [], 0, 0
    for job in jobs:
        r4, c4 = job[1].shape
        views.append(R._slice_plane(kept[0][None], kept[1][None], bc, be,
                                    4 * r4, 4 * c4, r4, c4) + tuple(job[2:]))
        bc += 16 * r4 * c4
        be += r4 * c4
    if (bc, be) != (nc, ne):
        raise RuntimeError(f"{what}: planes of {bc} and {be} entries in "
                           f"buffers of {nc} and {ne}")
    # the consuming residual clears the buffers: the plain version's copy
    plain_jobs = [(v[0].clone(), v[1].clone(), v[2], v[3]) for v in views]
    outs = R.residual_planes(views, lossless, bpp, consume=[bufs] * len(jobs))
    wants, plain_ms = host_ms(torch, lambda: [
        R.residual_plane_plain(*job, lossless, bpp) for job in plain_jobs])
    e = max(e, max_diff(outs, wants))
    if e:
        raise RuntimeError(f"the scatter and residual on {what}: kernel != "
                           f"plain (max |diff| {e})")
    if not bufs.read_zero() or bufs.fill_cause() is not None:
        raise RuntimeError(f"{what}: the kept buffers do not read zero after "
                           "the consuming residual")
    if not sum(int(o.count_nonzero()) for o in outs):
        raise RuntimeError(f"{what}: the residuals are zero everywhere")
    return bufs, views, plain_jobs, outs, plain_ms


def residual_hbd_phase(torch, np, scatter_calls, residual_calls,
                       seeded_shape=(1088, 1920)):
    """The high-bit-depth residual (csrc/itxfm.cu residual_planes_hbd) on
    the real inputs of frame 0 of the 10-bit and the 12-bit clip ({clip:
    args} of scatter_frame and residual_planes, as recon_frame hands them
    over), then on a seeded full-size 12-bit 4:4:4 frame whose
    coefficients reach the int32 extremes (hbd_pairs_frame): the wide
    scatter into a kept buffer set against _scatter_pairs32, the
    consuming launch of the three planes against residual_plane_plain,
    bit for bit, and the set reading zero after it; on the clips, its
    device time per frame on the card's clock (device_ms; also without
    the clear), the plain version's time, and the bound: residual_work
    (int32 coefficients, the int32 residual) and the bytes the clear
    writes, the butterflies' operations at HBD_OP_WORDS int32 operations
    each. Returns the kernel's row."""
    from ffmpeg_hybrid_tpu_torch.ops import recon as R
    frames = []
    for clip in HBD_CLIPS:
        (bufs, cp, ep), = scatter_calls[clip]
        (jobs, lossless, bpp), = [rc[:3] for rc in residual_calls[clip]]
        frames.append((clip, cp, ep, bufs.flat_c.numel(),
                       bufs.flat_e.numel(), jobs, lossless, bpp))
    rng = np.random.RandomState(SEED + 17)
    cp, ep, nc, ne, grids = hbd_pairs_frame(np, rng, (seeded_shape,) * 3)
    frames.append(("seeded 12-bit 4:4:4 (int32 extremes)",
                   torch.as_tensor(cp, device=DEVICE),
                   torch.as_tensor(ep, device=DEVICE), nc, ne,
                   [(None, *(torch.as_tensor(g, device=DEVICE) for g in gr))
                    for gr in grids], False, 12))
    tot = dict.fromkeys(("ms", "ms_noclear", "plain_ms", "bytes", "ops"), 0.0)
    notes, seeded_ms = [], {}
    card = card_line()
    for clip, cp, ep, nc, ne, jobs, lossless, bpp in frames:
        if bpp == 8 or cp.shape[1] != 4:
            raise RuntimeError(f"{clip}: {bpp} bpp, pair rows of "
                               f"{cp.shape[1]} columns")
        bufs, views, plain_jobs, _outs, t = kept_pair(
            torch, clip, cp, ep, nc, ne, jobs, lossless, bpp)
        roots = ", ".join(f"{sz}x{sz} {n} ({dc} DC-only)" for sz, (n, dc)
                          in sorted(hbd_roots(np, plain_jobs,
                                              lossless).items()))
        if clip not in HBD_CLIPS:
            def residual():
                R.residual_planes(plain_jobs, lossless, bpp)
            k_ms = seeded_ms[clip] = device_ms(torch, residual, PROFILE_REPS,
                                               ("residual_kernel",), 1)[0]
            notes.append(f"{clip}: {cp.shape[0]} pair rows, roots {roots}; "
                         f"exact; {k_ms:.5f} ms on the card (no clear)")
            continue

        def pair():
            R.scatter_frame(bufs, cp, ep)
            R.residual_planes(views, lossless, bpp, consume=[bufs] * 3)

        def residual():
            R.residual_planes(plain_jobs, lossless, bpp)
        k_ms, k_ops = device_ms(torch, pair, PROFILE_REPS,
                                ("residual_kernel",), 1)
        k0_ms, _o = device_ms(torch, residual, PROFILE_REPS,
                              ("residual_kernel",), 1)
        if not bufs.read_zero():
            raise RuntimeError(f"{clip}: the kept buffers do not read zero "
                               "after the timed pairs")
        nbytes = nops = 0
        for job in plain_jobs:
            b, o = residual_work(np, *job, lossless)
            nbytes += b + clear_bytes(np, *job, lossless)
            nops += o * HBD_OP_WORDS
        for key, v in (("ms", k_ms), ("ms_noclear", k0_ms), ("plain_ms", t),
                       ("bytes", nbytes), ("ops", nops)):
            tot[key] += v
        notes.append(f"{clip} frame 0 ({bpp} bpp, planes "
                     f"{[tuple(v[0].shape) for v in views]}, "
                     f"{sum(int(j[1].gt(0).sum()) for j in plain_jobs)} coded "
                     f"cells): {k_ms:.5f} ms on the card in {k_ops:.2f} device"
                     f" ops (without the clear {k0_ms:.5f}), plain {t:.1f} ms,"
                     f" bound {bounds(nbytes, nops, 0)[0]:.6f}; roots {roots}")
    n = len(HBD_CLIPS)
    d = {k: v / n for k, v in tot.items()}
    bound_ms, bound_by, _chain = bounds(d["bytes"], d["ops"], 0)
    say("kernels", f"residual_planes_hbd: {'; '.join(notes)}; ms/frame="
        f"{d['ms']:.5f} (without the clear {d['ms_noclear']:.5f}) "
        f"plain_ms/frame={d['plain_ms']:.2f} bound_ms/frame={bound_ms:.6f} "
        f"({bound_by}, {d['bytes']:.0f} B, {d['ops']:.0f} ops); exact vs "
        f"plain, the kept buffers read zero after each; {card}; ptxas: "
        + ptxas_of(ITXFM_SRC, "residual_kernel_hbd"))
    return {"name": "residual_planes_hbd", "route": "cuda",
            "source": ITXFM_SRC, "replaces": ITXFM_REPLACES,
            "launches": None, "max_abs_err": 0, "ms": d["ms"],
            "plain_ms": d["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "per": "frame (one consuming launch of the three planes), mean "
                   "of frame 0 of " + " and ".join(HBD_CLIPS),
            "ms_without_clear": d["ms_noclear"], "bytes_needed": d["bytes"],
            "ops": d["ops"], "detail": notes, "seeded_ms": seeded_ms,
            "ptxas": ptxas_of(ITXFM_SRC, "residual_kernel_hbd")}


def formats_phase(torch, np, calls):
    """Every main-path kernel of the other formats against its plain
    version on the card, bit for bit, on frame 0 of each format clip
    ({clip: {wrapper: [args]}} as recon_frame hands them over): the
    splat (on the decoder's own index state), the loop-filter grids, the
    loop filter (Y and U+V in one launch, on copies of the planes), the
    intra wavefront of the three planes, and at 8 bpp the scatter and the
    consuming residual of the three planes (kept_pair; the high-bit-depth
    clips' are residual_hbd_phase's), with the plain versions' times."""
    from ffmpeg_hybrid_tpu_torch.ops import lpf_dense as LD
    from ffmpeg_hybrid_tpu_torch.ops import lpf_masks as LM
    from ffmpeg_hybrid_tpu_torch.ops import recon as R
    for clip, got in calls.items():
        bpp, ss_h, ss_v = FORMAT_CLIPS[clip]
        times = {}
        states = {}
        (recs, r4, c4, sh, sv), = got["_grids_from_records"]
        if (sh, sv) != (ss_h, ss_v):
            raise RuntimeError(f"{clip}: splat under {(sh, sv)}")
        outs = R._grids_from_records(recs, r4, c4, sh, sv, states=states)
        wants, times["_grids_from_records"] = host_ms(
            torch, lambda: R._grids_from_records_plain(recs, r4, c4, sh, sv))
        checks = [("_grids_from_records", outs, wants)]
        (g_args,) = got["grids_device"]
        outs = LM.grids_device(*g_args)
        wants, times["grids_device"] = host_ms(
            torch, lambda: LM.grids_device_plain(*g_args))
        checks.append(("grids_device", outs, wants))
        (lf_args,) = got["lf_frame_"]
        if lf_args[9:11] != [ss_h, ss_v] or lf_args[11] != bpp:
            raise RuntimeError(f"{clip}: the loop filter ran under "
                               f"{lf_args[9:12]}")
        wants = [p.clone() for p in lf_args[:3]]
        _none, times["lf_frame_"] = host_ms(torch, lambda: LD.lf_frame_plain_(
            *wants, *lf_args[3:]))
        work, run, _restore = lf_run(torch, LD, lf_args)
        run()
        checks.append(("lf_frame_", work, wants))
        (i_args,) = got["_intra_scan_planes"]
        jobs, ibpp = i_args
        outs = R._intra_scan_planes(jobs, ibpp)
        wants, times["_intra_scan_planes"] = host_ms(torch, lambda: [
            R._intra_scan_plain(*job, ibpp) for job in jobs])
        checks.append(("_intra_scan_planes", outs, wants))
        if bpp == 8:
            (bufs, cp, ep), = got["scatter_frame"]
            (jobs, lossless, rbpp), = [a[:3] for a in got["residual_planes"]]
            *_rest, times["residual_planes"] = kept_pair(
                torch, f"{clip} frame 0", cp, ep, bufs.flat_c.numel(),
                bufs.flat_e.numel(), jobs, lossless, rbpp)
        for name, outs, wants in checks:
            e = max_diff(outs, wants)
            if e:
                raise RuntimeError(f"{name} on {clip} frame 0: kernel != "
                                   f"plain (max |diff| {e})")
        plain = {k: round(v, 1) for k, v in times.items()}
        held = [n for n, _o, _w in checks] + (
            ["scatter_frame", "residual_planes"] if bpp == 8 else [])
        say("kernels", f"{clip} frame 0 ({bpp} bpp {layout(ss_h, ss_v)}): "
            + ", ".join(held) + " exact vs plain "
            f"(plain ms: {json.dumps(plain)})")


def two_decoders_phase(torch, clips):
    """Two decoders of one geometry on two host threads, each through
    decode_stream at once, every frame's MD5 against its framemd5: in
    turn bench_1080p beside bench_1080p_lf (both 1920x1080), and
    bench_1080p beside itself. Each decoder keeps its own splat index
    state and coefficient buffers, so the launches of the two may
    interleave on the stream in any order."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    t0 = time.perf_counter()
    for pair in (("bench_1080p", "bench_1080p_lf"),
                 ("bench_1080p", "bench_1080p")):
        results, errs = [None, None], []

        def run(i, name):
            try:
                frames, _want = clips[name]
                dec = VP9Decoder(device=DEVICE)
                results[i] = (dec, [hashlib.md5(f.to_bytes()).hexdigest()
                                    for f in dec.decode_stream(iter(frames))])
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errs.append(e)

        threads = [threading.Thread(target=run, args=(i, n))
                   for i, n in enumerate(pair)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errs:
            raise errs[0]
        for (dec, got), name in zip(results, pair):
            if got != clips[name][1]:
                bad = next(i for i, (a, b) in enumerate(zip(got,
                                                            clips[name][1]))
                           if a != b)
                raise RuntimeError(f"two decoders on two threads: {name} "
                                   f"frame {bad} is not bit-exact")
        a, b = (set(map(id, r[0].splat_states.values())) for r in results)
        if not a or a & b:
            raise RuntimeError("the two decoders share a splat state")
    say("decode", "two decoders of one geometry on two host threads at "
        "once (bench_1080p beside bench_1080p_lf, then beside itself): "
        "every frame bit-exact vs framemd5, each decoder on its own splat "
        f"state, {time.perf_counter() - t0:.1f} s")


def data_rows(text):
    return [ln for ln in text.splitlines() if ln and not ln.startswith("#")]


def run_cli(torch, argv):
    """stdout of the port's CLI, main(argv), in this process; the card
    synchronised at its end. Fails unless it exits 0."""
    from ffmpeg_hybrid_tpu_torch.__main__ import main as cli_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"the CLI exited {rc} on {argv}")
    return buf.getvalue()


def cli_run_checked(torch, argv, name, launches):
    """run_cli on the main path with every plain version set to raise;
    fails unless the kernels launched as often as in the decode phase's
    conformance pass of the clip `name` (launches[name])."""
    with main_path_run():
        out = run_cli(torch, argv)
    got = main_path_launches()
    if got != launches[name]:
        raise RuntimeError(f"CLI {argv}: kernel launches {got}, the decode "
                           f"phase's for {name} {launches[name]}")
    return out


def check_slices(what, data, rows, name):
    """Each frame's bytes, in order, hash to its framemd5 row."""
    at = 0
    for i, row in enumerate(rows):
        size, md5 = (p.strip() for p in row.split(",")[4:6])
        part = data[at:at + int(size)]
        if hashlib.md5(part).hexdigest() != md5:
            raise RuntimeError(f"{what} of {name}: frame {i} differs from "
                               "its framemd5 row")
        at += int(size)
    if at != len(data):
        raise RuntimeError(f"{what} of {name}: {len(data) - at} bytes more "
                           "than the framemd5's frames")


def resume_check(name, cut):
    """Decode `cut` frames of the clip on the card, take state_dict, load
    it into a fresh decoder on the card and decode the rest: every MD5
    must equal the framemd5's."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9 import checkpoint
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    frames, want = read_clip(name)
    with main_path_run():
        dec = VP9Decoder(device=DEVICE)
        got = [hashlib.md5(f.to_bytes()).hexdigest()
               for fd in frames[:cut] for f in dec.decode(fd)]
        state = checkpoint.state_dict(dec)
        del dec
        dec = checkpoint.load_state_dict(VP9Decoder(device=DEVICE), state)
        if not all(f.dev[0].device.type == DEVICE and not f._host_stale
                   for f in dec.refs if f is not None):
            raise RuntimeError(f"{name}: a restored reference is not on "
                               "the card")
        got += [hashlib.md5(f.to_bytes()).hexdigest()
                for fd in frames[cut:] for f in dec.decode(fd)]
    if got != want:
        raise RuntimeError(f"{name} resumed after frame {cut - 1}: the "
                           "MD5s differ from the framemd5's")
    return len(state["frames"])


def cli_phase(torch, launches, decode_fps):
    """The port's command line on the card (phase 8 of the docstring).
    launches: each clip's kernel launches in the decode phase;
    decode_fps: bench_1080p's median fps there."""
    from ffmpeg_hybrid_tpu_torch.formats.ivf import read_ivf
    from ffmpeg_hybrid_tpu_torch.formats.webm import write_webm
    vec = os.path.join(ROOT, "vectors")
    rows = {}
    for name in launches:
        with open(os.path.join(vec, name + ".framemd5")) as f:
            rows[name] = data_rows(f.read())
    t0 = time.perf_counter()
    shell = subprocess.run(
        [sys.executable, "-m", PKG,
         os.path.join("vectors", "bench_1080p.ivf")],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if shell.returncode != 0 or data_rows(shell.stdout) != \
            rows["bench_1080p"]:
        raise RuntimeError("python -m ffmpeg_hybrid_tpu_torch "
                           f"vectors/bench_1080p.ivf exited "
                           f"{shell.returncode}, rows unequal to the "
                           f"framemd5's: {shell.stderr[-2000:]}")
    say("cli", "shell run: python -m ffmpeg_hybrid_tpu_torch "
        "vectors/bench_1080p.ivf prints the framemd5's rows in "
        f"{time.perf_counter() - t0:.1f} s (a process, kernels built)")

    t0 = time.perf_counter()
    for name in launches:
        out = cli_run_checked(torch, [os.path.join(vec, name + ".ivf")],
                              name, launches)
        if data_rows(out) != rows[name]:
            raise RuntimeError(f"CLI on {name}: rows unequal to the "
                               "framemd5's")
    say("cli", f"main(argv) on all {len(launches)} clips: every row equal "
        "to the framemd5's, every kernel's launches equal to the decode "
        f"phase's, {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("bench_1080p", RESIZE_CLIP):
            info, pkts = read_ivf(os.path.join(vec, name + ".ivf"))
            pkts = list(pkts)
            tcs = [i * 1000 // 30 for i in range(len(pkts))]
            for layout in ({}, {"lacing": "xiph", "lace_group": 3}):
                path = os.path.join(tmp, name + ".webm")
                write_webm(path, info.width, info.height,
                           [(tc, d) for tc, (_p, d) in zip(tcs, pkts)],
                           **layout)
                got = [[p.strip() for p in r.split(",")] for r in
                       data_rows(cli_run_checked(torch, [path], name,
                                                 launches))]
                want = [[p.strip() for p in r.split(",")] for r in
                        rows[name]]
                # a lace's later frames carry no timecode of their own
                lace = layout.get("lace_group", 1)
                pts = [0 if i % lace else tc for i, tc in enumerate(tcs)]
                if [g[4:6] for g in got] != [w[4:6] for w in want] or \
                        [int(g[2]) for g in got] != pts:
                    raise RuntimeError(f"CLI on {name} as WebM {layout}: "
                                       "rows or pts unequal")
        say("cli", "bench_1080p and resize_1080p remuxed to WebM as "
            "SimpleBlocks and xiph-laced (three frames a lace): every "
            "(size, md5) the IVF's, every pts the timecode written (a "
            "lace's later frames carry none: 0)")

        raw = os.path.join(tmp, "bench_4k.yuv")
        cli_run_checked(torch, [os.path.join(vec, "bench_4k.ivf"), "-f",
                                "rawvideo", "-o", raw], "bench_4k",
                        launches)
        with open(raw, "rb") as f:
            check_slices("-f rawvideo", f.read(), rows["bench_4k"],
                         "bench_4k")
        os.unlink(raw)
        y4m = os.path.join(tmp, "bench_1080p.y4m")
        cli_run_checked(torch, [os.path.join(vec, "bench_1080p.ivf"), "-f",
                                "y4m", "-o", y4m], "bench_1080p", launches)
        with open(y4m, "rb") as f:
            data = f.read()
        head, _, body = data.partition(b"\n")
        info, _pkts = read_ivf(os.path.join(vec, "bench_1080p.ivf"))
        if head != (f"YUV4MPEG2 W{info.width} H{info.height} F30:1 Ip "
                    "A0:0 C420jpeg").encode():
            raise RuntimeError(f"-f y4m header {head[:80]!r}")
        frames = body.split(b"FRAME\n")
        if frames[0] != b"" or len(frames) != len(rows["bench_1080p"]) + 1:
            raise RuntimeError("-f y4m: not a FRAME record a frame")
        for i, (part, row) in enumerate(zip(frames[1:],
                                            rows["bench_1080p"])):
            check_slices("-f y4m", part, [row], f"bench_1080p frame {i}")
    out = cli_run_checked(torch, [os.path.join(vec, "bench_1080p.ivf"),
                                  "--bsf",
                                  "vp9_superframe_split,vp9_raw_reorder"],
                          "bench_1080p", launches)
    if data_rows(out) != rows["bench_1080p"]:
        raise RuntimeError("--bsf vp9_superframe_split,vp9_raw_reorder on "
                           "bench_1080p: rows unequal to the framemd5's")
    say("cli", "-f rawvideo of bench_4k and -f y4m of bench_1080p: every "
        "frame's bytes hash to its framemd5 row; --bsf "
        "vp9_superframe_split,vp9_raw_reorder on bench_1080p: the "
        f"framemd5's rows; {time.perf_counter() - t0:.1f} s with the WebM "
        "runs")

    for name, cut in RESUME_AT.items():
        n = resume_check(name, cut)
        say("cli", f"checkpoint: {name} resumed after frame {cut - 1} in a "
            f"fresh decoder on the card ({n} frames in the state): every "
            "MD5 equal to the framemd5's")

    peaks = {}
    ivf = os.path.join(vec, "bench_1080p.ivf")
    n_frames = len(rows["bench_1080p"])
    for argv in ([ivf, "--frames", str(CLI_MEM_FRAMES)], [ivf]):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run_cli(torch, argv)
        peaks[len(argv)] = torch.cuda.max_memory_allocated()
    short, full = peaks[3], peaks[1]
    say("cli", f"peak device memory allocated: {full} B over all "
        f"{n_frames} bench_1080p frames, {short} B over --frames "
        f"{CLI_MEM_FRAMES} "
        f"({(full - short) / 2**20:.3f} MiB more; the limit "
        f"{CLI_MEM_SLACK >> 20} MiB)")
    if full - short > CLI_MEM_SLACK:
        raise RuntimeError("the CLI's device memory grows with the clip")

    fps = {}
    for fmt in ("null", "framemd5"):
        runs = []
        for _ in range(CLI_RUNS):
            gc.collect()
            t0 = time.perf_counter()
            run_cli(torch, [ivf, "-f", fmt])
            runs.append(n_frames / (time.perf_counter() - t0))
        fps[fmt] = (sorted(runs)[CLI_RUNS // 2], runs)
    say("cli", "bench_1080p through main(argv), wall fps (median of "
        f"{CLI_RUNS} runs, each ending in a synchronise): "
        + ", ".join(f"-f {k} {m:.3f} (runs "
                    + ", ".join(f"{r:.3f}" for r in v) + ")"
                    for k, (m, v) in fps.items())
        + f"; the decode phase's median {decode_fps:.3f} fps; on "
        + card_line())


def busy_share(torch, frames):
    """(the card's busy share, device ops a frame) of a serial decode of
    `frames` under torch.profiler after a warm-up decode: the device time
    of its kernels over the wall time, as tools/profile_stages_torch.py
    reads it, scaled by the port's kernels' launches over their records
    kept (profiled, launch_records)."""
    from torch.autograd import DeviceType
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder

    def run():
        dec = VP9Decoder(device=DEVICE)
        for fd in frames:
            dec.decode(fd)
        torch.cuda.synchronize()

    def timed():
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0

    run()
    prof, wall, kept = profiled(timed, launch_records)
    scale = kept_scale(kept)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and PAD_KERNEL not in e.key]
    us = sum(_device_us(e) for e in kernels)
    if not us:
        raise RuntimeError("the profiler saw no device time in the decode")
    return (us * scale / 1e6 / wall,
            sum(e.count for e in kernels) * scale / len(frames))


def read_clip(name):
    from ffmpeg_hybrid_tpu_torch.formats.ivf import read_ivf
    from ffmpeg_hybrid_tpu_torch.formats.superframe import split_superframe
    frames = []
    for pts, data in read_ivf(os.path.join(ROOT, "vectors",
                                           name + ".ivf"))[1]:
        for _fpts, fd in split_superframe(data, pts):
            frames.append(fd)
    want = [line.split(",")[-1].strip()
            for line in open(os.path.join(ROOT, "vectors",
                                          name + ".framemd5"))
            if line.strip() and not line.startswith("#")]
    return frames, want


# the port's kernels whose device records a profiled decode must hold,
# by the launch counts (main_path_launches) that count their wrappers'
# calls: {name substring: (counter keys, kernels a call)}. The scatter
# is left out: a call with no rows launches nothing
COUNTED_KERNELS = {"intra_kernel": (("intra",), 1),
                   "lpf_kernel": (("lf_dense",), 1),
                   "lf_grids_kernel": (("lf_grids",), 1),
                   "splat_": (("splat",), 2),
                   "mc_kernel": (("mc",), 1),
                   "mc_scaled_kernel": (("mc_scaled",), 1),
                   "residual_kernel": (("residual", "residual_hbd"), 1)}


def launch_records():
    """A profiled() expect: the device records of COUNTED_KERNELS that
    the launches counted from this call on make."""
    before = main_path_launches()

    def after():
        now = main_path_launches()
        return {name: per * sum(now[k] - before[k] for k in keys)
                for name, (keys, per) in COUNTED_KERNELS.items()}
    return after


def main_path_launches():
    """Every kernel wrapper's launch count since main_path_run began."""
    from ffmpeg_hybrid_tpu_torch.ops import (lpf_dense, lpf_masks,
                                             lpf_replay, passa_device, rac,
                                             recon)
    return dict(rac.LAUNCHES, **lpf_dense.LAUNCHES, **lpf_masks.LAUNCHES,
                **recon.LAUNCHES, **lpf_replay.LAUNCHES,
                **passa_device.LAUNCHES)


@contextlib.contextmanager
def main_path_run():
    """A run of the main path: every launch count set to zero at its
    start, and every kernel's plain version set to raise within it."""
    from ffmpeg_hybrid_tpu_torch.ops import (lpf_dense, lpf_masks,
                                             lpf_replay, passa_device, rac,
                                             recon)
    from ffmpeg_hybrid_tpu_torch.utils import digest
    for mod in (rac, lpf_dense, lpf_masks, recon, lpf_replay, passa_device,
                digest):
        mod.reset_launches()
    plains = [(mod, fn) for mod, fns in (
        (recon, ("_grids_from_records_plain", "residual_plane_plain",
                 "_intra_scan_plain", "mc_planes_plain",
                 "mc_planes_scaled_plain", "_scatter_pairs16",
                 "_scatter_pairs32", "_consume_plain")),
        (lpf_masks, ("grids_device_plain",)),
        (lpf_dense, ("lf_frame_plain_", "lf_dense_plain")),
        (lpf_replay, ("lf_scan_plain", "lf_scan_sharded_plain",
                      "apply_step_plain")),
        (passa_device, ("decode_frame_plain",)),
        (digest, ("plane_digest_plain", "frame_digest_plain")))
        for fn in fns]
    saved = [getattr(mod, fn) for mod, fn in plains]

    def plain_called(*_a, **_k):
        raise RuntimeError("a plain version ran on the card's main path")

    try:
        for mod, fn in plains:
            setattr(mod, fn, plain_called)
        yield
    finally:
        for (mod, fn), real in zip(plains, saved):
            setattr(mod, fn, real)


def digest_entry(torch, np, digests):
    """The kernels-line entry of the plane digest (csrc/digest.cu): the
    launches and the largest |kernel - plain| of the decode phase's
    digest steps (digest_check: a frame's three planes in one launch of
    frame_digest); its time on the card's clock on the three visible
    planes of the last frame of DIGEST_TIMED (device_ms), in one launch
    (the main path's) and in three of plane_digest, each device op
    counted (a memset would be one more), and under CUDA events (launch
    gaps included); the plain version's on the card and the bound: the
    cropped planes read once (4 B a pixel) and the words written, or
    DIGEST_PIXEL_OPS a pixel at the int32 rate. No single PyTorch call
    computes the mod-2^32 weighted sums: library_ms is null."""
    from ffmpeg_hybrid_tpu_torch.utils import digest as DG
    planes = digests[DIGEST_TIMED][3]
    crops = [tuple(c.shape) for c in planes]

    def frame():
        DG.frame_digest_dev_async(planes, crops)

    def per_plane():
        for c in planes:
            DG.plane_digest_dev_async(c, *c.shape)

    def plain():
        DG.frame_digest_plain(planes, crops)
    ms, dev_ops = device_ms(torch, frame, 50, ("digest_kernel", "Memset"),
                            kernel="digest_kernel")
    ms3, ops3 = device_ms(torch, per_plane, 50, ("digest_kernel", "Memset"),
                          per_call=3, kernel="digest_kernel")
    if round(dev_ops) != 1 or round(ops3) != 3:
        raise RuntimeError(f"plane_digest: {dev_ops:g} device ops a frame "
                           f"launch, {ops3:g} for three plane launches "
                           "(one each and no memset expected)")
    ev_ms, ev3_ms = cuda_ms(frame, 50), cuda_ms(per_plane, 50)
    got = DG.frame_digest_dev_async(planes, crops)
    if not torch.equal(got, torch.stack([DG.plane_digest_dev_async(
            c, *c.shape) for c in planes])):
        raise RuntimeError("plane_digest: the frame and the plane entries "
                           "differ")
    plain_ms = cuda_ms(plain, 10)
    pixels = sum(c.numel() for c in planes)
    nbytes = 4 * pixels + 8 * len(planes)
    bound_ms, bound_by, _chain = bounds(nbytes, DIGEST_PIXEL_OPS * pixels, 0)
    launches = sum(v[1] for v in digests.values())
    err = max(v[2] for v in digests.values())
    say("kernels", f"plane_digest on the three visible planes of "
        f"{DIGEST_TIMED}'s last frame ({crops}, int32): one launch "
        f"(frame_digest) ms={ms:.5f} on the card's clock in {dev_ops:g} "
        f"device op, {ev_ms:.5f} under CUDA events; a launch a plane "
        f"(plane_digest) {ms3:.5f} in {ops3:g} ops, {ev3_ms:.5f} under CUDA "
        f"events; no memset; plain_ms={plain_ms:.4f} (torch int64 on the "
        f"card), bound_ms={bound_ms:.6f} ({bound_by}, {nbytes} B; "
        f"{bound_ms / ms:.2f} of it reached); on every frame of the "
        f"{len(digests)} decode-phase clips "
        f"({sum(v[0] for v in digests.values())} planes, {launches} "
        f"launches, a frame each): kernel = plain = plane_digest_host; on "
        f"{card_line()}")
    say("kernels", "plane_digest ptxas: "
        + "; ".join(f"{n}: {p}" for n, p in ptxas_entries(DIGEST_SRC,
                                                            "digest")))
    return {"name": "plane_digest", "route": "cuda", "source": DIGEST_SRC,
            "replaces": DIGEST_REPLACES, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "per": f"the three planes of {DIGEST_TIMED}'s last frame, one "
                   "launch",
            "ms_a_launch_a_plane": ms3, "events_ms": ev_ms,
            "events_ms_a_launch_a_plane": ev3_ms,
            "bytes_needed": nbytes, "ops": DIGEST_PIXEL_OPS * pixels,
            "device_ops_per_call": dev_ops}


def visible_planes(np, raw, f):
    """The host planes of a frame's rawvideo bytes, and each plane's
    (height, width)."""
    w, h = f.size
    cw, ch = (w + f.ss_h) >> f.ss_h, (h + f.ss_v) >> f.ss_v
    a = np.frombuffer(raw, np.uint8 if f.bpp == 8 else np.dtype("<u2"))
    crops = ((h, w), (ch, cw), (ch, cw))
    planes, at = [], 0
    for ph, pw in crops:
        planes.append(a[at:at + ph * pw].reshape(ph, pw))
        at += ph * pw
    return planes, crops


def digest_check(np, name, taken):
    """The digest step of a clip's conformance pass: the kernel's words
    (plane_digest_dev_async, flushed in one copy) against the plain
    version on the card on the same cropped planes and against
    plane_digest_host on the frames' rawvideo bytes, every word exact.
    taken: [(async pair, cropped plane, host digest)]. Returns the
    largest |kernel - plain| (0)."""
    from ffmpeg_hybrid_tpu_torch.utils import digest as DG
    got = DG.digests_to_host([p for p, _c, _h in taken]).astype(np.int64)
    plain = DG.digests_to_host([DG.plane_digest_plain(c, *c.shape)
                                for _p, c, _h in taken]).astype(np.int64)
    host = np.array([h for _p, _c, h in taken], np.int64)
    err = int(np.abs(got - plain).max())
    if err or not np.array_equal(got, host):
        bad = int(np.nonzero((got != plain).any(1) | (got != host).any(1))
                  [0][0])
        raise RuntimeError(f"{name}: plane digest {bad}: kernel "
                           f"{got[bad]}, plain {plain[bad]}, host "
                           f"{host[bad]}")
    return err


def decode_phase(torch, np, name, frames, want, windows, digests):
    """Conformance, then timing (`windows` timed passes), of one clip on
    the main path. In the conformance pass each frame's three visible
    planes also go through the digest kernel (digest_check, after the
    pass); digests[name] gets (planes digested, launches, max |diff|,
    the last frame's cropped planes). Returns
    (median fps, all fps, per-stage ms/frame, launches of the
    conformance pass by kernel, frames with intra blocks, frames with
    inter blocks, host ms/frame of pass A and pass B beside each timed
    pass, the serial pass's kept coefficient buffer sets and splat
    states)."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu_torch.ops import recon
    from ffmpeg_hybrid_tpu_torch.utils.metrics import metrics
    # conformance pass: the main path's run, launches counted from zero,
    # with every kernel's plain version set to raise
    from ffmpeg_hybrid_tpu_torch.utils import digest as DG
    t0 = time.perf_counter()
    taken = []
    with main_path_run():
        dec = VP9Decoder(device=DEVICE)
        n = 0
        for f in dec.decode_stream(iter(frames)):
            if f.dev is None or f.dev[0].device.type != DEVICE:
                raise RuntimeError(f"frame {n} was not reconstructed on "
                                   "the card")
            raw = f.to_bytes()
            got = hashlib.md5(raw).hexdigest()
            if got != want[n]:
                raise RuntimeError(f"{name} frame {n}: md5 {got} != "
                                   f"{want[n]}")
            hosts, crops = visible_planes(np, raw, f)
            pairs = DG.frame_digest_dev_async(list(f.dev), crops)
            for k, (plane, host, (ph, pw)) in enumerate(zip(f.dev, hosts,
                                                            crops)):
                taken.append((pairs[k], plane[:ph, :pw].clone(),
                              DG.plane_digest_host(host, ph, pw)))
            n += 1
        digest_launches = DG.LAUNCHES["digest"]
    if digest_launches != n:
        raise RuntimeError(f"{name}: the digest kernel launched "
                           f"{digest_launches} times for {n} frames")
    err = digest_check(np, name, taken)
    digests[name] = (len(taken), digest_launches, err,
                     [c for _p, c, _h in taken[-3:]])
    del taken
    if n != len(want):
        raise RuntimeError(f"{name}: decoded {n} frames, expected "
                           f"{len(want)}")
    launches = main_path_launches()
    say("decode", f"{name}: {n} frames bit-exact vs framemd5 in "
        f"{time.perf_counter() - t0:.1f} s (first pass, incl. warm-up); "
        f"kernel launches on this path: {launches}; plane digests of the "
        f"{3 * n} visible planes: the kernel ({digest_launches} launches, "
        "a frame's three planes in one) equal to its plain version and to "
        "plane_digest_host")
    # timed pipelined passes (frames stay on the device): the host clock
    # spreads on a host-bound path, so report the median of WINDOWS; the
    # unsynchronised stage timers give each pass's host pass A and pass B
    # (its enqueue, and the waits the card imposes on it). The garbage of
    # the phases before is collected first, so that no pass of the
    # interpreter's cyclic collector (up to 0.2 s here) lands in a timed
    # stage.
    gc.collect()
    fps_runs, host = [], []
    metrics.enable()
    try:
        for _ in range(windows):
            metrics.reset()
            dec = VP9Decoder(device=DEVICE)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = list(dec.decode_stream(iter(frames)))
            torch.cuda.synchronize()
            fps_runs.append(len(outs) / (time.perf_counter() - t0))
            report = metrics.report()
            host.append(tuple(report[k]["total_s"] * 1e3 / len(outs)
                              for k in ("decode.pass_a", "decode.pass_b")))
    finally:
        metrics.disable()
    fps = sorted(fps_runs)[len(fps_runs) // 2]
    say("decode", f"{name}: timed pipelined passes of {len(frames)} "
        "frames: median "
        f"{fps:.3f} fps over {windows} (min {min(fps_runs):.3f}, max "
        f"{max(fps_runs):.3f}); by pass: "
        + ", ".join(f"{v:.3f} fps (host pass A {a:.3f}, pass B {b:.3f} "
                    "ms/frame)" for v, (a, b) in zip(fps_runs, host)))
    # serial pass with every stage timer synchronised to the card
    gc.collect()
    metrics.enable()
    metrics.reset()
    metrics.sync = torch.cuda.synchronize
    try:
        dec = VP9Decoder(device=DEVICE)
        for k, fd in enumerate(frames):
            dec.decode(fd)
            # the coefficient buffers kept from frame to frame read zero
            # after every frame (the residual consumed them)
            kept = list(dec.coef_bufs.values())
            if not kept or not all(b.read_zero() and b.consumed
                                   for b in kept):
                raise RuntimeError(f"{name} frame {k}: a kept coefficient "
                                   "buffer does not read zero")
        torch.cuda.synchronize()
    finally:
        metrics.sync = None
        metrics.disable()
    if any(recon.COEF_FILLS.values()):
        raise RuntimeError(f"{name}: kept coefficient buffers were "
                           f"zero-filled: {recon.COEF_FILLS}")
    report = metrics.report()
    stages = {k: round(v["total_s"] * 1e3 / len(frames), 3)
              for k, v in report.items() if "total_s" in v}
    levels = report.get("intra.levels", {"value": 0})["value"]
    intra_frames = report.get("intra.ncalls", {"value": 0})["value"]
    inter_frames = report.get("recon.mc", {"count": 0})["count"]
    say("decode", f"{name}: serial pass, ms/frame per stage "
        "(synchronised; the kept coefficient buffers read zero after every "
        f"frame, zero-fills {recon.COEF_FILLS}): "
        + json.dumps(stages, sort_keys=True)
        + f"; intra levels per frame (Y + U + V): {levels / len(frames)}; "
        f"{intra_frames} of {len(frames)} frames have intra blocks, "
        f"{inter_frames} inter blocks; kept coefficient buffer sets "
        f"{len(dec.coef_bufs)}, splat states {len(dec.splat_states)}")
    return (fps, fps_runs, stages, launches, intra_frames, inter_frames, host,
            (len(dec.coef_bufs), len(dec.splat_states)))


# ---------------------------------------------------------------------------
# the on-device pass A


def walk_host(out):
    """decode_frame's outputs on the host, as numpy arrays."""
    return [t.cpu().numpy() for t in out]


def walk_diff(np, got, want, S):
    """Where two walks' outputs differ (None if nowhere): every lane's
    rows of records and pairs, the counts, the err words, the bools a
    lane and, on an inter frame, the MV and reference grids."""
    for i, c in ((0, 1), (2, 3), (4, 5)):
        if not np.array_equal(got[c], want[c]):
            return f"row counts of output {i}: {got[c]} != {want[c]}"
        for s in range(S):
            m = int(want[c][s])
            if not np.array_equal(got[i][s, :m], want[i][s, :m]):
                return f"lane {s}: rows of output {i}"
    for i, what in ((6, "counts"), (7, "err")):
        if not np.array_equal(got[i], want[i]):
            return what
    if not np.array_equal(got[8][:, 0], want[8][:, 0]):
        return f"bools a lane {got[8][:, 0]} != {want[8][:, 0]}"
    if len(got) != len(want):
        return "the grids of one walk alone"
    for i, what in ((9, "MV grid"), (10, "reference grid")):
        if i < len(got) and not np.array_equal(got[i], want[i]):
            return what
    return None


def canon_records(np, recs):
    """Records with the fields a block does not write zeroed (the JAX
    package's test _canon): an intra block's references, filter and MVs,
    an inter block's uv mode, a single-reference block's second
    reference."""
    r = np.array(recs[:, :34], np.int64)
    intra = r[:, 6] != 0
    r[intra, 15:] = 0
    r[~intra, 13] = 0
    r[~intra & (r[:, 14] == 0), 16] = 0
    return r


def walk_vs_native(np, dec, got, S):
    """Where the walk's outputs differ from the native pass A that dec
    has just run on the frame (None if nowhere): the dense coefficient
    planes and eob grids the pairs make, the records in (row, col) order
    with their unwritten fields zeroed (canon_records), and on an inter
    frame the MV and reference grids against the decoder's cur_mv and
    cur_ref."""
    cp, ep = dec.coef_pairs
    pos = (cp[:, 0].astype(np.int64) << 16) | (cp[:, 1].astype(np.int64)
                                              & 0xffff)
    val = cp[:, 2].astype(np.int64) if cp.shape[1] == 3 else (
        (cp[:, 2].astype(np.int64) << 16) | (cp[:, 3].astype(np.int64)
                                             & 0xffff))
    epos = (ep[:, 0].astype(np.int64) << 16) | (ep[:, 1].astype(np.int64)
                                               & 0xffff)
    for what, n, p, v, k in (
            ("coefficients", dec.coef_y.size + 2 * dec.coef_u.size, pos,
             val, 2),
            ("eob cells", dec.eob_y.size + 2 * dec.eob_u.size, epos,
             ep[:, 2].astype(np.int64), 4)):
        native = np.zeros(n, np.int64)
        native[p] = v
        walk = np.zeros(n, np.int64)
        for s in range(S):
            m = int(got[k + 1][s])
            walk[got[k][s, :m, 0]] = got[k][s, :m, 1]
        if not np.array_equal(native, walk):
            return f"{what}: {int((native != walk).sum())} differ"
    recs_n = canon_records(np, dec.block_records)
    recs_w = canon_records(np, np.concatenate(
        [got[0][s, :int(got[1][s])] for s in range(S)]))

    def by_pos(r):
        return r[np.lexsort((r[:, 1], r[:, 0]))]
    if recs_n.shape != recs_w.shape or not np.array_equal(by_pos(recs_n),
                                                          by_pos(recs_w)):
        return f"records: {len(recs_w)} against the native {len(recs_n)}"
    if len(got) > 9 and not (np.array_equal(got[9], dec.cur_mv)
                             and np.array_equal(got[10], dec.cur_ref)):
        return "the MV and reference grids against cur_mv and cur_ref"
    return None


def native_pass_a_ms(frames, i=0, reps=3):
    """The native C pass A of frame i of a clip, ms: (decode.pass_a, its
    passa.c_decode), the median of reps fresh decoders, each taking
    frames 0..i-1's pass A untimed first."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu_torch.utils.metrics import metrics
    runs = []
    metrics.enable()
    try:
        for _ in range(reps):
            dec = VP9Decoder(device=DEVICE)
            for fd in frames[:i]:
                dec.decode_pass_a(fd)
            metrics.reset()
            dec.decode_pass_a(frames[i])
            rep = metrics.report()
            runs.append((rep["decode.pass_a"]["total_s"] * 1e3,
                         rep["passa.c_decode"]["total_s"] * 1e3))
    finally:
        metrics.disable()
    return sorted(runs)[reps // 2]


def prep_frame(PD, dec, fd):
    """The walk's inputs of the frame dec has just parsed."""
    h = dec.header
    prep = PD.prep_keyframe if h.keyframe or h.intraonly else PD.prep_inter
    return prep(dec, fd)


def kernel_vs_plain(np, PD, inputs, meta, what):
    """csrc/passa.cu against decode_frame_plain (the host CPU) on one
    frame's inputs, every output exact (walk_diff); raises where they
    differ. Returns (the kernel's outputs, the plain walk's ms)."""
    got = walk_host(PD.decode_frame(inputs, meta, DEVICE))
    t = time.perf_counter()
    want = walk_host(PD.decode_frame_plain(inputs, meta))
    plain_ms = (time.perf_counter() - t) * 1e3
    diff = walk_diff(np, got, want, meta["S"])
    if diff or got[7].any():
        raise RuntimeError(f"passa: {what}: the kernel against its plain "
                           f"version: {diff or got[7]}")
    return got, plain_ms


def walk_prev_bytes(np, hflags, recs, meta):
    """The bytes of the previous frame's grids that an inter frame's walk
    reads (csrc/passa.cu), from its records: the MV (8 B) and reference
    (2 B) cell at the block's own position, once for each inter block
    with a mode other than ZEROMV, when the frame uses the last frame's
    MVs (find_ref_mv's temporal slots; counted whether or not the
    candidate scan reached them); and the segment id cells of each block
    whose id is predicted, clipped to the frame, when the frame predicts
    ids from a previous map. A block whose id was predicted under
    temporal prediction (update_map and temporal) is not told by its
    record, so those reads are left out: the count stays a lower one."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9 import tables as T
    seg_en, seg_upd, _seg_tmp, have_pseg = (int(v) for v in hflags[:4])
    use_prev = int(hflags[13])
    inter = recs[:, 6] == 0
    n = 0
    if use_prev:
        n += 10 * int((inter & (recs[:, 9:13] != 12).any(axis=1)).sum())
    if seg_en and have_pseg and not seg_upd:
        bwh = np.asarray(T.BWH_TAB[1], np.int64)[recs[:, 3]]
        w = np.minimum(meta["cols"] - recs[:, 1], bwh[:, 0])
        h = np.minimum(meta["rows"] - recs[:, 0], bwh[:, 1])
        n += int((w * h).sum())
    return n


def walk_sections(np, PD, inputs, meta, got, what):
    """The kernel's debug sections on one frame (decode_frame_sections:
    the instance that times them), its outputs held to `got` (walk_diff):
    each lane's row as a dict of PD.SECTIONS."""
    out, sec = PD.decode_frame_sections(inputs, meta, DEVICE)
    diff = walk_diff(np, walk_host(out), got, meta["S"])
    if diff:
        raise RuntimeError(f"passa: {what}: the sections instance against "
                           f"the kernel: {diff}")
    return [dict(zip(PD.SECTIONS, (int(v) for v in row))) for row in sec]


def walk_row(np, PD, inputs, meta, got, frames, i, plain_ms):
    """The walk's measures on one frame (got: its outputs with stats):
    ms under CUDA events, the longest lane's clock64 time and cycles a
    bool, the MV quanta's cycles an inter block, the longest lane's debug
    sections, bytes and chain bounds, and the native pass A's ms on the
    same frame."""
    def walk():
        PD.decode_frame(inputs, meta, DEVICE)
    # CUDA events, not torch.profiler: it kept 1 of 3 device records
    # of this kernel, run after run (tens of ms a launch, where the
    # wrapper's uploads take some 0.1 ms); beside it the longest
    # lane's own clock64 cycles at the boost clock
    ms = cuda_ms(walk, 3)
    bools, cycles, mv_cycles = got[8][:, 0], got[8][:, 1], got[8][:, 2]
    longest = int(np.argmax(cycles))
    S = meta["S"]
    recs = np.concatenate([got[0][s, :int(got[1][s])] for s in range(S)])
    inter_blocks = [int((got[0][s, :int(got[1][s]), 6] == 0).sum())
                    for s in range(S)]
    written = (4 * 34 * int(got[1].sum()) + 8 * int(got[3].sum())
               + 8 * int(got[5].sum()) + 4 * S * PD.CNT_TOTAL + 24 * S)
    read = int(np.sum(inputs["tile_len"])) + len(PD.probs8(inputs))
    if meta.get("inter"):
        read += walk_prev_bytes(np, inputs["aux"]["hflags"], recs, meta)
        # the frame's MV (8 B) and reference (2 B) cells the blocks write
        written += 10 * meta["rows"] * meta["cols"]
    bound, bound_by, _ = bounds(read + written, int(bools.sum()), 0)
    pass_a, c_decode = native_pass_a_ms(frames, i)
    sections = walk_sections(np, PD, inputs, meta, got,
                             f"frame {i}")[longest]
    return {
        "sections": sections,
        "ms": ms, "longest_lane_ms": cycles[longest] / BOOST_HZ * 1e3,
        "bools": bools.tolist(),
        "cycles_a_bool": (cycles / np.maximum(bools, 1)).tolist(),
        "longest_lane": longest, "bound_ms": bound, "bound_by": bound_by,
        "bytes": read + written,
        "chain_ms": int(bools.max()) * BOOL_CHAIN_CYCLES / BOOST_HZ * 1e3,
        "mv_cycles": mv_cycles.tolist(), "inter_blocks": inter_blocks,
        "mv_cycles_a_block": float(mv_cycles.sum()) / max(sum(inter_blocks),
                                                          1),
        "mv_share": float(mv_cycles.sum()) / max(float(cycles.sum()), 1),
        "native_pass_a_ms": pass_a, "native_c_decode_ms": c_decode,
        "plain_ms": plain_ms}


def say_walk_row(label, row):
    say("kernels", f"passa_walk on {label}: {row['ms']:.3f} ms a call "
        f"under CUDA events (the longest lane's clock64 cycles at "
        f"{BOOST_HZ / 1e9:.2f} GHz: {row['longest_lane_ms']:.3f}); bools a "
        f"lane {row['bools']}, the longest lane's "
        f"{row['cycles_a_bool'][row['longest_lane']]:.2f} cycles a bool "
        f"(clock64; the chain alone {BOOL_CHAIN_CYCLES}); MV quanta "
        f"{row['mv_cycles_a_block']:.1f} cycles an inter block "
        f"({sum(row['inter_blocks'])} blocks, {100 * row['mv_share']:.2f}% "
        f"of the lanes' cycles); bound {row['bound_ms']:.6f} ms "
        f"({row['bound_by']}, {row['bytes']} B); chain bound "
        f"{row['chain_ms']:.3f} ms; native pass A "
        f"{row['native_pass_a_ms']:.3f} ms (passa.c_decode "
        f"{row['native_c_decode_ms']:.3f})"
        + (f"; the plain version {row['plain_ms']:.1f} ms on the host CPU"
           if row["plain_ms"] is not None else "") + f" on {card_line()}")
    sec = row["sections"]
    say("kernels", f"passa_walk sections on {label.split(' (')[0]}, the "
        "longest lane (clock64 cycles of the instance that reads them, "
        "bools): " + ", ".join(f"{k} {v}" for k, v in sec.items())
        + f"; the token loop's ZERO runs "
        f"{sec['coef_run'] / max(sec['run_positions'], 1):.1f} cycles a "
        "position, its other COEF bools "
        f"{sec['coef_loop'] / max(sec['bools_coef'] - sec['run_positions'], 1):.1f}"
        f" cycles each, {sec['mv_scan'] / max(sec['mv_scans'], 1):.1f} "
        "cycles an MV scan")


def passa_phase(torch, np, clips):
    """The on-device pass A (phase 4b of the docstring): csrc/passa.cu
    against decode_frame_plain on every intra frame of the PASSA_CLIPS
    and every frame of the PASSA_INTER_CLIPS, the counts forced on (the
    plain version on the host CPU); against the native pass A on frame 0
    of each PASSA_FRAME_CLIPS clip and every inter frame of each
    PASSA_INTER_FRAME_CLIPS clip (records, planes, eob grids, and the MV
    and reference grids), against the plain version on frame 0 of each
    PASSA_PLAIN_CLIPS clip and the PASSA_INTER_PLAIN frames, timed on
    those and the PASSA_INTER_TIMED frames; then decode_stream with
    pass_a_impl="device" over the fourteen clips on the main path (launches
    counted from zero, every plain version set to raise), every MD5
    against the framemd5, one walk launch a frame and no frame through
    the host pass A; a serial decode with synchronised stage timers; and
    the fps beside the host pass A's in turns. Returns the kernels-line
    entry."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu_torch.ops import passa_device as PD
    from ffmpeg_hybrid_tpu_torch.utils.metrics import metrics
    t0 = time.perf_counter()
    nframes = 0
    for name in PASSA_CLIPS:
        frames, _want = read_clip(name)
        dec = VP9Decoder(device=DEVICE)
        for fd in frames:
            if dec.decode_pass_a(fd).ready is not None:
                continue
            inputs, meta = PD.prep_keyframe(dec, fd)
            kernel_vs_plain(np, PD, inputs, meta, name)
            nframes += 1
    say("passa", f"csrc/passa.cu against decode_frame_plain (run on the "
        f"host CPU) on {nframes} intra frames of {len(PASSA_CLIPS)} clips "
        "(vectors/passa_*): records, pairs, counts, err words and bools a "
        "lane exact")
    ninter = nframes = 0
    for name in PASSA_INTER_CLIPS:
        frames, _want = read_clip(name)
        dec = VP9Decoder(device=DEVICE)
        for fd in frames:
            if dec.decode_pass_a(fd).ready is not None:
                continue
            inputs, meta = prep_frame(PD, dec, fd)
            meta["want_counts"] = 1
            got, _ms = kernel_vs_plain(np, PD, inputs, meta, name)
            if meta.get("inter") and not got[6].any():
                raise RuntimeError(f"passa: {name}: no symbol counted")
            ninter += bool(meta.get("inter"))
            nframes += 1
    say("passa", f"csrc/passa.cu against decode_frame_plain on the "
        f"{nframes} frames ({ninter} inter) of {len(PASSA_INTER_CLIPS)} "
        "inter clips (vectors/passa_inter_*), the symbol counts forced on: "
        "records, pairs, counts, err words, bools a lane and the MV and "
        "reference grids exact")
    for entry, props in ptxas_entries(PASSA_SRC, "passa_kernel"):
        say("kernels", f"passa_walk ptxas, {entry}: {props}")
    rows = {}
    for clip in PASSA_FRAME_CLIPS:
        frames = clips[clip][0]
        dec = VP9Decoder(device=DEVICE)
        dec.decode_pass_a(frames[0])
        inputs, meta = PD.prep_keyframe(dec, frames[0])
        got = walk_host(PD.decode_frame(inputs, meta, DEVICE))
        diff = walk_vs_native(np, dec, got, meta["S"])
        if diff or got[7].any():
            raise RuntimeError(f"passa: {clip} frame 0: the kernel against "
                               f"the native pass A: {diff or got[7]}")
        plain_ms = None
        if clip in PASSA_PLAIN_CLIPS:
            _got, plain_ms = kernel_vs_plain(np, PD, inputs, meta,
                                             f"{clip} frame 0")
        rows[clip] = walk_row(np, PD, inputs, meta, got, frames, 0,
                              plain_ms)
        say_walk_row(f"{clip} frame 0 (S={meta['S']}), exact against the "
                     "native pass A" + (" and decode_frame_plain"
                                        if plain_ms is not None else ""),
                     rows[clip])
    ninter = 0
    for clip in PASSA_INTER_FRAME_CLIPS:
        frames = clips[clip][0]
        dec = VP9Decoder(device=DEVICE)
        for i, fd in enumerate(frames):
            if dec.decode_pass_a(fd).ready is not None:
                continue
            if dec.header.keyframe or dec.header.intraonly:
                continue
            inputs, meta = PD.prep_inter(dec, fd)
            got = walk_host(PD.decode_frame(inputs, meta, DEVICE))
            diff = walk_vs_native(np, dec, got, meta["S"])
            if diff or got[7].any():
                raise RuntimeError(f"passa: {clip} frame {i}: the kernel "
                                   "against the native pass A: "
                                   f"{diff or got[7]}")
            ninter += 1
            plain_ms = None
            if (clip, i) in PASSA_FORMAT_INTER_PLAIN:
                # the symbol counts forced on, as on the small clips
                counted, plain_ms = kernel_vs_plain(
                    np, PD, inputs, dict(meta, want_counts=1),
                    f"{clip} frame {i}")
                if not counted[6].any():
                    raise RuntimeError(f"passa: {clip} frame {i}: no "
                                       "symbol counted")
            elif (clip, i) in PASSA_INTER_PLAIN:
                _got, plain_ms = kernel_vs_plain(np, PD, inputs, meta,
                                                 f"{clip} frame {i}")
            if (clip, i) in PASSA_INTER_TIMED:
                key = f"{clip} frame {i}"
                rows[key] = walk_row(np, PD, inputs, meta, got, frames, i,
                                     plain_ms)
                say_walk_row(f"{key} (S={meta['S']}, inter), exact against "
                             "the native pass A" + (
                                 " and decode_frame_plain"
                                 if plain_ms is not None else ""), rows[key])
    say("passa", f"csrc/passa.cu against the native pass A on the {ninter} "
        f"inter frames of {', '.join(PASSA_INTER_FRAME_CLIPS)}: records, "
        "coefficient planes, eob grids and the MV and reference grids "
        "(cur_mv, cur_ref) exact; against decode_frame_plain on "
        + ", ".join(f"{c} frame {i}" for c, i in PASSA_INTER_PLAIN)
        + " (the format clips' with the symbol counts forced on: records, "
        "pairs, counts, err words, bools a lane and the MV and reference "
        "grids exact)")
    # the main path: decode_stream with the device pass A
    with main_path_run():
        nwant = host_frames = 0
        for clip in PASSA_DECODE_CLIPS:
            frames, want = clips[clip]
            dec = VP9Decoder(device=DEVICE, pass_a_impl="device")
            got = [hashlib.md5(f.to_bytes()).hexdigest()
                   for f in dec.decode_stream(iter(frames))]
            if got != want:
                raise RuntimeError(f"passa: {clip} with the device pass A "
                                   "is not bit-exact")
            nwant += len(want)
            host_frames += dec.pass_a_host_frames
    launches = main_path_launches()
    if launches["passa"] != nwant or host_frames:
        raise RuntimeError(f"passa: the walk launched {launches['passa']} "
                           f"times for {nwant} frames, {host_frames} frames "
                           "through the host pass A")
    for key in ("splat", "scatter", "intra", "lf_grids", "lf_dense", "mc",
                "mc_scaled"):
        if not launches[key]:
            raise RuntimeError(f"passa: the {key} kernel never launched")
    say("passa", f"decode_stream(pass_a_impl=\"device\") on "
        f"{', '.join(PASSA_DECODE_CLIPS)}: {nwant} frames bit-exact vs "
        f"framemd5, the walk once a frame; frames through the host pass "
        f"A (pass_a_host_frames) {host_frames}; kernel launches "
        f"{launches}")
    # a serial decode, every stage timer synchronised to the card: what
    # each stage costs when none waits behind another
    frames, _want = clips["bench_1080p_lf"]
    metrics.enable()
    metrics.reset()
    metrics.sync = torch.cuda.synchronize
    try:
        dec = VP9Decoder(device=DEVICE, pass_a_impl="device")
        for fd in frames:
            dec.decode(fd)
        torch.cuda.synchronize()
    finally:
        metrics.sync = None
        metrics.disable()
    serial = {k: round(v["total_s"] * 1e3 / len(frames), 3)
              for k, v in metrics.report().items() if "total_s" in v}
    say("passa", "bench_1080p_lf with the device pass A, serial, every "
        "stage timer synchronised, ms/frame: "
        + json.dumps(serial, sort_keys=True) + f" on {card_line()}")
    rows["bench_1080p_lf"]["serial_stage_ms"] = serial
    # one timed pass each, the device pass A and the host's, in turns
    gc.collect()
    fps = {}
    metrics.enable()
    try:
        for clip in PASSA_DECODE_CLIPS:
            frames, _want = clips[clip]
            for impl in ("device", "host", "host", "device"):
                metrics.reset()
                dec = VP9Decoder(device=DEVICE, pass_a_impl=impl)
                torch.cuda.synchronize()
                t = time.perf_counter()
                n = sum(1 for _f in dec.decode_stream(iter(frames)))
                torch.cuda.synchronize()
                rep = metrics.report()
                per = {k: round(rep[k]["total_s"] * 1e3 / n, 3)
                       for k in ("decode.pass_a", "decode.pass_a_replay",
                                 "decode.pass_b", "upload.flat")
                       if k in rep}
                fps.setdefault(clip, []).append(
                    (impl, n / (time.perf_counter() - t), per))
    finally:
        metrics.disable()
    for clip, runs in fps.items():
        say("passa", f"{clip}: decode_stream fps in turns "
            + "; ".join(f"{impl} {v:.3f} (ms/frame {per})"
                        for impl, v, per in runs) + f" on {card_line()}")
        rows.setdefault(clip, {})["fps"] = [(impl, v) for impl, v, _p in runs]
        rows[clip]["stage_ms"] = [(impl, per) for impl, _v, per in runs]
    say("passa", f"phase {time.perf_counter() - t0:.1f} s")
    lf = rows["bench_1080p_lf"]
    return {"name": "passa_walk", "route": "cuda", "source": PASSA_SRC,
            "replaces": PASSA_REPLACES, "launches": launches["passa"],
            "max_abs_err": 0, "ms": lf["ms"], "plain_ms": lf["plain_ms"],
            "bound_ms": lf["bound_ms"], "bound_by": lf["bound_by"],
            "library_ms": None, "chain_ms": lf["chain_ms"],
            "per": "bench_1080p_lf frame 0 (4 tiles, one launch)",
            "ptxas": dict(ptxas_entries(PASSA_SRC, "passa_kernel")),
            "by_input": rows}


# ---------------------------------------------------------------------------
# parallel decode: GOP workers and the tile-sharded pass B


def gop_inputs(clips):
    """The gop phase's streams: (label, packets, each frame's MD5):
    bench_1080p_lf (6 GOPs), each format clip (2 GOPs), bench_1080p
    three times over (9 GOPs) and each GOP_INTER_CLIPS clip twice over (2
    GOPs of a keyframe and three inter frames), as tests/test_gop.py
    builds streams."""
    out = [("bench_1080p_lf", *clips["bench_1080p_lf"])]
    out += [(c, *clips[c]) for c in FORMAT_CLIPS]
    frames, want = clips["bench_1080p"]
    out.append(("bench_1080p x3", frames * 3, want * 3))
    for c in GOP_INTER_CLIPS:
        frames, want = clips[c]
        out.append((f"{c} x2", frames * 2, want * 2))
    return out


def two_streams_check(torch, clips):
    """Two decoders, each on its own CUDA stream, interleaved frame by
    frame on bench_1080p_lf (fault 3.1: each decoder's loop-filter
    schedule states, lf_schedules, are its own, so their launches may run
    at once): every frame's MD5 against its framemd5, the two decoders'
    schedule states disjoint."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    frames, want = clips["bench_1080p_lf"]
    decs = [VP9Decoder(device=DEVICE) for _ in range(2)]
    streams = [torch.cuda.Stream() for _ in range(2)]
    got = [[], []]
    for fd in frames:
        outs = []
        for dec, st in zip(decs, streams):
            with torch.cuda.stream(st):
                outs.append(dec.decode(fd))
        for i, (st, out) in enumerate(zip(streams, outs)):
            st.synchronize()
            got[i] += [hashlib.md5(f.to_bytes()).hexdigest() for f in out]
    a, b = (set(map(id, d.lf_schedules.values())) for d in decs)
    if got != [want, want] or not a or a & b:
        raise RuntimeError("two decoders on two streams: bench_1080p_lf not "
                           "bit-exact, or schedule states shared")
    say("gop", "two decoders on two CUDA streams, interleaved frame by "
        "frame on bench_1080p_lf: every frame bit-exact vs framemd5, each "
        "decoder on its own loop-filter schedule states")


def gop_busy(torch, packets, workers):
    """The card's busy share of one decode_gops_parallel pass under
    torch.profiler: the device time of its kernels over the wall time
    (with workers on several streams, kernels that overlap count each),
    scaled by the port's kernels' launches over their records kept."""
    from torch.autograd import DeviceType
    from ffmpeg_hybrid_tpu_torch.parallel.gop import decode_gops_parallel

    def timed():
        t0 = time.perf_counter()
        for _f in decode_gops_parallel(packets, workers=workers):
            pass
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prof, wall, kept = profiled(timed, launch_records)
    us = sum(_device_us(e) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and PAD_KERNEL not in e.key)
    if not us:
        raise RuntimeError("the profiler saw no device time in a GOP pass")
    return us * kept_scale(kept) / 1e6 / wall


def gop_phase(torch, clips):
    """GOP-parallel decode on the card (phase 6 of the docstring): first
    two decoders on two streams (two_streams_check); then
    decode_gops_parallel with each of GOP_WORKERS workers on every gop
    input, every frame's MD5 against its framemd5, on the main path (the
    launches of the conformance passes counted from zero, the plain
    versions set to raise); per input and worker count a timed pass (wall
    fps, host pass A ms/frame summed over the workers' threads) and the
    card's busy share under torch.profiler; decode_gops_md5_multiprocess
    in GOP_PROCS spawned processes on bench_1080p_lf; a GOP whose packet
    is cut short raises ValueError at its place with every worker joined.
    Returns {label: {workers: (fps, pass A ms/frame, busy share)}}."""
    from ffmpeg_hybrid_tpu_torch.parallel import gop as PG
    from ffmpeg_hybrid_tpu_torch.utils.metrics import metrics
    inputs = gop_inputs(clips)
    t0 = time.perf_counter()
    with main_path_run():
        two_streams_check(torch, clips)
        for label, packets, want in inputs:
            for workers in GOP_WORKERS:
                got = [hashlib.md5(f.to_bytes()).hexdigest()
                       for f in PG.decode_gops_parallel(packets,
                                                        workers=workers)]
                if got != want:
                    bad = next((i for i, (a, b) in enumerate(zip(got, want))
                                if a != b), min(len(got), len(want)))
                    raise RuntimeError(f"gop: {label} with {workers} "
                                       f"workers: frame {bad} of {len(got)} "
                                       f"(of {len(want)}) is not bit-exact")
    launches = main_path_launches()
    for key in ("splat", "scatter", "residual", "residual_hbd", "mc",
                "intra", "lf_dense", "lf_grids"):
        if not launches[key]:
            raise RuntimeError(f"gop: the {key} kernel never launched in "
                               f"the GOP passes: {launches}")
    say("gop", f"decode_gops_parallel with {GOP_WORKERS} workers on "
        + ", ".join(f"{label} ({len(PG.split_gops(p))} GOPs, {len(w)} "
                    "frames)" for label, p, w in inputs)
        + f": every frame bit-exact vs framemd5 in "
        f"{time.perf_counter() - t0:.1f} s; kernel launches {launches}")
    results = {}
    card = card_line()
    for label, packets, _want in inputs:
        for workers in GOP_WORKERS:
            gc.collect()
            metrics.enable()
            metrics.reset()
            try:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                n = sum(1 for _f in PG.decode_gops_parallel(
                    packets, workers=workers))
                torch.cuda.synchronize()
                fps = n / (time.perf_counter() - t1)
                pass_a = metrics.report()["decode.pass_a"]["total_s"] \
                    * 1e3 / n
            finally:
                metrics.disable()
            busy = gop_busy(torch, packets, workers)
            results.setdefault(label, {})[workers] = (fps, pass_a, busy)
        say("gop", f"{label}: " + "; ".join(
            f"{w} worker{'s' if w > 1 else ''} {fps:.3f} fps (host pass A "
            f"{pa:.3f} ms/frame summed over the workers, the card busy "
            f"{100 * b:.2f}%)" for w, (fps, pa, b) in results[label].items())
            + f" on {card}")
    t1 = time.perf_counter()
    path = os.path.join(ROOT, "vectors", "bench_1080p_lf.ivf")
    got = [m for _n, m in PG.decode_gops_md5_multiprocess(path,
                                                          n_procs=GOP_PROCS)]
    if got != clips["bench_1080p_lf"][1]:
        raise RuntimeError("gop: the multiprocess decode of bench_1080p_lf "
                           "is not bit-exact")
    say("gop", f"decode_gops_md5_multiprocess, {GOP_PROCS} spawned "
        "processes on bench_1080p_lf (loading the built kernels): every "
        f"frame bit-exact vs framemd5, {time.perf_counter() - t1:.1f} s")
    frames, want = clips["bench_1080p_lf"]
    bad = frames[:3] + [frames[3][:9]] + frames[4:]
    got = []
    try:
        for f in PG.decode_gops_parallel(bad, workers=2):
            got.append(hashlib.md5(f.to_bytes()).hexdigest())
    except ValueError as e:
        err = e
    else:
        raise RuntimeError("gop: a GOP cut short raised nothing")
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("ThreadPoolExecutor")]
    if got != want[:3] or alive:
        raise RuntimeError(f"gop: the cut GOP raised after {len(got)} frames"
                           f" (expected 3 bit-exact ones); workers alive "
                           f"{alive}")
    say("gop", f"bench_1080p_lf with GOP 3's packet cut to 9 bytes: the "
        f"generator yields GOPs 0-2 bit-exact, then raises ValueError "
        f"({err}); every worker joined")
    return results


def serial_steps(np, tsteps, x0, halo):
    """The serial schedule [S, D, 7] of per-stripe steps [T, S, D, 7]
    (pack_schedule_tiles): the same (wave, substep) rows and lanes, each
    record's px back in the frame's columns (x0: the stripes' offsets;
    halo: the columns before a stripe's own)."""
    out = np.zeros(tsteps.shape[1:], np.int32)
    for t, a in enumerate(x0):
        live = tsteps[t, ..., 3] > 0
        rec = tsteps[t].copy()
        rec[..., 1] += a - halo
        out[live] = rec[live]
    return out


def lf_replay_checks(torch, np, captured, lf_dense):
    """The replay kernel (csrc/lpf_replay.cu) on the sharded runs' own
    inputs, as sharded_decode_pass_b hands them over (captured: {clip:
    [(buffers, steps, wreal, bpp, sb) for Y, U+V]}): the sharded launch
    against lf_scan_sharded_plain; the stripes joined and the serial
    schedule through the one-stripe launch (lf_scan) against
    lf_scan_plain and against the sharded result; each launch's time
    under CUDA events on tickets built beforehand, the host time to build
    them (lpf_replay.Replay), and the chain alone (the same tickets with
    every record a no-op: their waits, windows, levels and write-backs);
    the bound terms; on bench_1080p_lf beside csrc/lpf.cu's time on the
    same frame (lf_dense: lpf_phase's entry). Returns the kernels-line
    entry."""
    from ffmpeg_hybrid_tpu_torch.ops import lpf_replay as LR
    err, rows = 0, {}
    for clip, sets in captured.items():
        for which, (buf, steps, wreal, bpp, sb) in zip(("Y", "U+V"), sets):
            T, B, H, Wb = buf.shape
            want, plain_ms = host_ms(torch, lambda: LR.lf_scan_sharded_plain(
                buf, steps, wreal, bpp))
            t0 = time.perf_counter()
            rp = LR.Replay(steps, buf.shape, sb, wreal, LR.HALO, T > 1)
            build_ms = (time.perf_counter() - t0) * 1e3
            got = LR.lf_scan_sharded(buf.clone(), rp, wreal, bpp, sb)
            e = int((got - want).abs().max())
            x0 = np.concatenate([[0], np.cumsum(wreal)[:-1]])
            joined = torch.cat([buf[t, :, :, LR.HALO:LR.HALO + w]
                                for t, w in enumerate(wreal)], dim=2)
            ssteps = serial_steps(np, steps, x0, LR.HALO)
            swant, splain_ms = host_ms(torch, lambda: LR.lf_scan_plain(
                joined, ssteps, bpp))
            t0 = time.perf_counter()
            srp = LR.Replay(ssteps[None], (1,) + tuple(joined.shape), sb)
            sbuild_ms = (time.perf_counter() - t0) * 1e3
            sgot = LR.lf_scan(joined, srp, bpp, sb)
            sharded_joined = torch.cat([got[t, :, :, LR.HALO:LR.HALO + w]
                                        for t, w in enumerate(wreal)], dim=2)
            e = max(e, int((sgot - swant).abs().max()),
                    int((sharded_joined - swant).abs().max()))
            if e:
                raise RuntimeError(f"lf_replay on {clip} {which}: kernel != "
                                   f"plain (max |diff| {e})")
            err = max(err, e)
            # CUDA events (the card's timestamps) around launches whose
            # tickets are on the card already (building them is host
            # work, timed apart), less the copies that restore their inputs
            work = buf.clone()
            copy_ms = cuda_ms(lambda: work.copy_(buf), 10)
            ms = cuda_ms(lambda: (work.copy_(buf), LR.lf_scan_sharded(
                work, rp, wreal, bpp, sb)), 10) - copy_ms
            clone_ms = cuda_ms(lambda: joined.clone(), 10)
            sms = cuda_ms(lambda: LR.lf_scan(joined, srp, bpp, sb), 10) \
                - clone_ms
            idle = rp.idle()
            chain_ms = cuda_ms(lambda: LR.lf_scan_sharded(
                work, idle, wreal, bpp, sb), 10)
            nrec = int((steps[..., 3] > 0).sum())
            run = LR.steps_run(steps)
            # the frame's columns of the plane set read and written once
            # (not the halos or the padding of the stripe buffers), each
            # record read once; the edge decision of every lane of every
            # record, a floor. The halo copy, each tail read and its
            # mirror written once a stripe after the first, is its own term
            nbytes = 2 * B * H * int(sum(wreal)) * 4 + nrec * 7 * 4
            halo_bytes = 2 * (T - 1) * B * H * LR.HALO * 4
            nops = nrec * 8 * B * LF_DECISION_OPS
            waves = 2 * (H // sb[1] - 1) + int(sum(wreal)) // sb[0]
            bound_ms, bound_by, chain_bound = bounds(nbytes, nops, run)
            rows[(clip, which)] = dict(
                ms=ms, serial_ms=sms, chain_ms=chain_ms, plain_ms=plain_ms,
                serial_plain_ms=splain_ms, bound_ms=bound_ms,
                bound_by=bound_by, steps=run, records=nrec,
                tickets=rp.ntickets, waves=waves, build_ms=build_ms,
                serial_build_ms=sbuild_ms, stripes=T, shape=(B, H, Wb),
                bytes=nbytes, halo_bytes=halo_bytes, ops=nops,
                us_per_wave=ms * 1e3 / max(waves, 1),
                us_per_record=ms * 1e3 / max(nrec, 1),
                chain_bound_ms=chain_bound)
            say("kernels", f"lf_replay on {clip} frame 0 {which} ({T} stripes"
                f" of {B} x {H} x {Wb}, superblocks {sb[0]}x{sb[1]}; {nrec} "
                f"records of {run} steps in {rp.ntickets} tickets, {waves} "
                f"waves): sharded ms={ms:.4f} ({ms * 1e3 / max(waves, 1):.3f}"
                f" us a wave), the same tickets as no-ops (the chain alone) "
                f"{chain_ms:.4f} ms, one stripe (the serial schedule) "
                f"{sms:.4f} ms; host build of the tickets {build_ms:.2f} ms "
                f"sharded, {sbuild_ms:.2f} ms serial; plain {plain_ms:.1f} ms"
                f" sharded, {splain_ms:.1f} ms serial; bound_ms="
                f"{bound_ms:.6f} ({bound_by}, {nbytes} B, {nops} ops; the "
                f"halo copy {halo_bytes} B more); exact vs both plain "
                "versions and sharded == serial")
    for name, props in ptxas_entries(LF_REPLAY_SRC, "lf_replay"):
        say("kernels", f"lf_replay ptxas ({name}): {props}")
    lf = [rows[("bench_1080p_lf", w)] for w in ("Y", "U+V")]
    say("kernels", f"lf_replay beside lf_dense (csrc/lpf.cu) on "
        f"bench_1080p_lf frame 0: the replay's Y + U+V {lf[0]['ms']:.4f} + "
        f"{lf[1]['ms']:.4f} = {lf[0]['ms'] + lf[1]['ms']:.4f} ms sharded "
        f"({lf[0]['serial_ms'] + lf[1]['serial_ms']:.4f} ms serial, chain "
        f"alone {lf[0]['chain_ms'] + lf[1]['chain_ms']:.4f}); lf_dense "
        f"{lf_dense['ms']:.4f} ms both sets in one launch (Y alone "
        f"{lf_dense['ms_y_alone']:.4f}, U+V alone "
        f"{lf_dense['ms_uv_alone']:.4f}); on {card_line()}")
    return {"name": "lf_replay", "route": "cuda", "source": LF_REPLAY_SRC,
            "replaces": LF_REPLAY_REPLACES, "launches": None,
            "max_abs_err": err, "ms": sum(r["ms"] for r in lf),
            "plain_ms": sum(r["plain_ms"] for r in lf),
            "bound_ms": sum(r["bound_ms"] for r in lf),
            "bound_by": lf[0]["bound_by"], "library_ms": None,
            "per": f"frame (a Y and a U+V launch, {lf[0]['stripes']} "
                   "stripes) of bench_1080p_lf frame 0",
            "chain_ms": sum(r["chain_ms"] for r in lf),
            "lf_dense_ms": lf_dense["ms"],
            "by_input": {f"{c} {w}": r for (c, w), r in rows.items()}}


def sharded_run(torch, label, frames, want, mesh_shape, step=1, only=None):
    """sharded_decode_pass_b over a (gop, tile) mesh, `step` frames a step
    (rows of one step decoded by one decoder's pass A in order), each
    output installed as its frame's planes; a frame whose tile count is
    not the mesh's (only: the tile count to shard) decodes serially. Every
    frame's MD5 against `want`; after every sharded frame the decoder's
    kept coefficient buffers read zero. Returns (sharded frames, filtered
    sharded frames, wall ms/frame of the pass)."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu_torch.parallel import fullframe as PF
    from ffmpeg_hybrid_tpu_torch.parallel.mesh import make_mesh
    gop, ntile = mesh_shape
    mesh = make_mesh(gop * ntile, gop)
    dec = VP9Decoder(device=DEVICE)
    got, nshard, nlf = [], 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, len(frames), step):
        jobs = [dec.decode_pass_a(fd) for fd in frames[i:i + step]]
        shard = [j for j in jobs if j.ready is None and (
            only is None or j.header.tile_cols == only)]
        for j in jobs:
            if j.ready is None and j not in shard:
                dec.decode_pass_b(dec.precompute_job(j))
        if shard:
            outs = PF.sharded_decode_pass_b(shard, make_mesh(
                len(shard) * ntile, len(shard)) if len(shard) != gop
                else mesh)
            for j, planes in zip(shard, outs):
                PF.install(j, planes)
                nshard += 1
                nlf += bool(j.header.filter_level)
            if not all(b.read_zero() and b.consumed
                       for b in dec.coef_bufs.values()):
                raise RuntimeError(f"sharded: {label} frame {i}: a kept "
                                   "coefficient buffer does not read zero")
        for j in jobs:
            got += [hashlib.md5(f.to_bytes()).hexdigest()
                    for f in (j.ready if j.ready is not None else j.outputs)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    if got != want[:len(got)] or len(got) != len(want):
        bad = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
                   len(got))
        raise RuntimeError(f"sharded: {label} on {mesh_shape}: frame {bad} "
                           f"of {len(got)} is not bit-exact")
    return nshard, nlf, ms


def sharded_phase(torch, np, clips, lf_dense):
    """The tile-sharded pass B on the card (phase 7 of the docstring):
    sharded_decode_pass_b on each SHARDED_RUNS input, every frame
    bit-exact, on the main path (launches counted from zero, the plain
    versions set to raise; the replay kernel twice a filtered sharded
    frame); then lf_replay_checks on the replay inputs of bench_1080p_lf
    and bench_4k frame 0 (lf_dense: lpf_phase's entry, csrc/lpf.cu's time
    on bench_1080p_lf frame 0). Returns the kernels-line entry of
    lf_replay and the captured inputs."""
    from ffmpeg_hybrid_tpu_torch.ops import lpf_replay as LR
    captured = {}
    real = LR.lf_scan_sharded

    def capture_first(clip):
        def wrapped(pl, steps, wreal, bpp, sb):
            sets = captured.setdefault(clip, [])
            if len(sets) < 2:
                sets.append((pl.clone(), np.array(steps), list(wreal), bpp,
                             tuple(sb)))
            return real(pl, steps, wreal, bpp, sb)
        return wrapped

    t0 = time.perf_counter()
    lines = []
    with main_path_run():
        nlf_total = 0
        for label, clip, nframes, mesh_shape, step, only in SHARDED_RUNS:
            frames, want = clips[clip]
            n = len(frames) if nframes is None else nframes
            if label in ("bench_1080p_lf", "bench_4k"):
                LR.lf_scan_sharded = capture_first(clip)
            try:
                nshard, nlf, ms = sharded_run(torch, label, frames[:n],
                                              want[:n], mesh_shape, step,
                                              only)
            finally:
                LR.lf_scan_sharded = real
            nlf_total += nlf
            lines.append(f"{label} on {mesh_shape}: {n} frames ({nshard} "
                         f"sharded) bit-exact, {ms:.2f} ms/frame")
    launches = main_path_launches()
    if launches["lf_replay"] != 2 * nlf_total:
        raise RuntimeError(f"sharded: lf_replay launched "
                           f"{launches['lf_replay']} times for {nlf_total} "
                           "filtered sharded frames (expected one a plane "
                           "set a frame)")
    for key in ("splat", "scatter", "residual", "residual_hbd", "mc",
                "mc_scaled", "intra", "lf_replay"):
        if not launches[key]:
            raise RuntimeError(f"sharded: the {key} kernel never launched: "
                               f"{launches}")
    say("sharded", "sharded_decode_pass_b: " + "; ".join(lines)
        + f"; kernel launches {launches} (lf_replay twice a filtered sharded "
        f"frame, {nlf_total} frames); {time.perf_counter() - t0:.1f} s")
    entry = lf_replay_checks(torch, np, captured, lf_dense)
    entry["launches"] = launches["lf_replay"]
    return entry, captured


def band_stats(np, frames, which):
    """The replay steps and records of the pipeline's bands of one plane
    set (prepare_frame's `ysteps` or `uvsteps` of every frame): (steps a
    band, records a band) as numpy arrays over the bands with a record."""
    bands = [s.steps[0] for fr in frames for s in fr[which] if s is not None]
    steps = np.asarray([s.shape[0] for s in bands])
    recs = np.asarray([int((s[..., 3] > 0).sum()) for s in bands])
    return steps, recs


def spread(np, a):
    """min-median-max of a, or "none"."""
    return f"{int(a.min())}-{int(np.median(a))}-{int(a.max())}" \
        if len(a) else "none"


def gop_pipeline_phase(torch, np, by_name):
    """The chained-GOP stripe pipeline on the card (phase 7b of the
    docstring): the serial decode of CHAINED_CLIP (its MD5s, each inter
    frame's decode_pass_b under CUDA events); decode_chained_gop on the
    main path (launches from zero, the plain versions set to raise), its
    frames' MD5s against the framemd5 and their coded areas against the
    serial decode, the MC and replay launches against the schedule's
    count; the run alone timed under CUDA events after a warm-up, the
    replay's steps a band and one band's time; the dry runs; the card
    against the CPU on the small chained clip. Adds the path's launches to
    the kernels-line entries (`launches_by_path`)."""
    from ffmpeg_hybrid_tpu_torch.codecs.vp9.decoder import VP9Decoder
    from ffmpeg_hybrid_tpu_torch.ops import lpf_replay as LR
    from ffmpeg_hybrid_tpu_torch.parallel import dryrun
    from ffmpeg_hybrid_tpu_torch.parallel import gop_pipeline as GP
    from ffmpeg_hybrid_tpu_torch.parallel.mesh import make_mesh
    t0 = time.perf_counter()
    packets, want = read_clip(CHAINED_CLIP)
    if len(packets) != PIPE_G + 1:
        raise RuntimeError(f"{CHAINED_CLIP}: {len(packets)} packets")
    mesh = make_mesh(PIPE_G, PIPE_G)

    dec = VP9Decoder(device=DEVICE)
    serial, serial_ms = [], []
    for i, fd in enumerate(packets):
        job = dec.precompute_job(dec.decode_pass_a(fd))
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        serial += dec.decode_pass_b(job)
        end.record()
        end.synchronize()
        if i:
            serial_ms.append(start.elapsed_time(end))
    if [hashlib.md5(f.to_bytes()).hexdigest() for f in serial] != want:
        raise RuntimeError(f"gop_pipeline: the serial decode of "
                           f"{CHAINED_CLIP} is not bit-exact")

    with main_path_run():
        (oy, ou, ov), jobs = GP.decode_chained_gop(packets, mesh, PIPE_HS,
                                                   PIPE_LAG)
        torch.cuda.synchronize()
        launches = main_path_launches()
    got = [hashlib.md5(j.cur_frame_obj.to_bytes()).hexdigest() for j in jobs]
    if got != want[1:]:
        bad = next(i for i, (a, b) in enumerate(zip(got, want[1:]))
                   if a != b)
        raise RuntimeError(f"gop_pipeline: {CHAINED_CLIP} chained frame "
                           f"{bad} does not match the framemd5")
    w, h = serial[0].size
    cw, ch = ((w + 7) >> 3) * 8, ((h + 7) >> 3) * 8
    for g in range(PIPE_G):
        for p, out in enumerate((oy, ou, ov)):
            ph, pw = (ch, cw) if p == 0 else (ch >> 1, cw >> 1)
            if not torch.equal(out[g][:ph, :pw],
                               serial[1 + g].dev[p][:ph, :pw]):
                raise RuntimeError(f"gop_pipeline: frame {g} plane {p} "
                                   "differs from the serial decode")

    t1 = time.perf_counter()
    run, frames, ref0, _jobs = GP.prepare_chained_gop(packets, mesh, PIPE_HS,
                                                      PIPE_LAG)
    torch.cuda.synchronize()
    prep_ms = (time.perf_counter() - t1) * 1e3
    S_f = len(frames[0]["ysteps"])
    ysteps, yrecs = band_stats(np, frames, "ysteps")
    uvsteps, uvrecs = band_stats(np, frames, "uvsteps")
    # the schedule: an MC launch a frame's stripe, a replay launch a band
    # of Y and one of U+V with a record (2 * G * S_f when all have one)
    want_l = {"mc": PIPE_G * S_f, "lf_replay": len(ysteps) + len(uvsteps)}
    for key, n in launches.items():
        if key in want_l and n != want_l[key]:
            raise RuntimeError(f"gop_pipeline: {key} launched {n} times, "
                               f"the schedule gives {want_l[key]}")
        if key not in PIPE_KERNELS.values() and n:
            raise RuntimeError(f"gop_pipeline: {key} launched {n} times "
                               "off the path")
    for key in PIPE_KERNELS.values():
        if not launches[key]:
            raise RuntimeError(f"gop_pipeline: the {key} kernel never "
                               f"launched: {launches}")
    for name, key in PIPE_KERNELS.items():
        by_name[name].setdefault("launches_by_path", {})[
            "gop_pipeline " + CHAINED_CLIP] = launches[key]

    run(frames, ref0)
    torch.cuda.synchronize()
    runs = []
    for _ in range(PIPE_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        tw = time.perf_counter()
        start.record()
        outs = run(frames, ref0)
        end.record()
        end.synchronize()
        runs.append((start.elapsed_time(end),
                     (time.perf_counter() - tw) * 1e3))
    for g in range(PIPE_G):
        if not all(torch.equal(outs[g][p], out[g])
                   for p, out in enumerate((oy, ou, ov))):
            raise RuntimeError(f"gop_pipeline: a timed run's frame {g} "
                               "differs from the first run's")
    dev_ms = sorted(r[0] for r in runs)[PIPE_REPS // 2]
    wall_ms = sorted(r[1] for r in runs)[PIPE_REPS // 2]
    # one band of each plane set alone: frame 0's band with the median
    # steps, its launch under CUDA events on its rows of the output
    band, bpp = {}, jobs[0].header.bpp
    for which, Hp, planes, sb in (("ysteps", PIPE_HS, (oy,), (64, 64)),
                                  ("uvsteps", PIPE_HS >> 1, (ou, ov),
                                   (32, 32))):
        live = [(s.steps.shape[1], j, s) for j, s in
                enumerate(frames[0][which]) if s is not None]
        n, j, s = sorted(live, key=lambda t: t[0])[len(live) // 2]
        y0, y1 = max(j * Hp - 8, 0), (j + 1) * Hp
        pl = torch.stack([p[0][y0:y1] for p in planes])
        ms = cuda_ms(lambda: LR.lf_scan(pl, s, bpp, sb), 10) \
            - cuda_ms(lambda: pl.clone(), 10)
        band[which] = (n, j, ms, ms * 1e3 / n, s.nrecords,
                       ms * 1e3 / max(s.nrecords, 1))
    say("gop_pipeline", f"decode_chained_gop on {CHAINED_CLIP} ({w}x{h}, "
        f"{PIPE_G} chained inter frames on a [{PIPE_G}, 1] mesh of "
        f"{mesh.row_device(0)}, {S_f} stripes of {PIPE_HS} rows, lag "
        f"{PIPE_LAG}, {S_f + (PIPE_G - 1) * PIPE_LAG} steps): every frame "
        f"bit-exact vs framemd5 and vs the serial decode; launches {launches}"
        f" (mc {want_l['mc']} = G x S_f, lf_replay {want_l['lf_replay']} "
        f"bands with a record of {2 * PIPE_G * S_f})")
    say("gop_pipeline", f"the run (CUDA events, median of {PIPE_REPS} after "
        f"a warm-up, [ms]: {[round(r[0], 3) for r in runs]}): "
        f"{dev_ms / PIPE_G:.3f} ms a frame ({dev_ms:.3f} for {PIPE_G}; "
        f"host wall {wall_ms / PIPE_G:.3f}); the serial decode_pass_b of "
        f"the same frames {np.mean(serial_ms):.3f} ms a frame "
        f"({[round(x, 3) for x in serial_ms]}); the pipeline's preparation "
        f"(keyframe decode, pass A, grids, residuals, records, host wall) "
        f"{prep_ms / PIPE_G:.3f} ms a frame; on {card_line()}")
    say("gop_pipeline", "replay steps a band (min-median-max): Y "
        f"{spread(np, ysteps)} ({int(ysteps.sum())} in {len(ysteps)} bands, "
        f"records {spread(np, yrecs)}), U+V {spread(np, uvsteps)} "
        f"({int(uvsteps.sum())} in {len(uvsteps)}, records "
        f"{spread(np, uvrecs)}); frame 0's median band alone: " + ", ".join(
            f"{label} stripe {j} {n} steps, {nr} records {ms:.4f} ms ({us:.3f}"
            f" us a step, {ur:.3f} us a record)"
            for label, (n, j, ms, us, nr, ur) in (("Y", band["ysteps"]),
                                                  ("U+V", band["uvsteps"]))))

    with main_path_run():
        dryrun.dryrun_multichip(DRYRUN_SLOTS)
        dryrun.dryrun_gop_pipeline(PIPE_G)
        small, _want = dryrun.read_clip(dryrun.CHAINED_CLIP)
        card, _jobs = GP.decode_chained_gop(small, make_mesh(PIPE_G, PIPE_G))
        torch.cuda.synchronize()
        small_launches = main_path_launches()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tc = time.perf_counter()
        cpu, _jobs = GP.decode_chained_gop(
            small, make_mesh(PIPE_G, PIPE_G, device="cpu"))
        cpu_s = time.perf_counter() - tc
    finally:
        torch.set_num_threads(threads)
    for p in range(3):
        if not torch.equal(card[p].cpu(), cpu[p]):
            raise RuntimeError(f"gop_pipeline: {dryrun.CHAINED_CLIP} plane {p}"
                               ": the card's pipeline differs from the CPU's")
    say("gop_pipeline", f"dry runs passed on the card; {dryrun.CHAINED_CLIP}: "
        f"the card's decode_chained_gop equal to the CPU's (plain versions, "
        f"{cpu_s:.1f} s), whole padded planes {tuple(card[0].shape)}; "
        f"launches of the dry runs and the card run {small_launches}; "
        f"phase {time.perf_counter() - t0:.1f} s")
    return {"ms_a_frame": dev_ms / PIPE_G, "serial_ms": serial_ms,
            "steps": (ysteps, uvsteps), "band": band}


def mesh_rank_setup(_rank):
    """rank_setup of the mesh_mp phase's ranks: the main path's run in
    each (launches from zero, the plain versions set to raise), held open
    for the rank's life."""
    main_path_run().__enter__()


def segments_alone(torch, np, captured, split, check):
    """Each rank's replay segments (lf_scan_sharded_dist) on a clip's
    frame-0 replay inputs (captured: [(buffers, steps, wreal, bpp, sb)]
    for Y and U+V, as sharded_decode_pass_b hands them over) in this
    process alone, the swaps bringing back what was sent (so the merges
    keep the rank's own columns and no other process shares the card):
    with check, rank 0's result held to lf_scan_sharded_dist_plain's with
    the same swaps (max |diff| 0; the plain version is a Python loop of
    many seconds a rank), the launches' device ms (CUDA events around each), the
    span of the scan under CUDA events with its host wall ms (the
    segments' tickets built in it), beside one launch of the rank's
    stripes over the same steps (lf_scan_sharded, its tickets built
    beforehand). Returns {rank: (launches, their device ms, span ms,
    host ms, one launch ms)} summed over Y and U+V."""
    from ffmpeg_hybrid_tpu_torch.ops import lpf_replay as LR
    from ffmpeg_hybrid_tpu_torch.parallel import dist as D

    class Own(D.HaloExchange):
        def swap(self, peer, send=None, like=None):
            self.exchanges += 1
            return None if like is None else like.clone()

    ranks = list(np.repeat([0, 1], split))
    out = {}
    for rank in (0, 1):
        tot = np.zeros(5)
        for buf, steps, wreal, bpp, sb in captured:
            lo, hi, _cuts, _segs = LR.segment_plan(steps, wreal, ranks, rank)
            local = buf[lo:hi].clone()
            work = local.clone()
            copy_ms = cuda_ms(lambda: work.copy_(local), 5)
            ex = Own(rank, timed=True)
            work.copy_(local)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            LR.lf_scan_sharded_dist(work, steps, wreal, bpp, ranks, ex, sb)
            end.record()
            end.synchronize()
            host = (time.perf_counter() - t0) * 1e3
            if check and rank == 0:
                want = LR.lf_scan_sharded_dist_plain(
                    local.cpu(), steps, wreal, bpp, ranks, Own(rank))
                e = int((work.cpu() - want).abs().max())
                if e:
                    raise RuntimeError(f"mesh_mp: rank {rank}'s segments "
                                       "alone differ from the plain version"
                                       f" (max |diff| {e})")
            rp = LR.Replay(np.asarray(steps)[lo:hi], local.shape, sb,
                           wreal[lo:hi], LR.HALO, hi - lo > 1)
            one = cuda_ms(lambda: (work.copy_(local), LR.lf_scan_sharded(
                work, rp, wreal[lo:hi], bpp, sb)), 5) - copy_ms
            tot += (len(ex.replay_events), ex.replay_ms(),
                    start.elapsed_time(end), host, one)
        out[rank] = tuple(tot)
    return out


def gloo_cuda_probe(rank, store, results):
    """One rank of gloo_cuda_check: a gloo send (rank 0) or receive (rank
    1) of a CUDA tensor, and what came of it, put on results."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    try:
        dist.init_process_group("gloo", init_method="file://" + store,
                                rank=rank, world_size=2,
                                timeout=timedelta(seconds=20))
        want = torch.arange(16, dtype=torch.int32)
        t = (want if rank == 0 else torch.zeros_like(want)).cuda()
        try:
            if rank == 0:
                dist.send(t, 1)
                out = "returned"
            else:
                dist.recv(t, 0)
                out = "returned, " + ("the values sent" if torch.equal(
                    t.cpu(), want) else "other values")
        except Exception as e:  # noqa: BLE001 - the outcome is the reading
            out = f"raised {type(e).__name__}: {str(e).splitlines()[0][:160]}"
        results.put((rank, out))
    except Exception as e:  # noqa: BLE001 - the outcome is the reading
        results.put((rank, f"failed before the call: {e}"))


def gloo_cuda_check():
    """Whether gloo's point-to-point calls take CUDA tensors on this
    machine (parallel/dist.py stages through host buffers on the premise
    that they do not): two spawned processes, a send and a receive of a
    CUDA tensor; returns what each reported, or its exit code."""
    import multiprocessing as mp
    import queue
    import shutil
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="gloo_probe_")
    procs = [ctx.Process(target=gloo_cuda_probe, args=(
        r, os.path.join(tmp, "store"), results)) for r in range(2)]
    got = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + 90
        while len(got) < 2 and time.monotonic() < deadline:
            try:
                rank, out = results.get(timeout=1.0)
                got[rank] = out
            except queue.Empty:
                if all(p.exitcode is not None for p in procs):
                    break
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    return {r: got.get(r, f"no word (exit code {procs[r].exitcode})")
            for r in range(2)}


def mesh_mp_phase(torch, np, by_name, replay_inputs):
    """The rank mesh on the card (phase 7c of the docstring): each
    MESH_MP_RUNS input through decode_mesh_multiprocess in two ranks on
    the main path, every frame's MD5 against the framemd5, the counts
    held to the plans; each rank's times a frame; then each rank's
    segments of bench_1080p_lf and bench_4k frame 0 alone in this process
    (segments_alone, replay_inputs from the sharded phase). Adds the
    ranks' launches to the kernels line (`launches_by_path`)."""
    from ffmpeg_hybrid_tpu_torch.parallel import dist as D
    t0 = time.perf_counter()
    try:
        D.decode_mesh_multiprocess([], 1, 4, 2, backend="nccl")
    except ValueError as e:
        refused = str(e)
    else:
        raise RuntimeError("mesh_mp: nccl on one shared card did not raise")
    card = card_line()
    for clip, nframes, (gop, ntile) in MESH_MP_RUNS:
        frames, want = read_clip(clip)
        n = len(frames) if nframes is None else nframes
        tc = time.perf_counter()
        md5s, stats = D.decode_mesh_multiprocess(
            frames[:n], gop, ntile, 2, timeout=MESH_MP_TIMEOUT,
            rank_setup=mesh_rank_setup)
        if md5s != want[:n]:
            bad = next((i for i, (a, b) in enumerate(zip(md5s, want))
                        if a != b), len(md5s))
            raise RuntimeError(f"mesh_mp: {clip} frame {bad} of {len(md5s)} "
                               "is not bit-exact")
        label = f"{clip} on {[gop, ntile]} split " + "+".join(
            str(st["slots"][0][2] - st["slots"][0][1]) for st in stats)
        for st in stats:
            k = st["frames"]
            lr = st["launches"]["lf_replay"]
            if lr != st["segments"] or st["exchanges"] != (
                    st["cut_steps"] + st["initial"]):
                raise RuntimeError(
                    f"mesh_mp: {label} rank {st['rank']}: {lr} lf_replay "
                    f"launches for {st['segments']} segments, "
                    f"{st['exchanges']} swaps for {st['cut_steps']} "
                    f"cross-rank steps and {st['initial']} first swaps")
            for key in ("splat",):
                if st["launches"][key] != k:
                    raise RuntimeError(f"mesh_mp: {label} rank {st['rank']}"
                                       f": {key} launched "
                                       f"{st['launches'][key]} times for {k}"
                                       " frames")
            for name in ("lf_replay", "_grids_from_records", "scatter_coef",
                         "residual_planes", "mc_planes",
                         "_intra_scan_planes"):
                key = PIPE_KERNELS[name]
                by_name[name].setdefault("launches_by_path", {})[
                    f"mesh_mp {clip} rank {st['rank']}"] = \
                    st["launches"][key]
            say("mesh_mp", f"{label} rank {st['rank']} (slots "
                f"{st['slots']}): {k} frames, {st['ms']:.3f} ms a frame "
                f"(CUDA events: the sharded step, gather and install); "
                f"a frame: replay {st['replay_ms'] / k:.3f} ms in "
                f"{lr / k:.1f} launches ({st['segments'] / k:.1f} segments, "
                f"{st['cut_steps'] / k:.1f} cross-rank steps), "
                f"{st['exchanges'] / k:.1f} swaps {st['exchange_ms'] / k:.3f}"
                f" ms {st['exchange_bytes'] / k:.0f} B "
                f"({st['exchange_ms'] / max(st['exchanges'], 1) * 1e3:.1f} "
                f"us a swap, {st['wire_ms'] / k:.3f} ms of it in gloo's "
                f"send and receive; {st['sync_ms'] / k:.3f} ms waiting for "
                f"the rank's own stream before them), gather "
                f"{st['gather_ms'] / k:.3f} ms "
                f"{st['gather_bytes'] / k:.0f} B; launches "
                f"{st['launches']}; on {card}")
        say("mesh_mp", f"{label}: {n} frames bit-exact vs framemd5 on both "
            f"ranks, {time.perf_counter() - tc:.1f} s with the ranks' start")
    for clip, ntile in (("bench_1080p_lf", 4), ("bench_4k", 8)):
        split = (ntile // 2, ntile // 2)
        check = clip == "bench_1080p_lf"
        for rank, (n, dev_ms, span, host, one) in segments_alone(
                torch, np, replay_inputs[clip], split, check).items():
            held = "; exact vs the plain version" if check and not rank \
                else ""
            say("mesh_mp", f"{clip} frame 0, rank {rank} of split "
                f"{'+'.join(map(str, split))} alone in this process (swaps "
                f"bring back what was sent{held}): "
                f"{int(n)} segment launches "
                f"{dev_ms:.3f} ms on the card (CUDA events around each), the "
                f"scan's span {span:.3f} ms (host wall {host:.3f}); one "
                f"launch of its stripes over the same steps {one:.3f} ms; on "
                f"{card}")
    probe = gloo_cuda_check()
    say("mesh_mp", f"gloo point-to-point on CUDA tensors (not gated): the "
        f"send {probe[0]}; the receive {probe[1]}")
    say("mesh_mp", f"nccl on the shared card refused: {refused}; phase "
        f"{time.perf_counter() - t0:.1f} s")


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, PKG)) or not all(
            os.path.exists(os.path.join(ROOT, "vectors", c + ".ivf"))
            for c in DECODE_CLIPS + PASSA_CLIPS + PASSA_INTER_CLIPS
            + (CHAINED_CLIP,) + tuple(r[0] for r in MESH_MP_RUNS)):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import ffmpeg_hybrid_tpu_torch  # noqa: F401  (sets matmul precision)
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("TF32 must be off for the exact intra product")
    from ffmpeg_hybrid_tpu_torch import _build, passa_native
    from ffmpeg_hybrid_tpu_torch.ops import rac

    card = card_line()
    say("card", f"{card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    native_err = []

    def build_native():
        try:
            passa_native.lib()
        except Exception as e:  # noqa: BLE001 - re-raised below
            native_err.append(e)

    th = threading.Thread(target=build_native)
    th.start()
    empty_build = start_empty_build()
    libs = _build.build_all()
    empty = load_empty(empty_build)
    th.join()
    if native_err:
        raise native_err[0]
    say("build", f"kernels and native pass A built in "
        f"{time.perf_counter() - t0:.1f} s: {sorted(libs.values())}")
    for src, path in libs.items():
        with open(path + ".log") as f:
            for line in f.read().splitlines():
                if "registers" in line or "spill" in line \
                        or "Compiling" in line:
                    say("build", f"{src}: {line.strip()}")

    clips = {c: read_clip(c) for c in DECODE_CLIPS}
    from ffmpeg_hybrid_tpu_torch.ops import lpf_dense, lpf_masks, recon
    lf_calls = capture_inputs(torch, [(lpf_dense, "lf_frame_"),
                                      (recon, "_intra_scan_planes"),
                                      (recon, "_grids_from_records"),
                                      (recon, "scatter_frame"),
                                      (recon, "residual_planes"),
                                      (lpf_masks, "grids_device")],
                              clips["bench_1080p_lf"][0][:1])
    res_calls = capture_inputs(torch, [(recon, "scatter_frame"),
                                       (recon, "residual_planes"),
                                       (recon, "mc_planes"),
                                       (recon, "_intra_scan_planes"),
                                       (recon, "_grids_from_records")],
                               clips["bench_1080p"][0][:3])
    k4_calls = capture_inputs(torch, [(recon, "_grids_from_records"),
                                      (lpf_masks, "grids_device")],
                              clips["bench_4k"][0][:2])
    fmt_calls = {c: capture_inputs(torch, [(recon, "scatter_frame"),
                                           (recon, "residual_planes"),
                                           (recon, "_intra_scan_planes"),
                                           (recon, "_grids_from_records"),
                                           (lpf_masks, "grids_device"),
                                           (lpf_dense, "lf_frame_")],
                                   clips[c][0][:1])
                 for c in FORMAT_CLIPS}
    rs_calls = capture_inputs(torch, [(recon, "mc_planes_scaled")],
                              clips[RESIZE_CLIP][0])
    intra_calls = {"bench_1080p_lf": lf_calls["_intra_scan_planes"][0],
                   "bench_1080p": res_calls["_intra_scan_planes"][0]}
    splat_calls = {"bench_1080p": res_calls["_grids_from_records"][:2],
                   "bench_1080p_lf": lf_calls["_grids_from_records"]}
    scatter_calls = {"bench_1080p": res_calls["scatter_frame"][:2],
                     "bench_1080p_lf": lf_calls["scatter_frame"]}
    residual_calls = {"bench_1080p": res_calls["residual_planes"][:2],
                      "bench_1080p_lf": lf_calls["residual_planes"]}
    if len(lf_calls["grids_device"]) != 1 \
            or len(k4_calls["grids_device"]) != 1:
        raise RuntimeError("the first frames of bench_1080p_lf and bench_4k "
                           "ran other than one grids call each")
    by_name = {k["name"]: k for k in (
        stream_phase(rac, torch, np, "bits"),
        stream_phase(rac, torch, np, "tree"),
        coef_phase(rac, torch, np, clips["bench_1080p"][0][0]),
        lpf_phase(torch, np, lf_calls["lf_frame_"]),
        *residual_phase(torch, np, scatter_calls, residual_calls),
        residual_hbd_phase(
            torch, np, {c: fmt_calls[c]["scatter_frame"] for c in HBD_CLIPS},
            {c: fmt_calls[c]["residual_planes"] for c in HBD_CLIPS}),
        mc_phase(torch, np, res_calls["mc_planes"]),
        mc_scaled_phase(torch, np, rs_calls["mc_planes_scaled"]),
        intra_phase(torch, np, intra_calls),
        splat_phase(torch, np, splat_calls,
                    k4_calls["_grids_from_records"][1]),
        lf_grids_phase(torch, np, lf_calls["grids_device"][0],
                       k4_calls["grids_device"][0]))}
    formats_phase(torch, np, fmt_calls)
    # the launch floor, after the kernel phases: profiled before them, the
    # empty kernel made every later profile miss some device records of
    # the port's kernels (0.86 ops a call where 1 ran)
    floor_ms = launch_floor_ms(torch, empty)
    say("kernels", f"launch floor: an empty kernel (one warp) takes "
        f"{floor_ms:.5f} ms on the card's clock (device_ms, 50 launches); "
        + ", ".join(f"{n} {by_name[n]['ms'] / floor_ms:.1f} floors"
                    for n in ("grids_device", "_grids_from_records")))
    for n in ("grids_device", "_grids_from_records"):
        by_name[n]["launch_floor_ms"] = floor_ms
    del lf_calls, res_calls, intra_calls, splat_calls, scatter_calls, \
        residual_calls, k4_calls, fmt_calls, rs_calls
    main_path = {"lf_dense": "lf_dense", "residual_planes": "residual",
                 "residual_planes_hbd": "residual_hbd",
                 "scatter_coef": "scatter", "mc_planes": "mc",
                 "mc_planes_scaled": "mc_scaled",
                 "_intra_scan_planes": "intra",
                 "_grids_from_records": "splat", "grids_device": "lf_grids"}
    clip_launches, clip_fps, digests = {}, {}, {}
    for name in DECODE_CLIPS:
        frames, want = clips[name]
        # the format clips' passes are two or four frames each, the resize
        # clip's six: three timed ones
        windows = WINDOWS if name in CLIPS else 3
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (fps, fps_runs, stages, launches, intra_frames, inter_frames,
         host, kept) = decode_phase(torch, np, name, frames, want, windows,
                                    digests)
        clip_launches[name], clip_fps[name] = launches, fps
        peak = torch.cuda.max_memory_allocated()
        busy = ""
        if name == RESIZE_CLIP:
            share, ops = busy_share(torch, frames)
            busy = (f"; a serial decode under torch.profiler: the card busy "
                    f"{100 * share:.2f}% of the wall time, {ops:.2f} device "
                    "ops a frame")
        for key in ("lf_dense", "lf_grids"):
            if launches[key] != LF_LAUNCHES[name]:
                raise RuntimeError(f"{name}: {key} launched {launches[key]}"
                                   f" times, expected {LF_LAUNCHES[name]}")
        # one residual launch a frame: the high-bit-depth one on the
        # 10/12-bit clips, the 8-bit one elsewhere
        hbd = name in HBD_ALL
        for key, n in (("splat", len(want)), ("scatter", len(want)),
                       ("residual", 0 if hbd else len(want)),
                       ("residual_hbd", len(want) if hbd else 0)):
            if launches[key] != n:
                raise RuntimeError(f"{name}: the {key} kernel launched "
                                   f"{launches[key]} times for {len(want)} "
                                   f"frames, expected {n}")
        # every inter frame of the resize clip has a reference of another
        # size: the scaled kernel once each, the unscaled one never; on the
        # other clips the reverse
        mc_want = (0, inter_frames) if name == RESIZE_CLIP \
            else (inter_frames, 0)
        if (launches["mc"], launches["mc_scaled"]) != mc_want or (
                inter_frames == 0) != (name == "bench_1080p_lf"
                                       or name in FORMAT_CLIPS):
            raise RuntimeError(f"{name}: the MC kernels launched "
                               f"{launches['mc']} (unscaled) and "
                               f"{launches['mc_scaled']} (scaled) times for "
                               f"{inter_frames} frames with inter blocks")
        if name == RESIZE_CLIP and kept != (3, 3):
            raise RuntimeError(f"{name}: {kept[0]} kept coefficient buffer "
                               f"sets and {kept[1]} splat states for its "
                               "three frame sizes")
        if not 0 < intra_frames == launches["intra"]:
            raise RuntimeError(f"{name}: the intra kernel launched "
                               f"{launches['intra']} times for "
                               f"{intra_frames} frames with intra blocks")
        for kname, key in main_path.items():
            k = by_name[kname]
            k["launches"] = (k["launches"] or 0) + launches[key]
            k.setdefault("launches_by_clip", {})[name] = launches[key]
        by_name["_intra_scan_planes"].setdefault(
            "frames_with_intra_by_clip", {})[name] = intra_frames
        med = sorted(range(windows), key=fps_runs.__getitem__)[windows // 2]
        top = sorted(((v, k) for k, v in stages.items()
                      if k.startswith(("recon.", "upload.", "intra."))),
                     reverse=True)[:5]
        say("decode", f"{name}: median {fps:.3f} fps (min "
            f"{min(fps_runs):.3f}, max {max(fps_runs):.3f}; its pass's host "
            f"pass A {host[med][0]:.3f}, pass B {host[med][1]:.3f} ms/frame)"
            f" on {card}; largest pass-B stages (ms/frame): "
            + ", ".join(f"{k} {v}" for v, k in top)
            + f"; peak device memory over the clip's passes {peak} B"
            + busy)
    by_name["plane_digest"] = digest_entry(torch, np, digests)
    del digests

    by_name["passa_walk"] = passa_phase(torch, np, clips)
    two_decoders_phase(torch, clips)
    gop_phase(torch, clips)
    by_name["lf_replay"], replay_inputs = sharded_phase(torch, np, clips,
                                                        by_name["lf_dense"])
    del clips
    gop_pipeline_phase(torch, np, by_name)
    mesh_mp_phase(torch, np, by_name, replay_inputs)
    cli_phase(torch, clip_launches, clip_fps["bench_1080p"])

    print(json.dumps({"kernels": list(by_name.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
