// VP9 loop filter for Hopper (sm_90a): the superblock-wavefront filter
// of one plane set, the CUDA counterpart of the JAX package's lf_dense
// (ffmpeg_hybrid_tpu/ops/lpf_dense.py:77-162, per-edge math
// filter_lanes_jnp, ops/lpf_tpu.py:22-111). That function is an XLA
// program, not a Pallas kernel; it is the loop filter of the main path.
//
//   lpf_frame  every wave of one plane set, one kernel launch per wave
//
// Semantics. The edges come as dense parameter grids: V edges at
// (py/8, px/4), H edges at (py/4, px/8), each (wd, E, I, H), wd in
// {0, 4, 8, 16} (ops/lpf_masks.py builds them). Within a superblock the
// reference filters V edges left to right, then H edges top to bottom
// (ff_vp9_loopfilter_sb, vp9lpf.c:183-230); 4px-offset edges chain
// (edge e writes e-2..e+1, edge e+4 reads from e), so that order is
// part of the result. Superblock (r, c) depends on (r, c-1), (r-1, c)
// and (r-1, c+1), so the superblocks of a wave of constant 2r + c are
// independent, and their windows (the superblock plus 8 px all round,
// the most any edge reads or writes) are disjoint.
//
// Design. One launch per wave; one thread block per superblock on the
// wave, filtering in place on the zero-padded plane(s) (8 px of zeros
// all round, allocated by the wrapper, so reads past the plane see the
// zeros lf_dense pads with).
//   V phase: one thread per (plane, pixel row) of the superblock. It
//     runs the superblock's V positions serially, left to right, each
//     on its own row's 16 samples across the edge. Rows are independent
//     across a vertical edge, so no thread waits on another.
//   __syncthreads()
//   H phase: one thread per (plane, pixel column), the H positions top
//     to bottom.
// Each edge writes only its filter's range: wd16 samples 1..14 of the
// 16, wd8 5..10, the narrow filter 6..9.
//
// What bounds it. The work is a dependency chain: waves in order, and
// within a superblock up to 16 serial V positions and then 16 serial H
// positions, each a global load of 16 samples, ~100 integer operations
// and a store. The bytes (each plane read and written once, plus the
// grids) and the operations are far below what the card moves and
// computes in that time, so the kernel is bound by latency: launches
// (one per wave) and each thread's chain of dependent loads. This first
// version does nothing about it beyond skipping positions with no edge
// (wd == 0); shared-memory windows and one launch per frame are later
// work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Filter one lane of 16 samples across the edge between x[7] | x[8]
// (reference: loop_filter, vp9dsp_template.c:1780-1889). wd > 0.
// Rewrites x and returns the range written: 16 -> 1..14, 8 -> 5..10,
// 4 -> 6..9, 0 -> nothing.
__device__ __forceinline__ int filter_edge(int (&x)[16], int wd, int E, int I,
                                           int H, int bpp) {
  const int sh = bpp - 8;
  const int F = 1 << sh;
  E <<= sh;
  I <<= sh;
  H <<= sh;
  const int p3 = x[4], p2 = x[5], p1 = x[6], p0 = x[7];
  const int q0 = x[8], q1 = x[9], q2 = x[10], q3 = x[11];
  const bool fm = abs(p3 - p2) <= I && abs(p2 - p1) <= I &&
                  abs(p1 - p0) <= I && abs(q1 - q0) <= I &&
                  abs(q2 - q1) <= I && abs(q3 - q2) <= I &&
                  abs(p0 - q0) * 2 + (abs(p1 - q1) >> 1) <= E;
  if (!fm) return 0;
  const bool flat8in = abs(p3 - p0) <= F && abs(p2 - p0) <= F &&
                       abs(p1 - p0) <= F && abs(q1 - q0) <= F &&
                       abs(q2 - q0) <= F && abs(q3 - q0) <= F;
  if (wd >= 16 && flat8in) {
    const bool flat8out = abs(x[0] - p0) <= F && abs(x[1] - p0) <= F &&
                          abs(x[2] - p0) <= F && abs(x[3] - p0) <= F &&
                          abs(x[12] - q0) <= F && abs(x[13] - q0) <= F &&
                          abs(x[14] - q0) <= F && abs(x[15] - q0) <= F;
    if (flat8out) {
      // 15 taps with edge replication, sample k counted twice
      int o[16];
#pragma unroll
      for (int k = 1; k < 15; ++k) {
        int acc = x[k] + 8;
#pragma unroll
        for (int t = -7; t <= 7; ++t) acc += x[clampi(k + t, 0, 15)];
        o[k] = acc >> 4;
      }
#pragma unroll
      for (int k = 1; k < 15; ++k) x[k] = o[k];
      return 16;
    }
  }
  if (wd >= 8 && flat8in) {
    x[5] = (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3;
    x[6] = (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3;
    x[7] = (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3;
    x[8] = (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3;
    x[9] = (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3;
    x[10] = (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3;
    return 8;
  }
  // narrow filter; >> on negative values is arithmetic, as in the
  // reference
  const int maxs = (1 << (bpp - 1)) - 1, mins = -(1 << (bpp - 1));
  const int maxp = (1 << bpp) - 1;
  const bool hev = abs(p1 - p0) > H || abs(q1 - q0) > H;
  if (hev) {
    const int f = clampi(3 * (q0 - p0) + clampi(p1 - q1, mins, maxs), mins,
                         maxs);
    const int f1 = min(f + 4, maxs) >> 3;
    const int f2 = min(f + 3, maxs) >> 3;
    x[7] = clampi(p0 + f2, 0, maxp);
    x[8] = clampi(q0 - f1, 0, maxp);
  } else {
    const int f = clampi(3 * (q0 - p0), mins, maxs);
    const int f1 = min(f + 4, maxs) >> 3;
    const int f2 = min(f + 3, maxs) >> 3;
    const int fo = (f1 + 1) >> 1;
    x[6] = clampi(p1 + fo, 0, maxp);
    x[7] = clampi(p0 + f2, 0, maxp);
    x[8] = clampi(q0 - f1, 0, maxp);
    x[9] = clampi(q1 - fo, 0, maxp);
  }
  return 4;
}

// Filter the edge whose 16 samples start at s, `stride` apart, with
// the parameters g = (wd, E, I, H).
__device__ __forceinline__ void filter_at(int32_t* s, size_t stride,
                                          const int32_t* g, int bpp) {
  const int wd = g[0];
  if (wd <= 0) return;
  int x[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) x[k] = s[k * stride];
  const int cls = filter_edge(x, wd, g[1], g[2], g[3], bpp);
  if (cls == 16) {
#pragma unroll
    for (int k = 1; k < 15; ++k) s[k * stride] = x[k];
  } else if (cls == 8) {
#pragma unroll
    for (int k = 5; k < 11; ++k) s[k * stride] = x[k];
  } else if (cls == 4) {
#pragma unroll
    for (int k = 6; k < 10; ++k) s[k * stride] = x[k];
  }
}

// One wave: block i filters superblock (r0 + i, w - 2 (r0 + i)).
// pad: [B, PH, PW] int32, the planes with 8 px of zeros all round.
// vg: [Hp/8, vgw, 4], hg: [Hp/4, hgw, 4] int32.
__global__ void lpf_wave_kernel(int32_t* pad, int B, int PH, int PW,
                                const int32_t* vg, int vgw,
                                const int32_t* hg, int hgw, int sbwx,
                                int sbwy, int bpp, int w, int r0) {
  const int r = r0 + blockIdx.x;
  const int c = w - 2 * r;
  const int tid = threadIdx.x;
  const int y0 = 8 + r * sbwy;  // superblock origin in padded coords
  const int x0 = 8 + c * sbwx;
  const int npos_v = sbwx >> 2, npos_h = sbwy >> 2;

  // V phase: thread = (plane, row), positions left to right
  if (tid < B * sbwy) {
    const int b = tid / sbwy, y = tid % sbwy;
    int32_t* s = pad + ((size_t)b * PH + y0 + y) * PW + x0 - 8;
    const int32_t* g =
        vg + ((size_t)((r * sbwy + y) >> 3) * vgw + (size_t)c * npos_v) * 4;
    for (int t = 0; t < npos_v; ++t) filter_at(s + 4 * t, 1, g + 4 * t, bpp);
  }
  __syncthreads();
  // H phase: thread = (plane, column), positions top to bottom
  if (tid < B * sbwx) {
    const int b = tid / sbwx, xx = tid % sbwx;
    int32_t* s = pad + ((size_t)b * PH + y0 - 8) * PW + x0 + xx;
    const int32_t* g = hg + ((size_t)r * npos_h * hgw +
                             (size_t)c * (sbwx >> 3) + (xx >> 3)) * 4;
    for (int t = 0; t < npos_h; ++t)
      filter_at(s + (size_t)4 * t * PW, PW, g + (size_t)t * hgw * 4, bpp);
  }
}

}  // namespace

extern "C" {

// Loop-filter one plane set in place: pad [B, PH, PW] int32 holds the B
// planes of sb_rows x sb_cols superblocks of sbwx x sbwy samples at
// offset (8, 8), zeros around. Launches one kernel per non-empty wave
// on `stream` and stores their number in *launches.
int lpf_frame(int32_t* pad, int B, int PH, int PW, const int32_t* vg,
              int vgw, const int32_t* hg, int hgw, int sb_rows, int sb_cols,
              int sbwx, int sbwy, int bpp, int* launches,
              cudaStream_t stream) {
  *launches = 0;
  const int threads = B * (sbwx > sbwy ? sbwx : sbwy);
  if (threads < 1 || threads > 1024 || PH != sb_rows * sbwy + 16 ||
      PW != sb_cols * sbwx + 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nwaves = 2 * (sb_rows - 1) + sb_cols;
  for (int w = 0; w < nwaves; ++w) {
    // the rows r with 0 <= w - 2r < sb_cols
    int r_lo = (w - sb_cols + 2) / 2;
    if (r_lo < 0) r_lo = 0;
    const int r_hi = w / 2 < sb_rows - 1 ? w / 2 : sb_rows - 1;
    if (r_hi < r_lo) continue;
    lpf_wave_kernel<<<r_hi - r_lo + 1, threads, 0, stream>>>(
        pad, B, PH, PW, vg, vgw, hg, hgw, sbwx, sbwy, bpp, w, r_lo);
    ++*launches;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
