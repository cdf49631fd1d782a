// The VP9 loop filter's per-lane arithmetic, shared by csrc/lpf.cu (the
// superblock-wavefront filter of the main path) and csrc/lpf_replay.cu
// (the record replay of the tile-sharded pass B), which must stay
// bit-exact with each other and with the reference.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Filter one lane of 16 samples across the edge between x[7] | x[8]
// (reference: loop_filter, vp9dsp_template.c:1780-1889). wd > 0.
// Rewrites x and returns the range written: 16 -> 1..14, 8 -> 5..10,
// 4 -> 6..9, 0 -> nothing.
__device__ __forceinline__ int filter_edge(int (&x)[16], int wd, int E,
                                           int I, int H, int bpp) {
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
    const bool flat8out =
        abs(x[0] - p0) <= F && abs(x[1] - p0) <= F &&
        abs(x[2] - p0) <= F && abs(x[3] - p0) <= F &&
        abs(x[12] - q0) <= F && abs(x[13] - q0) <= F &&
        abs(x[14] - q0) <= F && abs(x[15] - q0) <= F;
    if (flat8out) {
      // 15 taps with edge replication, sample k counted twice: a running
      // sum of x[clamp(k-7)] .. x[clamp(k+7)]
      int acc = 0;
#pragma unroll
      for (int t = -7; t <= 7; ++t) acc += x[clampi(1 + t, 0, 15)];
      int out[16];
#pragma unroll
      for (int k = 1; k < 15; ++k) {
        out[k] = (acc + x[k] + 8) >> 4;
        acc += x[clampi(k + 8, 0, 15)] - x[clampi(k - 7, 0, 15)];
      }
#pragma unroll
      for (int k = 1; k < 15; ++k) x[k] = out[k];
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

}  // namespace
