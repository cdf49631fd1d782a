// VP9 loop filter by record replay for Hopper (sm_90a): the recorded edge
// calls of a frame replayed step by step over the tile-column stripes of
// a plane set, with the stripes' halos exchanged after every step. The
// CUDA counterpart of the JAX package's _lf_scan (ffmpeg_hybrid_tpu/ops/
// lpf_tpu.py:115-162) with the sharded scan of its parallel/fullframe.py
// (_lf_apply_step, :163-200, and _lf_scan_sharded, :201-243). Those are
// XLA programs (a lax.scan under shard_map, halos over ppermute), not
// Pallas kernels. The port's plain versions are ops/lpf_replay.py's
// lf_scan_plain and lf_scan_sharded_plain.
//
//   lf_replay       T stripes (1-8) of a plane set, in place, one launch
//   lf_replay_from  the same, steps [first, run) alone: a segment of a
//                   replay whose stripes are split across processes
//
// Semantics. planes: [T, B, H, Wb] int32, B = 1 (Y) or 2 (U and V: the
// chroma records apply to both). steps: [T, S, D, 7] int32 records (py,
// px, dir, wd, E, I, H) of each stripe, in its buffer's coordinates; wd 0
// is a no-op. Step s of every stripe runs before step s + 1 of any. A
// record filters 8 lanes of 16 samples across its edge: dir 0 rows py..
// py+7, columns px-8..px+7; dir 1 columns px..px+7, rows py-8..py+7.
// Reads clamp to the buffer; the filter's written range (1..14, 5..10 or
// 6..9) is stored where it lies inside the buffer.
// With halo set (T > 1), columns 0..7 of stripe t > 0 mirror columns
// wreal[t-1] .. wreal[t-1]+7 of stripe t-1 (its last 8 real columns,
// its tail): first the halo takes a copy of the tail, then every store
// into a tail or a halo also goes to its mirror. The records of one step
// never touch the same pixel from two stripes (the wavefront's
// disjointness, fullframe.py's header), so the mirror of a pixel a step
// stored holds what the JAX merge gives: the side that changed it wins
// (:224-238), and where neither did both sides hold the old value.
//
// Design. One thread block a stripe, the stripes of the launch in one
// thread-block cluster (T <= 8, the portable size); a thread a (plane,
// record, lane) of a step, its 16 samples in registers, loaded and
// stored through L2 (ld/st.cg: a neighbouring block writes the mirrors);
// the cluster's barrier (release/acquire) between steps, and a block
// barrier when T is 1 (the serial _lf_scan). The host trims the
// bucket's trailing no-op steps (`run`).
//
// Segments. When a frame's stripes are split across processes (parallel/
// dist.py), each process replays its own run of stripes in segments, one
// launch each, and swaps the columns on its boundary with the other
// process's between them (ops/lpf_replay.py, lf_scan_sharded_dist). A
// launch from a later step (first > 0) continues a replay whose halos
// already mirror their tails, and makes no copy. The first and last
// stripe of a launch have no neighbour in it (has_left and has_right
// follow the launch's own T): the columns on a process boundary are not
// mirrored here.
//
// What bounds it. The work is small: the frame's planes read and
// written once, halos and padding not counted, and each record read once
// (1080p frame 0 of bench_1080p_lf: 18,936 Y and 7,646 U+V records, 25.8
// MB, 7.7 us at 3.35 TB/s), and ~100 integer operations a lane. It is a chain: 3,387 Y and 1,660 U+V steps there,
// each a record load, a window load, the stores and a barrier, several
// L2 round trips a step. The design keeps a step to one barrier and no
// exchange pass (the mirrors are stored with the pixels).
#include <cstdint>
#include <cuda_runtime.h>

#include "lpf_filter.cuh"

namespace {

constexpr int kHalo = 8;
constexpr int kMaxStripes = 8;
constexpr int kThreads = 512;

struct Args {
  int32_t* pl;          // [T, B, H, Wb]
  const int32_t* steps;  // [T, S, D, 7]
  int wreal[kMaxStripes];
  int T, B, H, Wb, S, D, first, run, halo, bpp;
};

// Every thread of the launch's stripes: the cluster's barrier when there
// are several (release/acquire orders the stores of every block of the
// cluster before the loads after it), the block's alone when one.
__device__ __forceinline__ void step_barrier(int T) {
  if (T > 1) {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  } else {
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) lf_replay_kernel(const Args a) {
  const int t = blockIdx.x;
  const size_t plane = static_cast<size_t>(a.H) * a.Wb;
  const size_t set = plane * a.B;
  int32_t* own = a.pl + set * t;
  const bool has_left = a.halo && t > 0;
  const bool has_right = a.halo && t < a.T - 1;
  const int wr = a.wreal[t];
  const int wl = has_left ? a.wreal[t - 1] : 0;
  // the halo takes a copy of the left neighbour's tail
  if (has_left && a.first == 0) {
    const int32_t* left = own - set;
    for (int i = threadIdx.x; i < a.B * a.H * kHalo; i += blockDim.x) {
      const size_t row = static_cast<size_t>(i / kHalo) * a.Wb;
      const int c = i % kHalo;
      __stcg(own + row + c, __ldcg(left + row + wl + c));
    }
  }
  step_barrier(a.T);
  const int items = a.B * a.D * 8;
  const int32_t* recs = a.steps +
                        (static_cast<size_t>(t) * a.S + a.first) * a.D * 7;
  for (int s = a.first; s < a.run; ++s, recs += a.D * 7) {
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      const int lane = i & 7;
      const int d = (i >> 3) % a.D;
      const int b = (i >> 3) / a.D;
      const int32_t* r = recs + d * 7;
      const int wd = __ldg(r + 3);
      if (wd <= 0) continue;
      const int py = __ldg(r), px = __ldg(r + 1), dir = __ldg(r + 2);
      int32_t* p = own + plane * b;
      // sample j of the lane at (row0 + j * dr, col0 + j * dc)
      const int row0 = dir == 0 ? py + lane : py - 8;
      const int col0 = dir == 0 ? px - 8 : px + lane;
      const int dr = dir == 0 ? 0 : 1, dc = 1 - dr;
      int x[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        x[j] = __ldcg(p + static_cast<size_t>(clampi(row0 + j * dr, 0,
                                                     a.H - 1)) * a.Wb +
                      clampi(col0 + j * dc, 0, a.Wb - 1));
      const int cls = filter_edge(x, wd, __ldg(r + 4), __ldg(r + 5),
                                  __ldg(r + 6), a.bpp);
      const int lo = cls == 16 ? 1 : cls == 8 ? 5 : 6;
      const int hi = cls == 16 ? 15 : cls == 8 ? 11 : cls == 4 ? 10 : 0;
#pragma unroll
      for (int j = 1; j < 15; ++j) {
        if (j < lo || j >= hi) continue;
        const int y = row0 + j * dr, c = col0 + j * dc;
        if (y < 0 || y >= a.H || c < 0 || c >= a.Wb) continue;
        const size_t at = static_cast<size_t>(y) * a.Wb;
        __stcg(p + at + c, x[j]);
        // the mirror of a tail or a halo column
        if (has_right && c >= wr && c < wr + kHalo)
          __stcg(p + set + at + (c - wr), x[j]);
        if (has_left && c < kHalo) __stcg(p - set + at + wl + c, x[j]);
      }
    }
    step_barrier(a.T);
  }
}

}  // namespace

extern "C" {

// Replay steps first .. run - 1 of steps ([T, S, D, 7] int32) over planes
// ([T, B, H, Wb] int32, in place) on `stream`: one launch, a block of
// kThreads a stripe, the T (1-8) blocks in one cluster. wreal: T ints on
// the host, each stripe's real width (its tail at columns wreal ..
// wreal + 7); halo: whether the stripes exchange halos (T > 1); the halos
// take their copies only when first is 0. bpp: 8-12.
int lf_replay_from(int32_t* planes, const int32_t* steps, const int* wreal,
                   int T, int B, int H, int Wb, int S, int D, int first,
                   int run, int halo, int bpp, cudaStream_t stream) {
  if (!planes || !steps || !wreal || T < 1 || T > kMaxStripes || B < 1 ||
      B > 2 || H < 1 || Wb < 1 || S < 0 || D < 1 || first < 0 ||
      run < first || run > S || bpp < 8 || bpp > 12 || (halo && T < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.pl = planes;
  a.steps = steps;
  for (int t = 0; t < T; ++t) {
    a.wreal[t] = wreal[t];
    if (halo && (wreal[t] < kHalo || wreal[t] + kHalo > Wb))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  a.T = T;
  a.B = B;
  a.H = H;
  a.Wb = Wb;
  a.S = S;
  a.D = D;
  a.first = first;
  a.run = run;
  a.halo = halo != 0;
  a.bpp = bpp;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(T);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = T;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = T > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, lf_replay_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The whole replay: lf_replay_from with first 0.
int lf_replay(int32_t* planes, const int32_t* steps, const int* wreal, int T,
              int B, int H, int Wb, int S, int D, int run, int halo, int bpp,
              cudaStream_t stream) {
  return lf_replay_from(planes, steps, wreal, T, B, H, Wb, S, D, 0, run, halo,
                        bpp, stream);
}

}  // extern "C"
