// VP9 loop filter for Hopper (sm_90a): the superblock-wavefront filter
// of a frame's plane sets (Y, and U+V), the CUDA counterpart of the JAX
// package's lf_dense (ffmpeg_hybrid_tpu/ops/lpf_dense.py:77-162, per-edge
// math filter_lanes_jnp, ops/lpf_tpu.py:22-111). That function is an XLA
// program, not a Pallas kernel; it is the loop filter of the main path.
//
//   lpf_frame  one or two plane sets, in place, one launch
//
// Semantics. The edges come as dense parameter grids: V edges at
// (py/8, px/4), H edges at (py/4, px/8), each (wd, E, I, H), wd in
// {0, 4, 8, 16} (ops/lpf_masks.py builds them). Within a superblock (SB)
// the reference filters V edges left to right, then H edges top to
// bottom (ff_vp9_loopfilter_sb, vp9lpf.c:183-230); 4px-offset edges chain
// (edge e writes e-2..e+1, edge e+4 reads from e), so that order is part
// of the result. An edge reads 8 samples and writes at most 7 on either
// side, so SB (r, c) reads and writes inside its window, the SB plus 8 px
// all round, and writes only rows y0-7 .. y0+sbwy+2 and columns
// x0-7 .. x0+sbwx+2 of it. Samples outside the plane read as zero (the
// zeros lf_dense pads with) and are never written: each one is touched by
// one SB only, so no other SB could read what it would hold.
//
// Dataflow. SB (r, c) waits for (r, c-1) and for (r-1, c+1), or for
// (r-1, c) in the last column. Every SB whose window overlaps (r, c)'s
// (its 8 neighbours) is ordered with it through these edges, so any order
// that keeps them gives the wavefront's result. The host builds the order
// once per geometry (ops/lpf_dense.py schedule): tickets wave by wave
// (2r + c), the plane sets interleaved, each with its SB's flag and the
// flags it waits for. A persistent grid takes tickets from an atomic
// counter; a ticket is only held by a running block and waits only on
// earlier tickets, so the launch cannot deadlock whatever the residency.
// Per ticket, one block:
//   1. loads the SB's V and H parameters into shared memory and ORs
//      their widths (none active: nothing is loaded or written);
//   2. waits for the flags it depends on (ld.acquire.gpu, then a block
//      barrier) to hold this launch's epoch, which the wrapper passes
//      anew each call, so the flags need no reset;
//   3. loads the window through L2 (a neighbour on another SM wrote it),
//      kLoadBatch int4 a thread in flight at once, into shared memory
//      with an odd row stride;
//   4. V phase: a thread per (plane, row) runs the SB's V positions left
//      to right in shared memory; H phase: a thread per (plane, column),
//      top to bottom;
//   5. writes back rows y0-8 .. y0+sbwy+3 and columns x0-8 .. x0+sbwx+3,
//      the part of the window its edges can change, inside the plane;
//   6. publishes its flag after fence.acq_rel.gpu, which releases the
//      whole block's write-back.
// The last block to finish resets the ticket counter for the next launch.
// tools/lpf_ab_torch.py times the constants below. Two designs lost to
// this one on bench_1080p_lf frame 0 and were taken out: a grid-wide
// barrier per wave in place of the flags (cooperative launch; 0.65-0.71
// ms against 0.52 at the time) and each thread's line of the window held
// in registers with its positions unrolled (0.39 ms against 0.36-0.37,
// though 7% faster on a frame with every edge active).
//
// What bounds it. The bytes the function needs (each plane read and
// written once, the grids read once: 27.7 MB a 1080p frame, 8.3 us at
// 3.35 TB/s) and its operations are far below what it takes. It is a
// chain: 2 (sb_rows - 1) + sb_cols waves (62 at 1080p), and per SB three
// L2 round trips (the flag, the window, the write-back before the
// release) and up to 16 serial V and then 16 serial H positions of ~100
// integer operations each. What the design buys is that a position costs
// shared memory instead of a global round trip, and that the frame is
// one launch: about 62 x the latency of one SB, some 6 us a wave on an
// H100 at 700 W, of which ~3.5 us do not depend on the positions
// (chip_smoke.py reports us per wave, each set alone).
#include <cstdint>
#include <cuda_runtime.h>

#include "lpf_filter.cuh"

namespace {

// blocks per SM of the persistent grid
constexpr int kBlocksPerSM = 2;
// threads per block; the filter phases use B x span of them
constexpr int kThreads = 256;
// window loads each thread has in flight at once
constexpr int kLoadBatch = 8;

constexpr int kMaxSets = 2;
// int4 parameters of one phase of the largest SB: (64 / 8) x (64 / 4)
constexpr int kMaxPar = 128;

struct Set {
  int32_t* p0;  // the set's planes, [H, W] int32 each (p1 NULL when B = 1)
  int32_t* p1;
  const int4* vg;  // [H/8, W/4] (wd, E, I, H)
  const int4* hg;  // [H/4, W/8]
  int B, H, W, sbwx, sbwy;
};

struct Launch {
  Set set[kMaxSets];
  // per ticket two int4: (set, r, c, own flag), (dep0, dep1, wave, 0)
  const int4* sched;
  int T;
  int* flags;     // per (set, r, c): the epoch its filter last completed
  unsigned* ctr;  // ticket, blocks done
  int epoch, bpp;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Publish v at p after every write that happened before it, this
// block's other threads' included when they precede a __syncthreads()
// (the fence releases them too; CUTLASS's barriers use this pattern).
__device__ __forceinline__ void release(int* p, int v) {
  asm volatile("fence.acq_rel.gpu;\n\tst.relaxed.gpu.global.s32 [%0], %1;"
               ::"l"(p), "r"(v)
               : "memory");
}

// The serial positions of one line of the window: N samples `stride`
// apart from s (shared memory), an edge every 4 samples from sample 8 on,
// position t with the parameters par[t * pstride]. Each active position
// reads its 16 samples and writes back the range its filter changed.
template <int N>
__device__ __noinline__ void filter_line(int32_t* s, int stride,
                                         const int4* par, int pstride,
                                         int bpp) {
  for (int t = 0; t < (N - 16) / 4; ++t) {
    const int4 g = par[t * pstride];
    if (g.x <= 0) continue;
    int32_t* e = s + 4 * t * stride;
    int x[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) x[k] = e[k * stride];
    const int cls = filter_edge(x, g.x, g.y, g.z, g.w, bpp);
    const int lo = cls == 16 ? 1 : cls == 8 ? 5 : 6;
    const int hi = cls == 16 ? 15 : cls == 8 ? 11 : cls == 4 ? 10 : 0;
#pragma unroll
    for (int k = 1; k < 15; ++k)
      if (k >= lo && k < hi) e[k * stride] = x[k];
  }
}

// One SB of sbwx x sbwy samples per plane: steps 1-6 of the header.
template <int SBWX, int SBWY>
__device__ __forceinline__ void filter_sb(const Launch& a, const Set& s,
                                          int4 e0, int4 e1, int32_t* smem) {
  constexpr int NPV = SBWX / 4, NBV = SBWY / 8;  // V positions, row bands
  constexpr int NPH = SBWY / 4, NBH = SBWX / 8;  // H positions, col bands
  constexpr int WX = SBWX + 16, WY = SBWY + 16;  // the window
  constexpr int S = WX + 1;                      // its row stride
  constexpr int Q = WX / 4;                      // int4 per window row
  constexpr int BX = (SBWX + 12) / 4, BY = SBWY + 12;  // write-back box
  const int tid = threadIdx.x;
  const int r = e0.y, c = e0.z, B = s.B;
  const int y0 = r * SBWY, x0 = c * SBWX;
  int4* vp = reinterpret_cast<int4*>(smem);  // [NBV][NPV]
  int4* hp = vp + kMaxPar;                   // [NPH][NBH]
  int32_t* win = smem + 8 * kMaxPar;         // [B][WY][S]

  // 1. parameters: they depend on no other SB
  int act = 0;
  for (int i = tid; i < NBV * NPV; i += kThreads) {
    const int4 g = __ldg(s.vg + (size_t)(r * NBV + i / NPV) * (s.W >> 2) +
                         c * NPV + i % NPV);
    vp[i] = g;
    act |= g.x > 0;
  }
  for (int i = tid; i < NPH * NBH; i += kThreads) {
    const int4 g = __ldg(s.hg + (size_t)(r * NPH + i / NBH) * (s.W >> 3) +
                         c * NBH + i % NBH);
    hp[i] = g;
    act |= g.x > 0;
  }
  // 2. dependencies
  if (tid < 2) {
    const int dep = tid ? e1.y : e1.x;
    if (dep >= 0) {
      while (ld_acquire(a.flags + dep) != a.epoch) {
      }
    }
  }
  if (__syncthreads_or(act)) {
    // 3. the window, zeros outside the plane: kLoadBatch loads in
    // flight per thread before the first lands in shared memory
    const int n = B * WY * Q;
    for (int i0 = tid; i0 < n; i0 += kLoadBatch * kThreads) {
      int4 v[kLoadBatch];
#pragma unroll
      for (int k = 0; k < kLoadBatch; ++k) {
        const int i = i0 + k * kThreads;
        const int b = i / (WY * Q), yy = i / Q % WY, q = i % Q;
        const int gy = y0 - 8 + yy, gx = x0 - 8 + 4 * q;
        v[k] = make_int4(0, 0, 0, 0);
        if (i < n && gy >= 0 && gy < s.H && gx >= 0 && gx < s.W)
          v[k] = __ldcg(reinterpret_cast<const int4*>(
              (b ? s.p1 : s.p0) + (size_t)gy * s.W + gx));
      }
#pragma unroll
      for (int k = 0; k < kLoadBatch; ++k) {
        const int i = i0 + k * kThreads;
        if (i < n) {
          const int b = i / (WY * Q), yy = i / Q % WY, q = i % Q;
          int32_t* d = win + (b * WY + yy) * S + 4 * q;
          d[0] = v[k].x;
          d[1] = v[k].y;
          d[2] = v[k].z;
          d[3] = v[k].w;
        }
      }
    }
    __syncthreads();
    // 4. V positions per (plane, row), then H positions per (plane, col)
    if (tid < B * SBWY) {
      const int b = tid / SBWY, y = tid % SBWY;
      filter_line<WX>(win + (b * WY + 8 + y) * S, 1, vp + (y >> 3) * NPV, 1,
                      a.bpp);
    }
    __syncthreads();
    if (tid < B * SBWX) {
      const int b = tid / SBWX, xx = tid % SBWX;
      filter_line<WY>(win + b * WY * S + 8 + xx, S, hp + (xx >> 3), NBH,
                      a.bpp);
    }
    __syncthreads();
    // 5. write-back of what the edges can change, inside the plane
    for (int i = tid; i < B * BY * BX; i += kThreads) {
      const int b = i / (BY * BX), yy = i / BX % BY, q = i % BX;
      const int gy = y0 - 8 + yy, gx = x0 - 8 + 4 * q;
      if (gy >= 0 && gy < s.H && gx >= 0 && gx < s.W) {
        const int32_t* w = win + (b * WY + yy) * S + 4 * q;
        __stcg(reinterpret_cast<int4*>((b ? s.p1 : s.p0) +
                                       (size_t)gy * s.W + gx),
               make_int4(w[0], w[1], w[2], w[3]));
      }
    }
  }
  // 6. publish (and free the shared memory for the next ticket)
  __syncthreads();
  if (tid == 0) release(a.flags + e0.w, a.epoch);
}

__device__ __forceinline__ void run_ticket(const Launch& a, int t,
                                           int32_t* smem) {
  const int4 e0 = __ldg(a.sched + 2 * t), e1 = __ldg(a.sched + 2 * t + 1);
  const Set s = e0.x ? a.set[1] : a.set[0];
  if (s.sbwx == 64) {
    if (s.sbwy == 64)
      filter_sb<64, 64>(a, s, e0, e1, smem);
    else
      filter_sb<64, 32>(a, s, e0, e1, smem);
  } else {
    if (s.sbwy == 64)
      filter_sb<32, 64>(a, s, e0, e1, smem);
    else
      filter_sb<32, 32>(a, s, e0, e1, smem);
  }
}

__global__ void __launch_bounds__(kThreads) lpf_kernel(const Launch a) {
  extern __shared__ int4 smem4[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  __shared__ int s_ticket;
  for (;;) {
    if (threadIdx.x == 0) s_ticket = static_cast<int>(atomicAdd(a.ctr, 1u));
    __syncthreads();
    const int t = s_ticket;
    if (t >= a.T) break;
    run_ticket(a, t, smem);  // ends with a barrier
  }
  // every block has taken its last ticket: reset for the next launch
  if (threadIdx.x == 0 && atomicAdd(a.ctr + 1, 1u) == gridDim.x - 1) {
    a.ctr[0] = 0;
    a.ctr[1] = 0;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Loop-filter nsets (1 or 2) plane sets of sb_rows x sb_cols SBs in
// place, one launch on `stream`. Set j: planes p<j>0, p<j>1 (NULL when
// B = 1), each [sb_rows * sbwy, sb_cols * sbwx] int32, and its grids;
// dims[3j..3j+2] = B, sbwx, sbwy (32 or 64 each). sched: the ticket table
// of ops/lpf_dense.py schedule, [ntickets][8]; state: ntickets flags then
// 2 counters, zero before the first call; epoch: larger than any flag
// holds (the wrapper counts calls).
int lpf_frame(int32_t* p00, int32_t* p01, const int32_t* vg0,
              const int32_t* hg0, int32_t* p10, int32_t* p11,
              const int32_t* vg1, const int32_t* hg1, int nsets,
              const int* dims, int sb_rows, int sb_cols, const int32_t* sched,
              int ntickets, int32_t* state, int epoch, int bpp,
              cudaStream_t stream) {
  if (nsets < 1 || nsets > kMaxSets || sb_rows < 1 || sb_cols < 1 ||
      ntickets != nsets * sb_rows * sb_cols || epoch < 1 || bpp < 8 ||
      bpp > 12 || !aligned16(sched) || !state)
    return static_cast<int>(cudaErrorInvalidValue);
  int32_t* planes[kMaxSets][2] = {{p00, p01}, {p10, p11}};
  const int32_t* vgs[kMaxSets] = {vg0, vg1};
  const int32_t* hgs[kMaxSets] = {hg0, hg1};
  Launch a{};
  int win_bytes = 0;
  for (int j = 0; j < nsets; ++j) {
    const int B = dims[3 * j], sbwx = dims[3 * j + 1], sbwy = dims[3 * j + 2];
    const int span = sbwx > sbwy ? sbwx : sbwy;
    if (B < 1 || B > 2 || (sbwx != 32 && sbwx != 64) ||
        (sbwy != 32 && sbwy != 64) || B * span > kThreads ||
        !planes[j][0] || !aligned16(planes[j][0]) ||
        (B == 2 && (!planes[j][1] || !aligned16(planes[j][1]))) ||
        !vgs[j] || !aligned16(vgs[j]) || !hgs[j] || !aligned16(hgs[j]))
      return static_cast<int>(cudaErrorInvalidValue);
    a.set[j] = Set{planes[j][0], B == 2 ? planes[j][1] : nullptr,
                   reinterpret_cast<const int4*>(vgs[j]),
                   reinterpret_cast<const int4*>(hgs[j]), B,
                   sb_rows * sbwy, sb_cols * sbwx, sbwx, sbwy};
    const int bytes = B * (sbwy + 16) * (sbwx + 17) * 4;
    win_bytes = bytes > win_bytes ? bytes : win_bytes;
  }
  a.sched = reinterpret_cast<const int4*>(sched);
  a.T = ntickets;
  a.flags = state;
  a.ctr = reinterpret_cast<unsigned*>(state + ntickets);
  a.epoch = epoch;
  a.bpp = bpp;
  const int smem = 2 * kMaxPar * static_cast<int>(sizeof(int4)) + win_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      lpf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = ntickets < kBlocksPerSM * sms ? ntickets
                                                 : kBlocksPerSM * sms;
  lpf_kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
