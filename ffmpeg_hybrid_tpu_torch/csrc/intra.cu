// VP9 intra prediction for Hopper (sm_90a): the whole intra wavefront of
// a frame's planes, the CUDA counterpart of the JAX package's _intra_scan
// with _edge_spec_dev and _intra_batch_apply
// (ffmpeg_hybrid_tpu/ops/recon_tpu.py:591-731). Those are one XLA
// program (a fori_loop over the dependency levels), not a Pallas
// kernel; it is the intra stage of the main path.
//
//   intra_scan  every level of up to three planes, one launch
//
// Semantics. The host packs the plane's intra transform blocks into a
// slab of int16 rows (py, px, m, have_top, have_left, have_right,
// n_have_top, n_have_left), per size a section of L levels x cap rows;
// unused rows are inert (py = Hp + 64, outside the plane). Levels come
// from the blocks' dependencies: a block reads only the row above it
// and the column left of it, written at earlier levels, so the blocks
// of one level are independent. Each block's edge vector is
//   e = [tl, top[0..Ta-1], left bottom-up[0..sz-1], 128 << (bpp-8), 1]
// (Ta = 8 for 4x4, else sz), assembled by the rules of check_intra_mode
// (vp9recon.c:98-217): the EDGES flags of the mode say which parts it
// needs; top pixels clamp to n_have_top; the 4x4 top-right zone is real
// only with have_right and n_have_top >= 8, else it repeats top[3]
// (clamped); a missing top or left gives base - 1 / base + 1, the
// top-left base +- 1; left rows past n_have_left repeat the last one
// available. Every predictor but TM is (e . W[mode][:, pixel] + 32) >>
// 6 with integer weights (ops/intra_tables.py); TM is clip(top[x] +
// left[y] - tl). The residual is added and the sum clipped to
// [0, (1 << bpp) - 1]; pixels outside the plane are not written.
//
// The predictors, from the tap table (ops/recon_cuda.py tap_table,
// built from intra_tables.build_all, so exact at every bit depth). Per
// block size, a descriptor per mode says how its weights are held:
//   taps    (the directional modes) one int32 word per pixel: up to
//           three (edge index, weight) taps; a pixel reads three edge
//           entries from shared memory and one word;
//   column  (the DC family: every pixel of a block alike) the one
//           column of edge weights, applied once per block while its
//           edge vector is assembled (a shared-memory atomic sum per
//           entry); every pixel reads that one sum;
//   TM      computed as above.
// No dense weight column is read.
//
// Design. Each plane has a cluster of kCluster thread blocks of 1024
// threads, one per SM; the planes' clusters share one grid, so the three
// wavefronts run side by side and the launch takes as long as the
// longest. The blocks of a cluster walk their plane's L levels together,
// the CUDA form of the reference's fori_loop. The rows of one level (all
// sizes, as one list of "virtual rows") are taken in windows of at most
// 1024; each window runs two phases in every block of the cluster:
//   edges    one thread per (listed block, edge entry) assembles every
//            edge vector of the window into shared memory (and the DC
//            sums);
//   pixels   one thread per quad (four pixels of a row, one int4 of
//            residual, tap words and output) of this block's share: the
//            rank-th part of every listed block's quads. Beside them,
//            the compaction of the next window: each thread appends the
//            row it loaded, if the block touches the plane, to its
//            size's list in shared memory (inert rows cost this one
//            read and nothing else).
// What does not depend on the wavefront is read off the chain: the next
// window's rows load a window ahead, and each thread's first kPre quads
// of residual and tap words load before the barrier that waits for the
// window's edges.
// The blocks of a cluster order a window's stores before the next
// window's edge reads with the cluster barrier (arrive after the stores,
// wait before the edges, the next window's set-up between them); the
// edge reads go through L2.
//
// What bounds it. The bytes the function needs (the planes read and
// written once, the residual, the slab rows and the tap words used, some
// 25 MB for a 1080p frame, 7.5 us at 3.35 TB/s) and its operations (at
// most three multiply-adds a pixel) are far below what it takes. It is a
// chain of L dependent levels per plane (about 300 on a 1080p keyframe of
// small blocks), and a level costs some 3 us however few its pixels (its
// edge reads of pixels stored the level before, two barriers, and the
// window's set-up in every warp); the cluster keeps a wide level's pixel
// work below that (tools/intra_ab_torch.py measures both).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
// thread blocks (SMs) per plane, one cluster: each assembles every edge
// vector of a window and takes its rank's share of every block's pixels
// (a 4x4 block has 4 quads, so at most 4)
constexpr int kLogCluster = 2;
constexpr int kCluster = 1 << kLogCluster;
static_assert(kCluster <= 4, "a 4x4 block's quads are shared out");
constexpr int kMaxSec = 4;     // block sizes 4, 8, 16, 32
constexpr int kMaxPlanes = 3;
constexpr int kModes = 15;
constexpr int kMeta = 1 + 5 * kMaxSec;
// edge vectors of one window, int32, in dynamic shared memory
constexpr int kEdgeInts = 45 * 1024;
// quads per thread whose residual and tap words load before the barrier
constexpr int kPre = 2;
// descriptor kinds of the tap table (ops/recon_cuda.py)
constexpr int kTaps = 0, kColumn = 1, kTM = 2;

// The slab's sections, from the wrapper (ops/recon_cuda.py intra_meta):
// per section the block size, rows per level, first slab row, edge
// length and offset of the size's part of the tap table; and the window.
struct Sections {
  int n;
  int sz[kMaxSec], cap[kMaxSec], base[kMaxSec], ne[kMaxSec], toff[kMaxSec];
  int first[kMaxSec];  // the section's first virtual row of a level
  int rows;   // rows of one level over all sections (sum of cap)
  int win;    // rows per window: at most kThreads, and win * max(ne)
              // edge entries fit kEdgeInts
};

struct Plane {
  int32_t* plane;            // [H, W], updated in place
  const int32_t* residual;   // [H, W]
  const int16_t* slab;       // [tot, 8]
  int H, W, L;
  int vec;  // plane and residual 16-byte aligned, W a multiple of 4
};

struct Job {
  Plane p;
  Sections s;
};

struct Launch {
  Job job[kMaxPlanes];
  const int32_t* taps;   // the tap table (16-byte aligned)
  const int32_t* edges;  // [15, 4] needs_left, needs_top, needs_tl,
                         // needs_tr per mode
  int bpp;
};

// Four pixels of one row of a block, x a multiple of 4: the unit of the
// pixel phase.
struct Quad {
  int k, slot, pix;  // section, list slot, first pixel's index in block
  int rr, cc;        // its position in the plane
  int d;             // the mode's descriptor
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int log2i(int v) { return 31 - __clz(v); }

// The section of entry t, from the window's prefix offsets off (nondecreasing,
// off[0] = 0): the last section that starts at or before t.
__device__ __forceinline__ int section(const int (&off)[kMaxSec + 1], int t) {
  int k = 0;
#pragma unroll
  for (int i = 1; i < kMaxSec; ++i) k += t >= off[i];
  return k;
}

// a[k] for a register array (a dynamic index would put it in local memory)
template <int N>
__device__ __forceinline__ int pick(const int (&a)[N], int k) {
  int v = a[0];
#pragma unroll
  for (int i = 1; i < N; ++i) v = k == i ? a[i] : v;
  return v;
}

__device__ __forceinline__ int lane(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ const int16_t* fields(const uint4& r) {
  return reinterpret_cast<const int16_t*>(&r);
}

// The cluster's barrier in two halves: a block's stores before arrive are
// seen by every block of the cluster after its wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Entry j of the edge vector of the block with slab row h.
__device__ int edge_value(const Plane& p, const int* edges, int bpp,
                          const int16_t* h, int sz, int j) {
  const int py = h[0], px = h[1], m = h[2];
  const bool ht = h[3] != 0, hl = h[4] != 0, hr = h[5] != 0;
  const int nht = h[6], nhl = h[7];
  const int base = 128 << (bpp - 8);
  const int ta = sz == 4 ? 8 : sz;
  const int off = 1 + ta;
  const int* ed = edges + 4 * clampi(m, 0, kModes - 1);
  const bool need_left = ed[0] != 0, need_top = ed[1] != 0;
  const bool need_tl = ed[2] != 0, need_tr = ed[3] != 0;
  bool pixel = false;
  int idx = 0, cval = 0;
  if (j == 0) {                                  // top-left
    if (need_tl) {
      if (hl && ht) {
        pixel = true;
        idx = (py - 1) * p.W + px - 1;
      } else {
        cval = ht ? base + 1 : base - 1;
      }
    }
  } else if (j <= ta) {                          // top, top-right
    const int i = j - 1;
    if (need_top) {
      if (!ht) {
        cval = base - 1;
      } else if (i < sz) {
        pixel = true;
        idx = (py - 1) * p.W + px + min(i, nht - 1);
      } else if (need_tr) {                      // 4x4: entries 5..8
        pixel = true;
        idx = (hr && nht >= sz + 4) ? (py - 1) * p.W + px + 4 + (j - 5)
                                    : (py - 1) * p.W + px + min(3, nht - 1);
      }
    }
  } else if (j < off + sz) {                     // left, bottom-up
    const int r = j - off;
    if (need_left) {
      if (hl) {
        const int npx = min(sz, nhl);
        const int i_eff = r >= sz - npx ? sz - 1 - r : npx - 1;
        pixel = true;
        idx = (py + i_eff) * p.W + px - 1;
      } else {
        cval = base + 1;
      }
    }
  } else {
    cval = j == off + sz ? base : 1;
  }
  // through L2: the other blocks of the cluster write the plane
  return pixel ? __ldcg(p.plane + clampi(idx, 0, p.H * p.W - 1)) : cval;
}

// The slab row of this thread's virtual row in the window at w0 of level
// lvl (py = 0x7fff, outside any plane, where the window has no such row).
__device__ __forceinline__ uint4 load_row(const Plane& p, const Sections& s,
                                          int lvl, int w0) {
  const int v = w0 + static_cast<int>(threadIdx.x);
  uint4 r = make_uint4(0x7fff, 0, 0, 0);
  if (static_cast<int>(threadIdx.x) >= s.win || v >= s.rows) return r;
  int k = 0;
  while (k + 1 < s.n && v >= s.first[k + 1]) ++k;
  const int16_t* g =
      p.slab + 8 * (static_cast<size_t>(s.base[k]) +
                    static_cast<size_t>(lvl) * s.cap[k] + (v - s.first[k]));
  auto pair = [&](int i) {
    return static_cast<uint32_t>(static_cast<uint16_t>(g[i])) |
           static_cast<uint32_t>(static_cast<uint16_t>(g[i + 1])) << 16;
  };
  r.x = pair(0);
  r.y = pair(2);
  r.z = pair(4);
  r.w = pair(6);
  return r;
}

// Compact the window at w0: if this thread's row (from load_row) is a
// block that touches the plane, append it to its section's part of the
// list (which starts at the section's first row in the window) and zero
// its DC sum.
__device__ __forceinline__ void compact(const Plane& p, const Sections& s,
                                        const uint4& row, int w0, uint4* rows,
                                        int* dc, int* cnt) {
  const int v = w0 + static_cast<int>(threadIdx.x);
  if (static_cast<int>(threadIdx.x) >= s.win || v >= s.rows) return;
  int k = 0;
  while (k + 1 < s.n && v >= s.first[k + 1]) ++k;
  const int16_t* h = fields(row);
  const int py = h[0], px = h[1], sz = s.sz[k];
  if (py < p.H && px < p.W && py + sz > 0 && px + sz > 0) {
    const int slot = max(s.first[k] - w0, 0) + atomicAdd(&cnt[k], 1);
    rows[slot] = row;
    dc[slot] = 0;
  }
}

__global__ void __launch_bounds__(kThreads, 1) intra_kernel(Launch a) {
  extern __shared__ int32_t s_edge[];
  __shared__ Job s_job;
  __shared__ uint4 s_row[2][kThreads];
  __shared__ int s_dc[2][kThreads];
  __shared__ int s_cnt[2][kMaxSec];
  __shared__ int s_desc[kMaxSec][kModes];
  __shared__ int s_edges[kModes * 4];
  const int tid = threadIdx.x;
  const int rank = blockIdx.x % kCluster;
  if (tid == 0) s_job = a.job[blockIdx.x / kCluster];
  if (tid < 2 * kMaxSec) s_cnt[tid / kMaxSec][tid % kMaxSec] = 0;
  if (tid < kModes * 4) s_edges[tid] = a.edges[tid];
  __syncthreads();
  const Plane& p = s_job.p;
  const Sections& s = s_job.s;
  if (tid < s.n * kModes)
    s_desc[tid / kModes][tid % kModes] =
        a.taps[s.toff[tid / kModes] + tid % kModes];
  const int maxp = (1 << a.bpp) - 1;
  uint4 next = load_row(p, s, 0, 0);
  compact(p, s, next, 0, s_row[0], s_dc[0], s_cnt[0]);
  __syncthreads();
  // window u starts at virtual row w0 of level lvl; the next one at w0n of
  // lvln (lvln == L: none)
  int lvl = 0, w0 = 0;
  for (int u = 0; lvl < p.L; ++u) {
    const int b = u & 1;
    const bool wrap = w0 + s.win >= s.rows;
    const int w0n = wrap ? 0 : w0 + s.win, lvln = wrap ? lvl + 1 : lvl;
    const bool more = lvln < p.L;
    // the next window's rows, off the chain
    if (more) next = load_row(p, s, lvln, w0n);
    // this window's blocks per section: list offsets, edge and quad
    // offsets
    int reg[kMaxSec], eoff[kMaxSec + 1], qoff[kMaxSec + 1];
    eoff[0] = qoff[0] = 0;
#pragma unroll
    for (int k = 0; k < kMaxSec; ++k) {
      const bool on = k < s.n;
      const int n = on ? s_cnt[b][k] : 0;
      reg[k] = on ? max(s.first[k] - w0, 0) : 0;
      eoff[k + 1] = eoff[k] + n * (on ? s.ne[k] : 0);
      qoff[k + 1] =
          qoff[k] + n * (on ? s.sz[k] * s.sz[k] / (4 * kCluster) : 0);
    }
    const int nquad = qoff[kMaxSec];
    // quad t of this block's share: of each listed block, the rank-th
    // part of its quads (in raster order), whatever the list's order
    auto locate = [&](int t) {
      Quad q;
      q.k = section(qoff, t);
      const int sz = s.sz[q.k], lg = log2i(sz);
      const int i = t - pick(qoff, q.k), lgq = 2 * lg - 2 - kLogCluster;
      q.slot = pick(reg, q.k) + (i >> lgq);
      q.pix = ((rank << lgq) + (i & ((1 << lgq) - 1))) << 2;
      const int16_t* h = fields(s_row[b][q.slot]);
      q.rr = h[0] + (q.pix >> lg);
      q.cc = h[1] + (q.pix & (sz - 1));
      q.d = s_desc[q.k][clampi(h[2], 0, kModes - 1)];
      return q;
    };
    // the quad's four pixels lie in the plane and one aligned int4
    auto whole = [&](const Quad& q) {
      return p.vec && q.rr >= 0 && q.rr < p.H && q.cc >= 0 &&
             q.cc + 4 <= p.W && (q.cc & 3) == 0;
    };
    // what quad t reads apart from the edges: residual and tap words
    auto fetch = [&](int t, int4& res, int4& words) {
      const Quad q = locate(t);
      const size_t o = static_cast<size_t>(q.rr) * p.W + q.cc;
      if (whole(q)) {
        res = __ldg(reinterpret_cast<const int4*>(p.residual + o));
      } else {
        int r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r[j] = q.rr >= 0 && q.rr < p.H && q.cc + j >= 0 && q.cc + j < p.W
                     ? __ldg(p.residual + o + j)
                     : 0;
        res = make_int4(r[0], r[1], r[2], r[3]);
      }
      words = (q.d >> 24) == kTaps
                  ? __ldg(reinterpret_cast<const int4*>(
                        a.taps + s.toff[q.k] + (q.d & 0xffffff) + q.pix))
                  : make_int4(0, 0, 0, 0);
    };
    auto put = [&](int t, const int4& res, const int4& words) {
      const Quad q = locate(t);
      if (q.rr < 0 || q.rr >= p.H) return;
      const int sz = s.sz[q.k];
      const int32_t* e =
          s_edge + pick(eoff, q.k) + (q.slot - pick(reg, q.k)) * s.ne[q.k];
      const int kind = q.d >> 24;
      int out[4];
      if (kind == kTM) {
        const int lg = log2i(sz), ta = sz == 4 ? 8 : sz;
        const int y = q.pix >> lg, x = q.pix & (sz - 1);
        const int left = e[ta + sz - y] - e[0];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          out[j] = clampi(e[1 + x + j] + left, 0, maxp);
      } else if (kind == kColumn) {
        const int pred = (s_dc[b][q.slot] + 32) >> 6;
#pragma unroll
        for (int j = 0; j < 4; ++j) out[j] = pred;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int word = lane(words, j), n = word >> 27;
          int acc = 0;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const int tap = word >> (9 * c);
            if (c < n) acc += e[tap & 127] * ((((tap >> 7) & 3) + 1) << 4);
          }
          out[j] = (acc + 32) >> 6;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[j] = clampi(out[j] + lane(res, j), 0, maxp);
      const size_t o = static_cast<size_t>(q.rr) * p.W + q.cc;
      if (whole(q)) {
        *reinterpret_cast<int4*>(p.plane + o) =
            make_int4(out[0], out[1], out[2], out[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (q.cc + j >= 0 && q.cc + j < p.W) p.plane[o + j] = out[j];
      }
    };
    int4 pres[kPre], pword[kPre];
#pragma unroll
    for (int r = 0; r < kPre; ++r) {
      pres[r] = pword[r] = make_int4(0, 0, 0, 0);
      const int t = r * kThreads + tid;
      if (t < nquad) fetch(t, pres[r], pword[r]);
    }
    // the stores of the window before, by every block of the cluster
    if constexpr (kCluster > 1) {
      if (u > 0) cluster_wait();
    }
    // edges: one thread per (block, entry); a DC-family block sums its
    // column here
    for (int t = tid; t < eoff[kMaxSec]; t += kThreads) {
      const int k = section(eoff, t);
      const int ne = s.ne[k];
      const int i = t - pick(eoff, k);
      const int slot = pick(reg, k) + i / ne, j = i % ne;
      const int16_t* h = fields(s_row[b][slot]);
      const int e = edge_value(p, s_edges, a.bpp, h, s.sz[k], j);
      s_edge[t] = e;
      const int d = s_desc[k][clampi(h[2], 0, kModes - 1)];
      if ((d >> 24) == kColumn) {
        const int w = __ldg(a.taps + s.toff[k] + (d & 0xffffff) + j);
        if (w) atomicAdd(&s_dc[b][slot], w * e);
      }
    }
    __syncthreads();
    // pixels; then the next window's compaction into the other list
#pragma unroll
    for (int r = 0; r < kPre; ++r) {
      const int t = r * kThreads + tid;
      if (t < nquad) put(t, pres[r], pword[r]);
    }
    for (int t = kPre * kThreads + tid; t < nquad; t += kThreads) {
      int4 res, words;
      fetch(t, res, words);
      put(t, res, words);
    }
    // this window's stores, for the cluster's next edge reads
    if constexpr (kCluster > 1) cluster_arrive();
    if (tid < kMaxSec) s_cnt[b][tid] = 0;
    if (more)
      compact(p, s, next, w0n, s_row[b ^ 1], s_dc[b ^ 1], s_cnt[b ^ 1]);
    __syncthreads();
    lvl = lvln;
    w0 = w0n;
  }
  if constexpr (kCluster > 1) cluster_wait();
}

}  // namespace

extern "C" {

// Run the intra wavefronts of n planes (1..3) in place, one launch of a
// cluster of kCluster thread blocks per plane on `stream`. plane, residual, slab: per plane
// (the unused ones NULL). taps: the tap table; edges: the [15, 4] EDGES
// table. dims: per plane H, W, L, sections, slab rows. meta: per plane
// kMeta ints from the wrapper: rows, then per section sz, cap, base, ne,
// toff. windows (out): per plane the windows each level takes.
int intra_scan(int32_t* plane0, const int32_t* residual0,
               const int16_t* slab0, int32_t* plane1,
               const int32_t* residual1, const int16_t* slab1,
               int32_t* plane2, const int32_t* residual2,
               const int16_t* slab2, const int32_t* taps,
               const int32_t* edges, int n, const int* dims, const int* meta,
               int bpp, int* windows, cudaStream_t stream) {
  if (n < 1 || n > kMaxPlanes || bpp < 8 || bpp > 12 || !taps || !edges ||
      reinterpret_cast<uintptr_t>(taps) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  int32_t* planes[kMaxPlanes] = {plane0, plane1, plane2};
  const int32_t* residuals[kMaxPlanes] = {residual0, residual1, residual2};
  const int16_t* slabs[kMaxPlanes] = {slab0, slab1, slab2};
  Launch a{};
  a.taps = taps;
  a.edges = edges;
  a.bpp = bpp;
  for (int j = 0; j < n; ++j) {
    const int* dm = dims + 5 * j;
    const int* mt = meta + kMeta * j;
    const int H = dm[0], W = dm[1], L = dm[2], nsec = dm[3], tot = dm[4];
    if (!planes[j] || !residuals[j] || !slabs[j] || H <= 0 || W <= 0 ||
        H >= 0x7fff || W >= 0x7fff || L <= 0 || nsec <= 0 ||
        nsec > kMaxSec)
      return static_cast<int>(cudaErrorInvalidValue);
    Sections& s = a.job[j].s;
    s.n = nsec;
    s.rows = mt[0];
    int ne_max = 0, first = 0;
    for (int k = 0; k < nsec; ++k) {
      s.sz[k] = mt[1 + 5 * k];
      s.cap[k] = mt[2 + 5 * k];
      s.base[k] = mt[3 + 5 * k];
      s.ne[k] = mt[4 + 5 * k];
      s.toff[k] = mt[5 + 5 * k];
      s.first[k] = first;
      first += s.cap[k];
      ne_max = s.ne[k] > ne_max ? s.ne[k] : ne_max;
      const long long end =
          s.base[k] + static_cast<long long>(L) * s.cap[k];
      if (s.cap[k] <= 0 || (s.sz[k] & (s.sz[k] - 1)) || s.sz[k] < 4 ||
          s.sz[k] > 32 || s.ne[k] <= 0 || s.ne[k] > 127 || s.toff[k] < 0 ||
          s.toff[k] % 4 ||
          end > tot)
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (first != s.rows) return static_cast<int>(cudaErrorInvalidValue);
    // rows whose edge vectors fit the shared buffer at the longest edge
    s.win = kEdgeInts / ne_max < kThreads ? kEdgeInts / ne_max : kThreads;
    windows[j] = (s.rows + s.win - 1) / s.win;
    const bool vec = W % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(planes[j]) |
                      reinterpret_cast<uintptr_t>(residuals[j])) % 16 == 0;
    a.job[j].p = Plane{planes[j], residuals[j], slabs[j], H, W, L, vec};
  }
  const int smem = kEdgeInts * static_cast<int>(sizeof(int32_t));
  cudaError_t err = cudaFuncSetAttribute(
      intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kCluster;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = kCluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, intra_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
