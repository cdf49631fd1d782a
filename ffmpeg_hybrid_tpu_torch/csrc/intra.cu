// VP9 intra prediction for Hopper (sm_90a): the whole intra wavefront of
// one plane, the CUDA counterpart of the JAX package's _intra_scan with
// _edge_spec_dev and _intra_batch_apply
// (ffmpeg_hybrid_tpu/ops/recon_tpu.py:591-731). Those are one XLA
// program (a fori_loop over the dependency levels), not a Pallas
// kernel; it is the intra stage of the main path.
//
//   intra_scan  every level of one plane, one launch
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
// Design. One thread block of 1024 threads walks all L levels of the
// plane: the CUDA form of the reference's single fori_loop dispatch.
// The rows of one level (all sizes, as one list of "virtual rows") are
// taken in windows of at most 1024; each window runs three phases:
//   compact  each thread reads one row's position and, if the block
//            touches the plane, appends it to its size's list in shared
//            memory (inert rows cost this one read and nothing else);
//   edges    one thread per (listed block, edge entry) assembles the
//            edge vectors into shared memory;
//   pixels   one thread per (listed block, pixel): the integer dot
//            product with the mode's weight column (int32, exact: the
//            sum is below 2^19), or TM, plus the residual, stored into
//            the plane in place.
// Compaction of the next window runs beside the pixels of this one
// (two lists and two counters alternate), so a window costs two
// barriers. A barrier orders a level's stores before the next level's
// edge reads: the block's global writes are visible to all its threads
// after __syncthreads().
//
// What bounds it. The work is a chain of L dependent levels (about 300
// per plane on a 1080p keyframe of small blocks) with two barriers each,
// on one SM. The bytes the function needs (the plane read and written
// once, the residual, the slab and the weights used read once, some 50
// MB at 1080p, 15 us at 3.35 TB/s) and its operations are far below
// what it takes. What it does take: every pixel reads its whole
// weight column (up to 67 entries; a 32x32 mode's weights are 274 KB,
// more than the L1 beside the edge buffer), so a level of large blocks
// streams megabytes from L2 into this one SM, which bounds the Y plane
// (about 30 us per level on an H100; U and V, smaller blocks, about
// 10). Predictors that read only their few taps, and a level spread
// over many SMs (a grid-wide barrier per level, or a launch per level),
// are the next steps.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxSec = 4;
// edge vectors of one window, int32, in dynamic shared memory
constexpr int kEdgeInts = 48 * 1024;

// The slab's sections, from the wrapper (ops/recon_cuda.py intra_meta):
// per section the block size, rows per level, first slab row, edge
// length and offset of the size's weights in the table; and the window.
struct Sections {
  int n;
  int sz[kMaxSec], cap[kMaxSec], base[kMaxSec], ne[kMaxSec], woff[kMaxSec];
  int first[kMaxSec];  // the section's first virtual row of a level
  int rows;   // rows of one level over all sections (sum of cap)
  int win;    // rows per window: at most kThreads, and win * max(ne)
              // edge entries fit kEdgeInts
};

struct Plane {
  int32_t* plane;            // [H, W], updated in place
  const int32_t* residual;   // [H, W]
  const int16_t* slab;       // [tot, 8]
  const int32_t* wtab;       // weights of every size, [15, ne, sz*sz] each
  const int32_t* edges;      // [15, 4] needs_left, needs_top, needs_tl,
                             // needs_tr per mode
  int H, W, L, bpp;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int log2i(int v) { return 31 - __clz(v); }

// Entry j of the edge vector of the block in slab row h.
__device__ int edge_value(const Plane& p, const int16_t* h, int sz, int j) {
  const int py = h[0], px = h[1], m = h[2];
  const bool ht = h[3] != 0, hl = h[4] != 0, hr = h[5] != 0;
  const int nht = h[6], nhl = h[7];
  const int base = 128 << (p.bpp - 8);
  const int ta = sz == 4 ? 8 : sz;
  const int off = 1 + ta;
  const int32_t* ed = p.edges + 4 * clampi(m, 0, 14);
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
  return pixel ? p.plane[clampi(idx, 0, p.H * p.W - 1)] : cval;
}

// The slab row of virtual row v (of section k) of level lvl.
__device__ __forceinline__ const int16_t* slab_row(const Plane& p,
                                                   const Sections& s, int k,
                                                   int lvl, int v) {
  return p.slab + 8 * (static_cast<size_t>(s.base[k]) +
                       static_cast<size_t>(lvl) * s.cap[k] + (v - s.first[k]));
}

// Compact the rows of window w0 of level lvl into list/cnt: per
// section, the window positions (v - w0) of the blocks that touch the
// plane.
__device__ __forceinline__ void compact(const Plane& p, const Sections& s,
                                        int lvl, int w0, int16_t* list,
                                        int* cnt) {
  const int tid = threadIdx.x;
  const int v = w0 + tid;
  if (tid >= s.win || v >= s.rows) return;
  int k = 0;
  while (k + 1 < s.n && v >= s.first[k + 1]) ++k;
  const int16_t* h = slab_row(p, s, k, lvl, v);
  const int py = h[0], px = h[1], sz = s.sz[k];
  if (py < p.H && px < p.W && py + sz > 0 && px + sz > 0) {
    const int slot = atomicAdd(&cnt[k], 1);
    list[k * kThreads + slot] = static_cast<int16_t>(tid);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    intra_kernel(Plane p, Sections s) {
  extern __shared__ int32_t s_edge[];
  __shared__ int16_t s_list[2][kMaxSec * kThreads];
  __shared__ int s_cnt[2][kMaxSec];
  const int tid = threadIdx.x;
  const int maxp = (1 << p.bpp) - 1;
  const int nwin = (s.rows + s.win - 1) / s.win;
  const long units = static_cast<long>(p.L) * nwin;
  if (tid < 2 * kMaxSec) s_cnt[tid / kMaxSec][tid % kMaxSec] = 0;
  __syncthreads();
  compact(p, s, 0, 0, s_list[0], s_cnt[0]);
  __syncthreads();
  for (long u = 0; u < units; ++u) {
    const int b = u & 1;
    const int lvl = static_cast<int>(u / nwin);
    const int w0 = static_cast<int>(u % nwin) * s.win;
    const int16_t* list = s_list[b];
    // this window's blocks per section, and their edge and pixel offsets
    int n[kMaxSec], eoff[kMaxSec + 1], poff[kMaxSec + 1];
    eoff[0] = poff[0] = 0;
    for (int k = 0; k < kMaxSec; ++k) {
      n[k] = k < s.n ? s_cnt[b][k] : 0;
      eoff[k + 1] = eoff[k] + n[k] * (k < s.n ? s.ne[k] : 0);
      poff[k + 1] = poff[k] + n[k] * (k < s.n ? s.sz[k] * s.sz[k] : 0);
    }
    // edges: one thread per (block, entry)
    for (int t = tid; t < eoff[kMaxSec]; t += kThreads) {
      int k = 0;
      while (t >= eoff[k + 1]) ++k;
      const int i = (t - eoff[k]) / s.ne[k], j = (t - eoff[k]) % s.ne[k];
      const int16_t* h = slab_row(p, s, k, lvl, w0 + list[k * kThreads + i]);
      s_edge[t] = edge_value(p, h, s.sz[k], j);
    }
    __syncthreads();
    // pixels: one thread per (block, pixel); then the next window's
    // compaction into the other list
    for (int t = tid; t < poff[kMaxSec]; t += kThreads) {
      int k = 0;
      while (t >= poff[k + 1]) ++k;
      const int sz = s.sz[k], lg = log2i(sz);
      const int q = t - poff[k];
      const int i = q >> (2 * lg), pix = q & (sz * sz - 1);
      const int y = pix >> lg, x = pix & (sz - 1);
      const int16_t* h = slab_row(p, s, k, lvl, w0 + list[k * kThreads + i]);
      const int rr = h[0] + y, cc = h[1] + x, m = h[2];
      if (rr < 0 || rr >= p.H || cc < 0 || cc >= p.W) continue;
      const int ne = s.ne[k];
      const int32_t* e = s_edge + eoff[k] + i * ne;
      int pred;
      if (m == 9) {                              // TM
        const int ta = sz == 4 ? 8 : sz;
        pred = clampi(e[1 + x] + e[ta + sz - y] - e[0], 0, maxp);
      } else {
        const int P = sz * sz;
        const int32_t* w = p.wtab + s.woff[k] +
                           static_cast<size_t>(clampi(m, 0, 14)) * ne * P + pix;
        int acc = 0;
        for (int kk = 0; kk < ne; ++kk) acc += e[kk] * w[kk * P];
        pred = (acc + 32) >> 6;
      }
      const size_t o = static_cast<size_t>(rr) * p.W + cc;
      p.plane[o] = clampi(pred + p.residual[o], 0, maxp);
    }
    if (tid < kMaxSec) s_cnt[b][tid] = 0;
    if (u + 1 < units) {
      const long un = u + 1;
      compact(p, s, static_cast<int>(un / nwin),
              static_cast<int>(un % nwin) * s.win, s_list[b ^ 1],
              s_cnt[b ^ 1]);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Run the intra wavefront of one plane in place, one launch on `stream`.
// meta: 1 + 5 * nsec ints from the wrapper: rows, then per section sz,
// cap, base, ne, woff. tot: the slab's rows. windows (out): the windows
// each level takes.
int intra_scan(int32_t* plane, const int32_t* residual, const int16_t* slab,
               const int32_t* wtab, const int32_t* edges, int H, int W, int L,
               int bpp, int nsec, const int* meta, long long tot, int* windows,
               cudaStream_t stream) {
  if (H <= 0 || W <= 0 || L <= 0 || nsec <= 0 || nsec > kMaxSec ||
      bpp < 8 || bpp > 12)
    return static_cast<int>(cudaErrorInvalidValue);
  Sections s{};
  s.n = nsec;
  s.rows = meta[0];
  int ne_max = 0, first = 0;
  for (int k = 0; k < nsec; ++k) {
    s.sz[k] = meta[1 + 5 * k];
    s.cap[k] = meta[2 + 5 * k];
    s.base[k] = meta[3 + 5 * k];
    s.ne[k] = meta[4 + 5 * k];
    s.woff[k] = meta[5 + 5 * k];
    s.first[k] = first;
    first += s.cap[k];
    ne_max = s.ne[k] > ne_max ? s.ne[k] : ne_max;
    const long long end =
        s.base[k] + static_cast<long long>(L) * s.cap[k];
    if (s.cap[k] <= 0 || (s.sz[k] & (s.sz[k] - 1)) || s.sz[k] < 4 ||
        s.sz[k] > 32 || s.ne[k] <= 0 || s.ne[k] > kEdgeInts || end > tot)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (first != s.rows) return static_cast<int>(cudaErrorInvalidValue);
  // rows whose edge vectors fit the shared buffer at the longest edge
  s.win = kEdgeInts / ne_max < kThreads ? kEdgeInts / ne_max : kThreads;
  *windows = (s.rows + s.win - 1) / s.win;
  const Plane p{plane, residual, slab, wtab, edges, H, W, L, bpp};
  const int smem = kEdgeInts * static_cast<int>(sizeof(int32_t));
  cudaError_t err = cudaFuncSetAttribute(
      intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  intra_kernel<<<1, kThreads, smem, stream>>>(p, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
