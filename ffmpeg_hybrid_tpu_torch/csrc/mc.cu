// VP9 motion compensation for Hopper (sm_90a): the inter pass of a
// frame's planes, the CUDA counterpart of the JAX package's _mc_cells and
// the apply step of _recon_plane_inter (ffmpeg_hybrid_tpu/ops/
// recon_tpu.py:131-184 and 1805-1850). Those are XLA programs there, not
// Pallas kernels; the port's plain version is ops/recon.py:mc_planes_plain.
//
//   mc_planes         the inter pass of up to three planes, one launch
//   mc_planes_scaled  the same for a frame with a reference of another
//                     size (below, before the entry points)
//
// Semantics. A plane is H x W pixels, its grids H/4 x W/4 cells. Cell
// (i, j) of an inter cell (inter4) predicts its 4x4 pixels from one
// reference, or from two averaged as (p0 + p1 + 1) >> 1 where comp is
// set and the frame has compound blocks (has_comp; otherwise comp is not
// read). Reference ri of the cell: plane refsel[i, j, ri] of the three,
// motion mvx = mv16[i, j, ri, 0] * mvsx, mvy = mv16[i, j, ri, 1] * mvsy
// (1/16 pel), integer part mv >> 4 (arithmetic), phase mv & 15. The
// cell's source is the 11 x 11 patch from -3 to +7 around (4i + (mvy >>
// 4), 4j + (mvx >> 4)), its rows clamped to [0, h - 1] and its columns
// to [0, w - 1] (the plane's visible size, not its padded one). An
// 8-tap horizontal pass of filter bank filt (clamped to 0-3) at phase mx
// gives 11 x 4 values, then a vertical pass at phase my gives 4 x 4;
// each pass rounds as (acc + 64) >> 7 and clips to [0, 2^bpp - 1]. The
// plane is clip(prediction + residual) on inter cells and 0 elsewhere.
//
// Design. A warp per 16 x 16 pixel tile of a plane, kWarps neighbouring
// tiles a block (raster order; the tiles of the three planes make one
// grid, the planes' descriptors sit in the kernel's parameters), and no
// barrier wider than a warp: each warp owns a slice of shared memory and
// synchronises with __syncwarp alone, so a tile that waits on memory
// stalls only itself, and kWarps x kMinBlocks = 24 tiles reside on an
// SM (80 registers a thread). A lane owns two 4-pixel quads of the
// tile, rows lane / 4 and lane / 4 + 8 at columns 4 (lane % 4) to +3,
// and their two cells. It loads its cells' inter, comp (with has_comp),
// filt, refsel (int2) and mv (int4) at once; a tile without an inter
// cell writes zeros and leaves. The inter quads' residuals then go into
// the warp's slice by cp.async, in flight with the reference's pixels,
// and the second reference runs only where the warp holds a compound
// cell. For each reference the warp votes on the motion (plane, mvx,
// mvy, bank) of the cells that use it, the inter cells, then the
// compound ones. A cell that does not use it contributes nothing, so
// the out-of-range values such cells carry never enter a key, an
// address or a product.
//  - One motion: the warp copies one window of the reference into its
//    slice (cp.async, a row a step, consecutive lanes on consecutive
//    columns), the tile's 16 + 7 rows and columns around its displaced
//    origin (clamped as a cell's patch is), runs the horizontal pass
//    over it into shared memory and the vertical pass into registers.
//    At phase 0 every bank's taps are {0, 0, 0, 128, 0, 0, 0, 0}, and
//    (128 v + 64) >> 7 = v, so the pass is the clip alone: mx == 0 drops
//    the window's column halo and the horizontal pass (the vertical pass
//    clips the window as it reads it), my == 0 its row halo and the
//    vertical pass.
//  - More than one: the warp walks the cells that use the reference,
//    32 / kCellLanes at a time and kCellLanes lanes a cell: the cell's
//    11 x 11 patch, its 44 horizontal values and its 16 pixels, in the
//    warp's slice; the predictions go into a 16 x 16 tile there, read
//    back by quad.
// The epilogue averages compound cells, adds the residual, clips,
// selects by inter and writes each quad once as an int4. The taps come
// from __constant__ memory: one phase a warp on the window path, and on
// the walk one a cell in flight, so a read serialises at most 32 /
// kCellLanes ways; a copy per block into shared memory would need a
// block-wide barrier.
//
// What bounds it. Bytes: each output pixel written once (4 B), and per
// pixel of an inter cell its residual and a reference pixel per
// reference (4 B each), plus the grids (some 30 B a cell): about 43 MB
// for a 1080p frame of single-reference cells, 55 MB with every cell
// compound, 13-16 us at 3.35 TB/s. The operations, 480 multiply-adds a
// cell a reference, are below that at the int32 rate. The first design
// (a 256-thread block per tile, a thread per pixel, 59 registers) was
// held back by latency, not bytes: 4 tiles resided on an SM, so a 1080p
// frame's 12,240 tiles ran in 23.2 waves, each a chain of dependent
// steps behind two block-wide votes and two barriers (the inter byte,
// the compound byte, the grids, the patches, then the residual): 0.105
// ms a frame, 4.5 us a wave, some four device-memory round trips.
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 3;
constexpr int kWarps = 4;         // tiles a block, a warp each
constexpr int kMinBlocks = 6;     // blocks an SM holds (__launch_bounds__)
constexpr int kCellLanes = 16;    // lanes a cell on the per-cell walk
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 16;                  // pixels a side of a tile
constexpr int kWin = kTile + 7;            // window rows and columns
constexpr int kWinStride = 24;             // ints a window row
constexpr int kPatch = 11;                 // patch rows and columns a cell
constexpr int kHVals = kPatch * 4;         // horizontal values a cell
constexpr int kStep = 32 / kCellLanes;     // cells a step of the walk
// A warp's slice of shared memory, in ints. The window path: the window
// [kWin][kWinStride] at 0 and its horizontal values [kWin][kTile] at
// kHv. The walk: kStep patches and kStep cells' horizontal values from
// 0, the tile's prediction [kTile][kTile] at kPred. Both: the tile's
// residual [kTile][kTile] at kRes.
constexpr int kHv = kWin * kWinStride;
constexpr int kRes = kHv + kWin * kTile;
constexpr int kSlice = kRes + kTile * kTile;
constexpr int kCellHv = kStep * kPatch * kPatch;
constexpr int kPred = (kCellHv + kStep * kHVals + 3) & ~3;
static_assert(kPred + kTile * kTile <= kRes, "the walk outgrows a slice");
static_assert(32 % kCellLanes == 0 && kCellLanes <= 16, "kCellLanes");

// The 8-tap filters [bank][phase][tap]: banks 0-2 are tables.py's
// SUBPEL_FILTERS in its order (smooth, regular, sharp), bank 3 the
// bilinear filter as 8 taps (128 - 8m and 8m at taps 3 and 4); the
// port's tests hold this table to ops/recon.py's _FTAB.
__constant__ __align__(16) int kFtab[4][16][8] = {
    {  // bank 0
     {0, 0, 0, 128, 0, 0, 0, 0},
     {-3, -1, 32, 64, 38, 1, -3, 0},
     {-2, -2, 29, 63, 41, 2, -3, 0},
     {-2, -2, 26, 63, 43, 4, -4, 0},
     {-2, -3, 24, 62, 46, 5, -4, 0},
     {-2, -3, 21, 60, 49, 7, -4, 0},
     {-1, -4, 18, 59, 51, 9, -4, 0},
     {-1, -4, 16, 57, 53, 12, -4, -1},
     {-1, -4, 14, 55, 55, 14, -4, -1},
     {-1, -4, 12, 53, 57, 16, -4, -1},
     {0, -4, 9, 51, 59, 18, -4, -1},
     {0, -4, 7, 49, 60, 21, -3, -2},
     {0, -4, 5, 46, 62, 24, -3, -2},
     {0, -4, 4, 43, 63, 26, -2, -2},
     {0, -3, 2, 41, 63, 29, -2, -2},
     {0, -3, 1, 38, 64, 32, -1, -3},
    },
    {  // bank 1
     {0, 0, 0, 128, 0, 0, 0, 0},
     {0, 1, -5, 126, 8, -3, 1, 0},
     {-1, 3, -10, 122, 18, -6, 2, 0},
     {-1, 4, -13, 118, 27, -9, 3, -1},
     {-1, 4, -16, 112, 37, -11, 4, -1},
     {-1, 5, -18, 105, 48, -14, 4, -1},
     {-1, 5, -19, 97, 58, -16, 5, -1},
     {-1, 6, -19, 88, 68, -18, 5, -1},
     {-1, 6, -19, 78, 78, -19, 6, -1},
     {-1, 5, -18, 68, 88, -19, 6, -1},
     {-1, 5, -16, 58, 97, -19, 5, -1},
     {-1, 4, -14, 48, 105, -18, 5, -1},
     {-1, 4, -11, 37, 112, -16, 4, -1},
     {-1, 3, -9, 27, 118, -13, 4, -1},
     {0, 2, -6, 18, 122, -10, 3, -1},
     {0, 1, -3, 8, 126, -5, 1, 0},
    },
    {  // bank 2
     {0, 0, 0, 128, 0, 0, 0, 0},
     {-1, 3, -7, 127, 8, -3, 1, 0},
     {-2, 5, -13, 125, 17, -6, 3, -1},
     {-3, 7, -17, 121, 27, -10, 5, -2},
     {-4, 9, -20, 115, 37, -13, 6, -2},
     {-4, 10, -23, 108, 48, -16, 8, -3},
     {-4, 10, -24, 100, 59, -19, 9, -3},
     {-4, 11, -24, 90, 70, -21, 10, -4},
     {-4, 11, -23, 80, 80, -23, 11, -4},
     {-4, 10, -21, 70, 90, -24, 11, -4},
     {-3, 9, -19, 59, 100, -24, 10, -4},
     {-3, 8, -16, 48, 108, -23, 10, -4},
     {-2, 6, -13, 37, 115, -20, 9, -4},
     {-2, 5, -10, 27, 121, -17, 7, -3},
     {-1, 3, -6, 17, 125, -13, 5, -2},
     {0, 1, -3, 8, 127, -7, 3, -1},
    },
    {  // bank 3
     {0, 0, 0, 128, 0, 0, 0, 0},
     {0, 0, 0, 120, 8, 0, 0, 0},
     {0, 0, 0, 112, 16, 0, 0, 0},
     {0, 0, 0, 104, 24, 0, 0, 0},
     {0, 0, 0, 96, 32, 0, 0, 0},
     {0, 0, 0, 88, 40, 0, 0, 0},
     {0, 0, 0, 80, 48, 0, 0, 0},
     {0, 0, 0, 72, 56, 0, 0, 0},
     {0, 0, 0, 64, 64, 0, 0, 0},
     {0, 0, 0, 56, 72, 0, 0, 0},
     {0, 0, 0, 48, 80, 0, 0, 0},
     {0, 0, 0, 40, 88, 0, 0, 0},
     {0, 0, 0, 32, 96, 0, 0, 0},
     {0, 0, 0, 24, 104, 0, 0, 0},
     {0, 0, 0, 16, 112, 0, 0, 0},
     {0, 0, 0, 8, 120, 0, 0, 0},
    },
};

struct Plane {
  const int32_t* ref[3];   // [Hr, Wr] each
  const int32_t* residual; // [H, W]
  int32_t* out;            // [H, W]
  const uint8_t* inter;    // [H/4, W/4] bool
  const uint8_t* comp;     // [H/4, W/4] bool; null without has_comp
  const int32_t* filt;     // [H/4, W/4]
  const int32_t* refsel;   // [H/4, W/4, 2]
  const int32_t* mv;       // [H/4, W/4, 2 refs, (x, y)]
  int H, W;
  int ref_w;               // Wr, the references' row stride
  int w, h;                // the visible size
  int mvsx, mvsy;
  int tiles_x;             // tiles a row
  int tile0;               // the plane's first tile in the grid
};

struct Args {
  Plane p[kMaxPlanes];
  int n;
  int tiles;               // of all the planes
  int maxp;
  int has_comp;
};

// One reference's motion of a cell: plane, MV (1/16 pel, scaled) and
// filter bank.
struct Motion {
  int ref, mvx, mvy, bank;
};

__device__ __forceinline__ int clip(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ bool same(const Motion& a, const Motion& b) {
  return a.ref == b.ref && a.mvx == b.mvx && a.mvy == b.mvy &&
         a.bank == b.bank;
}

// One 8-tap pass of 8 consecutive values, rounded and clipped.
__device__ __forceinline__ int tap8(const int* t, const int* v, int maxp) {
  int acc = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc += t[k] * v[k];
  return clip((acc + 64) >> 7, 0, maxp);
}

// Copies from device memory into shared memory, of 4 bytes and of 16
// (both aligned to their size), as cp.async: a copy holds no register
// while in flight, so a lane keeps all its copies in flight at once (a
// load into a register, then a store, measured slower: the stores wait
// on the loads); copies_done waits for the lane's own.
__device__ __forceinline__ void copy4(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy16(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 4 values of shared memory, clipped to [0, maxp] where `clipped`.
__device__ __forceinline__ int4 load4(const int32_t* src, bool clipped,
                                      int maxp) {
  int4 v = *reinterpret_cast<const int4*>(src);
  if (clipped)
    v = make_int4(clip(v.x, 0, maxp), clip(v.y, 0, maxp),
                  clip(v.z, 0, maxp), clip(v.w, 0, maxp));
  return v;
}

// The window path: the prediction of the lane's two quads from one
// motion m shared by every cell of the tile at (y0, x0) that uses it.
__device__ __forceinline__ void window_pass(const Plane& p, int maxp,
                                            int32_t* s, int lane,
                                            const Motion& m, int y0, int x0,
                                            int v[2][4]) {
  const int mx = m.mvx & 15, my = m.mvy & 15;
  const int rows = my ? kWin : kTile;
  const int wy = y0 + (m.mvy >> 4) - (my ? 3 : 0);
  const int wx = x0 + (m.mvx >> 4) - (mx ? 3 : 0);
  const int32_t* ref = p.ref[m.ref];
  int32_t* hv = s + kHv;
  // the window, a row a step, consecutive lanes on consecutive columns:
  // into s when a horizontal pass follows; else into hv, two rows a step,
  // where the vertical pass clips it as it reads
  if (mx) {
    const int32_t* src = ref + clip(wx + lane, 0, p.w - 1);
    if (lane < kWin) {
#pragma unroll
      for (int r = 0; r < kWin; ++r)
        if (r < rows)
          copy4(s + r * kWinStride + lane,
                src + static_cast<size_t>(clip(wy + r, 0, p.h - 1)) *
                          p.ref_w);
    }
  } else {
    const int c = lane & 15, r0 = lane >> 4;
    const int32_t* src = ref + clip(wx + c, 0, p.w - 1);
#pragma unroll
    for (int i = 0; i < (kWin + 1) / 2; ++i)
      if (r0 + 2 * i < rows)
        copy4(hv + (r0 + 2 * i) * kTile + c,
              src + static_cast<size_t>(clip(wy + r0 + 2 * i, 0, p.h - 1)) *
                        p.ref_w);
  }
  copies_done();
  __syncwarp();
  if (mx) {
    // horizontal pass: a lane a (row, quad) of 4 values, read as three
    // int4; rows r and r + 2 share a quarter-warp, so the 8 lanes' reads
    // fall on 32 different banks
    int t[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) t[k] = kFtab[m.bank][mx][k];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int j = lane + 32 * i;
      const int g = j >> 2, qc = j & 3;
      const int r = (g & ~3) | ((g & 1) << 1) | ((g >> 1) & 1);
      if (r < rows) {
        const int4* src = reinterpret_cast<const int4*>(
            s + r * kWinStride + 4 * qc);
        const int4 a = src[0], b = src[1], c = src[2];
        const int w[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                           c.x, c.y, c.z, c.w};
        *reinterpret_cast<int4*>(hv + r * kTile + 4 * qc) = make_int4(
            tap8(t, w, maxp), tap8(t, w + 1, maxp), tap8(t, w + 2, maxp),
            tap8(t, w + 3, maxp));
      }
    }
    __syncwarp();
  }
  const int q = lane & 3;
  int t[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) t[k] = kFtab[m.bank][my][k];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int y = (lane >> 2) + 8 * k;
    if (my) {
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int tap = 0; tap < 8; ++tap) {
        const int4 h4 = load4(hv + (y + tap) * kTile + 4 * q, !mx, maxp);
        acc[0] += t[tap] * h4.x;
        acc[1] += t[tap] * h4.y;
        acc[2] += t[tap] * h4.z;
        acc[3] += t[tap] * h4.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) v[k][i] = clip((acc[i] + 64) >> 7, 0, maxp);
    } else {
      const int4 h4 = load4(hv + y * kTile + 4 * q, !mx, maxp);
      v[k][0] = h4.x;
      v[k][1] = h4.y;
      v[k][2] = h4.z;
      v[k][3] = h4.w;
    }
  }
}

// The per-cell walk: the prediction of the lane's two quads for
// reference ri, from the cells of `cells` (bit 4 i + j: cell (i, j) of
// the tile whose first cell is (cy0, cx0)), kStep cells a step.
__device__ __forceinline__ void cell_pass(const Plane& p, int maxp,
                                          int32_t* s, int lane, int ri,
                                          unsigned cells, int cy0, int cx0,
                                          int v[2][4]) {
  const int grp = lane / kCellLanes, rank = lane % kCellLanes;
  int32_t* patch = s + grp * kPatch * kPatch;
  int32_t* hval = s + kCellHv + grp * kHVals;
  int32_t* pred = s + kPred;
  while (cells) {
    int c = -1;
#pragma unroll
    for (int i = 0; i < kStep; ++i) {
      const int b = cells ? __ffs(cells) - 1 : -1;
      if (i == grp) c = b;
      cells &= cells - 1;
    }
    int bank = 0, mx = 0, my = 0;
    if (c >= 0) {
      const size_t g = static_cast<size_t>(cy0 + (c >> 2)) * (p.W >> 2) +
                       cx0 + (c & 3);
      const int mvx = __ldg(p.mv + g * 4 + ri * 2) * p.mvsx;
      const int mvy = __ldg(p.mv + g * 4 + ri * 2 + 1) * p.mvsy;
      const int32_t* ref = p.ref[clip(__ldg(p.refsel + g * 2 + ri), 0, 2)];
      bank = clip(__ldg(p.filt + g), 0, 3);
      mx = mvx & 15;
      my = mvy & 15;
      const int iy = (cy0 + (c >> 2)) * 4 + (mvy >> 4) - 3;
      const int ix = (cx0 + (c & 3)) * 4 + (mvx >> 4) - 3;
      // a row a step, the lane on columns rank, rank + kCellLanes, ...
      for (int c = rank; c < kPatch; c += kCellLanes) {
        const int32_t* src = ref + clip(ix + c, 0, p.w - 1);
#pragma unroll
        for (int r = 0; r < kPatch; ++r)
          copy4(patch + r * kPatch + c,
                src + static_cast<size_t>(clip(iy + r, 0, p.h - 1)) * p.ref_w);
      }
    }
    copies_done();
    __syncwarp();
    if (c >= 0) {
      // horizontal pass: row j / 4 of the patch, output column j % 4
      int t[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) t[k] = kFtab[bank][mx][k];
      for (int j = rank; j < kHVals; j += kCellLanes)
        hval[j] = tap8(t, patch + (j >> 2) * kPatch + (j & 3), maxp);
    }
    __syncwarp();
    if (c >= 0) {
      // vertical pass: the lane's pixels of the cell
      int t[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) t[k] = kFtab[bank][my][k];
      for (int px = rank; px < 16; px += kCellLanes) {
        int acc = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) acc += t[k] * hval[px + 4 * k];
        pred[((c >> 2) * 4 + (px >> 2)) * kTile + (c & 3) * 4 + (px & 3)] =
            clip((acc + 64) >> 7, 0, maxp);
      }
    }
  }
  __syncwarp();
  const int q = lane & 3;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int4 p4 = *reinterpret_cast<const int4*>(
        pred + ((lane >> 2) + 8 * k) * kTile + 4 * q);
    v[k][0] = p4.x;
    v[k][1] = p4.y;
    v[k][2] = p4.z;
    v[k][3] = p4.w;
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    mc_kernel(const __grid_constant__ Args a) {
  __shared__ __align__(16) int32_t smem[kWarps * kSlice];
  const int lane = threadIdx.x & 31;
  const int tile_g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile_g >= a.tiles) return;
  int pi = 0;
  while (pi + 1 < a.n && tile_g >= a.p[pi + 1].tile0) ++pi;
  const Plane& p = a.p[pi];
  int32_t* s = smem + (threadIdx.x >> 5) * kSlice;
  const int tile = tile_g - p.tile0;
  const int y0 = (tile / p.tiles_x) * kTile, x0 = (tile % p.tiles_x) * kTile;
  const int x = x0 + 4 * (lane & 3);
  // every grid load first, then the residuals of the inter quads into
  // the slice, in flight with the reference's
  bool qin[2], inter[2], comp[2];
  int4 mv[2];
  int2 rs[2];
  int filt[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int y = y0 + (lane >> 2) + 8 * k;
    qin[k] = y < p.H && x < p.W;
    inter[k] = comp[k] = false;
    mv[k] = make_int4(0, 0, 0, 0);
    rs[k] = make_int2(0, 0);
    filt[k] = 0;
    if (qin[k]) {
      const size_t g = static_cast<size_t>(y >> 2) * (p.W >> 2) + (x >> 2);
      inter[k] = __ldg(p.inter + g) != 0;
      if (a.has_comp) comp[k] = __ldg(p.comp + g) != 0;
      filt[k] = __ldg(p.filt + g);
      rs[k] = __ldg(reinterpret_cast<const int2*>(p.refsel) + g);
      mv[k] = __ldg(reinterpret_cast<const int4*>(p.mv) + g);
    }
    comp[k] = comp[k] && inter[k];
  }
  if (!__any_sync(kFull, inter[0] || inter[1])) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (qin[k])
        *reinterpret_cast<int4*>(
            p.out + static_cast<size_t>(y0 + (lane >> 2) + 8 * k) * p.W + x) =
            make_int4(0, 0, 0, 0);
    return;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (inter[k])
      copy16(s + kRes + ((lane >> 2) + 8 * k) * kTile + 4 * (lane & 3),
             p.residual + static_cast<size_t>(y0 + (lane >> 2) + 8 * k) * p.W +
                 x);
  const int nref = __any_sync(kFull, comp[0] || comp[1]) ? 2 : 1;
  int pred[2][4];
  for (int ri = 0; ri < nref; ++ri) {
    if (ri) __syncwarp();   // reference 0's reads of the slice are done
    bool act[2];
    Motion m[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      act[k] = ri ? comp[k] : inter[k];
      m[k] = act[k] ? Motion{clip(ri ? rs[k].y : rs[k].x, 0, 2),
                             (ri ? mv[k].z : mv[k].x) * p.mvsx,
                             (ri ? mv[k].w : mv[k].y) * p.mvsy,
                             clip(filt[k], 0, 3)}
                    : Motion{0, 0, 0, 0};
    }
    // the vote: the first lane that uses the reference leads
    const unsigned by0 = __ballot_sync(kFull, act[0]);
    const unsigned by1 = __ballot_sync(kFull, act[1]);
    const int src = __ffs(by0 | by1) - 1;
    const Motion mine = act[0] ? m[0] : m[1];
    const Motion lead{__shfl_sync(kFull, mine.ref, src),
                      __shfl_sync(kFull, mine.mvx, src),
                      __shfl_sync(kFull, mine.mvy, src),
                      __shfl_sync(kFull, mine.bank, src)};
    int v[2][4];
    if (__all_sync(kFull, (!act[0] || same(m[0], lead)) &&
                              (!act[1] || same(m[1], lead)))) {
      window_pass(p, a.maxp, s, lane, lead, y0, x0, v);
    } else {
      // cell (i, j) of the tile is lane 16 i + j's first cell for i < 2,
      // lane 16 (i - 2) + j's second for i >= 2
      const unsigned cells = (by0 & 0xf) | (by0 >> 16 & 0xf) << 4 |
                             (by1 & 0xf) << 8 | (by1 >> 16 & 0xf) << 12;
      cell_pass(p, a.maxp, s, lane, ri, cells, y0 >> 2, x0 >> 2, v);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pred[k][i] = ri == 0 ? v[k][i]
                   : act[k]  ? (pred[k][i] + v[k][i] + 1) >> 1
                             : pred[k][i];
  }
  copies_done();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (!qin[k]) continue;
    int4 o = make_int4(0, 0, 0, 0);
    if (inter[k]) {
      const int4 res = *reinterpret_cast<const int4*>(
          s + kRes + ((lane >> 2) + 8 * k) * kTile + 4 * (lane & 3));
      o = make_int4(clip(pred[k][0] + res.x, 0, a.maxp),
                    clip(pred[k][1] + res.y, 0, a.maxp),
                    clip(pred[k][2] + res.z, 0, a.maxp),
                    clip(pred[k][3] + res.w, 0, a.maxp));
    }
    *reinterpret_cast<int4*>(
        p.out + static_cast<size_t>(y0 + (lane >> 2) + 8 * k) * p.W + x) = o;
  }
}

// ---------------------------------------------------------------------------
// mc_planes_scaled: the inter pass of a frame with a reference of another
// size than the frame (dynamic resize), the counterpart of the JAX
// package's _mc_cells_mixed with _mc_ref_scaled, _mulshift14,
// _mc_one_ref_unscaled, _scaled_anchor_grids and the apply of
// _recon_plane_inter_mixed (ffmpeg_hybrid_tpu/ops/recon_tpu.py:204-442,
// 1851-1884), XLA programs there; the port's plain version is
// ops/recon.py:mc_planes_scaled_plain. Reference: mc_luma_scaled and
// mc_chroma_scaled (vp9recon.c:492-628).
//
// Semantics. As mc_planes, but each of the three slots has its own plane,
// row stride and visible size, and a slot of scale 0 (the frame's size)
// takes mc_planes' arithmetic, any other the scaled one, per cell and
// reference: so a compound cell can mix the two. The MV grid holds raw
// 1/8-pel MVs (luma units); the unscaled path scales them by 2 >> ss. The
// scaled path, for the cell's reference of slot k:
//  - the call anchor (ay, ax), parent corner (by, bx) and span (ph, pw)
//    come from the cell's block record b, the record of luma cell (i <<
//    ss_y, j << ss_x): by = row * 8 >> ss_y, ay = by + 4 ((i - 2 row) & 1)
//    for a sub-8x8 block (bs > 9) when ss_y is 0, else by; ph = 8 height
//    (8x8 units of bs) >> ss_y; likewise x;
//  - the MV is clamped to [-(b0 + span + 4) * 8, (n8 * 8 - b0 + 3) * 8]
//    without subsampling, [-(b0 + span + 4) * 16, (n8 * 4 - b0 + 3) * 16]
//    with (n8: the frame's 8x8 columns or rows);
//  - the start t0 = (2 mv * sc >> 14) + (a0 * sc >> 10) without
//    subsampling, (mv * sc >> 14) + ((a0 * sc >> 10) & ~15) + ((a0 * sc
//    >> 9) & 15) with (the libvpx-820 formula), in 64 bits;
//  - pixel x of the plane reads source column (t0 >> 4) + (tk >> 4) at
//    phase tk & 15, tk = (t0 & 15) + (x - ax) * step; likewise y;
//  - the 8-tap passes as mc_planes', each source row and column clamped
//    to the slot's visible size.
//
// Design. mc_planes' structure: a warp per 16 x 16 tile of a plane,
// kSWarps tiles a block, each warp with its own slice of shared memory and
// __syncwarp its only barrier; a lane owns two 4-pixel quads, rows lane /
// 4 and lane / 4 + 8 at columns 4 (lane % 4) to +3, and their two cells.
// It loads its cells' grids at once, and where a cell uses a scaled slot
// it reads the cell's record once from the splat's index (an entry per
// 8x8 unit, (epoch << 32) | b; an entry of another epoch is no record:
// the last, a pad row) and derives the anchor, corner and span. The inter
// quads' residuals go into the slice by cp.async, in flight with the
// rest. For each reference the lane maps each of its cells that uses it
// to the source: pixel x of the cell reads the 1/16-pel position pos(x) =
// p + (x - xc) * step (column pos >> 4, phase pos & 15; p the cell's own
// position, step 16 for a slot of the frame's size and mc_planes'
// arithmetic there), and likewise y. The map is a line, so the motion key
// of a cell is its slot, its bank and the line's value at the tile's
// origin (x0, y0): two cells of equal keys read the same source columns
// and rows at the same phases, whatever their blocks, anchors or MVs. The
// warp votes on the key of the cells that use the reference.
//  - One motion: the warp copies one window of the slot into its slice
//    (cp.async, each source row and column clamped to the slot's visible
//    size; where no column needs the clamp, a row as the 16-byte chunks
//    that hold it): the rows and columns the tile's 16 pixel rows and
//    columns need, ((phase + 15 step) >> 4) + 8 of each, at most 38 at a
//    step of 32 (a reference twice the frame's size; kSWin). The
//    horizontal pass runs each output column at its own phase over the
//    window's rows into the slice, a lane a column and half the rows; the
//    vertical pass runs each pixel row at its phase into registers, an
//    int4 a tap.
//  - More than one: the warp walks the cells that use the reference,
//    kSCells (8) at a time with every patch's copies in flight at once, 4
//    lanes a cell, from descriptors their owning lanes left in the slice:
//    the cell's patch (at most 14 x 14 at a step of 32, 11 x 11
//    unscaled), its 4 columns' horizontal values, its 16 pixels into a
//    16 x 16 prediction tile in the slice, read back by quad.
// The epilogue averages compound cells, adds the residual, clips, selects
// by inter and writes each quad once as an int4. A cell that does not use
// a reference contributes nothing to its key, address or product. Taps
// come from kFtab read through L1 (a lane loads its column's or row's
// phase once a window or cell; constant memory would serve a warp's 16
// phases one address at a time), block sizes from kBwh. The cells' index
// entries load beside the grids, the residual's copies go before the
// records.
//
// What bounds it. Bytes: each output pixel written once (4 B), per inter
// pixel its residual (4 B), the grids (some 30 B a cell) and the
// reference planes the cells use, each read once: about 43 MB at 1080p
// with one reference plane a cell, 13 us at 3.35 TB/s. Operations: 8
// multiply-adds a pixel for the vertical pass and 2-3.5 rows of 8 for the
// horizontal one, per reference, under the bytes at the int32 rate. The
// first design (a thread per 4-pixel column, each reading its 8 source
// columns from L1 for every row its pixels need, 88-112 loads for 4
// pixels; 96 registers, 5 blocks of 4 warps an SM) took 4.6 times the
// bytes bound on the resize clip and 3.5-6.8 times on seeded frames.

constexpr int kSWarps = 4;        // tiles a block, a warp each
constexpr int kSMinBlocks = 5;    // blocks an SM holds (__launch_bounds__)
constexpr int kSThreads = 32 * kSWarps;
constexpr int kSWin = 38;         // window rows and columns at a step of 32
constexpr int kSWinStride = 44;   // ints a window row: kSWin + 3, by 4
constexpr int kSPatch = 14;       // patch rows and columns a cell, step 32
constexpr int kSCells = 8;        // cells a step of the walk, 4 lanes each
constexpr int kRecLen = 36;       // int16 fields a block record
constexpr int kMaxStep = 32;      // 1/16 pel a pixel: 2x down
// A warp's slice, in ints: the window [kSWin][kSWinStride] at 0, its
// horizontal values [kSWin][kTile] at kSHv, the tile's residual
// [kTile][kTile] at kSRes, the walk's cell descriptors [16][8] at kSDesc.
// The walk overlays the window and its values: kSCells patches at 0, their
// horizontal values [kSPatch][4] at kSHval, the tile's prediction
// [kTile][kTile] at kSPred.
constexpr int kSHv = (kSWin * kSWinStride + 3) & ~3;
constexpr int kSRes = kSHv + kSWin * kTile;
constexpr int kSDesc = kSRes + kTile * kTile;
constexpr int kSSlice = kSDesc + 16 * 8;
constexpr int kSHval = kSCells * kSPatch * kSPatch;
constexpr int kSPred = (kSHval + kSCells * kSPatch * 4 + 3) & ~3;
static_assert(kSPred + kTile * kTile <= kSRes, "the walk outgrows a slice");
static_assert(((15 + 15 * kMaxStep) >> 4) + 8 == kSWin, "kSWin");
static_assert(((15 + 3 * kMaxStep) >> 4) + 8 == kSPatch, "kSPatch");

// BWH_TAB[1] of the port's tables.py: a block size's width and height in
// 8x8 units; the port's tests hold this table to it
__constant__ int kBwh[13][2] = {{8, 8}, {8, 4}, {4, 8}, {4, 4}, {4, 2},
                                {2, 4}, {2, 2}, {2, 1}, {1, 2}, {1, 1},
                                {1, 1}, {1, 1}, {1, 1}};

struct ScaledPlane {
  const int32_t* ref[3];    // [Hr, Wr] each, a shape a slot
  int ref_stride[3];        // Wr
  int ref_w[3], ref_h[3];   // the visible size
  const int32_t* residual;  // [H, W]
  int32_t* out;             // [H, W]
  const uint8_t* inter;     // [H/4, W/4] bool
  const uint8_t* comp;      // [H/4, W/4] bool; null without has_comp
  const int32_t* filt;      // [H/4, W/4]
  const int32_t* refsel;    // [H/4, W/4, 2]
  const int32_t* mv;        // [H/4, W/4, 2 refs, (x, y)], raw 1/8 pel
  int H, W;
  int ss_x, ss_y;
  int tiles_x;              // tiles a row
  int tile0;                // the plane's first tile in the grid
  int vec[3];               // the slot's rows are 16-byte aligned
};

struct ScaledArgs {
  ScaledPlane p[kMaxPlanes];
  int n;
  int tiles;                // of all the planes
  int maxp;
  int has_comp;
  const int16_t* recs;      // [N, 36]
  int N;
  const unsigned long long* bidx;  // [r8 * c8] (epoch << 32) | record
  unsigned epoch;
  int c8;
  int cols, rows;           // the frame's 8x8 block columns and rows
  int scale[3][2];          // 14-bit factors, 0 for the frame's size
  int step[3][2];           // 1/16-pel steps a pixel
  const int* ftab;          // kFtab, read through L1 (global memory)
  int any_scaled;           // a slot has another size than the frame
  // null, or the warps' own count of their tile passes (a reference of a
  // tile that some cell uses): [0] on the window path, [1] on the walk
  unsigned long long* paths;
};

__device__ __forceinline__ int clamp_mv(int mv, int b0, int span, int n8,
                                        int ss) {
  return ss ? clip(mv, -(b0 + span + 4) * 16, (n8 * 4 - b0 + 3) * 16)
            : clip(mv, -(b0 + span + 4) * 8, (n8 * 8 - b0 + 3) * 8);
}

// the 14-bit scaled start of a call, in 1/16 pel of the reference
__device__ __forceinline__ long long scaled_start(int mv, int a0, int sc,
                                                  int ss) {
  const long long pa = static_cast<long long>(a0) * sc;
  if (ss)
    return ((static_cast<long long>(mv) * sc) >> 14) + ((pa >> 10) & ~15LL) +
           ((pa >> 9) & 15);
  return ((static_cast<long long>(mv) * 2 * sc) >> 14) + (pa >> 10);
}

// A cell's call structure in a plane (from its block record): the anchor
// (ay, ax), the parent corner (by, bx) and span (ph, pw).
struct Call {
  int ay, ax, by, bx, ph, pw;
};

// A cell's motion for one reference: its slot and bank, and its map to
// the source, the 1/16-pel position of its first pixel column (cx: column
// cx >> 4, phase cx & 15) and row (cy), a step a pixel (the slot's).
struct SMotion {
  int sel, bank, cx, cy;
};

__device__ __forceinline__ bool same(const SMotion& a, const SMotion& b) {
  return a.sel == b.sel && a.bank == b.bank && a.cx == b.cx && a.cy == b.cy;
}

// The splat's index entry of the cell (i, j) of plane p: its 8x8 unit's
__device__ __forceinline__ unsigned long long cell_entry(
    const ScaledArgs& a, const ScaledPlane& p, int i, int j) {
  return __ldg(a.bidx + static_cast<size_t>((i << p.ss_y) >> 1) * a.c8 +
               ((j << p.ss_x) >> 1));
}

// The call structure of the cell (i, j) of plane p from its record, which
// its index entry e names.
__device__ __forceinline__ Call cell_call(const ScaledArgs& a,
                                          const ScaledPlane& p, int i,
                                          int j, unsigned long long e) {
  const int b = static_cast<unsigned>(e >> 32) == a.epoch
                    ? min(static_cast<int>(e & 0xffffffffu), a.N - 1)
                    : a.N - 1;
  const int16_t* rec = a.recs + static_cast<size_t>(b) * kRecLen;
  const int brow = rec[0], bcol = rec[1], bs = rec[3];
  const bool sub8 = bs > 9;
  const int bsc = clip(bs, 0, 12);
  Call c;
  c.by = (brow * 8) >> p.ss_y;
  c.bx = (bcol * 8) >> p.ss_x;
  c.ay = c.by + (sub8 && !p.ss_y ? ((i - brow * 2) & 1) * 4 : 0);
  c.ax = c.bx + (sub8 && !p.ss_x ? ((j - bcol * 2) & 1) * 4 : 0);
  c.pw = (kBwh[bsc][0] * 8) >> p.ss_x;
  c.ph = (kBwh[bsc][1] * 8) >> p.ss_y;
  return c;
}

// A slot's step on axis d: 16 at the frame's size. A slot of another size
// steps 1-32 (the decoder refuses a frame whose blocks use one beyond); a
// larger step is taken as kMaxStep, which keeps every read in the slice.
__device__ __forceinline__ int slot_step(const ScaledArgs& a, int sel,
                                         int d) {
  return a.scale[sel][0] ? min(a.step[sel][d], kMaxStep) : 16;
}

// The motion of the cell whose first pixel is (yc, xc) for reference ri:
// its raw MV (mvx, mvy), slot sel and bank; cl its call structure (read
// only for a scaled slot).
__device__ __forceinline__ SMotion cell_motion(const ScaledArgs& a,
                                               const ScaledPlane& p, int sel,
                                               int bank, int mvx, int mvy,
                                               const Call& cl, int yc,
                                               int xc) {
  if (a.scale[sel][0] == 0) {
    mvx *= 2 >> p.ss_x;
    mvy *= 2 >> p.ss_y;
    return SMotion{sel, bank, 16 * xc + mvx, 16 * yc + mvy};
  }
  mvx = clamp_mv(mvx, cl.bx, cl.pw, a.cols, p.ss_x);
  mvy = clamp_mv(mvy, cl.by, cl.ph, a.rows, p.ss_y);
  const long long tx0 = scaled_start(mvx, cl.ax, a.scale[sel][0], p.ss_x);
  const long long ty0 = scaled_start(mvy, cl.ay, a.scale[sel][1], p.ss_y);
  // pos(x) = tx0 + (x - ax) step, as (tx0 >> 4) whole pixels and the rest
  const int txk =
      static_cast<int>(tx0 & 15) + (xc - cl.ax) * slot_step(a, sel, 0);
  const int tyk =
      static_cast<int>(ty0 & 15) + (yc - cl.ay) * slot_step(a, sel, 1);
  return SMotion{sel, bank, 16 * static_cast<int>(tx0 >> 4) + txk,
                 16 * static_cast<int>(ty0 >> 4) + tyk};
}

// The 8 taps of bank `bank` at phase `ph`, two 16-byte loads through L1:
// the lanes of a warp ask for up to 16 phases at once, which constant
// memory would serve one address at a time.
__device__ __forceinline__ void taps(const ScaledArgs& a, int bank, int ph,
                                     int* t) {
  const int4* row =
      reinterpret_cast<const int4*>(a.ftab + (bank * 16 + ph) * 8);
  const int4 lo = __ldg(row), hi = __ldg(row + 1);
  t[0] = lo.x;
  t[1] = lo.y;
  t[2] = lo.z;
  t[3] = lo.w;
  t[4] = hi.x;
  t[5] = hi.y;
  t[6] = hi.z;
  t[7] = hi.w;
}

// The window path: the prediction of the lane's two quads from one motion
// m, whose map is at the tile's origin.
__device__ __forceinline__ void scaled_window(const ScaledArgs& a,
                                              const ScaledPlane& p,
                                              int32_t* s, int lane,
                                              const SMotion& m, int v[2][4]) {
  const int sx = slot_step(a, m.sel, 0), sy = slot_step(a, m.sel, 1);
  const int fx = m.cx & 15, fy = m.cy & 15;
  const int ncol = ((fx + 15 * sx) >> 4) + 8;
  const int nrow = ((fy + 15 * sy) >> 4) + 8;
  const int c0 = (m.cx >> 4) - 3, r0 = (m.cy >> 4) - 3;
  const int32_t* ref = p.ref[m.sel];
  const int stride = p.ref_stride[m.sel];
  const int wm = p.ref_w[m.sel] - 1, hm = p.ref_h[m.sel] - 1;
  // window column v sits at v + off of its row: where no column is
  // clamped and the slot's rows are aligned, the rows go as the 16-byte
  // chunks that hold them (off = c0 % 4), else a column at a time
  int off = 0;
  const int nch = ((c0 & 3) + ncol + 3) >> 2;
  if (p.vec[m.sel] && c0 >= 0 && c0 + ncol - 1 <= wm &&
      (c0 & ~3) + 4 * nch <= stride) {
    off = c0 & 3;
    const int32_t* src = ref + (c0 - off);
    // chunk i = r nch + k, the lane's stepping by 32 without a division
    const int dr = 32 / nch, dk = 32 - dr * nch;
    int r = lane / nch, k = lane - r * nch;
    for (; r < nrow; r += dr, k += dk) {
      if (k >= nch) {
        k -= nch;
        ++r;
        if (r >= nrow) break;
      }
      copy16(s + r * kSWinStride + 4 * k,
             src + static_cast<size_t>(clip(r0 + r, 0, hm)) * stride + 4 * k);
    }
  } else {
    for (int c = lane; c < ncol; c += 32) {
      const int32_t* src = ref + clip(c0 + c, 0, wm);
      for (int r = 0; r < nrow; ++r)
        copy4(s + r * kSWinStride + c,
              src + static_cast<size_t>(clip(r0 + r, 0, hm)) * stride);
    }
  }
  copies_done();
  __syncwarp();
  // horizontal pass: output column j at its phase, rows lane / 16 + 2 i
  int32_t* hv = s + kSHv;
  {
    const int j = lane & 15, tk = fx + j * sx;
    int t[8];
    taps(a, m.bank, tk & 15, t);
    const int32_t* w = s + (tk >> 4) + off;
    for (int u = lane >> 4; u < nrow; u += 2)
      hv[u * kTile + j] = tap8(t, w + u * kSWinStride, a.maxp);
  }
  __syncwarp();
  // vertical pass: each of the lane's two pixel rows at its phase
  const int q = lane & 3;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int tk = fy + ((lane >> 2) + 8 * k) * sy;
    int t[8];
    taps(a, m.bank, tk & 15, t);
    int acc[4] = {0, 0, 0, 0};
    const int32_t* h = hv + (tk >> 4) * kTile + 4 * q;
#pragma unroll
    for (int tap = 0; tap < 8; ++tap) {
      const int4 h4 = *reinterpret_cast<const int4*>(h + tap * kTile);
      acc[0] += t[tap] * h4.x;
      acc[1] += t[tap] * h4.y;
      acc[2] += t[tap] * h4.z;
      acc[3] += t[tap] * h4.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) v[k][i] = clip((acc[i] + 64) >> 7, 0, a.maxp);
  }
}

// The walk: the prediction of the lane's two quads from the cells of
// `cells` (bit 4 i + j: cell (i, j) of the tile), whose motions
// (SMotion, at the cell's first pixel) are in the slice's descriptors,
// kSCells cells a step (all their patches' copies in flight at once) and
// 4 lanes a cell, a column each.
__device__ __forceinline__ void scaled_walk(const ScaledArgs& a,
                                            const ScaledPlane& p, int32_t* s,
                                            int lane, unsigned cells,
                                            int v[2][4]) {
  const int grp = lane >> 2, rank = lane & 3;
  int32_t* patch = s + grp * kSPatch * kSPatch;
  int32_t* hval = s + kSHval + grp * kSPatch * 4;
  int32_t* pred = s + kSPred;
  while (cells) {
    int c = -1;
#pragma unroll
    for (int i = 0; i < kSCells; ++i) {
      const int b = cells ? __ffs(cells) - 1 : -1;
      if (i == grp) c = b;
      cells &= cells - 1;
    }
    SMotion m{0, 0, 0, 0};
    int sx = 16, sy = 16, nrow = 0;
    if (c >= 0) {
      const int4 d = *reinterpret_cast<const int4*>(s + kSDesc + 8 * c);
      m = SMotion{d.x, d.y, d.z, d.w};
      sx = slot_step(a, m.sel, 0);
      sy = slot_step(a, m.sel, 1);
      const int ncol = (((m.cx & 15) + 3 * sx) >> 4) + 8;
      nrow = (((m.cy & 15) + 3 * sy) >> 4) + 8;
      const int c0 = (m.cx >> 4) - 3, r0 = (m.cy >> 4) - 3;
      const int wm = p.ref_w[m.sel] - 1, hm = p.ref_h[m.sel] - 1;
      const int stride = p.ref_stride[m.sel];
      for (int col = rank; col < ncol; col += 4) {
        const int32_t* src = p.ref[m.sel] + clip(c0 + col, 0, wm);
        for (int r = 0; r < nrow; ++r)
          copy4(patch + r * kSPatch + col,
                src + static_cast<size_t>(clip(r0 + r, 0, hm)) * stride);
      }
    }
    copies_done();
    __syncwarp();
    if (c >= 0) {
      // horizontal pass: column `rank` of the cell at its phase, every row
      const int tk = (m.cx & 15) + rank * sx;
      int t[8];
      taps(a, m.bank, tk & 15, t);
      for (int r = 0; r < nrow; ++r)
        hval[r * 4 + rank] = tap8(t, patch + r * kSPatch + (tk >> 4), a.maxp);
    }
    __syncwarp();
    if (c >= 0) {
      // vertical pass: the cell's four pixels of column `rank`
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int tk = (m.cy & 15) + y * sy;
        int t[8];
        taps(a, m.bank, tk & 15, t);
        int acc = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          acc += t[k] * hval[((tk >> 4) + k) * 4 + rank];
        pred[((c >> 2) * 4 + y) * kTile + (c & 3) * 4 + rank] =
            clip((acc + 64) >> 7, 0, a.maxp);
      }
    }
  }
  __syncwarp();
  const int q = lane & 3;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int4 p4 = *reinterpret_cast<const int4*>(
        pred + ((lane >> 2) + 8 * k) * kTile + 4 * q);
    v[k][0] = p4.x;
    v[k][1] = p4.y;
    v[k][2] = p4.z;
    v[k][3] = p4.w;
  }
}

__global__ void __launch_bounds__(kSThreads, kSMinBlocks)
    mc_scaled_kernel(const __grid_constant__ ScaledArgs a) {
  __shared__ __align__(16) int32_t smem[kSWarps * kSSlice];
  const int lane = threadIdx.x & 31;
  const int tile_g = blockIdx.x * kSWarps + (threadIdx.x >> 5);
  if (tile_g >= a.tiles) return;
  int pi = 0;
  while (pi + 1 < a.n && tile_g >= a.p[pi + 1].tile0) ++pi;
  const ScaledPlane& p = a.p[pi];
  int32_t* s = smem + (threadIdx.x >> 5) * kSSlice;
  const int tile = tile_g - p.tile0;
  const int y0 = (tile / p.tiles_x) * kTile, x0 = (tile % p.tiles_x) * kTile;
  const int x = x0 + 4 * (lane & 3);
  // every grid load first, then the records the scaled slots need, then
  // the residuals of the inter quads into the slice
  bool qin[2], inter[2], comp[2];
  int4 mv[2];
  int2 rs[2];
  int filt[2];
  unsigned long long ent[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int y = y0 + (lane >> 2) + 8 * k;
    qin[k] = y < p.H && x < p.W;
    inter[k] = comp[k] = false;
    mv[k] = make_int4(0, 0, 0, 0);
    rs[k] = make_int2(0, 0);
    filt[k] = 0;
    ent[k] = 0;
    if (qin[k]) {
      const size_t g = static_cast<size_t>(y >> 2) * (p.W >> 2) + (x >> 2);
      inter[k] = __ldg(p.inter + g) != 0;
      if (a.has_comp) comp[k] = __ldg(p.comp + g) != 0;
      filt[k] = __ldg(p.filt + g);
      rs[k] = __ldg(reinterpret_cast<const int2*>(p.refsel) + g);
      mv[k] = __ldg(reinterpret_cast<const int4*>(p.mv) + g);
      // the record's index entry beside the grids, where a slot is scaled
      if (a.any_scaled) ent[k] = cell_entry(a, p, y >> 2, x >> 2);
    }
    comp[k] = comp[k] && inter[k];
    rs[k] = make_int2(clip(rs[k].x, 0, 2), clip(rs[k].y, 0, 2));
    filt[k] = clip(filt[k], 0, 3);
  }
  if (!__any_sync(kFull, inter[0] || inter[1])) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (qin[k])
        *reinterpret_cast<int4*>(
            p.out + static_cast<size_t>(y0 + (lane >> 2) + 8 * k) * p.W + x) =
            make_int4(0, 0, 0, 0);
    return;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (inter[k])
      copy16(s + kSRes + ((lane >> 2) + 8 * k) * kTile + 4 * (lane & 3),
             p.residual +
                 static_cast<size_t>(y0 + (lane >> 2) + 8 * k) * p.W + x);
  Call cl[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    cl[k] = Call{0, 0, 0, 0, 0, 0};
    if (inter[k] && (a.scale[rs[k].x][0] || (comp[k] && a.scale[rs[k].y][0])))
      cl[k] = cell_call(a, p, (y0 >> 2) + (lane >> 2) / 4 + 2 * k, x >> 2,
                        ent[k]);
  }
  const int nref = __any_sync(kFull, comp[0] || comp[1]) ? 2 : 1;
  int pred[2][4];
  for (int ri = 0; ri < nref; ++ri) {
    if (ri) __syncwarp();   // reference 0's reads of the slice are done
    bool act[2];
    SMotion m[2], key[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      act[k] = ri ? comp[k] : inter[k];
      m[k] = key[k] = SMotion{0, 0, 0, 0};
      if (act[k]) {
        const int yc = y0 + (lane >> 2 & ~3) + 8 * k;
        const int sel = ri ? rs[k].y : rs[k].x;
        m[k] = cell_motion(a, p, sel, filt[k], ri ? mv[k].z : mv[k].x,
                           ri ? mv[k].w : mv[k].y, cl[k], yc, x);
        // the map at the tile's origin
        key[k] = SMotion{m[k].sel, m[k].bank,
                         m[k].cx + (x0 - x) * slot_step(a, sel, 0),
                         m[k].cy + (y0 - yc) * slot_step(a, sel, 1)};
      }
    }
    // the vote: the first lane that uses the reference leads
    const unsigned by0 = __ballot_sync(kFull, act[0]);
    const unsigned by1 = __ballot_sync(kFull, act[1]);
    const int src = __ffs(by0 | by1) - 1;
    const SMotion mine = act[0] ? key[0] : key[1];
    const SMotion lead{__shfl_sync(kFull, mine.sel, src),
                       __shfl_sync(kFull, mine.bank, src),
                       __shfl_sync(kFull, mine.cx, src),
                       __shfl_sync(kFull, mine.cy, src)};
    int v[2][4];
    const bool one = __all_sync(kFull, (!act[0] || same(key[0], lead)) &&
                                           (!act[1] || same(key[1], lead)));
    if (a.paths && lane == 0) atomicAdd(a.paths + (one ? 0 : 1), 1ull);
    if (one) {
      scaled_window(a, p, s, lane, lead, v);
    } else {
      // the lanes of the cells' first pixel rows leave their motions; cell
      // (i, j) of the tile is lane 16 i + j's first cell for i < 2, lane
      // 16 (i - 2) + j's second for i >= 2
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (act[k] && !(lane & 12))
          *reinterpret_cast<int4*>(s + kSDesc +
                                   8 * (4 * (lane >> 4) + 8 * k + (lane & 3))) =
              make_int4(m[k].sel, m[k].bank, m[k].cx, m[k].cy);
      __syncwarp();
      const unsigned cells = (by0 & 0xf) | (by0 >> 16 & 0xf) << 4 |
                             (by1 & 0xf) << 8 | (by1 >> 16 & 0xf) << 12;
      scaled_walk(a, p, s, lane, cells, v);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pred[k][i] = ri == 0 ? v[k][i]
                   : act[k]  ? (pred[k][i] + v[k][i] + 1) >> 1
                             : pred[k][i];
  }
  copies_done();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (!qin[k]) continue;
    int4 o = make_int4(0, 0, 0, 0);
    if (inter[k]) {
      const int4 res = *reinterpret_cast<const int4*>(
          s + kSRes + ((lane >> 2) + 8 * k) * kTile + 4 * (lane & 3));
      o = make_int4(clip(pred[k][0] + res.x, 0, a.maxp),
                    clip(pred[k][1] + res.y, 0, a.maxp),
                    clip(pred[k][2] + res.z, 0, a.maxp),
                    clip(pred[k][3] + res.w, 0, a.maxp));
    }
    *reinterpret_cast<int4*>(
        p.out + static_cast<size_t>(y0 + (lane >> 2) + 8 * k) * p.W + x) = o;
  }
}

// kFtab's address on the current device, for taps()' 16-byte loads:
// looked up once a device and process (a host call, on a host-bound
// path), and refused unless 16-byte aligned.
cudaError_t ftab_address(const int** out) {
  constexpr int kMaxDevices = 64;
  static std::atomic<const int*> cache[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const int* p = cache[dev].load(std::memory_order_acquire);
  if (!p) {
    void* addr = nullptr;
    err = cudaGetSymbolAddress(&addr, kFtab);
    if (err != cudaSuccess) return err;
    if (reinterpret_cast<uintptr_t>(addr) % 16)
      return cudaErrorMisalignedAddress;
    p = static_cast<const int*>(addr);
    cache[dev].store(p, std::memory_order_release);
  }
  *out = p;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The inter pass of n (1-3) planes in one launch on `stream`. ptrs: 10
// device pointers a plane: ref0, ref1, ref2 (int32 [Hr, Wr]), residual
// and out (int32 [H, W], 16-byte aligned), inter4 and comp (bool [H/4,
// W/4]; comp may be null when has_comp is 0), filt (int32 [H/4, W/4]),
// refsel (int32 [H/4, W/4, 2], 8-byte aligned), mv16 (int32 [H/4, W/4,
// 2, 2], 16-byte aligned). dims: 8 ints a plane: H, W (multiples of 4),
// Hr, Wr, w, h (the visible size, 1 <= w <= Wr, 1 <= h <= Hr), mvsx,
// mvsy. bpp: 8-12.
int mc_planes(const void* const* ptrs, const int* dims, int n, int bpp,
              int has_comp, cudaStream_t stream) {
  if (n < 1 || n > kMaxPlanes || bpp < 8 || bpp > 12 || !ptrs || !dims)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.n = n;
  a.maxp = (1 << bpp) - 1;
  a.has_comp = has_comp != 0;
  int tiles = 0;
  for (int i = 0; i < n; ++i) {
    const void* const* q = ptrs + 10 * i;
    const int* d = dims + 8 * i;
    Plane& p = a.p[i];
    for (int r = 0; r < 3; ++r) p.ref[r] = static_cast<const int32_t*>(q[r]);
    p.residual = static_cast<const int32_t*>(q[3]);
    p.out = static_cast<int32_t*>(const_cast<void*>(q[4]));
    p.inter = static_cast<const uint8_t*>(q[5]);
    p.comp = static_cast<const uint8_t*>(q[6]);
    p.filt = static_cast<const int32_t*>(q[7]);
    p.refsel = static_cast<const int32_t*>(q[8]);
    p.mv = static_cast<const int32_t*>(q[9]);
    p.H = d[0];
    p.W = d[1];
    p.ref_w = d[3];
    p.w = d[4];
    p.h = d[5];
    p.mvsx = d[6];
    p.mvsy = d[7];
    const auto misaligned = [](const void* ptr, uintptr_t to) {
      return reinterpret_cast<uintptr_t>(ptr) % to != 0;
    };
    if (p.H <= 0 || p.W <= 0 || p.H % 4 || p.W % 4 || p.w < 1 ||
        p.w > d[3] || p.h < 1 || p.h > d[2] || (has_comp && !p.comp) ||
        misaligned(p.residual, 16) || misaligned(p.out, 16) ||
        misaligned(p.mv, 16) || misaligned(p.refsel, 8))
      return static_cast<int>(cudaErrorInvalidValue);
    p.tiles_x = (p.W + kTile - 1) / kTile;
    p.tile0 = tiles;
    tiles += p.tiles_x * ((p.H + kTile - 1) / kTile);
  }
  a.tiles = tiles;
  mc_kernel<<<(tiles + kWarps - 1) / kWarps, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The inter pass of n (1-3) planes of a frame with a reference of another
// size, in one launch on `stream`. ptrs: 10 device pointers a plane as
// mc_planes' (ref0-2 int32 [Hr, Wr], each of its own shape; residual,
// out int32 [H, W]; inter4, comp bool (comp null when has_comp is 0);
// filt int32 [H/4, W/4]; refsel int32 [H/4, W/4, 2]; mv int32 [H/4, W/4,
// 2, 2], raw 1/8 pel), then recs (int16 [N, 36]), the splat's index
// (uint64 [r8 * c8]) and paths (null, or uint64 [2]: the warps add their
// tile passes on the window path to [0], those on the walk to [1]). dims: 16 ints a plane: H, W (multiples of 4), ss_x,
// ss_y (0 or 1), then a slot each Hr, Wr, w, h (1 <= w <= Wr, 1 <= h <=
// Hr). frame: 18 ints: N, epoch, r8, c8 (the luma 8x8 units), cols, rows,
// scale[3][2], step[3][2] (a slot of another size steps 1-32 a pixel:
// at most twice the frame's size, at most 16 times smaller; slot_step).
// bpp: 8-12.
// residual, out and mv must be 16-byte aligned, refsel 8-byte aligned.
int mc_planes_scaled(const void* const* ptrs, const int* dims, int n,
                     const int* frame, int bpp, int has_comp,
                     cudaStream_t stream) {
  if (n < 1 || n > kMaxPlanes || bpp < 8 || bpp > 12 || !ptrs || !dims ||
      !frame)
    return static_cast<int>(cudaErrorInvalidValue);
  ScaledArgs a{};
  a.n = n;
  a.maxp = (1 << bpp) - 1;
  a.has_comp = has_comp != 0;
  a.recs = static_cast<const int16_t*>(ptrs[10 * n]);
  a.bidx = static_cast<const unsigned long long*>(ptrs[10 * n + 1]);
  a.paths = static_cast<unsigned long long*>(const_cast<void*>(
      ptrs[10 * n + 2]));
  a.N = frame[0];
  a.epoch = static_cast<unsigned>(frame[1]);
  const int r8 = frame[2];
  a.c8 = frame[3];
  a.cols = frame[4];
  a.rows = frame[5];
  for (int k = 0; k < 3; ++k)
    for (int d = 0; d < 2; ++d) {
      a.scale[k][d] = frame[6 + 2 * k + d];
      a.step[k][d] = frame[12 + 2 * k + d];
    }
  if (!a.recs || !a.bidx || a.N < 1 || r8 < 1 || a.c8 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto misaligned = [](const void* ptr, uintptr_t to) {
    return reinterpret_cast<uintptr_t>(ptr) % to != 0;
  };
  const cudaError_t err = ftab_address(&a.ftab);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int k = 0; k < 3; ++k) a.any_scaled |= a.scale[k][0] != 0;
  int tiles = 0;
  for (int i = 0; i < n; ++i) {
    const void* const* q = ptrs + 10 * i;
    const int* d = dims + 16 * i;
    ScaledPlane& p = a.p[i];
    p.H = d[0];
    p.W = d[1];
    p.ss_x = d[2];
    p.ss_y = d[3];
    if (p.H <= 0 || p.W <= 0 || p.H % 4 || p.W % 4 || p.ss_x < 0 ||
        p.ss_x > 1 || p.ss_y < 0 || p.ss_y > 1)
      return static_cast<int>(cudaErrorInvalidValue);
    if (((((p.H >> 2) << p.ss_y) + 1) >> 1) != r8 ||
        ((((p.W >> 2) << p.ss_x) + 1) >> 1) != a.c8)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int r = 0; r < 3; ++r) {
      p.ref[r] = static_cast<const int32_t*>(q[r]);
      const int* s = d + 4 + 4 * r;
      p.ref_stride[r] = s[1];
      p.ref_w[r] = s[2];
      p.ref_h[r] = s[3];
      if (!p.ref[r] || p.ref_w[r] < 1 || p.ref_w[r] > s[1] ||
          p.ref_h[r] < 1 || p.ref_h[r] > s[0])
        return static_cast<int>(cudaErrorInvalidValue);
      p.vec[r] = !misaligned(p.ref[r], 16) && p.ref_stride[r] % 4 == 0;
    }
    p.residual = static_cast<const int32_t*>(q[3]);
    p.out = static_cast<int32_t*>(const_cast<void*>(q[4]));
    p.inter = static_cast<const uint8_t*>(q[5]);
    p.comp = static_cast<const uint8_t*>(q[6]);
    p.filt = static_cast<const int32_t*>(q[7]);
    p.refsel = static_cast<const int32_t*>(q[8]);
    p.mv = static_cast<const int32_t*>(q[9]);
    if ((has_comp && !p.comp) || misaligned(p.residual, 16) ||
        misaligned(p.out, 16) || misaligned(p.mv, 16) ||
        misaligned(p.refsel, 8))
      return static_cast<int>(cudaErrorInvalidValue);
    p.tiles_x = (p.W + kTile - 1) / kTile;
    p.tile0 = tiles;
    tiles += p.tiles_x * ((p.H + kTile - 1) / kTile);
  }
  a.tiles = tiles;
  mc_scaled_kernel<<<(tiles + kSWarps - 1) / kSWarps, kSThreads, 0,
                     stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
