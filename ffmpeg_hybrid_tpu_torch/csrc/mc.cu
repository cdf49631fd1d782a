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
__constant__ int kFtab[4][16][8] = {
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
// Design. A thread per 4-pixel column of a cell: a warp holds 8 cells of
// a row of cells, 4 lanes each, so the stores of a pixel row are 32
// consecutive ints. The thread derives its cell's record from the
// splat's index (an entry per 8x8 unit, (epoch << 32) | b; an entry of
// another epoch is no record: the last, a pad row), only where a scaled
// slot is used. Its column has one source column set and one phase, so
// it runs the horizontal pass over the rows its 4 pixels need (at most
// 14 at a step of 32, 11 unscaled) into its own column of shared memory
// (no barrier: no other thread reads it), then the vertical pass at each
// row's phase. The taps come from kFtab, the block sizes from kBwh.
//
// What bounds it. Bytes: each output pixel written once (4 B), per inter
// pixel its residual (4 B), the grids (some 30 B a cell) and the
// reference planes the cells use, each read once: about 43 MB at 1080p
// with one reference plane a cell, 13 us at 3.35 TB/s. Operations: 8
// multiply-adds a pixel for the vertical pass and 2-3.5 rows of 8 for the
// horizontal one, per reference, under the bytes at the int32 rate. The
// kernel reads each source pixel again for every column that needs it
// (from L1) and walks its rows serially: a first design, right before
// fast.

constexpr int kScaledThreads = 128;
constexpr int kScaledRows = 16;   // horizontal-pass rows a thread keeps
constexpr int kRecLen = 36;       // int16 fields a block record

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
  int H, W, r4, c4;
  int ss_x, ss_y;
  int strips_x;             // strips of 8 cells a row of cells
  int strip0;               // the plane's first strip in the grid
};

struct ScaledArgs {
  ScaledPlane p[kMaxPlanes];
  int n;
  int strips;               // of all the planes
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

__global__ void __launch_bounds__(kScaledThreads)
    mc_scaled_kernel(const __grid_constant__ ScaledArgs a) {
  __shared__ int32_t hv[kScaledRows][kScaledThreads];
  const int t = threadIdx.x, lane = t & 31;
  const int strip_g = blockIdx.x * (kScaledThreads / 32) + (t >> 5);
  if (strip_g >= a.strips) return;
  int pi = 0;
  while (pi + 1 < a.n && strip_g >= a.p[pi + 1].strip0) ++pi;
  const ScaledPlane& p = a.p[pi];
  const int strip = strip_g - p.strip0;
  const int i = strip / p.strips_x;
  const int j = (strip % p.strips_x) * 8 + (lane >> 2);
  if (j >= p.c4) return;
  const int x = 4 * j + (lane & 3), y0 = 4 * i;
  const size_t g = static_cast<size_t>(i) * p.c4 + j;
  int32_t* out = p.out + static_cast<size_t>(y0) * p.W + x;
  if (!__ldg(p.inter + g)) {
#pragma unroll
    for (int r = 0; r < 4; ++r) out[static_cast<size_t>(r) * p.W] = 0;
    return;
  }
  const int nref = a.has_comp && __ldg(p.comp + g) ? 2 : 1;
  const int bank = clip(__ldg(p.filt + g), 0, 3);
  bool have_rec = false;
  int ay = 0, ax = 0, by = 0, bx = 0, ph = 0, pw = 0;
  int pred[4];
  for (int ri = 0; ri < nref; ++ri) {
    const int sel = clip(__ldg(p.refsel + g * 2 + ri), 0, 2);
    int mvx = __ldg(p.mv + g * 4 + ri * 2);
    int mvy = __ldg(p.mv + g * 4 + ri * 2 + 1);
    int col0, phx, row[4], phy[4];
    if (a.scale[sel][0] == 0) {
      mvx *= 2 >> p.ss_x;
      mvy *= 2 >> p.ss_y;
      col0 = x + (mvx >> 4) - 3;
      phx = mvx & 15;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        row[r] = y0 + r + (mvy >> 4) - 3;
        phy[r] = mvy & 15;
      }
    } else {
      if (!have_rec) {
        // the record of luma cell (i << ss_y, j << ss_x), by its 8x8 unit
        const unsigned long long e =
            a.bidx[static_cast<size_t>((i << p.ss_y) >> 1) * a.c8 +
                   ((j << p.ss_x) >> 1)];
        const int b = static_cast<unsigned>(e >> 32) == a.epoch
                          ? min(static_cast<int>(e & 0xffffffffu), a.N - 1)
                          : a.N - 1;
        const int16_t* rec = a.recs + static_cast<size_t>(b) * kRecLen;
        const int brow = rec[0], bcol = rec[1], bs = rec[3];
        const bool sub8 = bs > 9;
        const int bsc = clip(bs, 0, 12);
        by = (brow * 8) >> p.ss_y;
        bx = (bcol * 8) >> p.ss_x;
        ay = by + (sub8 && !p.ss_y ? ((i - brow * 2) & 1) * 4 : 0);
        ax = bx + (sub8 && !p.ss_x ? ((j - bcol * 2) & 1) * 4 : 0);
        pw = (kBwh[bsc][0] * 8) >> p.ss_x;
        ph = (kBwh[bsc][1] * 8) >> p.ss_y;
        have_rec = true;
      }
      mvx = clamp_mv(mvx, bx, pw, a.cols, p.ss_x);
      mvy = clamp_mv(mvy, by, ph, a.rows, p.ss_y);
      const long long tx0 = scaled_start(mvx, ax, a.scale[sel][0], p.ss_x);
      const long long ty0 = scaled_start(mvy, ay, a.scale[sel][1], p.ss_y);
      const int txk = static_cast<int>(tx0 & 15) + (x - ax) * a.step[sel][0];
      col0 = static_cast<int>(tx0 >> 4) + (txk >> 4) - 3;
      phx = txk & 15;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int tyk =
            static_cast<int>(ty0 & 15) + (y0 + r - ay) * a.step[sel][1];
        row[r] = static_cast<int>(ty0 >> 4) + (tyk >> 4) - 3;
        phy[r] = tyk & 15;
      }
    }
    const int32_t* ref = p.ref[sel];
    const int wm = p.ref_w[sel] - 1, hm = p.ref_h[sel] - 1;
    int cidx[8], tx[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      cidx[k] = clip(col0 + k, 0, wm);
      tx[k] = kFtab[bank][phx][k];
    }
    // horizontal pass over the rows the column's pixels need
    const int nrows = clip(row[3] - row[0] + 8, 8, kScaledRows);
    for (int u = 0; u < nrows; ++u) {
      const int32_t* src = ref + static_cast<size_t>(clip(row[0] + u, 0, hm)) *
                                     p.ref_stride[sel];
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += tx[k] * __ldg(src + cidx[k]);
      hv[u][t] = clip((acc + 64) >> 7, 0, a.maxp);
    }
    // vertical pass at each row's phase
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int base = row[r] - row[0];
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        acc += kFtab[bank][phy[r]][k] *
               hv[clip(base + k, 0, kScaledRows - 1)][t];
      const int v = clip((acc + 64) >> 7, 0, a.maxp);
      pred[r] = ri == 0 ? v : (pred[r] + v + 1) >> 1;
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const size_t o = static_cast<size_t>(r) * p.W;
    out[o] = clip(pred[r] + __ldg(p.residual + static_cast<size_t>(y0) * p.W +
                                  x + o),
                  0, a.maxp);
  }
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
// 2, 2], raw 1/8 pel), then recs (int16 [N, 36]) and the splat's index
// (uint64 [r8 * c8]). dims: 16 ints a plane: H, W (multiples of 4), ss_x,
// ss_y (0 or 1), then a slot each Hr, Wr, w, h (1 <= w <= Wr, 1 <= h <=
// Hr). frame: 18 ints: N, epoch, r8, c8 (the luma 8x8 units), cols, rows,
// scale[3][2], step[3][2]. bpp: 8-12.
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
  int strips = 0;
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
    p.r4 = p.H / 4;
    p.c4 = p.W / 4;
    if ((((p.r4 << p.ss_y) + 1) >> 1) != r8 ||
        (((p.c4 << p.ss_x) + 1) >> 1) != a.c8)
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
    }
    p.residual = static_cast<const int32_t*>(q[3]);
    p.out = static_cast<int32_t*>(const_cast<void*>(q[4]));
    p.inter = static_cast<const uint8_t*>(q[5]);
    p.comp = static_cast<const uint8_t*>(q[6]);
    p.filt = static_cast<const int32_t*>(q[7]);
    p.refsel = static_cast<const int32_t*>(q[8]);
    p.mv = static_cast<const int32_t*>(q[9]);
    if (has_comp && !p.comp) return static_cast<int>(cudaErrorInvalidValue);
    p.strips_x = (p.c4 + 7) / 8;
    p.strip0 = strips;
    strips += p.strips_x * p.r4;
  }
  a.strips = strips;
  constexpr int kStrips = kScaledThreads / 32;
  mc_scaled_kernel<<<(strips + kStrips - 1) / kStrips, kScaledThreads, 0,
                     stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
