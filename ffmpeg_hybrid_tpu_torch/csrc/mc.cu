// VP9 motion compensation for Hopper (sm_90a): the inter pass of a
// frame's planes, the CUDA counterpart of the JAX package's _mc_cells and
// the apply step of _recon_plane_inter (ffmpeg_hybrid_tpu/ops/
// recon_tpu.py:131-184 and 1805-1850). Those are XLA programs there, not
// Pallas kernels; the port's plain version is ops/recon.py:mc_planes_plain.
//
//   mc_planes  the inter pass of up to three planes, one launch
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
// Design. One thread block of 256 threads per 16 x 16 pixel tile of a
// plane (4 x 4 cells); the tiles of the three planes make one grid, the
// planes' descriptors sit in the kernel's parameters. A thread owns one
// output pixel; the 16 threads of a cell load its 121-pixel patch into
// shared memory through the read-only path (the cells of one block share
// their motion, so their patches overlap in L1), compute its 44
// horizontal values (up to 3 each) into shared memory, then each its own
// pixel's vertical pass. The second reference runs only in tiles that
// hold a compound cell, and a tile without an inter cell writes zeros
// and leaves. The epilogue adds the residual, clips, selects by inter4
// and writes the plane once. A cell that is not inter reads no motion,
// reference or filter (those grid values may be out of range there). The
// taps sit in __constant__ memory; each thread reads its cell's 16.
//
// What bounds it. Bytes: each output pixel written once (4 B), and per
// pixel of an inter cell its residual and a reference pixel per
// reference (4 B each), plus the grids (some 30 B a cell): about 43 MB
// for a 1080p frame of single-reference cells, 55 MB with every cell
// compound, 13-16 us at 3.35 TB/s. The operations, 480 multiply-adds a
// cell a reference, are below that at the int32 rate.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 3;
constexpr int kThreads = 256;
constexpr int kTile = 16;                  // pixels a side of a block's tile
constexpr int kTileCells = kTile / 4;      // cells a side of a tile
constexpr int kCells = kTileCells * kTileCells;
constexpr int kPatch = 11;                 // source rows and columns a cell
constexpr int kHVals = kPatch * 4;         // horizontal-pass values a cell

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
  int tile0;               // the plane's first block in the grid
};

struct Args {
  Plane p[kMaxPlanes];
  int n;
  int maxp;
  int has_comp;
};

__device__ __forceinline__ int clip(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(kThreads)
    mc_kernel(const __grid_constant__ Args a) {
  __shared__ int32_t patch[kCells][kPatch * kPatch];
  __shared__ int32_t hval[kCells][kHVals];
  int pi = 0;
  while (pi + 1 < a.n && static_cast<int>(blockIdx.x) >= a.p[pi + 1].tile0)
    ++pi;
  const Plane& p = a.p[pi];
  const int tile = blockIdx.x - p.tile0;
  const int t = threadIdx.x;
  const int py = t / kTile, px = t % kTile;   // the thread's pixel in the tile
  const int y = (tile / p.tiles_x) * kTile + py;
  const int x = (tile % p.tiles_x) * kTile + px;
  const int cell = (py >> 2) * kTileCells + (px >> 2);
  const int rank = (py & 3) * 4 + (px & 3);    // the thread's rank in its cell
  const bool inside = y < p.H && x < p.W;
  const size_t g = static_cast<size_t>(y >> 2) * (p.W >> 2) + (x >> 2);
  const bool inter = inside && p.inter[g] != 0;
  const bool comp = inter && a.has_comp && p.comp[g] != 0;
  const size_t pix = static_cast<size_t>(y) * p.W + x;
  if (!__syncthreads_or(inter)) {
    if (inside) p.out[pix] = 0;
    return;
  }
  const int nref = __syncthreads_or(comp) ? 2 : 1;
  const int bank = inter ? clip(p.filt[g], 0, 3) : 0;
  int pred = 0;
  for (int ri = 0; ri < nref; ++ri) {
    const bool act = ri == 0 ? inter : comp;
    int mx = 0, my = 0;
    if (act) {
      const int mvx = p.mv[g * 4 + ri * 2] * p.mvsx;
      const int mvy = p.mv[g * 4 + ri * 2 + 1] * p.mvsy;
      const int iy = (y & ~3) + (mvy >> 4) - 3;
      const int ix = (x & ~3) + (mvx >> 4) - 3;
      mx = mvx & 15;
      my = mvy & 15;
      const int32_t* ref = p.ref[clip(p.refsel[g * 2 + ri], 0, 2)];
      for (int j = rank; j < kPatch * kPatch; j += 16) {
        const int sy = clip(iy + j / kPatch, 0, p.h - 1);
        const int sx = clip(ix + j % kPatch, 0, p.w - 1);
        patch[cell][j] = __ldg(ref + static_cast<size_t>(sy) * p.ref_w + sx);
      }
    }
    __syncthreads();
    if (act) {
      // horizontal pass: row j / 4 of the patch, output column j % 4
      int taps[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) taps[k] = kFtab[bank][mx][k];
      for (int j = rank; j < kHVals; j += 16) {
        const int32_t* src = &patch[cell][(j >> 2) * kPatch + (j & 3)];
        int acc = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) acc += taps[k] * src[k];
        hval[cell][j] = clip((acc + 64) >> 7, 0, a.maxp);
      }
    }
    __syncthreads();
    if (act) {
      // vertical pass: the thread's own pixel
      const int32_t* src = &hval[cell][(py & 3) * 4 + (px & 3)];
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += kFtab[bank][my][k] * src[k * 4];
      const int v = clip((acc + 64) >> 7, 0, a.maxp);
      pred = ri == 0 ? v : (pred + v + 1) >> 1;
    }
  }
  if (inside)
    p.out[pix] = inter ? clip(pred + p.residual[pix], 0, a.maxp) : 0;
}

}  // namespace

extern "C" {

// The inter pass of n (1-3) planes in one launch on `stream`. ptrs: 10
// device pointers a plane: ref0, ref1, ref2 (int32 [Hr, Wr]), residual
// and out (int32 [H, W]), inter4 and comp (bool [H/4, W/4]; comp may be
// null when has_comp is 0), filt (int32 [H/4, W/4]), refsel (int32
// [H/4, W/4, 2]), mv16 (int32 [H/4, W/4, 2, 2]). dims: 8 ints a plane:
// H, W (multiples of 4), Hr, Wr, w, h (the visible size, 1 <= w <= Wr, 1
// <= h <= Hr), mvsx, mvsy. bpp: 8-12.
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
    if (p.H <= 0 || p.W <= 0 || p.H % 4 || p.W % 4 || p.w < 1 ||
        p.w > d[3] || p.h < 1 || p.h > d[2] || (has_comp && !p.comp))
      return static_cast<int>(cudaErrorInvalidValue);
    p.tiles_x = (p.W + kTile - 1) / kTile;
    p.tile0 = tiles;
    tiles += p.tiles_x * ((p.H + kTile - 1) / kTile);
  }
  mc_kernel<<<tiles, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
