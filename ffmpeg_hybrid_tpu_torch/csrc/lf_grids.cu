// The dense loop-filter parameter grids for Hopper (sm_90a): a frame's
// per-superblock filter levels and edge masks become the V and H
// (wd, E, I, H) grids that csrc/lpf.cu reads. The CUDA counterpart of
// the JAX package's dense_grids and grids_device
// (ffmpeg_hybrid_tpu/ops/lpf_masks.py:61-186), an XLA program there,
// not a Pallas kernel; the port's plain version is
// ops/lpf_masks.py:grids_device_plain.
//
//   lf_grids  Vy, Hy, Vu, Hu of one frame, one launch
//
// Semantics: the decision tree of the walker, native/vp9_lpf.c lf_cols
// (172) and lf_rows (239). Per superblock (SB), level is its 8x8 grid of
// 8x8-block levels and the masks are 8 rows of 4 classes of 8 bits
// (cols for V edges, rows for H edges), for the luma set and for the
// chroma set (mask set 1 if the chroma planes are subsampled, else 0).
// A plane set with subsampling (ss_h, ss_v) has per SB Rv = 8 >> ss_v
// rows of Cv = 16 >> ss_h V positions and Rh = 16 >> ss_v rows of
// Ch = 8 >> ss_h H positions; the class-3 (4 px offset) positions sit
// between the aligned ones and exist only where ss_h == 0 (V) or
// ss_v == 0 (H). Grid (y, x) of a set is SB (y / R, x / C) at (y % R,
// x % C).
// - V, at (r, cp): mask bit cx = cp (ss_h) or cp >> 1, rows a = (r >> 1)
//   * (2 << ss_v) and b = a + 1 + ss_v, level column cx & ~1 under ss_h.
//   Top (r even): wd 16, 8, 4 by classes 0, 1, 2 of row a, level of a.
//   Bottom: 16 where class 0 is set in both rows, with a's level; else
//   nothing if a has class 0; else 8 or 4 by b's classes 1 and 2, with
//   b's level. Offset (cp odd, ss_h == 0): wd 4 by class 3 of its row.
//   Column 0 of the frame is never filtered.
// - H, at (rp, c): row = rp (ss_v) or rp >> 1, level row row & ~1 under
//   ss_v, bits l = (c >> 1) * (2 << ss_h) and r = l + 1 + ss_h. Left (c
//   even): wd 16, 8, 4 by l's classes 0, 1, 2, l's level. Right: 16
//   with l's level where class 0 is set at both; nothing if l has class
//   0; else 8 or 4 by r's class 1 if r has any class 0-2, with r's
//   level. Offset (rp odd, ss_v == 0): wd 4 by class 3 of its bit. Row
//   0 of the frame is never filtered.
// An edge is (wd, mblim[L & 63], lim[L & 63], L >> 4) from the level L,
// and all zero where wd == 0.
//
// Design. One launch per frame for both plane sets. A block takes a run
// of kSbRun superblocks along one superblock row (their levels and
// masks are contiguous in the inputs). Its threads first stage the
// run's 64 levels and 128 mask words a superblock, and the 64-entry
// table (mblim, lim) built from the LUT, in shared memory: every load
// is issued before the one barrier, so a thread waits on one device
// round trip. Then the block writes the run's quads of the four grids
// from shared memory, grid by grid, row by row across the run, so a
// warp's int4 stores cover whole runs of each grid row.
//
// What bounds it. Bytes: at 1080p (17 x 30 SBs, 4:2:0) the four grids
// are 163,200 quads, 2.6 MB, and the masks and levels 0.33 MB, under
// 1 us at 3.35 TB/s; each output is written once and each input word
// read once, so the kernel is its bytes and its launch.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSbRun = 2;     // superblocks a block, along a row
constexpr int kLevels = 64;   // levels are 6-bit

struct Set {
  int4* V;
  int4* H;
  int ss_h, ss_v;
  int mset;  // mask set the plane set reads
};

struct Args {
  const int16_t* lfl;   // [nSB * 64] levels
  const int32_t* lfm;   // [nSB * 128] masks: [set][cols, rows][8][4]
  const int32_t* luts;  // [128] lim ++ mblim
  int sb_rows, sb_cols;
  Set set[2];
};

// what one block holds: its run's levels and masks, and the table
struct Staged {
  int lev[kSbRun * 64];
  int msk[kSbRun * 128];
  int2 tab[kLevels];  // (mblim, lim)
};

// the words a thread stages: levels, masks and the LUT
constexpr int kStageWords = kSbRun * (64 + 128) + 2 * kLevels;
constexpr int kStageSlots = (kStageWords + kThreads - 1) / kThreads;

__device__ __forceinline__ int4 edge(int wd, int L, const Staged& s) {
  if (wd == 0) return make_int4(0, 0, 0, 0);
  const int l = L & (kLevels - 1);
  return make_int4(wd, s.tab[l].x, s.tab[l].y, L >> 4);
}

// one V quad of a set: row r, column cp of the superblock whose masks
// and levels are cm and lev (shared), at frame column gc
__device__ __forceinline__ int4 v_edge(const Set& s, const int* cm,
                                       const int* lev, int r, int cp, int gc,
                                       const Staged& st) {
  if (gc == 0) return make_int4(0, 0, 0, 0);
  const int cx = s.ss_h ? cp : cp >> 1;
  const int lc = s.ss_h ? (cx & ~1) : cx;
  const int ra = (r >> 1) * (2 << s.ss_v), rb = ra + 1 + s.ss_v;
  if (!s.ss_h && (cp & 1)) {
    const int row = (r & 1) ? rb : ra;
    return edge(((cm[row * 4 + 3] >> cx) & 1) * 4, lev[row * 8 + lc], st);
  }
  const int k0a = (cm[ra * 4] >> cx) & 1, k1a = (cm[ra * 4 + 1] >> cx) & 1,
            k2a = (cm[ra * 4 + 2] >> cx) & 1;
  const int La = lev[ra * 8 + lc];
  if (!(r & 1)) return edge(k0a ? 16 : k1a ? 8 : k2a ? 4 : 0, La, st);
  const int k0b = (cm[rb * 4] >> cx) & 1, k1b = (cm[rb * 4 + 1] >> cx) & 1,
            k2b = (cm[rb * 4 + 2] >> cx) & 1;
  const int wd = k0a ? (k0b ? 16 : 0) : k1b ? 8 : k2b ? 4 : 0;
  return edge(wd, (k0a & k0b) ? La : lev[rb * 8 + lc], st);
}

// one H quad of a set: row rp, column c of the superblock whose row
// masks and levels are rm and lev (shared), at frame row gr
__device__ __forceinline__ int4 h_edge(const Set& s, const int* rm,
                                       const int* lev, int rp, int c, int gr,
                                       const Staged& st) {
  if (gr == 0) return make_int4(0, 0, 0, 0);
  const int row = s.ss_v ? rp : rp >> 1;
  const int lr = s.ss_v ? (row & ~1) : row;
  const int bl = (c >> 1) * (2 << s.ss_h), br = bl + 1 + s.ss_h;
  const int* m = rm + row * 4;
  if (!s.ss_v && (rp & 1)) {
    const int bit = (c & 1) ? br : bl;
    return edge(((m[3] >> bit) & 1) * 4, lev[lr * 8 + bit], st);
  }
  const int m0 = m[0], m1 = m[1], m2 = m[2];
  const int k0l = (m0 >> bl) & 1, k1l = (m1 >> bl) & 1, k2l = (m2 >> bl) & 1;
  const int Ll = lev[lr * 8 + bl];
  if (!(c & 1)) return edge(k0l ? 16 : k1l ? 8 : k2l ? 4 : 0, Ll, st);
  const int k0r = (m0 >> br) & 1, k1r = (m1 >> br) & 1, k2r = (m2 >> br) & 1;
  const int wd = k0l ? (k0r ? 16 : 0) : (k0r | k1r | k2r) ? (k1r ? 8 : 4) : 0;
  return edge(wd, (k0l & k0r) ? Ll : lev[lr * 8 + br], st);
}

__global__ void __launch_bounds__(kThreads) lf_grids_kernel(Args a) {
  __shared__ Staged st;
  const int sbr = blockIdx.y, sbc0 = blockIdx.x * kSbRun;
  const int n = min(kSbRun, a.sb_cols - sbc0);  // superblocks of the run
  const int sb0 = sbr * a.sb_cols + sbc0;
  const int tid = threadIdx.x;

  // stage: every load first, into registers, then the stores to shared
  int v[kStageSlots];
#pragma unroll
  for (int k = 0; k < kStageSlots; ++k) {
    int w = tid + k * kThreads;
    v[k] = 0;
    if (w < n * 64) {
      v[k] = __ldg(a.lfl + sb0 * 64 + w);
      continue;
    }
    w -= kSbRun * 64;
    if (w >= 0 && w < n * 128) {
      v[k] = __ldg(a.lfm + sb0 * 128 + w);
      continue;
    }
    w -= kSbRun * 128;
    if (w >= 0 && w < 2 * kLevels) v[k] = __ldg(a.luts + w);
  }
#pragma unroll
  for (int k = 0; k < kStageSlots; ++k) {
    int w = tid + k * kThreads;
    if (w < kSbRun * 64) {
      st.lev[w] = v[k];
      continue;
    }
    w -= kSbRun * 64;
    if (w < kSbRun * 128) {
      st.msk[w] = v[k];
      continue;
    }
    w -= kSbRun * 128;
    // LUT word w is lim[w] (w < 64) or mblim[w - 64]
    if (w < 2 * kLevels) {
      if (w < kLevels)
        st.tab[w].y = v[k];
      else
        st.tab[w - kLevels].x = v[k];
    }
  }
  __syncthreads();

  // the run's quads, grid by grid (Vy, Hy, Vu, Hu), row by row across
  // the run: item i of a grid of R rows and C columns a superblock is
  // row i / (n * C), column i % (n * C) of the run
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const Set& s = a.set[k];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int R = h ? 16 >> s.ss_v : 8 >> s.ss_v;
      const int C = h ? 8 >> s.ss_h : 16 >> s.ss_h;
      const int wrun = n * C, width = a.sb_cols * C;
      int4* out = (h ? s.H : s.V) + (sbr * R) * width + sbc0 * C;
      for (int i = tid; i < R * wrun; i += kThreads) {
        const int r = i / wrun, x = i - r * wrun;
        const int sbl = x / C, c = x - sbl * C;
        const int* msk = st.msk + sbl * 128 + s.mset * 64;
        const int* lev = st.lev + sbl * 64;
        out[r * width + x] =
            h ? h_edge(s, msk + 32, lev, r, c, sbr * R + r, st)
              : v_edge(s, msk, lev, r, c, sbc0 * C + x, st);
      }
    }
  }
}

}  // namespace

extern "C" {

// Vy, Hy (luma set) and Vu, Hu (chroma set, subsampling ss_h, ss_v) of
// one frame of sb_rows x sb_cols superblocks, int32 [rows, cols, 4] in
// lpf_dense's layout, from lfl [nSB * 64] int16, lfm [nSB * 128] int32
// and luts [128] int32 (lim ++ mblim); one launch on `stream`.
int lf_grids(const int16_t* lfl, const int32_t* lfm, const int32_t* luts,
             int32_t* Vy, int32_t* Hy, int32_t* Vu, int32_t* Hu,
             int sb_rows, int sb_cols, int ss_h, int ss_v,
             cudaStream_t stream) {
  if (sb_rows < 1 || sb_cols < 1 || sb_rows > 65535 || (ss_h | ss_v) & ~1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{lfl, lfm, luts, sb_rows, sb_cols,
         {{reinterpret_cast<int4*>(Vy), reinterpret_cast<int4*>(Hy), 0, 0, 0},
          {reinterpret_cast<int4*>(Vu), reinterpret_cast<int4*>(Hu), ss_h,
           ss_v, (ss_h | ss_v) ? 1 : 0}}};
  const dim3 grid((sb_cols + kSbRun - 1) / kSbRun, sb_rows);
  lf_grids_kernel<<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
