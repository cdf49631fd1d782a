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
// An edge is (wd, mblim[L], lim[L], L >> 4) from the level L, and all
// zero where wd == 0.
//
// Design. One launch per frame for both plane sets: a thread per output
// quad of the four grids, taken in their final row-major order, so each
// thread decodes its grid, SB and position from its index, reads its
// mask words and level cells (a few words of its SB, shared with its
// neighbours through L1), walks the tree in registers and writes its
// quad as one int4, coalesced with its neighbours' quads.
//
// What bounds it. Bytes: at 1080p (17 x 30 SBs, 4:2:0) the four grids
// are 163,200 quads, 2.6 MB, and the masks and levels 0.33 MB, under
// 1 us at 3.35 TB/s; each output is written once and each mask word
// comes from HBM once, so the kernel is the bytes and its launch.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLevels = 64;  // levels are 6-bit

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

__device__ __forceinline__ int4 edge(int wd, int L, const int32_t* luts) {
  if (wd == 0) return make_int4(0, 0, 0, 0);
  const int l = L & (kLevels - 1);
  return make_int4(wd, __ldg(luts + kLevels + l), __ldg(luts + l), L >> 4);
}

// one V quad of a set, grid row gr, column gc
__device__ __forceinline__ int4 v_edge(const Args& a, const Set& s, int gr,
                                       int gc) {
  const int Rv = 8 >> s.ss_v, Cv = 16 >> s.ss_h;
  const int sbr = gr / Rv, r = gr - sbr * Rv;
  const int sbc = gc / Cv, cp = gc - sbc * Cv;
  const int sb = sbr * a.sb_cols + sbc;
  const int32_t* cm = a.lfm + sb * 128 + s.mset * 64;
  const int16_t* lev = a.lfl + sb * 64;
  const int cx = s.ss_h ? cp : cp >> 1;
  const int lc = s.ss_h ? (cx & ~1) : cx;
  const int ra = (r >> 1) * (2 << s.ss_v), rb = ra + 1 + s.ss_v;
  const int row = (r & 1) ? rb : ra;
  if (gc == 0) return make_int4(0, 0, 0, 0);
  if (!s.ss_h && (cp & 1))
    return edge(((__ldg(cm + row * 4 + 3) >> cx) & 1) * 4,
                __ldg(lev + row * 8 + lc), a.luts);
  const int ma = __ldg(cm + ra * 4) >> cx, mb = __ldg(cm + rb * 4) >> cx;
  const int k0a = ma & 1, k1a = (__ldg(cm + ra * 4 + 1) >> cx) & 1,
            k2a = (__ldg(cm + ra * 4 + 2) >> cx) & 1;
  const int La = __ldg(lev + ra * 8 + lc);
  if (!(r & 1))
    return edge(k0a ? 16 : k1a ? 8 : k2a ? 4 : 0, La, a.luts);
  const int k0b = mb & 1, k1b = (__ldg(cm + rb * 4 + 1) >> cx) & 1,
            k2b = (__ldg(cm + rb * 4 + 2) >> cx) & 1;
  const int wd = k0a ? (k0b ? 16 : 0) : k1b ? 8 : k2b ? 4 : 0;
  return edge(wd, (k0a & k0b) ? La : __ldg(lev + rb * 8 + lc), a.luts);
}

// one H quad of a set, grid row gr, column gc
__device__ __forceinline__ int4 h_edge(const Args& a, const Set& s, int gr,
                                       int gc) {
  const int Rh = 16 >> s.ss_v, Ch = 8 >> s.ss_h;
  const int sbr = gr / Rh, rp = gr - sbr * Rh;
  const int sbc = gc / Ch, c = gc - sbc * Ch;
  const int sb = sbr * a.sb_cols + sbc;
  const int32_t* rm = a.lfm + sb * 128 + s.mset * 64 + 32;
  const int16_t* lev = a.lfl + sb * 64;
  const int row = s.ss_v ? rp : rp >> 1;
  const int lr = s.ss_v ? (row & ~1) : row;
  const int bl = (c >> 1) * (2 << s.ss_h), br = bl + 1 + s.ss_h;
  const int bit = (c & 1) ? br : bl;
  if (gr == 0) return make_int4(0, 0, 0, 0);
  const int32_t* m = rm + row * 4;
  if (!s.ss_v && (rp & 1))
    return edge(((__ldg(m + 3) >> bit) & 1) * 4, __ldg(lev + lr * 8 + bit),
                a.luts);
  const int m0 = __ldg(m), m1 = __ldg(m + 1), m2 = __ldg(m + 2);
  const int k0l = (m0 >> bl) & 1, k1l = (m1 >> bl) & 1, k2l = (m2 >> bl) & 1;
  const int Ll = __ldg(lev + lr * 8 + bl);
  if (!(c & 1))
    return edge(k0l ? 16 : k1l ? 8 : k2l ? 4 : 0, Ll, a.luts);
  const int k0r = (m0 >> br) & 1, k1r = (m1 >> br) & 1, k2r = (m2 >> br) & 1;
  const int wd = k0l ? (k0r ? 16 : 0) : (k0r | k1r | k2r) ? (k1r ? 8 : 4) : 0;
  return edge(wd, (k0l & k0r) ? Ll : __ldg(lev + lr * 8 + br), a.luts);
}

__global__ void __launch_bounds__(kThreads) lf_grids_kernel(Args a) {
  int idx = blockIdx.x * kThreads + threadIdx.x;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const Set& s = a.set[k];
    const int vw = a.sb_cols * (16 >> s.ss_h);
    const int nv = a.sb_rows * (8 >> s.ss_v) * vw;
    if (idx < nv) {
      s.V[idx] = v_edge(a, s, idx / vw, idx % vw);
      return;
    }
    idx -= nv;
    const int hw = a.sb_cols * (8 >> s.ss_h);
    const int nh = a.sb_rows * (16 >> s.ss_v) * hw;
    if (idx < nh) {
      s.H[idx] = h_edge(a, s, idx / hw, idx % hw);
      return;
    }
    idx -= nh;
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
  if (sb_rows < 1 || sb_cols < 1 || (ss_h | ss_v) & ~1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{lfl, lfm, luts, sb_rows, sb_cols,
         {{reinterpret_cast<int4*>(Vy), reinterpret_cast<int4*>(Hy), 0, 0, 0},
          {reinterpret_cast<int4*>(Vu), reinterpret_cast<int4*>(Hu), ss_h,
           ss_v, (ss_h | ss_v) ? 1 : 0}}};
  // per SB: 256 quads of the luma set (V and H), 256 >> (ss_h + ss_v)
  // of the chroma set
  const long long quads = static_cast<long long>(sb_rows) * sb_cols *
                          (256 + (256 >> (ss_h + ss_v)));
  lf_grids_kernel<<<static_cast<unsigned>((quads + kThreads - 1) / kThreads),
                    kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
